"""The port's BigVGAN slice against tts_tpu on the CPU, fp32 on both sides:
the kaiser-sinc filters and the anti-aliased resampling, kernel 10's plain
twin (ops/bigvgan_stage.amp_block_fused on CPU tensors) against tts_tpu's
Pallas kernel in interpret mode, the generator (AMPBlock1 through kernel
10's twin and through the plain chain, AMPBlock2, feat_upsample, speaker
conditioning), the vocoder's int16 output, params_from_jax, and the
MelSpectrogram options.

Tolerances: the filters agree to 1e-6 (the same fp32 ops, in tts_tpu's
order); kernel 10's twin to 1e-5 abs, tts_tpu's own bound for its kernel
against the XLA chain (the conv sums run in another order); the generator
to 1e-4 relative L2 (dozens of convs, each summed in another order); int16
within 2 LSB (float waveforms that agree to ~1e-6 truncate to neighbouring
integers); the log-mel to 1e-5 (fp32 STFT products in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.audio import filters as jfl
from tts_tpu.audio.mel import MelSpectrogram as JaxMel
from tts_tpu.models import bigvgan as jbv
from tts_tpu.ops import bigvgan_stage as jks
from tts_tpu.runtime.vocoder import BigVGANVocoder as JaxVocoder
from tts_tpu_torch.audio import filters as tfl
from tts_tpu_torch.audio.mel import MelSpectrogram
from tts_tpu_torch.audio.snake import snake_beta
from tts_tpu_torch.models import bigvgan as tbv
from tts_tpu_torch.ops import bigvgan_stage as tks
from tts_tpu_torch.runtime.vocoder import BigVGANVocoder
from tts_tpu_torch.weights.convert import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------- filters

@pytest.mark.parametrize("cutoff,half,k", [(0.25, 0.3, 12), (0.5 / 3, 0.2, 18),
                                           (0.1, 0.05, 9), (0.0, 0.3, 12)])
def test_kaiser_sinc_filter_bit_equal(cutoff, half, k):
    np.testing.assert_array_equal(tfl.kaiser_sinc_filter(cutoff, half, k),
                                  jfl.kaiser_sinc_filter(cutoff, half, k))


@pytest.mark.parametrize("ratio,t", [(2, 37), (2, 8), (3, 20)])
def test_resample_matches_jax(ratio, t):
    """upsample, downsample and alias_free_act (snakebeta) in fp32."""
    from tts_tpu.audio.snake import snake_beta as jsnake

    rng = np.random.default_rng(ratio * 100 + t)
    x = rng.standard_normal((2, t, 5)).astype(np.float32)
    alpha = (1 + rng.uniform(0, 1, 5)).astype(np.float32)
    recip = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    jr, tr = jfl.AliasFreeResample(ratio), tfl.AliasFreeResample(ratio)
    np.testing.assert_allclose(tr.upsample(_t(x)).numpy(),
                               np.asarray(jr.upsample(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(tr.downsample(_t(x)).numpy(),
                               np.asarray(jr.downsample(jnp.asarray(x))), atol=1e-6)
    got = tr.alias_free_act(_t(x), lambda u: snake_beta(u, _t(alpha), _t(recip)))
    ref = jr.alias_free_act(jnp.asarray(x),
                            lambda u: jsnake(u, jnp.asarray(alpha), jnp.asarray(recip)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


# ---------------------------------------------------------------- kernel 10

def _stack_args(rng, k, n_br, c):
    """tts_tpu's kernel test inputs (tests/test_bigvgan_stage.py:_params),
    stacked: w1, b1, w2, b2, a1, r1, a2, r2."""
    def conv(shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    return [conv((n_br, k, c, c)), conv((n_br, c)), conv((n_br, k, c, c)), conv((n_br, c)),
            (1 + rng.uniform(0, 1, (n_br, c))).astype(np.float32),
            rng.uniform(0.5, 1.5, (n_br, c)).astype(np.float32),
            (1 + rng.uniform(0, 1, (n_br, c))).astype(np.float32),
            rng.uniform(0.5, 1.5, (n_br, c)).astype(np.float32)]


@pytest.mark.parametrize("k,dils,b,t,c", [
    (11, (1, 3, 5), 1, 800, 24),
    (7, (1, 3, 5), 1, 530, 48),
    (3, (1, 3, 5), 1, 300, 16),
    (3, (1, 2), 1, 300, 16),
    (11, (1, 3, 5), 1, 100, 8),     # T shorter than one tile and than the halo
    (7, (1, 3, 5), 2, 260, 16),     # two batch rows
])
def test_amp_block_twin_matches_pallas(k, dils, b, t, c):
    rng = np.random.default_rng(k + t + b)
    args = _stack_args(rng, k, len(dils), c)
    x = (rng.standard_normal((b, t, c)) * 0.5).astype(np.float32)
    ref = jks.amp_block_fused(jnp.asarray(x), *map(jnp.asarray, args), k=k,
                              dils=dils, interpret=True)
    got = tks.amp_block_fused(_t(x), *map(_t, args), k=k, dils=dils)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_amp_block_twin_matches_xla_chain_bf16():
    """In bf16 the twin keeps the kernel's rounding points (one rounding per
    act, fp32 conv sums): three branches of bf16 rounding stay within 3e-2
    relative L2 of tts_tpu's fp32 XLA chain."""
    rng = np.random.default_rng(3)
    k, dils, c = 7, (1, 3, 5), 16
    w1, b1, w2, b2, a1, r1, a2, r2 = _stack_args(rng, k, 3, c)
    x = (rng.standard_normal((1, 300, c)) * 0.5).astype(np.float32)
    p = {"convs1": [{"w": w1[j], "b": b1[j]} for j in range(3)],
         "convs2": [{"w": w2[j], "b": b2[j]} for j in range(3)],
         "acts1": [{"alpha": a1[j], "beta_recip": r1[j]} for j in range(3)],
         "acts2": [{"alpha": a2[j], "beta_recip": r2[j]} for j in range(3)]}
    cfg = jbv.BigVGANConfig(resblock_kernel_sizes=(k,), resblock_dilation_sizes=(dils,))
    ref = np.asarray(jbv._amp_block(jnp.asarray(x), jax.tree.map(jnp.asarray, p), k, dils,
                                    cfg, jfl.AliasFreeResample(2)))
    got = tks.amp_block_fused(_t(x).bfloat16(), *map(_t, (w1, b1, w2, b2, a1, r1, a2, r2)),
                              k=k, dils=dils).float().numpy()
    assert _rel(got, ref) < 3e-2


def test_amp_block_guards_raise():
    """tts_tpu's geometry guards (staging margin, halo), shape checks and
    x's contiguity, on both paths; a device without a kernel raises."""
    rng = np.random.default_rng(0)
    k, c, t = 11, 16, 512
    x = _t((rng.standard_normal((1, t, c)) * 0.5).astype(np.float32))
    args = [_t(a) for a in _stack_args(rng, k, 3, c)]
    with pytest.raises(ValueError, match="staging margin"):
        tks.amp_block_fused(x, *args, k=k, dils=(1, 3, 7))
    args4 = [_t(a) for a in _stack_args(rng, k, 4, c)]
    with pytest.raises(ValueError, match="halo"):
        tks.amp_block_fused(x, *args4, k=k, dils=(5, 5, 5, 5))
    with pytest.raises(ValueError, match="w1"):
        tks.amp_block_fused_plain(x, *args, k=k, dils=(1, 3))
    with pytest.raises(ValueError, match="contiguous"):
        tks.amp_block_fused(x.transpose(1, 2).contiguous().transpose(1, 2), *args, k=k,
                            dils=(1, 3, 5))
    with pytest.raises(ValueError, match="no kernel"):
        tks.amp_block_fused(x.to("meta"), *[a.to("meta") for a in args], k=k,
                            dils=(1, 3, 5))


@pytest.mark.parametrize("c,t,dtype,jdtype", [
    (24, 131072, torch.bfloat16, jnp.bfloat16),
    (128, 16384, torch.float32, jnp.float32),
    (192, 16384, torch.float32, jnp.float32),
    (768, 2048, torch.bfloat16, jnp.bfloat16),
    (24, 100, torch.bfloat16, jnp.bfloat16),
    (24, 131072, torch.float16, jnp.float16),
    (256, 256, torch.bfloat16, jnp.bfloat16),
])
def test_fusable_stage_agrees(c, t, dtype, jdtype):
    """tts_tpu's test cases of its gate, and on a CUDA device the kernel's
    own limits on top: bf16 only, C a multiple of 8."""
    want = jks.fusable_stage(c, t, jdtype)
    assert tks.fusable_stage(c, t, dtype) == want
    assert tks.fusable_stage(c, t, dtype, "cpu") == want
    assert tks.fusable_stage(c, t, dtype, "cuda") == (want and dtype == torch.bfloat16)
    assert not tks.fusable_stage(20, 4096, torch.bfloat16, "cuda")


# ---------------------------------------------------------------- generator

SMALL = dict(num_mels=8, upsample_initial_channel=32, upsample_rates=(2, 2),
             upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3, 5),
             resblock_dilation_sizes=((1, 3), (1, 3)), use_tanh_at_final=True,
             use_bias_at_final=True)


def _louder(p, rng):
    """tts_tpu's init gives zero biases and unit snakes: add random biases
    and snake parameters so the test sees them."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for key, v in node.items():
                if key in ("b", "alpha", "beta_recip", "alpha_recip"):
                    base = 1.0 if key != "b" else 0.0
                    v = base + rng.uniform(-0.3, 0.3, np.shape(v)).astype(np.float32)
                    out[key] = jnp.asarray(v)
                else:
                    out[key] = walk(v)
            return out
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(p)


@pytest.fixture
def interpret_kernel(monkeypatch):
    orig = jbv._amp_block_kernel
    monkeypatch.setattr(jbv, "_amp_block_kernel",
                        lambda x, p, k, d, c: orig(x, p, k, d, c, interpret=True))


@pytest.mark.parametrize("variant", ["fused", "plain", "resblock2", "feat_upsample",
                                     "conds"])
def test_bigvgan_apply_matches_jax(variant, interpret_kernel):
    """Stages of (C 16, T 260) and (C 8, T 520) pass the kernel's gate:
    "fused" runs tts_tpu's kernel (interpret) against the port's twin,
    "plain" both plain chains, the rest the port's default route."""
    over = {"resblock2": dict(resblock="2"), "feat_upsample": dict(feat_upsample=True)}
    cfg_kw = {**SMALL, **over.get(variant, {})}
    jcfg, tcfg = jbv.BigVGANConfig(**cfg_kw), tbv.BigVGANConfig(**cfg_kw)
    rng = np.random.default_rng(7)
    jp = _louder(jbv.init_params(jcfg, jax.random.key(0)), rng)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    frames = 40 if variant == "feat_upsample" else 130
    mel = rng.standard_normal((2, frames, 8)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if variant == "conds":
        ce = rng.standard_normal((2, 1, 32)).astype(np.float32) * 0.3
        cs = [rng.standard_normal((2, 1, c)).astype(np.float32) * 0.3
              for c in jcfg.stage_channels]
        kw_j = dict(cond_embed=jnp.asarray(ce), conds=[jnp.asarray(c) for c in cs])
        kw_t = dict(cond_embed=_t(ce), conds=[_t(c) for c in cs])
    fused = variant != "plain"
    ref = np.asarray(jbv.bigvgan_apply(jp, jnp.asarray(mel), jcfg, fused=fused, **kw_j))
    got = tbv.bigvgan_apply(tp, _t(mel), tcfg, fused=None if fused else False, **kw_t)
    assert got.shape == ref.shape == (2, frames * jcfg.total_upsample)
    assert np.abs(ref).max() > 1e-3
    assert _rel(got.numpy(), ref) < 1e-4


def test_bigvgan_routes_through_kernel_10(monkeypatch):
    """fused=None sends each AMPBlock1 stage the gate admits through
    amp_block_fused (one call a resblock), on the CPU as on the card."""
    calls = []
    real = tks.amp_block_fused
    monkeypatch.setattr(tks, "amp_block_fused",
                        lambda x, *a, **k: calls.append(tuple(x.shape)) or real(x, *a, **k))
    cfg = tbv.BigVGANConfig(**SMALL)
    tp = tbv.init_params(cfg, torch.Generator().manual_seed(0))
    tbv.bigvgan_apply(tp, torch.randn(1, 130, 8), cfg)
    assert calls == [(1, 260, 16)] * 2 + [(1, 520, 8)] * 2
    calls.clear()
    tbv.bigvgan_apply(tp, torch.randn(1, 100, 8), cfg)      # T 200: under one tile
    assert calls == [(1, 400, 8)] * 2
    calls.clear()
    tbv.bigvgan_apply(tp, torch.randn(1, 130, 8), cfg, fused=False)
    assert calls == []


def test_linear_upsample_4x_exact():
    x = np.random.default_rng(5).standard_normal((2, 9, 5)).astype(np.float32)
    np.testing.assert_array_equal(tbv.linear_upsample_4x(_t(x)).numpy(),
                                  np.asarray(jbv.linear_upsample_4x(jnp.asarray(x))))


def test_vocoder_int16_matches_jax():
    """BigVGANVocoder.__call__: tts_tpu's jitted program (plain chain on the
    CPU) against the port's default route (kernel 10's twin)."""
    cfg_kw = dict(SMALL, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                  use_tanh_at_final=False, use_bias_at_final=False)
    jcfg, tcfg = jbv.BigVGANConfig(**cfg_kw), tbv.BigVGANConfig(**cfg_kw)
    rng = np.random.default_rng(11)
    jp = _louder(jbv.init_params(jcfg, jax.random.key(3)), rng)
    jp["conv_post"]["w"] = jp["conv_post"]["w"] * 200.0   # a waveform that spans int16
    jv = JaxVocoder(jp, jcfg, dtype=jnp.float32)
    tv = BigVGANVocoder(params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32),
                        tcfg, dtype=torch.float32)
    mel = rng.standard_normal((40, 8)).astype(np.float32)
    ref, got = jv(mel), tv(mel)
    assert got.dtype == np.int16 and got.shape == ref.shape == (1, 40 * 8)
    assert np.abs(ref).max() > 3000
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 2
    bench = tv.benchmark(mel_frames=16, iters=2)
    assert bench["samples"] == 16 * 8 and bench["samples_per_sec"] > 0


def test_vocoder_takes_params_in_bf16_by_default():
    """BigVGANVocoder needs its params (no random ones of its own), runs on
    their device, and casts them to bf16 unless asked otherwise: the dtype
    kernel 10 takes on the card."""
    cfg = tbv.BigVGANConfig(**SMALL)
    tp = tbv.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(TypeError):
        BigVGANVocoder(cfg=cfg)
    voc = BigVGANVocoder(tp, cfg)
    assert voc.device == torch.device("cpu")
    assert voc.params["conv_pre"]["w"].dtype == torch.bfloat16
    wav = voc(np.random.default_rng(2).standard_normal((20, 8)).astype(np.float32))
    assert wav.dtype == np.int16 and wav.shape == (1, 20 * cfg.total_upsample)


def test_params_from_jax_and_init_shapes():
    for kind in ("1", "2"):
        cfg_kw = dict(SMALL, resblock=kind)
        jp = jbv.init_params(jbv.BigVGANConfig(**cfg_kw), jax.random.key(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.bfloat16)
        ours = tbv.init_params(tbv.BigVGANConfig(**cfg_kw), torch.Generator().manual_seed(0))
        shapes = lambda tree: jax.tree.map(lambda a: tuple(np.shape(a)), tree)
        assert shapes(jax.tree.map(lambda t: t.float().numpy(), tp)) == shapes(jp)
        assert shapes(jax.tree.map(lambda t: t.numpy(), ours)) == shapes(jp)
        assert tp["conv_pre"]["w"].dtype == torch.bfloat16
    jp["resblocks"][0]["convs1"] = jp["resblocks"][0]["convs"]   # a mix of both kinds
    with pytest.raises(KeyError, match="resblocks/0"):
        params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


# ---------------------------------------------------------------- mel options

@pytest.mark.parametrize("opts", [
    dict(),
    dict(pad_mode="constant"),
    dict(log_mode="add"),
    dict(f_min=50.0, f_max=7000.0),
    dict(norm="slaney", mel_scale="slaney"),
    dict(window_type="hamming", win_length=200),
])
def test_mel_options_match_jax(opts):
    kw = dict(sample_rate=16000, n_fft=256, hop=64, n_mels=24, **opts)
    x = np.random.default_rng(2).standard_normal((2, 1000)).astype(np.float32) * 0.3
    ref = np.asarray(JaxMel(**kw)(jnp.asarray(x)))
    got = MelSpectrogram(**kw)(_t(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_mel_log_mode_checked():
    with pytest.raises(ValueError, match="log_mode"):
        MelSpectrogram(16000, 256, 64, log_mode="ln")
