"""F5's many-request paths in the port against tts_tpu on the CPU, fp32 on
both sides, at a small config: `dit_forward` with a (B,) step vector and
per-row kv_len, the FORA layer cache (`dit_forward_cached`,
`synthesize(layer_cache_interval=2)`) and `synthesize_batch` (float and
int8 weights), with tts_tpu's jax.random draws handed to the port as
`noise=`; and the routes per-row modulation takes.

The port's kernel wrappers run their plain twins here; tts_tpu runs its CPU
path (plain softmax attention, unfused MLP; its W8A8 kernels in interpret
mode for quantize=8). Both compute the same fp32 math in another summation
order: forwards agree to fp32 rounding, int16 audio to 2 LSB (a sample on
an integer boundary may truncate one LSB apart)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tts_tpu.models.f5 as jf5
from tts_tpu.models import vocos as jvo
from tts_tpu.runtime.f5 import F5Pipeline as JaxPipeline
from tts_tpu_torch.models import f5 as tf5
from tts_tpu_torch.models import vocos as tvo
from tts_tpu_torch.runtime.f5 import F5Pipeline, quantize_dit
from tts_tpu_torch.weights.convert import params_from_jax

# tests/test_torch_f5.py's SMALL with 6 NFE steps (steps 0 and 5 exist)
SMALL = dict(dim=128, depth=2, heads=2, head_dim=64, text_dim=64, conv_layers=1,
             nfe_steps=6, max_signal_len=512, vocab_size=40)
VOCOS = dict(dim=32, intermediate_dim=64, num_layers=2)
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz,.")}
T = 256
LSB = 2
REQUESTS = (("hello there.", " some words here"),
            ("hi.", " and a bit more text, again."),
            ("a longer reference text.", " short"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Interpret:
    """tts_tpu's W8A8 kernels in interpret mode for the duration."""

    def __enter__(self):
        self.old = jf5.Q8_INTERPRET
        jf5.Q8_INTERPRET = True

    def __exit__(self, *exc):
        jf5.Q8_INTERPRET = self.old


@pytest.fixture(scope="module")
def models():
    jc, tc = jf5.F5Config(**SMALL), tf5.F5Config(**SMALL)
    jvc, tvc = jvo.VocosConfig(**VOCOS), tvo.VocosConfig(**VOCOS)
    jp = jf5.init_params(jc, jax.random.key(0))
    jvp = jvo.init_params(jvc, jax.random.key(1))
    # a louder vocoder (magnitude bias e^3), as tests/test_torch_f5.py
    jvp["head"]["b"] = jvp["head"]["b"].at[:jvc.n_fft // 2 + 1].set(3.0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    tvp = params_from_jax(jax.tree.map(np.asarray, jvp), "cpu", torch.float32)
    return dict(jc=jc, tc=tc, jvc=jvc, tvc=tvc, jp=jp, jvp=jvp, tp=tp, tvp=tvp)


def _inputs(cfg, b: int, seed: int):
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((b, T, cfg.n_mels)).astype(np.float32)
    cond = rng.standard_normal((b, T, cfg.n_mels + cfg.text_dim)).astype(np.float32)
    drop = rng.standard_normal((b, T, cfg.n_mels + cfg.text_dim)).astype(np.float32)
    return noise, cond, drop


def _pipes(models, **kw):
    jpipe = JaxPipeline(models["jp"], models["jc"], VOCAB, models["jvp"], models["jvc"], **kw)
    pipe = F5Pipeline(tf5.F5Model(models["tc"], models["tp"]), VOCAB,
                      tvo.VocosModel(models["tvc"], models["tvp"]), **kw)
    return jpipe, pipe


def _audio(seed: int, n: int = 12000) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 3000).astype(np.int16)


def _close(got: np.ndarray, ref: np.ndarray) -> None:
    assert got.dtype == np.int16 and got.shape == ref.shape and ref.size
    assert np.abs(ref.astype(np.int32)).max() > 3000
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= LSB


@pytest.mark.parametrize("steps", [(0, 5), (5, 5)])
def test_dit_forward_step_vector_matches_jax(models, steps):
    """Two requests, each at its own NFE step and key length: the (B,) step
    vector gathers each row's AdaLN vectors, paired cond then uncond."""
    cfg, jp, tp = models["jc"], models["jp"], models["tp"]
    noise, cond, drop = _inputs(cfg, 2, 4)
    kv = np.array([256, 200] * 2, np.int32)
    idx = np.array(steps, np.int32)
    pj, pj1 = jf5.dit_forward(jp, jnp.asarray(noise), jnp.asarray(cond), jnp.asarray(drop),
                              jp["time_table"][idx], jp["rope_cos"][:T], jp["rope_sin"][:T],
                              cfg, kv_len=jnp.asarray(kv), step_idx=jnp.asarray(idx))
    pt, pt1 = tf5.dit_forward(tp, torch.from_numpy(noise), torch.from_numpy(cond),
                              torch.from_numpy(drop), tp["rope_cos"][:T], tp["rope_sin"][:T],
                              models["tc"], kv_len=torch.from_numpy(kv),
                              step_idx=torch.from_numpy(idx))
    assert pt.shape == (2, T, cfg.n_mels)
    # two blocks of fp32 attention (the twin's exp2 softmax against a
    # max-subtracted one) and MLP, as tests/test_torch_f5.py
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(pt1.numpy(), np.asarray(pj1), atol=2e-5, rtol=1e-5)


def test_step_vector_of_equal_steps_is_the_int_step(models):
    """A step vector whose rows share one step gives the int step's output
    bit for bit (the same AdaLN vectors, per row)."""
    cfg, tp = models["tc"], models["tp"]
    noise, cond, drop = (torch.from_numpy(a) for a in _inputs(cfg, 2, 5))
    kv = torch.tensor([256, 200] * 2)
    args = (tp, noise, cond, drop, tp["rope_cos"][:T], tp["rope_sin"][:T], cfg)
    a = tf5.dit_forward(*args, kv_len=kv, step_idx=3)
    b = tf5.dit_forward(*args, kv_len=kv, step_idx=torch.tensor([3, 3]))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


def test_dit_forward_cached_matches_jax(models):
    """A full step (use_cache False: the cache filled) at step 2, then a
    cached step (use_cache True: attention and FF outputs reused, this
    step's gates) at step 3, each against tts_tpu's."""
    cfg, jp, tp = models["jc"], models["jp"], models["tp"]
    noise, cond, drop = _inputs(cfg, 1, 6)
    shape = (cfg.depth, 2, T, cfg.dim)
    jcache = (jnp.zeros(shape), jnp.zeros(shape))
    tcache = None
    for step, use in ((2, False), (3, True)):
        *jout, jcache = jf5.dit_forward_cached(
            jp, jnp.asarray(noise), jnp.asarray(cond), jnp.asarray(drop),
            jp["time_table"][step], jp["rope_cos"][:T], jp["rope_sin"][:T], cfg,
            jnp.int32(200), jcache, use_cache=use, step_idx=step)
        *tout, tcache = tf5.dit_forward_cached(
            tp, torch.from_numpy(noise), torch.from_numpy(cond), torch.from_numpy(drop),
            tp["rope_cos"][:T], tp["rope_sin"][:T], models["tc"], 200, tcache,
            use_cache=use, step_idx=step)
        for o, r in zip(tout, jout):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5, rtol=1e-5)
        assert tuple(tcache[0].shape) == shape
        for o, r in zip(tcache, jcache):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5, rtol=1e-5)
    # a full step's outputs are the exact forward's
    exact = tf5.dit_forward(tp, torch.from_numpy(noise), torch.from_numpy(cond),
                            torch.from_numpy(drop), tp["rope_cos"][:T], tp["rope_sin"][:T],
                            models["tc"], kv_len=200, step_idx=4)
    full = tf5.dit_forward_cached(tp, torch.from_numpy(noise), torch.from_numpy(cond),
                                  torch.from_numpy(drop), tp["rope_cos"][:T],
                                  tp["rope_sin"][:T], models["tc"], 200, None,
                                  use_cache=False, step_idx=4)
    for x, y in zip(exact, full[:2]):
        torch.testing.assert_close(x, y, atol=2e-6, rtol=1e-6)


def test_synthesize_layer_cache_matches_jax(models):
    """synthesize with layer_cache_interval=2 (full steps 0, 2, 4) against
    tts_tpu's lax.cond loop; the exact loop's audio differs from it."""
    audio, (ref_text, gen_text) = _audio(6), REQUESTS[0]
    jpipe, pipe = _pipes(models, layer_cache_interval=2)
    wav_j, _ = jpipe.synthesize(audio, ref_text, gen_text, seed=7)
    frames = pipe._prepare(audio, ref_text, gen_text)[4][2]
    noise = np.asarray(jax.random.normal(jax.random.key(7), (1, frames, models["jc"].n_mels)))
    wav_t, stats = pipe.synthesize(audio, ref_text, gen_text, noise=noise)
    _close(wav_t, wav_j)
    assert np.isfinite(stats.peak)
    pipe.layer_cache_interval = 1
    exact, _ = pipe.synthesize(audio, ref_text, gen_text, noise=noise)
    assert exact.shape == wav_t.shape and not np.array_equal(exact, wav_t)


@pytest.mark.parametrize("quantize", [None, 8])
def test_synthesize_batch_matches_jax(models, quantize):
    """Three requests of different references and lengths in one batch:
    each row within 2 LSB of tts_tpu's synthesize_batch (its (B, frames,
    n_mels) draw passed in), audio_s the sum of the samples returned."""
    reqs = [(_audio(10 + i, 8000 + 3000 * i), r, g) for i, (r, g) in enumerate(REQUESTS)]
    jpipe, pipe = _pipes(models, quantize=quantize)
    with _Interpret():
        outs_j, _ = jpipe.synthesize_batch(reqs, seed=5)
    frames = pipe._prepare_batch(reqs)[5]
    noise = np.asarray(jax.random.normal(jax.random.key(5),
                                         (len(reqs), frames, models["jc"].n_mels)))
    outs_t, stats = pipe.synthesize_batch(reqs, noise=noise)
    assert len(outs_t) == len(reqs) and len({len(o) for o in outs_t}) == len(reqs)
    for got, ref in zip(outs_t, outs_j):
        _close(got, np.asarray(ref))
    assert stats.audio_s == sum(len(o) for o in outs_t) / models["tc"].sample_rate
    assert np.isfinite(stats.peak)


def test_synthesize_batch_of_one_is_synthesize(models):
    """A batch of one draws the solo request's noise from the same seed and
    gives its samples bit for bit."""
    _, pipe = _pipes(models)
    audio, (ref_text, gen_text) = _audio(8), REQUESTS[1]
    solo, _ = pipe.synthesize(audio, ref_text, gen_text, seed=3)
    (one,), stats = pipe.synthesize_batch([(audio, ref_text, gen_text)], seed=3)
    np.testing.assert_array_equal(one, solo)
    assert stats.audio_s == len(solo) / models["tc"].sample_rate
    with pytest.warns(UserWarning, match="layer_cache_interval"):
        pipe.layer_cache_interval = 2
        (cached,), _ = pipe.synthesize_batch([(audio, ref_text, gen_text)], seed=3)
    np.testing.assert_array_equal(cached, solo)
    with pytest.raises(ValueError):
        pipe.synthesize_batch([(audio, ref_text, gen_text)], noise=np.zeros((2, 4, 100)))


@pytest.mark.parametrize("quantize", [None, 8])
def test_per_row_mods_routes(models, monkeypatch, quantize):
    """The routes of a per-row step (2 requests at steps 1 and 4) against
    the solo int step's: kernels 7 and 8 (one shared mod vector) are left
    for the plain attention projections with kernel 1, kernels 3 (float
    weights) and 6 (int8) take the (4, 3, D) mods; the int step keeps
    kernels 7, 1, 8, 6 (int8) or 1, 3 (float) with (1, 3, D)."""
    calls = []
    for name in ("ln_qkv_q8", "out_proj_residual_q8", "mlp_block_fused_q8",
                 "mlp_block_fused", "flash_attention_flat"):
        fn = getattr(tf5, name)

        def rec(*a, _f=fn, _n=name, **k):
            mods = a[1] if _n.startswith("mlp") else None
            calls.append((_n, None if mods is None else tuple(mods.shape)))
            return _f(*a, **k)

        monkeypatch.setattr(tf5, name, rec)
    cfg = models["tc"]
    params = models["tp"] if quantize is None else quantize_dit(models["tp"], quantize)
    noise, cond, drop = (torch.from_numpy(a) for a in _inputs(cfg, 2, 7))
    rope = (params["rope_cos"][:T], params["rope_sin"][:T])
    kv = torch.tensor([256, 0] * 2)           # the second request an idle row

    def run(step):
        calls.clear()
        out = tf5.dit_forward(params, noise, cond, drop, *rope, cfg, kv_len=kv, step_idx=step)
        assert all(torch.isfinite(o).all() for o in out)
        return sorted(set(calls)), len(calls)

    mlp = "mlp_block_fused" if quantize is None else "mlp_block_fused_q8"
    d = cfg.dim
    assert run(torch.tensor([1, 4])) == (
        [("flash_attention_flat", None), (mlp, (4, 3, d))], 2 * cfg.depth)
    solo = [("flash_attention_flat", None), (mlp, (1, 3, d))]
    if quantize is not None:
        solo += [("ln_qkv_q8", None), ("out_proj_residual_q8", None)]
    assert run(2) == (sorted(solo), len(solo) * cfg.depth)
