"""The port's quantized F5 slice against tts_tpu on the CPU: the F5Pipeline
quantize modes' weights, the W8A8 DiT (kernels 7, 1, 8 and 6 through
their twins) against tts_tpu's W8A8 route (its Pallas kernels in interpret
mode: `tts_tpu.models.f5.Q8_INTERPRET`, flipped for the call and put back),
and the whole W8A8 and int4 `synthesize` against tts_tpu's.

Both sides quantize the same weights bit for bit and each activation row
with the same rule. They differ in attention's association: tts_tpu's
interpret route runs a max-subtracted softmax (`_plain_packed`), the port
kernel 1's twin (the TPU kernel's exp2 softmax). An ulp there can flip an
int8 rounding of the next projection's input (one quantization step), so
the DiT is held to a mean |diff| of 5e-5, a tenth of the JAX package's
single-step W8A8 budget (tests/test_w8a8_bound.py)."""
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
from tts_tpu_torch.ops import _build
from tts_tpu_torch.quant.weight_only import QTensor, QTensorG
from tts_tpu_torch.runtime.f5 import F5Pipeline, quantize_dit
from tts_tpu_torch.weights.convert import params_from_jax

# the config of tests/test_w8a8_bound.py: t % 128 == 0 and head_dim 64, so
# the W8A8 attention route is taken
BOUND = dict(dim=128, depth=2, heads=2, head_dim=64, ff_mult=2, text_dim=32,
             conv_layers=1, conv_mult=2, n_mels=16, vocab_size=20, nfe_steps=8,
             n_fft=256, hop=64, win_length=256, max_signal_len=128, freq_embed_dim=16)
T = 128
SMALL = dict(dim=128, depth=2, heads=2, head_dim=64, text_dim=64, conv_layers=1,
             nfe_steps=4, max_signal_len=512, vocab_size=40)
VOCOS = dict(dim=32, intermediate_dim=64, num_layers=2)
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz,.")}


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
def bound():
    cfg = jf5.F5Config(**BOUND)
    jp = jf5.init_params(cfg, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    rng = np.random.default_rng(21)
    noise = rng.standard_normal((1, T, cfg.n_mels)).astype(np.float32)
    cond = (rng.standard_normal((1, T, cfg.n_mels + cfg.text_dim)) * 0.1).astype(np.float32)
    return dict(jc=cfg, tc=tf5.F5Config(**BOUND), jp=jp, tp=tp, noise=noise, cond=cond)


def _jax_q8(jp):
    """tts_tpu's F5Pipeline quantize=8 weights, without its vocoder."""
    from tts_tpu.quant.weight_only import quantize_int8

    blocks = [{**b, "attn": {**b["attn"], "wqkv": quantize_int8(b["attn"]["wqkv"]),
                             "wo": quantize_int8(b["attn"]["wo"])},
               "ff1": {**b["ff1"], "w": quantize_int8(b["ff1"]["w"])},
               "ff2": {**b["ff2"], "w": quantize_int8(b["ff2"]["w"])}}
              for b in jp["blocks"]]
    return {**jp, "blocks": blocks}


@pytest.mark.parametrize("step", [0, 5])
def test_w8a8_dit_forward_matches_jax(bound, step):
    cfg, jq = bound["jc"], _jax_q8(bound["jp"])
    tq = quantize_dit(bound["tp"], "w8a8")
    noise, cond = bound["noise"], bound["cond"]
    args = (jnp.asarray(noise), jnp.asarray(cond), jnp.zeros_like(jnp.asarray(cond)))
    with _Interpret():
        ref = jf5.dit_forward(jq, *args, jq["time_table"][step], jq["rope_cos"][:T],
                              jq["rope_sin"][:T], cfg, kv_len=jnp.int32(T - 8),
                              step_idx=step)
    _build.LAUNCHES.clear()
    out = tf5.dit_forward(tq, torch.from_numpy(noise), torch.from_numpy(cond),
                          torch.zeros(cond.shape), tq["rope_cos"][:T], tq["rope_sin"][:T],
                          bound["tc"], kv_len=T - 8, step_idx=step)
    # each block took kernels 7, 1, 8 and 6 (the twins, counted by no launch)
    assert sum(_build.LAUNCHES.values()) == 0
    for o, r in zip(out, ref):
        diff = np.abs(o.numpy() - np.asarray(r))
        assert diff.mean() <= 5e-5, f"mean |diff| {diff.mean():.3g}"
        assert diff.max() <= 1e-3, f"max |diff| {diff.max():.3g}"


def test_w8a8_route_is_taken(bound, monkeypatch):
    """Int8 weights send every block through kernels 7, 1, 8 and 6, and no
    block through kernel 3; int4 weights through the plain chain with
    kernel 1; a mod per batch row keeps attention off kernels 7 and 8."""
    calls = []
    for name in ("ln_qkv_q8", "out_proj_residual_q8", "mlp_block_fused_q8",
                 "mlp_block_fused", "flash_attention_flat"):
        fn = getattr(tf5, name)
        monkeypatch.setattr(tf5, name, lambda *a, _f=fn, _n=name, **k:
                            (calls.append(_n), _f(*a, **k))[1])
    cfg, tp = bound["tc"], bound["tp"]
    x = torch.from_numpy(bound["noise"])
    c = torch.from_numpy(bound["cond"])
    rope = (tp["rope_cos"][:T], tp["rope_sin"][:T])

    def run(params):
        calls.clear()
        tf5.dit_forward(params, x, c, torch.zeros(c.shape), *rope, cfg, kv_len=T - 8)
        return sorted(set(calls)), len(calls)

    q8 = quantize_dit(tp, 8)
    assert run(q8) == (["flash_attention_flat", "ln_qkv_q8", "mlp_block_fused_q8",
                        "out_proj_residual_q8"], 4 * cfg.depth)
    q4 = quantize_dit(tp, 4)
    assert isinstance(q4["blocks"][0]["ff2"]["w"], QTensorG)
    assert run(q4) == (["flash_attention_flat"], cfg.depth)
    assert run(tp) == (["flash_attention_flat", "mlp_block_fused"], 2 * cfg.depth)
    blk = q8["blocks"][0]
    mod = torch.cat([tp["ada_table"][0, 0][None, None]] * 2)      # (2, 1, 6D)
    calls.clear()
    tf5._dit_block(blk, torch.cat([x.new_zeros(1, T, cfg.dim)] * 2) + 0.1, mod,
                   *rope, cfg, T - 8)
    assert calls == ["flash_attention_flat", "mlp_block_fused_q8"]
    with pytest.raises(ValueError):
        quantize_dit(tp, 16)


@pytest.mark.parametrize("ff,q8", [(2048, True), (2176, False)])
def test_w8a8_mlp_route_keeps_to_kernel_limits(bound, monkeypatch, ff, q8):
    """An FFN width past the CUDA kernels' 2048-deep rows (ff2's depth)
    takes the plain chain with a quantized dense on every device, as it
    must on the card; up to 2048 it takes kernel 6."""
    from tts_tpu_torch.ops.quant_matmul import q8_fits
    from tts_tpu_torch.quant.weight_only import quantize_int8_eager

    assert q8_fits(2048, 128) and not q8_fits(2112, 128) and not q8_fits(2048, 192)
    assert not q8_fits(96, 128)
    calls = []
    fn = tf5.mlp_block_fused_q8
    monkeypatch.setattr(tf5, "mlp_block_fused_q8", lambda *a, **k:
                        (calls.append("q8"), fn(*a, **k))[1])
    cfg, tp = bound["tc"], bound["tp"]
    rng = np.random.default_rng(22)
    blk = dict(tp["blocks"][0])
    blk["attn"] = {**blk["attn"], "wqkv": quantize_int8_eager(blk["attn"]["wqkv"]),
                   "wo": quantize_int8_eager(blk["attn"]["wo"])}
    for name, shape in (("ff1", (cfg.dim, ff)), ("ff2", (ff, cfg.dim))):
        w = torch.from_numpy((rng.standard_normal(shape) * 0.02).astype(np.float32))
        blk[name] = {"w": quantize_int8_eager(w), "b": torch.zeros(shape[1])}
    x = torch.from_numpy(rng.standard_normal((2, T, cfg.dim)).astype(np.float32))
    mod = tp["ada_table"][0, 0].reshape(1, 1, -1)
    out = tf5._dit_block(blk, x, mod, tp["rope_cos"][:T], tp["rope_sin"][:T], cfg, T - 8)
    assert calls == (["q8"] if q8 else []) and torch.isfinite(out).all()


def _nfe(params, bound, dt=1.0 / BOUND["nfe_steps"]):
    cfg = bound["tc"]
    carry = torch.from_numpy(bound["noise"])
    cond = torch.from_numpy(bound["cond"])
    for i in range(cfg.nfe_steps - 1):
        pred, pred1 = tf5.dit_forward(params, carry, cond, torch.zeros(cond.shape),
                                      params["rope_cos"][:T], params["rope_sin"][:T],
                                      cfg, kv_len=T - 8, step_idx=i)
        carry = carry + (pred + (pred - pred1) * cfg.cfg_strength) * dt
    return carry.numpy()


def test_w8a8_nfe_delta_bounded(bound):
    """The port's W8A8 NFE loop against its fp32 one: within the mel-L1
    budget tests/test_w8a8_bound.py holds tts_tpu to."""
    ref = _nfe(bound["tp"], bound)
    out = _nfe(quantize_dit(bound["tp"], "w8a8"), bound)
    assert np.isfinite(out).all()
    assert np.abs(out - ref).mean() <= 2e-3


@pytest.fixture(scope="module")
def small():
    jc, tc = jf5.F5Config(**SMALL), tf5.F5Config(**SMALL)
    jvc, tvc = jvo.VocosConfig(**VOCOS), tvo.VocosConfig(**VOCOS)
    jp = jf5.init_params(jc, jax.random.key(0))
    jvp = jvo.init_params(jvc, jax.random.key(1))
    # a louder vocoder (magnitude bias e^3), as tests/test_torch_f5.py
    jvp["head"]["b"] = jvp["head"]["b"].at[:jvc.n_fft // 2 + 1].set(3.0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    tvp = params_from_jax(jax.tree.map(np.asarray, jvp), "cpu", torch.float32)
    return dict(jc=jc, tc=tc, jvc=jvc, tvc=tvc, jp=jp, jvp=jvp, tp=tp, tvp=tvp)


@pytest.mark.parametrize("quantize", [8, 4])
def test_quantized_params_are_tts_tpus(small, quantize):
    """F5Pipeline's quantized tree, converted from tts_tpu's, against the
    port's own: q and scale bit-equal (int8: the eager quantizer; int4:
    the k_quant search, tts_tpu's packed form unpacked)."""
    jpipe = JaxPipeline(small["jp"], small["jc"], VOCAB, small["jvp"], small["jvc"],
                        quantize=quantize)
    ref = params_from_jax(jax.tree.map(np.asarray, jpipe.params), "cpu", torch.float32)
    pipe = F5Pipeline(tf5.F5Model(small["tc"], small["tp"]), VOCAB,
                      tvo.VocosModel(small["tvc"], small["tvp"]), quantize=quantize)
    n = 0
    for bj, bt in zip(ref["blocks"], pipe.params["blocks"]):
        for a, b in ((bj["attn"]["wqkv"], bt["attn"]["wqkv"]),
                     (bj["attn"]["wo"], bt["attn"]["wo"]),
                     (bj["ff1"]["w"], bt["ff1"]["w"]), (bj["ff2"]["w"], bt["ff2"]["w"])):
            if quantize == 4:
                a = a.unpack_runtime()
                assert isinstance(b, QTensorG)
            else:
                assert isinstance(a, QTensor) and isinstance(b, QTensor)
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
            n += 1
    assert n == 4 * small["tc"].depth
    assert torch.equal(pipe.params["blocks"][0]["ada"]["w"], small["tp"]["blocks"][0]["ada"]["w"])


@pytest.mark.parametrize("quantize", ["w8a8", 4])
def test_quantized_synthesize_matches_jax(small, quantize):
    rng = np.random.default_rng(6)
    audio = (rng.standard_normal(12000) * 3000).astype(np.int16)
    ref_text, gen_text = "hello there.", " some words here"
    jpipe = JaxPipeline(small["jp"], small["jc"], VOCAB, small["jvp"], small["jvc"],
                        quantize=quantize)
    with _Interpret():
        wav_j, _ = jpipe.synthesize(audio, ref_text, gen_text, seed=7)
    pipe = F5Pipeline(tf5.F5Model(small["tc"], small["tp"]), VOCAB,
                      tvo.VocosModel(small["tvc"], small["tvp"]), quantize=quantize)
    frames = pipe._prepare(audio, ref_text, gen_text)[4][2]
    noise = np.asarray(jax.random.normal(jax.random.key(7),
                                         (1, frames, small["jc"].n_mels)))
    wav_t, stats = pipe.synthesize(audio, ref_text, gen_text, noise=noise)
    assert wav_t.dtype == np.int16 and wav_t.shape == wav_j.shape
    assert np.abs(wav_j.astype(np.int32)).max() > 3000 and np.isfinite(stats.peak)
    # measured on the CPU: correlation 1 - O(1e-9), at most 1 LSB apart (an
    # int16 truncation of float waveforms that agree to ~1e-6); 0.99999 and
    # 4 LSB leave room for an int8 rounding flip in a DiT activation
    corr = np.corrcoef(wav_t.astype(np.float64), wav_j.astype(np.float64))[0, 1]
    assert corr >= 0.99999, corr
    assert np.abs(wav_t.astype(np.int32) - wav_j.astype(np.int32)).max() <= 4
