"""The Qwen3-TTS decode kernels' wrappers on CPU tensors (their plain
PyTorch twins) against tts_tpu's Pallas kernels run in interpret mode:
ops/decode_attention.decode_gqa_attention (kernel 13),
ops/decode_mlp.fused_out_mlp (kernel 14, bf16 and int8 weights) and
ops/decode_mlp.fused_out_mlp_q8 (kernel 15, W8A8). Same numpy inputs on
both sides, fp32 activations on both sides.

Tolerances:
  * kernel 13: atol 1e-5, rtol 1e-5. Both sides walk the same blocks in
    the same order with the same online softmax; only the order of the fp32
    sums inside a block's two products differs. Scores of O(10) then differ
    by ulps (~1e-6), and each output is a weighted mean of values of O(1)
    that cancels, so the bound is absolute: a few ulps of max |v| (~4).
  * kernel 14: atol 3e-5, rtol 2e-4, tts_tpu's own bound for this kernel
    against its XLA chain: the TPU kernel adds the out-projection and the
    down product block by block (512 rows), the twin in one matmul.
  * kernel 15: atol 3e-5, rtol 1e-4 (tts_tpu's bound for its W8A8
    kernels), with the int8 rounding flips of tests/test_torch_q8_kernels.py:
    the RMSNorm's fp32 sum and silu's sigmoid are computed in another order
    or form on the two sides, so the normed row n or the product a can
    differ by an ulp. An ulp moves v / xs by at most 127 * 2^-23 (~1.5e-5),
    so it flips only an activation within that of a .5 boundary, and the
    flip changes it by one int8 step: its row's output moves by at most
    one step of that activation through the rest of the tail. The bound
    below charges a flip in h with one step of h through the gate/up and
    down products, and a flip in a with one step of a through w_down.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu_torch.ops.decode_attention import decode_gqa_attention
from tts_tpu_torch.ops.decode_mlp import (_pick_block, fused_out_mlp, fused_out_mlp_q8,
                                          out_mlp_fits)
from tts_tpu_torch.quant.weight_only import QTensor


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(rng, shapes, quant: bool):
    """(jax weights, port weights, float weights) of the given shapes:
    plain arrays, or tts_tpu's eager int8 QTensors and the port's with the
    same q and scale."""
    from tts_tpu.quant.weight_only import quantize_int8

    ws = [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in shapes]
    if not quant:
        return [jnp.asarray(w) for w in ws], [_t(w) for w in ws], ws
    qs = [quantize_int8(jnp.asarray(w)) for w in ws]
    return qs, [QTensor(q=_t(np.asarray(q.q)), scale=_t(np.asarray(q.scale))) for q in qs], ws


# ---------------------------------------------------------------- kernel 13

@pytest.mark.parametrize("scale", [1.0, 0.125])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("kv_len", [1, 100, 256, 300, 512])
def test_decode_gqa_attention_matches_pallas(kv_len, b, scale):
    """kv_len across the 256-row block edges of a T = 512 cache, G = 2.
    Rows >= kv_len hold large values: neither side may let them in."""
    from tts_tpu.ops.decode_attention import decode_gqa_attention as pallas

    rng = np.random.default_rng(41)
    h, kvh, t, d = 4, 2, 512, 64
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, t, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, t, d)).astype(np.float32)
    k[:, :, kv_len:] = 1e3
    v[:, :, kv_len:] = -1e3
    ref = pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len, scale=scale,
                 interpret=True)
    out = decode_gqa_attention(_t(q), _t(k), _t(v), kv_len, scale=scale)
    assert out.shape == (b, h, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bad", ["group", "block", "kv_len", "device"])
def test_decode_gqa_attention_rejects(bad):
    q = torch.zeros(1, 5 if bad == "group" else 4, 64)
    k = torch.zeros(1, 2, 384 if bad == "block" else 256, 64)
    kv_len = 0 if bad == "kv_len" else 3
    if bad == "device":
        q, k = q.to("meta"), k.to("meta")
    with pytest.raises(ValueError):
        decode_gqa_attention(q, k, k, kv_len)


# ---------------------------------------------------------------- kernel 14

@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("quant", [False, True])
def test_fused_out_mlp_matches_pallas(quant, b):
    """F = 1024: _pick_block gives two F-blocks of 512 on the TPU side."""
    from tts_tpu.ops.decode_mlp import fused_out_mlp as pallas

    rng = np.random.default_rng(42)
    a, h, f = 256, 128, 1024
    assert _pick_block(f) == 512
    x = (rng.standard_normal((b, h)) * 0.1).astype(np.float32)
    att = (rng.standard_normal((b, a)) * 0.1).astype(np.float32)
    wj, wt, _ = _weights(rng, [(a, h), (h, 2 * f), (f, h)], quant)
    ref = pallas(jnp.asarray(x), jnp.asarray(att), *wj, eps=1e-6, interpret=True)
    out = fused_out_mlp(_t(x), _t(att), *wt, eps=1e-6)
    assert out.shape == (b, h) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=2e-4)


def test_out_mlp_reference_matches_jax():
    from tts_tpu.ops.decode_mlp import out_mlp_reference as jref

    from tts_tpu_torch.ops.decode_mlp import out_mlp_reference

    rng = np.random.default_rng(43)
    x = (rng.standard_normal((2, 128)) * 0.1).astype(np.float32)
    att = (rng.standard_normal((2, 256)) * 0.1).astype(np.float32)
    wj, wt, _ = _weights(rng, [(256, 128), (128, 512), (256, 128)], True)
    ref = jref(jnp.asarray(x), jnp.asarray(att), *wj, eps=1e-6)
    np.testing.assert_allclose(out_mlp_reference(_t(x), _t(att), *wt, eps=1e-6).numpy(),
                               np.asarray(ref), atol=3e-5, rtol=2e-4)


def test_fused_out_mlp_rejects_mixed_and_bad_shapes():
    rng = np.random.default_rng(44)
    _, (wo, wgu, wd), _ = _weights(rng, [(64, 32), (32, 128), (64, 32)], True)
    x, att = torch.zeros(1, 32), torch.zeros(1, 64)
    with pytest.raises(ValueError):
        fused_out_mlp(x, att, wo, wgu.q.float(), wd)          # mixed kinds
    with pytest.raises(ValueError):
        fused_out_mlp(x, torch.zeros(1, 48), wo, wgu, wd)     # att width
    with pytest.raises(ValueError):
        fused_out_mlp_q8(x, att, wo.q.float(), wgu, wd)       # W8A8 needs int8
    assert out_mlp_fits(1, 2048, 1024, 3072) and out_mlp_fits(8, 2048, 1024, 3072)
    assert not out_mlp_fits(9, 2048, 1024, 3072)              # rows
    assert not out_mlp_fits(1, 2048, 1000, 3072)              # hidden % 32
    assert not out_mlp_fits(1, 2048, 1024, 8192)              # FFN past 4096


# ---------------------------------------------------------------- kernel 15

def _row_scale(v):
    return np.maximum(np.abs(v).max(-1), np.float32(1e-8)) * np.float32(1 / 127)


@pytest.mark.parametrize("b", [1, 8])
def test_fused_out_mlp_q8_matches_pallas(b):
    """F = 1024: two activation blocks of 512, each with its own scales."""
    from tts_tpu.ops.decode_mlp import fused_out_mlp_q8 as pallas

    rng = np.random.default_rng(45)
    a, h, f = 256, 128, 1024
    x = (rng.standard_normal((b, h)) * 0.1).astype(np.float32)
    att = (rng.standard_normal((b, a)) * 0.1).astype(np.float32)
    wj, wt, (wo, wgu, wd) = _weights(rng, [(a, h), (h, 2 * f), (f, h)], True)
    ref = np.asarray(pallas(jnp.asarray(x), jnp.asarray(att), *wj, eps=1e-6,
                            interpret=True))
    out = fused_out_mlp_q8(_t(x), _t(att), *wt, eps=1e-6).numpy()
    assert out.shape == (b, h)
    # one step of each flip, from the float chain: a flip in a (block j of
    # row b) moves output n by as_j |wd[f, n]|; a flip in h moves g and u by
    # hs |w_gate_up[k, :]|, so a_f by at most that times |d a / d g| +
    # |d a / d u| <= 1.1 |u_f| + |silu(g_f)|, and output n by the sum over f
    # of those times |wd[f, n]| (plus the flips in a that follows)
    x2 = x + att @ wo
    hn = x2 / np.sqrt((x2 * x2).mean(-1, keepdims=True) + 1e-6)
    g, u = np.split(hn @ wgu, 2, axis=-1)
    silu = g / (1 + np.exp(-g))
    as_max = (np.abs(silu * u).reshape(b, -1, 512).max(-1) / 127).max(-1)[:, None]
    a_step = as_max * np.abs(wd).max(0)[None]
    da = _row_scale(hn)[:, None] * np.abs(wgu).max() * (1.1 * np.abs(u) + np.abs(silu))
    step = da @ np.abs(wd) + a_step
    err = np.abs(out - ref)
    bad = err > 3e-5 + 1e-4 * np.abs(ref)
    rows = np.unique(np.nonzero(bad)[0])
    for r in rows:
        print(f"int8 rounding flip in row {r}: {bad[r].sum()} elements past the "
              f"tolerance, max |err| {err[r][bad[r]].max():.3g}")
    assert len(rows) <= 1, f"{len(rows)} rows past the tolerance: {rows}"
    assert np.all(err[bad] <= (3e-5 + 1e-4 * np.abs(ref) + step)[bad])
