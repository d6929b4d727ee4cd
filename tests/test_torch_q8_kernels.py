"""The port's W8A8 kernel wrappers on CPU tensors (their plain PyTorch
twins) against the tts_tpu Pallas kernels they port, run in Pallas
interpret mode as tts_tpu's own kernel tests run them: kernel 6
`mlp_block_fused_q8`, kernel 7 `ln_qkv_q8`, kernel 8 `out_proj_residual_q8`
and kernel 9 `quantized_matmul`. Same numpy inputs on both sides, fp32 on
both sides, the shapes of tts_tpu's own parity tests.

Tolerance: atol 3e-5, rtol 1e-4, the bound the JAX package holds these
kernels to against their reference chain: both sides quantize the same
rows with the same rounding rule and sum the int8 products exactly; only
the fp32 LayerNorm sums and the gelu's tanh differ by ulps. Such an ulp can
move one activation across a .5 and round it to the other int8 value (a
"flip"). A flip changes its row's outputs by at most one quantization step
of that activation, xs * max|w[:, j]|, so an element past the tolerance is
allowed only as a named flip within that step, in at most one row."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu_torch.ops.dit_mlp import mlp_block_fused_q8
from tts_tpu_torch.ops.quant_matmul import (ln_qkv_q8, out_proj_residual_q8,
                                            quantized_matmul)

ATOL, RTOL = 3e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jq(w):
    from tts_tpu.quant.weight_only import quantize_int8
    qt = quantize_int8(jnp.asarray(w))
    return np.asarray(qt.q), np.asarray(qt.scale)


def _row_scale(v):
    """The kernels' per-row activation scale, from fp32 rows (..., K)."""
    return np.maximum(np.abs(v).max(-1), np.float32(1e-8)) * np.float32(1 / 127)


def assert_close_or_flip(out, ref, step):
    """out, ref (..., N); step (..., N), the output change of one flipped
    activation in that row. Every element within ATOL + RTOL |ref|; beyond
    that only the elements of one row, each within one step more."""
    step = np.broadcast_to(step, ref.shape).reshape(-1, ref.shape[-1])
    out, ref = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
    err = np.abs(out - ref)
    bad = err > ATOL + RTOL * np.abs(ref)
    rows = np.unique(np.nonzero(bad)[0])
    for r in rows:
        cols = np.nonzero(bad[r])[0]
        print(f"int8 rounding flip in row {r}: {len(cols)} elements past the "
              f"tolerance, max |err| {err[r, cols].max():.3g} against one "
              f"step {step[r, cols].min():.3g}")
    assert len(rows) <= 1, f"{len(rows)} rows past the tolerance: {rows}"
    assert np.all(err[bad] <= ATOL + RTOL * np.abs(ref[bad]) + step[bad])


def test_ln_qkv_q8_matches_pallas():
    from tts_tpu.ops.quant_matmul import ln_qkv_q8 as pallas

    rng = np.random.default_rng(4)
    b, t, d, n = 2, 64, 128, 384
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    w = (rng.standard_normal((d, n)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(n) * 0.1).astype(np.float32)
    mods = (rng.standard_normal((2, d)) * 0.1).astype(np.float32)
    wq, ws = _jq(w)
    ref = np.asarray(pallas(*map(jnp.asarray, (x, mods, wq, ws, bias)),
                            block_rows=32, interpret=True))
    out = ln_qkv_q8(*map(_t, (x, mods, wq, ws, bias)))
    assert out.shape == (b, t, n) and out.dtype == torch.float32
    xf = torch.from_numpy(x)
    nrm = torch.nn.functional.layer_norm(xf, (d,), eps=1e-6) * (1 + _t(mods[1])) + _t(mods[0])
    step = _row_scale(nrm.numpy())[..., None] * np.abs(w).max(0)
    assert_close_or_flip(out.numpy(), ref, step)


def test_out_proj_residual_q8_matches_pallas():
    from tts_tpu.ops.quant_matmul import out_proj_residual_q8 as pallas

    rng = np.random.default_rng(5)
    b, t, hd, d = 2, 64, 256, 128
    o = rng.standard_normal((b, t, hd)).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    w = (rng.standard_normal((hd, d)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(d) * 0.1).astype(np.float32)
    gate = (rng.standard_normal(d) * 0.1).astype(np.float32)
    wq, ws = _jq(w)
    ref = np.asarray(pallas(*map(jnp.asarray, (o, wq, ws, bias, gate, x)),
                            block_rows=32, interpret=True))
    out = out_proj_residual_q8(*map(_t, (o, wq, ws, bias, gate, x)))
    # the quantization is of the input rows themselves: no ulp differs
    # before it, so no flip is allowed
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_matmul_matches_pallas(dtype):
    """fp32 and bf16 activations, each written back in its dtype. In bf16
    both sides quantize the same bf16 rows and round the same fp32 rescale
    once to bf16: within one bf16 step (2^-8 relative) of each other."""
    from jax.experimental.pallas import tpu as pltpu

    from tts_tpu.ops.quant_matmul import quantized_matmul as pallas

    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 256)) * 0.1).astype(np.float32)
    wq, ws = _jq(w)
    xj = jnp.asarray(x, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas(xj, jnp.asarray(wq), jnp.asarray(ws), block_m=128, block_n=256)
    assert ref.dtype == xj.dtype
    ref = np.asarray(ref.astype(jnp.float32))
    out = quantized_matmul(_t(xj.astype(jnp.float32)).to(getattr(torch, dtype)), _t(wq),
                           _t(ws))
    assert out.dtype == getattr(torch, dtype)
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == "float32" else dict(atol=ATOL, rtol=2.0 ** -8)
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)


@pytest.mark.parametrize("per_row", [False, True])
def test_mlp_block_fused_q8_matches_pallas(per_row):
    from tts_tpu.ops.dit_mlp import mlp_block_fused_q8 as pallas

    rng = np.random.default_rng(3)
    b, t, d, f = 2, 64, 128, 256
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    mods = (rng.standard_normal((b, 3, d) if per_row else (3, d)) * 0.1).astype(np.float32)
    (w1q, s1), (w2q, s2) = _jq(w1), _jq(w2)
    args = (x, mods, w1q, s1, b1, w2q, s2, b2)
    ref = np.asarray(pallas(*map(jnp.asarray, args), block_rows=32, interpret=True))
    out = mlp_block_fused_q8(*map(_t, args))
    assert out.shape == (b, t, d) and out.dtype == torch.float32
    # a flip in the hidden layer moves its row's y by at most one step of
    # the second product; gate scales it into the output
    from tts_tpu_torch.ops.dit_mlp import _gelu_tanh
    m = _t(mods).reshape(-1, 3, d)
    nrm = torch.nn.functional.layer_norm(_t(x), (d,), eps=1e-6) * (1 + m[:, 1:2]) + m[:, 0:1]
    h = _gelu_tanh(nrm @ _t(w1) + _t(b1)).numpy()
    step = _row_scale(h)[..., None] * np.abs(w2).max(0) * np.abs(m[:, 2:3].numpy())
    assert_close_or_flip(out.numpy(), ref, step)


def test_q8_wrappers_reject_bad_shapes():
    x = torch.zeros(1, 64, 128)
    wq, ws = torch.zeros(128, 256, dtype=torch.int8), torch.ones(256)
    with pytest.raises(ValueError):
        ln_qkv_q8(x, torch.zeros(3, 128), wq, ws, torch.zeros(256))
    with pytest.raises(ValueError):
        out_proj_residual_q8(x, wq, ws, torch.zeros(256), torch.zeros(256), x)
    with pytest.raises(ValueError):
        quantized_matmul(x[0], wq[:64], ws)
    with pytest.raises(ValueError):
        mlp_block_fused_q8(x, torch.zeros(3, 128), wq, ws, torch.zeros(256), wq,
                           torch.ones(128), torch.zeros(128))


def test_quantized_rows_round_half_to_even():
    """Rows whose values sit exactly on .5 steps of their scale: round half
    to even, clip at 127, and the 1e-8 floor of an all-zero row."""
    from tts_tpu_torch.ops.quant_matmul import quantize_rows

    xs = np.float32(127) * np.float32(1 / 127)
    row = np.array([[127, 0.5, 1.5, 2.5, -0.5, -2.5, 3.49, -127]], np.float32) / xs
    q, s = quantize_rows(_t(row.astype(np.float32)))
    np.testing.assert_array_equal(q.numpy(), [[127, 0, 2, 2, 0, -2, 3, -127]])
    q0, s0 = quantize_rows(torch.zeros(1, 8))
    assert q0.abs().sum() == 0 and s0.item() == np.float32(1e-8) * np.float32(1 / 127)
