"""The port's kernels 4 and 5 (ops/flash_attention.flash_attention on CPU
tensors: the twins `flash_onepass_plain` and `flash_online_plain`) against
tts_tpu's Pallas `flash_attention` in interpret mode, as
tests/test_flash_attention.py runs it. Same numpy inputs, fp32 on both
sides.

Tolerance: atol 2e-5, the one the Pallas kernels' own parity tests use:
both sides compute the same fp32 math at the same points, and only the
order of the fp32 sums differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tts_tpu.ops.flash_attention import flash_attention as pallas
from tts_tpu_torch.ops import flash_attention as tfa

B, H, S = 2, 4, 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(d: int, seed: int):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, H, S, d)) * 0.5).astype(np.float32) for _ in range(3)]


def _kv(kv_len):
    """numpy kv_len for both sides: a scalar int32 or a (B,) vector."""
    return np.asarray(kv_len, np.int32)


def _both(q, k, v, kv_len, **kw):
    kv = _kv(kv_len)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(kv), **kw))
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(kv), **kw)
    return out.numpy(), ref


@pytest.mark.parametrize("kv_len", [256, 150, 0, (256, 97)])
@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize("head_block", [1, 2])
@pytest.mark.parametrize("d", [64, 128, 192])
def test_onepass_matches_pallas(d, head_block, packed_out, kv_len):
    """Kernel 4: block_kv == S, scale d^-0.5 (folded with log2e)."""
    q, k, v = _qkv(d, 31 + d)
    out, ref = _both(q, k, v, kv_len, scale=d ** -0.5, block_q=128, block_kv=S,
                     head_block=head_block, packed_out=packed_out)
    assert out.shape == ((B, S, H * d) if packed_out else (B, H, S, d))
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)
    if kv_len == 0:
        # every key masked: the 1e-37 guard gives zeros, not NaN
        assert not out.any()


@pytest.mark.parametrize("kv_len", [256, 150, 0])
@pytest.mark.parametrize("block_kv", [64, 128])
@pytest.mark.parametrize("d", [64, 128, 192])
def test_online_matches_pallas(d, block_kv, kv_len):
    """Kernel 5: the online softmax over kv blocks, scalar kv_len."""
    q, k, v = _qkv(d, 41 + d)
    out, ref = _both(q, k, v, kv_len, scale=d ** -0.5, block_q=128, block_kv=block_kv)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)
    if kv_len == 0:
        # every score is -1e30: each row is the mean of v over all S keys
        np.testing.assert_allclose(out, np.broadcast_to(v.mean(axis=2, keepdims=True),
                                                        out.shape), atol=2e-6)


def test_online_with_scale_one_and_head_block_zero():
    """head_block 0 forces kernel 5 at block_kv == S; scale 1 skips the
    multiply, as tts_tpu's body does."""
    q, k, v = _qkv(64, 7)
    out, ref = _both(q, k, v, 200, block_q=64, block_kv=S, head_block=0)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


def test_kernel4_and_5_agree_where_both_apply():
    """With kv_len >= 1 and logits well inside exp2's range the two softmax
    forms are the same function."""
    q, k, v = [torch.from_numpy(a) for a in _qkv(128, 3)]
    a = tfa.flash_attention(q, k, v, 180, scale=0.1, block_kv=S)
    b = tfa.flash_attention(q, k, v, 180, scale=0.1, block_kv=64)
    torch.testing.assert_close(a, b, atol=2e-6, rtol=0)


@pytest.mark.parametrize("case,exc", [
    ("seq_not_multiple", ValueError),
    ("packed_online", NotImplementedError),
    ("vector_kv_online", NotImplementedError),
])
def test_errors_match_pallas(case, exc):
    s = 100 if case == "seq_not_multiple" else S
    q = np.zeros((B, H, s, 64), np.float32)
    kw = dict(block_q=64, block_kv=64)
    kv = None
    if case == "packed_online":
        kw["packed_out"] = True
    if case == "vector_kv_online":
        kv = np.array([256, 100], np.int32)
    with pytest.raises(exc):
        pallas(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
               None if kv is None else jnp.asarray(kv), **kw)
    t = torch.from_numpy(q)
    with pytest.raises(exc):
        tfa.flash_attention(t, t, t, None if kv is None else torch.from_numpy(kv), **kw)


@pytest.mark.parametrize("dtype,d,s,want", [
    (torch.bfloat16, 64, 1408, True),
    (torch.float32, 192, 256, True),
    (torch.float32, 256, 128, True),
    (torch.float32, 320, 128, False),
    (torch.float16, 64, 128, False),
    (torch.bfloat16, 96, 128, False),
    (torch.bfloat16, 64, 100, False),
])
def test_mha_kernel_fits(dtype, d, s, want):
    assert tfa.mha_kernel_fits(dtype, d, s) == want


@pytest.mark.parametrize("dtype,d,t,want", [
    (torch.bfloat16, 64, 1408, True),
    (torch.bfloat16, 128, 256, True),
    (torch.float32, 64, 256, False),
    (torch.bfloat16, 192, 256, False),
    (torch.bfloat16, 64, 100, False),
])
def test_flat_kernel_fits(dtype, d, t, want):
    assert tfa.flat_kernel_fits(dtype, d, t) == want


def test_flat_twin_at_head_dim_128_matches_pallas():
    """Kernel 1 at D 128 (one head a 128-lane block in tts_tpu)."""
    from tts_tpu.models.f5 import f5_rope_tables
    from tts_tpu.ops.flash_attention import flash_attention_flat as pallas_flat

    b, h, t, d = 2, 2, 256, 128
    rng = np.random.default_rng(17)
    qkv = (rng.standard_normal((b, t, 3 * h * d)) * 0.5).astype(np.float32)
    cos, sin = f5_rope_tables(t, d)
    kv = np.array([256, 131], np.int32)
    ref = pallas_flat(jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin),
                      jnp.asarray(kv), heads=h, block_q=128, interpret=True)
    out = tfa.flash_attention_flat(torch.from_numpy(qkv), torch.from_numpy(cos),
                                   torch.from_numpy(sin), torch.from_numpy(kv), heads=h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
