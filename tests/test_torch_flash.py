"""The port's kernels 4 and 5 (ops/flash_attention.flash_attention on CPU
tensors: the twins `flash_onepass_plain` and `flash_online_plain`) against
tts_tpu's Pallas `flash_attention` in interpret mode, as
tests/test_flash_attention.py runs it, D 64 to 256, kernel 4 also at the
flash core's edges (kv_len 0, 1, 63, 64, 65; packed); kernel 1's twin and
its RoPE pre-pass against tts_tpu's `flash_attention_flat` and its
prologue, at the same edges, one 64-row tile, and a row whose every logit
is below -66. Same numpy inputs, fp32 on both sides
(bf16 for the pre-pass, whose rounding point is the point).

Tolerance: atol 2e-5, the one the Pallas kernels' own parity tests use:
both sides compute the same fp32 math at the same points, and only the
order of the fp32 sums differs. The pre-pass is bit-equal."""
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
@pytest.mark.parametrize("d", [64, 128, 192, 256])
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


@pytest.mark.parametrize("kv_len", [0, 1, 63, 64, 65])
@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize("d", [64, 192, 256])
def test_onepass_edges_match_pallas(d, packed_out, kv_len):
    """Kernel 4 at the tile edges its CUDA forms must keep (no key, one key,
    a 64-key tile less one, one tile, one past it); packed, the output the
    bf16 core writes through strides."""
    q, k, v = _qkv(d, 51 + d)
    out, ref = _both(q, k, v, kv_len, scale=d ** -0.5, block_q=128, block_kv=S,
                     head_block=1, packed_out=packed_out)
    assert out.shape == ((B, S, H * d) if packed_out else (B, H, S, d))
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)
    assert (not out.any()) == (kv_len == 0)


@pytest.mark.parametrize("kv_len", [256, 150, 0, 1, 63, 64, 65])
@pytest.mark.parametrize("block_kv", [64, 128])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
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


def _flat_inputs(b, h, t, d, seed):
    from tts_tpu.models.f5 import f5_rope_tables

    rng = np.random.default_rng(seed)
    qkv = (rng.standard_normal((b, t, 3 * h * d)) * 0.5).astype(np.float32)
    cos, sin = f5_rope_tables(t, d)
    return qkv, cos, sin


def _flat_both(qkv, cos, sin, kv, h, block_q=128):
    from tts_tpu.ops.flash_attention import flash_attention_flat as pallas_flat

    kv = np.asarray(kv, np.int32)
    ref = pallas_flat(jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin),
                      jnp.asarray(kv), heads=h, block_q=block_q, interpret=True)
    out = tfa.flash_attention_flat(torch.from_numpy(qkv), torch.from_numpy(cos),
                                   torch.from_numpy(sin), torch.from_numpy(kv), heads=h)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("kv_len", [0, 1, 63, 64, 65, (0, 65)])
def test_flat_twin_edges_match_pallas(kv_len):
    """Kernel 1 at the flash core's tile edges: no key, one key, a tile
    less one, one tile, one past it, and per row."""
    qkv, cos, sin = _flat_inputs(2, 2, 256, 64, 23)
    out, ref = _flat_both(qkv, cos, sin, kv_len, 2)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)
    if kv_len == 0:
        # every key masked: the 1e-37 guard gives zeros, not NaN
        assert not out.any() and not ref.any()


@pytest.mark.parametrize("kv_len", [64, 33])
def test_flat_twin_one_tile_matches_pallas(kv_len):
    """T 64: one query tile and one key tile (tts_tpu at block_q 64)."""
    qkv, cos, sin = _flat_inputs(2, 2, 64, 64, 29)
    out, ref = _flat_both(qkv, cos, sin, kv_len, 2, block_q=64)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


def test_flat_twin_flushes_rows_below_minus_66_as_pallas():
    """A query row whose every logit is below -66: exp2(s log2e - 30) is
    under 2^-126, which the TPU flushes to 0, so the row is 0 (not NaN and
    not a denormal-weighted mean of v); the twin flushes as the kernel's
    ex2.approx.ftz does. Identity RoPE, every key leaning on dimension 0
    and query row 5 against it (logits about -90)."""
    b, h, t, d = 1, 2, 128, 64
    qkv, _, _ = _flat_inputs(b, h, t, d, 31)
    x = qkv.reshape(b, t, 3, h, d)
    x[:, :, 1, :, 0] = 3.0 + 0.1 * x[:, :, 1, :, 0]
    x[:, 5, 0] = 0.0
    x[:, 5, 0, :, 0] = -30.0
    qkv = x.reshape(b, t, -1)
    cos, sin = np.ones((t, d), np.float32), np.zeros((t, d), np.float32)
    out, ref = _flat_both(qkv, cos, sin, t, h)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)
    assert not out[:, 5].any() and not ref[:, 5].any()
    assert np.abs(out[:, 6]).sum() > 0


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 values, held as fp32 (exact in both packages)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("d", [64, 128])
def test_rope_prepass_twin_is_bit_equal(d):
    """Kernel 1's RoPE pre-pass (twin `rope_qk_plain`) on bf16 qkv: bit for
    bit the port's `_rope_qkv_flat`, tts_tpu's `_rope_qkv_flat` (XLA) and
    the prologue of tts_tpu's `_kernel_flat` (its `_rot_half` lines in a
    Pallas body, interpret mode): x * cos + rot_half(x) * sin in fp32,
    rounded to bf16."""
    import functools

    import jax
    from jax.experimental import pallas as pl

    from tts_tpu.models.f5 import _rope_qkv_flat as jax_rope
    from tts_tpu.ops.flash_attention import _rot_half
    from tts_tpu_torch.models.f5 import _rope_qkv_flat as torch_rope

    b, h, t = 2, 128 // d * 2, 128
    qkv, cos, sin = _flat_inputs(b, h, t, d, 37 + d)
    qkv = _bf16_exact(qkv * 4.0)
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    got = tfa.rope_qk_plain(tq, torch.from_numpy(cos), torch.from_numpy(sin), heads=h)
    assert got.shape == (2, b, h, t, d) and got.dtype == torch.bfloat16
    bits = got.view(torch.int16).numpy()

    q, k, _ = torch_rope(tq, torch.from_numpy(cos), torch.from_numpy(sin), h, d)
    np.testing.assert_array_equal(bits, torch.stack([q, k]).view(torch.int16).numpy())

    jq = jnp.asarray(qkv, jnp.bfloat16)
    jqr, jkr, _ = jax_rope(jq, jnp.asarray(cos), jnp.asarray(sin), h, d)
    jbits = np.stack([np.asarray(jqr), np.asarray(jkr)]).view(np.int16)
    np.testing.assert_array_equal(bits, jbits)

    # the prologue: one (T, 128) column block of q or k heads a program
    def prologue(x_ref, c_ref, s_ref, o_ref):
        xf = x_ref[0].astype(jnp.float32)
        o_ref[0] = (xf * c_ref[...] + _rot_half(xf, d) * s_ref[...]).astype(o_ref.dtype)

    nb = h * d // 128                          # 128-lane blocks of q (and of k)
    c2 = jnp.tile(jnp.asarray(cos), (1, 128 // d))
    s2 = jnp.tile(jnp.asarray(sin), (1, 128 // d))
    roped = pl.pallas_call(
        functools.partial(prologue),
        grid=(b, 2 * nb),
        in_specs=[pl.BlockSpec((1, t, 128), lambda ib, ic: (ib, 0, ic)),
                  pl.BlockSpec((t, 128), lambda ib, ic: (0, 0)),
                  pl.BlockSpec((t, 128), lambda ib, ic: (0, 0))],
        out_specs=pl.BlockSpec((1, t, 128), lambda ib, ic: (ib, 0, ic)),
        out_shape=jax.ShapeDtypeStruct((b, t, 2 * h * d), jnp.bfloat16),
        interpret=True,
    )(jq[:, :, :2 * h * d], c2, s2)
    pbits = np.asarray(roped).view(np.int16).reshape(b, t, 2, h, d).transpose(2, 0, 3, 1, 4)
    # interpret mode on the CPU contracts x * cos + (rot * sin) into one FMA,
    # where the TPU and the twin round x * cos first: the two agree bit for
    # bit except where that moves the bf16 rounding, and there the prologue
    # is the FMA form's rounding
    x = qkv[:, :, :2 * h * d].reshape(b, t, 2, h, d).transpose(2, 0, 3, 1, 4)
    rot = np.concatenate([-x[..., d // 2:], x[..., :d // 2]], axis=-1)
    fma = (x.astype(np.float64) * cos + rot * sin).astype(np.float32)
    fbits = torch.from_numpy(fma).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(pbits, fbits)
    moved = fbits != bits
    assert moved.mean() < 1e-3
    np.testing.assert_array_equal(pbits[~moved], bits[~moved])
