"""The port's kernel wrappers on CPU tensors (their plain PyTorch twins)
against the tts_tpu Pallas kernels they port, run in Pallas interpret mode
as tts_tpu's own kernel tests run them. Same numpy inputs on both sides,
fp32 on both sides.

Tolerance: atol 2e-5 (with rtol 1e-5 where values reach O(1)), the one the
Pallas kernels' own parity tests use: both sides compute the same fp32
math, and only the order of the fp32 sums differs (the kernel tiles keys,
channels and rows differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu_torch.ops.dit_mlp import mlp_block_fused
from tts_tpu_torch.ops.flash_attention import flash_attention_flat
from tts_tpu_torch.ops.grouped_conv import conv_pos_embed_fused


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kv_len", [256, 150, (256, 97)])
def test_flash_attention_flat_matches_pallas(kv_len):
    from tts_tpu.models.f5 import f5_rope_tables
    from tts_tpu.ops.flash_attention import flash_attention_flat as pallas

    b, h, t, d = 2, 4, 256, 64
    rng = np.random.default_rng(11)
    qkv = (rng.standard_normal((b, t, 3 * h * d)) * 0.5).astype(np.float32)
    cos, sin = f5_rope_tables(t, d)
    kv = np.asarray(kv_len, np.int32)
    ref = pallas(jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin),
                 jnp.asarray(kv), heads=h, block_q=128, interpret=True)
    out = flash_attention_flat(_t(qkv), _t(cos), _t(sin),
                               _t(kv) if kv.ndim else int(kv), heads=h)
    assert out.shape == (b, t, h * d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


# T 192: a ragged last row tile of the CUDA kernel's 128; K 7: a short halo
@pytest.mark.parametrize("t,k", [(64, 31), (192, 31), (128, 7)])
def test_conv_pos_embed_fused_matches_pallas(t, k):
    from tts_tpu.ops.grouped_conv import conv_pos_embed_fused as pallas

    rng = np.random.default_rng(12)
    b, c, g = 2, 128, 16
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w1 = (rng.standard_normal((k, c // g, c)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((k, c // g, c)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    ref = pallas(*map(jnp.asarray, (x, w1, b1, w2, b2)), groups=g, interpret=True)
    out = conv_pos_embed_fused(*map(_t, (x, w1, b1, w2, b2)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("per_row", [False, True])
def test_mlp_block_fused_matches_pallas(per_row):
    from tts_tpu.ops.dit_mlp import mlp_block_fused as pallas

    rng = np.random.default_rng(13)
    b, t, d, f = 2, 64, 128, 256
    # rows of very different scales, so the LayerNorm eps matters
    x = (rng.standard_normal((b, t, d))
         * np.logspace(-2, 1, t)[None, :, None]).astype(np.float32)
    mods = (rng.standard_normal((b, 3, d) if per_row else (3, d)) * 0.5
            ).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    ref = pallas(*map(jnp.asarray, (x, mods, w1, b1, w2, b2)), block_rows=32,
                 interpret=True)
    out = mlp_block_fused(*map(_t, (x, mods, w1, b1, w2, b2)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_flash_attention_flat_masks_keys_not_queries():
    """Keys at or past kv_len never reach the output; query rows past it
    still attend (the pipeline zeroes them afterwards)."""
    rng = np.random.default_rng(14)
    b, h, t, d = 1, 2, 128, 64
    qkv = _t((rng.standard_normal((b, t, 3 * h * d)) * 0.5).astype(np.float32))
    cos = torch.ones(t, d)
    sin = torch.zeros(t, d)
    base = flash_attention_flat(qkv, cos, sin, 100, heads=h)
    pert = qkv.clone()
    pert[:, 100:, h * d:] = 7.0            # k and v of the masked keys
    out = flash_attention_flat(pert, cos, sin, 100, heads=h)
    torch.testing.assert_close(out, base, atol=0, rtol=0)
    assert torch.isfinite(base[:, 100:]).all() and base[:, 100:].abs().sum() > 0


@pytest.mark.parametrize("bad", ["qkv_dim", "rope", "kv_len"])
def test_flash_attention_flat_rejects_bad_input(bad):
    b, h, t, d = 2, 2, 64, 64
    qkv = torch.zeros(b, t, 3 * h * d + (1 if bad == "qkv_dim" else 0))
    cos = torch.zeros(t - (1 if bad == "rope" else 0), d)
    kv = torch.tensor([64, 64, 64]) if bad == "kv_len" else None
    with pytest.raises(ValueError):
        flash_attention_flat(qkv, cos, cos, kv, heads=h)


def test_fused_wrappers_reject_mismatched_weights():
    x = torch.zeros(1, 64, 128)
    with pytest.raises(ValueError):
        conv_pos_embed_fused(x, torch.zeros(31, 8, 64), torch.zeros(64),
                             torch.zeros(31, 8, 64), torch.zeros(64))
    with pytest.raises(ValueError):
        mlp_block_fused(x, torch.zeros(3, 128), torch.zeros(128, 256),
                        torch.zeros(256), torch.zeros(128, 256), torch.zeros(128))
    with pytest.raises(ValueError):
        mlp_block_fused(x, torch.zeros(2, 3, 128), torch.zeros(128, 256),
                        torch.zeros(256), torch.zeros(256, 128), torch.zeros(128))
