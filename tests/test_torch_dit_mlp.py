"""Kernel 3 (`tts_tpu_torch.ops.dit_mlp.mlp_block_fused`) on the CPU: the
host-side plan of its two GEMMs (`gemm_plan`: form, tiles, waves and the
masked last row tile at the bench buckets' row counts), the shapes
`kernel_fits` admits, and the wrapper's twin against tts_tpu's Pallas
kernel in interpret mode at the shapes the GEMM plan treats specially: rows
that leave the last 128-row tile half empty, and rows far from 0.

Tolerance against Pallas: atol 2e-5, rtol 1e-5 on fp32 inputs, as
tests/test_torch_kernels.py: the same fp32 math on both sides, only the
order of the sums differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu_torch.ops.dit_mlp import gemm_plan, kernel_fits, mlp_block_fused

H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# rows = B * T of the smoke run's requests (buckets 1024, 1408, 2048 with
# CFG's batch of 2), the T 4608 forward and a batch of one at T 1088;
# n = F (ff1) or D (ff2) of F5TTS_v1_Base
@pytest.mark.parametrize("rows, n, want", [
    # rows, n: (bn, stages, CTAs an SM, row tiles, column tiles, masked rows)
    (2048, 2048, (128, 3, 2, 16, 16, 0)),
    (2048, 1024, (128, 4, 1, 16, 8, 0)),      # 128 CTAs: one an SM
    (2816, 2048, (128, 3, 2, 22, 16, 0)),
    (2816, 1024, (64, 4, 2, 22, 16, 0)),      # 352 64-wide CTAs beat 176
    (4096, 2048, (128, 3, 2, 32, 16, 0)),
    (4096, 1024, (128, 3, 2, 32, 8, 0)),
    (9216, 2048, (128, 3, 2, 72, 16, 0)),
    (9216, 1024, (64, 4, 2, 72, 16, 0)),
    (1088, 2048, (64, 4, 2, 9, 32, 64)),      # M % 128 = 64
    (1088, 1024, (128, 4, 1, 9, 8, 64)),
])
def test_gemm_plan_at_the_smoke_shapes(rows, n, want):
    p = gemm_plan(rows, n, H100_SMS)
    assert (p.bn, p.stages, p.ctas_per_sm, p.row_tiles, p.col_tiles, p.masked_rows) == want
    assert p.ctas == p.row_tiles * p.col_tiles
    assert p.waves == pytest.approx(p.ctas / (H100_SMS * p.ctas_per_sm))


@pytest.mark.parametrize("sms", [132, 114, 66])
def test_gemm_plan_covers_every_admitted_shape(sms):
    """Every (rows, n) multiple of 64 gets a form csrc/dit_mlp.cu has, whose
    tiles cover the output exactly in n and with at most one half-empty row
    tile."""
    forms = {(128, 4, 1), (128, 3, 2), (64, 4, 2)}
    for rows in range(64, 64 * 160, 64):
        for n in (64, 192, 512, 576, 1024, 1536, 2048):
            p = gemm_plan(rows, n, sms)
            assert (p.bn, p.stages, p.ctas_per_sm) in forms
            assert n % p.bn == 0 and p.col_tiles * p.bn == n
            assert p.row_tiles * 128 - rows == p.masked_rows in (0, 64)
            if p.ctas_per_sm == 1:        # the one-wave form
                assert p.bn == 128 and p.ctas <= sms


@pytest.mark.parametrize("rows", [64, 128, 192, 1088, 2048, 2816, 4096, 9216])
def test_kernel_fits_every_row_count_of_64(rows):
    assert kernel_fits(torch.bfloat16, rows, 1024, 2048)
    assert not kernel_fits(torch.bfloat16, rows + 32, 1024, 2048)
    assert not kernel_fits(torch.float32, rows, 1024, 2048)
    assert not kernel_fits(torch.bfloat16, rows, 1024 + 32, 2048)


@pytest.mark.parametrize("b, t, offset", [(1, 64, 0.0), (1, 192, 0.0), (2, 64, 100.0)])
def test_mlp_block_fused_matches_pallas_at_plan_edges(b, t, offset):
    """B T = 64 and 192 leave the GEMMs' last 128-row tile half empty on
    the card; rows offset by +100 test the LayerNorm's two-pass
    statistics."""
    from tts_tpu.ops.dit_mlp import mlp_block_fused as pallas

    rng = np.random.default_rng(15)
    d, f = 128, 256
    x = (rng.standard_normal((b, t, d)) + offset).astype(np.float32)
    mods = (rng.standard_normal((b, 3, d)) * 0.5).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    ref = pallas(*map(jnp.asarray, (x, mods, w1, b1, w2, b2)), block_rows=32,
                 interpret=True)
    out = mlp_block_fused(*(torch.from_numpy(a) for a in (x, mods, w1, b1, w2, b2)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)
