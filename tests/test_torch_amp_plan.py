"""Kernel 10's host plan (ops/bigvgan_stage.amp_plan, amp_geometry) against
the C entry's checks (csrc/amp_block.cu `geometry`), at every (C, k, d) of
the bigvgan_v2_24khz_100band_256x bench stages and of the IndexTTS-1.5
vocoder that kernel 10 runs (C 192, 96, 48, 24 in bf16; C <= 128 in fp32;
k 3, 7, 11; d 1, 3, 5), and a plain model that runs the kernel's twin tile
by tile, each tile of the plan's Tb output rows from its rows widened by the
branch's receptive radius R = 12 + mid d + mid (its halo), and stitches the
tiles: it must equal the whole twin bitwise, at T a multiple of the tile
and at T one that leaves a ragged last tile.

The C entry takes the row tile from the plan and refuses one that a
branch's buffers do not fit; `test_c_entry_computes_what_the_mirror_states`
reads its constants and its geometry from the source, so the mirror here
(amp_geometry) cannot drift from it unseen. The kernel launches no
clusters: one CTA a row tile.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from tts_tpu_torch.ops import bigvgan_stage as k10
from tts_tpu_torch.ops.bigvgan_stage import amp_block_fused_plain, amp_geometry, amp_plan

CSRC = Path(__file__).resolve().parent.parent / "tts_tpu_torch" / "csrc"
CARD_SMEM = 232448            # an H100 CTA's shared memory, bytes
KS, DILS = (3, 7, 11), (1, 3, 5)
# the stages kernel 10 runs: (C, T) of the bench call (mel of 512 frames)
# and of an IndexTTS-1.5 request of 254 codes (1,024x from the GPT latents)
BENCH = ((192, 16384), (96, 32768), (48, 65536), (24, 131072))
INDEX = ((192, 16256), (96, 65024), (48, 130048), (24, 260096))


def test_c_entry_computes_what_the_mirror_states():
    src = " ".join((CSRC / "amp_block.cu").read_text().split())
    for part in ("constexpr int NT = 384;", "constexpr int NWG = NT / 128;",
                 "constexpr int S = 16;", "constexpr int KB = 32;",
                 "constexpr int SLOTS_BF16 = 4, SLOTS_F32 = 3;",
                 "constexpr int MAX_SMEM = 227 * 1024;", "constexpr int MAX_TB = 1024;",
                 "p.R = 12 + p.mid * p.d + p.mid;",
                 "const int n1 = round_up(Tb + 2 * (p.R - 6), S);",
                 "const int n3 = round_up(Tb + 2 * p.mid, S);",
                 "p.mr1 = Tb + 2 * (6 + p.mid); if (!F32) p.mr1 = round_up(p.mr1, 64);",
                 "p.rows1 = std::max(std::max(n1, n3), p.mr1 + 2 * p.mid * p.d);",
                 "p.rows2 = std::max(p.done2, n3 + 12);",
                 "const int tiles = std::max(p.mr1, Tb) / 64; mt = (tiles + NWG - 1) / NWG;",
                 "const bool regs = F32 || mt == 1 || mt * nb <= 3;",
                 "const bool stage = F32 || (size_t)Tb * (p.Cp + 8) * 2 <= (size_t)p.rows2 * "
                 "row_bytes<E>(p.Cp, p.Ck);",
                 "return Tb >= 64 && Tb <= MAX_TB && Tb % 64 == 0 && regs && stage && "
                 "smem_bytes<E>(p.Cp, p.Ck, p.rows1, p.rows2) <= (size_t)MAX_SMEM;",
                 "return sizeof(E) == 2 ? (Cp + 63) / 64 * 4096 : KB * Cp * 4;",
                 "return sizeof(E) == 2 ? (Cp + 63) / 64 * 128 : (Ck + 4) * 4;",
                 "p.Ck = F32 ? p.Cp : round_up(p.C, KB);",
                 "return 1024 + (size_t)slots<E>() * slot_bytes<E>(Cp) + "
                 "(size_t)(rows1 + rows2) * row_bytes<E>(Cp, Ck);"):
        assert part in src, part
    assert (k10._NT, k10._NWG, k10._STRIP, k10._KB, k10._MAX_TB) == (384, 3, 16, 32, 1024)
    assert k10._SLOTS == {torch.bfloat16: 4, torch.float32: 3}
    assert k10._MAX_SMEM == 227 * 1024 <= CARD_SMEM


def _stages(dtype):
    cmax = 256 if dtype == torch.bfloat16 else 128
    return [(c, t) for c, t in BENCH + INDEX if c <= cmax]


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_amp_plan_at_every_stage(dtype, b):
    """The plan's row tile at every stage, k and batch: a multiple of 64
    that every branch takes (the geometry's check: registers, shared memory
    within 227 KB), each branch's halo R = 12 + mid d + mid, the tile wider
    than the earlier form's 64 rows at C 192 and (bf16) 512 at C <= 48,
    one CTA a row tile and batch row (no cluster)."""
    for c, t in _stages(dtype):
        for k in KS:
            plan = amp_plan(c, k, DILS, dtype, t, b, 132)
            mid = (k - 1) // 2
            assert plan.tb % 64 == 0 and 64 <= plan.tb <= 1024
            assert plan.ctas == -(-t // plan.tb) * b and plan.waves == -(-plan.ctas // 132)
            for d in DILS:
                geo = amp_geometry(c, k, d, plan.tb, dtype)
                assert geo.ok and geo.smem <= CARD_SMEM
                assert geo.radius == 12 + mid * d + mid
                assert geo.rows1 >= plan.tb + 2 * (geo.radius - 6)
                assert geo.rows2 >= plan.tb + 2 * mid + 12
            if dtype == torch.bfloat16 and c == 192:
                assert plan.tb == 128
            if dtype == torch.bfloat16 and c <= 48 and b == 1 and t >= 65536:
                assert plan.tb == 512


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_amp_geometry_refuses_what_does_not_fit(dtype):
    """A tile past shared memory, or (bf16) one that gives a warpgroup more
    accumulator tiles than its registers hold, or not a multiple of 64."""
    assert not amp_geometry(192 if dtype == torch.bfloat16 else 128, 11, 5, 256, dtype).ok
    assert not amp_geometry(48, 11, 5, 96, dtype).ok
    assert not amp_geometry(24, 3, 1, 2048, dtype).ok
    if dtype == torch.bfloat16:
        geo = amp_geometry(96, 3, 1, 256, dtype)      # 2 column blocks x 2 row tiles
        assert geo.mt == 2 and not geo.ok


def _tiled_twin(x, w1, b1, w2, b2, a1, r1, a2, r2, k, dils, tb):
    """The twin tile by tile: for each branch, each tile of tb output rows
    runs the whole branch (act, conv d, act, conv 1, residual) on its x rows
    widened by R on both sides (cut at the sequence's ends, where the twin
    zero-pads as on the whole sequence), and keeps its own rows."""
    t = x.shape[1]
    mid = (k - 1) // 2
    dt = x.dtype
    cur = x
    for j, d in enumerate(dils):
        radius = 12 + mid * d + mid
        out = torch.empty_like(cur)
        for t0 in range(0, t, tb):
            lo, hi = max(0, t0 - radius), min(t, t0 + tb + radius)
            xs = cur[:, lo:hi]
            h = k10._act(xs, a1[j].to(dt).float(), r1[j].to(dt).float())
            h = k10._conv(h, w1[j], b1[j], d)
            h = k10._act(h, a2[j].to(dt).float(), r2[j].to(dt).float())
            y = xs + k10._conv(h, w2[j], b2[j], 1)
            n = min(tb, t - t0)
            out[:, t0:t0 + n] = y[:, t0 - lo:t0 - lo + n]
        cur = out
    return cur


def _inputs(rng, b, t, c, k, dtype):
    j = len(DILS)

    def rn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)

    def uni(lo):
        return torch.from_numpy((lo + rng.random((j, c))).astype(np.float32)).to(dtype)

    ws = (k * c) ** -0.5
    return (rn(b, t, c), rn(j, k, c, c, scale=ws), rn(j, c, scale=0.1),
            rn(j, k, c, c, scale=ws), rn(j, c, scale=0.1), uni(1.0), uni(0.5), uni(1.0),
            uni(0.5))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ragged", [False, True], ids=["whole", "ragged"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("c,t_bench", BENCH)
def test_tiled_twin_equals_the_whole_twin(c, t_bench, k, ragged):
    """bf16, the plan's tile at the bench stage; T of two tiles (+ 100 rows:
    a ragged third tile), B 2: the stitched tiles equal the whole twin bit
    for bit."""
    plan = amp_plan(c, k, DILS, torch.bfloat16, t_bench, 1, 132)
    t = 2 * plan.tb + (100 if ragged else 0)
    args = _inputs(np.random.default_rng(c + k + ragged), 2, t, c, k, torch.bfloat16)
    whole = amp_block_fused_plain(*args, k=k, dils=DILS)
    tiled = _tiled_twin(*args, k, DILS, plan.tb)
    assert tiled.dtype == whole.dtype == torch.bfloat16
    assert torch.equal(tiled, whole)


@pytest.mark.parametrize("c,t_bench", BENCH[1:])
def test_tiled_twin_equals_the_whole_twin_fp32(c, t_bench):
    """fp32 at the fp32 plan's tile (stages 3-5, k 11), a ragged last tile."""
    plan = amp_plan(c, 11, DILS, torch.float32, t_bench, 1, 132)
    t = 2 * plan.tb + 72
    args = _inputs(np.random.default_rng(c), 1, t, c, 11, torch.float32)
    assert torch.equal(_tiled_twin(*args, 11, DILS, plan.tb),
                       amp_block_fused_plain(*args, k=11, dils=DILS))
