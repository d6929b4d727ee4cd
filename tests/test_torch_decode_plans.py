"""The host-side plans of kernels 11, 12, 14 and 15 (ops/decode_qkv.qkv_plan,
ops/decode_step.step_plan, ops/decode_mlp.out_mlp_plan,
ops/decode_mlp.q8_tail_plan) against the forms their C entries accept
(csrc/decode_qkv.cu `fused_qkv_rope`, csrc/decode_step.cu
`fused_qkv_attn`, csrc/decode_mlp.cu `fused_out_mlp`, csrc/decode_mlp_q8.cu
`fused_out_mlp_q8`), and plain models of kernel 11's split of the qkv dot
over its input dim, of kernel 12's split over a kv head's cluster and of
kernel 14's split of each dot over its input dim, held against tts_tpu's
Pallas kernels in interpret mode and against the port's twins.

The C entries refuse any form but the plan's; `_qkv_accepts`,
`_step_accepts`, `_out_mlp_accepts` and `_q8_accepts` below restate their
checks, and `test_c_entries_check_what_the_mirrors_state` reads the checks
and the limits they use from the sources, so the two cannot drift apart
unseen.

Tolerance of the split models: the card's 2^-6 of max |ref| and of the rel
L2 (chip_smoke.py's TOL), in bf16. Against the twin only the order of the
fp32 sums differs (slices, then ranks), so a few bf16 roundings move (of
q, k and v in kernel 11; of p in kernel 12; of x2, h, g, u, a and the
output in kernel 14); against tts_tpu's kernels their own bf16 roundings
move too.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu_torch.ops.decode_mlp import (OutMlpPlan, Q8TailPlan, _pick_block,
                                          fused_out_mlp_plain, out_mlp_fits, out_mlp_plan,
                                          q8_tail_plan)
from tts_tpu_torch.quant.weight_only import QTensor
from tts_tpu_torch.ops import decode_qkv
from tts_tpu_torch.ops.decode_qkv import (QkvPlan, _norm_rope, fused_qkv_rope_plain,
                                          heads_a_tile, qkv_fits, qkv_plan)
from tts_tpu_torch.ops.decode_step import fused_qkv_attn, step_fits, step_plan

CSRC = Path(__file__).resolve().parent.parent / "tts_tpu_torch" / "csrc"
CARD_SMEM = 232448            # an H100 CTA's shared memory, bytes


def _qkv_accepts(b: int, hidden: int, head_dim: int, plan) -> bool:
    """csrc/decode_qkv.cu's shape and form checks (weight_stream.cuh's
    cut_ok)."""
    ctas, k, pdl = plan
    return (1 <= b <= 8 and head_dim in (64, 128) and 8 <= hidden <= 8192
            and hidden % 8 == 0 and _cut8_ok(hidden, ctas, k) and int(pdl) in (0, 1))


def _qkv_smem(b: int, head_dim: int, w_bytes: int, plan) -> int:
    """csrc/decode_qkv.cu's smem_bytes: the bf16 normed slice in whole
    chunks (NT / CG row lanes x NR rows, CG = the tile's bytes a row / 16,
    NR 8 for int8 at B > 4, else 16), the 8 warps' and the cluster's fp32
    sums (B x the tile's columns each)."""
    cols = heads_a_tile(head_dim, w_bytes) * head_dim
    cg = cols * w_bytes // 16
    chunk = 256 // cg * (8 if w_bytes == 1 and b > 4 else 16)
    return 2 * b * -(-plan.rows // chunk) * chunk + 4 * (8 + plan.ctas) * b * cols


def _step_accepts(pos: int, ctas: int, rows: int) -> bool:
    """csrc/decode_step.cu: the live rows in `ctas` (1 to 8) slices of
    `rows`, the last shorter, none empty; pos 0 one CTA of 0 rows."""
    if pos == 0:
        return ctas == 1 and rows == 0
    return 1 <= ctas <= 8 and rows >= 1 and ctas * rows >= pos and (ctas - 1) * rows < pos


def _cut_ok(dim: int, ctas: int, k: int) -> bool:
    """csrc/decode_mlp_q8.cu's cut_ok."""
    return 1 <= ctas <= 16 and k >= 8 and k % 8 == 0 and ctas * k >= dim \
        and (ctas - 1) * k < dim


def _q8_accepts(a_dim: int, hidden: int, ffn: int, plan) -> bool:
    """csrc/decode_mlp_q8.cu's form check."""
    c1, k1, c2, k2, c3, k3 = plan
    fb = _pick_block(ffn)
    nsub = ffn // k3 if k3 > 0 else 0
    return (_cut_ok(a_dim, c1, k1) and _cut_ok(hidden, c2, k2) and k3 >= 4 and k3 % 4 == 0
            and fb % k3 == 0 and 1 <= c3 <= 16 and c3 <= nsub and -(-nsub // c3) <= 2)


def _cut8_ok(dim: int, ctas: int, k: int) -> bool:
    """csrc/decode_mlp.cu's cut_ok."""
    return 1 <= ctas <= 8 and k >= 8 and k % 8 == 0 and ctas * k >= dim \
        and (ctas - 1) * k < dim


def _out_mlp_accepts(a_dim: int, hidden: int, ffn: int, plan) -> bool:
    """csrc/decode_mlp.cu's form check."""
    c1, k1, c2, k2, c3, k3, pdl = plan
    return (_cut8_ok(a_dim, c1, k1) and _cut8_ok(hidden, c2, k2) and _cut8_ok(ffn, c3, k3)
            and int(pdl) in (0, 1))


def _out_mlp_smem(launch: int, b: int, hidden: int, plan, w_bytes: int) -> int:
    """csrc/decode_mlp.cu's smem_bytes: launch 2's x2 rows, the bf16
    activations of a slice in whole chunks of 32 row lanes x NR rows (NR 8
    for int8 at B > 4, else 16), the warps' and the cluster's fp32 sums
    (B x 128 bytes of columns each)."""
    k, ctas = (plan.k1, plan.c1) if launch == 1 else \
        (plan.k2, plan.c2) if launch == 2 else (plan.k3, plan.c3)
    chunk = 32 * (8 if w_bytes == 1 and b > 4 else 16)
    sums = 4 * b * 128 // w_bytes
    return (2 * b * hidden if launch == 2 else 0) + 2 * b * -(-k // chunk) * chunk \
        + (8 + ctas) * sums


def test_c_entries_check_what_the_mirrors_state():
    def flat(name):
        return " ".join((CSRC / name).read_text().split())

    stream = flat("weight_stream.cuh")
    for part in ("constexpr int MAX_CTAS = 8;", "constexpr int NT = 256, NW = NT / 32;",
                 "return sizeof(W) == 1 && NB > 4 ? 8 : 16;",
                 "constexpr int CH = NT / CG * rows_in_flight<W, NB>();",
                 "ctas >= 1 && ctas <= MAX_CTAS && k >= 8 && k % 8 == 0 && "
                 "(long long)ctas * k >= dim && (long long)(ctas - 1) * k < dim;"):
        assert part in stream, part
    k14 = flat("decode_mlp.cu")
    for part in ("constexpr int CG = 8;",
                 "const bool form = tts::cut_ok(A, c1, k1) && tts::cut_ok(H, c2, k2) && "
                 "tts::cut_ok(F, c3, k3) && (pdl == 0 || pdl == 1);",
                 "return x2s + sizeof(bf16) * NB * padded<W, CG, NB>(k) + (NW + ctas) * N;",
                 "if (s1 > 227 * 1024 || s2 > 227 * 1024 || s3 > 227 * 1024)"):
        assert part in k14, part
    q8 = (CSRC / "decode_mlp_q8.cu").read_text()
    assert re.search(r"constexpr int MAX_CTAS = 16;", q8)
    assert re.search(r"constexpr int MAX_PASSES = 2;", q8)
    for part in ("ctas >= 1 && ctas <= MAX_CTAS && k >= 8 && k % 8 == 0 && "
                 "(long long)ctas * k >= dim &&",
                 "(long long)(ctas - 1) * k < dim",
                 "tts::cut_ok(A, c1, k1) && tts::cut_ok(H, c2, k2) && k3 >= 4 &&",
                 "k3 % 4 == 0 && fb % k3 == 0 && c3 >= 1 && c3 <= tts::MAX_CTAS &&",
                 "c3 <= nsub && (nsub + c3 - 1) / c3 <= tts::MAX_PASSES;"):
        assert part in " ".join(q8.split()), part
    # kernel 11: the tile, the shapes, the form and the shared memory
    k11 = flat("decode_qkv.cu")
    for part in ("constexpr int MAX_H = 8192;", "constexpr int SMEM_MAX = 216 * 1024;",
                 "static constexpr int HPT = HD * (int)sizeof(W) >= 128 ? 1 : 128 / (HD * "
                 "(int)sizeof(W));",
                 "static constexpr int COLS = HPT * HD, V = vals<W>(), CG = COLS / V, "
                 "NP = NB * COLS;",
                 "const bool shapes = B >= 1 && B <= 8 && (hd == 64 || hd == 128) && H >= 8 && "
                 "H % 8 == 0 && H <= tts::MAX_H &&",
                 "const bool form = tts::cut_ok(H, ctas, rows) && (pdl == 0 || pdl == 1);",
                 "return sizeof(bf16) * NB * padded<W, T::CG, NB>(k) + sizeof(float) * (NW + "
                 "ctas) * T::NP;",
                 "if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;"):
        assert part in k11, part
    assert decode_qkv.MAX_HIDDEN == 8192 and decode_qkv.MAX_ROWS == 8
    assert decode_qkv._TILE_BYTES == 128
    # kernel 12: the attention launch's shared memory and split; its qkv
    # launch is kernel 11's C entry, which checks the qkv plan's form
    step = flat("decode_step.cu")
    assert "constexpr int ST_MAX_CTAS = 8;" in step
    assert "constexpr int ST_THREADS = 256;" in step
    assert ("return (size_t)(1 + ST_WARPS + ctas) * G * HD + 2 * HD + (size_t)G * rows;"
            in step)
    assert ("const int err = fused_qkv_rope(x, w, w_int8, scale, bias, qn, kn, cosr, sinr, "
            "lnw, lnb, q, k, v, 1, H, heads, kv_heads, hd, qctas, qrows, pdl, eps, stream);"
            ) in step
    assert ("pos == 0 ? ctas == 1 && rows == 0 : ctas >= 1 && ctas <= tts::ST_MAX_CTAS && "
            "rows >= 1 && (long long)ctas * rows >= pos && (long long)(ctas - 1) * rows < pos"
            ) in step


# ---------------------------------------------------------------- kernel 11

# (H, q + k + v heads, head_dim): Kani, the Qwen talker and predictor, IndexTTS
QKV_SHAPES = {"kani": (1024, 32, 64), "qwen": (1024, 32, 128), "indextts": (1280, 60, 64)}


# the plan on an H100 (132 SMs) at B 1, 3 and 8: (CTAs a tile, rows a CTA)
QKV_FORMS = {("kani", 2): [(2, 512)] * 3, ("kani", 1): [(2, 512), (2, 512), (4, 256)],
             ("qwen", 2): [(4, 256), (4, 256), (3, 344)],
             ("qwen", 1): [(2, 512), (2, 512), (3, 344)],
             ("indextts", 2): [(3, 432), (3, 432), (2, 640)],
             ("indextts", 1): [(3, 432), (3, 432), (4, 320)]}


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("w_bytes", [2, 1], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", list(QKV_SHAPES))
def test_qkv_plan_at_the_family_shapes(shape, w_bytes, rows):
    """On an H100 (132 SMs): tiles of one head in bf16 (Kani 32 of 128
    bytes a row, Qwen 32 of 256, IndexTTS 60 of 128) and of two heads at
    head dim 64 in int8 (16, 30) or one at 128 (32); each tile's input dim
    in slices of one chunk of loads in flight (512 rows of 128-byte tiles,
    256 of 256-byte ones or of int8 past 4 rows), fewer where the grid
    would pass what the card holds at once (Qwen and IndexTTS at B 8, whose
    registers allow one CTA an SM); programmatic dependent launch. The
    forms that were fastest, or within 7% of it, on the card."""
    hidden, n_heads, hd = QKV_SHAPES[shape]
    plan = qkv_plan(hidden, n_heads, hd, w_bytes, 132, rows)
    assert plan == QkvPlan(*QKV_FORMS[shape, w_bytes][(1, 3, 8).index(rows)], True)
    assert _qkv_accepts(rows, hidden, hd, plan)
    assert heads_a_tile(hd, w_bytes) == (2 if (w_bytes, hd) == (1, 64) else 1)
    assert _qkv_smem(rows, hd, w_bytes, plan) <= 216 * 1024


@pytest.mark.parametrize("sms", [16, 132])
@pytest.mark.parametrize("w_bytes", [2, 1], ids=["bf16", "int8"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_qkv_plan_covers_every_admitted_shape(head_dim, w_bytes, sms):
    """Every (B, H) qkv_fits admits at this head dim, for 3 to 96 heads: the
    plan is a form the C entry takes, at most 8 CTAs a cluster, a grid the
    card holds at once (two CTAs an SM where the registers allow, less 4 a
    CTA of a cluster past the first) unless one CTA a tile, slices of one
    chunk of loads in flight unless the cluster or the grid stopped it, and
    the shared memory within the C entry's 216 KB."""
    for hidden in list(range(8, 8193, 168)) + [8192]:
        for n_heads in (3, 4, 7, 32, 60, 96):
            tiles = -(-n_heads // heads_a_tile(head_dim, w_bytes))
            for b in range(1, 9):
                assert qkv_fits(b, hidden, head_dim)
                plan = qkv_plan(hidden, n_heads, head_dim, w_bytes, sms, b)
                c = plan.ctas
                assert _qkv_accepts(b, hidden, head_dim, plan), (hidden, n_heads, b, plan)
                room = sms * (2 if b <= (5 if w_bytes == 2 else 2) else 1)
                assert c == 1 or tiles * c <= room - 4 * (c - 1)
                chunk = 256 // (128 // 16 if head_dim * w_bytes <= 128 else 16) \
                    * (8 if w_bytes == 1 and b > 4 else 16)
                assert -(-hidden // chunk) <= c or c == 8 \
                    or tiles * (c + 1) > room - 4 * c, (hidden, n_heads, b, plan)
                assert _qkv_smem(b, head_dim, w_bytes, plan) <= 216 * 1024
    assert not qkv_fits(1, 8200, head_dim) and not qkv_fits(1, 1028, head_dim)
    assert not qkv_fits(9, 1024, head_dim) and not qkv_fits(1, 1024, 96)


@pytest.mark.parametrize("plan", [
    QkvPlan(9, 128, True),      # a cluster of 9
    QkvPlan(3, 512, True),      # the third slice empty
    QkvPlan(2, 516, True),      # rows not a multiple of 8
    QkvPlan(2, 256, True),      # the input not covered
    QkvPlan(2, 512, 2),         # no such PDL mode
])
def test_qkv_form_check_refuses_other_forms(plan):
    assert not _qkv_accepts(1, 1024, 64, plan)


def _qkv_model(x, w, plan, heads, kvh, hd, cos=None, sin=None, qn=None, kn=None,
               bqkv=None, norm="rms", lnw=None, lnb=None, eps=1e-6):
    """Kernel 11's CUDA form in plain torch on bf16 values: the twin's
    normed input in bf16; the dot's fp32 sum taken over the plan's slices
    of the input dim (a CTA each), the slices added in rank order; then, on
    whole heads, the twin's epilogue at its rounding points (rounded to
    bf16, (int8) times the bf16-rounded scale, plus the bias, the per-head
    norm and the rotation)."""
    xf = x.float()
    if norm == "ln":
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        h = (xf - mean) * torch.rsqrt(var + eps) * lnw.float() + lnb.float()
    else:
        h = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    h = h.to(torch.bfloat16).float()
    wq = (w.q if isinstance(w, QTensor) else w).float()
    acc = torch.zeros(x.shape[0], wq.shape[1])
    for s0 in range(0, h.shape[1], plan.rows):
        acc = acc + h[:, s0:s0 + plan.rows] @ wq[s0:s0 + plan.rows]
    qkv = acc.to(torch.bfloat16)
    if isinstance(w, QTensor):
        qkv = qkv * w.scale.to(torch.bfloat16)
    if bqkv is not None:
        qkv = qkv + bqkv
    q_sz, kv_sz = heads * hd, kvh * hd
    q = _norm_rope(qkv[:, :q_sz], qn, cos, sin, heads, hd, eps)
    k = _norm_rope(qkv[:, q_sz:q_sz + kv_sz], kn, cos, sin, kvh, hd, eps)
    return q, k, qkv[:, q_sz + kv_sz:].contiguous()


def _bf(rng, *shape, scale=1.0, shift=0.0):
    a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16)


def _jb(a):
    return None if a is None else jnp.asarray(a.float().numpy(), jnp.bfloat16)


def _qkv_weights(w, quant):
    """(the port's weight, tts_tpu's): bf16, or tts_tpu's eager int8
    quantizer's q and scales on both sides."""
    if not quant:
        return w, _jb(w)
    from tts_tpu.quant.weight_only import quantize_int8

    qt = quantize_int8(jnp.asarray(w.float().numpy()))
    return QTensor(q=torch.from_numpy(np.array(qt.q)),
                   scale=torch.from_numpy(np.array(qt.scale))), qt


# (norm, q/k norms and RoPE, bias, hidden, heads, kv heads, head_dim)
QKV_VARIANTS = {"rms-norms-rope": ("rms", True, False, 1024, 4, 2, 128),
                "ln-bias": ("ln", False, True, 1280, 4, 4, 64)}


@pytest.mark.parametrize("b", [1, 5, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("variant", list(QKV_VARIANTS))
def test_qkv_split_matches_pallas_and_twin(variant, quant, b):
    """The model of kernel 11's split (the plan on 132 SMs: four slices of
    256 rows at H 1024 and head dim 128 in bf16, two of 512 in int8; three
    of 432 at H 1280 and head dim 64, four of 320 in int8 at B 8) against
    tts_tpu's fused_qkv_rope in interpret mode and the port's twin, bf16
    activations, bf16 or int8 weights: RMSNorm with q/k norms and RoPE, and
    LayerNorm with a bias and no RoPE."""
    from tts_tpu.nn.rope import rope_table
    from tts_tpu.ops.decode_qkv import fused_qkv_rope as pallas

    norm, normed, biased, hin, heads, kvh, hd = QKV_VARIANTS[variant]
    n = (heads + 2 * kvh) * hd
    rng = np.random.default_rng(150 + b + 10 * quant)
    x = _bf(rng, b, hin)
    w, wj = _qkv_weights(_bf(rng, hin, n, scale=0.03), quant)
    qn = _bf(rng, hd, scale=0.1, shift=1.0) if normed else None
    kn = _bf(rng, hd, scale=0.1, shift=1.0) if normed else None
    cos = sin = None
    if normed:
        cos, sin = (torch.from_numpy(np.asarray(a[9:10])).to(torch.bfloat16)
                    for a in rope_table(16, hd, 1e6))
    bq = _bf(rng, n, scale=0.1) if biased else None
    lnw = _bf(rng, hin, scale=0.1, shift=1.0) if norm == "ln" else None
    lnb = _bf(rng, hin, scale=0.1) if norm == "ln" else None
    eps = 1e-5 if norm == "ln" else 1e-6
    plan = qkv_plan(hin, heads + 2 * kvh, hd, 1 if quant else 2, 132, b)
    assert plan.ctas > 1
    kw = dict(heads=heads, kv_heads=kvh, head_dim=hd, norm=norm, eps=eps)
    model = _qkv_model(x, w, plan, heads, kvh, hd, cos, sin, qn, kn, bq, norm, lnw, lnb, eps)
    twin = fused_qkv_rope_plain(x, w, cos, sin, q_norm=qn, k_norm=kn, bqkv=bq,
                                ln_weight=lnw, ln_bias=lnb, **kw)
    ref = pallas(_jb(x), wj, _jb(cos), _jb(sin), q_norm=_jb(qn), k_norm=_jb(kn), bqkv=_jb(bq),
                 ln_weight=_jb(lnw), ln_bias=_jb(lnb), interpret=True, **kw)
    for m, t, r, width in zip(model, twin, ref, (heads * hd, kvh * hd, kvh * hd)):
        assert m.shape == t.shape == (b, width) and m.dtype == torch.bfloat16
        _within_bf16_tol(m, t)
        _within_bf16_tol(m, torch.from_numpy(np.array(r.astype(jnp.float32))))


# ---------------------------------------------------------------- kernel 14

@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("w_bytes", [2, 1])
def test_out_mlp_plan_at_the_qwen_shape(w_bytes, rows):
    """A 2048, H 1024, F 3072 on an H100 (132 SMs): slices of 512 rows, 4 x
    16, 2 x 96 and 6 x 16 CTAs in bf16 (64-column tiles), 4 x 8, 2 x 48 and
    6 x 8 in int8 (128-column tiles); programmatic dependent launch in bf16
    and in int8 at one row: the forms that won on the card. Kani's FFN
    (4608) is past the kernels' 4096: no form there."""
    plan = out_mlp_plan(2048, 1024, 3072, w_bytes, 132, rows)
    assert plan == OutMlpPlan(4, 512, 2, 512, 6, 512, w_bytes == 2 or rows == 1)
    assert _out_mlp_accepts(2048, 1024, 3072, plan)
    assert not out_mlp_fits(1, 1024, 1024, 4608)


@pytest.mark.parametrize("sms", [16, 132])
@pytest.mark.parametrize("w_bytes", [2, 1])
@pytest.mark.parametrize("a_dim", [8, 256, 1000, 2048, 4096, 8192])
def test_out_mlp_plan_covers_every_admitted_shape(a_dim, w_bytes, sms):
    """Every (H, F) out_mlp_fits admits: the plan is a form the C entry
    takes, at most 8 CTAs a cluster, slices of at least 512 rows where the
    dim has them, no more CTAs than it takes to give every SM one, and each
    launch's shared memory within an H100 CTA's at B 1 and 8."""
    for hidden in range(32, 4097, 224):
        for ffn in range(32, 4097, 96):
            if not out_mlp_fits(1, a_dim, hidden, ffn):
                continue
            plan = out_mlp_plan(a_dim, hidden, ffn, w_bytes, sms)
            assert _out_mlp_accepts(a_dim, hidden, ffn, plan), (a_dim, hidden, ffn, plan)
            cols = 128 // w_bytes
            for dim, ctas, k, tiles in ((a_dim, plan.c1, plan.k1, -(-hidden // cols)),
                                        (hidden, plan.c2, plan.k2, -(-ffn // (cols // 2))),
                                        (ffn, plan.c3, plan.k3, -(-hidden // cols))):
                assert k >= min(512, dim) or ctas == 1
                assert ctas == 1 or (ctas - 1) * tiles < sms
            for b in (1, 8):
                for launch in (1, 2, 3):
                    assert _out_mlp_smem(launch, b, hidden, plan, w_bytes) <= CARD_SMEM


@pytest.mark.parametrize("plan", [
    OutMlpPlan(9, 256, 2, 512, 6, 512, True),      # a cluster of 9
    OutMlpPlan(5, 512, 2, 512, 6, 512, True),      # the fifth slice empty
    OutMlpPlan(4, 516, 2, 512, 6, 512, True),      # rows not a multiple of 8
    OutMlpPlan(4, 512, 2, 256, 6, 512, True),      # the hidden dim not covered
    OutMlpPlan(4, 512, 2, 512, 6, 512, 2),         # no such PDL mode
])
def test_out_mlp_form_check_refuses_other_forms(plan):
    assert not _out_mlp_accepts(2048, 1024, 3072, plan)


def _out_mlp_model(x, att, wo, wgu, wd, plan, eps=1e-6):
    """Kernel 14's CUDA form in plain torch on bf16 values: each dot's fp32
    sum taken over the plan's slices of its input dim (a CTA each), the
    slices added in rank order, then the twin's rounding points: rounded to
    bf16, (int8) times the bf16-rounded scale in bf16; x2 = x + y; h =
    bf16(x2 rsqrt(mean(x2^2) + eps)); a = bf16(silu(g) u); out = x2 + y."""
    f = wd.shape[0]

    def dot(a, w, k, cols=slice(None)):
        wq = (w.q if isinstance(w, QTensor) else w)[:, cols].float()
        acc = torch.zeros(a.shape[0], wq.shape[1])
        for s0 in range(0, a.shape[1], k):
            acc = acc + a[:, s0:s0 + k].float() @ wq[s0:s0 + k]
        y = acc.to(torch.bfloat16)
        if isinstance(w, QTensor):
            y = y * w.scale[cols].to(torch.bfloat16)
        return y

    x2 = x + dot(att, wo, plan.k1)
    xf = x2.float()
    h = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)).to(torch.bfloat16)
    g = dot(h, wgu, plan.k2, slice(0, f))
    u = dot(h, wgu, plan.k2, slice(f, 2 * f))
    a = (torch.nn.functional.silu(g.float()) * u.float()).to(torch.bfloat16)
    return x2 + dot(a, wd, plan.k3)


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_out_mlp_split_matches_pallas_and_twin(quant, b):
    """The model of kernel 14's split (the plan at A 1024, H 256, F 1024 on
    132 SMs: 2 slices of 512 of att, one of h, 2 of a) against tts_tpu's
    fused_out_mlp in interpret mode and the port's twin, bf16 activations,
    bf16 or int8 weights (tts_tpu's eager quantizer, the same q and scales
    on both sides)."""
    from tts_tpu.ops.decode_mlp import fused_out_mlp as pallas
    from tts_tpu.quant.weight_only import quantize_int8

    a_dim, hid, ffn = 1024, 256, 1024
    rng = np.random.default_rng(140 + b + 10 * quant)
    plan = out_mlp_plan(a_dim, hid, ffn, 1 if quant else 2, 132)
    assert (plan.c1, plan.c2, plan.c3) == (2, 1, 2)

    def bf(*shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(torch.bfloat16)

    jb = lambda a: jnp.asarray(a.float().numpy(), jnp.bfloat16)   # noqa: E731
    x, att = bf(b, hid), bf(b, a_dim)
    ws = [bf(*s, scale=0.03) for s in ((a_dim, hid), (hid, 2 * ffn), (ffn, hid))]
    if quant:
        qs = [quantize_int8(jnp.asarray(w.float().numpy())) for w in ws]
        wj = qs
        ws = [QTensor(q=torch.from_numpy(np.array(q.q)),
                      scale=torch.from_numpy(np.array(q.scale))) for q in qs]
    else:
        wj = [jb(w) for w in ws]
    model = _out_mlp_model(x, att, *ws, plan)
    twin = fused_out_mlp_plain(x, att, *ws, eps=1e-6)
    ref = pallas(jb(x), jb(att), *wj, eps=1e-6, interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert model.shape == twin.shape == (b, hid) and model.dtype == torch.bfloat16
    _within_bf16_tol(model, twin)
    _within_bf16_tol(model, ref)


# ---------------------------------------------------------------- kernel 15

def test_q8_tail_plan_at_the_qwen_shape():
    """A 2048, H 1024, F 3072 (F-block 512), 128-column tiles: 4 x 8 CTAs of
    512 rows of wo, 2 x 48 of 512 rows of w_gate_up (64 gate + 64 up
    columns a tile), 6 x 8 F-blocks of 512 rows of w_down: portable
    clusters, slices of at least 512 rows (the form that won on the
    card)."""
    plan = q8_tail_plan(2048, 1024, 3072)
    assert plan == Q8TailPlan(4, 512, 2, 512, 6, 512)
    assert _q8_accepts(2048, 1024, 3072, plan)


@pytest.mark.parametrize("a_dim", [8, 256, 1000, 2048, 4096, 8192])
def test_q8_tail_plan_covers_every_admitted_shape(a_dim):
    """Every (H, F) out_mlp_fits admits: the plan is a form the C entry
    takes, portable clusters unless the F-blocks need more, and each
    F-block's sub-blocks land on distinct (CTA, pass) slots that cover it."""
    for hidden in range(32, 4097, 224):
        for ffn in range(32, 4097, 32):
            if not out_mlp_fits(1, a_dim, hidden, ffn):
                continue
            plan = q8_tail_plan(a_dim, hidden, ffn)
            assert _q8_accepts(a_dim, hidden, ffn, plan), (a_dim, hidden, ffn, plan)
            assert plan.c1 <= 8 and plan.c2 <= 8
            assert plan.c3 <= 8 or plan.k3 == _pick_block(ffn)
            nsub = ffn // plan.k3
            slots = {(s % plan.c3, s // plan.c3) for s in range(nsub)}
            assert len(slots) == nsub and all(p < 2 for _, p in slots)


@pytest.mark.parametrize("plan", [
    Q8TailPlan(17, 128, 4, 256, 6, 512),     # a cluster of 17
    Q8TailPlan(9, 256, 4, 256, 6, 512),      # the ninth slice empty
    Q8TailPlan(9, 228, 4, 256, 6, 512),      # rows not a multiple of 8
    Q8TailPlan(8, 256, 4, 256, 8, 384),      # a sub-block across two F-blocks
    Q8TailPlan(8, 256, 4, 256, 4, 256),      # three sub-blocks a CTA
    Q8TailPlan(8, 256, 4, 256, 13, 256),     # a CTA without a sub-block
])
def test_q8_form_check_refuses_other_forms(plan):
    assert not _q8_accepts(2048, 1024, 3072, plan)


# ---------------------------------------------------------------- kernel 12

STEP_POS = [0, 1, 2, 17, 31, 32, 33, 63, 64, 65, 126, 127, 255, 256, 257, 639, 700, 2047,
            4500, 24000]


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("pos", STEP_POS)
def test_step_plan_covers_live_rows(pos, head_dim):
    """Every live row in exactly one slice, the slices in order and none
    empty, 1 to 8 CTAs; one CTA up to 64 rows at head_dim 64 and 128 at
    128; the C entry's check takes the form."""
    ctas, rows = step_plan(pos, head_dim)
    assert _step_accepts(pos, ctas, rows)
    if pos == 0:
        return
    slices = [range(r * rows, min((r + 1) * rows, pos)) for r in range(ctas)]
    assert all(len(sl) > 0 for sl in slices)
    assert [t for sl in slices for t in sl] == list(range(pos))
    assert (ctas == 1) == (pos <= {64: 64, 128: 128}[head_dim])


def _cluster_smem(group: int, head_dim: int, ctas: int, rows: int) -> int:
    """Dynamic shared memory of kernel 12's attention launch, bytes
    (csrc/decode_step.cu's st_smem_floats): q, k_new, v_new, the 8 warps'
    P.V sums, the cluster's (one set a CTA), the slice's scores."""
    return 4 * ((9 + ctas) * group * head_dim + 2 * head_dim + group * rows)


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("group", range(1, 9))
def test_step_plan_fits_the_card_wherever_the_gate_admits(group, head_dim):
    """step_fits (the route gate, unchanged) admits pos by the earlier
    one-CTA form's shared memory, up to 200 KB; the cluster form's
    attention launch fits the card's 227 KB at every admitted pos."""
    pos, worst = 0, 0
    while step_fits(group, head_dim, pos):
        ctas, rows = step_plan(pos, head_dim)
        worst = max(worst, _cluster_smem(group, head_dim, ctas, rows))
        pos += 1 if pos < 300 else 61
    assert pos > 2048 and worst <= CARD_SMEM


def _step_model(q, k_new, v_new, kc, vc, pos, heads, kv_heads, head_dim):
    """Kernel 12's attention launch in plain torch, fp32 on bf16 values: the
    live rows cut as step_plan cuts them; one max over every slice and
    s_new; p = exp(s - m); denom the slices' sums in rank order plus p_new;
    P.V a slice at a time with bf16(p / denom), the slices added in rank
    order, plus p_new / denom (bf16 at head_dim 128) times v_new; the
    output rounded to bf16 once."""
    ctas, rows = step_plan(pos, head_dim)
    g = heads // kv_heads
    qh = q.float().reshape(kv_heads, g, head_dim)
    kn = k_new.float().reshape(kv_heads, 1, head_dim)
    vn = v_new.float().reshape(kv_heads, 1, head_dim)
    s_new = (qh * kn).sum(-1, keepdim=True)
    cuts = [(r * rows, min((r + 1) * rows, pos)) for r in range(ctas)] if pos else []
    scores = [qh @ kc[:, lo:hi].float().transpose(1, 2) for lo, hi in cuts]
    m = s_new
    for s in scores:
        m = torch.maximum(m, s.amax(-1, keepdim=True))
    ps = [torch.exp(s - m) for s in scores]
    den = torch.zeros_like(m)
    for p in ps:
        den = den + p.sum(-1, keepdim=True)
    p_new = torch.exp(s_new - m)
    den = den + p_new
    acc = torch.zeros_like(qh)
    for (lo, hi), p in zip(cuts, ps):
        acc = acc + (p / den).to(torch.bfloat16).float() @ vc[:, lo:hi].float()
    pn = p_new / den
    if head_dim >= 128:
        pn = pn.to(torch.bfloat16).float()
    return (acc + pn * vn).to(torch.bfloat16).reshape(1, heads * head_dim)


def _within_bf16_tol(got, ref, tol=2.0 ** -6):
    got, ref = got.float(), ref.float()
    err = got - ref
    assert err.abs().max() <= tol * ref.abs().max()
    assert torch.linalg.vector_norm(err) <= tol * torch.linalg.vector_norm(ref)


@pytest.mark.parametrize("geom,pos", [((16, 8, 128), 126), ((16, 8, 128), 300),
                                      ((16, 8, 64), 700), ((16, 8, 64), 5)],
                         ids=["qwen-126", "qwen-300", "kani-700", "kani-5"])
def test_step_split_matches_pallas_and_twin(geom, pos):
    """The model of the cluster split against tts_tpu's fused_qkv_attn in
    interpret mode and against the port's twin, on the same bf16 inputs
    (q, k and v from the twin's qkv head, which the model shares)."""
    from tts_tpu.ops.decode_step import fused_qkv_attn as pallas

    heads, kvh, hd = geom
    hin, t, layers, layer = 256, 768, 2, 1
    rng = np.random.default_rng(23)

    def bf(*shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(torch.bfloat16)

    x = bf(1, hin)
    w = bf(hin, (heads + 2 * kvh) * hd, scale=0.05)
    kc = bf(layers, 1, kvh, t, hd, scale=hd ** -0.25)
    vc = bf(layers, 1, kvh, t, hd)
    qn = kn = torch.full((hd,), hd ** -0.25).to(torch.bfloat16)
    cos, sin = (torch.from_numpy(np.asarray(a[pos:pos + 1])).to(torch.bfloat16)
                for a in _rope(t, hd))
    kw = dict(heads=heads, kv_heads=kvh, head_dim=hd, eps=1e-6)
    q, k_new, v_new = fused_qkv_rope_plain(x, w, cos, sin, q_norm=qn, k_norm=kn, **kw)
    model = _step_model(q, k_new, v_new, kc[layer, 0], vc[layer, 0], pos, heads, kvh, hd)
    twin = fused_qkv_attn(x, w, cos, sin, kc, vc, layer, pos, q_norm=qn, k_norm=kn, **kw)[0]
    jb = lambda a: jnp.asarray(a.float().numpy(), jnp.bfloat16)   # noqa: E731
    ref = pallas(jb(x), jb(w), jb(cos), jb(sin), jb(kc), jb(vc), layer, jnp.int32(pos),
                 q_norm=jb(qn), k_norm=jb(kn), interpret=True, **kw)[0]
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert model.shape == twin.shape == (1, heads * hd) and twin.dtype == torch.bfloat16
    _within_bf16_tol(model, twin)
    _within_bf16_tol(model, ref)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("geom,pos", [((16, 8, 128), 126), ((16, 8, 64), 700)],
                         ids=["qwen-126", "kani-700"])
def test_step_split_on_the_qkv_split_matches_pallas(geom, pos, quant):
    """Kernel 12 as the card runs it: the model of kernel 11's split at one
    row (the plan at H 1024: slices of 256 or 512 rows) makes q, k and v, and
    the model of the attention's cluster split reads them; against tts_tpu's
    fused_qkv_attn in interpret mode and the port's twin, bf16 or int8
    weights."""
    from tts_tpu.ops.decode_step import fused_qkv_attn as pallas

    heads, kvh, hd = geom
    hin, t, layers, layer = 1024, 768, 2, 1
    rng = np.random.default_rng(24 + quant)
    x = _bf(rng, 1, hin)
    w, wj = _qkv_weights(_bf(rng, hin, (heads + 2 * kvh) * hd, scale=0.03), quant)
    kc = _bf(rng, layers, 1, kvh, t, hd, scale=hd ** -0.25)
    vc = _bf(rng, layers, 1, kvh, t, hd)
    qn = kn = torch.full((hd,), hd ** -0.25).to(torch.bfloat16)
    cos, sin = (torch.from_numpy(np.asarray(a[pos:pos + 1])).to(torch.bfloat16)
                for a in _rope(t, hd))
    plan = qkv_plan(hin, heads + 2 * kvh, hd, 1 if quant else 2, 132)
    assert plan.ctas > 1
    q, k_new, v_new = _qkv_model(x, w, plan, heads, kvh, hd, cos, sin, qn, kn)
    model = _step_model(q, k_new, v_new, kc[layer, 0], vc[layer, 0], pos, heads, kvh, hd)
    kw = dict(heads=heads, kv_heads=kvh, head_dim=hd, eps=1e-6)
    twin = fused_qkv_attn(x, w, cos, sin, kc, vc, layer, pos, q_norm=qn, k_norm=kn, **kw)
    ref = pallas(_jb(x), wj, _jb(cos), _jb(sin), _jb(kc), _jb(vc), layer, jnp.int32(pos),
                 q_norm=_jb(qn), k_norm=_jb(kn), interpret=True, **kw)
    for m, tw, r in zip((model, k_new, v_new), twin, ref):
        _within_bf16_tol(m, tw)
        _within_bf16_tol(m, torch.from_numpy(np.array(r.astype(jnp.float32))))


def _rope(t, hd):
    from tts_tpu_torch.nn.rope import rope_table

    return rope_table(t, hd, 1e6)
