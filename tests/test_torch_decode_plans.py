"""The host-side plans of kernels 12 and 15 (ops/decode_step.step_plan,
ops/decode_mlp.q8_tail_plan) against the forms their C entries accept
(csrc/decode_step.cu `fused_qkv_attn`, csrc/decode_mlp_q8.cu
`fused_out_mlp_q8`), and a plain model of kernel 12's split over a kv
head's cluster held against tts_tpu's Pallas kernel in interpret mode and
against the port's twin.

The C entries refuse any form but the plan's; `_step_accepts` and
`_q8_accepts` below restate their checks, and
`test_c_entries_check_what_the_mirrors_state` reads the checks and the
limits they use from the sources, so the two cannot drift apart unseen.

Tolerance of the split model: the card's 2^-6 of max |ref| and of the rel
L2 (chip_smoke.py's TOL), in bf16. Against the twin only the order of the
fp32 sums differs (slices, then ranks), so a few bf16 roundings of p move;
against tts_tpu's kernel its own bf16 roundings of the qkv head move too.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu_torch.ops.decode_mlp import (Q8TailPlan, _pick_block, out_mlp_fits,
                                          q8_tail_plan)
from tts_tpu_torch.ops import decode_qkv
from tts_tpu_torch.ops.decode_qkv import fused_qkv_rope_plain
from tts_tpu_torch.ops.decode_step import fused_qkv_attn, step_fits, step_plan

CSRC = Path(__file__).resolve().parent.parent / "tts_tpu_torch" / "csrc"
CARD_SMEM = 232448            # an H100 CTA's shared memory, bytes


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


def test_c_entries_check_what_the_mirrors_state():
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
    step = " ".join((CSRC / "decode_step.cu").read_text().split())
    assert "constexpr int ST_MAX_CTAS = 8;" in step
    assert "constexpr int ST_STAGE_MAX = 48 * 1024;" in step
    assert ("return (size_t)ksplit * (G + 2) * HD + (size_t)(1 + ST_WARPS + ctas) * G * HD + "
            "2 * HD + ST_THREADS + (size_t)G * rows;") in step
    assert "constexpr int ST_THREADS = 256;" in step
    assert ("(long long)ksplit * (heads / kv_heads + 2) * hd * sizeof(float) > "
            "tts::ST_STAGE_MAX") in step
    assert decode_qkv._STEP_STAGE == 48 * 1024
    assert ("pos == 0 ? ctas == 1 && rows == 0 : ctas >= 1 && ctas <= tts::ST_MAX_CTAS && "
            "rows >= 1 && (long long)ctas * rows >= pos && (long long)(ctas - 1) * rows < pos"
            ) in step


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


def _cluster_smem(group: int, head_dim: int, ksplit: int, ctas: int, rows: int) -> int:
    """Dynamic shared memory of kernel 12's attention launch, bytes
    (csrc/decode_step.cu's st_smem_floats): the staged partial sums of the
    kv head's heads, q, k_new, v_new, the rotation's rows (256 threads), the
    8 warps' P.V sums, the cluster's (one set a CTA), the slice's scores."""
    return 4 * (ksplit * (group + 2) * head_dim + (9 + ctas) * group * head_dim
                + 2 * head_dim + 256 + group * rows)


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("group", range(1, 9))
def test_step_plan_fits_the_card_wherever_the_gate_admits(group, head_dim):
    """step_fits (the route gate, unchanged) admits pos by the earlier
    one-CTA form's shared memory, up to 200 KB; the cluster form's
    attention launch fits the card's 227 KB at every admitted pos."""
    ksplit = 48 * 1024 // (4 * (group + 2) * head_dim)     # the most it stages
    pos, worst = 0, 0
    while step_fits(group, head_dim, pos):
        ctas, rows = step_plan(pos, head_dim)
        worst = max(worst, _cluster_smem(group, head_dim, ksplit, ctas, rows))
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


def _rope(t, hd):
    from tts_tpu_torch.nn.rope import rope_table

    return rope_table(t, hd, 1e6)
