"""Fused decode-layer tail for M = 1..8 AR decode rows (counterpart of
tts_tpu/ops/decode_mlp.py): attention out-projection -> residual ->
RMSNorm -> SwiGLU MLP -> residual,

    x2 = x + dense(att, wo);  h = rms_norm(x2)
    g, u = split(dense(h, w_gate_up));  out = x2 + dense(silu(g) * u, w_down)

`fused_out_mlp` (kernel 14) takes bf16 weights or int8 weight-only
QTensors, all three of one kind; `fused_out_mlp_q8` (kernel 15) is the W8A8
form over int8 QTensors. Each runs the hand-written CUDA kernel
(csrc/decode_mlp.cu, csrc/decode_mlp_q8.cu) on a CUDA tensor and its plain
PyTorch twin on a CPU tensor; `out_mlp_reference` is the plain chain
(dense, rms_norm, silu in the activation dtype) the kernels replace.
`out_mlp_plan` and `q8_tail_plan` cut kernels 14's and 15's three weight
streams over the card.

Kernel 14's rounding points, in the activation dtype: each dot accumulates
in fp32 and is rounded, then (int8) times the scale rounded to the dtype;
x2 and the output are rounded sums; h is rounded once from fp32; a =
silu(g) * u is computed in fp32 from the rounded g and u and rounded once.
The card sums each dot over slices of its input dim (the plan's), then the
slices in order: another fp32 order than the twin's one matmul, within
the kernels' tolerance.

Kernel 15's quantization (tts_tpu's _kernel_q8, with the att row
quantization its wrapper ran ahead of it): att per row, xs = max(amax,
1e-8) * f32(1/127), q = clip(round_half_even(v / xs), -127, 127);
y = (acc * ats) * so in fp32, x2 = x + y rounded; n = x2 * rsqrt(mean(x2^2)
+ eps) in fp32, unrounded, quantized per row; per F-block of
fb = _pick_block(F) columns (512 at F = 3072): g, u rescaled in fp32, a =
silu(g) * u, quantized per row of the block, its down product rescaled and
summed over the blocks in order; out = x2 + (accf * sd) rounded. The block
size sets the activation scales, so it is part of the contract. The twin
sums the int8 products as a float64 matmul, exact below 2^53.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..quant.weight_only import QTensor, dense
from . import _build
from .decode_qkv import _ptr
from .quant_matmul import int_dot, quantize_rows

__all__ = ["fused_out_mlp", "fused_out_mlp_plain", "fused_out_mlp_q8",
           "fused_out_mlp_q8_plain", "out_mlp_reference", "out_mlp_fits", "out_mlp_plan",
           "OutMlpPlan", "q8_tail_plan", "Q8TailPlan"]

MAX_ROWS = 8                 # decode rows the CUDA kernels take
_H_MAX, _F_MAX = 4096, 4096  # widest hidden and FFN they hold on chip
_TILE_BYTES = 128            # bytes of each weight row a CTA of kernel 14 takes
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# x, att, wo, wgu, wd, w_int8, so, sgu, sd, x2, a, out, B, A, H, F, c1, k1,
# c2, k2, c3, k3, pdl, eps, stream
_ARGTYPES = [_P] * 5 + [_I] + [_P] * 6 + [_I] * 11 + [_F, _P]
# x, att, wo, wgu, wd, so, sgu, sd, x2, a, out, B, A, H, F, fb, c1, k1, c2,
# k2, c3, k3, eps, stream
_ARGTYPES_Q8 = [_P] * 11 + [_I] * 11 + [_F, _P]
_MAX_PASSES = 2              # sub-blocks of the down product one CTA takes
_MIN_ROWS = 512              # input rows a CTA of kernels 14 and 15 takes at least
_CLUSTER = 8                 # CTAs a cluster of kernels 14 and 15 (the portable size)


def _pick_block(dim: int, target: int = 512, mult: int = 128) -> int:
    """Largest divisor of `dim` that is a multiple of `mult` and <= target;
    falls back to the smallest multiple-of-mult divisor (or dim itself).
    tts_tpu's block rule, copied: kernel 15's activation scales follow it."""
    best = None
    for b in range(mult, dim + 1, mult):
        if dim % b == 0:
            if b <= target:
                best = b
            elif best is None:
                best = b
                break
    return best if best is not None else dim


def out_mlp_fits(batch: int, a_dim: int, hidden: int, ffn: int) -> bool:
    """Whether the CUDA kernels take these widths: 1..8 rows, the attention
    width a multiple of 8, hidden and FFN multiples of 32 up to 4096, and
    (W8A8) an F-block that 32 divides."""
    fb = _pick_block(ffn)
    return (1 <= batch <= MAX_ROWS and a_dim % 8 == 0 and hidden % 32 == 0
            and ffn % 32 == 0 and hidden <= _H_MAX and ffn <= _F_MAX and fb % 32 == 0)


def _parts(wo, w_gate_up, w_down, x, att):
    """(quantized, f_dim) after tts_tpu's checks: one kind of weight, shapes
    that chain (A, H) -> (H, 2F) -> (F, H)."""
    quant = isinstance(wo, QTensor)
    if quant != isinstance(w_gate_up, QTensor) or quant != isinstance(w_down, QTensor):
        raise ValueError("wo/w_gate_up/w_down must be uniformly quantized")
    b, hd = x.shape
    a_dim = att.shape[1]
    f_dim = w_down.shape[0]
    if att.shape[0] != b or tuple(w_gate_up.shape) != (hd, 2 * f_dim) \
            or tuple(wo.shape) != (a_dim, hd) or tuple(w_down.shape) != (f_dim, hd):
        raise ValueError(f"shape mismatch: wo {tuple(wo.shape)}, gate_up "
                         f"{tuple(w_gate_up.shape)}, down {tuple(w_down.shape)} for x "
                         f"{tuple(x.shape)}, att {tuple(att.shape)}")
    return quant, f_dim


# --------------------------------------------------------------------------
# plain twins

def out_mlp_reference(x, att, wo, w_gate_up, w_down, *, eps: float = 1e-6):
    """The plain chain the kernels replace (the layer tail of
    models/qwen_tts when no fused route is taken)."""
    from ..nn.norm import rms_norm

    x = x + dense(att, wo)
    gate, up = dense(rms_norm(x, eps=eps), w_gate_up).chunk(2, dim=-1)
    return x + dense(F.silu(gate) * up, w_down)


def _dot(a: torch.Tensor, w, cols: slice | None = None) -> torch.Tensor:
    """fp32 dot rounded to a.dtype, then (int8) times the scale in a.dtype."""
    wq = w.q if isinstance(w, QTensor) else w
    if cols is not None:
        wq = wq[:, cols]
    y = torch.matmul(a.float(), wq.float()).to(a.dtype)
    if isinstance(w, QTensor):
        s = w.scale if cols is None else w.scale[cols]
        y = y * s.to(a.dtype)
    return y


def fused_out_mlp_plain(x, att, wo, w_gate_up, w_down, *, eps: float = 1e-6):
    """Plain PyTorch twin of kernel 14: same contract, same rounding points."""
    _, f_dim = _parts(wo, w_gate_up, w_down, x, att)
    x2 = x + _dot(att.to(x.dtype), wo)
    xf = x2.float()
    h = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)).to(x.dtype)
    g = _dot(h, w_gate_up, slice(0, f_dim))
    u = _dot(h, w_gate_up, slice(f_dim, 2 * f_dim))
    a = (F.silu(g.float()) * u.float()).to(x.dtype)
    return x2 + _dot(a, w_down)


def fused_out_mlp_q8_plain(x, att, wo, w_gate_up, w_down, *, eps: float = 1e-6):
    """Plain PyTorch twin of kernel 15: same contract, same rounding points."""
    if not all(isinstance(w, QTensor) for w in (wo, w_gate_up, w_down)):
        raise ValueError("fused_out_mlp_q8 needs int8 QTensor weights")
    _, f_dim = _parts(wo, w_gate_up, w_down, x, att)
    dt = x.dtype
    attq, ats = quantize_rows(att.float())
    x2 = x + (int_dot(attq, wo.q) * ats * wo.scale).to(dt)
    xf = x2.float()
    n = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    hq, hs = quantize_rows(n)
    fb = _pick_block(f_dim)
    accf = torch.zeros_like(xf)
    for j in range(f_dim // fb):
        g_cols = slice(j * fb, (j + 1) * fb)
        u_cols = slice(f_dim + j * fb, f_dim + (j + 1) * fb)
        g = int_dot(hq, w_gate_up.q[:, g_cols]) * hs * w_gate_up.scale[g_cols]
        u = int_dot(hq, w_gate_up.q[:, u_cols]) * hs * w_gate_up.scale[u_cols]
        aq, as_ = quantize_rows(F.silu(g) * u)
        accf = accf + int_dot(aq, w_down.q[g_cols]) * as_
    return x2 + (accf * w_down.scale).to(dt)


# --------------------------------------------------------------------------
# CUDA kernels

def _operands(x, att, ws) -> None:
    """The CUDA kernels' operand rules: contiguous 16-byte-aligned tensors on
    x's card, bf16 activations, bf16 or int8 weights, fp32 scales."""
    dev = x.device
    for name, a in (("x", x), ("att", att)):
        if a.dtype != torch.bfloat16 or a.device != dev or not a.is_contiguous() \
                or a.data_ptr() % 16:
            raise TypeError(f"the CUDA kernel takes {name} as a contiguous bf16 tensor "
                            f"on {dev}")
    for name, w in ws:
        wq = w.q if isinstance(w, QTensor) else w
        want = torch.int8 if isinstance(w, QTensor) else torch.bfloat16
        if wq.dtype != want or wq.device != dev or not wq.is_contiguous() \
                or wq.data_ptr() % 16:
            raise TypeError(f"{name} must be contiguous, 16-byte aligned {want} on {dev}")
        if isinstance(w, QTensor) and (w.scale.dtype != torch.float32 or w.scale.device
                                       != dev or not w.scale.is_contiguous()):
            raise TypeError(f"{name}'s scale must be contiguous fp32 on {dev}")


def _prepare(x, att, wo, w_gate_up, w_down):
    """Device checks and the kernels' limits. Returns (f_dim, quant), or
    None for a CPU tensor."""
    quant, f_dim = _parts(wo, w_gate_up, w_down, x, att)
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    b, hd = x.shape
    if not out_mlp_fits(b, att.shape[1], hd, f_dim):
        raise ValueError(f"the CUDA kernels take 1..{MAX_ROWS} rows, an attention width "
                         f"a multiple of 8, hidden and FFN multiples of 32 up to "
                         f"{_H_MAX}; got B={b}, A={att.shape[1]}, H={hd}, F={f_dim}")
    _operands(x, att, (("wo", wo), ("w_gate_up", w_gate_up), ("w_down", w_down)))
    return f_dim, quant


class OutMlpPlan(NamedTuple):
    """Kernel 14's cut of its three weight streams (csrc/decode_mlp.cu):
    launch l cuts its input dim (the attention width, the hidden width, the
    FFN width) into c_l slices of k_l rows, the c_l CTAs of a column tile
    one cluster; `pdl` launches the three with programmatic stream
    serialization (each issues its weight loads before it waits for the
    previous launch)."""
    c1: int
    k1: int
    c2: int
    k2: int
    c3: int
    k3: int
    pdl: bool


def _fill(dim: int, tiles: int, sms: int, min_rows: int = _MIN_ROWS) -> tuple[int, int]:
    """(CTAs, rows) over `dim` input rows for `tiles` column tiles: slices
    of at least `min_rows` rows, no more than it takes for tiles x slices
    to reach the SM count, at most 8 a cluster (the portable size), each a
    multiple of 8 rows (16-byte copies of bf16 activations), in order, none
    empty."""
    want = max(1, min(_CLUSTER, -(-sms // tiles), dim // min_rows))
    k = -(-dim // want)
    k = -(-k // 8) * 8
    return -(-dim // k), k


@functools.lru_cache(maxsize=64)
def out_mlp_plan(a_dim: int, hidden: int, ffn: int, w_bytes: int, sms: int,
                 rows: int = 1) -> OutMlpPlan:
    """Kernel 14's form (the C entry refuses any other) for weights of
    `w_bytes` bytes a value (2 bf16, 1 int8) on a card of `sms` SMs:
    column tiles of 128 bytes of each weight row (launches 1 and 3: 64 bf16
    or 128 int8 columns; launch 2: half as many gate and as many up
    columns), each tile's input dim cut over a cluster in slices of at
    least 512 rows (`_fill`). At the Qwen3-TTS width (A 2048, H 1024, F
    3072) on an H100: 4 x 16, 2 x 96 and 6 x 16 CTAs in bf16, 4 x 8, 2 x 48
    and 6 x 8 in int8, all of 512 rows. Slices short enough to give every
    SM a CTA (8 x 16, 2 x 96, 8 x 16 of 256, 512, 384 rows in bf16) ran
    slower on the card at B 1, 3 and 8 (`chip_smoke.py`'s forms), as
    kernel 15's did: a cluster's barrier grows with its CTAs. Programmatic
    dependent launch for bf16 weights and for int8 at one row: it took
    25% off a chained bf16 call at B 1, 14% at B 3, none at B 8, 14% in
    int8 at B 1, and added 25% and 18% in int8 at B 3 and 8."""
    cols = _TILE_BYTES // w_bytes
    tiles = -(-hidden // cols)
    c1, k1 = _fill(a_dim, tiles, sms)
    c2, k2 = _fill(hidden, -(-ffn // (cols // 2)), sms)
    c3, k3 = _fill(ffn, tiles, sms)
    return OutMlpPlan(c1, k1, c2, k2, c3, k3, w_bytes == 2 or rows == 1)


def fused_out_mlp(x: torch.Tensor, att: torch.Tensor, wo, w_gate_up, w_down, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """x (B, H) residual input; att (B, A) attention rows; wo (A, H),
    w_gate_up (H, 2F), w_down (F, H), all bf16 tensors or all int8 QTensors.
    Returns (B, H) in x's dtype."""
    prep = _prepare(x, att, wo, w_gate_up, w_down)
    if prep is None:
        return fused_out_mlp_plain(x, att, wo, w_gate_up, w_down, eps=eps)
    f_dim, quant = prep
    b, hd = x.shape
    a_dim = att.shape[1]
    plan = out_mlp_plan(a_dim, hd, f_dim, 1 if quant else 2, _build.sm_count(x.device), b)
    # bf16 scratch: x2 (B, H), then a (B, F)
    scratch = torch.empty((b * (hd + f_dim),), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    w = [t.q if quant else t for t in (wo, w_gate_up, w_down)]
    scales = [t.scale if quant else None for t in (wo, w_gate_up, w_down)]
    _build.launch("fused_out_mlp", _ARGTYPES, x.data_ptr(), att.data_ptr(),
                  *(t.data_ptr() for t in w), int(quant), *map(_ptr, scales),
                  scratch.data_ptr(), scratch[b * hd:].data_ptr(), out.data_ptr(), b, a_dim,
                  hd, f_dim, *plan[:6], int(plan.pdl), eps,
                  torch.cuda.current_stream(x.device).cuda_stream, device=x.device)
    return out


class Q8TailPlan(NamedTuple):
    """Kernel 15's cut of its three weight streams (csrc/decode_mlp_q8.cu):
    launch 1 cuts the attention width into c1 slices of k1 rows, launch 2
    the hidden width into c2 slices of k2 rows (each a cluster of the CTAs
    of one column tile), launch 3 the FFN width into sub-blocks of k3 rows,
    which divide the F-block, over a cluster of c3 CTAs (sub-block s on CTA
    s % c3, at most two a CTA)."""
    c1: int
    k1: int
    c2: int
    k2: int
    c3: int
    k3: int


def _cut(dim: int) -> tuple[int, int]:
    """(CTAs, rows) over `dim` input rows: slices of at least 512 rows, at
    most 8 a cluster (the portable size), each a multiple of 8 rows (a
    thread's row quads, and 16-byte loads of bf16 activations), in order,
    none empty."""
    want = max(1, min(_CLUSTER, dim // _MIN_ROWS))
    k = -(-dim // want)
    k = -(-k // 8) * 8
    return -(-dim // k), k


@functools.lru_cache(maxsize=64)
def q8_tail_plan(a_dim: int, hidden: int, ffn: int) -> Q8TailPlan:
    """Kernel 15's form (the C entry refuses any other): column tiles of 128
    (launches 1 and 3: 128 contiguous bytes of each weight row) and of 64
    gate + 64 up columns (launch 2), each tile's input dim cut over a
    cluster of at most 8 CTAs with slices of at least 512 rows. On the card
    (NVIDIA H100, `chip_smoke.py`'s forms at the Qwen3-TTS width) larger
    clusters and shorter slices lost: a cluster's barrier grows with its
    CTAs, and a CTA with more rows keeps more loads in flight. Launch 3's
    sub-blocks are the smallest divisor of the F-block (a multiple of 4, at
    least 512 rows where the F-block has them) that leaves at most 8; where
    even the F-block leaves more (F-blocks of 128 at F 2176 and more), the
    F-block, two a CTA."""
    c1, k1 = _cut(a_dim)
    c2, k2 = _cut(hidden)
    fb = _pick_block(ffn)
    fit = [d for d in range(min(_MIN_ROWS, fb), fb + 1, 4)
           if fb % d == 0 and ffn // d <= _CLUSTER]
    if fit:
        k3 = fit[0]
        c3 = ffn // k3
    else:
        k3 = fb
        c3 = -(-(ffn // fb) // _MAX_PASSES)
    return Q8TailPlan(c1, k1, c2, k2, c3, k3)


def fused_out_mlp_q8(x: torch.Tensor, att: torch.Tensor, wo, w_gate_up, w_down, *,
                     eps: float = 1e-6) -> torch.Tensor:
    """The W8A8 tail: as fused_out_mlp, all three weights int8 QTensors with
    fp32 scales; att, h and a quantized per row (a per F-block)."""
    if not all(isinstance(w, QTensor) for w in (wo, w_gate_up, w_down)):
        raise ValueError("fused_out_mlp_q8 needs int8 QTensor weights")
    prep = _prepare(x, att, wo, w_gate_up, w_down)
    if prep is None:
        return fused_out_mlp_q8_plain(x, att, wo, w_gate_up, w_down, eps=eps)
    f_dim = prep[0]
    b, hd = x.shape
    a_dim = att.shape[1]
    plan = q8_tail_plan(a_dim, hd, f_dim)
    # x2 (bf16) and a (fp32)
    n_x2 = (b * hd + 1) // 2
    scratch = torch.empty((n_x2 + b * f_dim,), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    _build.launch("fused_out_mlp_q8", _ARGTYPES_Q8, x.data_ptr(), att.data_ptr(),
                  wo.q.data_ptr(), w_gate_up.q.data_ptr(), w_down.q.data_ptr(),
                  wo.scale.data_ptr(), w_gate_up.scale.data_ptr(), w_down.scale.data_ptr(),
                  scratch.data_ptr(), scratch[n_x2:].data_ptr(), out.data_ptr(), b, a_dim,
                  hd, f_dim, _pick_block(f_dim), *plan, eps,
                  torch.cuda.current_stream(x.device).cuda_stream, device=x.device)
    return out
