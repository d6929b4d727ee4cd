"""Fused decode-layer qkv head for M = 1..8 AR decode rows (counterpart of
tts_tpu/ops/decode_qkv.py:fused_qkv_rope):

    h = rms_norm(x) or layer_norm(x, ln_weight, ln_bias)   # fp32, to dtype
    qkv = h @ wqkv                     # fp32 accumulation, rounded to dtype
    qkv = qkv * scale (int8 weights) + bqkv                # in dtype
    q, k = per-head RMSNorm(q, q_norm), (k, k_norm)        # optional
    q, k = half-split RoPE                                 # optional

`fused_qkv_rope` runs the hand-written CUDA kernel (csrc/decode_qkv.cu,
one launch: a weight stream over the card whose sums meet, through a
thread-block cluster, on the CTA that runs the epilogue of their heads) on
a CUDA tensor and its plain PyTorch twin `fused_qkv_rope_plain` on a CPU
tensor. `qkv_plan` cuts the stream over the card; kernel 12
(ops/decode_step.py) runs the same launch as its first. Both keep the TPU
kernel's rounding points: the normed input is rounded to the activation
dtype; the dot accumulates in fp32 and is rounded; the int8 scale is
rounded to the activation dtype and multiplied there, then the bias added;
the per-head norm runs in fp32 and is rounded once; the rotation is three
rounded ops in the activation dtype (two products and their sum). q/k
norms apply whether or not RoPE does, as in the XLA chain the kernel
replaces (the TPU kernel applied them only with RoPE, a combination no
caller passes). The card sums each dot over slices of the input dim (the
plan's), then the slices in order: another fp32 order than the twin's one
matmul, within the kernels' tolerance.

The model gates (`fusable_layout`, `fusable_weight`) are tts_tpu's, so the
port routes a step exactly where tts_tpu does; `qkv_fits` holds the CUDA
kernel's own limits (rows, head dim, input width), which the models add to
the gate.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..quant.weight_only import QTensor
from . import _build

__all__ = ["MAX_ROWS", "MAX_HIDDEN", "QkvPlan", "fusable_layout", "fusable_weight",
           "fused_qkv_rope", "fused_qkv_rope_plain", "qkv_fits", "qkv_plan"]

MAX_ROWS = 8                # decode rows the CUDA kernel takes
MAX_HIDDEN = 8192           # input width the CUDA kernel takes (a multiple of 8)
_HEAD_DIMS = (64, 128)      # head widths the CUDA kernel is built for
_TILE_BYTES = 128           # bytes of each weight row a CTA takes at least
_CLUSTER = 8                # CTAs a cluster (the portable size)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# x, w, w_int8, scale, bias, q_norm, k_norm, cos, sin, ln_w, ln_b, q, k, v,
# B, H, heads, kv_heads, head_dim, ctas, rows, pdl, eps, stream
_ARGTYPES = [_P, _P, _I] + [_P] * 11 + [_I] * 8 + [_F, _P]


def fusable_weight(w) -> bool:
    """Plain tensors and int8 QTensors fuse (the int4 forms, which stay on
    the dense path in tts_tpu, are not ported)."""
    return isinstance(w, (torch.Tensor, QTensor))


def qkv_fits(batch: int, hidden: int, head_dim: int) -> bool:
    """Whether the CUDA kernel takes these widths: 1..8 rows, head dim 64 or
    128, an input width that is a multiple of 8 up to 8192 (16-byte loads
    of the rows; its slice fits shared memory)."""
    return (1 <= batch <= MAX_ROWS and head_dim in _HEAD_DIMS and hidden % 8 == 0
            and 8 <= hidden <= MAX_HIDDEN)


def fusable_layout(batch: int, heads: int, kv_heads: int, head_dim: int) -> bool:
    """tts_tpu's packing gate (128-lane rows on the TPU), kept so that the
    port takes the fused routes exactly where tts_tpu does."""
    if head_dim >= 128:
        return True
    q_sz, kv_sz = heads * head_dim, kv_heads * head_dim
    return not (128 % head_dim or q_sz % 128 or kv_sz % 128
                or (batch * heads) % (128 // head_dim)
                or (batch * kv_heads) % (128 // head_dim))


# --------------------------------------------------------------------------
# plain twin

def _norm_rope(seg: torch.Tensor, weight, cos, sin, n_heads: int, head_dim: int,
               eps: float) -> torch.Tensor:
    """(B, n_heads*hd) -> per-head RMSNorm (weight optional) then half-split
    RoPE (optional), at the kernel's rounding points."""
    b, dt = seg.shape[0], seg.dtype
    hs = seg.reshape(b, n_heads, head_dim)
    if weight is not None:
        xf = hs.float()
        o = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
        hs = (o * weight.float()).to(dt)
    if cos is not None:
        half = head_dim // 2
        rot = torch.cat([-hs[..., half:], hs[..., :half]], dim=-1)
        hs = hs * cos.reshape(head_dim).to(dt) + rot * sin.reshape(head_dim).to(dt)
    return hs.reshape(b, n_heads * head_dim)


def fused_qkv_rope_plain(x: torch.Tensor, wqkv, rope_cos=None, rope_sin=None, *,
                         heads: int, kv_heads: int, head_dim: int,
                         q_norm=None, k_norm=None, bqkv=None, norm: str = "rms",
                         ln_weight=None, ln_bias=None, eps: float = 1e-6):
    """Plain PyTorch twin of the kernel: same contract, same rounding
    points. The dot takes fp32 operands (products of bf16 values are exact
    in fp32), so it accumulates in fp32 as the kernel does."""
    dt = x.dtype
    xf = x.float()
    if norm == "ln":
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        h = (xf - mean) * torch.rsqrt(var + eps) * ln_weight.float() + ln_bias.float()
    else:
        h = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    h = h.to(dt).float()
    if isinstance(wqkv, QTensor):
        qkv = torch.matmul(h, wqkv.q.float()).to(dt) * wqkv.scale.to(dt)
    else:
        qkv = torch.matmul(h, wqkv.float()).to(dt)
    if bqkv is not None:
        qkv = qkv + bqkv.to(dt)
    q_sz, kv_sz = heads * head_dim, kv_heads * head_dim
    q, k, v = qkv[:, :q_sz], qkv[:, q_sz:q_sz + kv_sz], qkv[:, q_sz + kv_sz:]
    q = _norm_rope(q, q_norm, rope_cos, rope_sin, heads, head_dim, eps)
    k = _norm_rope(k, k_norm, rope_cos, rope_sin, kv_heads, head_dim, eps)
    return q, k, v.contiguous()


# --------------------------------------------------------------------------
# CUDA kernel

def check_contract(x: torch.Tensor, wqkv, heads: int, kv_heads: int, head_dim: int,
                   q_norm, k_norm, rope_cos, rope_sin, norm: str, ln_weight,
                   ln_bias) -> None:
    """Raise on what the kernel's contract excludes (both paths)."""
    w = wqkv.q if isinstance(wqkv, QTensor) else wqkv
    if not fusable_weight(wqkv):
        raise TypeError(f"no fused qkv head for a {type(wqkv).__name__} weight")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and wqkv {tuple(w.shape)} do not "
                         f"make a (B, H) @ (H, N) product")
    if w.shape[1] != (heads + 2 * kv_heads) * head_dim:
        raise ValueError(f"wqkv out {w.shape[1]} != heads/kv split "
                         f"({heads} + 2 * {kv_heads}) * {head_dim}")
    if (q_norm is None) != (k_norm is None) or (rope_cos is None) != (rope_sin is None):
        raise ValueError("q_norm/k_norm and rope_cos/rope_sin come in pairs")
    if norm not in ("rms", "ln"):
        raise ValueError(f"norm must be 'rms' or 'ln', got {norm!r}")
    if norm == "ln" and (ln_weight is None or ln_bias is None):
        raise ValueError("norm='ln' needs ln_weight and ln_bias")


class QkvPlan(NamedTuple):
    """Kernel 11's cut of its weight stream (csrc/decode_qkv.cu): the input
    dim cut into `ctas` slices of `rows` rows, the `ctas` CTAs of a column
    tile one cluster; `pdl` launches with programmatic stream serialization
    (the launch issues its weight loads before it waits for the previous
    one)."""
    ctas: int
    rows: int
    pdl: bool


def heads_a_tile(head_dim: int, w_bytes: int) -> int:
    """Whole heads a column tile of kernel 11 takes: at least 128 bytes of
    each weight row (bf16: one head; int8: two at head dim 64, one at
    128)."""
    return max(1, _TILE_BYTES // (head_dim * w_bytes))


def _chunk(head_dim: int, w_bytes: int, rows: int) -> int:
    """Input rows a CTA of kernel 11 has in flight at once: its 256 threads
    over the tile's 16-byte column groups, 16 row loads a thread (8 in int8
    past 4 rows; csrc/weight_stream.cuh's rows_in_flight)."""
    groups = heads_a_tile(head_dim, w_bytes) * head_dim * w_bytes // 16
    return 256 // groups * (8 if w_bytes == 1 and rows > 4 else 16)


@functools.lru_cache(maxsize=256)
def qkv_plan(hidden: int, n_heads: int, head_dim: int, w_bytes: int, sms: int,
             rows: int = 1) -> QkvPlan:
    """Kernel 11's form (the C entry refuses any other) for `n_heads` q, k
    and v heads of `head_dim` over an input of `hidden` rows, with weights
    of `w_bytes` bytes a value (2 bf16, 1 int8), `rows` activation rows, on
    a card of `sms` SMs, with programmatic dependent launch (faster chained
    at every measured form). Column tiles of `heads_a_tile` whole heads,
    each tile's input dim cut over a cluster so that a CTA's slice is one
    chunk of loads in flight (`_chunk`: a second chunk waits a memory round
    trip after the first), then fewer CTAs a tile while the grid passes
    what the card holds at once: two CTAs an SM where the kernel's
    registers allow it (ptxas: <= 128 at bf16 up to 5 rows, int8 up to 2),
    less 4 for each CTA a cluster past the first (the clusters pack into
    the card's GPCs: clusters of 4 at one CTA an SM ran 120 CTAs at full
    speed, 128 up to 1.4x slower). Measured on an H100 (`chip_smoke.py`'s
    sweep of every cut), the rule picks the fastest form, or one within 7%
    of it, at the Kani, Qwen3-TTS and IndexTTS-1.5 shapes at B 1, 4 and 8,
    bf16 and int8: Kani bf16 2 x 32 CTAs, Qwen bf16 4 x 32 (3 x 32 at B 8),
    IndexTTS bf16 3 x 60 (2 x 60 at B 8)."""
    tiles = -(-n_heads // heads_a_tile(head_dim, w_bytes))
    ctas = max(1, min(_CLUSTER, -(-hidden // _chunk(head_dim, w_bytes, rows))))
    room = sms * (2 if rows <= (5 if w_bytes == 2 else 2) else 1)
    while ctas > 1 and tiles * ctas > room - 4 * (ctas - 1):
        ctas -= 1
    k = -(-hidden // ctas)
    k = -(-k // 8) * 8
    return QkvPlan(-(-hidden // k), k, True)


def _bf16_vec(t, name: str, n: int, device) -> torch.Tensor | None:
    """A small vector operand as a contiguous bf16 (n,) tensor on `device`."""
    if t is None:
        return None
    if t.numel() != n:
        raise ValueError(f"{name} has {t.numel()} entries, expected {n}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != torch.bfloat16 or not t.is_contiguous():
        t = t.to(torch.bfloat16).contiguous()
    return t                     # any shape: the kernel reads n contiguous values


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def launch_args(x: torch.Tensor, wqkv, rope_cos, rope_sin, heads: int,
                kv_heads: int, head_dim: int, q_norm, k_norm, bqkv, norm: str,
                ln_weight, ln_bias, extra: int = 0):
    """Check the CUDA kernel's operands and allocate its outputs, q (B,
    heads*hd), k and v (B, kvh*hd), and `extra` more values (kernel 12's
    attention row) in one bf16 buffer. Returns (the C entry's arguments x ..
    v, (q, k, v), the extra values, the plan)."""
    b, hin = x.shape
    dev = x.device
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"the CUDA kernel takes contiguous bf16 x, got {x.dtype}")
    if not qkv_fits(b, hin, head_dim):
        raise ValueError(f"the CUDA kernel takes 1..{MAX_ROWS} rows, head dims "
                         f"{_HEAD_DIMS} and an input width that is a multiple of 8 up to "
                         f"{MAX_HIDDEN}; got B={b}, H={hin}, head_dim={head_dim}")
    if x.data_ptr() % 16:
        raise ValueError("the CUDA kernel reads x in 16-byte loads: x must be 16-byte "
                         "aligned")
    quant = isinstance(wqkv, QTensor)
    w = wqkv.q if quant else wqkv
    n = w.shape[1]
    if w.device != dev or w.dtype != (torch.int8 if quant else torch.bfloat16):
        raise TypeError(f"wqkv must be bf16 or an int8 QTensor on {dev}, got "
                        f"{w.dtype} on {w.device}")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("wqkv must be contiguous and 16-byte aligned")
    scale = None
    if quant:
        scale = wqkv.scale
        if scale.dtype != torch.float32 or scale.device != dev \
                or scale.shape != (n,) or not scale.is_contiguous():
            raise TypeError(f"the int8 scale must be a contiguous fp32 ({n},) "
                            f"tensor on {dev}")
    vecs = [_bf16_vec(t, name, size, dev) for t, name, size in (
        (bqkv, "bqkv", n), (q_norm, "q_norm", head_dim), (k_norm, "k_norm", head_dim),
        (rope_cos, "rope_cos", head_dim), (rope_sin, "rope_sin", head_dim),
        (ln_weight if norm == "ln" else None, "ln_weight", hin),
        (ln_bias if norm == "ln" else None, "ln_bias", hin))]
    plan = qkv_plan(hin, heads + 2 * kv_heads, head_dim, 1 if quant else 2,
                    _build.sm_count(dev), b)
    q_sz, kv_sz = b * heads * head_dim, b * kv_heads * head_dim
    buf = torch.empty((q_sz + 2 * kv_sz + extra,), dtype=x.dtype, device=dev)
    q, k, v = (buf[lo:lo + size].view(b, -1) for lo, size in (
        (0, q_sz), (q_sz, kv_sz), (q_sz + kv_sz, kv_sz)))
    args = [x.data_ptr(), w.data_ptr(), int(quant), _ptr(scale), *map(_ptr, vecs),
            q.data_ptr(), k.data_ptr(), v.data_ptr()]
    return args, (q, k, v), buf[q_sz + 2 * kv_sz:], plan


def fused_qkv_rope(x: torch.Tensor, wqkv, rope_cos=None, rope_sin=None, *,
                   heads: int, kv_heads: int, head_dim: int,
                   q_norm=None, k_norm=None, bqkv=None, norm: str = "rms",
                   ln_weight=None, ln_bias=None, eps: float = 1e-6):
    """x (B, H); wqkv (H, (heads + 2*kv_heads)*head_dim), a tensor or an
    int8 QTensor; rope_cos/rope_sin the (1, hd) rows of the current
    position (None: no RoPE); q_norm/k_norm (hd,) per-head RMSNorm weights
    (None: no q/k norm); bqkv (N,) bias; norm "rms" (weightless) or "ln"
    with ln_weight/ln_bias. Returns (q (B, heads*hd), k (B, kvh*hd),
    v (B, kvh*hd))."""
    check_contract(x, wqkv, heads, kv_heads, head_dim, q_norm, k_norm, rope_cos,
                   rope_sin, norm, ln_weight, ln_bias)
    if x.device.type == "cpu":
        return fused_qkv_rope_plain(
            x, wqkv, rope_cos, rope_sin, heads=heads, kv_heads=kv_heads,
            head_dim=head_dim, q_norm=q_norm, k_norm=k_norm, bqkv=bqkv, norm=norm,
            ln_weight=ln_weight, ln_bias=ln_bias, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    args, out, _, plan = launch_args(x, wqkv, rope_cos, rope_sin, heads, kv_heads,
                                     head_dim, q_norm, k_norm, bqkv, norm, ln_weight,
                                     ln_bias)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.launch("fused_qkv_rope", _ARGTYPES, *args, x.shape[0], x.shape[1], heads,
                  kv_heads, head_dim, plan.ctas, plan.rows, int(plan.pdl), eps, stream,
                  device=x.device)
    return out
