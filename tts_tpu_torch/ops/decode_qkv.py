"""Fused decode-layer qkv head for M = 1..8 AR decode rows (counterpart of
tts_tpu/ops/decode_qkv.py:fused_qkv_rope):

    h = rms_norm(x) or layer_norm(x, ln_weight, ln_bias)   # fp32, to dtype
    qkv = h @ wqkv                     # fp32 accumulation, rounded to dtype
    qkv = qkv * scale (int8 weights) + bqkv                # in dtype
    q, k = per-head RMSNorm(q, q_norm), (k, k_norm)        # optional
    q, k = half-split RoPE                                 # optional

`fused_qkv_rope` runs the hand-written CUDA kernel (csrc/decode_qkv.cu) on
a CUDA tensor and its plain PyTorch twin `fused_qkv_rope_plain` on a CPU
tensor. Both keep the TPU kernel's rounding points: the normed input is
rounded to the activation dtype; the dot accumulates in fp32 and is rounded;
the int8 scale is rounded to the activation dtype and multiplied there,
then the bias added; the per-head norm runs in fp32 and is rounded once;
the rotation is three rounded ops in the activation dtype (two products
and their sum). q/k norms apply whether or not RoPE does, as in the XLA
chain the kernel replaces (the TPU kernel applied them only with RoPE, a
combination no caller passes).

The model gates (`fusable_layout`, `fusable_weight`) are tts_tpu's, so the
port routes a step exactly where tts_tpu does; `MAX_ROWS` is the CUDA
kernel's own row limit, which the models add to the gate.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..quant.weight_only import QTensor
from . import _build

__all__ = ["MAX_ROWS", "fusable_layout", "fusable_weight", "fused_qkv_rope",
           "fused_qkv_rope_plain"]

MAX_ROWS = 8                # decode rows the CUDA kernel takes
_HEAD_DIMS = (64, 128)      # head widths the CUDA kernel is built for
_COLS_PER_BLOCK = 256       # wqkv columns one matvec block covers
_STEP_STAGE = 48 * 1024     # bytes of partial sums kernel 12 stages a kv head
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# x, w, w_int8, scale, bias, q_norm, k_norm, cos, sin, ln_w, ln_b, partial,
# q, k, v, B, H, heads, kv_heads, head_dim, ksplit, kslice, eps, stream
_ARGTYPES = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, _I, _F, _P]


def fusable_weight(w) -> bool:
    """Plain tensors and int8 QTensors fuse (the int4 forms, which stay on
    the dense path in tts_tpu, are not ported)."""
    return isinstance(w, (torch.Tensor, QTensor))


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=64)
def _k_split(device: torch.device, hin: int, n: int,
             max_split: int | None = None) -> tuple[int, int]:
    """(blocks along the input dim, input rows per block): about two blocks
    per SM over the whole matvec, at most `max_split` (where given), each
    taking a multiple of 8 rows (one per warp) of the input dim."""
    tiles = _cdiv(n, _COLS_PER_BLOCK)
    want = max(1, min(_cdiv(2 * _build.sm_count(device), tiles), hin // 8,
                      max_split or hin))
    kslice = _cdiv(_cdiv(hin, want), 8) * 8
    return _cdiv(hin, kslice), kslice


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
                ln_weight, ln_bias, eps: float, step: bool = False):
    """Check the CUDA kernel's operands and allocate its outputs. Returns
    (argument list of the C entry without its stream, (q, k, v)). With
    `step` (kernel 12's head, one row) q stays on chip: no q is allocated
    (None) and the list has neither q nor the row count."""
    b, hin = x.shape
    dev = x.device
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"the CUDA kernel takes contiguous bf16 x, got {x.dtype}")
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"the CUDA kernel takes 1..{MAX_ROWS} rows, got {b}")
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernel is built for head dims {_HEAD_DIMS}, "
                         f"got {head_dim}")
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
    # kernel 12 stages one kv head's heads of every slice in shared memory
    stage = _STEP_STAGE // (4 * (heads // kv_heads + 2) * head_dim) if step else None
    ksplit, kslice = _k_split(dev, hin, n, stage)
    partial = torch.empty((ksplit, b, n), dtype=torch.float32, device=dev)
    q = None if step else torch.empty((b, heads * head_dim), dtype=x.dtype, device=dev)
    k = torch.empty((b, kv_heads * head_dim), dtype=x.dtype, device=dev)
    v = torch.empty((b, kv_heads * head_dim), dtype=x.dtype, device=dev)
    outs = [k.data_ptr(), v.data_ptr()] if step else [q.data_ptr(), k.data_ptr(),
                                                      v.data_ptr(), b]
    args = [x.data_ptr(), w.data_ptr(), int(quant), _ptr(scale),
            *map(_ptr, vecs), partial.data_ptr(), *outs, hin, heads, kv_heads,
            head_dim, ksplit, kslice, eps]
    return args, (q, k, v)


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
    args, out = launch_args(x, wqkv, rope_cos, rope_sin, heads, kv_heads, head_dim,
                            q_norm, k_norm, bqkv, norm, ln_weight, ln_bias, eps)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.launch("fused_qkv_rope", _ARGTYPES, *args, stream, device=x.device)
    return out
