"""Fused DiT MLP block of the F5 transformer (counterpart of
tts_tpu/ops/dit_mlp.py: mlp_block_fused and mlp_block_fused_q8).

Both compute x + gate * (ff2(gelu_tanh(ff1(LN(x) * (1 + scale) + shift)))).
Each wrapper runs its hand-written CUDA kernels on a CUDA tensor and its
plain PyTorch twin on a CPU tensor, with the TPU kernel's rounding points.

`mlp_block_fused` (csrc/dit_mlp.cu; twin `mlp_block_plain`), float
weights: LayerNorm statistics in fp32 (eps 1e-6) rounded to the activation
dtype; the modulation in the activation dtype; each dot accumulates in
fp32 and is rounded to the activation dtype before its bias; the gelu (tanh
form) in fp32, rounded once.

`mlp_block_fused_q8` (csrc/dit_mlp_q8.cu; twin `mlp_block_q8_plain`), int8
weights (W8A8): the mods taken in the activation dtype; LayerNorm and
modulation in fp32, not rounded; each dot's input quantized to int8 per
row (ops/quant_matmul's contract), rescaled in fp32 with its bias; the gelu
in fp32; y rounded to the activation dtype, then x + gate * y in that dtype.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .quant_matmul import check_cuda_args, int_dot, quantize_rows, row_scratch

__all__ = ["mlp_block_fused", "mlp_block_plain", "mlp_block_fused_q8",
           "mlp_block_q8_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_TILE = 64   # rows, D and F must be multiples of the kernel's GEMM tile


def _mods3(mods: torch.Tensor, b: int, d: int) -> torch.Tensor:
    """(3, D) shared or (Bm, 3, D) with Bm in {1, B} -> (Bm, 3, D)."""
    if mods.dim() == 2:
        mods = mods[None]
    if mods.dim() != 3 or mods.shape[1:] != (3, d) or mods.shape[0] not in (1, b):
        raise ValueError(f"mods {tuple(mods.shape)} is neither (3, {d}) nor "
                         f"(1 or {b}, 3, {d})")
    return mods


def mlp_block_plain(x, mods, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch twin of the kernel. Dots take fp32 operands, so they
    accumulate in fp32 whatever the activation dtype."""
    dt = x.dtype
    mods = _mods3(mods, x.shape[0], x.shape[-1]).to(dt)
    shift, scale, gate = mods[:, 0:1], mods[:, 1:2], mods[:, 2:3]
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    n = ((xf - mean) * torch.rsqrt(var + 1e-6)).to(dt) * (1 + scale) + shift
    h = (n.float() @ w1.float()).to(dt) + b1.to(dt)
    h = F.gelu(h.float(), approximate="tanh").to(dt)
    y = (h.float() @ w2.float()).to(dt) + b2.to(dt)
    return x + gate * y


def mlp_block_fused(x: torch.Tensor, mods: torch.Tensor, w1: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor) -> torch.Tensor:
    """x (B, T, D); mods (3, D) shared or (B, 3, D) per batch row, rows
    [shift, scale, gate]; w1 (D, F), b1 (F,), w2 (F, D), b2 (D,)."""
    bsz, t, d = x.shape
    f = w1.shape[1]
    if w1.shape != (d, f) or w2.shape != (f, d) or b1.shape != (f,) \
            or b2.shape != (d,):
        raise ValueError(f"weights {tuple(w1.shape)} / {tuple(w2.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    mods = _mods3(mods, bsz, d)
    if x.device.type == "cpu":
        return mlp_block_plain(x, mods, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    args = (("x", x), ("mods", mods), ("w1", w1), ("b1", b1), ("w2", w2),
            ("b2", b2))
    for name, a in args:
        if a.dtype != torch.bfloat16 or a.device != x.device:
            raise TypeError(f"the CUDA kernel takes bf16 tensors on {x.device};"
                            f" {name} is {a.dtype} on {a.device}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if (bsz * t) % _TILE or d % _TILE or f % _TILE:
        raise ValueError(f"rows {bsz * t}, D {d} and F {f} must be multiples "
                         f"of {_TILE}")
    hidden = torch.empty((bsz * t, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.launch("mlp_block_fused", _ARGTYPES, x.data_ptr(), mods.data_ptr(),
                  mods.shape[0], w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                  b2.data_ptr(), hidden.data_ptr(), out.data_ptr(), bsz, t, d, f,
                  stream)
    return out


def _gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), in its order of operations."""
    c = torch.tensor(0.7978845608028654, dtype=torch.float32)    # f32(sqrt(2/pi))
    return h * (0.5 * (1.0 + torch.tanh(c * (h + 0.044715 * (h * h * h)))))


def mlp_block_q8_plain(x, mods, w1_q, w1_scale, b1, w2_q, w2_scale, b2) -> torch.Tensor:
    """Plain PyTorch twin of the W8A8 kernel."""
    dt = x.dtype
    mods = _mods3(mods, x.shape[0], x.shape[-1]).to(dt).float()
    shift, scale, gate = mods[:, 0:1], mods[:, 1:2], mods[:, 2:3]
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    n = (xf - mean) * torch.rsqrt(var + 1e-6) * (1 + scale) + shift
    q, xs = quantize_rows(n)
    h = _gelu_tanh(int_dot(q, w1_q) * xs * w1_scale.float() + b1.float())
    q, hs = quantize_rows(h)
    y = int_dot(q, w2_q) * hs * w2_scale.float() + b2.float()
    return x + gate.to(dt) * y.to(dt)


def mlp_block_fused_q8(x: torch.Tensor, mods: torch.Tensor, w1_q: torch.Tensor,
                       w1_scale: torch.Tensor, b1: torch.Tensor, w2_q: torch.Tensor,
                       w2_scale: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x (B, T, D); mods (3, D) shared or (B, 3, D) per batch row, rows
    [shift, scale, gate]; w1_q (D, F) int8 with per-column fp32 w1_scale
    (F,), b1 (F,); likewise w2_q (F, D), w2_scale (D,), b2 (D,)."""
    bsz, t, d = x.shape
    f = w1_q.shape[1]
    if w1_q.shape != (d, f) or w2_q.shape != (f, d) or w1_scale.shape != (f,) \
            or b1.shape != (f,) or w2_scale.shape != (d,) or b2.shape != (d,):
        raise ValueError(f"weights {tuple(w1_q.shape)} / {tuple(w2_q.shape)} and "
                         f"their scales and biases do not fit x {tuple(x.shape)}")
    mods = _mods3(mods, bsz, d)
    if x.device.type == "cpu":
        return mlp_block_q8_plain(x, mods, w1_q, w1_scale, b1, w2_q, w2_scale, b2)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    # the mods in the activation dtype (as the TPU kernel takes them), then
    # fp32 for the kernel: exact
    mods = mods.to(x.dtype).float().contiguous()
    s1, b1, s2, b2 = (a.to(torch.float32).contiguous() for a in (w1_scale, b1, w2_scale, b2))
    fp32 = torch.float32
    check_cuda_args(x, d, f, x=(x, torch.bfloat16), mods=(mods, fp32),
                    w1_q=(w1_q, torch.int8), w1_scale=(s1, fp32), b1=(b1, fp32))
    check_cuda_args(x, f, d, w2_q=(w2_q, torch.int8), w2_scale=(s2, fp32), b2=(b2, fp32))
    m = bsz * t
    xq, xs = row_scratch(x, m, max(d, f))            # the int8 rows of both dots
    hidden = torch.empty((m, f), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    _build.launch("mlp_block_fused_q8", [_P, _P, _I] + [_P] * 10 + [_I] * 4 + [_P],
                  x.data_ptr(), mods.data_ptr(), mods.shape[0], w1_q.data_ptr(),
                  s1.data_ptr(), b1.data_ptr(), w2_q.data_ptr(), s2.data_ptr(),
                  b2.data_ptr(), xq.data_ptr(), xs.data_ptr(), hidden.data_ptr(),
                  out.data_ptr(), m, t, d, f,
                  torch.cuda.current_stream(x.device).cuda_stream)
    return out
