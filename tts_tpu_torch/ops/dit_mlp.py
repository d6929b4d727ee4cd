"""Fused DiT MLP block of the F5 transformer (counterpart of
tts_tpu/ops/dit_mlp.py:mlp_block_fused).

`mlp_block_fused` runs the hand-written CUDA kernels (csrc/dit_mlp.cu) on a
CUDA tensor and its plain PyTorch twin `mlp_block_plain` on a CPU tensor.
Both compute x + gate * (ff2(gelu_tanh(ff1(LN(x) * (1 + scale) + shift)))),
with the TPU kernel's rounding points: LayerNorm statistics in fp32 (eps
1e-6) rounded to the activation dtype; the modulation in the activation
dtype; each dot accumulates in fp32 and is rounded to the activation dtype
before its bias; the gelu (tanh form) in fp32, rounded once.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["mlp_block_fused", "mlp_block_plain"]

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
