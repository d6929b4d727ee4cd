"""Kernel 17: ablations of the W8A8 DiT MLP block (counterpart of
benchmarks/q8_kernel_profile.py: `_mk` over `_body` and `_body_dots_only`).

Each variant is kernel 6 (ops/dit_mlp.mlp_block_fused_q8: LN and modulate,
the int8 row quantizer, ff1, gelu, the hidden's row quantizer, ff2, the
gated residual) with one piece swapped or removed, as (ln, quant, gelu):

  ln     "two_pass"  LayerNorm as kernel 6 (mean, then mean((x - mean)^2));
         "one_pass"  var = mean(x^2) - mean^2;
         "none"      no LayerNorm: x itself is modulated;
  quant  "dynamic"   kernel 6's per-row scale, max(amax, 1e-8) * f32(1/127);
         "fixed"     one scale 0.05 for every row, q = clip(rint(v * 20)):
                     no amax, and in ff1 no exchange of row maxima across
                     the cluster;
  gelu   "tanh_f32" (kernel 6's), "tanh_bf16" (the same on h rounded to
         bf16, in bf16), "relu", "none", "sig" (x sigmoid(1.702 x)),
         "sig_exp2" (its exp2 form), "tanh_exp2" (the tanh gelu with tanh
         through exp2).

`dots_only` keeps only the two int8 products: x converted to int8 toward
zero, acc = x W1 in int32, (acc >> 8) wrapped to int8, acc2 = that W2,
written as acc2 in the activation dtype.

`mlp_block_q8_variant` runs the hand-written CUDA kernels (csrc/
dit_mlp_q8_variants.cu: kernel 6's three launches with the variant's hooks
in csrc/q8_core.cuh and csrc/q8_wgmma.cuh, or the dots path) on a CUDA
tensor and the plain twin `mlp_block_q8_variant_plain` on a CPU tensor. The
CUDA kernels take bf16 activations and K-major weights, as kernel 6 does.
`full` is kernel 6, bit for bit. No pipeline calls it: the ablation entry
point (tts_tpu_torch/ablations/q8_kernel_profile.py) and the smoke run do.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .dit_mlp import _gelu_tanh, _mods3
from .quant_matmul import (check_cuda_args, int_dot, kmajor, q8_plan, quantize_rows,
                           row_scratch)

__all__ = ["VARIANTS", "mlp_block_q8_variant", "mlp_block_q8_variant_plain"]

# name -> (ln, quant, gelu), as the script's table; dots_only has none
VARIANTS = {
    "full": ("two_pass", "dynamic", "tanh_f32"),
    "ln_one_pass": ("one_pass", "dynamic", "tanh_f32"),
    "no_ln": ("none", "dynamic", "tanh_f32"),
    "fixed_scale": ("two_pass", "fixed", "tanh_f32"),
    "gelu_bf16": ("two_pass", "dynamic", "tanh_bf16"),
    "gelu_relu": ("two_pass", "dynamic", "relu"),
    "no_gelu": ("two_pass", "dynamic", "none"),
    "gelu_sig": ("two_pass", "dynamic", "sig"),
    "gelu_sig_exp2": ("two_pass", "dynamic", "sig_exp2"),
    "gelu_tanh_exp2": ("two_pass", "dynamic", "tanh_exp2"),
    "lean": ("one_pass", "dynamic", "tanh_bf16"),
    "dots_only": None,
}
_LN = ("two_pass", "one_pass", "none")
_QUANT = ("dynamic", "fixed")
_GELU = ("tanh_f32", "tanh_bf16", "relu", "none", "sig", "sig_exp2", "tanh_exp2")
_LOG2E = 1.4426950408889634
_FIXED_SCALE = 0.05          # the fixed quantizer: xs = 0.05, q = rint(v * 20)
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, mods, mods rows, w1t, s1, b1, w2t, s2, b2, xq, xs, hq, hs, out,
# M, T, D, F, st1, st2, ln, quant, gelu, dots, stream
_ARGTYPES = [_P, _P, _I] + [_P] * 11 + [_I] * 10 + [_P]


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32)


def _layer_norm(xf: torch.Tensor, ln: str) -> torch.Tensor:
    mean = xf.mean(dim=-1, keepdim=True)
    if ln == "two_pass":
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
    else:
        var = xf.square().mean(dim=-1, keepdim=True) - mean.square()
    return (xf - mean) * torch.rsqrt(var + 1e-6)


def _quantize(v: torch.Tensor, quant: str) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 rows -> (int8 values as fp32, scale): per row or fixed."""
    if quant == "dynamic":
        return quantize_rows(v)
    return torch.clamp(torch.round(v * 20.0), -127, 127), _f32(_FIXED_SCALE)


def _gelu_tanh_bf16(h: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True) of h rounded to bf16, every op in bf16
    (its constants rounded to bf16), back in fp32."""
    x = h.to(torch.bfloat16)
    c = torch.tensor(np.sqrt(2 / np.pi), dtype=torch.float64).to(torch.bfloat16)
    k = torch.tensor(0.044715, dtype=torch.float64).to(torch.bfloat16)
    return (x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))).float()


def _gelu(h: torch.Tensor, kind: str) -> torch.Tensor:
    """The script's activations on fp32 h, in its order of operations."""
    if kind == "tanh_f32":
        return _gelu_tanh(h)
    if kind == "tanh_bf16":
        return _gelu_tanh_bf16(h)
    if kind == "relu":
        return torch.clamp(h, min=0.0)
    if kind == "none":
        return h
    if kind == "sig":
        return h * torch.sigmoid(1.702 * h)
    if kind == "sig_exp2":
        return h / (1.0 + torch.exp2(_f32(-1.702 * _LOG2E).to(h.device) * h))
    u = 0.7978845608028654 * (h + 0.044715 * h * h * h)
    t = torch.exp2(_f32(2 * _LOG2E).to(h.device) * u)
    return 0.5 * h * (2.0 - 2.0 / (t + 1.0))


def _dots_only(x: torch.Tensor, w1_q: torch.Tensor, w2_q: torch.Tensor) -> torch.Tensor:
    """int8(x) toward zero, (x W1 >> 8) wrapped to int8, that W2, in x's
    dtype. The products run in float64, exact for these integers."""
    nq = torch.trunc(x.float()).clamp(-128, 127)
    acc = (nq.double() @ w1_q.double()).long()
    hq = torch.bitwise_right_shift(acc, 8).to(torch.int8)
    return (hq.double() @ w2_q.double()).float().to(x.dtype)


def mlp_block_q8_variant_plain(x, mods, w1_q, s1, b1, w2_q, s2, b2, *,
                               variant: str) -> torch.Tensor:
    """Plain PyTorch twin of kernel 17 at the Pallas `_body`'s rounding
    points (kernel 6's twin, ops/dit_mlp.mlp_block_q8_plain, with the
    variant's pieces)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {tuple(VARIANTS)}")
    if VARIANTS[variant] is None:
        return _dots_only(x, w1_q, w2_q)
    ln, quant, gelu = VARIANTS[variant]
    dt = x.dtype
    mods = _mods3(mods, x.shape[0], x.shape[-1]).to(dt).float()
    shift, scale, gate = mods[:, 0:1], mods[:, 1:2], mods[:, 2:3]
    xf = x.float()
    n = (xf if ln == "none" else _layer_norm(xf, ln)) * (1 + scale) + shift
    q, xs = _quantize(n, quant)
    h = _gelu(int_dot(q, w1_q) * xs.to(x.device) * s1.float() + b1.float(), gelu)
    q, hs = _quantize(h, quant)
    y = int_dot(q, w2_q) * hs.to(x.device) * s2.float() + b2.float()
    return x + gate.to(dt) * y.to(dt)


def mlp_block_q8_variant(x: torch.Tensor, mods: torch.Tensor, w1_q: torch.Tensor,
                         s1: torch.Tensor, b1: torch.Tensor, w2_q: torch.Tensor,
                         s2: torch.Tensor, b2: torch.Tensor, *, variant: str) -> torch.Tensor:
    """Kernel 6's arguments (x (B, T, D); mods (3, D) or (Bm, 3, D); w1_q
    (D, F) int8 with per-column fp32 s1 (F,), b1 (F,); w2_q (F, D), s2,
    b2 (D,); on a card both weights K-major) through variant `variant`
    (a key of VARIANTS). Returns (B, T, D) in x's dtype."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {tuple(VARIANTS)}")
    bsz, t, d = x.shape
    f = w1_q.shape[1]
    if w1_q.shape != (d, f) or w2_q.shape != (f, d) or s1.shape != (f,) \
            or b1.shape != (f,) or s2.shape != (d,) or b2.shape != (d,):
        raise ValueError(f"weights {tuple(w1_q.shape)} / {tuple(w2_q.shape)} and "
                         f"their scales and biases do not fit x {tuple(x.shape)}")
    mods = _mods3(mods, bsz, d)
    if x.device.type == "cpu":
        return mlp_block_q8_variant_plain(x, mods, w1_q, s1, b1, w2_q, s2, b2,
                                          variant=variant)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    mods = mods.to(x.dtype).float().contiguous()
    s1, b1, s2, b2 = (a.to(torch.float32).contiguous() for a in (s1, b1, s2, b2))
    w1t, w2t = kmajor(w1_q), kmajor(w2_q)
    fp32, i8 = torch.float32, torch.int8
    check_cuda_args(x, d, f, x=(x, torch.bfloat16), mods=(mods, fp32), w1_qt=(w1t, i8),
                    s1=(s1, fp32), b1=(b1, fp32))
    check_cuda_args(x, f, d, w2_qt=(w2t, i8), s2=(s2, fp32), b2=(b2, fp32))
    m, sms = bsz * t, _build.sm_count(x.device)
    dots = VARIANTS[variant] is None
    ln, quant, gelu = VARIANTS["full"] if dots else VARIANTS[variant]
    p1 = q8_plan(m, f, d, sms, whole_rows=not dots)
    p2 = q8_plan(m, d, f, sms)
    xq, xs = row_scratch(x, m, d)
    hq, hs = row_scratch(x, m, f)
    out = torch.empty_like(x)
    _build.launch("mlp_block_q8_variant", _ARGTYPES,
                  x.data_ptr(), mods.data_ptr(), mods.shape[0], w1t.data_ptr(), s1.data_ptr(),
                  b1.data_ptr(), w2t.data_ptr(), s2.data_ptr(), b2.data_ptr(), xq.data_ptr(),
                  xs.data_ptr(), hq.data_ptr(), hs.data_ptr(), out.data_ptr(), m, t, d, f,
                  p1.stages, p2.stages, _LN.index(ln), _QUANT.index(quant),
                  _GELU.index(gelu), int(dots), torch.cuda.current_stream(x.device).cuda_stream,
                  device=x.device)
    return out
