"""Fused grouped-conv position embedding of the F5 input embedding
(counterpart of tts_tpu/ops/grouped_conv.py:conv_pos_embed_fused).

`conv_pos_embed_fused` runs the hand-written CUDA kernel
(csrc/grouped_conv.cu: an implicit-im2col GEMM on wgmma) on a CUDA tensor
and its plain PyTorch twin `conv_pos_embed_plain` on a CPU tensor. Both
compute mish(conv2(mish(conv1(x)))) + x with two "same"-padded grouped
conv1d in WIO layout, with the TPU kernel's rounding points: each dot
accumulates in fp32 and is rounded to the input dtype, then the bias is
added; mish runs in fp32 and is rounded once.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv_pos_embed_fused", "conv_pos_embed_plain", "kernel_fits"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_CPG = 64        # channels per group the kernel is built for
_T_STEP = 64     # the route admits T in multiples of this
_MAX_TAPS = 33   # widest kernel its halo buffer takes


def kernel_fits(dtype, cin_pg: int, k: int, t: int) -> bool:
    """Whether the CUDA kernel takes this conv: bf16, 64 channels a group,
    an odd width of at most 33 taps, T a multiple of 64."""
    return (dtype == torch.bfloat16 and cin_pg == _CPG and k % 2 == 1 and k <= _MAX_TAPS
            and t % _T_STEP == 0)


def _grouped_conv_mm(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """'same'-padded grouped conv1d as a batched im2col product
    (models/f5._grouped_conv_mm in tts_tpu): x (B, T, C), w (K, C/g, Cout),
    b (Cout,). The product accumulates in fp32 and is rounded to x's dtype
    before the bias."""
    k, cin, cout = w.shape
    bsz, t, c = x.shape
    g = c // cin
    cpg = cout // g
    pad_l = (k - 1) // 2
    xp = F.pad(x, (0, 0, pad_l, k - 1 - pad_l)).reshape(bsz, t + k - 1, g, cin)
    col = torch.stack([xp[:, i:i + t] for i in range(k)], dim=3)
    col = col.permute(2, 0, 1, 3, 4).reshape(g, bsz * t, k * cin)
    wg = w.reshape(k, cin, g, cpg).permute(2, 0, 1, 3).reshape(g, k * cin, cpg)
    out = torch.bmm(col.float(), wg.float())
    out = out.reshape(g, bsz, t, cpg).permute(1, 2, 0, 3).reshape(bsz, t, cout)
    return out.to(x.dtype) + b


def _mish(c: torch.Tensor) -> torch.Tensor:
    cf = c.float()
    sp = torch.where(cf > 20.0, cf, torch.log1p(torch.exp(cf)))
    return (cf * torch.tanh(sp)).to(c.dtype)


def conv_pos_embed_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch twin of the kernel."""
    c = _mish(_grouped_conv_mm(x, w1.to(x.dtype), b1.to(x.dtype)))
    c = _mish(_grouped_conv_mm(c, w2.to(x.dtype), b2.to(x.dtype)))
    return c + x


def conv_pos_embed_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x (B, T, C); w1/w2 (K, C/groups, C) WIO; b1/b2 (C,). Returns
    mish(conv2(mish(conv1(x)))) + x. The group count is C / w1.shape[1]."""
    bsz, t, c = x.shape
    k, cin, cout = w1.shape
    if cout != c or c % cin or w2.shape != w1.shape \
            or b1.shape != (c,) or b2.shape != (c,):
        raise ValueError(f"weights {tuple(w1.shape)} / {tuple(w2.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return conv_pos_embed_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not kernel_fits(x.dtype, cin, k, t):
        raise ValueError(f"the CUDA kernel takes bf16 x with {_CPG} channels a group, "
                         f"an odd width <= {_MAX_TAPS} and T a multiple of {_T_STEP}; got "
                         f"{x.dtype}, {cin} channels a group, width {k}, T {t}")
    for name, a in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if a.dtype != torch.bfloat16 or a.device != x.device:
            raise TypeError(f"the CUDA kernel takes bf16 tensors on {x.device};"
                            f" {name} is {a.dtype} on {a.device}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    scratch = torch.empty_like(x)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.launch("conv_pos_embed_fused", _ARGTYPES, x.data_ptr(),
                  w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  scratch.data_ptr(), out.data_ptr(), bsz, t, c, k, stream, device=x.device)
    return out
