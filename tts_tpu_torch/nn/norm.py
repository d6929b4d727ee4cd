"""LayerNorm and RMSNorm (counterparts of tts_tpu/nn/norm.py): statistics
and affine in fp32, the result cast back to the input dtype."""
from __future__ import annotations

import torch

__all__ = ["layer_norm", "rms_norm", "l2_norm"]


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
               bias: torch.Tensor | None = None, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
             eps: float = 1e-5) -> torch.Tensor:
    """weight=None means the weight was absorbed into the next projection."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def l2_norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / sqrt(sum(x^2) + eps) along the last axis, in fp32."""
    xf = x.float()
    return (xf / torch.sqrt(xf.square().sum(dim=-1, keepdim=True) + eps)).to(x.dtype)
