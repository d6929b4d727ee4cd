"""1-D convolution in feature-last (B, T, C) layout with WIO weights
(K, C_in/groups, C_out) (counterpart of tts_tpu/ops/conv.py: conv1d and
conv_transpose1d).

The compute dtype follows the weights. The depthwise case at stride 1 runs
as K shifted multiply-adds, as in tts_tpu; the others go to
torch.nn.functional.conv1d / conv_transpose1d.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv1d", "conv_transpose1d"]


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           padding: int = 0, groups: int = 1, dilation: int = 1,
           stride: int = 1) -> torch.Tensor:
    """'padding' zeros on both sides, taps `dilation` apart, outputs
    `stride` apart."""
    x = x.to(w.dtype)
    if (groups == x.shape[-1] and w.shape[1] == 1 and w.shape[2] == groups
            and stride == 1):
        k = w.shape[0]
        t = x.shape[1] + 2 * padding - dilation * (k - 1)
        xp = F.pad(x, (0, 0, padding, padding))
        out = xp[:, :t] * w[0, 0]
        for i in range(1, k):
            out = out + xp[:, i * dilation:i * dilation + t] * w[i, 0]
        return out if b is None else out + b
    xt = F.pad(x.transpose(1, 2), (padding, padding))       # (B, C, T)
    out = F.conv1d(xt, w.permute(2, 1, 0), stride=stride, groups=groups,
                   dilation=dilation).transpose(1, 2)
    return out if b is None else out + b


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                     stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch.nn.ConvTranspose1d semantics, out_len = (T-1)*stride - 2*padding
    + K, for x (B, T, C_in) and w (K, C_in, C_out): torch's (C_in, C_out, K)
    weight in WIO layout."""
    x = x.to(w.dtype)
    out = F.conv_transpose1d(x.transpose(1, 2), w.permute(1, 2, 0), stride=stride,
                             padding=padding).transpose(1, 2)
    return out if b is None else out + b
