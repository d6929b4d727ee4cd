"""1-D convolution in feature-last (B, T, C) layout with WIO weights
(K, C_in/groups, C_out) (counterpart of tts_tpu/ops/conv.py:conv1d, for the
stride-1 cases F5 and Vocos use).

The compute dtype follows the weights. The depthwise case runs as K
shifted multiply-adds, as in tts_tpu; the others go to
torch.nn.functional.conv1d.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv1d"]


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           padding: int = 0, groups: int = 1) -> torch.Tensor:
    """Stride-1, 'padding' zeros on both sides."""
    x = x.to(w.dtype)
    if groups == x.shape[-1] and w.shape[1] == 1 and w.shape[2] == groups:
        k = w.shape[0]
        t = x.shape[1] + 2 * padding - (k - 1)
        xp = F.pad(x, (0, 0, padding, padding))
        out = xp[:, :t] * w[0, 0]
        for i in range(1, k):
            out = out + xp[:, i : i + t] * w[i, 0]
        return out if b is None else out + b
    xt = F.pad(x.transpose(1, 2), (padding, padding))       # (B, C, T)
    out = F.conv1d(xt, w.permute(2, 1, 0), groups=groups).transpose(1, 2)
    return out if b is None else out + b
