"""`dense` (counterpart of tts_tpu/quant/weight_only.py:dense), float
weights only: the int8 and int4 forms are not ported yet."""
from __future__ import annotations

import torch

__all__ = ["dense"]


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for a plain float weight."""
    if w.is_floating_point():
        return torch.matmul(x, w)
    raise TypeError(f"quantized weights ({w.dtype}) are not ported yet")
