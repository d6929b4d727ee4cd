"""Snake activation (counterpart of tts_tpu/audio/snake.py):
snake(x) = x + (1/alpha) * sin^2(alpha * x), per channel, with the
reciprocal precomputed at load where the checkpoint gives it."""
from __future__ import annotations

import torch

__all__ = ["snake"]


def snake(x: torch.Tensor, alpha: torch.Tensor,
          alpha_recip: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., C); alpha, alpha_recip (C,)."""
    if alpha_recip is None:
        alpha_recip = 1.0 / (alpha + 1e-9)
    s = torch.sin(alpha * x)
    return x + alpha_recip * (s * s)
