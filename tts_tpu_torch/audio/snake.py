"""Snake activations (counterparts of tts_tpu/audio/snake.py), per channel:
    snake(x)      = x + (1/alpha) * sin^2(alpha * x)
    snake_beta(x) = x + (1/beta)  * sin^2(alpha * x)
with the reciprocals precomputed at load where the checkpoint gives them."""
from __future__ import annotations

import torch

__all__ = ["snake", "snake_beta"]


def snake(x: torch.Tensor, alpha: torch.Tensor,
          alpha_recip: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., C); alpha, alpha_recip (C,)."""
    if alpha_recip is None:
        alpha_recip = 1.0 / (alpha + 1e-9)
    s = torch.sin(alpha * x)
    return x + alpha_recip * (s * s)


def snake_beta(x: torch.Tensor, alpha: torch.Tensor,
               beta_recip: torch.Tensor) -> torch.Tensor:
    """x (..., C); alpha (C,) already exponentiated, beta_recip (C,) =
    1 / exp(beta), as the loader stores them."""
    s = torch.sin(alpha * x)
    return x + beta_recip * (s * s)
