"""Rotary position embeddings (counterpart of tts_tpu/nn/rope.py): host
numpy tables, and the half-split rotation on tensors."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["rope_table", "rope_table_interleaved", "apply_rope"]


def rope_table(max_seq_len: int, head_dim: int, base: float = 10000.0,
               scaling: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables, each (max_seq_len, head_dim), half-split layout
    (Llama/Qwen/LFM2)."""
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    pos = np.arange(max_seq_len, dtype=np.float64)
    freqs = np.outer(pos, inv_freq)                      # (T, D/2)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return ((np.cos(emb) * scaling).astype(np.float32),
            (np.sin(emb) * scaling).astype(np.float32))


def rope_table_interleaved(max_seq_len: int, head_dim: int, base: float = 10000.0,
                           interpolation: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables, each (max_seq_len, head_dim), with repeat-interleaved
    frequencies (the F5 DiT convention)."""
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    pos = np.arange(max_seq_len, dtype=np.float64)
    freqs = np.outer(pos, inv_freq) / interpolation      # (T, D/2)
    emb = np.repeat(freqs, 2, axis=-1)                   # (T, D)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); cos/sin: (S, D), broadcast over heads."""
    if x.dim() == cos.dim() + 2:
        cos = cos[..., :, None, :]
        sin = sin[..., :, None, :]
    return x * cos + _rotate_half(x) * sin
