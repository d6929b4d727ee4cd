"""Rotary position tables (counterpart of tts_tpu/nn/rope.py), host numpy."""
from __future__ import annotations

import numpy as np

__all__ = ["rope_table_interleaved"]


def rope_table_interleaved(max_seq_len: int, head_dim: int, base: float = 10000.0,
                           interpolation: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables, each (max_seq_len, head_dim), with repeat-interleaved
    frequencies (the F5 DiT convention)."""
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    pos = np.arange(max_seq_len, dtype=np.float64)
    freqs = np.outer(pos, inv_freq) / interpolation      # (T, D/2)
    emb = np.repeat(freqs, 2, axis=-1)                   # (T, D)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)
