"""Window functions, computed host-side in numpy (float64 -> float32).

Counterpart of tts_tpu/audio/windows.py, re-declared here because
tts_tpu.audio imports JAX. Periodic hann/hamming/bartlett/blackman and
kaiser with beta=12.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_window", "padded_window"]


def _periodic(fn, length: int) -> np.ndarray:
    # numpy's window fns are symmetric over `length` points; the periodic
    # variant is the first `length` points of a symmetric window of length+1.
    return fn(length + 1)[:-1]


def make_window(window_type: str, length: int) -> np.ndarray:
    """Return a periodic window of `length` samples as float32."""
    if length <= 1:
        return np.ones(length, dtype=np.float32)
    n = np.arange(length, dtype=np.float64)
    if window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / length)
    elif window_type == "bartlett":
        w = _periodic(np.bartlett, length)
    elif window_type == "blackman":
        w = _periodic(np.blackman, length)
    elif window_type == "kaiser":
        w = _periodic(lambda L: np.kaiser(L, 12.0), length)
    else:                                   # hann, and the default
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)
    return w.astype(np.float32)


def padded_window(window_type: str, win_length: int, n_fft: int) -> np.ndarray:
    """Window of `win_length` samples centre-padded (or cropped) to `n_fft`."""
    win = make_window(window_type, win_length)
    if win_length == n_fft:
        return win
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        right = n_fft - win_length - left
        return np.pad(win, (left, right)).astype(np.float32)
    start = (win_length - n_fft) // 2
    return win[start : start + n_fft]
