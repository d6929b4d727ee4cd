"""STFT / ISTFT as framed matmuls (counterpart of tts_tpu/audio/stft.py).

Framing: with K = ceil(n_fft / hop), a hop-aligned signal reshaped to
(M, hop) rows gives frame t as rows[t : t+K], so the frames are K static
row slices concatenated; one (T, K*hop) @ (K*hop, 2F) product then gives
every DFT bin. The inverse is the mirror image: (T, 2F) @ (2F, K*hop), then
the K hop-sized chunks of each frame are added at K static offsets, and the
overlap-add is normalised by the window sum. The bases are the same numpy
tables as tts_tpu's; the products run in fp32 (callers on a card keep
TF32 off).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .windows import make_window, padded_window

__all__ = ["StftKernel", "IstftKernel", "stft", "istft"]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _dft_basis(n_fft: int) -> np.ndarray:
    """Real-stacked one-sided DFT basis, shape (2F, n_fft), F = n_fft//2 + 1."""
    eye = np.fft.fft(np.eye(n_fft, dtype=np.float64))
    half = n_fft // 2 + 1
    return np.vstack([eye[:half].real, eye[:half].imag])


class _OnDevice:
    """Per-device copies of host tables, made once."""

    def __init__(self):
        self._cache: dict = {}

    def get(self, key, device, make) -> torch.Tensor:
        k = (key, str(device))
        if k not in self._cache:
            self._cache[k] = torch.as_tensor(make(), device=device)
        return self._cache[k]


class StftKernel:
    """Forward STFT: x (..., N) -> (real, imag), each (..., F, N//hop + 1),
    centre-padded as torch.stft(center=True)."""

    def __init__(self, n_fft: int, hop: int, win_length: int,
                 window_type: str = "hann"):
        self.n_fft, self.hop, self.win_length = n_fft, hop, win_length
        self.window_type = window_type
        window = padded_window(window_type, win_length, n_fft)
        t = np.arange(n_fft, dtype=np.float64)[None, :]
        f = np.arange(n_fft // 2 + 1, dtype=np.float64)[:, None]
        omega = 2.0 * np.pi * f * t / n_fft
        cos_k = np.cos(omega) * window[None, :]          # (F, n_fft)
        sin_k = -np.sin(omega) * window[None, :]         # (F, n_fft)
        k = _cdiv(n_fft, hop)
        basis = np.concatenate([cos_k, sin_k], axis=0)   # (2F, n_fft)
        basis = np.pad(basis, ((0, 0), (0, k * hop - n_fft)))
        # (K*hop, 2F): [cos | -sin] columns, window folded in
        self.basis = basis.T.astype(np.float32)
        self._dev = _OnDevice()

    @property
    def num_bins(self) -> int:
        return self.n_fft // 2 + 1

    def __call__(self, x: torch.Tensor, pad_mode: str = "reflect"):
        n_fft, hop = self.n_fft, self.hop
        half = n_fft // 2
        lead = x.shape[:-1]
        n = x.shape[-1]
        num_frames = n // hop + 1
        k = _cdiv(n_fft, hop)
        flat = x.reshape(-1, 1, n)
        flat = F.pad(flat, (half, half),
                     mode="reflect" if pad_mode == "reflect" else "constant")
        # right-pad so every frame's K row slices exist
        need = (num_frames - 1 + k) * hop
        flat = F.pad(flat, (0, max(0, need - flat.shape[-1])))[..., :need]
        rows = flat.reshape(*lead, -1, hop)                   # (..., M, hop)
        frames = torch.cat([rows[..., i:i + num_frames, :] for i in range(k)],
                           dim=-1)                            # (..., T, K*hop)
        basis = self._dev.get("basis", x.device, lambda: self.basis)
        spec = torch.matmul(frames, basis).transpose(-1, -2)  # (..., 2F, T)
        f = self.num_bins
        return spec[..., :f, :], spec[..., f:, :]


class IstftKernel:
    """Inverse STFT matching the pinv-basis + window-sum normalisation of
    tts_tpu's IstftKernel: (real, imag) (..., F, T) -> (..., (T-1)*hop)."""

    def __init__(self, n_fft: int, hop: int, win_length: int,
                 window_type: str = "hann"):
        self.n_fft, self.hop, self.win_length = n_fft, hop, win_length
        self.window_type = window_type
        window = padded_window(window_type, win_length, n_fft)
        fb = _dft_basis(n_fft)                                # (2F, n_fft)
        inv = np.linalg.pinv(fb * n_fft / hop).T * window[None, :]
        k = _cdiv(n_fft, hop)
        inv = np.pad(inv, ((0, 0), (0, k * hop - n_fft)))
        self.basis = inv.astype(np.float32)                   # (2F, K*hop)
        orig = make_window(window_type, win_length).astype(np.float64)
        wn = orig / np.abs(orig).max()
        if win_length < n_fft:
            left = (n_fft - win_length) // 2
            self.win_sq = np.pad(wn**2, (left, n_fft - win_length - left))
        else:
            self.win_sq = wn**2
        self._dev = _OnDevice()

    @property
    def num_bins(self) -> int:
        return self.n_fft // 2 + 1

    def _window_sum_inv(self, num_frames: int) -> np.ndarray:
        n = self.n_fft + self.hop * (num_frames - 1)
        wsum = np.zeros(n, dtype=np.float64)
        for i in range(num_frames):
            s = i * self.hop
            wsum[s : s + self.n_fft] += self.win_sq[: max(0, min(self.n_fft, n - s))]
        return (self.n_fft / (wsum * self.hop + 1e-7)).astype(np.float32)

    def __call__(self, real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
        n_fft, hop = self.n_fft, self.hop
        half = n_fft // 2
        spec = torch.cat([real, imag], dim=-2)                # (..., 2F, T)
        lead = spec.shape[:-2]
        num_frames = spec.shape[-1]
        k = _cdiv(n_fft, hop)
        basis = self._dev.get("basis", spec.device, lambda: self.basis)
        frames = torch.matmul(spec.transpose(-1, -2), basis)  # (..., T, K*hop)
        chunks = frames.reshape(*lead, num_frames, k, hop)
        total = (num_frames - 1 + k) * hop
        out = torch.zeros((*lead, total), dtype=frames.dtype, device=frames.device)
        for i in range(k):
            out[..., i * hop : i * hop + num_frames * hop] += \
                chunks[..., :, i, :].reshape(*lead, num_frames * hop)
        out = out[..., : n_fft + hop * (num_frames - 1)]
        wsi = self._dev.get(("wsi", num_frames), spec.device,
                            lambda: self._window_sum_inv(num_frames))
        out = out * wsi
        return out[..., half : hop * (num_frames - 1) + n_fft - half]

    def from_mag_phase(self, magnitude: torch.Tensor,
                       phase: torch.Tensor) -> torch.Tensor:
        """Input (magnitude, phase), each (..., F, T)."""
        return self(magnitude * torch.cos(phase), magnitude * torch.sin(phase))


# One-shot forms over kernels cached by their settings -----------------------

@functools.lru_cache(maxsize=32)
def _stft_kernel(n_fft, hop, win_length, window_type) -> StftKernel:
    return StftKernel(n_fft, hop, win_length, window_type)


@functools.lru_cache(maxsize=32)
def _istft_kernel(n_fft, hop, win_length, window_type) -> IstftKernel:
    return IstftKernel(n_fft, hop, win_length, window_type)


def stft(x: torch.Tensor, n_fft: int, hop: int, win_length: int | None = None,
         window_type: str = "hann", pad_mode: str = "reflect"):
    """One-shot STFT -> (real, imag), each (..., n_fft//2+1, N//hop+1)."""
    return _stft_kernel(n_fft, hop, win_length or n_fft, window_type)(x, pad_mode=pad_mode)


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int,
          win_length: int | None = None, window_type: str = "hann") -> torch.Tensor:
    """One-shot ISTFT from (real, imag) -> waveform (..., (T-1)*hop)."""
    return _istft_kernel(n_fft, hop, win_length or n_fft, window_type)(real, imag)
