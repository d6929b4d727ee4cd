"""Mel filterbank + log-mel extraction (counterpart of tts_tpu/audio/mel.py).

The HTK (or slaney) triangular filterbank of
torchaudio.functional.melscale_fbanks, built in numpy, then the log of
fbank @ |STFT| in fp32, with tts_tpu's options.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .stft import StftKernel, _OnDevice

__all__ = ["mel_filterbank", "MelSpectrogram"]


def _hz_to_mel(f, mel_scale: str = "htk"):
    f = np.asarray(f, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):       # log(0) where f = 0: np.where drops it
        return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mel)


def _mel_to_hz(m, mel_scale: str = "htk"):
    m = np.asarray(m, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freq = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freq)


@functools.lru_cache(maxsize=16)
def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int, norm: str | None = None,
                   mel_scale: str = "htk") -> np.ndarray:
    """Triangular mel filterbank, shape (n_freqs, n_mels), float32."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(_hz_to_mel(f_min, mel_scale), _hz_to_mel(f_max, mel_scale),
                        n_mels + 2)
    f_pts = _mel_to_hz(m_pts, mel_scale)
    f_diff = np.diff(f_pts)                                     # (n_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]                # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))                  # (n_freqs, n_mels)
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


class MelSpectrogram:
    """Waveform (..., N) -> log-mel (..., T, n_mels): fbank @ sqrt(re^2 +
    im^2), then log(clamp(mel, 1e-5)) (`log_mode="clamp"`, the F5/BigVGAN
    convention) or log(mel + 1e-5) (`"add"`, the Qwen speaker mel). The STFT
    pads `pad_mode` ("reflect", or "constant" zeros as IndexTTS's reference
    mel does) and windows with `window_type`; the filterbank spans f_min ..
    f_max (default sample_rate / 2) on the `mel_scale` ("htk" or "slaney")
    with `norm` (None or "slaney"), as tts_tpu's options."""

    def __init__(self, sample_rate: int, n_fft: int, hop: int,
                 win_length: int | None = None, n_mels: int = 100,
                 window_type: str = "hann", f_min: float = 0.0,
                 f_max: float | None = None, mel_scale: str = "htk",
                 norm: str | None = None, pad_mode: str = "reflect",
                 log_mode: str = "clamp"):
        if log_mode not in ("clamp", "add"):
            raise ValueError(f"log_mode must be 'clamp' or 'add': {log_mode}")
        self.stft = StftKernel(n_fft, hop, win_length or n_fft, window_type)
        self.pad_mode = pad_mode
        self.log_mode = log_mode
        self.fbank = mel_filterbank(n_fft // 2 + 1, f_min, f_max or sample_rate / 2.0,
                                    n_mels, sample_rate, norm, mel_scale)
        self._dev = _OnDevice()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        real, imag = self.stft(x, pad_mode=self.pad_mode)       # (..., F, T)
        mag = torch.sqrt(real * real + imag * imag)
        fbank = self._dev.get("fbank", x.device, lambda: self.fbank)
        mel = torch.matmul(mag.transpose(-1, -2), fbank)        # (..., T, M)
        if self.log_mode == "add":
            return torch.log(mel + 1e-5)
        return torch.log(torch.clamp(mel, min=1e-5))
