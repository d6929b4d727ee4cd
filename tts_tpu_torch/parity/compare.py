"""Output-fidelity comparison harness (counterpart of tts_tpu/parity/compare.py).

The acceptance criterion is mel-spectrogram L1 <= 1e-2 against the
reference's ONNX Runtime sessions. `wav_mel_l1` compares waveforms through
the same log-mel front end (the port's `audio/mel.MelSpectrogram`);
`stft_diff_report` holds the port's STFT / ISTFT (framed matmuls) against
torch.stft / torch.istft, the reference's own kernel-level check
(STFT_Process.py:179-240).

Each function that computes takes a `device` ("cuda", the default, or
"cpu"). On a card TF32 is off around the call: the STFT's framed matmuls
need full fp32 products.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["mel_l1", "wav_mel_l1", "stft_diff_report"]


@contextlib.contextmanager
def _fp32_products(device: torch.device):
    """TF32 off for matmuls and cuDNN on a CUDA device, restored after."""
    if device.type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def mel_l1(mel_a: np.ndarray, mel_b: np.ndarray) -> float:
    """Mean |Δ| between two log-mel arrays (truncated to the common
    length)."""
    t = min(mel_a.shape[-2], mel_b.shape[-2])
    return float(np.mean(np.abs(np.asarray(mel_a)[..., :t, :]
                                - np.asarray(mel_b)[..., :t, :])))


def wav_mel_l1(wav_a: np.ndarray, wav_b: np.ndarray, sample_rate: int = 24000,
               n_fft: int = 1024, hop: int = 256, n_mels: int = 100,
               device="cuda") -> float:
    """Compare two waveforms (int16 or float) via log-mel L1, the
    acceptance metric. Waveforms are RMS-aligned first so level differences
    don't mask spectral ones; one whose peak passes 2.0 is taken as
    int16-scaled."""
    from ..audio.mel import MelSpectrogram

    def prep(w):
        w = np.asarray(w).astype(np.float32).reshape(-1)
        if np.abs(w).max() > 2.0:          # int16-scaled
            w = w / 32768.0
        rms = np.sqrt(np.mean(w * w)) + 1e-9
        return w / rms * 0.1

    device = torch.device(device)
    n = min(len(wav_a), len(wav_b))
    ms = MelSpectrogram(sample_rate, n_fft, hop, n_fft, n_mels)
    with _fp32_products(device), torch.no_grad():
        ma, mb = (ms(torch.from_numpy(prep(w)[:n][None]).to(device)).cpu().numpy()
                  for w in (wav_a, wav_b))
    return mel_l1(ma, mb)


def stft_diff_report(signal: np.ndarray, n_fft: int = 1024, hop: int = 256,
                     device="cuda") -> dict:
    """Kernel-level numeric diff of the port's StftKernel / IstftKernel
    against torch.stft / torch.istft on the same device. Returns mean |Δ|
    per kernel and of the round trip."""
    from ..audio.stft import IstftKernel, StftKernel

    device = torch.device(device)
    x = np.asarray(signal, np.float32).reshape(-1)
    xt = torch.from_numpy(x)[None].to(device)
    window = torch.hann_window(n_fft, device=device)
    with _fp32_products(device), torch.no_grad():
        ref = torch.stft(xt, n_fft, hop, win_length=n_fft, window=window,
                         center=True, return_complex=True, pad_mode="reflect")
        re, im = StftKernel(n_fft, hop, n_fft)(xt)
        rec = IstftKernel(n_fft, hop, n_fft)(re, im)[0].cpu().numpy()
        ref_rec = torch.istft(ref, n_fft, hop, win_length=n_fft, window=window,
                              center=True)[0].cpu().numpy()
    ref, re, im = ref.cpu(), re.cpu().numpy(), im.cpu().numpy()
    t = min(ref.shape[-1], re.shape[-1])
    stft_err = float(np.mean(np.abs(re[0, :, :t] - ref[0, :, :t].real.numpy()))
                     + np.mean(np.abs(im[0, :, :t] - ref[0, :, :t].imag.numpy())))
    n = min(len(rec), len(ref_rec))
    istft_err = float(np.mean(np.abs(rec[hop:n - hop] - ref_rec[hop:n - hop])))
    roundtrip_err = float(np.mean(np.abs(rec[hop:n - hop] - x[hop:n - hop])))
    return {"stft_mean_abs_err": stft_err,
            "istft_vs_torch_mean_abs_err": istft_err,
            "roundtrip_mean_abs_err": roundtrip_err}
