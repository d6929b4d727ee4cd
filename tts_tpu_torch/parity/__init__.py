"""Parity harness (counterpart of tts_tpu/parity): the mel-L1 metric and
the STFT check (`compare`), per-stage session drivers (`sessions`), the
ONNX-oracle runner (`run_reference`) and stand-in sessions built from the
port's own stage functions (`standins`)."""
from .compare import mel_l1, stft_diff_report, wav_mel_l1

__all__ = ["mel_l1", "wav_mel_l1", "stft_diff_report"]
