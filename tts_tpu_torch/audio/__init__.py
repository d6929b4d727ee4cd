"""DSP and audio I/O: windows, STFT/ISTFT, log-mel, snake and WAV I/O
(tts_tpu/audio counterparts)."""
from .mel import MelSpectrogram, mel_filterbank
from .snake import snake, snake_beta
from .stft import IstftKernel, StftKernel
from .wav import read_audio, read_wav, resample_kaiser, resample_linear, write_wav
from .windows import make_window, padded_window

__all__ = [
    "MelSpectrogram", "mel_filterbank", "snake", "snake_beta",
    "IstftKernel", "StftKernel",
    "read_audio", "read_wav", "resample_kaiser", "resample_linear",
    "write_wav", "make_window", "padded_window",
]
