"""ctypes bindings for the native host audio helpers (csrc/audio_io.c).

The C file is compiled at first use with the system C compiler (`cc`)
into `tts_tpu_torch/_build/native/`, under a name keyed by a hash of the
source. Every entry point has a numpy twin (`*_plain`), which it runs when
no compiler is found; the tests hold each helper against its twin. They
cover the host work around the device programs: PCM conversion,
resampling, downmix and loudness normalization.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["pcm16_to_f32", "f32_to_pcm16", "resample_linear", "downmix_to_mono",
           "rms_normalize", "native_available", "pcm16_to_f32_plain",
           "f32_to_pcm16_plain", "resample_linear_plain", "downmix_to_mono_plain",
           "rms_normalize_plain"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "audio_io.c"
BUILD_DIR = _PKG / "_build" / "native"

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Path:
    """Compile the source once per content into BUILD_DIR (an atomic
    rename, so processes building at once do not see a partial file)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"audio_io-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".audio_io-{digest}.{os.getpid()}.so"
        subprocess.run(["cc", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE), "-lm"],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.CalledProcessError):
            return None
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.pcm16_to_f32.argtypes = [i16p, f32p, ctypes.c_long]
        lib.f32_to_pcm16.argtypes = [f32p, i16p, ctypes.c_long]
        lib.resample_linear_f32.argtypes = [f32p, ctypes.c_long, f32p, ctypes.c_long]
        lib.downmix_i16.argtypes = [i16p, i16p, ctypes.c_long, ctypes.c_int]
        lib.rms_normalize_f32.argtypes = [f32p, ctypes.c_long, ctypes.c_float]
        lib.rms_normalize_f32.restype = ctypes.c_float
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def pcm16_to_f32_plain(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.int16).astype(np.float32) / 32768.0


def pcm16_to_f32(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.int16)
    lib = _load()
    if lib is None:
        return pcm16_to_f32_plain(x)
    out = np.empty(x.shape, np.float32)
    lib.pcm16_to_f32(x.reshape(-1), out.reshape(-1), x.size)
    return out


def f32_to_pcm16_plain(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    return np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)


def f32_to_pcm16(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    lib = _load()
    if lib is None:
        return f32_to_pcm16_plain(x)
    out = np.empty(x.shape, np.int16)
    lib.f32_to_pcm16(x.reshape(-1), out.reshape(-1), x.size)
    return out


def _resample_len(n: int, src_rate: int, dst_rate: int) -> int:
    return int(round(n * dst_rate / src_rate))


def resample_linear_plain(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    if src_rate == dst_rate:
        return np.asarray(x, np.float32)
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    xi = np.linspace(0.0, len(x) - 1, _resample_len(len(x), src_rate, dst_rate))
    return np.interp(xi, np.arange(len(x)), x).astype(np.float32)


def resample_linear(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """float32 mono linear resample (endpoint-aligned)."""
    if src_rate == dst_rate:
        return np.asarray(x, np.float32)
    lib = _load()
    if lib is None:
        return resample_linear_plain(x, src_rate, dst_rate)
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    out = np.empty(_resample_len(len(x), src_rate, dst_rate), np.float32)
    lib.resample_linear_f32(x, len(x), out, len(out))
    return out


def downmix_to_mono_plain(x: np.ndarray) -> np.ndarray:
    if x.ndim == 1:
        return np.asarray(x, np.int16)
    return np.ascontiguousarray(x, np.int16).mean(axis=1).astype(np.int16)


def downmix_to_mono(x: np.ndarray) -> np.ndarray:
    """(frames, channels) int16 -> (frames,) int16, the channels' mean
    truncated toward zero."""
    if x.ndim == 1:
        return np.asarray(x, np.int16)
    lib = _load()
    if lib is None:
        return downmix_to_mono_plain(x)
    x = np.ascontiguousarray(x, np.int16)
    out = np.empty(x.shape[0], np.int16)
    lib.downmix_i16(x.reshape(-1), out, x.shape[0], x.shape[1])
    return out


def rms_normalize_plain(x: np.ndarray, target_rms: float = 0.15) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32).copy()
    rms = float(np.sqrt(np.mean(x * x)))
    if rms > 1e-8:
        x *= target_rms / rms
    return x


def rms_normalize(x: np.ndarray, target_rms: float = 0.15) -> np.ndarray:
    """RMS normalization toward target_rms; returns the normalized copy."""
    lib = _load()
    if lib is None:
        return rms_normalize_plain(x, target_rms)
    x = np.ascontiguousarray(x, np.float32).copy()
    lib.rms_normalize_f32(x.reshape(-1), x.size, np.float32(target_rms))
    return x
