"""Self-contained WAV I/O (counterpart of tts_tpu/audio/wav.py): RIFF chunk
parser + kaiser-sinc host resample.

Replaces the reference's pydub/soundfile dependency
(`F5_TTS/F5-TTS-ONNX-Inference.py:223,315`): the reference accepts whatever
ffmpeg can open and writes WAVEX via soundfile. Here the parser reads every
common WAV layout directly — PCM 8/16/24/32-bit, IEEE float32/float64, and
WAVE_FORMAT_EXTENSIBLE (WAVEX) wrappers of either — walking RIFF chunks so
LIST/fact/bext metadata is skipped. Compressed formats raise a clear error
naming ffmpeg. The framework's graph contract matches the reference's: all
pipelines take/emit int16 PCM (SURVEY.md §1 L4).

Host resampling defaults to a polyphase kaiser-windowed sinc (the same
filter design as `audio/filters.py` uses in-graph for BigVGAN's alias-free
activation); linear interpolation stays available for parity with the
reference's in-graph interpolate-resample (Qwen encoder :544-551).
"""
from __future__ import annotations

import math
import struct

import numpy as np
import torch

__all__ = ["read_audio", "read_wav", "write_wav", "resample_linear",
           "resample_kaiser", "to_pcm16"]

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _parse_riff(blob: bytes) -> tuple[dict, bytes]:
    """Walk RIFF/WAVE chunks -> (fmt fields, raw data bytes)."""
    if len(blob) < 12 or blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos, fmt, data = 12, None, None
    while pos + 8 <= len(blob):
        cid = blob[pos:pos + 4]
        (size,) = struct.unpack_from("<I", blob, pos + 4)
        body = blob[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            tag, ch, rate, _brate, _align, bits = struct.unpack_from(
                "<HHIIHH", body, 0)
            if tag == _WAVE_FORMAT_EXTENSIBLE:
                if len(body) < 40:
                    raise ValueError("truncated WAVEX fmt chunk")
                # cbSize(2) validBits(2) channelMask(4) then the subformat
                # GUID whose first two bytes are the real format tag
                (tag,) = struct.unpack_from("<H", body, 24)
            fmt = {"tag": tag, "channels": ch, "rate": rate, "bits": bits}
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)          # chunks are word-aligned
    if fmt is None or data is None:
        raise ValueError("WAV file missing fmt or data chunk")
    return fmt, data


def _decode_pcm(fmt: dict, raw: bytes) -> np.ndarray:
    """Raw data chunk -> int16 samples (interleaved channels preserved)."""
    tag, bits = fmt["tag"], fmt["bits"]
    if tag == _WAVE_FORMAT_IEEE_FLOAT:
        dt = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(raw[: len(raw) // dt().itemsize * dt().itemsize],
                          dtype=dt).astype(np.float32)
        return (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)
    if tag != _WAVE_FORMAT_PCM:
        raise ValueError(
            f"unsupported WAV format tag 0x{tag:04x}: only PCM and IEEE "
            "float are read natively — decode compressed audio to WAV "
            "first (e.g. `ffmpeg -i in.mp3 out.wav`)")
    if bits == 16:
        return np.frombuffer(raw[: len(raw) & ~1], dtype=np.int16)
    if bits == 8:                              # unsigned in WAV
        u = np.frombuffer(raw, dtype=np.uint8)
        return ((u.astype(np.int16) - 128) << 8)
    if bits == 24:
        b = np.frombuffer(raw[: len(raw) // 3 * 3], dtype=np.uint8)
        b = b.reshape(-1, 3)
        val = (b[:, 0].astype(np.int32)
               | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = (val ^ 0x800000) - 0x800000      # sign-extend 24 bits
        return (val >> 8).astype(np.int16)
    if bits == 32:
        return (np.frombuffer(raw[: len(raw) & ~3], dtype=np.int32)
                >> 16).astype(np.int16)
    raise ValueError(f"unsupported PCM bit depth {bits}")


def read_wav(path: str, target_rate: int | None = None,
             resample: str = "kaiser") -> tuple[np.ndarray, int]:
    """Read a WAV file -> (int16 mono samples, sample_rate).

    Handles PCM 8/16/24/32-bit, float32/float64, and WAVEX wrappers.
    Multi-channel audio is averaged to mono. If `target_rate` differs from
    the file rate the host resample runs: 'kaiser' (default, polyphase
    kaiser-sinc — the quality path) or 'linear' (parity with the
    reference's in-graph interpolate-resample)."""
    with open(path, "rb") as f:
        fmt, raw = _parse_riff(f.read())
    data = _decode_pcm(fmt, raw)
    rate = fmt["rate"]
    if fmt["channels"] > 1:
        from ..native import downmix_to_mono

        n = fmt["channels"]
        data = downmix_to_mono(data[: len(data) // n * n].reshape(-1, n))
    if target_rate is not None and target_rate != rate:
        if resample == "kaiser":
            data = resample_kaiser(data, rate, target_rate)
        else:
            data = resample_linear(data, rate, target_rate)
        rate = target_rate
    return data, rate


def read_audio(path: str, target_rate: int | None = None,
               resample: str = "kaiser") -> tuple[np.ndarray, int]:
    """Any-format audio load -> (int16 mono samples, sample_rate).

    The reference loads reference audio with pydub's any-format path
    (`F5_TTS/F5-TTS-ONNX-Inference.py:223`), which itself shells out to
    an ffmpeg binary for anything that is not WAV. Same contract here:
    RIFF/WAV decodes natively through read_wav; any other container
    (mp3/flac/ogg/m4a/...) decodes through `ffmpeg` on PATH — the same
    external dependency the reference has — and raises a clear error
    naming ffmpeg when the binary is absent."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"RIFF":
        return read_wav(path, target_rate, resample)
    return _read_via_ffmpeg(path, target_rate, resample)


def _read_via_ffmpeg(path: str, target_rate: int | None,
                     resample: str) -> tuple[np.ndarray, int]:
    import os
    import shutil
    import subprocess
    import tempfile

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"{path!r} is not a WAV file and no `ffmpeg` binary is on "
            "PATH to decode it. Install ffmpeg or convert first: "
            "`ffmpeg -i in.mp3 out.wav` (the reference's pydub loader "
            "has the same ffmpeg dependency for compressed formats)")
    fd, tmp = tempfile.mkstemp(suffix=".wav")
    os.close(fd)
    try:
        proc = subprocess.run(
            [ffmpeg, "-v", "error", "-y", "-i", path,
             "-acodec", "pcm_s16le", tmp],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"ffmpeg failed to decode {path!r}: {proc.stderr.strip()}")
        return read_wav(tmp, target_rate, resample)
    finally:
        os.unlink(tmp)


def resample_linear(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """int16 linear resample through the native helper (numpy twin without a C compiler)."""
    from ..native import f32_to_pcm16, pcm16_to_f32
    from ..native import resample_linear as native_resample

    return f32_to_pcm16(native_resample(pcm16_to_f32(x), src_rate, dst_rate))


def _kaiser_beta(att_db: float) -> float:
    if att_db > 50.0:
        return 0.1102 * (att_db - 8.7)
    if att_db >= 21.0:
        return 0.5842 * (att_db - 21.0) ** 0.4 + 0.07886 * (att_db - 21.0)
    return 0.0


def resample_kaiser(x: np.ndarray, src_rate: int, dst_rate: int,
                    taps: int = 32, att_db: float = 80.0) -> np.ndarray:
    """Polyphase kaiser-windowed-sinc resample (int16 in/out).

    Same filter family `audio/filters.kaiser_sinc_filter` builds for the
    in-graph alias-free resamplers, evaluated here as an (L, taps)
    continuous-phase bank: output n sits at input position n*M/L, phase
    p = (n*M) % L selects the fractional-delay row. Each row is
    DC-normalized so constants pass through exactly."""
    if src_rate == dst_rate or x.size == 0:
        return np.asarray(x, dtype=np.int16)
    g = math.gcd(int(src_rate), int(dst_rate))
    up, down = dst_rate // g, src_rate // g
    xf = x.astype(np.float32) / 32768.0

    # anti-alias cutoff in input-sample units: downsampling must stop at
    # the OUTPUT Nyquist (up/down of input Nyquist); upsampling at input's
    cutoff = 0.5 * min(1.0, up / down)
    beta = _kaiser_beta(att_db)
    half = taps // 2
    phases = np.arange(up, dtype=np.float64)[:, None] / up      # (L, 1)
    t = (np.arange(taps, dtype=np.float64) - (half - 1))[None, :] - phases
    win_arg = 1.0 - (t / half) ** 2
    window = np.where(win_arg > 0,
                      np.i0(beta * np.sqrt(np.clip(win_arg, 0, None))), 0.0)
    window /= np.i0(beta)
    bank = 2.0 * cutoff * np.sinc(2.0 * cutoff * t) * window     # (L, taps)
    bank /= bank.sum(axis=1, keepdims=True)                      # unit DC
    bank = bank.astype(np.float32)

    n_out = int(len(xf) * up) // down
    n = np.arange(n_out, dtype=np.int64)
    num = n * down
    base = num // up                          # integer input position
    p = (num % up).astype(np.int64)           # fractional phase row
    xpad = np.pad(xf, (half, taps))
    # gather (n_out, taps) windows; chunk to bound the temp buffer
    y = np.empty(n_out, dtype=np.float32)
    step = max(1, (1 << 22) // taps)
    for s in range(0, n_out, step):
        e = min(s + step, n_out)
        idx = base[s:e, None] + np.arange(taps)[None, :] + 1
        y[s:e] = np.einsum("nk,nk->n", xpad[idx], bank[p[s:e]])
    return (np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16)


def to_pcm16(scaled: torch.Tensor) -> torch.Tensor:
    """int16 of a waveform tensor already scaled by 32767: truncated toward
    zero and saturated at the int16 range, as XLA's convert (tts_tpu's
    `.astype(jnp.int16)`) does. In bf16, 32767 rounds to 32768, which a
    plain `.to(torch.int16)` wraps to -32768; the clamp runs in fp32, where
    every bf16 value is exact."""
    return scaled.float().clamp(-32768.0, 32767.0).to(torch.int16)


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write int16 mono PCM."""
    import wave

    samples = np.asarray(samples)
    if samples.dtype != np.int16:
        samples = np.clip(samples, -1.0, 1.0)
        samples = (samples * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(samples.reshape(-1).tobytes())
