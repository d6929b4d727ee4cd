"""Streaming synthesis: windowed codec decodes assembled into audio
(counterpart of tts_tpu/runtime/streaming.py).

The AR loop runs in chunks; each finished window of codec frames is decoded
on the device, and its audio is copied to the host one window LATE, so the
decode of a window runs while the next AR chunk is enqueued. The window
carries `left_context` frames already emitted, whose audio is discarded
(the reference's chunked_decode overlap, Export_Qwen_TTS_ONNX.py:2706-2726).
"""
from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

__all__ = ["ChunkedCodecStream"]


class ChunkedCodecStream:
    """Assembles streaming codec windows into audio.

    decode_fn(codes (1, W, G...) numpy) -> int16 (1, W * upsample), a device
    tensor (or an array): the codec decode at the fixed window size. The
    stream is pipelined one window deep: `push_frames` launches the new
    window's decode and only then copies the previous window's audio to the
    host, so the copy waits on the previous decode alone.
    """

    def __init__(self, decode_fn: Callable, window: int, left_context: int,
                 upsample: int, num_groups: int):
        self.decode_fn = decode_fn
        self.window = window
        self.left_context = left_context
        self.upsample = upsample
        self.num_groups = num_groups
        self._codes: list[np.ndarray] = []       # frames, (G...) each
        self._decoded = 0                         # frames whose decode started
        self._pending = None                      # (device wav, ctx, n_new)

    def _ready(self, final: bool) -> bool:
        avail = len(self._codes) - self._decoded
        step = self.window - self.left_context
        return avail > 0 and (final or avail >= step)

    def _dispatch(self) -> None:
        start = max(self._decoded - self.left_context, 0)
        ctx = self._decoded - start
        chunk = np.asarray(self._codes[start:start + self.window])
        avail = len(self._codes) - self._decoded
        n_new = min(len(chunk) - ctx, avail)
        if len(chunk) < self.window:              # pad the tail window
            pad = np.repeat(chunk[-1:], self.window - len(chunk), axis=0)
            chunk = np.concatenate([chunk, pad], axis=0)
        self._pending = (self.decode_fn(chunk[None]), ctx, n_new)
        self._decoded += n_new

    def _to_host(self, pending) -> np.ndarray | None:
        if pending is None:
            return None
        dev, ctx, n_new = pending
        wav = dev.cpu().numpy() if hasattr(dev, "cpu") else np.asarray(dev)   # the sync
        wav = wav.reshape(-1)[ctx * self.upsample:(ctx + n_new) * self.upsample]
        return wav.astype(np.int16)

    def _advance(self) -> np.ndarray | None:
        """Launch the next window's decode, then fetch the previous one."""
        prev = self._pending
        self._dispatch()
        return self._to_host(prev)

    def push_frames(self, frames: np.ndarray) -> np.ndarray | None:
        """frames: (N, G...) new codec frames. Launches a decode when a
        window completes and returns the previous window's audio (one-deep
        pipeline), else None."""
        self._codes.extend(list(frames))
        if not self._ready(final=False):
            return None
        return self._advance()

    def finish(self) -> Iterator[np.ndarray]:
        """Flush the remaining frames and drain the pipeline."""
        while self._ready(final=True):
            out = self._advance()
            if out is not None and len(out):
                yield out
        out = self._to_host(self._pending)
        self._pending = None
        if out is not None and len(out):
            yield out
