"""Stage timing, RTF reporting, and profiler hooks.

The reference reports per-stage timings and token-rate/RTF tables with raw
prints (Qwen_TTS/Export_Qwen_TTS_ONNX.py:2769-2804,
Kani_TTS/Inference_Kani_TTS_ONNX.py:356, IndexTTS/Export_IndexTTS.py:1208).
This module provides the same observability with structured records plus an
optional `torch.profiler` trace context for device-level analysis (a copy of
tts_tpu/utils/timing.py, whose trace wraps `jax.profiler`).
"""
from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field

__all__ = ["StageTimer", "SynthesisReport", "trace_profile"]

log = logging.getLogger("tts_tpu_torch")


class StageTimer:
    """Accumulates named wall-clock spans.

    with timer.span("talker"):
        ...  # call torch.cuda.synchronize() inside for honest device timing
    """

    def __init__(self):
        self.spans: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def as_dict(self) -> dict[str, float]:
        return dict(self.spans)


@dataclass
class SynthesisReport:
    """Per-utterance stats record — the structured analog of the
    reference's RTF tables."""

    family: str
    audio_seconds: float
    wall_seconds: float
    tokens: int = 0
    stages: dict = field(default_factory=dict)

    @property
    def rtf(self) -> float:
        return self.wall_seconds / max(self.audio_seconds, 1e-9)

    @property
    def tokens_per_second(self) -> float:
        return self.tokens / max(self.wall_seconds, 1e-9)

    def table(self) -> str:
        lines = [
            f"{'family':<12} {self.family}",
            f"{'audio_s':<12} {self.audio_seconds:.3f}",
            f"{'wall_s':<12} {self.wall_seconds:.3f}",
            f"{'RTF':<12} {self.rtf:.4f}",
        ]
        if self.tokens:
            lines.append(f"{'tokens/s':<12} {self.tokens_per_second:.1f}")
        for k, v in self.stages.items():
            lines.append(f"  {k:<10} {v * 1000:.1f} ms")
        return "\n".join(lines)

    def json(self) -> str:
        return json.dumps({
            "family": self.family,
            "audio_s": round(self.audio_seconds, 4),
            "wall_s": round(self.wall_seconds, 4),
            "rtf": round(self.rtf, 5),
            "tokens": self.tokens,
            "stages_ms": {k: round(v * 1000, 2) for k, v in self.stages.items()},
        })

    def log(self, level: int = logging.INFO) -> None:
        log.log(level, self.json())


@contextlib.contextmanager
def trace_profile(log_dir: str | None):
    """Optional torch.profiler trace of the host and, where a card is
    present, its kernels; a chrome trace (view in Perfetto or
    chrome://tracing) is written into log_dir on exit. No-op when log_dir
    is None."""
    if log_dir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
