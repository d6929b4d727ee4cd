"""BigVGAN vocoder runtime: mel in, int16 waveform out, with a timing
benchmark (counterpart of tts_tpu/runtime/vocoder.py:BigVGANVocoder).

The generator runs eagerly on the device its params are on; AMPBlock1
stages take kernel 10 where its gate admits them. The int16 conversion
(x 32767, truncation) happens on the device, as in tts_tpu. tts_tpu's
staged half-programs are not ported: they split one XLA compile in two,
and eager PyTorch compiles nothing.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..models.bigvgan import BigVGANConfig, bigvgan_apply

__all__ = ["BigVGANVocoder"]


class BigVGANVocoder:
    """params: a BigVGAN params dict (tts_tpu's layout, e.g. from
    `weights.convert.params_from_jax` or `models.bigvgan.init_params`) on
    the device to run on; floats are cast to `dtype`. Kernel 10 takes the
    stages its gate admits in bf16 (C <= 256) and in fp32 (C <= 128: stages
    3-5 of bigvgan_v2_24khz_100band_256x)."""

    def __init__(self, params: dict, cfg: BigVGANConfig | None = None,
                 dtype=torch.bfloat16):
        self.cfg = cfg or BigVGANConfig()
        self.params = _cast(params, dtype)
        self.dtype = dtype
        self.device = self.params["conv_pre"]["w"].device

    @torch.no_grad()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, num_mels) on the device -> int16 (B, T * total_upsample)."""
        wav = bigvgan_apply(self.params, mel.to(self.dtype), self.cfg)
        return (wav.float() * 32767.0).to(torch.int16)

    def __call__(self, mel: np.ndarray) -> np.ndarray:
        """mel: (B, T, num_mels) or (T, num_mels) -> int16 (B, T*up)."""
        if mel.ndim == 2:
            mel = mel[None]
        return self.forward(torch.as_tensor(mel, device=self.device)).cpu().numpy()

    def benchmark(self, mel_frames: int = 512, iters: int = 50) -> dict:
        """The reference benchmark shape, mel (1, mel_frames, num_mels) of
        zeros (tts_tpu's): one warm-up call, then `iters` calls chained on
        the previous output, timed on the host to the last call's
        completion (a device synchronize). Returns wall seconds a call,
        samples, samples/s and the real-time factor."""
        mel = torch.zeros((1, mel_frames, self.cfg.num_mels), device=self.device)
        out = self.forward(mel)
        _sync(self.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = self.forward(mel + out.reshape(-1)[0].float() * 0.0)
        _sync(self.device)
        wall = (time.perf_counter() - t0) / iters
        n = out.shape[-1]
        audio_s = n / self.cfg.sample_rate
        return {"wall_s": wall, "samples": int(n), "samples_per_sec": n / wall,
                "rtf": wall / audio_s}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree
