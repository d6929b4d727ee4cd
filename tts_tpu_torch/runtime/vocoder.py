"""BigVGAN vocoder runtime: mel in, int16 waveform out, with a timing
benchmark (counterpart of tts_tpu/runtime/vocoder.py:BigVGANVocoder).

The generator runs on the device its params are on; AMPBlock1 stages take
kernel 10 where its gate admits them. The int16 conversion (x 32767,
truncation, saturation) happens on the device, as in tts_tpu. As tts_tpu
jits the whole generator into one program, the port builds one
`runtime.program.Program` per mel shape (B, T): on a card a CUDA graph,
captured at the first call of the shape and replayed for every later one;
on the CPU its body runs eagerly. tts_tpu's staged half-programs are not
ported: they split one XLA compile in two, which a capture does not need.
A graph reads the weights it was captured on: setting `params`, or moving or
casting a tensor of them, drops the programs.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..audio.wav import to_pcm16
from ..models.bigvgan import BigVGANConfig, bigvgan_apply
from .program import GraphPool, Program, weights_key

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
        self.dtype = dtype
        # one program per mel shape (B, T); on a card their graphs share one
        # memory pool
        self._fn_cache: dict = {}
        self._pool = GraphPool()
        self._weights = None
        self.params = params

    @property
    def params(self) -> dict:
        """The generator's params, in the vocoder's dtype. Setting them
        (cast to it) drops the programs built so far; `device` follows."""
        return self._params

    @params.setter
    def params(self, params: dict) -> None:
        self._params = _cast(params, self.dtype)
        self.device = self._params["conv_pre"]["w"].device
        self._fn_cache.clear()

    def _run(self, mel: torch.Tensor) -> tuple:
        """The program's body: mel (B, T, num_mels) in the vocoder's dtype ->
        (int16 (B, T * total_upsample),)."""
        wav = bigvgan_apply(self.params, mel, self.cfg)
        return (to_pcm16(wav.float() * 32767.0),)

    def _get_fn(self, bsz: int, frames: int) -> Program:
        key, wkey = (bsz, frames), weights_key(self.params)
        if wkey != self._weights:
            # a tensor of the params was replaced, moved or cast in place
            self._fn_cache.clear()
            self._weights = wkey
        if key not in self._fn_cache:
            self._fn_cache.setdefault(key, Program(
                self._run, [((bsz, frames, self.cfg.num_mels), self.dtype)], self.device,
                self._pool))
        return self._fn_cache[key]

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, num_mels) on the host or the device -> int16 (B, T *
        total_upsample) on the device, through the program of (B, T); mel
        is cast to the vocoder's dtype on its way in."""
        return self._get_fn(mel.shape[0], mel.shape[1])(mel)[0]

    def __call__(self, mel: np.ndarray) -> np.ndarray:
        """mel: (B, T, num_mels) or (T, num_mels) -> int16 (B, T*up)."""
        if mel.ndim == 2:
            mel = mel[None]
        return self.forward(torch.as_tensor(mel)).cpu().numpy()

    def benchmark(self, mel_frames: int = 512, iters: int = 50) -> dict:
        """The reference benchmark shape, mel (1, mel_frames, num_mels) of
        zeros (tts_tpu's): one warm-up call, then `iters` calls chained on
        the previous output (each call's mel reaches its program by a copy
        into the static mel buffer), timed on the host to the last call's
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
