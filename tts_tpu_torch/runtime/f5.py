"""F5-TTS synthesis pipeline: reference audio + text -> generated speech
(counterpart of tts_tpu/runtime/f5.py:F5Pipeline).

The same static buckets as tts_tpu (audio samples, text ids, mel frames,
generated frames) with validity carried by scalar lengths: mel frames >=
ref_signal_len are zeroed, attention keys >= duration are masked and the
Euler carry is re-zeroed there every step, and the vocoder runs on the
generated span only. The run is eager PyTorch: the 31-step NFE loop is a
Python loop whose kernels queue on the current CUDA stream; only the final
fetch waits for the device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.mel import MelSpectrogram
from ..frontend.f5_text import convert_char_to_pinyin, f5_duration, text_to_ids
from ..models.f5 import F5Model, dit_forward, text_embedding
from ..models.vocos import VocosModel, vocos_decode
from ..ops.quant_matmul import to_kmajor
from ..quant.weight_only import QTensor, quantize_int4, quantize_int8_eager

__all__ = ["F5Pipeline", "F5Stats", "quantize_dit"]


def _bucket(n: int, step: int, lo: int) -> int:
    return max(lo, -(-n // step) * step)


@dataclass
class F5Stats:
    wall_s: float
    audio_s: float
    # max |waveform| before the int16 clip; nan or inf if it was not finite
    peak: float = 0.0

    @property
    def rtf(self) -> float:
        return self.wall_s / max(self.audio_s, 1e-9)


def _on_card(params: dict) -> bool:
    """Whether the F5 params lie on a CUDA device."""
    return params["blocks"][0]["ff1"]["w"].device.type == "cuda"


def quantize_dit(params: dict, quantize) -> dict:
    """tts_tpu's F5Pipeline quantize modes over an F5 params dict: the DiT
    blocks' wqkv, wo, ff1 and ff2 weights become int8 QTensors (8 or
    "w8a8", the eager quantizer tts_tpu's pipeline calls) or int4 where the
    input dim is a multiple of 32 (4: the k_quant search, held in the
    unpacked QTensorG form, int8 for the rest). AdaLN, the convs and the
    vocoder stay float. Returns a new dict sharing the other tensors.

    On a card the int8 q of wqkv, ff1 and ff2 is stored K-major (still the
    (in, out) shape: `quant_matmul.to_kmajor`), the layout kernels 7 and 6
    read there; wo stays row-major for kernel 8."""
    if quantize not in (8, "w8a8", 4):
        raise ValueError(f"quantize must be None, 8, 'w8a8' or 4, got {quantize!r}")
    on_card = _on_card(params)

    def q(w, k_major: bool = False):
        if quantize == 4 and w.dim() == 2 and w.shape[0] % 32 == 0:
            return quantize_int4(w).unpack_runtime()
        qt = quantize_int8_eager(w)
        return QTensor(to_kmajor(qt.q), qt.scale) if k_major and on_card else qt

    blocks = [{**blk,
               "attn": {**blk["attn"], "wqkv": q(blk["attn"]["wqkv"], True),
                        "wo": q(blk["attn"]["wo"])},
               "ff1": {**blk["ff1"], "w": q(blk["ff1"]["w"], True)},
               "ff2": {**blk["ff2"], "w": q(blk["ff2"]["w"], True)}}
              for blk in params["blocks"]]
    return {**params, "blocks": blocks}


class F5Pipeline:
    """End-to-end F5-TTS over an F5Model and a VocosModel (random init for
    smoke runs). Runs on the device the models' tensors are on.

    quantize: None (float weights), 8 or "w8a8" (int8 DiT weights: every
    block takes the W8A8 kernels 6-8), or 4 (int4 DiT weights, the plain
    chain with a quantized dense); see `quantize_dit`."""

    def __init__(self, f5: F5Model, vocab: dict[str, int], vocos: VocosModel,
                 seed: int = 9527, allow_degraded_text: bool = False,
                 quantize: int | str | None = None):
        self.f5, self.vocos = f5, vocos
        # quantized weights are made once, on the model's device
        self._qparams = None if quantize is None else quantize_dit(f5.params, quantize)
        self.cfg, self.vcfg = f5.cfg, vocos.cfg
        self.vocab = vocab
        self.seed = seed
        self.allow_degraded_text = allow_degraded_text
        cfg = self.cfg
        self.melspec = MelSpectrogram(cfg.sample_rate, cfg.n_fft, cfg.hop,
                                      cfg.win_length, cfg.n_mels)

    @property
    def params(self) -> dict:
        """The F5 params the pipeline runs: the model's, or their quantized
        form."""
        return self.f5.params if self._qparams is None else self._qparams

    def _prepare(self, ref_audio: np.ndarray, ref_text: str, gen_text: str,
                 speed: float = 1.0):
        """Host-side prep: audio to int16, duration heuristic, tokenize,
        bucket, pad. Returns (audio_p, ids_p, ref_signal_len, duration,
        buckets, n_keep)."""
        cfg = self.cfg
        if ref_audio.dtype == np.int16:
            audio = ref_audio
        else:
            audio = np.clip(np.round(ref_audio.astype(np.float64) * 32768.0),
                            -32768, 32767).astype(np.int16)
        audio = audio.reshape(1, -1)
        ref_signal_len, duration = f5_duration(audio.shape[-1], ref_text, gen_text,
                                               cfg.hop, speed)
        duration = min(duration, cfg.max_signal_len)
        chars = convert_char_to_pinyin(
            [ref_text + gen_text], allow_degraded=self.allow_degraded_text)[0]
        ids = text_to_ids(chars, self.vocab)                        # (1, T)

        audio_bucket = _bucket(audio.shape[-1], 32768, 32768)
        text_bucket = _bucket(ids.shape[-1], 64, 64)
        frame_bucket = min(_bucket(duration, 128, 256), cfg.max_signal_len)
        audio_p = np.pad(audio, ((0, 0), (0, audio_bucket - audio.shape[-1])))
        # pad with -1: the +1 shift in text_embedding maps it to filler id 0
        ids_p = np.pad(ids, ((0, 0), (0, text_bucket - ids.shape[-1])),
                       constant_values=-1)
        gen_len = max(duration - ref_signal_len - 1, 0)
        gen_bucket = min(_bucket(gen_len, 64, 64), frame_bucket)
        buckets = (audio_bucket, text_bucket, frame_bucket, gen_bucket)
        return audio_p, ids_p, ref_signal_len, duration, buckets, gen_len * cfg.hop

    @torch.no_grad()
    def _dispatch(self, audio_p: np.ndarray, ids_p: np.ndarray,
                  ref_signal_len: int, duration: int, buckets,
                  seed: int | None = None, noise: np.ndarray | None = None):
        """Queue one synthesis without waiting: returns (int16 waveform
        (1, samples), peak |float waveform|), both on the device."""
        cfg = self.cfg
        params, vparams = self.params, self.vocos.params
        dev = params["proj_out"]["w"].device
        cdt = params["proj_out"]["w"].dtype       # compute dtype follows the weights
        frames, gen_frames = buckets[2], buckets[3]

        # preprocess: int16 PCM -> log-mel of the reference, zero past it
        audio = torch.from_numpy(audio_p).to(dev).float() * (1.0 / 32768.0)
        mel = self.melspec(audio)[:, :frames]                     # (1, Fa, M)
        mel = F.pad(mel, (0, 0, 0, frames - mel.shape[1]))
        frame_idx = torch.arange(frames, device=dev)[None, :, None]
        mel = torch.where(frame_idx < ref_signal_len, mel, 0.0)

        shape = (1, frames, cfg.n_mels)
        if noise is None:
            rng = torch.Generator(device=dev).manual_seed(
                self.seed if seed is None else seed)
            noise_t = torch.randn(shape, generator=rng, device=dev)
        else:
            if tuple(noise.shape) != shape:
                raise ValueError(f"noise {tuple(noise.shape)} != {shape}")
            noise_t = torch.from_numpy(np.array(noise, dtype=np.float32)).to(dev)
        in_len = (frame_idx < duration).float()                   # valid mask
        x = noise_t * in_len

        ids = torch.from_numpy(ids_p).to(dev)
        text, text_drop = text_embedding(params, ids, frames, cfg)
        cat = torch.cat([mel, text * in_len], dim=-1).to(cdt)
        cat_drop = torch.cat([torch.zeros_like(mel), text_drop * in_len],
                             dim=-1).to(cdt)

        # NFE loop: the Euler carry stays fp32
        rope_cos = params["rope_cos"][:frames].float()
        rope_sin = params["rope_sin"][:frames].float()
        kv_len = torch.full((2,), duration, dtype=torch.int32, device=dev)
        for idx in range(cfg.nfe_steps - 1):
            pred, pred1 = dit_forward(params, x.to(cdt), cat, cat_drop, rope_cos,
                                      rope_sin, cfg, kv_len=kv_len, step_idx=idx)
            update = (pred + (pred - pred1) * cfg.cfg_strength).float() \
                * params["delta_t"][idx]
            x = (x + update) * in_len

        # decode the generated span only
        gen = F.pad(x, (0, 0, 0, gen_frames))[:, ref_signal_len:ref_signal_len + gen_frames]
        wav = vocos_decode(vparams, gen, self.vcfg)
        pcm = (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
        return pcm, wav.abs().amax()

    def synthesize(self, ref_audio: np.ndarray, ref_text: str, gen_text: str,
                   speed: float = 1.0, seed: int | None = None,
                   noise: np.ndarray | None = None) -> tuple[np.ndarray, F5Stats]:
        """ref_audio: int16 or float mono waveform at cfg.sample_rate.
        noise: optional (1, frames, n_mels) start noise for the frame
        bucket, unmasked (the pipeline zeroes it past the duration); drawn on
        the device from a generator seeded with `seed` when absent.
        Returns (int16 waveform, stats)."""
        audio_p, ids_p, ref_signal_len, duration, buckets, n_keep = \
            self._prepare(ref_audio, ref_text, gen_text, speed)
        t0 = time.perf_counter()
        pcm, peak = self._dispatch(audio_p, ids_p, ref_signal_len, duration,
                                   buckets, seed, noise)
        out = pcm.cpu().numpy().reshape(-1)[:n_keep]
        wall = time.perf_counter() - t0
        # audio_s counts the samples returned: when the generated length
        # fills its bucket, the vocoder gives one hop fewer than n_keep
        return out, F5Stats(wall_s=wall, audio_s=len(out) / self.cfg.sample_rate,
                            peak=float(peak))

    def benchmark(self, ref_seconds: float = 6.0, gen_words: int = 15,
                  iters: int = 3) -> dict:
        """~6 s of reference audio and ~15 words, as tts_tpu's benchmark:
        single-request latency (prep, enqueue and the fetch that waits, per
        call) and sustained throughput (`iters` identical requests queued
        back to back, one wait at the end)."""
        rng = np.random.default_rng(0)
        n = int(ref_seconds * self.cfg.sample_rate)
        audio = (rng.standard_normal(n) * 3000).astype(np.int16)
        ref_text = "Some call me nature, others call me mother nature."
        gen_text = " ".join(["word"] * gen_words)
        wav, _ = self.synthesize(audio, ref_text, gen_text)        # warm-up
        audio_s = len(wav) / self.cfg.sample_rate

        prep_t = disp_t = fence_t = 0.0
        t0 = time.perf_counter()
        for _ in range(iters):
            ta = time.perf_counter()
            p = self._prepare(audio, ref_text, gen_text)
            tb = time.perf_counter()
            pcm, _ = self._dispatch(*p[:5])
            tc = time.perf_counter()
            pcm.cpu()
            td = time.perf_counter()
            prep_t += tb - ta
            disp_t += tc - tb
            fence_t += td - tc
        lat_wall = (time.perf_counter() - t0) / iters

        prep = self._prepare(audio, ref_text, gen_text)
        sus_wall = float("inf")
        for _ in range(2):      # best of 2
            t0 = time.perf_counter()
            outs = [self._dispatch(*prep[:5])[0] for _ in range(iters)]
            outs = [o.cpu().numpy() for o in outs]
            sus_wall = min(sus_wall, (time.perf_counter() - t0) / iters)
        np.testing.assert_array_equal(
            outs[0].reshape(-1)[: len(wav)], wav)    # exact-output guard

        # fixed per-request cost: the same enqueue + fetch round trip with a
        # trivial op over a buffer of the output's size
        dev_buf = self._dispatch(*prep[:5])[0]
        (dev_buf + 1).cpu()
        fixed_s = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(iters):
                (dev_buf + 1).cpu()
            fixed_s = min(fixed_s, (time.perf_counter() - t0) / iters)

        return {"wall_s": lat_wall, "audio_s": audio_s,
                "rtf": lat_wall / max(audio_s, 1e-9),
                "sustained_wall_s": sus_wall,
                "sustained_rtf": sus_wall / max(audio_s, 1e-9),
                "fixed_roundtrip_ms": fixed_s * 1e3,
                "compute_rtf": (lat_wall - fixed_s) / max(audio_s, 1e-9),
                "prep_ms": prep_t / iters * 1e3,
                "dispatch_ms": disp_t / iters * 1e3,
                "fence_ms": fence_t / iters * 1e3}
