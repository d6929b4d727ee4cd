"""F5-TTS synthesis pipeline: reference audio + text -> generated speech
(counterpart of tts_tpu/runtime/f5.py:F5Pipeline).

The same static buckets as tts_tpu (audio samples, text ids, mel frames,
generated frames) with validity carried by lengths: mel frames >=
ref_signal_len are zeroed, attention keys >= duration are masked and the
Euler carry is re-zeroed there every step, and the vocoder runs on the
generated span only. As tts_tpu builds one jitted program per bucket
(`_build`, `_get_fn`, `_fn_cache`; `_build_batch` for `synthesize_batch`),
the port builds one `runtime.program.Program` per bucket: mel -> text
embedding -> the 31-step NFE loop -> Vocos -> int16, with ref_signal_len
and duration as (B,) tensors on the device, so every request of a bucket
runs one program. On a card it is a CUDA graph, captured at the bucket's
first request and replayed for every later one; on the CPU its body runs
eagerly. The start noise is drawn outside the program and copied in.
A graph reads the weights it was captured on: replacing `f5` or `vocos`, or
moving or casting their tensors, drops the programs (`_programs`).
"""
from __future__ import annotations

import functools
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.mel import MelSpectrogram
from ..audio.wav import to_pcm16
from ..frontend.f5_text import convert_char_to_pinyin, f5_duration, text_to_ids
from ..models.f5 import F5Model, dit_forward, dit_forward_cached, text_embedding
from ..models.vocos import VocosModel, vocos_decode
from ..ops.quant_matmul import to_kmajor
from ..quant.weight_only import QTensor, quantize_int4, quantize_int8_eager
from .program import GraphPool, Program, weights_key

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

    On a card the int8 q of wqkv, wo, ff1 and ff2 is stored K-major (still
    the (in, out) shape: `quant_matmul.to_kmajor`), the layout kernels 7, 8
    and 6 read there."""
    if quantize not in (8, "w8a8", 4):
        raise ValueError(f"quantize must be None, 8, 'w8a8' or 4, got {quantize!r}")
    on_card = _on_card(params)

    def q(w):
        if quantize == 4 and w.dim() == 2 and w.shape[0] % 32 == 0:
            return quantize_int4(w).unpack_runtime()
        qt = quantize_int8_eager(w)
        return QTensor(to_kmajor(qt.q), qt.scale) if on_card else qt

    blocks = [{**blk,
               "attn": {**blk["attn"], "wqkv": q(blk["attn"]["wqkv"]),
                        "wo": q(blk["attn"]["wo"])},
               "ff1": {**blk["ff1"], "w": q(blk["ff1"]["w"])},
               "ff2": {**blk["ff2"], "w": q(blk["ff2"]["w"])}}
              for blk in params["blocks"]]
    return {**params, "blocks": blocks}


class F5Pipeline:
    """End-to-end F5-TTS over an F5Model and a VocosModel (random init for
    smoke runs). Runs on the device the models' tensors are on.

    quantize: None (float weights), 8 or "w8a8" (int8 DiT weights: every
    block takes the W8A8 kernels 6-8), or 4 (int4 DiT weights, the plain
    chain with a quantized dense); see `quantize_dit`.

    layer_cache_interval: K > 1 runs the full DiT every K-th Euler step only
    and reuses each block's attention and FF outputs between (tts_tpu's
    FORA layer cache, `models/f5.dit_forward_cached`; `synthesize` only).

    Many requests: `synthesize_batch` (one CFG batch of 2B rows), or a slot
    server over the pipeline (`serving/continuous_f5.F5SlotServer`)."""

    def __init__(self, f5: F5Model, vocab: dict[str, int], vocos: VocosModel,
                 seed: int = 9527, allow_degraded_text: bool = False,
                 quantize: int | str | None = None, layer_cache_interval: int = 1):
        # one program per bucket, keyed as tts_tpu's: (audio, text, frames,
        # generated frames) for a request, (batch, ...) for a batch; on a
        # card their graphs share one memory pool
        self._fn_cache: dict = {}
        self._pool = GraphPool()
        self._weights = None
        self._quantize = quantize
        self.f5, self.vocos = f5, vocos
        self.cfg, self.vcfg = f5.cfg, vocos.cfg
        self.vocab = vocab
        self.seed = seed
        self.allow_degraded_text = allow_degraded_text
        cfg = self.cfg
        self.melspec = MelSpectrogram(cfg.sample_rate, cfg.n_fft, cfg.hop,
                                      cfg.win_length, cfg.n_mels)
        self.layer_cache_interval = layer_cache_interval

    @property
    def f5(self) -> F5Model:
        """The F5 model (of the pipeline's config). Setting it drops the
        programs built so far and, with `quantize`, quantizes its weights
        anew, once, on its device."""
        return self._f5

    @f5.setter
    def f5(self, model: F5Model) -> None:
        self._f5 = model
        self._qparams = None if self._quantize is None else quantize_dit(model.params,
                                                                         self._quantize)
        self._fn_cache.clear()

    @property
    def vocos(self) -> VocosModel:
        """The Vocos model. Setting it drops the programs built so far."""
        return self._vocos

    @vocos.setter
    def vocos(self, model: VocosModel) -> None:
        self._vocos = model
        self._fn_cache.clear()

    def _programs(self) -> dict:
        """`_fn_cache`, emptied first where a tensor its programs read was
        replaced, moved or cast since they were built (`weights_key`)."""
        key = weights_key(self.params, self.vocos.params)
        if key != self._weights:
            self._fn_cache.clear()
            self._weights = key
        return self._fn_cache

    @property
    def layer_cache_interval(self) -> int:
        """The FORA layer cache (tts_tpu's): the attention and FF outputs
        are recomputed every K-th Euler step only and re-modulated between;
        K = 1 is the exact loop. A program is built for one K: setting it
        drops the programs built so far."""
        return self._layer_cache_interval

    @layer_cache_interval.setter
    def layer_cache_interval(self, k: int) -> None:
        self._layer_cache_interval = max(1, int(k))
        self._fn_cache.clear()

    @property
    def params(self) -> dict:
        """The F5 params the pipeline runs: the model's, or their quantized
        form."""
        return self.f5.params if self._qparams is None else self._qparams

    @property
    def device(self) -> torch.device:
        """The device the F5 params lie on, where the pipeline runs."""
        return self.params["proj_out"]["w"].device

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

    def _noise(self, shape: tuple, seed: int | None, noise) -> torch.Tensor:
        """Start noise of `shape` on the device: `noise` (unmasked, as a
        numpy array or tensor) where given, else a draw from a generator on
        the device seeded with `seed` (the pipeline's seed when None)."""
        dev = self.device
        if noise is None:
            rng = torch.Generator(device=dev).manual_seed(self.seed if seed is None else seed)
            return torch.randn(shape, generator=rng, device=dev)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise {tuple(noise.shape)} != {shape}")
        return torch.as_tensor(np.array(noise, dtype=np.float32)).to(dev)

    def _stage_a(self, audio_p, ids_p, ref_signal_len, duration,
                 frames: int, noise_t: torch.Tensor):
        """Preprocess B padded requests at a frame bucket: int16 PCM ->
        log-mel of the reference, zero from ref_signal_len on; the text
        embedding; the noise zeroed from duration on. audio_p and ids_p:
        arrays or tensors; ref_signal_len and duration: ints (B = 1) or (B,)
        integer tensors on the device. Returns (x (B, frames, n_mels) fp32,
        cat, cat_drop in the compute dtype, the (B, frames, 1) valid
        mask)."""
        cfg, params = self.cfg, self.params
        dev = self.device
        cdt = params["proj_out"]["w"].dtype       # compute dtype follows the weights

        def lim(v):
            return v.reshape(-1, 1, 1) if isinstance(v, torch.Tensor) else v

        audio = torch.as_tensor(audio_p, device=dev).float() * (1.0 / 32768.0)
        mel = self.melspec(audio)[:, :frames]                     # (B, Fa, M)
        mel = F.pad(mel, (0, 0, 0, frames - mel.shape[1]))
        frame_idx = torch.arange(frames, device=dev)[None, :, None]
        mel = torch.where(frame_idx < lim(ref_signal_len), mel, 0.0)
        in_len = (frame_idx < lim(duration)).float()              # valid mask
        x = noise_t * in_len

        ids = torch.as_tensor(ids_p, device=dev)
        text, text_drop = text_embedding(params, ids, frames, cfg)
        cat = torch.cat([mel, text * in_len], dim=-1).to(cdt)
        cat_drop = torch.cat([torch.zeros_like(mel), text_drop * in_len], dim=-1).to(cdt)
        return x, cat, cat_drop, in_len

    def _euler(self, x: torch.Tensor, cat: torch.Tensor, cat_drop: torch.Tensor,
               in_len: torch.Tensor, kv_len: torch.Tensor, frames: int,
               k: int = 1) -> torch.Tensor:
        """The NFE loop over a CFG batch: nfe_steps - 1 Euler steps, the
        carry fp32, re-zeroed past each row's duration. With a layer cache
        interval k > 1, steps whose index is not a multiple of k reuse the
        last full step's attention and FF outputs (`dit_forward_cached`),
        branched on the host by the step index (fixed in a captured graph,
        as tts_tpu's `lax.cond` schedule in its program)."""
        cfg, params = self.cfg, self.params
        cdt = params["proj_out"]["w"].dtype
        rope_cos = params["rope_cos"][:frames].float()
        rope_sin = params["rope_sin"][:frames].float()
        cache = None
        for idx in range(cfg.nfe_steps - 1):
            if k == 1:
                pred, pred1 = dit_forward(params, x.to(cdt), cat, cat_drop, rope_cos,
                                          rope_sin, cfg, kv_len=kv_len, step_idx=idx)
            else:
                pred, pred1, cache = dit_forward_cached(
                    params, x.to(cdt), cat, cat_drop, rope_cos, rope_sin, cfg, kv_len,
                    cache, use_cache=idx % k != 0, step_idx=idx)
            update = (pred + (pred - pred1) * cfg.cfg_strength).float() \
                * params["delta_t"][idx]
            x = (x + update) * in_len
        return x

    def _vocode(self, gen: torch.Tensor):
        """Vocos over (B, frames, n_mels) -> (int16 waveforms (B, samples),
        peak |float waveform|), both on the device."""
        wav = vocos_decode(self.vocos.params, gen, self.vcfg)
        pcm = to_pcm16(torch.clamp(wav, -1.0, 1.0) * 32767.0)
        return pcm, wav.abs().amax()

    def _run(self, audio: torch.Tensor, ids: torch.Tensor, ref: torch.Tensor,
             dur: torch.Tensor, noise: torch.Tensor, *, frames: int, gen_frames: int,
             k: int) -> tuple:
        """A bucket's program body over B padded requests: int16 PCM (B,
        audio bucket) and text ids (B, text bucket), ref_signal_len (B,)
        int64 and duration (B,) int32 on the device, the unmasked start
        noise (B, frames, n_mels) -> (int16 waveforms (B, samples), peak
        |float waveform|). kv_len is cat([dur, dur]) and each row's
        generated span is gathered from its own ref_signal_len, so the
        lengths are data, not part of the program."""
        cfg = self.cfg
        x, cat, cat_drop, in_len = self._stage_a(audio, ids, ref, dur, frames, noise)
        x = self._euler(x, cat, cat_drop, in_len, torch.cat([dur, dur]), frames, k)
        # each row's generated span, from its own ref_signal_len
        pos = ref[:, None] + torch.arange(gen_frames, device=x.device)[None, :]   # (B, G)
        gen = torch.gather(F.pad(x, (0, 0, 0, gen_frames)), 1,
                           pos[..., None].expand(-1, -1, cfg.n_mels))
        return self._vocode(gen)

    def _program(self, bsz: int, audio_len: int, text_len: int, frames: int,
                 gen_frames: int, k: int) -> Program:
        body = functools.partial(self._run, frames=frames, gen_frames=gen_frames, k=k)
        return Program(body, [((bsz, audio_len), torch.int16), ((bsz, text_len), torch.int32),
                              ((bsz,), torch.int64), ((bsz,), torch.int32),
                              ((bsz, frames, self.cfg.n_mels), torch.float32)],
                       self.device, self._pool)

    def _build(self, audio_len: int, text_len: int, frames: int, gen_frames: int) -> Program:
        """One request's program at a bucket (tts_tpu's `_build`), with the
        pipeline's layer cache interval."""
        return self._program(1, audio_len, text_len, frames, gen_frames,
                             self.layer_cache_interval)

    def _get_fn(self, audio_len: int, text_len: int, frames: int, gen_frames: int) -> Program:
        key, cache = (audio_len, text_len, frames, gen_frames), self._programs()
        if key not in cache:
            cache.setdefault(key, self._build(*key))
        return cache[key]

    def _build_batch(self, bsz: int, audio_len: int, text_len: int, frames: int,
                     gen_frames: int) -> Program:
        """A batch's program (tts_tpu's `_build_batch`): B requests in one
        CFG batch of 2B rows, the exact DiT only."""
        return self._program(bsz, audio_len, text_len, frames, gen_frames, 1)

    def _get_batch_fn(self, bsz: int, audio_len: int, text_len: int, frames: int,
                      gen_frames: int) -> Program:
        key, cache = (bsz, audio_len, text_len, frames, gen_frames), self._programs()
        if key not in cache:
            cache.setdefault(key, self._build_batch(*key))
        return cache[key]

    def _inputs(self, audio_p: np.ndarray, ids_p: np.ndarray, refs, durs, frames: int,
                seed: int | None, noise) -> tuple:
        """A program's inputs for B prepared requests: host tensors of the
        padded audio, ids and lengths, and the start noise (drawn on the
        device where `noise` is None)."""
        bsz = audio_p.shape[0]
        return (torch.from_numpy(audio_p), torch.from_numpy(ids_p),
                torch.tensor(refs, dtype=torch.int64), torch.tensor(durs, dtype=torch.int32),
                self._noise((bsz, frames, self.cfg.n_mels), seed, noise))

    def _dispatch(self, audio_p: np.ndarray, ids_p: np.ndarray,
                  ref_signal_len: int, duration: int, buckets,
                  seed: int | None = None, noise: np.ndarray | None = None):
        """Queue one synthesis through its bucket's program without
        waiting: returns (int16 waveform (1, samples), peak |float
        waveform|), both on the device."""
        return self._get_fn(*buckets)(*self._inputs(audio_p, ids_p, [ref_signal_len],
                                                    [duration], buckets[2], seed, noise))

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

    def _prepare_batch(self, requests: list, speed: float = 1.0):
        """Host prep of B (ref_audio, ref_text, gen_text) requests, each as
        `_prepare` does it, padded to the batch's largest buckets (each
        bucket grows with its length, so these are the buckets of the
        batch maximum). Returns (audio_p (B, A) int16, ids_p (B, L), refs,
        durs, gens (lists of ints), frame bucket, gen bucket)."""
        preps = [self._prepare(*r, speed) for r in requests]
        audio_b, text_b, frames, gen_frames = (max(p[4][i] for p in preps) for i in range(4))
        audio_p = np.concatenate([np.pad(p[0], ((0, 0), (0, audio_b - p[0].shape[1])))
                                  for p in preps])
        ids_p = np.concatenate([np.pad(p[1], ((0, 0), (0, text_b - p[1].shape[1])),
                                       constant_values=-1) for p in preps])
        return (audio_p, ids_p, [p[2] for p in preps], [p[3] for p in preps],
                [p[5] // self.cfg.hop for p in preps], frames, gen_frames)

    @torch.no_grad()
    def synthesize_batch(self, requests: list, speed: float = 1.0, seed: int | None = None,
                         noise: np.ndarray | None = None) -> tuple[list, F5Stats]:
        """B (ref_audio, ref_text, gen_text) requests in one CFG batch of 2B
        rows (tts_tpu's batched serving), through the program of (B, the
        buckets). Shapes bucket on the batch maximum;
        each row's ref_signal_len and duration ride as (B,) vectors on the
        device (kv_len = cat([dur, dur])). noise: optional (B, frames,
        n_mels) start noise, else one draw of that shape from a generator
        seeded with `seed`. Returns (int16 waveforms, each cut to its own
        generated length, stats with audio_s summed over the batch: RTF here
        is throughput, not one request's latency).

        The FORA layer cache does not apply here (the exact DiT only)."""
        if self.layer_cache_interval > 1:
            warnings.warn("synthesize_batch always runs the exact DiT; "
                          "layer_cache_interval is ignored", stacklevel=2)
        cfg = self.cfg
        audio_p, ids_p, refs, durs, gens, frames, gen_frames = \
            self._prepare_batch(requests, speed)
        bsz = len(requests)
        t0 = time.perf_counter()
        fn = self._get_batch_fn(bsz, audio_p.shape[1], ids_p.shape[1], frames, gen_frames)
        pcm, peak = fn(*self._inputs(audio_p, ids_p, refs, durs, frames, seed, noise))
        wav = pcm.cpu().numpy()
        wall = time.perf_counter() - t0
        outs = [wav[b, :gens[b] * cfg.hop] for b in range(bsz)]
        return outs, F5Stats(wall_s=wall, audio_s=sum(len(o) for o in outs) / cfg.sample_rate,
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
            queued = [self._dispatch(*prep[:5])[0] for _ in range(iters)]
            outs = [o.cpu().numpy() for o in queued]
            sus_wall = min(sus_wall, (time.perf_counter() - t0) / iters)
        # exact-output guard: every queued output, each in a buffer of its own
        if len({o.data_ptr() for o in queued}) != iters:
            raise AssertionError("queued dispatches returned a shared output buffer")
        for o in outs:
            np.testing.assert_array_equal(o.reshape(-1)[: len(wav)], wav)

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
