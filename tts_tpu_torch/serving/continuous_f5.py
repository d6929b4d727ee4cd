"""Slot-based continuous batching for the F5-TTS flow-matching decode
(counterpart of tts_tpu/serving/continuous_f5.py).

A diffusion model has no KV cache: each request is an independent Euler
integration of nfe_steps - 1 steps over its own latent. The slot batch
carries per-row (latent, cond, cond_drop, step, duration) state on the
device, and a chunk advances every live row by `chunk_steps` Euler steps
AT ITS OWN STEP: `models/f5.dit_forward` takes the (B,) step vector and
gathers each row's AdaLN vectors on the device, so a request admitted
mid-flight integrates the schedule it would solo. Per-row mods keep kernels
7 and 8 (one shared vector) off; kernels 3 and 6 take them as (2B, 3, D),
and kernel 1 masks each row at its own duration (an idle row at 0).

A chunk reads nothing from the card: the step vector, the finished flags
and the durations live there and change by index assignment; the one host
read is the flags between chunks (`_fin_done`). A finished row vocodes its
generated span through Vocos and its slot refills from the queue.

Same output as solo: a request's audio equals its solo `synthesize` when
the server's frame bucket is the bucket `_prepare` picks solo. The noise is
drawn at admission at (1, frames, n_mels) from a generator on the device
seeded with the request's seed (the solo pipeline's draw), or passed in
(`submit(..., noise=)`); per-row duration masks keep pad frames inert.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.f5 import dit_forward
from .slots import SlotEngine

__all__ = ["F5SlotServer"]


class F5SlotServer(SlotEngine):
    """Continuous-batching server over an F5Pipeline, on the device of its
    params.

    submit(ref_audio, ref_text, gen_text) -> Future resolving to (int16
    wav, n_samples)."""

    def __init__(self, pipeline, *, slots: int = 4, chunk_steps: int = 4,
                 frames: int = 1408, audio_bucket: int = 8 * 32768,
                 text_bucket: int = 128, gen_frames: int | None = None,
                 queue_limit: int = 256):
        self.pipe = pipeline
        self.cfg = pipeline.cfg
        self.frames = min(frames, self.cfg.max_signal_len)
        self.audio_bucket = audio_bucket
        self.text_bucket = text_bucket
        self.gen_frames = min(gen_frames or self.frames, self.frames)
        self._slots = slots
        # no shared position: admission never drains (a request's cap is
        # its NFE steps)
        super().__init__(slots=slots, chunk=chunk_steps, seq_limit=1 << 30, start_pos=0,
                         queue_limit=queue_limit, name="f5-slot-server",
                         device=pipeline.device)

    # ------------------------------------------------------------- client

    def submit(self, ref_audio: np.ndarray, ref_text: str, gen_text: str,
               speed: float = 1.0, seed: int | None = None,
               deadline_s: float | None = None, noise=None):
        """noise: this request's (1, frames, n_mels) start noise at the
        server's frame bucket, in place of its generator's draw."""
        payload = self._payload(ref_audio, ref_text, gen_text, speed, seed, noise)
        return self._submit(payload, self.cfg.nfe_steps, deadline_s=deadline_s)

    def _payload(self, ref_audio: np.ndarray, ref_text: str, gen_text: str,
                 speed: float = 1.0, seed: int | None = None, noise=None) -> tuple:
        """The host-side request a row is admitted from, padded to the
        server's buckets; a request past one of them is refused."""
        audio_p, ids_p, ref_signal_len, duration, _, n_keep = \
            self.pipe._prepare(ref_audio, ref_text, gen_text, speed)
        if audio_p.shape[1] > self.audio_bucket:
            raise ValueError(f"audio {audio_p.shape[1]} > bucket {self.audio_bucket}")
        if ids_p.shape[1] > self.text_bucket:
            raise ValueError(f"text {ids_p.shape[1]} > bucket {self.text_bucket}")
        if duration > self.frames:
            raise ValueError(f"duration {duration} > frame bucket {self.frames}")
        if duration - ref_signal_len - 1 > self.gen_frames:
            raise ValueError("generated span exceeds gen_frames bucket")
        if noise is not None and tuple(noise.shape) != (1, self.frames, self.cfg.n_mels):
            raise ValueError(f"noise {tuple(noise.shape)} != "
                             f"{(1, self.frames, self.cfg.n_mels)}")
        audio_p = np.pad(audio_p, ((0, 0), (0, self.audio_bucket - audio_p.shape[1])))
        ids_p = np.pad(ids_p, ((0, 0), (0, self.text_bucket - ids_p.shape[1])),
                       constant_values=-1)
        return (audio_p, ids_p, int(ref_signal_len), int(duration), int(n_keep),
                self.pipe.seed if seed is None else seed, noise)

    # ------------------------------------------------------ engine hooks

    def _fresh(self):
        bsz, cfg, dev, frames = self._slots, self.cfg, self.device, self.frames
        params = self.pipe.params
        cdt = params["proj_out"]["w"].dtype
        cw = cfg.n_mels + cfg.text_dim
        return {
            "x": torch.zeros((bsz, frames, cfg.n_mels), device=dev),
            "cat": torch.zeros((bsz, frames, cw), dtype=cdt, device=dev),
            "catd": torch.zeros((bsz, frames, cw), dtype=cdt, device=dev),
            # idle rows: at the last step, finished, no valid frame
            "tvec": torch.full((bsz,), cfg.nfe_steps - 1, dtype=torch.int32, device=dev),
            "fin": torch.ones((bsz,), dtype=torch.bool, device=dev),
            "dur": torch.zeros((bsz,), dtype=torch.int32, device=dev),
            "frame_idx": torch.arange(frames, device=dev)[None, :, None],
            "rope": (params["rope_cos"][:frames].float(), params["rope_sin"][:frames].float()),
            "ref": [0] * bsz,            # host: each row's ref_signal_len
            "keep": [0] * bsz,           # and its n_keep samples
        }

    def _fin_done(self, s):
        fin = s["fin"].cpu().numpy()
        return fin, np.zeros(self._slots, np.int64)

    def _admit_row(self, s, b: int, payload, cap: int) -> None:
        audio_p, ids_p, ref_len, duration, n_keep, seed, noise = payload
        pipe = self.pipe
        noise_t = pipe._noise((1, self.frames, self.cfg.n_mels), seed, noise)
        x1, cat1, catd1, _ = pipe._stage_a(audio_p, ids_p, ref_len, duration, self.frames,
                                           noise_t)
        s["x"][b] = x1[0]
        s["cat"][b] = cat1[0]
        s["catd"][b] = catd1[0]
        s["tvec"][b] = 0
        s["fin"][b] = False
        s["dur"][b] = duration
        s["ref"][b] = ref_len
        s["keep"][b] = n_keep

    def _step_chunk(self, s) -> None:
        cfg, params = self.cfg, self.pipe.params
        cdt = params["proj_out"]["w"].dtype
        nfe = cfg.nfe_steps
        x, tvec, fin, dur = s["x"], s["tvec"], s["fin"], s["dur"]
        cos, sin = s["rope"]
        in_len = (s["frame_idx"] < dur[:, None, None]).float()
        kv2 = torch.cat([dur, dur])
        for _ in range(self.chunk):
            idx = torch.clamp(tvec, max=nfe - 2).long()               # (B,)
            pred, pred1 = dit_forward(params, x.to(cdt), s["cat"], s["catd"], cos, sin,
                                      cfg, kv_len=kv2, step_idx=idx)
            update = (pred + (pred - pred1) * cfg.cfg_strength).float() \
                * params["delta_t"].index_select(0, idx)[:, None, None]
            act = (~fin).float()[:, None, None]
            x = (x + update * act) * in_len
            tvec = torch.where(fin, tvec, tvec + 1)
            # a finished (or killed) row stays finished
            fin = fin | (tvec >= nfe - 1)
        s.update(x=x, tvec=tvec, fin=fin)

    def _finalize(self, s, b: int, _n: int):
        ref, g = s["ref"][b], self.gen_frames
        gen = F.pad(s["x"][b:b + 1], (0, 0, 0, g))[:, ref:ref + g]
        pcm, _ = self.pipe._vocode(gen)
        wav = pcm.cpu().numpy().reshape(-1)[:s["keep"][b]]
        return wav, len(wav)
