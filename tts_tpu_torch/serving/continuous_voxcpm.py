"""Slot-based continuous batching for the VoxCPM dual-LM decode
(counterpart of tts_tpu/serving/continuous_voxcpm.py).

A family adapter over serving/slots.SlotEngine. Each chunk step runs the
FULL generation step a row: the CFM feature decoder (st_star CFG over the
[pos | neg] feat_cond halves) -> the latent write -> the feature encoder ->
one dual-LM (base + FSQ + residual) step with per-row key masks, whose
layers take kernel 11 at 1-8 slots (the masks keep kernel 12 off).

Each slot draws its CFM noise from its OWN source, one (1, patch, latent)
draw a generated latent: a torch.Generator seeded from the request's seed,
on the params' device, or the draws the request brought (`submit(...,
noise=)`; tts_tpu's per-request jax.random chain cannot be reproduced in
torch, so the tests pass its draws). A request therefore gives the same
output whenever it is admitted and whichever rows share the batch, and
with the same draws passed its solo output (from a seed the solo decode
programs, runtime/voxcpm.py, draw their whole buffer at once, so one seed
gives the two paths other values).

Admission prefills ONE row at the batch's current shared position (rope is
relative, so the right-justified offset prefill decodes as a solo request
does), written in place into the batch's KV rows. The VAE is causal, so a
finished row's zero-masked latent buffer decodes to its solo samples.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kv.cache import KVCache
from ..models.voxcpm import cfm_feat_decoder_batch, feat_encoder_cond_batch, voxcpm_main_step
from ..runtime.streaming import ChunkedCodecStream
from .slots import SlotEngine, StreamHandle, stream_failure_hook

__all__ = ["VoxCPMSlotServer"]


class VoxCPMSlotServer(SlotEngine):
    """Continuous-batching server over a VoxCPMPipeline, on the device of
    its params.

    submit(prompt_ids, target_ids, prompt_audio=None) -> Future resolving
    to (int16 wav, n_latents).
    """

    def __init__(self, pipeline, *, slots: int = 4, chunk: int = 8,
                 prompt_bucket: int = 64, max_seq_len: int | None = None,
                 queue_limit: int = 256):
        self.pipe = pipeline
        self.cfg = cfg = pipeline.cfg
        self.dcfg = pipeline.dcfg
        self.sb = -(-prompt_bucket // 16) * 16
        self.fbuf = self.dcfg.max_latents
        kv_max = min(max_seq_len or cfg.base.max_seq_len, cfg.base.max_seq_len)
        kv_max = (kv_max // 128) * 128 or kv_max
        if self.sb + self.fbuf + chunk > kv_max:
            raise ValueError(f"kv budget {kv_max} too small for bucket {self.sb} + "
                             f"max_latents {self.fbuf} + chunk {chunk}")
        self.kv_max = kv_max
        self._slots = slots
        super().__init__(slots=slots, chunk=chunk, seq_limit=kv_max,
                         start_pos=self.sb, queue_limit=queue_limit,
                         name="voxcpm-slot-server", device=pipeline.device)

    # ------------------------------------------------------------- client

    def _plan(self, prompt_ids, target_ids, prompt_audio):
        """The v1.5 layout, [prompt_text | target_text | audio_start
        (| prompt feats)], as segments with its feat_cond and latent cap."""
        cfg, dcfg = self.cfg, self.dcfg
        flat = np.concatenate([prompt_ids[0], target_ids[0],
                               [cfg.audio_start_id]]).astype(np.int32)
        segments: list = [("text", flat)]
        fc = None
        if prompt_audio is not None and len(prompt_audio):
            _, fe, fc = self.pipe.encode_prompt(prompt_audio)
            segments.append(("audio", fe))
        cap = int(min(target_ids.shape[1] * dcfg.decode_limit_factor + 10, dcfg.max_latents))
        return segments, fc, cap

    def submit(self, prompt_ids: np.ndarray, target_ids: np.ndarray,
               prompt_audio: np.ndarray | None = None, seed: int | None = None,
               deadline_s: float | None = None, noise=None):
        """noise: this request's CFM draws, (steps, 1, patch, latent) or
        (steps, patch, latent), in place of its generator's."""
        segments, fc, cap = self._plan(prompt_ids, target_ids, prompt_audio)
        return self.submit_segments(segments, fc, cap, seed, deadline_s=deadline_s,
                                    noise=noise)

    def submit_stream(self, prompt_ids: np.ndarray, target_ids: np.ndarray,
                      prompt_audio: np.ndarray | None = None, seed: int | None = None,
                      window: int | None = None, left_context: int = 1,
                      noise=None) -> StreamHandle:
        """Streaming variant of submit(): a StreamHandle iterating int16
        chunks as chunk boundaries produce latents; concurrent streams share
        the slot batch. Each VAE window carries `left_context` latents
        already emitted, whose audio is discarded (the reference's
        pairwise overlap, VoxCPM/v1.5/Inference_VoxCPM_ONNX.py:511-523);
        by default a window is the server's chunk + 1."""
        segments, fc, cap = self._plan(prompt_ids, target_ids, prompt_audio)
        return self.submit_segments_stream(segments, fc, cap, seed, window=window,
                                           left_context=left_context, noise=noise)

    def submit_segments_stream(self, segments, feat_cond=None, max_latents: int | None = None,
                               seed: int | None = None, window: int | None = None,
                               left_context: int = 1, noise=None) -> StreamHandle:
        """Streaming submit_segments."""
        window = self.chunk + 1 if window is None else window
        if left_context >= window:
            raise ValueError(f"left_context {left_context} >= window {window}; raise window")
        handle = StreamHandle()
        fut = self.submit_segments(segments, feat_cond, max_latents, seed,
                                   _stream=(handle, window, left_context), noise=noise)
        stream_failure_hook(fut, handle)
        return handle

    def submit_segments(self, segments, feat_cond=None, max_latents: int | None = None,
                        seed: int | None = None, _stream=None,
                        deadline_s: float | None = None, noise=None):
        """A segmented prompt (the v2 modes' plan format,
        runtime/voxcpm._run_segments): ('text', ids (T,)) / ('audio',
        feat_embed (1, T, H)) in prompt order, with an optional CFG
        feat_cond (2, patch, est_H)."""
        cap = int(min(max_latents or self.dcfg.max_latents, self.dcfg.max_latents))
        return self._submit((self._payload(segments, feat_cond, seed, noise), _stream), cap,
                            deadline_s=deadline_s)

    def _payload(self, segments, feat_cond=None, seed: int | None = None, noise=None):
        """The host-side prompt a row is prefilled from: right-justified
        text ids, the audio-position mask, its left pad, the audio feats,
        the CFG feat_cond, and the noise source (the request's draws, or
        the seed of its generator, made at admission, so a request
        re-routed after a failure draws from its start)."""
        cfg = self.cfg
        total = sum(len(d) if kind == "text" else d.shape[1] for kind, d in segments)
        if total > self.sb:
            raise ValueError(f"prompt {total} > bucket {self.sb}")
        pad = self.sb - total
        text_buf = np.zeros((1, self.sb), np.int64)
        is_audio = np.zeros((1, self.sb), bool)
        fe_buf = np.zeros((1, self.sb, cfg.base.hidden_size), np.float32)
        p = pad
        for kind, data in segments:
            if kind == "text":
                n = len(data)
                text_buf[0, p:p + n] = data
            else:
                n = data.shape[1]
                fe_buf[0, p:p + n] = np.asarray(torch.as_tensor(data).float().cpu())[0]
                is_audio[0, p:p + n] = True
            p += n
        fc0 = np.zeros((2, cfg.patch_size, cfg.estimator.hidden_size), np.float32)
        if feat_cond is not None:
            fc0[:] = np.asarray(torch.as_tensor(feat_cond).float().cpu())
        if noise is not None:
            src = torch.as_tensor(noise).float().reshape(-1, cfg.patch_size,
                                                         cfg.vae.latent_dim)
        else:
            src = self.dcfg.seed if seed is None else seed
        return text_buf, is_audio, pad, fe_buf, fc0, src

    # ------------------------------------------------------ engine hooks

    def _fresh(self):
        bsz, cfg, dev, dt = self._slots, self.cfg, self.pipe.device, self.pipe.dtype
        b, r = cfg.base, cfg.residual

        def z():
            return torch.zeros((bsz,), dtype=torch.int32, device=dev)

        return {
            "base_kv": KVCache.create(b.num_layers, bsz, b.num_kv_heads, self.kv_max,
                                      b.head_dim, dt, dev),
            "res_kv": KVCache.create(r.num_layers, bsz, r.num_kv_heads, self.kv_max,
                                     r.head_dim, dt, dev),
            "dit": torch.zeros((bsz, 1, cfg.estimator.hidden_size), dtype=dt, device=dev),
            "feat_cond": torch.zeros((2 * bsz, cfg.patch_size, cfg.estimator.hidden_size),
                                     dtype=dt, device=dev),
            "latents": torch.zeros((bsz, self.fbuf, cfg.patch_size, cfg.vae.latent_dim),
                                   device=dev),
            "cnt": z(),
            "fin": torch.ones((bsz,), dtype=torch.bool, device=dev),
            "done": z(),
            "kvf": z(),                 # each row's first valid key
            "cap": z(),
            # per slot: [noise source (generator or draws), draws taken]
            "noise": [None] * bsz,
            "zero": torch.zeros((cfg.patch_size, cfg.vae.latent_dim), device=dev),
            "stream": [None] * bsz,     # {handle, codec, prev} per slot
        }

    def _draw(self, s, b: int) -> torch.Tensor:
        """Slot b's next CFM draw (patch, latent) on the device; empty slots
        draw zeros. A slot keeps drawing after its row finishes inside a
        chunk: those draws are never used."""
        src = s["noise"][b]
        if src is None:
            return s["zero"]
        gen, k = src
        src[1] = k + 1
        if isinstance(gen, torch.Generator):
            cfg = self.cfg
            return torch.randn((1, cfg.patch_size, cfg.vae.latent_dim), generator=gen,
                               device=self.pipe.device)[0]
        return gen[min(k, gen.shape[0] - 1)]

    def _step_chunk(self, s) -> None:
        cfg, params, pipe = self.cfg, self.pipe.params, self.pipe
        dt, fbuf = pipe.dtype, self.fbuf
        base_kv, res_kv, dit, feat_cond, latents, cnt, fin, done = (s[k] for k in (
            "base_kv", "res_kv", "dit", "feat_cond", "latents", "cnt", "fin", "done"))
        cap = s["cap"]
        kv_valid = torch.arange(self.kv_max, device=cnt.device)[None, :] >= s["kvf"][:, None]
        for _ in range(self.chunk):
            noise = torch.stack([self._draw(s, b) for b in range(self._slots)])
            latent = cfm_feat_decoder_batch(params, noise, dit, feat_cond, cfg)   # fp32
            cur = torch.clamp(cnt, max=fbuf - 1)[:, None, None, None].long().expand(
                -1, 1, cfg.patch_size, cfg.vae.latent_dim)
            latents.scatter_(1, cur, torch.where(fin[:, None, None, None],
                                                 latents.gather(1, cur), latent[:, None]))
            feat_embed, feat_cond = feat_encoder_cond_batch(params, latent.to(dt), cfg)
            h = feat_embed.to(dt) * (~fin)[:, None, None]
            dit, stop, base_kv, res_kv = voxcpm_main_step(
                params, h, h, 0, base_kv, res_kv, cfg, kv_valid=kv_valid, fused=pipe._fused)
            stop = stop.reshape(-1)
            newly = ((((stop == 1) & (cnt + 1 >= self.dcfg.min_latents)) | (cnt + 1 >= cap))
                     & ~fin)
            done = torch.where(newly, cnt + 1, done)
            cnt = torch.where(fin, cnt, cnt + 1)
            fin = fin | newly
        s.update(base_kv=base_kv, res_kv=res_kv, dit=dit, feat_cond=feat_cond, cnt=cnt,
                 fin=fin, done=done)

    def _admit_row(self, s, b: int, payload, cap: int) -> None:
        (text_buf, is_audio, pad, fe_buf, fc0, src), stream = payload
        if stream is not None:
            handle, window, left_context = stream
            s["stream"][b] = {
                "handle": handle, "prev": 0,
                "codec": ChunkedCodecStream(self.pipe._vae_dec_fn, window=window,
                                            left_context=left_context,
                                            upsample=self.cfg.samples_per_latent,
                                            num_groups=self.cfg.patch_size)}
        else:
            s["stream"][b] = None
        cfg, params, dev, dt = self.cfg, self.pipe.params, self.pipe.device, self.pipe.dtype
        pos, sb = s["pos"], self.sb
        fe = torch.from_numpy(fe_buf).to(dev, dt)
        audio = torch.from_numpy(is_audio).to(dev)
        valid = torch.arange(sb, device=dev)[None, :] >= pad
        h = torch.where(audio[..., None], fe, params["embed"][torch.from_numpy(text_buf).to(dev)])
        h = h * valid[..., None]
        bk, rk = s["base_kv"], s["res_kv"]
        rows = (KVCache(bk.k[:, b:b + 1], bk.v[:, b:b + 1], pos - sb),
                KVCache(rk.k[:, b:b + 1], rk.v[:, b:b + 1], pos - sb))
        kv_valid = torch.arange(self.kv_max, device=dev)[None, :] >= pos - sb + pad
        dit1, _, _, _ = voxcpm_main_step(params, h, fe, audio, *rows, cfg, kv_valid=kv_valid)
        s["base_kv"], s["res_kv"] = KVCache(bk.k, bk.v, pos), KVCache(rk.k, rk.v, pos)
        fc = torch.from_numpy(fc0).to(dev, dt)
        s["dit"][b] = dit1[0].to(dt)
        s["feat_cond"][b] = fc[0]                   # [pos rows | neg rows]
        s["feat_cond"][b + self._slots] = fc[1]
        s["latents"][b] = 0.0
        s["noise"][b] = [src.to(dev) if isinstance(src, torch.Tensor)
                         else self.pipe._get_key(src), 0]
        s["cnt"][b] = 0
        s["fin"][b] = False
        s["done"][b] = cap
        s["kvf"][b] = pos - (sb - pad)
        s["cap"][b] = cap

    def _push(self, s, st: dict, b: int, new: int) -> None:
        if new > st["prev"]:
            lats = s["latents"][b, st["prev"]:new].cpu().numpy()
            st["prev"] = new
            out = st["codec"].push_frames(lats)
            if out is not None and len(out):
                st["handle"]._put(out)

    def _post_chunk(self, s) -> None:
        if not any(st is not None for st in s["stream"]):
            return
        cnt = s["cnt"].cpu().numpy()          # one small fetch for all rows
        for b, st in enumerate(s["stream"]):
            if st is not None:
                self._push(s, st, b, int(cnt[b]))

    def _kill_row(self, s, slot: int) -> None:
        super()._kill_row(s, slot)
        s["noise"][slot] = None

    def _finalize(self, s, b: int, n: int):
        s["noise"][b] = None
        st = s["stream"][b]
        if st is not None:
            s["stream"][b] = None
            self._push(s, st, b, n)
            for out in st["codec"].finish():
                st["handle"]._put(out)
            st["handle"]._close(n)
            return None, n
        if n <= 0:
            return np.zeros(0, np.int16), 0
        live = (torch.arange(self.fbuf, device=self.pipe.device) < n)[:, None, None]
        wav = self.pipe._vocode((s["latents"][b] * live)[None])
        # at the pipeline's output rate, as its requests (streams stay native)
        return self.pipe._resampled(wav[0, :n * self.cfg.samples_per_latent]), n
