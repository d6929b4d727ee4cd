"""VoxCPM-1.5 / VoxCPM-2 synthesis: prompt audio + text ids -> speech
(counterpart of tts_tpu/runtime/voxcpm.py:VoxCPMPipeline, without
`synthesize_streaming`, int4, `mesh` and resampling to
another output rate, which are not ported yet).

A request: one dual-LM prefill over the prompt bucket (64 positions at a
time; a per-position kind mask marks the text tokens and the audio
patches, so one pass serves v1.5's [text | audio_start | prompt feats] and
every v2 mode), the caches rewound to the true length; then a Python loop,
one latent a step: the CFM feature decoder makes a latent patch from fresh
noise, the feature encoder re-encodes it, the dual LM takes one step
(kernel 12 on each of its layers at B = 1). The host reads the stop flag
once a latent from min_latents on. Then one VAE decode of the latent buffer, zero past the
generated latents (the VAE is causal, so the kept samples equal a compact
decode's), to int16.

The batched form right-justifies B prompts in one bucket with per-row key
validity, and tracks each row's cap and stop; its steps take kernel 11.

The CFM noise: a latent step draws (B, patch, latent) from a
torch.Generator seeded from `seed` on the params' device; a `noise`
argument of (steps, B, patch, latent) replaces the draws (tts_tpu's
jax.random stream cannot be reproduced in torch, so tests pass its draws).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..kv.cache import KVCache
from ..models.voxcpm import (VoxCPMConfig, cfm_feat_decoder, cfm_feat_decoder_batch,
                             feat_encoder_cond, feat_encoder_cond_batch, vae_decode,
                             vae_encode, voxcpm_main_step)

__all__ = ["VoxCPMPipeline", "VoxCPMDecodeConfig", "MAX_PREFILL_TOKENS",
           "MAX_PROMPT_FEATS"]

MAX_PREFILL_TOKENS = 256   # text tokens incl. audio_start
MAX_PROMPT_FEATS = 256     # prompt audio patches


@dataclass(frozen=True)
class VoxCPMDecodeConfig:
    max_latents: int = 256
    decode_limit_factor: int = 8       # limit = text_len * factor + 10
    min_latents: int = 2               # latents before a stop is honoured
    seed: int = 9527
    # retry with the next seed when generation hits the length cap without a
    # stop (the upstream bad-case retry)
    retry_badcase: int = 0
    # decode routes of models/voxcpm.llama_stack_step. None = "step" (kernel
    # 12) on every device; True = the qkv head (kernel 11); False = plain
    # ops. "step" degrades per call where its gate fails (batch rows).
    fused_decode: bool | str | None = None


class VoxCPMPipeline:
    """VoxCPM over the LM params dict and the VAE params dict (tts_tpu's
    layouts, e.g. from `weights.convert.params_from_jax` or the models'
    init functions). Runs on the device the params are on."""

    def __init__(self, params: dict, cfg: VoxCPMConfig, vae_params: dict,
                 decode_cfg: VoxCPMDecodeConfig | None = None,
                 output_sample_rate: int | None = None, quantize: int | None = None):
        if quantize not in (None, 8):
            raise ValueError(f"quantize must be None or 8, got {quantize!r}")
        if output_sample_rate not in (None, cfg.output_sample_rate):
            raise ValueError(f"output_sample_rate {output_sample_rate}: resampling from the "
                             f"native {cfg.output_sample_rate} Hz is not ported")
        if quantize:
            # int8 on the LM, feature-encoder and estimator matmuls; the VAE
            # stays float
            from ..quant.weight_only import quantize_pytree

            params = quantize_pytree(params, bits=quantize)
        self.params = params
        self.cfg = cfg
        self.vae_params = vae_params
        self.dcfg = decode_cfg or VoxCPMDecodeConfig()
        fd = self.dcfg.fused_decode
        self._fused = "step" if fd is None else fd
        self.output_sample_rate = cfg.output_sample_rate
        self.device = params["embed"].device
        self.dtype = params["embed"].dtype
        sr = cfg.vae.sr_bins
        self._sr_idx = int(np.searchsorted(np.asarray(sr), cfg.output_sample_rate)) if sr else 0

    # ------------------------------------------------------------- prompt

    def encode_prompt(self, audio: np.ndarray):
        """audio: int16 or float mono at cfg.sample_rate. Returns (the latent
        patches (T, patch, latent), feat_embed (1, T, base_H), feat_cond (2,
        patch, est_H)) on the device. The audio is left-padded to a patch
        multiple, given one trailing zero patch and zero-padded to a multiple
        of 8 patches, as tts_tpu buckets it; every patch of the bucket is
        kept."""
        cfg = self.cfg
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        patch_len = cfg.patch_size * cfg.chunk_size
        pad = patch_len - (len(audio) % patch_len)
        audio = np.concatenate([np.zeros(pad, np.float32), audio.astype(np.float32),
                                np.zeros(patch_len, np.float32)])
        bucket = -(-len(audio) // (patch_len * 8)) * (patch_len * 8)
        audio = np.pad(audio, (0, bucket - len(audio)))[None]
        lat = vae_encode(self.vae_params, torch.as_tensor(audio, device=self.device),
                         cfg.vae)
        t = lat.shape[1] // cfg.patch_size
        feats = lat[0, :t * cfg.patch_size].reshape(t, cfg.patch_size, -1).to(self.dtype)
        feat_embed, feat_cond = feat_encoder_cond(self.params, feats, cfg)
        return feats, feat_embed, feat_cond

    def _zero_cond(self) -> torch.Tensor:
        return torch.zeros((2, self.cfg.patch_size, self.cfg.estimator.hidden_size),
                           dtype=self.dtype, device=self.device)

    def _caches(self, bsz: int, kv_max: int) -> tuple[KVCache, KVCache]:
        b, r = self.cfg.base, self.cfg.residual
        return (KVCache.create(b.num_layers, bsz, b.num_kv_heads, kv_max, b.head_dim,
                               self.dtype, self.device),
                KVCache.create(r.num_layers, bsz, r.num_kv_heads, kv_max, r.head_dim,
                               self.dtype, self.device))

    def _noise(self, noise, step: int, gen: torch.Generator, bsz: int) -> torch.Tensor:
        if noise is not None:
            return noise[step].to(self.device, torch.float32)
        cfg = self.cfg
        return torch.randn((bsz, cfg.patch_size, cfg.vae.latent_dim), generator=gen,
                           device=self.device)

    def _get_key(self, seed: int) -> torch.Generator:
        """A request's CFM noise source: a fresh generator seeded from
        `seed` on the params' device, the one the decode loops draw from."""
        return torch.Generator(self.device).manual_seed(seed)

    def _vae_dec_fn(self, latents: np.ndarray) -> torch.Tensor:
        """A streaming window of latents (1, W, patch, latent) -> int16 (1,
        W * samples_per_latent) on the device (its host copy comes later)."""
        flat = torch.as_tensor(latents, dtype=torch.float32, device=self.device)
        flat = flat.reshape(1, -1, self.cfg.vae.latent_dim)
        wav = vae_decode(self.vae_params["dec"], flat, self.cfg.vae, sr_idx=self._sr_idx)
        return (wav * 32767.0).to(torch.int16)

    def _vocode(self, latents: torch.Tensor) -> np.ndarray:
        """(B, buf, patch, latent) -> int16 (B, buf * samples_per_latent)."""
        cfg = self.cfg
        flat = latents.reshape(latents.shape[0], -1, cfg.vae.latent_dim)
        wav = vae_decode(self.vae_params["dec"], flat, cfg.vae, sr_idx=self._sr_idx)
        return (wav * 32767.0).to(torch.int16).cpu().numpy()

    # ------------------------------------------------------------- decode

    def _decode(self, text_buf, is_audio, prefill_len: int, fe_buf, feat_cond,
                max_steps: int, buf: int, seed: int, noise=None):
        """The prefill, the generation loop and the VAE decode of one
        request. Returns (int16 (1, buf * samples_per_latent), latents)."""
        cfg, dcfg, params = self.cfg, self.dcfg, self.params
        dt = self.dtype
        fe_buf, feat_cond = fe_buf.to(dt), feat_cond.to(dt)
        # the cache holds the prefill bucket and the latent cap
        kv_max = min(cfg.base.max_seq_len, -(-(text_buf.shape[1] + buf + 1) // 128) * 128)
        base_kv, res_kv = self._caches(1, kv_max)
        h = torch.where(is_audio[None, :, None], fe_buf, params["embed"][text_buf.long()])
        dit, _, base_kv, res_kv = voxcpm_main_step(
            params, h, fe_buf, is_audio, base_kv, res_kv, cfg, valid_len=prefill_len)
        base_kv, res_kv = base_kv.rewind(prefill_len), res_kv.rewind(prefill_len)

        gen = self._get_key(seed)
        latents = torch.zeros((1, buf, cfg.patch_size, cfg.vae.latent_dim),
                              device=self.device)
        num, fin = 0, False
        while not fin and num < min(max_steps, buf):
            latent = cfm_feat_decoder(params, self._noise(noise, num, gen, 1), dit,
                                      feat_cond, cfg)
            latents[0, num] = latent[0]
            feat_embed, feat_cond = feat_encoder_cond(params, latent.to(dt), cfg)
            h = feat_embed[:, :1]
            dit, stop, base_kv, res_kv = voxcpm_main_step(
                params, h, h, 0, base_kv, res_kv, cfg, fused=self._fused)
            num += 1
            # a stop is honoured only after min_latents
            fin = num >= dcfg.min_latents and bool(stop == 1)
        return self._vocode(latents), num

    def _run_segments(self, segments, feat_cond, max_steps: int, seed: int | None,
                      noise=None) -> tuple[np.ndarray, dict]:
        """segments: ('text', ids (T,)) / ('audio', feat_embed (1, T, H)) in
        prompt order. Runs the prefill, the generation and the VAE decode."""
        cfg, dcfg = self.cfg, self.dcfg
        cap = MAX_PREFILL_TOKENS + MAX_PROMPT_FEATS
        pos = sum(len(d) if kind == "text" else d.shape[1] for kind, d in segments)
        if pos > cap:
            raise ValueError(f"prompt too long: {pos} > {cap}")
        s_buf = min(cap, max(64, -(-pos // 64) * 64))
        text_buf = np.zeros((1, s_buf), np.int32)
        is_audio = torch.zeros((s_buf,), dtype=torch.bool, device=self.device)
        fe_buf = torch.zeros((1, s_buf, cfg.base.hidden_size), device=self.device)
        p = 0
        for kind, data in segments:
            if kind == "text":
                n = len(data)
                text_buf[0, p:p + n] = data
            else:
                n = data.shape[1]
                fe_buf[:, p:p + n] = data
                is_audio[p:p + n] = True
            p += n
        text_buf = torch.as_tensor(text_buf, device=self.device)
        # the latent buffer: 32-latent granularity, capped at max_latents
        buf = min(dcfg.max_latents, max(32, -(-max_steps // 32) * 32))
        base_seed = dcfg.seed if seed is None else seed

        t0 = time.perf_counter()
        for attempt in range(dcfg.retry_badcase + 1):
            wav, num = self._decode(text_buf, is_audio, pos, fe_buf, feat_cond, max_steps,
                                    buf, base_seed + attempt, noise)
            if num < min(max_steps, buf):
                break                       # stopped by itself
        n_samples = num * cfg.samples_per_latent
        wall = time.perf_counter() - t0
        return wav[0, :n_samples], {"latents": num, "wall_s": wall,
                                    "sample_rate": self.output_sample_rate,
                                    "rtf": wall / max(n_samples / self.output_sample_rate,
                                                      1e-9)}

    # -------------------------------------------------------------- public

    def synthesize_ids(self, prompt_ids: np.ndarray, target_ids: np.ndarray,
                       prompt_audio: np.ndarray | None = None, seed: int | None = None,
                       noise: torch.Tensor | None = None) -> tuple[np.ndarray, dict]:
        """The v1.5 layout: [prompt_text | target_text | audio_start | prompt
        feats]. Returns (int16 waveform, stats)."""
        cfg, dcfg = self.cfg, self.dcfg
        segments: list = [("text", np.concatenate(
            [prompt_ids[0], target_ids[0], [cfg.audio_start_id]]).astype(np.int32))]
        if prompt_audio is not None and len(prompt_audio) > 0:
            _, feat_embed, feat_cond = self.encode_prompt(prompt_audio)
            segments.append(("audio", feat_embed))
        else:
            feat_cond = self._zero_cond()
        max_steps = target_ids.shape[1] * dcfg.decode_limit_factor + 10
        return self._run_segments(segments, feat_cond, max_steps, seed, noise)

    def _v2_plan(self, mode: str, target_ids: np.ndarray, ref_audio=None, prompt_audio=None,
                 prompt_ids=None, ref_start_id: int = 103, ref_end_id: int = 104):
        """The VoxCPM-2 modes' segments and feat_cond (None: zeros):
          voice_design   - the text only;
          reference_only - [ref_start | ref feats | ref_end | text];
          continuation   - [prompt text + target text | prompt feats];
          combined       - [ref_start | ref feats | ref_end | text | prompt feats]."""
        target = target_ids[0].astype(np.int32)
        rs = ("text", np.array([ref_start_id], np.int32))
        re_ = ("text", np.array([ref_end_id], np.int32))
        if mode == "voice_design":
            return [("text", target)], None
        if mode == "reference_only":
            if ref_audio is None:
                raise ValueError("reference_only needs ref_audio")
            return [rs, ("audio", self.encode_prompt(ref_audio)[1]), re_,
                    ("text", target)], None
        if mode == "continuation" and (prompt_audio is None or prompt_ids is None):
            raise ValueError("continuation needs prompt_audio and prompt_ids")
        if mode == "combined" and (ref_audio is None or prompt_audio is None
                                   or prompt_ids is None):
            raise ValueError("combined needs ref_audio, prompt_audio and prompt_ids")
        if mode in ("continuation", "combined"):
            _, p_fe, p_fc = self.encode_prompt(prompt_audio)
            text = ("text", np.concatenate([prompt_ids[0].astype(np.int32), target]))
            if mode == "continuation":
                return [text, ("audio", p_fe)], p_fc
            ref_fe = self.encode_prompt(ref_audio)[1]
            return [rs, ("audio", ref_fe), re_, text, ("audio", p_fe)], p_fc
        raise ValueError(f"unknown mode {mode!r}")

    def synthesize_v2(self, mode: str, target_ids: np.ndarray,
                      ref_audio: np.ndarray | None = None,
                      prompt_audio: np.ndarray | None = None,
                      prompt_ids: np.ndarray | None = None, ref_start_id: int = 103,
                      ref_end_id: int = 104, seed: int | None = None,
                      noise: torch.Tensor | None = None) -> tuple[np.ndarray, dict]:
        """The VoxCPM-2 prompt modes (see `_v2_plan`). Returns (int16
        waveform, stats)."""
        segments, feat_cond = self._v2_plan(mode, target_ids, ref_audio, prompt_audio,
                                            prompt_ids, ref_start_id, ref_end_id)
        if feat_cond is None:
            feat_cond = self._zero_cond()
        max_steps = target_ids.shape[1] * self.dcfg.decode_limit_factor + 10
        return self._run_segments(segments, feat_cond, max_steps, seed, noise)

    # ------------------------------------------------------------- batched

    def _decode_batch(self, text_buf, is_audio, pad_start, fe_buf, feat_cond0, caps,
                      buf: int, seed: int, noise=None):
        """Batched prefill and generation, then one batched VAE decode with
        each row's latents zeroed past its stop. Returns (int16 (B, buf *
        samples_per_latent), latents a row)."""
        cfg, dcfg, params = self.cfg, self.dcfg, self.params
        dt, dev = self.dtype, self.device
        bsz, s_buf = text_buf.shape
        fe_buf, feat_cond = fe_buf.to(dt), feat_cond0.to(dt)
        kv_max = min(cfg.base.max_seq_len, -(-(s_buf + buf + 1) // 128) * 128)
        base_kv, res_kv = self._caches(bsz, kv_max)
        valid = torch.arange(s_buf, device=dev)[None, :] >= pad_start[:, None]
        kv_valid = torch.arange(kv_max, device=dev)[None, :] >= pad_start[:, None]
        h = torch.where(is_audio[..., None], fe_buf, params["embed"][text_buf.long()])
        h = h * valid[..., None]
        dit, _, base_kv, res_kv = voxcpm_main_step(params, h, fe_buf, is_audio, base_kv,
                                                   res_kv, cfg, kv_valid=kv_valid)

        gen = self._get_key(seed)
        latents = torch.zeros((bsz, buf, cfg.patch_size, cfg.vae.latent_dim), device=dev)
        fin = torch.zeros((bsz,), dtype=torch.bool, device=dev)
        done = torch.full((bsz,), buf, dtype=torch.int32, device=dev)
        num = 0
        while num < buf:
            latent = cfm_feat_decoder_batch(params, self._noise(noise, num, gen, bsz), dit,
                                            feat_cond, cfg)
            latents[:, num] = latent
            feat_embed, feat_cond = feat_encoder_cond_batch(params, latent.to(dt), cfg)
            dit, stop, base_kv, res_kv = voxcpm_main_step(
                params, feat_embed, feat_embed, 0, base_kv, res_kv, cfg, kv_valid=kv_valid,
                fused=self._fused)
            num += 1
            newly = (((stop == 1) & (num >= dcfg.min_latents)) | (num >= caps)) & ~fin
            done = torch.where(newly, num, done)
            fin = fin | newly
            if bool(fin.all()):
                break
        done = torch.clamp(done, max=num)
        # rows that finished early kept generating with the batch: zero their
        # tail, as a compact decode of each row would see it
        live = torch.arange(buf, device=dev)[None, :] < done[:, None]
        return self._vocode(latents * live[..., None, None]), done.cpu().tolist()

    def _run_segments_batch(self, plans, seed: int | None, noise=None):
        """plans: per row (segments, feat_cond (2, P, H) | None, cap). Rows are
        right-justified in one bucket; the per-position kind mask and the
        per-row key validity give each row its single-request layout.
        Returns (wavs, stats, counts, caps)."""
        cfg, dcfg, dev = self.cfg, self.dcfg, self.device
        bsz = len(plans)
        totals = [sum(len(d) if kind == "text" else d.shape[1] for kind, d in segments)
                  for segments, _, _ in plans]
        s_buf = max(16, -(-max(totals) // 16) * 16)
        text_buf = np.zeros((bsz, s_buf), np.int32)
        pad_start = np.zeros((bsz,), np.int32)
        caps = np.zeros((bsz,), np.int32)
        is_audio = torch.zeros((bsz, s_buf), dtype=torch.bool, device=dev)
        fe_buf = torch.zeros((bsz, s_buf, cfg.base.hidden_size), device=dev)
        feat_cond0 = torch.zeros((2 * bsz, cfg.patch_size, cfg.estimator.hidden_size),
                                 device=dev)
        for bi, ((segments, fc, cap), total) in enumerate(zip(plans, totals)):
            pos = s_buf - total
            pad_start[bi], caps[bi] = pos, cap
            for kind, data in segments:
                if kind == "text":
                    text_buf[bi, pos:pos + len(data)] = data
                    pos += len(data)
                else:
                    n = data.shape[1]
                    fe_buf[bi, pos:pos + n] = data[0]
                    is_audio[bi, pos:pos + n] = True
                    pos += n
            if fc is not None:
                feat_cond0[bi], feat_cond0[bsz + bi] = fc[0], fc[1]   # pos, neg rows
        # the latent buffer: the loop cannot pass max(caps)
        buf = min(dcfg.max_latents, max(32, -(-int(caps.max()) // 32) * 32))

        t0 = time.perf_counter()
        wav, counts = self._decode_batch(
            torch.as_tensor(text_buf, device=dev), is_audio,
            torch.as_tensor(pad_start, device=dev), fe_buf, feat_cond0,
            torch.as_tensor(caps, device=dev), buf,
            dcfg.seed if seed is None else seed, noise)
        spl = cfg.samples_per_latent
        wavs = [wav[bi, :counts[bi] * spl] for bi in range(bsz)]
        wall = time.perf_counter() - t0
        audio_s = sum(len(w) for w in wavs) / self.output_sample_rate
        stats = {"latents": sum(counts), "wall_s": wall, "audio_s": audio_s,
                 "rtf": wall / max(audio_s, 1e-9)}
        return wavs, stats, counts, [int(c) for c in caps]

    def synthesize_ids_batch(self, requests: list[tuple[np.ndarray, np.ndarray]],
                             prompt_audios: list[np.ndarray | None] | None = None,
                             seed: int | None = None, noise: torch.Tensor | None = None
                             ) -> tuple[list[np.ndarray], dict]:
        """B (prompt_ids, target_ids) requests, each optionally with its
        prompt audio (the v1.5 layout), decoded together. Returns (int16
        waveforms, aggregate stats)."""
        cfg, dcfg = self.cfg, self.dcfg
        prompt_audios = prompt_audios or [None] * len(requests)
        plans = []
        for (prompt_ids, target_ids), pa in zip(requests, prompt_audios):
            segments: list = [("text", np.concatenate(
                [prompt_ids[0], target_ids[0], [cfg.audio_start_id]]).astype(np.int32))]
            fc = None
            if pa is not None and len(pa) > 0:
                _, fe, fc = self.encode_prompt(pa)
                segments.append(("audio", fe))
            cap = min(target_ids.shape[1] * dcfg.decode_limit_factor + 10, dcfg.max_latents)
            plans.append((segments, fc, cap))
        wavs, stats, counts, caps = self._run_segments_batch(plans, seed, noise)
        # rows that hit their cap without a stop run again on the single
        # path, which owns the bad-case retry
        if dcfg.retry_badcase > 0:
            for bi, (c, cap) in enumerate(zip(counts, caps)):
                if c >= cap:
                    wavs[bi], _ = self.synthesize_ids(*requests[bi], prompt_audios[bi],
                                                      seed=seed)
        return wavs, stats

    def synthesize_v2_batch(self, requests: list[dict], seed: int | None = None,
                            noise: torch.Tensor | None = None
                            ) -> tuple[list[np.ndarray], dict]:
        """Batched VoxCPM-2: each request a dict of synthesize_v2's keywords
        (mode, target_ids, ref_audio, prompt_audio, prompt_ids, ref_start_id,
        ref_end_id); rows may mix modes."""
        dcfg = self.dcfg
        plans = []
        for req in requests:
            segments, fc = self._v2_plan(**req)
            cap = min(req["target_ids"].shape[1] * dcfg.decode_limit_factor + 10,
                      dcfg.max_latents)
            plans.append((segments, fc, cap))
        wavs, stats, counts, caps = self._run_segments_batch(plans, seed, noise)
        if dcfg.retry_badcase > 0:
            for bi, (c, cap) in enumerate(zip(counts, caps)):
                if c >= cap:
                    wavs[bi], _ = self.synthesize_v2(seed=seed, **requests[bi])
        return wavs, stats
