"""VoxCPM-1.5 / VoxCPM-2 synthesis: prompt audio + text ids -> speech
(counterpart of tts_tpu/runtime/voxcpm.py:VoxCPMPipeline, without `mesh`,
which is not ported yet).

A request: one dual-LM prefill over the prompt bucket (64 positions at a
time; a per-position kind mask marks the text tokens and the audio
patches, so one pass serves v1.5's [text | audio_start | prompt feats] and
every v2 mode), the caches rewound to the true length; then one latent a
step: the CFM feature decoder makes a latent patch from the request's
noise, the feature encoder re-encodes it, the dual LM takes one step
(kernel 12 on each of its layers at B = 1); then one VAE decode of the
latent buffer, zero past the generated latents (the VAE is causal, so the
kept samples equal a compact decode's), to int16. The batched form
right-justifies B prompts in one bucket with per-row key validity, and
tracks each row's cap and stop; its steps take kernel 11.

tts_tpu jits each stage; the port runs each as a `runtime.program.Program`
under tts_tpu's key (on a card a CUDA graph on the pipeline's `GraphPool`,
captured at its first call and replayed; on the CPU its body runs eagerly
on the same state):
  1. encode (`_enc_cache[bucket]`): vae_encode, the patch reshape and
     feat_encoder_cond over the prompt audio of its bucket (a multiple of 8
     patches); the padding and the bucketing stay on the host;
  2. decode (`_dec_cache[(s_buf, buf)]` for a request, `_batch_fns[("batch",
     B, s_buf, buf)]` for a batch): a `_Decode`, a prefill and a step
     program over a state on the device (both KV caches with their length
     as a device int32 over kv_max rows, dit_hidden, feat_cond, the latent
     buffer, the request's CFM noise, the count, the flags). tts_tpu keys
     its request program by `buf` alone, and its jit specialises on the
     prompt bucket s_buf (an argument's shape), so one key holds a program
     for each s_buf; the port's key names both. The prefill resets the
     state, runs the prefill and rewinds the caches on the device; each
     replay of the step program runs STEPS iterations of tts_tpu's
     while-loop body (the CFM at the noise row of the device count, the
     latent written there, the feature encoder, the dual-LM step at the
     device length, the stop), each applied only while the loop's
     condition holds (`go`): a step past the stop is a frozen step, which
     changes no state but still launches its kernels. The host reads the
     stop flag through `program.replay_ahead` (one replay queued ahead of
     the read, so after a stop one replay of frozen steps runs; at the cap
     the host queues exactly the replays it needs). A step for which the
     cache has no row freezes the request, and the host raises afterwards;
  3. VAE: the whole-buffer decode behind `_decode` / `_decode_batch`
     (`_voc_cache[(rows, buf)]`: the latents zeroed past each row's count,
     vae_decode, int16), which tts_tpu fuses into its decode program, and
     the streaming window decode (`_vae_dec_cache[n]`, n the window's
     latents).
A decode key holds a list of `_Decode`s: a request takes a free one or
builds another, and holds it from its prefill until the VAE program has
copied its latents in. Setting `params` or `vae_params`, or replacing,
moving or casting a tensor of them, drops every program.

`synthesize_streaming` runs the request's `_Decode` (the same prompt
bucket and key; tts_tpu's `_build_gen_chunk` and its 2,048-row
`_prefill_only_fn` have no separate port: the step program serves both),
copies the latents made so far to the host every `chunk` latents and at the
stop, and VAE-decodes windows of chunk + 1 latents with one latent of left
context discarded (runtime/streaming.ChunkedCodecStream), at the native
rate. The other entries resample their output linearly to
`output_sample_rate` where it is not the native rate.

The CFM noise: a request's (buf, B, patch, latent) draws, filled into its
state before the prefill, outside any program: one draw from a
torch.Generator seeded from `seed` on the params' device, or the `noise`
argument of (steps, B, patch, latent) (tts_tpu's jax.random stream cannot
be reproduced in torch, so tests pass its draws). The step reads its row
at the device count; no random draw happens inside a graph. Rows past a
short `noise` are zeros: where a kept latent read one, the host raises
afterwards.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..audio.wav import resample_linear, to_pcm16
from ..kv.cache import KVCache
from ..models.voxcpm import (VoxCPMConfig, cfm_feat_decoder_batch, feat_encoder_cond,
                             feat_encoder_cond_batch, vae_decode, vae_encode,
                             voxcpm_main_step)
from .program import GraphPool, HostSlots, Program, replay_ahead, weights_key

__all__ = ["VoxCPMPipeline", "VoxCPMDecodeConfig", "MAX_PREFILL_TOKENS",
           "MAX_PROMPT_FEATS", "STEPS"]

MAX_PREFILL_TOKENS = 256   # text tokens incl. audio_start
MAX_PROMPT_FEATS = 256     # prompt audio patches
# latent steps a replay of a step program covers: the host reads the stop
# flag once a replay, and after a stop one replay of frozen steps runs
STEPS = 1


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


class _Decode:
    """One decode key's programs and the device state they share: the
    counterpart of one jitted `run` of tts_tpu's `_dec_cache[buf]` at prompt
    bucket s_buf (`batch` False, one row) or of `_batch_fns[("batch", B,
    s_buf, buf)]` (`rows` B). One body serves both: with one row and its cap
    min(max_steps, buf) the batch's loop is the request's (its count stops
    at the stop or the cap, as tts_tpu's `num < min(max_steps, buf)` bound).

    `prefill` is the prefill program: the text ids (rows, s_buf) int32, the
    audio mask ((s_buf,), a batch's (rows, s_buf)) bool, the prompt length
    () (a batch: each row's pad start (rows,)) int32, the feat_embed buffer
    (rows, s_buf, base_H) fp32, feat_cond (2 rows, patch, est_H) fp32 (the
    rows [pos | neg]), each row's latent cap (rows,) int32. `step` is the
    program of STEPS latent steps. Each returns `outs`: the stop flag, the
    latent steps run, each row's latents kept (rows,) int32, the overflow
    flag. `state` lists every tensor they update; `noise` (buf, rows,
    patch, latent) fp32, which they only read, is the host's to fill before
    the prefill (`fill_noise`). A request holds `lock` from its prefill to
    the VAE program's copy of its latents (`VoxCPMPipeline._held`)."""

    def __init__(self, pipe: "VoxCPMPipeline", rows: int, s_buf: int, buf: int,
                 batch: bool):
        cfg, dev, dt = pipe.cfg, pipe.device, pipe.dtype
        b, r, est = cfg.base, cfg.residual, cfg.estimator
        self.pipe, self.rows, self.s_buf, self.buf, self.batch = pipe, rows, s_buf, buf, batch
        # the caches hold the prefill bucket and the latent cap (tts_tpu's kv_max)
        self.kv_max = min(b.max_seq_len, -(-(s_buf + buf + 1) // 128) * 128)

        def cache(c):
            return torch.zeros((c.num_layers, rows, c.num_kv_heads, self.kv_max, c.head_dim),
                               dtype=dt, device=dev)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.bk, self.bv, self.rk, self.rv = cache(b), cache(b), cache(r), cache(r)
        patch, lat = cfg.patch_size, cfg.vae.latent_dim
        # pos: both caches' length; num: latent steps run; fin: a row stopped
        # (its stop flag from min_latents on, or its cap); done: a row's
        # latents at its stop; cnt: the latents each row keeps; over: a step
        # found no cache row; stop: the loop's exit
        self.pos, self.num = zeros(), zeros()
        self.dit = zeros(rows, 1, est.hidden_size, dtype=dt)
        self.feat_cond = zeros(2 * rows, patch, est.hidden_size, dtype=dt)
        self.latents = zeros(rows, buf, patch, lat, dtype=torch.float32)
        self.noise = zeros(buf, rows, patch, lat, dtype=torch.float32)
        self.caps, self.done, self.cnt = zeros(rows), zeros(rows), zeros(rows)
        self.fin = zeros(rows, dtype=torch.bool)
        # a batch's key validity: its prompts are right-justified in the bucket
        self.kv_valid = zeros(rows, self.kv_max, dtype=torch.bool) if batch else None
        self.over, self.stop = zeros(dtype=torch.bool), zeros(dtype=torch.bool)
        self.state = tuple(x for x in (
            self.bk, self.bv, self.rk, self.rv, self.pos, self.num, self.dit, self.feat_cond,
            self.latents, self.caps, self.done, self.cnt, self.fin, self.kv_valid, self.over,
            self.stop) if x is not None)
        self.outs = (self.stop, self.num, self.cnt, self.over)
        self.prefill = Program(self._prefill_body, [
            ((rows, s_buf), torch.int32), ((rows, s_buf) if batch else (s_buf,), torch.bool),
            ((rows,) if batch else (), torch.int32), ((rows, s_buf, b.hidden_size), torch.float32),
            ((2 * rows, patch, est.hidden_size), torch.float32), ((rows,), torch.int32)],
            dev, pipe._pool, self.state)
        self.step = Program(self._steps, [], dev, pipe._pool, self.state)
        # the host's two slots of outs: one replay runs ahead of the read
        self._slots = HostSlots(self.outs, dev)
        self._drawn = buf
        self.lock = threading.Lock()

    # ------------------------------------------------------------ programs

    def _prefill_body(self, text, is_audio, lens, fe, feat_cond0, caps) -> tuple:
        """tts_tpu's prefill: one dual-LM pass over the bucket, each position a
        text token or an audio patch by the mask; a request's caches rewound
        to its true length (the latents append there and overwrite the
        padded rows, which the mask hides until then), a batch's rows
        right-justified with their key validity."""
        pipe, cfg = self.pipe, self.pipe.cfg
        params, dt = pipe.params, pipe.dtype
        for t in (self.bk, self.bv, self.rk, self.rv, self.latents, self.num, self.fin,
                  self.over):
            t.zero_()
        fe = fe.to(dt)
        base_kv, res_kv = KVCache(self.bk, self.bv, 0), KVCache(self.rk, self.rv, 0)
        emb = params["embed"][text.long()]
        if self.batch:
            dev = text.device
            valid = torch.arange(self.s_buf, device=dev)[None, :] >= lens[:, None]
            self.kv_valid.copy_(torch.arange(self.kv_max, device=dev)[None, :]
                                >= lens[:, None])
            h = torch.where(is_audio[..., None], fe, emb) * valid[..., None]
            dit, _, _, _ = voxcpm_main_step(params, h, fe, is_audio, base_kv, res_kv, cfg,
                                            kv_valid=self.kv_valid)
            self.pos.fill_(self.s_buf)
        else:
            h = torch.where(is_audio[None, :, None], fe, emb)
            dit, _, _, _ = voxcpm_main_step(params, h, fe, is_audio, base_kv, res_kv, cfg,
                                            valid_len=lens)
            KVCache(self.bk, self.bv, self.pos).rewind(lens)
        self.dit.copy_(dit)
        self.feat_cond.copy_(feat_cond0.to(dt))
        self.caps.copy_(caps)
        self.done.fill_(self.buf)
        self._set_stop()
        return self.outs

    def _set_stop(self) -> None:
        self.cnt.copy_(torch.minimum(self.done, self.num))
        self.stop.copy_(self.fin.all() | (self.num >= self.buf) | self.over)

    def _steps(self) -> tuple:
        for _ in range(STEPS):
            self._one_step()
        return self.outs

    def _one_step(self) -> None:
        """One iteration of tts_tpu's while-loop body, applied only while
        its condition holds (`go`); otherwise a frozen step."""
        pipe, cfg, dcfg = self.pipe, self.pipe.cfg, self.pipe.dcfg
        params, dt = pipe.params, pipe.dtype
        active = ~self.fin.all() & (self.num < self.buf)
        go = active & (self.pos < self.kv_max)
        self.over.copy_(self.over | (active & ~go))
        at = self.num.clamp(max=self.buf - 1).long().reshape(1)
        latent = cfm_feat_decoder_batch(params, self.noise.index_select(0, at)[0], self.dit,
                                        self.feat_cond, cfg)                   # fp32
        self.latents.index_copy_(1, at, torch.where(go, latent[:, None],
                                                    self.latents.index_select(1, at)))
        feat_embed, feat_cond = feat_encoder_cond_batch(params, latent.to(dt), cfg)
        # a frozen step writes cache row pos, which no kept row is
        pos = self.pos.clamp(max=self.kv_max - 1)
        dit, stop, _, _ = voxcpm_main_step(
            params, feat_embed, feat_embed, 0, KVCache(self.bk, self.bv, pos),
            KVCache(self.rk, self.rv, pos), cfg, kv_valid=self.kv_valid, fused=pipe._fused)
        self.dit.copy_(torch.where(go, dit, self.dit))
        self.feat_cond.copy_(torch.where(go, feat_cond, self.feat_cond))
        # a stop is honoured only from min_latents on; a row stops at its cap
        nxt = self.num + 1
        newly = (((stop == 1) & (nxt >= dcfg.min_latents)) | (nxt >= self.caps)) \
            & ~self.fin & go
        self.done.copy_(torch.where(newly, nxt, self.done))
        self.fin.copy_(self.fin | newly)
        step = go.to(torch.int32)
        self.num.add_(step)
        self.pos.add_(step)
        self._set_stop()

    # ---------------------------------------------------------------- host

    def fill_noise(self, noise, seed: int) -> None:
        """The request's CFM draws into the state, outside any program: the
        `noise` argument's first rows (the rest zeros), or one draw of the
        whole buffer from the generator of `seed` (`_get_key`)."""
        if noise is None:
            self.noise.normal_(generator=self.pipe._get_key(seed))
            self._drawn = self.buf
            return
        noise = torch.as_tensor(noise).to(self.noise.device, torch.float32)
        n = min(noise.shape[0], self.buf)
        self.noise[:n].copy_(noise[:n].reshape(n, *self.noise.shape[1:]))
        self.noise[n:].zero_()
        self._drawn = noise.shape[0]

    def replays(self, inputs: tuple, cap: int):
        """The prefill over `inputs`, then at most enough replays of the step
        program for `cap` latents: yields the host values of `outs` after
        the prefill and after each replay, each replay queued before the
        host reads the one before it."""
        yield from replay_ahead(self._slots, self.prefill(*inputs), self.step,
                                -(-cap // STEPS))

    def check(self, vals) -> None:
        """Raises where a step found no cache row, or a latent step read a
        noise row past the `noise` argument's."""
        _, num, _, over = vals
        if over:
            raise ValueError(f"cache of {self.kv_max} rows cannot take the next latent step")
        if int(num) > self._drawn:
            raise IndexError(f"{int(num)} latent steps ran on a noise argument of "
                             f"{self._drawn} rows")

    def run(self, inputs: tuple, cap: int) -> list:
        """`replays` to the stop flag; returns the last values read (stop,
        steps run, latents kept a row, overflow) after `check`."""
        for vals in self.replays(inputs, cap):
            if vals[0]:
                break
        self.check(vals)
        return vals


class VoxCPMPipeline:
    """VoxCPM over the LM params dict and the VAE params dict (tts_tpu's
    layouts, e.g. from `weights.convert.params_from_jax` or the models'
    init functions). Runs on the device the params are on, through the
    programs of the module's docstring."""

    def __init__(self, params: dict, cfg: VoxCPMConfig, vae_params: dict,
                 decode_cfg: VoxCPMDecodeConfig | None = None,
                 output_sample_rate: int | None = None, quantize: int | None = None):
        if quantize not in (None, 4, 8):
            raise ValueError(f"quantize must be None, 4 or 8, got {quantize!r}")
        if quantize:
            # int8 or int4 on the LM, feature-encoder and estimator matmuls;
            # the VAE stays float
            from ..quant.weight_only import quantize_pytree

            params = quantize_pytree(params, bits=quantize)
        # the programs, keyed as tts_tpu's (the module's docstring); on a
        # card their graphs share one memory pool
        self._enc_cache: dict = {}
        self._dec_cache: dict = {}
        self._batch_fns: dict = {}
        self._vae_dec_cache: dict = {}
        self._voc_cache: dict = {}
        self._pool = GraphPool()
        self._weights = None
        self.params = params
        self.cfg = cfg
        self.vae_params = vae_params
        self.dcfg = decode_cfg or VoxCPMDecodeConfig()
        fd = self.dcfg.fused_decode
        self._fused = "step" if fd is None else fd
        self.output_sample_rate = output_sample_rate or cfg.output_sample_rate
        sr = cfg.vae.sr_bins
        self._sr_idx = int(np.searchsorted(np.asarray(sr), cfg.output_sample_rate)) if sr else 0

    @property
    def params(self) -> dict:
        """The LM, feature-encoder and estimator params (quantized where the
        pipeline was built with `quantize`). Setting them drops the programs
        built so far."""
        return self._params

    @params.setter
    def params(self, params: dict) -> None:
        self._params = params
        self.device = params["embed"].device
        self.dtype = params["embed"].dtype
        self._drop()

    @property
    def vae_params(self) -> dict:
        """The VAE's params. Setting them drops the programs built so far."""
        return self._vae_params

    @vae_params.setter
    def vae_params(self, vae_params: dict) -> None:
        self._vae_params = vae_params
        self._drop()

    def _drop(self) -> None:
        for table in (self._enc_cache, self._dec_cache, self._batch_fns, self._vae_dec_cache,
                      self._voc_cache):
            table.clear()

    def _programs(self) -> None:
        """Drop the programs where a tensor they read was replaced, moved or
        cast since they were built (`weights_key`)."""
        key = weights_key(self.params, self.vae_params)
        if key != self._weights:
            self._drop()
            self._weights = key

    # ------------------------------------------------------------- prompt

    def _encode_body(self, audio: torch.Tensor) -> tuple:
        """The encode program's body: the bucket's audio (1, N) fp32 ->
        (the latent patches (T, patch, latent), feat_embed (1, T, base_H),
        feat_cond (2, patch, est_H))."""
        cfg = self.cfg
        lat = vae_encode(self.vae_params, audio, cfg.vae)
        t = lat.shape[1] // cfg.patch_size
        feats = lat[0, :t * cfg.patch_size].reshape(t, cfg.patch_size, -1).to(self.dtype)
        feat_embed, feat_cond = feat_encoder_cond(self.params, feats, cfg)
        return feats, feat_embed, feat_cond

    @torch.no_grad()
    def encode_prompt(self, audio: np.ndarray):
        """audio: int16 or float mono at cfg.sample_rate. Returns (the latent
        patches (T, patch, latent), feat_embed (1, T, base_H), feat_cond (2,
        patch, est_H)) on the device, from the encode program of the padded
        audio's bucket. The audio is left-padded to a patch multiple, given
        one trailing zero patch and zero-padded to a multiple of 8 patches,
        as tts_tpu buckets it; every patch of the bucket is kept."""
        cfg = self.cfg
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        patch_len = cfg.patch_size * cfg.chunk_size
        pad = patch_len - (len(audio) % patch_len)
        audio = np.concatenate([np.zeros(pad, np.float32), audio.astype(np.float32),
                                np.zeros(patch_len, np.float32)])
        bucket = -(-len(audio) // (patch_len * 8)) * (patch_len * 8)
        audio = np.pad(audio, (0, bucket - len(audio)))[None]
        self._programs()
        if bucket not in self._enc_cache:
            self._enc_cache[bucket] = Program(self._encode_body, [((1, bucket), torch.float32)],
                                              self.device, self._pool)
        return self._enc_cache[bucket](audio)

    def _zero_cond(self) -> torch.Tensor:
        return torch.zeros((2, self.cfg.patch_size, self.cfg.estimator.hidden_size),
                           dtype=self.dtype, device=self.device)

    def _caches(self, bsz: int, kv_max: int) -> tuple[KVCache, KVCache]:
        b, r = self.cfg.base, self.cfg.residual
        return (KVCache.create(b.num_layers, bsz, b.num_kv_heads, kv_max, b.head_dim,
                               self.dtype, self.device),
                KVCache.create(r.num_layers, bsz, r.num_kv_heads, kv_max, r.head_dim,
                               self.dtype, self.device))

    def _get_key(self, seed: int) -> torch.Generator:
        """A request's CFM noise source: a fresh generator seeded from
        `seed` on the params' device, from which a decode state draws its
        whole noise buffer."""
        return torch.Generator(self.device).manual_seed(seed)

    # ---------------------------------------------------------------- VAE

    def _vae_body(self, latents: torch.Tensor, counts: torch.Tensor) -> tuple:
        """(rows, buf, patch, latent) fp32 latents, each row's count (rows,)
        int32 -> (int16 (rows, buf * samples_per_latent),): the latents past
        each row's count zeroed, vae_decode, * 32767."""
        cfg = self.cfg
        live = torch.arange(latents.shape[1], device=latents.device)[None, :] < counts[:, None]
        flat = (latents * live[..., None, None]).reshape(latents.shape[0], -1,
                                                        cfg.vae.latent_dim)
        wav = vae_decode(self.vae_params["dec"], flat, cfg.vae, sr_idx=self._sr_idx)
        return (to_pcm16(wav * 32767.0),)

    def _vae(self, rows: int, buf: int) -> Program:
        """The whole-buffer VAE program of (rows, buf) latents
        (`_voc_cache[(rows, buf)]`)."""
        self._programs()
        if (rows, buf) not in self._voc_cache:
            cfg = self.cfg
            self._voc_cache[(rows, buf)] = Program(self._vae_body, [
                ((rows, buf, cfg.patch_size, cfg.vae.latent_dim), torch.float32),
                ((rows,), torch.int32)], self.device, self._pool)
        return self._voc_cache[(rows, buf)]

    def _window_body(self, latents: torch.Tensor) -> tuple:
        flat = latents.reshape(1, -1, self.cfg.vae.latent_dim)
        wav = vae_decode(self.vae_params["dec"], flat, self.cfg.vae, sr_idx=self._sr_idx)
        return (to_pcm16(wav * 32767.0),)

    def _window(self, n: int) -> Program:
        """The streaming window VAE program of n latents (tts_tpu's
        `_vae_dec_cache[n]`)."""
        cfg = self.cfg
        self._programs()
        if n not in self._vae_dec_cache:
            self._vae_dec_cache[n] = Program(
                self._window_body, [((1, n, cfg.patch_size, cfg.vae.latent_dim), torch.float32)],
                self.device, self._pool)
        return self._vae_dec_cache[n]

    def _vae_dec_fn(self, latents: np.ndarray) -> torch.Tensor:
        """A streaming window of latents (1, W, patch, latent) -> int16 (1,
        W * samples_per_latent) on the device (its host copy comes later),
        through the window's program."""
        return self._window(latents.shape[1])(np.asarray(latents, np.float32))[0]

    def _vocode(self, latents: torch.Tensor) -> np.ndarray:
        """The whole-buffer VAE body run eagerly (the slot server's call):
        (B, buf, patch, latent) -> int16 (B, buf * samples_per_latent)."""
        counts = torch.full((latents.shape[0],), latents.shape[1], dtype=torch.int32,
                            device=latents.device)
        return self._vae_body(latents.float(), counts)[0].cpu().numpy()

    # ------------------------------------------------------------- decode

    @contextmanager
    def _held(self, table: dict, key, rows: int, s_buf: int, buf: int, batch: bool):
        """A `_Decode` of `table[key]` (a list) that no other request holds,
        held for the `with` block: the first free one, or a new one where
        each is held (by a request in another thread, or by a stream not
        consumed to its end)."""
        self._programs()
        decs = table.setdefault(key, [])
        for dec in list(decs):
            if dec.lock.acquire(blocking=False):
                break
        else:
            dec = _Decode(self, rows, s_buf, buf, batch)
            dec.lock.acquire()
            decs.append(dec)
        try:
            yield dec
        finally:
            dec.lock.release()

    @contextmanager
    def _solo(self, text_buf, is_audio, prefill_len: int, fe_buf, feat_cond,
              max_steps: int, buf: int, seed: int, noise=None):
        """A request's `_Decode` (`_dec_cache[(s_buf, buf)]`, held) with its
        noise filled, its prefill program's inputs and its cap min(max_steps,
        buf), for the `with` block."""
        cap, s_buf = min(max_steps, buf), text_buf.shape[1]
        with self._held(self._dec_cache, (s_buf, buf), 1, s_buf, buf, False) as dec:
            dec.fill_noise(noise, seed)
            yield dec, (text_buf, is_audio, np.int32(prefill_len), fe_buf,
                        torch.as_tensor(feat_cond), np.array([cap], np.int32)), cap

    def _latent_steps(self, text_buf, is_audio, prefill_len: int, fe_buf, feat_cond,
                      max_steps: int, buf: int, seed: int, noise=None):
        """The prefill and the generation loop of one request on its decode
        programs, a generator: after the prefill and after each replay it
        yields (the state's latents (1, buf, patch, latent) fp32 on the
        device, latent steps run, stopped). Rows [0, steps run) are final
        when yielded; the replay queued ahead writes past them, or
        nothing."""
        with self._solo(text_buf, is_audio, prefill_len, fe_buf, feat_cond, max_steps, buf,
                        seed, noise) as (dec, inputs, cap):
            for vals in dec.replays(inputs, cap):
                dec.check(vals)
                yield dec.latents, int(vals[1]), bool(vals[0])
                if vals[0]:
                    break

    def _decode(self, text_buf, is_audio, prefill_len: int, fe_buf, feat_cond,
                max_steps: int, buf: int, seed: int, noise=None):
        """The prefill, the generation loop and the VAE decode of one
        request, on its programs. Returns (int16 (1, buf *
        samples_per_latent), latents)."""
        with self._solo(text_buf, is_audio, prefill_len, fe_buf, feat_cond, max_steps, buf,
                        seed, noise) as (dec, inputs, cap):
            _, num, _, _ = dec.run(inputs, cap)
            (wav,) = self._vae(1, buf)(dec.latents, dec.cnt)
        return wav.cpu().numpy(), int(num)

    def _prompt_bufs(self, segments) -> tuple:
        """segments: ('text', ids (T,)) / ('audio', feat_embed (1, T, H)) in
        prompt order -> (text ids (1, S), audio mask (S,), feat_embed buffer
        (1, S, H), prompt length) in the 64-position bucket, on the device."""
        cfg = self.cfg
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
                fe_buf[:, p:p + n] = torch.as_tensor(data, device=self.device)
                is_audio[p:p + n] = True
            p += n
        return torch.as_tensor(text_buf, device=self.device), is_audio, fe_buf, pos

    def _latent_buf(self, max_steps: int) -> int:
        """The latent buffer: 32-latent granularity, capped at max_latents."""
        return min(self.dcfg.max_latents, max(32, -(-max_steps // 32) * 32))

    def _resampled(self, wav: np.ndarray) -> np.ndarray:
        native = self.cfg.output_sample_rate
        if self.output_sample_rate == native or len(wav) == 0:
            return wav
        return resample_linear(wav, native, self.output_sample_rate)

    def _run_segments(self, segments, feat_cond, max_steps: int, seed: int | None,
                      noise=None) -> tuple[np.ndarray, dict]:
        """segments: ('text', ids (T,)) / ('audio', feat_embed (1, T, H)) in
        prompt order. Runs the prefill, the generation and the VAE decode;
        the waveform at output_sample_rate."""
        cfg, dcfg = self.cfg, self.dcfg
        text_buf, is_audio, fe_buf, pos = self._prompt_bufs(segments)
        buf = self._latent_buf(max_steps)
        base_seed = dcfg.seed if seed is None else seed

        t0 = time.perf_counter()
        for attempt in range(dcfg.retry_badcase + 1):
            wav, num = self._decode(text_buf, is_audio, pos, fe_buf, feat_cond, max_steps,
                                    buf, base_seed + attempt, noise)
            if num < min(max_steps, buf):
                break                       # stopped by itself
        n_samples = num * cfg.samples_per_latent
        wav = self._resampled(wav[0, :n_samples])
        wall = time.perf_counter() - t0
        # the real-time factor over the native-rate length, as tts_tpu's
        return wav, {"latents": num, "wall_s": wall,
                     "sample_rate": self.output_sample_rate,
                     "rtf": wall / max(n_samples / cfg.output_sample_rate, 1e-9)}

    @torch.no_grad()
    def synthesize_streaming(self, segments, feat_cond, max_steps: int,
                             seed: int | None = None, chunk: int = 4, noise=None):
        """A generator of int16 audio chunks at the native rate for one
        request (segments and feat_cond as _run_segments takes them): the
        latents of the request's decode programs, copied to the host every
        `chunk` latents and at the stop or the cap (the count and the stop
        flag read once a replay), VAE-decoded in windows of chunk + 1
        latents with one latent of left context discarded, a window each
        `chunk` latents. No bad-case retry on this path. noise: the CFM
        draws (steps, 1, patch, latent), as synthesize_ids takes them."""
        from .streaming import ChunkedCodecStream

        cfg, dcfg = self.cfg, self.dcfg
        text_buf, is_audio, fe_buf, pos = self._prompt_bufs(segments)
        stream = ChunkedCodecStream(self._vae_dec_fn, window=chunk + 1, left_context=1,
                                    upsample=cfg.samples_per_latent,
                                    num_groups=cfg.patch_size)
        sent = 0
        for latents, num, stop in self._latent_steps(
                text_buf, is_audio, pos, fe_buf, feat_cond, max_steps,
                self._latent_buf(max_steps), dcfg.seed if seed is None else seed, noise):
            cuts = list(range((sent // chunk + 1) * chunk, num + 1, chunk))
            if stop and num > (cuts[-1] if cuts else sent):
                cuts.append(num)
            for cut in cuts:
                # on the stream after the replay that wrote the rows
                out = stream.push_frames(latents[0, sent:cut].cpu().numpy())
                sent = cut
                if out is not None and len(out):
                    yield out
        for out in stream.finish():
            yield out

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
        """Batched prefill and generation on the batch's decode programs
        (`_batch_fns[("batch", B, s_buf, buf)]`), then the VAE program over
        the buffer with each row's latents zeroed past its stop. Returns
        (int16 (B, buf * samples_per_latent), latents a row)."""
        bsz, s_buf = text_buf.shape
        caps = np.asarray(torch.as_tensor(caps).cpu(), np.int32)
        with self._held(self._batch_fns, ("batch", bsz, s_buf, buf), bsz, s_buf, buf,
                        True) as dec:
            dec.fill_noise(noise, seed)
            _, _, cnt, _ = dec.run((text_buf, is_audio, pad_start, fe_buf, feat_cond0, caps),
                                   int(caps.max()))
            cnt = [int(c) for c in cnt]
            (wav,) = self._vae(bsz, buf)(dec.latents, dec.cnt)
        return wav.cpu().numpy(), cnt

    def _batch_bufs(self, plans) -> tuple:
        """plans: per row (segments, feat_cond (2, P, H) | None, cap). Rows are
        right-justified in one bucket (a multiple of 16 positions); the
        per-position kind mask and the per-row key validity give each row
        its single-request layout. Returns the batch program's inputs (text
        ids, audio mask, pad starts, feat_embed buffer, feat_cond rows [pos
        | neg], caps) and the latent buffer."""
        cfg = self.cfg
        dev = self.device
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
        buf = self._latent_buf(int(caps.max()))       # the loop cannot pass max(caps)
        return (text_buf, is_audio, pad_start, fe_buf, feat_cond0, caps), buf

    def _run_segments_batch(self, plans, seed: int | None, noise=None):
        """plans: per row (segments, feat_cond (2, P, H) | None, cap), laid
        out by `_batch_bufs`. Returns (wavs, stats, counts, caps)."""
        cfg, dcfg = self.cfg, self.dcfg
        bsz = len(plans)
        inputs, buf = self._batch_bufs(plans)
        caps = inputs[-1]
        t0 = time.perf_counter()
        wav, counts = self._decode_batch(*inputs, buf, dcfg.seed if seed is None else seed,
                                         noise)
        spl = cfg.samples_per_latent
        wavs = [self._resampled(wav[bi, :counts[bi] * spl]) for bi in range(bsz)]
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
