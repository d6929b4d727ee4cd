"""IndexTTS synthesis from token ids: reference audio + text ids -> cloned
speech (counterpart of tts_tpu/runtime/indextts.py:IndexTTSPipeline,
without `mesh`). `synthesize` is the text entry: frontend/indextts_text.py's
tokenizer and sentence split, one `synthesize_ids` a sentence.

Three stages, as tts_tpu's three jitted programs, each a
`runtime.program.Program` under tts_tpu's key (on a card a CUDA graph on
the pipeline's `GraphPool`, captured at its first call and replayed; on
the CPU its body runs eagerly on the same state):
  1. encode (`_enc_cache[bucket]`): the log-mel (constant STFT padding) ->
     conformer -> perceiver conds_latent; ECAPA -> cond_layer and the
     per-stage BigVGAN conds, over the reference padded to its bucket, a
     multiple of 32768 samples. The 100 ms noise pad (numpy, from `seed`)
     in front of the audio and the bucketing stay on the host;
  2. decode (`_dec_cache[(tb, max_gen)]` for a request,
     `_dec_cache[("batch", B, tb, max_gen)]` for a batch): a `_Decode`, a
     prefill and a step program over a state on the device (the KV cache
     with its length as a device int32 over kv_max = min(max_seq_len,
     ceil((p_len + max_gen) / 256) * 256) rows, the key mask of the text
     bucket's hole, the penalty vector and its reset index, the token and
     hidden-state buffers, the count, the stop flags). The prefill runs
     over [conds_latent | text | mel start] and makes the first argmax;
     each replay of the step program runs STEPS iterations of tts_tpu's
     while-loop body (the penalty vector's sliding reset window, a GPT-2
     step at the device length, argmax, the stop), each applied only while
     the loop's condition holds (`go`): a step past the stop is a frozen
     step, which changes no state but still launches its kernels. The host
     reads the stop flag through `program.replay_ahead` (one replay queued
     ahead of the read, so after a stop one replay of frozen steps runs; at
     the max_gen cap the host queues exactly the replays it needs). A step
     for which the cache has no row freezes the request, and the host
     raises afterwards, as the host-driven loop raised at that step;
  3. vocode (`_voc_cache[fb]`, `_voc_cache[("batch", fb, nlive)]`): the
     hiddens of the fb-frame bucket with rows past each row's frame count
     zeroed, final_norm, the speaker-conditioned BigVGAN (kernel 10 on
     AMPBlock1 stages), int16.

A decode key holds a list of `_Decode`s: a request takes a free one or
builds another, and holds it from its prefill until the vocode program has
copied its hiddens in. Setting `params`, or replacing, moving or casting a
tensor of them, drops every program.

Text lengths are bucketed to 16; this GPT-2 has no positional encoding of
its own, so the padded text positions are handled by the kv mask alone.
Decode steps take `fused_decode` ("step" by default, which the kv mask
degrades to kernel 11, as in tts_tpu).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..audio.mel import MelSpectrogram
from ..audio.wav import to_pcm16
from ..kv.cache import KVCache
from ..models.bigvgan import BigVGANConfig, bigvgan_apply
from ..models.indextts import (IndexTTSConfig, conformer_encoder, ecapa_speaker_encoder,
                               gpt_final_norm, gpt_step, perceiver_resample)
from ..quant.weight_only import quantize_int4, quantize_int8_eager
from .program import GraphPool, HostSlots, Program, replay_ahead, weights_key

__all__ = ["IndexTTSPipeline", "IndexTTSDecodeConfig", "IndexTTSStats", "STEPS"]

# decode steps a replay of a step program covers: the host reads the stop
# flag once a replay, and after a stop one replay of frozen steps runs
STEPS = 1
# the reference audio's bucket, in samples
ENC_BUCKET = 32768


@dataclass(frozen=True)
class IndexTTSDecodeConfig:
    repeat_penalty: float = 0.9
    penalty_range: int = 10
    # None = "step" on every device (degraded to the qkv-head kernel by the
    # kv mask every decode step passes); True = the qkv-head kernel;
    # False = plain ops
    fused_decode: bool | str | None = None


@dataclass
class IndexTTSStats:
    tokens: int
    wall_s: float

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.wall_s, 1e-9)


def _quantize_gpt(gpt: dict, bits: int) -> dict:
    """Weight-only int8 (the eager quantizer, as tts_tpu calls it) or int4
    (input dims a multiple of 32; int8 for the rest) of the GPT matmuls."""
    def q(w):
        if bits == 4 and w.dim() == 2 and w.shape[0] % 32 == 0:
            return quantize_int4(w)
        return quantize_int8_eager(w)

    layers = [{**lyr, "wqkv": q(lyr["wqkv"]), "wo": q(lyr["wo"]),
               "fc": {**lyr["fc"], "w": q(lyr["fc"]["w"])},
               "proj": {**lyr["proj"], "w": q(lyr["proj"]["w"])}}
              for lyr in gpt["layers"]]
    return {**gpt, "layers": layers, "lm_head": q(gpt["lm_head"])}


class _Decode:
    """One decode key's programs and the device state they share: the
    counterpart of one jitted `run` of tts_tpu's `_dec_cache[(tb,
    max_gen)]` (`rows` 1) or `_dec_cache[("batch", B, tb, max_gen)]` (`rows`
    B). One body serves both: with one row the batch's loop is the solo
    one (a live row is never finished, and its kept count is the count).

    `prefill` is the prefill program: conds_latent (rows, n_lat, D), the
    text ids (rows, tb) int32, each row's text length (rows,) int32. `step`
    is the program of STEPS decode steps. Each returns `outs`: the stop
    flag, each row's tokens kept (rows,) int32, the overflow flag. `state`
    lists every tensor they update. A request holds `lock` from its prefill
    to the vocode program's copy of its hiddens (`IndexTTSPipeline._held`)."""

    def __init__(self, pipe: "IndexTTSPipeline", rows: int, tb: int, max_gen: int,
                 latent_dtype):
        cfg, dev, dt = pipe.cfg, pipe.device, pipe.dtype
        self.pipe, self.rows, self.tb, self.max_gen = pipe, rows, tb, max_gen
        self.p_len = cfg.num_latents + tb + 3
        self.kv_max = min(cfg.max_seq_len, -(-(self.p_len + max_gen) // 256) * 256)
        shape = (cfg.gpt_layers, rows, cfg.gpt_heads, self.kv_max, cfg.gpt_head_dim)
        self.k = torch.zeros(shape, dtype=dt, device=dev)
        self.v = torch.zeros(shape, dtype=dt, device=dev)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # pos: the cache length; num: tokens decoded; tok: the last token;
        # rst: the penalty window's reset index; fin: a row's stop token
        # came; done: a row's tokens with its stop token; cnt: the tokens
        # each row keeps; over: a step found no cache row; stop: the loop's
        # exit
        self.kv_valid = zeros(rows, self.kv_max, dtype=torch.bool)
        self.vec = zeros(rows, cfg.num_mel_codes, dtype=torch.float32)
        self.save = zeros(rows, max_gen, dtype=torch.long)
        self.hiddens = zeros(rows, max_gen, cfg.gpt_dim, dtype=dt)
        self.pos, self.num = zeros(), zeros()
        self.tok, self.rst = zeros(rows, dtype=torch.long), zeros(rows, dtype=torch.long)
        self.fin = zeros(rows, dtype=torch.bool)
        self.done, self.cnt = zeros(rows), zeros(rows)
        self.over, self.stop = zeros(dtype=torch.bool), zeros(dtype=torch.bool)
        self.state = (self.k, self.v, self.kv_valid, self.vec, self.save, self.hiddens,
                      self.pos, self.num, self.tok, self.rst, self.fin, self.done, self.cnt,
                      self.over, self.stop)
        self.outs = (self.stop, self.cnt, self.over)
        self.prefill = Program(self._prefill_body, [
            ((rows, cfg.num_latents, cfg.gpt_dim), latent_dtype), ((rows, tb), torch.int32),
            ((rows,), torch.int32)], dev, pipe._pool, self.state)
        self.step = Program(self._steps, [], dev, pipe._pool, self.state)
        # the host's two slots of outs: one replay runs ahead of the read
        self._slots = HostSlots(self.outs, dev)
        self.lock = threading.Lock()

    # ------------------------------------------------------------ programs

    def _mask(self) -> torch.Tensor:
        return self.kv_valid if self.rows > 1 else self.kv_valid[0]

    def _prefill_body(self, conds_latent, text_ids, text_len) -> tuple:
        """tts_tpu's prefill: [0] + ids + [1] embedded with learned
        positions (the [1] moved to its true position text_len + 1), the
        mel start, one GPT pass with the padded text positions
        [n_lat + text_len + 2, p_len - 1) masked, the first argmax."""
        pipe, cfg = self.pipe, self.pipe.cfg
        gpt, dev = pipe.params["gpt"], conds_latent.device
        for t in (self.k, self.v, self.save, self.hiddens, self.rst, self.fin, self.over):
            t.zero_()
        bsz, tb = text_ids.shape
        ids = torch.cat([torch.zeros((bsz, 1), dtype=torch.long, device=dev), text_ids.long(),
                         torch.ones((bsz, 1), dtype=torch.long, device=dev)], dim=1)
        tl = text_len.long()
        text_emb = gpt["text_embed"][ids] + gpt["text_pos"][None, :tb + 2]
        end_emb = (gpt["text_embed"][1][None] + gpt["text_pos"][tl + 1])[:, None]
        pos_idx = torch.arange(tb + 2, device=dev)[None, :, None]
        text_emb = torch.where(pos_idx == (tl + 1)[:, None, None], end_emb, text_emb)
        mel_start = gpt["mel_embed"][cfg.start_mel_token] + gpt["mel_pos"][0]
        prefill = torch.cat([conds_latent, text_emb,
                             mel_start.expand(bsz, 1, cfg.gpt_dim)], dim=1)
        kv_idx = torch.arange(self.kv_max, device=dev)[None, :]
        self.kv_valid.copy_(~((kv_idx >= cfg.num_latents + (tl + 2)[:, None])
                              & (kv_idx < self.p_len - 1)))
        self.vec.fill_(1.0)
        logits, last, _ = gpt_step(gpt, prefill, KVCache(self.k, self.v, 0), self.vec, cfg,
                                   self._mask())
        tok = torch.argmax(logits, dim=-1)
        self.hiddens[:, 0] = last
        self.save[:, 0] = tok
        self.tok.copy_(tok)
        self.fin.copy_(tok == cfg.stop_token)
        self.done.copy_(torch.where(self.fin, 1, self.max_gen))
        self.num.fill_(1)
        self.pos.fill_(self.p_len)
        self._set_stop()
        return self.outs

    def _set_stop(self) -> None:
        self.stop.copy_(self.fin.all() | (self.num >= self.max_gen) | self.over)
        self.cnt.copy_(torch.minimum(self.done, self.num))

    def _steps(self) -> tuple:
        for _ in range(STEPS):
            self._one_step()
        return self.outs

    def _one_step(self) -> None:
        """One iteration of tts_tpu's while-loop body, applied only while
        its condition holds (`go`); otherwise a frozen step."""
        pipe, cfg = self.pipe, self.pipe.cfg
        gpt, dcfg, dt = pipe.params["gpt"], pipe.dcfg, pipe.dtype
        active = ~self.fin.all() & (self.num < self.max_gen)
        go = active & (self.pos < self.kv_max)
        self.over.copy_(self.over | (active & ~go))
        # the penalty vector and its sliding reset window (the reference's
        # host loop); no reset in a frozen step or on a finished row
        t = self.tok[:, None]
        self.vec.scatter_(1, t, torch.where(go, dcfg.repeat_penalty, self.vec.gather(1, t)))
        old = self.save.gather(1, self.rst[:, None])
        reset = (go & ~self.fin)[:, None] & (self.num > dcfg.penalty_range) & (old != t)
        self.vec.scatter_(1, old, torch.where(reset, 1.0, self.vec.gather(1, old)))
        self.rst.add_(reset[:, 0].long())
        at = self.num.clamp(max=self.max_gen - 1).long().reshape(1)
        h = (gpt["mel_embed"][self.tok] + gpt["mel_pos"].index_select(0, at))[:, None]
        # a frozen step writes cache row pos, which no kept row is
        kv = KVCache(self.k, self.v, self.pos.clamp(max=self.kv_max - 1))
        logits, last, _ = gpt_step(gpt, h, kv, self.vec, cfg, self._mask(), fused=pipe._fused)
        ntok = torch.where(self.fin, cfg.stop_token, torch.argmax(logits, dim=-1))
        self.save.index_copy_(1, at, torch.where(go, ntok[:, None],
                                                 self.save.index_select(1, at)))
        self.hiddens.index_copy_(1, at, torch.where(go, last[:, None].to(dt),
                                                    self.hiddens.index_select(1, at)))
        newly = (ntok == cfg.stop_token) & ~self.fin & go
        self.done.copy_(torch.where(newly, self.num + 1, self.done))
        self.fin.copy_(self.fin | newly)
        self.tok.copy_(torch.where(go, ntok, self.tok))
        step = go.to(torch.int32)
        self.num.add_(step)
        self.pos.add_(step)
        self._set_stop()

    # ---------------------------------------------------------------- host

    def decode(self, conds_latent, text_ids: np.ndarray, text_len: np.ndarray) -> np.ndarray:
        """The prefill, then replays of the step program until the stop
        flag (at most enough for max_gen - 1 steps); returns each row's
        tokens kept (rows,), and raises where a step found no cache row."""
        first = self.prefill(conds_latent, text_ids, text_len.astype(np.int32))
        for stop, cnt, over in replay_ahead(self._slots, first, self.step,
                                            -(-(self.max_gen - 1) // STEPS)):
            if stop:
                break
        if over:
            raise ValueError(f"cache of {self.kv_max} rows cannot take the next decode step")
        return cnt


class IndexTTSPipeline:
    """params: 'conformer', 'perceiver', 'ecapa', 'gpt', 'bigvgan',
    'cond_layer' ((spk_dim, C0) w, b) and 'conds' (one per BigVGAN stage),
    tts_tpu's tree (e.g. from `weights.convert.params_from_jax`). Runs on
    the device the params are on, through the programs of the module's
    docstring; `quantize` None, 8 or 4 (the GPT matmuls; encoders and
    vocoder stay float)."""

    def __init__(self, params: dict, cfg: IndexTTSConfig, bigvgan_cfg: BigVGANConfig,
                 sample_rate: int = 24000, n_fft: int = 1024, hop: int = 256,
                 seed: int = 0, decode_cfg: IndexTTSDecodeConfig | None = None,
                 quantize: int | None = None):
        if quantize not in (None, 8, 4):
            raise ValueError(f"quantize must be None, 8 or 4, got {quantize!r}")
        if quantize:
            params = {**params, "gpt": _quantize_gpt(params["gpt"], quantize)}
        # the programs, keyed as tts_tpu's (the module's docstring); on a
        # card their graphs share one memory pool
        self._enc_cache: dict = {}
        self._dec_cache: dict = {}
        self._voc_cache: dict = {}
        self._pool = GraphPool()
        self._weights = None
        self.params = params
        self.cfg = cfg
        self.dcfg = decode_cfg or IndexTTSDecodeConfig()
        fd = self.dcfg.fused_decode
        self._fused = "step" if fd is None else fd
        self.vcfg = bigvgan_cfg
        self.sample_rate = sample_rate
        self.melspec = MelSpectrogram(sample_rate, n_fft, hop, n_fft, cfg.n_mels,
                                      pad_mode="constant")
        self.seed = seed

    @property
    def params(self) -> dict:
        """The pipeline's params (the GPT quantized where the pipeline was
        built with `quantize`). Setting them drops the programs built so
        far."""
        return self._params

    @params.setter
    def params(self, params: dict) -> None:
        self._params = params
        gpt = params["gpt"]
        self.device = gpt["text_embed"].device
        self.dtype = gpt["text_embed"].dtype
        self._drop()

    def _drop(self) -> None:
        self._enc_cache.clear()
        self._dec_cache.clear()
        self._voc_cache.clear()

    def _programs(self) -> None:
        """Drop the programs where a tensor they read was replaced, moved or
        cast since they were built (`weights_key`)."""
        key = weights_key(self.params)
        if key != self._weights:
            self._drop()
            self._weights = key

    # -------------------------------------------------- reference encoding

    def _encode_body(self, audio: torch.Tensor) -> tuple:
        """The encode program's body: the bucket's audio (1, N) fp32 ->
        (conds_latent (1, L, D), cond_embed (1, 1, C0), *conds)."""
        p, cfg = self.params, self.cfg
        mel = self.melspec(audio)                                       # (1, T, M) fp32
        conds_latent = perceiver_resample(
            p["perceiver"], conformer_encoder(p["conformer"], mel, cfg), cfg)
        spk = ecapa_speaker_encoder(p["ecapa"], mel, cfg)
        cond_embed = torch.matmul(spk, p["cond_layer"]["w"]) + p["cond_layer"]["b"]
        return (conds_latent, cond_embed,
                *(torch.matmul(spk, c["w"]) + c["b"] for c in p["conds"]))

    @torch.no_grad()
    def encode_reference(self, audio: np.ndarray):
        """audio: int16 or float mono at sample_rate. Returns the device
        tuple (conds_latent (1, L, D), cond_embed (1, 1, C0), conds), from
        the encode program of the padded audio's bucket."""
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        rng = np.random.default_rng(self.seed)
        pad = rng.standard_normal(int(self.sample_rate * 0.1)).astype(np.float32)
        audio = np.concatenate([pad, audio.reshape(-1).astype(np.float32)])
        bucket = max(1, -(-len(audio) // ENC_BUCKET)) * ENC_BUCKET
        audio = np.pad(audio, (0, bucket - len(audio)))[None]
        self._programs()
        if bucket not in self._enc_cache:
            self._enc_cache[bucket] = Program(self._encode_body, [((1, bucket), torch.float32)],
                                              self.device, self._pool)
        outs = self._enc_cache[bucket](audio)
        return outs[0], outs[1], list(outs[2:])

    # ------------------------------------------------------------- decode

    @contextmanager
    def _held(self, rows: int, tb: int, max_gen: int, latent_dtype, batch: bool = False):
        """A `_Decode` of the key's list (tts_tpu's `_dec_cache[(tb,
        max_gen)]`, or `[("batch", rows, tb, max_gen)]` with `batch`) that no
        other request holds, held for the `with` block: the first free one,
        or a new one where each is held."""
        mel_positions = self.params["gpt"]["mel_pos"].shape[0]
        if max_gen > mel_positions:
            # tts_tpu's gather clamps a position past the table; here it raises
            raise ValueError(f"max_gen {max_gen} exceeds the {mel_positions} mel positions")
        self._programs()
        key = ("batch", rows, tb, max_gen) if batch else (tb, max_gen)
        decs = self._dec_cache.setdefault(key, [])
        for dec in list(decs):
            if dec.lock.acquire(blocking=False):
                break
        else:
            dec = _Decode(self, rows, tb, max_gen, latent_dtype)
            dec.lock.acquire()
            decs.append(dec)
        try:
            yield dec
        finally:
            dec.lock.release()

    def _decode(self, conds_latent, text_ids: np.ndarray, text_len: np.ndarray,
                max_gen: int):
        """B rows of greedy decode with the repetition penalty through the
        decode programs (one request's key for one row, a batch's for more).
        Returns (hiddens (B, max_gen, D), done (B,) host ints: tokens kept
        per row, the token ids (B, max_gen)), copies of the state's."""
        bsz = text_ids.shape[0]
        with self._held(bsz, text_ids.shape[1], max_gen, conds_latent.dtype,
                        batch=bsz > 1) as dec:
            done = dec.decode(conds_latent, text_ids, text_len)
            return dec.hiddens.clone(), done, dec.save.clone()

    # ------------------------------------------------------------- vocode

    def _vocode_body(self, h: torch.Tensor, n: torch.Tensor, cond_embed: torch.Tensor,
                     *conds) -> tuple:
        """h (rows, fb, D), n (rows,) frames kept -> (int16 (rows, fb *
        total_upsample),): rows past each row's frame count zeroed,
        final_norm, the conditioned BigVGAN."""
        h = h * (torch.arange(h.shape[1], device=h.device)[None, :] < n[:, None])[..., None]
        latent = gpt_final_norm(self.params["gpt"], h)
        wav = bigvgan_apply(self.params["bigvgan"], latent, self.vcfg, conds=list(conds),
                            cond_embed=cond_embed)
        return (to_pcm16(torch.clamp(wav, -1.0, 1.0) * 32767.0),)

    def _vocode(self, hiddens: torch.Tensor, frames: list[int], fb: int,
                cond_embed: torch.Tensor, conds: list) -> torch.Tensor:
        """The vocode body run eagerly (the slot server's call): hiddens
        (n, >= fb, D) -> int16 (n, fb * total_upsample)."""
        return self._vocode_body(hiddens[:, :fb], torch.tensor(frames, device=self.device),
                                 cond_embed, *conds)[0]

    def _vocoder(self, fb: int, nlive: int | None, cond_embed: torch.Tensor,
                 conds: list) -> Program:
        """The vocode program of fb frames (tts_tpu's `_voc_cache[fb]`, or
        `[("batch", fb, nlive)]`): the hiddens (rows, fb, D), each row's
        frames kept (rows,) int32, cond_embed (rows, 1, C0) and each stage's
        conds (rows, 1, C_i) -> (int16 waveforms,)."""
        self._programs()
        key = fb if nlive is None else ("batch", fb, nlive)
        if key not in self._voc_cache:
            rows = 1 if nlive is None else nlive
            specs = [((rows, fb, self.cfg.gpt_dim), self.dtype), ((rows,), torch.int32)] + [
                ((rows,) + tuple(c.shape[1:]), c.dtype) for c in (cond_embed, *conds)]
            self._voc_cache[key] = Program(self._vocode_body, specs, self.device, self._pool)
        return self._voc_cache[key]

    def _frame_bucket(self, n_frames: int, max_gen: int) -> int:
        return min(max(8, -(-n_frames // 8) * 8), max_gen)

    # ------------------------------------------------------------- public

    @torch.no_grad()
    def synthesize_ids(self, text_ids: np.ndarray, ref, max_gen: int | None = None
                       ) -> tuple[np.ndarray, IndexTTSStats]:
        """text_ids (1, T) BPE ids; ref = encode_reference(...)."""
        conds_latent, cond_embed, conds = ref
        max_gen = max_gen or self.cfg.max_mel_tokens
        tlen = text_ids.shape[1]
        tb = max(16, -(-tlen // 16) * 16)
        ids = np.zeros((1, tb), np.int32)
        ids[0, :tlen] = text_ids[0]
        t0 = time.perf_counter()
        with self._held(1, tb, max_gen, conds_latent.dtype) as dec:
            num = int(dec.decode(conds_latent, ids, np.array([tlen]))[0])
            # the last 2 collected hiddens are dropped (the reference's latent[:-2])
            n_frames = max(num - 2, 0)
            if n_frames == 0:
                return np.zeros(0, np.int16), IndexTTSStats(num, 0.0)
            fb = self._frame_bucket(n_frames, max_gen)
            (wav,) = self._vocoder(fb, None, cond_embed, conds)(
                dec.hiddens[:, :fb], np.array([n_frames], np.int32), cond_embed, *conds)
        wav = wav[0, :n_frames * self.vcfg.total_upsample].cpu().numpy()
        return wav, IndexTTSStats(num, time.perf_counter() - t0)

    @torch.no_grad()
    def synthesize_ids_batch(self, requests: list[tuple[np.ndarray, tuple]],
                             max_gen: int | None = None) -> tuple[list[np.ndarray], dict]:
        """B (text_ids, ref) requests decoded together (per-row kv masks and
        stop tracking), then one vocoder call over the live rows. Returns
        (int16 waveforms, {"tokens", "wall_s", "tokens_per_s"})."""
        bsz = len(requests)
        max_gen = max_gen or self.cfg.max_mel_tokens
        tb = max(16, -(-max(t.shape[1] for t, _ in requests) // 16) * 16)
        ids = np.zeros((bsz, tb), np.int32)
        tlens = np.zeros((bsz,), np.int32)
        for b, (t, _) in enumerate(requests):
            ids[b, :t.shape[1]] = t[0]
            tlens[b] = t.shape[1]
        conds_latent = torch.cat([ref[0] for _, ref in requests], dim=0)
        t0 = time.perf_counter()
        wavs = [np.zeros(0, np.int16)] * bsz
        with self._held(bsz, tb, max_gen, conds_latent.dtype, batch=True) as dec:
            done = dec.decode(conds_latent, ids, tlens)
            frames = [max(int(d) - 2, 0) for d in done]
            live = [b for b in range(bsz) if frames[b] > 0]
            if live:
                fb = self._frame_bucket(max(frames[b] for b in live), max_gen)
                refs = [requests[b][1] for b in live]
                cond_embed = torch.cat([r[1] for r in refs], dim=0)
                conds = [torch.cat([r[2][i] for r in refs], dim=0)
                         for i in range(len(refs[0][2]))]
                rows = torch.tensor(live, device=self.device)
                (wav,) = self._vocoder(fb, len(live), cond_embed, conds)(
                    dec.hiddens.index_select(0, rows)[:, :fb],
                    np.array([frames[b] for b in live], np.int32), cond_embed, *conds)
        if live:
            wav = wav.cpu().numpy()
            up = self.vcfg.total_upsample
            for i, b in enumerate(live):
                wavs[b] = wav[i, :frames[b] * up]
        wall = time.perf_counter() - t0
        total = int(done.sum())
        return wavs, {"tokens": total, "wall_s": wall,
                      "tokens_per_s": total / max(wall, 1e-9)}

    def synthesize(self, text: str, ref, tokenizer=None, max_gen: int | None = None,
                   separator_ms: float = 200.0) -> tuple[np.ndarray, list[IndexTTSStats]]:
        """Text path: normalize, tokenize, split into sentences, one
        `synthesize_ids` a sentence, each followed by separator_ms of silence
        (200 ms, as the reference's Export_IndexTTS.py:1127-1216)."""
        from ..frontend.indextts_text import IndexTTSTokenizer, split_sentences

        tok = tokenizer or IndexTTSTokenizer()
        sentences = split_sentences(tok.tokenize(text))
        blank = np.zeros(int(self.sample_rate * separator_ms / 1000), np.int16)
        wavs, stats = [], []
        for sent in sentences:
            ids = np.array([tok.convert_tokens_to_ids(sent)], np.int32)
            wav, st = self.synthesize_ids(ids, ref, max_gen=max_gen)
            wavs.extend([wav, blank])
            stats.append(st)
        return (np.concatenate(wavs) if wavs else np.zeros(0, np.int16), stats)
