"""Qwen3-TTS synthesis: the two-level talker / code-predictor decode and the
12 Hz codec (counterpart of tts_tpu/runtime/qwen.py:QwenTTSPipeline,
without `mesh`, which is not ported yet): the custom_voice and voice_clone
prefills, one request, a batch, and a stream of audio chunks.

A frame step, as in tts_tpu's while-loop body: talker logits (codec head,
suppress bias, repetition penalty) -> greedy group-0 token -> the
predictor's 15 groups (greedy or beam) -> the next talker input (the
group embeddings and the trailing text) -> one talker step. The EOS frame
is computed and dropped, as in tts_tpu.

tts_tpu jits a request into one program per bucket: the talker prefill
over the MAX_PREFILL bucket (one pass, then the cache rewound to the true
length), a `lax.while_loop` of frame steps and the codec, cached in
`_decode_fn[tb]` (tb: the trailing text's bucket), `_batch_fns[("batch", B,
pmax, tb)]` for a batch, `_codec_cache[(fb, "dev", nlive)]` for the codec,
and for a stream `_prefill_fn` with `_codec_cache[("chunk", chunk, tb)]`
and the window codec `_codec_cache[window]`. The port keeps those keys. A
decode key holds a `_Decode`: two `runtime.program.Program`s over a state
that lives on the device (the talker's KV cache with its length as a device
int32 and `kv_max` rows, the hidden state, the frames, the group-0 history,
the count, the stop flags), on a card each a CUDA graph on the pipeline's
`GraphPool`:
  * a prefill program over the prefill bucket, which resets the state and
    runs the prefill and the rewind on the device;
  * a step program, whose replay runs one frame step; every state write
    is masked by a device flag `go`, tts_tpu's exact `(~fin) & (num <
    max_frames)` (a batch: not every row finished), so a replay past the
    stop is a frozen frame, which still launches its kernels.
The talker's attention reads the device length itself (kernel 12's device
form on the default route, kernel 13's on "all" / "attn", the plain
masked chain over the cache's `kv_max` rows elsewhere); the predictor's
positions 0..16 are the same every frame, so its steps stay host-indexed
inside the graph. The host replays the step program until the stop flag,
read with the count through `program.replay_ahead` (one replay queued
ahead of the read: after an EOS one frozen frame runs); at the max_frames
cap it queues exactly max_frames replays. A frame for which the cache has
no row freezes the request, and the host raises afterwards, as the
host-driven loop raised at that frame. The codec programs take the
frames on the device (frames past a row's count zeroed); a stream copies
the kept frames to the host a chunk of `chunk_frames` at a time, after it
read the count and the flag, and runs each window of `window` frames (its
last frame repeated to fill it, none zeroed) through the window codec,
assembled by runtime/streaming.ChunkedCodecStream. On the CPU every
program runs its body eagerly, on the same state.

A decode key holds a list of `_Decode`s, each one request's while it
runs: a request takes a free one or builds another, so requests in
threads, and streams of one bucket consumed in turn, each decode on a
state of their own (tts_tpu's programs are functional and allow both).

The cache bucket is tts_tpu's: kv_max = min(max_seq_len, ceil((512 +
max_frames + 1) / 128) * 128), 640 rows at max_frames = 120 (where kernel
13's gate, 256 | T, fails and "attn"/"all" take the plain chain on the
talker) and 768 at 128. The codec decodes a bucket of fb = min(max(8,
ceil(frames / 8) * 8), max_frames) frames with the frames past the
generated ones zeroed: its pre-transformer attends both ways, so the
bucket is part of the output.

Voice clone: `encode_reference` gives the reference's Mimi codes (the
whole 19,200-sample bucket) and its x-vector; `build_prefill_voice_clone`
lays them out with the text, on the device in fp32.
"""
from __future__ import annotations

import threading
import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..audio.wav import to_pcm16
from ..decoding.sampling import apply_repetition_penalty
from ..kv.cache import KVCache
from ..models.qwen_codec import QwenCodecDecoderConfig, codec_decode
from ..models.qwen_encoder import mimi_encode, rvq_encode
from ..models.qwen_tts import (QwenTTSConfig, next_talker_input, next_talker_input_batch,
                               predictor_frame, predictor_frame_beam,
                               predictor_frame_beam_batch, qwen3_stack_step,
                               talker_logits)
from .program import GraphPool, HostSlots, Program, replay_ahead, weights_key

__all__ = ["QwenTTSPipeline", "QwenDecodeConfig", "LANGUAGE_ID_MAP", "SPEAKER_ID_MAP",
           "resolve_voice", "MAX_PREFILL"]

# token ids from the Qwen3-TTS checkpoint's talker_config
LANGUAGE_ID_MAP = {
    "english": 2050, "german": 2053, "spanish": 2054, "chinese": 2055,
    "japanese": 2058, "french": 2061, "korean": 2064, "russian": 2069,
    "italian": 2070, "portuguese": 2071,
}
SPEAKER_ID_MAP = {
    "serena": 3066, "vivian": 3065, "uncle_fu": 3010, "ryan": 3061,
    "aiden": 2861, "ono_anna": 2873, "sohee": 2864, "eric": 2875,
    "dylan": 2878,
}
# speakers locked to a dialect language id (custom_voice mode)
_SPEAKER_DIALECT = {"eric": 2062, "dylan": 2074}   # sichuan / beijing

MAX_PREFILL = 512


def resolve_voice(language: str, speaker: str | None = None) -> tuple[int, int | None]:
    """(language name, optional speaker name) -> (language_id, speaker_id),
    with the per-speaker dialect override."""
    lang_id = LANGUAGE_ID_MAP[language.lower()]
    spk_id = None
    if speaker is not None:
        key = speaker.lower()
        spk_id = SPEAKER_ID_MAP[key]
        lang_id = _SPEAKER_DIALECT.get(key, lang_id)
    return lang_id, spk_id


def _check_special_ids(vocab: int, cfg: QwenTTSConfig) -> None:
    """Fail loudly if the text-embedding table cannot hold the special ids."""
    for name in ("tts_bos_token_id", "tts_eos_token_id", "tts_pad_token_id"):
        tid = getattr(cfg, name)
        if not 0 <= tid < vocab:
            raise ValueError(
                f"{name}={tid} is out of range for the loaded text embedding "
                f"table (vocab={vocab}); the checkpoint and config disagree")


@dataclass(frozen=True)
class QwenDecodeConfig:
    max_frames: int = 600
    repeat_penalty: float = 0.9
    penalty_range: int = 10
    # predictor beam search; degenerate settings fall back to greedy with a
    # warning at pipeline construction
    use_beam: bool = False
    beam_size: int = 3
    beam_top_k: int = 3
    # decode routes of models/qwen_tts.qwen3_stack_step. None = "step"
    # (kernel 12) on every device; True = the qkv head (kernel 11); "attn",
    # "all", "mlp", "mlp_q8" add kernels 13, 14 or 15; False = plain ops.
    # "step" degrades per call where its gate fails (beam and batch rows).
    fused_decode: bool | str | None = None


class _Decode:
    """One decode bucket's programs and the device state they share: the
    counterpart of one jitted `run` of tts_tpu's `_decode_fn[tb]` or of the
    stream's `_prefill_fn` and chunk program (`kind` "solo": one request,
    the predictor greedy or beam) or of `_batch_fns[("batch", B, pmax, tb)]`
    ("batch"), for `rows` talker rows (1 or B), a prefill bucket of `s_buf`
    rows and a trailing bucket of `tb`.

    `prefill` is the prefill program: prefill (rows, s_buf, H) fp32, the
    prefill length () (a batch: each row's pad start (rows,)) int32, the
    trailing text (rows, tb, H) fp32. `step` is the program of one frame
    step. Each returns `outs`: the stop flag, the count and (solo) the EOS
    flag, and the overflow flag. `state` lists every tensor they update. A
    request holds `lock` from its prefill to its last read of the state
    (`QwenTTSPipeline._held`)."""

    def __init__(self, pipe: "QwenTTSPipeline", kind: str, rows: int, s_buf: int, tb: int):
        cfg, dcfg, dev, dt = pipe.cfg, pipe.dcfg, pipe.device, pipe.dtype
        t = cfg.talker
        self.pipe, self.kind, self.rows, self.tb = pipe, kind, rows, tb
        self.kv_max = pipe._kv_max(s_buf)
        shape = (t.num_layers, rows, t.num_kv_heads, self.kv_max, t.head_dim)
        self.k = torch.zeros(shape, dtype=dt, device=dev)
        self.v = torch.zeros(shape, dtype=dt, device=dev)

        def i32(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        def flag(*shape):
            return torch.zeros(shape, dtype=torch.bool, device=dev)

        # pos: the talker cache's length; num: frames computed; fin: EOS came
        # (each row's, in a batch); done: a batch row's EOS frame; over: a
        # frame found no cache row; stop: the loop's exit
        self.pos, self.num = i32(), i32()
        self.hid = torch.zeros((rows, t.hidden_size), dtype=dt, device=dev)
        self.tr = torch.zeros((rows, tb, t.hidden_size), dtype=dt, device=dev)
        self.frames = i32(rows, dcfg.max_frames, cfg.num_code_groups)
        self.save0 = i32(rows, dcfg.max_frames)
        self.fin = flag(rows) if kind == "batch" else flag()
        self.done = i32(rows)
        # a batch's key validity: its prompts are right-justified in the bucket
        self.kv_valid = flag(rows, self.kv_max) if kind == "batch" else None
        self.over, self.stop = flag(), flag()
        self.state = tuple(x for x in (
            self.k, self.v, self.pos, self.num, self.hid, self.tr, self.frames, self.save0,
            self.fin, self.done, self.kv_valid, self.over, self.stop) if x is not None)
        self.outs = ((self.stop, self.num, self.over) if kind == "batch"
                     else (self.stop, self.num, self.fin, self.over))
        lens = ((rows,), torch.int32) if kind == "batch" else ((), torch.int32)
        self.prefill = Program(self._prefill_body, [
            ((rows, s_buf, t.hidden_size), torch.float32), lens,
            ((rows, tb, t.hidden_size), torch.float32)], dev, pipe._pool, self.state)
        self.step = Program(self._one_frame, [], dev, pipe._pool, self.state)
        # the host's two slots of outs: one replay runs ahead of the read
        self._slots = HostSlots(self.outs, dev)
        self.lock = threading.Lock()

    # ------------------------------------------------------------ programs

    def _prefill_body(self, buf, lens, trailing) -> tuple:
        p, cfg, t = self.pipe.params, self.pipe.cfg, self.pipe.cfg.talker
        dt, s_buf = self.pipe.dtype, buf.shape[1]
        for x in (self.k, self.v, self.num, self.frames, self.save0, self.fin, self.over):
            x.zero_()
        kv = KVCache(self.k, self.v, 0)
        rope = p["rope_cos"][:s_buf], p["rope_sin"][:s_buf]
        if self.kind == "batch":
            # prompts right-justified in the bucket; lens: each row's pad start
            valid = torch.arange(s_buf, device=buf.device)[None, :] >= lens[:, None]
            self.kv_valid.copy_(torch.arange(self.kv_max, device=buf.device)[None, :]
                                >= lens[:, None])
            hid_all, _ = qwen3_stack_step(p["talker"], buf.to(dt) * valid[..., None], kv, t,
                                          *rope, kv_valid=self.kv_valid, return_all=True)
            self.hid.copy_(hid_all[:, -1])
            self.pos.fill_(s_buf)
            self.done.fill_(self.pipe.dcfg.max_frames)
        else:
            # one pass over the bucket, then the rewind to the true length:
            # the frames append there and overwrite the padded rows
            hid_all, _ = qwen3_stack_step(p["talker"], buf.to(dt), kv, t, *rope,
                                          return_all=True)
            self.hid.copy_(hid_all.index_select(1, (lens.long() - 1).reshape(1))[:, 0])
            self.pos.copy_(lens)
        self.tr.copy_(trailing)
        self._set_stop()
        return self.outs

    def _set_stop(self) -> None:
        fin = self.fin.all() if self.kind == "batch" else self.fin
        self.stop.copy_(fin | (self.num >= self.pipe.dcfg.max_frames) | self.over)

    def _one_frame(self) -> tuple:
        """One frame step of tts_tpu's while-loop body, applied only while
        its condition holds (`go`); otherwise a frozen frame."""
        pipe, cfg, dcfg = self.pipe, self.pipe.cfg, self.pipe.dcfg
        p, batch = pipe.params, self.kind == "batch"
        active = ~(self.fin.all() if batch else self.fin) & (self.num < dcfg.max_frames)
        go = active & (self.pos < self.kv_max)
        self.over.copy_(self.over | (active & ~go))
        logits = pipe._penalized(talker_logits(p, self.hid, cfg), self.save0, self.num)
        tok0 = torch.argmax(logits, dim=-1).to(torch.int32)                    # (rows,)
        gather = self.num.clamp(max=self.tb - 1)
        if batch:
            newly = (tok0 == cfg.codec_eos_token_id) & ~self.fin & go
            self.done.copy_(torch.where(newly, self.num, self.done))
            self.fin.copy_(self.fin | newly)
            tok0 = torch.where(self.fin, cfg.codec_pad_id, tok0).to(torch.int32)
            frame_ids, ce0 = pipe._predictor_batch(self.hid[:, None], tok0, self.rows)
            nxt = next_talker_input_batch(p, frame_ids, ce0, self.tr,
                                          gather.expand(self.rows), cfg)
        else:
            newly = go & (tok0[0] == cfg.codec_eos_token_id)
            frame_ids, ce0 = pipe._predictor(self.hid[:, None], tok0)
            nxt = next_talker_input(p, frame_ids, ce0, self.tr, gather, cfg)
            frame_ids = frame_ids[None]
        at = self.num.clamp(max=dcfg.max_frames - 1).long().reshape(1)
        self.save0.index_copy_(1, at, torch.where(go, tok0[:, None],
                                                  self.save0.index_select(1, at)))
        self.frames.index_copy_(1, at, torch.where(go, frame_ids[:, None],
                                                   self.frames.index_select(1, at)))
        # a frozen frame's talker step writes row pos, which no kept row is
        pos = self.pos.clamp(max=self.kv_max - 1)
        h, _ = qwen3_stack_step(p["talker"], nxt, KVCache(self.k, self.v, pos, self.kv_max),
                                cfg.talker, *pipe._rope(pos), kv_valid=self.kv_valid,
                                fused=pipe._fused)
        self.hid.copy_(torch.where(go, h, self.hid))
        if not batch:
            self.fin.copy_(self.fin | newly)
        step = go.to(torch.int32)
        self.num.add_(step)
        self.pos.add_(step)
        self._set_stop()
        return self.outs

    # ---------------------------------------------------------------- host

    def replays(self, buf, lens, trailing):
        """The prefill, then at most max_frames replays of the step program:
        yields the host values of `outs` after the prefill and after each
        replay, each replay queued before the host reads the one before it.
        The caller stops at the stop flag; past it at most one frozen frame
        runs."""
        yield from replay_ahead(self._slots, self.prefill(buf, lens, trailing), self.step,
                                self.pipe.dcfg.max_frames)

    def decode(self, buf, lens, trailing) -> list:
        """Runs `replays` to the stop flag; returns the last values read
        (stop, count, ...), and raises where a frame found no cache row."""
        for vals in self.replays(buf, lens, trailing):
            if vals[0]:
                break
        self.check(vals)
        return vals

    def check(self, vals) -> None:
        if vals[-1]:
            raise ValueError(f"cache of {self.kv_max} rows cannot take the next talker step")


class QwenTTSPipeline:
    """Qwen3-TTS over the merged talker + predictor params dict and the
    codec decoder's (tts_tpu's layouts, e.g. from
    `weights.convert.params_from_jax` or the models' init functions). Runs
    on the device the params are on, through the programs of the module's
    docstring."""

    # the 12 Hz codec's rate: tts_tpu's pipeline takes an output_sample_rate
    # argument but resamples nothing with it, so the port keeps the constant
    output_sample_rate = 24000
    # the reference audio's bucket for the Mimi encoder: 0.8 s at 24 kHz
    REF_BUCKET = 19200

    def __init__(self, params: dict, cfg: QwenTTSConfig, codec_params: dict,
                 codec_cfg: QwenCodecDecoderConfig,
                 decode_cfg: QwenDecodeConfig | None = None, quantize: int | None = None):
        if quantize not in (None, 4, 8):
            raise ValueError(f"quantize must be None, 4 or 8, got {quantize!r}")
        if quantize:
            # int8 or int4 on the talker and predictor matmuls; lm_heads,
            # group_embeds, codec_head and the codec stay float
            from ..quant.weight_only import quantize_pytree

            params = quantize_pytree(params, bits=quantize)
        # the programs, keyed as tts_tpu's (the module's docstring); on a
        # card their graphs share one memory pool
        self._decode_fn: dict = {}
        self._batch_fns: dict = {}
        self._codec_cache: dict = {}
        self._pool = GraphPool()
        self._weights = None
        self.params = params
        self.cfg = cfg
        self.codec_params = codec_params
        self.codec_cfg = codec_cfg
        self.dcfg = decode_cfg or QwenDecodeConfig()
        if self.dcfg.use_beam and (self.dcfg.beam_size < 2 or self.dcfg.beam_top_k < 1):
            warnings.warn(f"degenerate beam settings (beam_size={self.dcfg.beam_size}, "
                          f"top_k={self.dcfg.beam_top_k}); using greedy", stacklevel=2)
            self.dcfg = replace(self.dcfg, use_beam=False)
        fd = self.dcfg.fused_decode
        self._fused = "step" if fd is None else fd

    @property
    def params(self) -> dict:
        """The talker's and predictor's params (quantized where the pipeline
        was built with `quantize`). Setting them drops the programs built so
        far."""
        return self._params

    @params.setter
    def params(self, params: dict) -> None:
        self._params = params
        self.device = params["talker_codec_embed"].device
        self.dtype = params["talker_codec_embed"].dtype
        self._drop()

    @property
    def codec_params(self) -> dict:
        """The codec decoder's params. Setting them drops the programs."""
        return self._codec_params

    @codec_params.setter
    def codec_params(self, params: dict) -> None:
        self._codec_params = params
        self._drop()

    def _drop(self) -> None:
        self._decode_fn.clear()
        self._batch_fns.clear()
        self._codec_cache.clear()

    def _programs(self) -> None:
        """Drop the programs where a tensor they read was replaced, moved or
        cast since they were built (`weights_key`)."""
        key = weights_key(self.params, self.codec_params)
        if key != self._weights:
            self._drop()
            self._weights = key

    # ------------------------------------------------------------- prefill

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def _text_embed(self, ids) -> torch.Tensor:
        """Text ids (1, T) -> their projected embeddings (1, T, H), gathered
        on the device, projected in fp32."""
        p = self.params
        e = p["text_embed"][self._ids(ids)].float()
        return torch.matmul(e, p["text_proj_w"].float()) + p["text_proj_b"].float()

    def _codec_embed(self, ids) -> torch.Tensor:
        return self.params["talker_codec_embed"][self._ids(ids)].float()

    def _tts_specials(self) -> tuple:
        """(tts_bos, tts_eos, tts_pad) embeddings, each (1, 1, H)."""
        cfg = self.cfg
        _check_special_ids(self.params["text_embed"].shape[0], cfg)
        return self._text_embed([[cfg.tts_bos_token_id, cfg.tts_eos_token_id,
                                  cfg.tts_pad_token_id]]).split(1, 1)

    def build_prefill_embeds(self, text_ids: np.ndarray, language_id: int,
                             speaker_id: int | None = None,
                             ref_text_ids: np.ndarray | None = None,
                             instruct_ids: np.ndarray | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
        """The talker prefill in the custom_voice layout (codec prefix [think,
        think_bos, language, think_eos, (speaker), pad] with the tts pad/bos
        overlay, then the first text token + codec bos) and the trailing
        text. Gathered on the device, projected in fp32. Returns (prefill
        (1, P, H), trailing (1, Tt, H)), fp32."""
        cfg = self.cfg
        text_embed, codec_embed = self._text_embed, self._codec_embed
        tts_bos, tts_eos, tts_pad = self._tts_specials()
        texts = [text_embed(text_ids), tts_eos]
        if ref_text_ids is not None:
            texts.insert(0, text_embed(ref_text_ids))
        text_seq = torch.cat(texts, dim=1)
        prefix = [cfg.codec_think_id, cfg.codec_think_bos_id, language_id,
                  cfg.codec_think_eos_id]
        if speaker_id is not None:
            prefix.append(speaker_id)
        prefix.append(cfg.codec_pad_id)
        codec_prefix = codec_embed([prefix])
        # tts special-token overlay: pad * (n - 1) + bos aligned on the prefix
        n = codec_prefix.shape[1]
        codec_prefix = codec_prefix + torch.cat([tts_pad.expand(1, n - 1, -1), tts_bos], 1)
        # interleave: the first text token + codec bos starts generation
        first = text_seq[:, :1] + codec_embed([[cfg.codec_bos_id]])
        prefill = torch.cat([codec_prefix, first], dim=1)
        if instruct_ids is not None:
            prefill = torch.cat([text_embed(instruct_ids), prefill], dim=1)
        trailing = torch.cat([text_seq[:, 1:], tts_pad], dim=1)
        return prefill, trailing

    @torch.no_grad()
    def encode_reference(self, audio: np.ndarray, encoder_params: dict, encoder_cfg,
                         speaker_params: dict | None = None, speaker_cfg=None, mel=None):
        """The voice_clone prompt side: 24 kHz mono audio (int16, or float in
        [-1, 1]) -> (ref_codes (T, groups) int32, the codes of the whole
        REF_BUCKET-padded input; speaker_embed (1, 1, H) or None), on the
        encoder params' device. The speaker mel is `mel` or the slaney
        128-band log-mel (n_fft 1024, hop 256, constant centre pad, log(mel +
        1e-5)) over the padded bucket; the ECAPA variant is told by the
        params (no "bn" entries: Qwen's reflect-padded form, no std clip)."""
        from ..audio.mel import MelSpectrogram
        from ..models.indextts import ecapa_speaker_encoder

        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        audio = np.asarray(audio, np.float32).reshape(-1)
        bucket = max(1, -(-len(audio) // self.REF_BUCKET)) * self.REF_BUCKET
        dev = encoder_params["pre"]["w"].device
        buf = torch.as_tensor(np.pad(audio, (0, bucket - len(audio)))[None], device=dev)
        emb = mimi_encode(encoder_params, buf, encoder_cfg)
        codes = rvq_encode(encoder_params, emb, encoder_cfg, self.cfg.num_code_groups)[0]
        spk = None
        if speaker_params is not None:
            if mel is None:
                mel = MelSpectrogram(24000, 1024, 256, 1024, 128, mel_scale="slaney",
                                     norm="slaney", pad_mode="constant", log_mode="add")
            qwen_variant = "bn" not in speaker_params["block0"]
            spk = ecapa_speaker_encoder(speaker_params, mel(buf), speaker_cfg,
                                        reflect_pad=qwen_variant,
                                        std_clip=None if qwen_variant else 1e-6)
        return codes, spk

    @torch.no_grad()
    def build_prefill_voice_clone(self, text_ids: np.ndarray, ref_text_ids: np.ndarray,
                                  language_id: int, ref_codes, speaker_embed
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """The voice_clone layout: the codec prefix [think, think_bos,
        language, think_eos, speaker_embed, pad] with the tts pad/bos
        overlay, then the in-context run: text (reference text, target text,
        tts_eos, padded with tts_pad to the codec run) summed with [codec
        bos, the reference frames], each frame the talker's group-0 table
        plus the 15 group tables; the text past the codec run trails.
        ref_codes (T, groups) and speaker_embed (1, 1, H), numpy or tensors.
        On the device in fp32. Returns (prefill (1, P, H), trailing (1, Tt,
        H))."""
        p, cfg, dev = self.params, self.cfg, self.device
        text_embed, codec_embed = self._text_embed, self._codec_embed
        tts_bos, tts_eos, tts_pad = self._tts_specials()
        codes = torch.as_tensor(ref_codes, device=dev).long()
        ref = p["talker_codec_embed"][codes[:, 0]].float()
        for g in range(cfg.num_code_groups - 1):
            ref = ref + p["group_embeds"][g][codes[:, g + 1]].float()
        codec_seq = torch.cat([codec_embed([[cfg.codec_bos_id]]), ref[None]], dim=1)
        codec_len = codec_seq.shape[1]
        text_seq = torch.cat([text_embed(ref_text_ids), text_embed(text_ids), tts_eos], dim=1)
        if text_seq.shape[1] < codec_len:
            text_seq = torch.cat(
                [text_seq, tts_pad.expand(1, codec_len - text_seq.shape[1], -1)], dim=1)
        prefix = torch.cat([
            codec_embed([[cfg.codec_think_id, cfg.codec_think_bos_id, language_id,
                          cfg.codec_think_eos_id]]),
            torch.as_tensor(speaker_embed, device=dev).float().reshape(1, 1, -1),
            codec_embed([[cfg.codec_pad_id]])], dim=1)
        n = prefix.shape[1]
        prefix = prefix + torch.cat([tts_pad.expand(1, n - 1, -1), tts_bos], dim=1)
        prefill = torch.cat([prefix, text_seq[:, :codec_len] + codec_seq], dim=1)
        trailing = torch.cat([text_seq[:, codec_len:], tts_pad], dim=1)
        return prefill, trailing

    # -------------------------------------------------------------- decode

    def _kv_max(self, prefill_rows: int) -> int:
        t = self.cfg.talker
        return min(t.max_seq_len,
                   -(-(prefill_rows + self.dcfg.max_frames + 1) // 128) * 128)

    def _penalized(self, logits: torch.Tensor, save0: torch.Tensor, num):
        d = self.dcfg
        if d.repeat_penalty == 1.0:
            return logits
        return apply_repetition_penalty(logits, save0, num, d.repeat_penalty,
                                        d.penalty_range)

    def _predictor(self, hid: torch.Tensor, tok0: torch.Tensor):
        d = self.dcfg
        if d.use_beam:
            return predictor_frame_beam(self.params, hid, tok0, self.cfg, d.beam_size,
                                        d.beam_top_k, d.repeat_penalty, d.penalty_range,
                                        fused=self._fused)
        return predictor_frame(self.params, hid, tok0, self.cfg, d.repeat_penalty,
                               d.penalty_range, fused=self._fused)

    def _predictor_batch(self, hid: torch.Tensor, tok0: torch.Tensor, bsz: int):
        d = self.dcfg
        if d.use_beam:
            return predictor_frame_beam_batch(self.params, hid, tok0, self.cfg, d.beam_size,
                                              d.beam_top_k, d.repeat_penalty,
                                              d.penalty_range, fused=self._fused)
        frame_ids, ce0 = predictor_frame(self.params, hid, tok0, self.cfg,
                                         d.repeat_penalty, d.penalty_range,
                                         fused=self._fused)
        return frame_ids.reshape(bsz, self.cfg.num_code_groups), ce0

    def _rope(self, pos) -> tuple:
        """The talker's RoPE rows of position pos: sliced at a host int,
        gathered at a 0-dim device tensor."""
        p = self.params
        if isinstance(pos, torch.Tensor):
            idx = pos.reshape(1).long()
            return p["rope_cos"].index_select(0, idx), p["rope_sin"].index_select(0, idx)
        return p["rope_cos"][pos:pos + 1], p["rope_sin"][pos:pos + 1]

    @contextmanager
    def _held(self, table: dict, key, kind: str, rows: int, s_buf: int, tb: int):
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
            dec = _Decode(self, kind, rows, s_buf, tb)
            dec.lock.acquire()
            decs.append(dec)
        try:
            yield dec
        finally:
            dec.lock.release()

    def _solo(self, tb: int):
        """A request's decode programs for trailing bucket tb (tts_tpu's
        `_decode_fn[tb]`), held (`_held`)."""
        return self._held(self._decode_fn, tb, "solo", 1, MAX_PREFILL, tb)

    def _batch(self, bsz: int, pmax: int, tb: int):
        """A batch's decode programs (tts_tpu's `_batch_fns[("batch", B,
        pmax, tb)]`), held."""
        return self._held(self._batch_fns, ("batch", bsz, pmax, tb), "batch", bsz, pmax, tb)

    def _stream(self, chunk: int, tb: int):
        """A stream's decode programs (tts_tpu's `_prefill_fn` and
        `_codec_cache[("chunk", chunk, tb)]`): a request's, on states of
        their own, held."""
        return self._held(self._codec_cache, ("chunk", chunk, tb), "solo", 1, MAX_PREFILL, tb)

    def _decode(self, prefill_buf: torch.Tensor, prefill_len: int,
                trailing: torch.Tensor) -> tuple[torch.Tensor, int]:
        """One request through its decode programs. Returns (frames
        (max_frames, G) int32 on the device, frames kept: the EOS frame is
        computed and dropped)."""
        with self._solo(trailing.shape[1]) as dec:
            _, num, fin, _ = dec.decode(prefill_buf, np.int32(prefill_len), trailing)
            return dec.frames[0].clone(), int(num) - int(fin)

    # --------------------------------------------------------------- codec

    def _codec_fb(self, frames: int) -> int:
        return min(max(8, -(-frames // 8) * 8), self.dcfg.max_frames)

    def _vocode(self, frames: torch.Tensor, nfr: torch.Tensor, fb: int):
        """frames (B, >= fb, G), nfr (B,) frames kept -> (int16 waveforms
        (B, fb * total_upsample), max |float waveform|). Frames past a row's
        count are zeroed, as tts_tpu's codec program zeroes them."""
        live = torch.arange(fb, device=frames.device)[None, :] < nfr[:, None]
        codes = frames[:, :fb] * live[..., None]
        wav = codec_decode(self.codec_params, codes, self.codec_cfg)
        return to_pcm16(wav * 32767.0), wav.abs().amax()

    def _codec(self, fb: int, nlive: int | None = None) -> Program:
        """The codec program of fb frames (tts_tpu's `_codec_cache[(fb,
        "dev", nlive)]`, nlive None for one request): frames (rows,
        max_frames, G) int32 on the device, each row's frames kept (rows,)
        int32 -> `_vocode`'s (int16 waveforms, peak)."""
        self._programs()
        key = (fb, "dev", nlive)
        if key not in self._codec_cache:
            rows, g = 1 if nlive is None else nlive, self.cfg.num_code_groups
            self._codec_cache[key] = Program(
                lambda frames, nfr: self._vocode(frames, nfr, fb),
                [((rows, self.dcfg.max_frames, g), torch.int32), ((rows,), torch.int32)],
                self.device, self._pool)
        return self._codec_cache[key]

    # -------------------------------------------------------------- public

    @staticmethod
    def _trailing_bucket(trailing: torch.Tensor) -> int:
        return max(64, -(-trailing.shape[1] // 64) * 64)

    def _trailing_buf(self, trailing: torch.Tensor, tb: int) -> torch.Tensor:
        """(1, Tt, H) -> (1, tb, H): rows past the true length repeat the last
        (pad) embedding, so a gather beyond it returns the pad."""
        pad = trailing[:, -1:].expand(1, tb - trailing.shape[1], -1)
        return torch.cat([trailing, pad], dim=1)

    def _request_bufs(self, prefill, trailing) -> tuple[torch.Tensor, int, torch.Tensor]:
        """(prefill in the MAX_PREFILL bucket, its rows, trailing in its
        bucket), fp32 on the device."""
        prefill = torch.as_tensor(prefill, device=self.device).float()
        trailing = torch.as_tensor(trailing, device=self.device).float()
        p_len = prefill.shape[1]
        if not 1 <= p_len <= MAX_PREFILL:
            raise ValueError(f"prefill of {p_len} rows, the bucket holds {MAX_PREFILL}")
        buf = torch.zeros((1, MAX_PREFILL, prefill.shape[2]), device=self.device)
        buf[:, :p_len] = prefill
        return buf, p_len, self._trailing_buf(trailing, self._trailing_bucket(trailing))

    @torch.no_grad()
    def synthesize_from_prefill(self, prefill, trailing) -> tuple[np.ndarray, dict]:
        """prefill (1, P, H), trailing (1, Tt, H) (from build_prefill_embeds
        or build_prefill_voice_clone; numpy or tensors). Returns (int16
        waveform, {"frames", "wall_s", "frames_per_s", "peak"})."""
        t0 = time.perf_counter()
        buf, p_len, tr = self._request_bufs(prefill, trailing)
        frames, num = self._decode(buf, p_len, tr)
        if num == 0:
            return np.zeros(0, np.int16), {"frames": 0, "wall_s": 0.0}
        wav, peak = self._codec(self._codec_fb(num))(frames[None], np.array([num], np.int32))
        wav = wav[0, :num * self.codec_cfg.total_upsample].cpu().numpy()
        wall = time.perf_counter() - t0
        return wav, {"frames": num, "wall_s": wall, "frames_per_s": num / max(wall, 1e-9),
                     "peak": float(peak)}

    @torch.no_grad()
    def synthesize_from_prefill_batch(self, requests: list) -> tuple[list[np.ndarray], dict]:
        """B (prefill, trailing) requests decoded together (right-justified
        prefills, per-row masks and stops), then the codec over every live
        row at the longest row's frame bucket. Returns (int16 waveforms,
        aggregate stats)."""
        dev = self.device
        reqs = [(torch.as_tensor(p, device=dev).float(), torch.as_tensor(tr, device=dev).float())
                for p, tr in requests]
        bsz, hs = len(reqs), reqs[0][0].shape[2]
        pmax = max(64, -(-max(p.shape[1] for p, _ in reqs) // 64) * 64)
        tb = max(self._trailing_bucket(tr) for _, tr in reqs)
        t0 = time.perf_counter()
        buf = torch.zeros((bsz, pmax, hs), device=dev)
        pad_start = np.array([pmax - p.shape[1] for p, _ in reqs], np.int32)
        for b, (p, _) in enumerate(reqs):
            buf[b, pmax - p.shape[1]:] = p[0]
        tr_buf = torch.cat([self._trailing_buf(tr, tb) for _, tr in reqs], dim=0)
        wavs = [np.zeros(0, np.int16)] * bsz
        peak = 0.0
        with self._batch(bsz, pmax, tb) as dec:
            dec.decode(buf, pad_start, tr_buf)
            # each row's frames kept: to its EOS frame, within the count
            done = torch.clamp(dec.done, max=dec.num)
            nfr = [int(n) for n in done.cpu()]
            live = [b for b in range(bsz) if nfr[b] > 0]
            if live:
                rows = torch.tensor(live, device=dev)
                prog = self._codec(self._codec_fb(max(nfr[b] for b in live)), len(live))
                wav, pk = prog(dec.frames.index_select(0, rows), done.index_select(0, rows))
        if live:
            wav, peak = wav.cpu().numpy(), float(pk)
            up = self.codec_cfg.total_upsample
            for i, b in enumerate(live):
                wavs[b] = wav[i, :nfr[b] * up]
        wall = time.perf_counter() - t0
        total = sum(nfr)
        return wavs, {"frames": total, "wall_s": wall,
                      "frames_per_s": total / max(wall, 1e-9), "peak": peak}

    def _window_body(self, codes: torch.Tensor) -> tuple:
        return (to_pcm16(codec_decode(self.codec_params, codes, self.codec_cfg) * 32767.0),)

    def _codec_window(self, codes: np.ndarray) -> torch.Tensor:
        """A streaming window (1, W, G) of codes -> int16 (1, W * upsample) on
        the device, the codec run at the window's fixed size through its
        program (tts_tpu's `_codec_cache[W]`; the host copy comes a window
        later)."""
        self._programs()
        window = codes.shape[1]
        if window not in self._codec_cache:
            self._codec_cache[window] = Program(
                self._window_body, [((1, window, self.cfg.num_code_groups), torch.int32)],
                self.device, self._pool)
        return self._codec_cache[window](np.asarray(codes, np.int32))[0]

    @torch.no_grad()
    def synthesize_streaming(self, prefill, trailing, chunk_frames: int = 24,
                             window: int = 72, left_context: int = 24):
        """A generator of int16 audio chunks for one request (prefill and
        trailing as synthesize_from_prefill takes them): the frames are those
        of the request's decode programs (replayed on a state of the
        stream's own), copied to the host a chunk of `chunk_frames` at a time
        (the EOS frame dropped) once the count and the stop flag after a
        replay say the chunk is done; each codec window holds `window`
        frames, `left_context` of them already emitted, its audio
        discarded. The chunks together are the 24 kHz waveform of the kept
        frames, pushed where the frame-by-frame loop pushed them: at each
        multiple of chunk_frames, and the rest at the end."""
        from .streaming import ChunkedCodecStream

        buf, p_len, tr = self._request_bufs(prefill, trailing)
        codec = ChunkedCodecStream(self._codec_window, window=window,
                                   left_context=left_context,
                                   upsample=self.codec_cfg.total_upsample,
                                   num_groups=self.cfg.num_code_groups)
        with self._stream(chunk_frames, tr.shape[1]) as dec:
            sent = 0
            for vals in dec.replays(buf, np.int32(p_len), tr):
                dec.check(vals)
                stop, num, fin, _ = vals
                keep = int(num) - int(fin)
                cuts = list(range((sent // chunk_frames + 1) * chunk_frames, keep + 1,
                                  chunk_frames))
                if stop and keep > (cuts[-1] if cuts else sent):
                    cuts.append(keep)
                for cut in cuts:
                    out = codec.push_frames(dec.frames[0, sent:cut].cpu().numpy())
                    sent = cut
                    if out is not None and len(out):
                        yield out
                if stop:
                    break
        for out in codec.finish():
            yield out

    def synthesize_ids(self, text_ids: np.ndarray, language_id: int = 0,
                       speaker_id: int | None = None,
                       instruct_ids: np.ndarray | None = None) -> tuple[np.ndarray, dict]:
        prefill, trailing = self.build_prefill_embeds(text_ids, language_id, speaker_id,
                                                      instruct_ids=instruct_ids)
        return self.synthesize_from_prefill(prefill, trailing)
