"""KaniTTS synthesis: text -> prompt ids -> codec tokens -> waveform
(counterpart of tts_tpu/runtime/kani.py:KaniPipeline, without `mesh`,
which is not ported yet). The tokenizer is the caller's: an
`HFTokenizer` (frontend/hf_tokenizer.py) over the checkpoint's
tokenizer.json, or any callable with transformers' `return_tensors="np"`
surface.

tts_tpu jits a request into one program per bucket: a batched prefill over
the padded prompt bucket, a `lax.while_loop` of decode steps (LM step,
repetition penalty, greedy or beam selection) and the codec epilogue,
cached in `_decode_cache[fbuf]` (`_batch_fns[("batch", B, fbuf)]` for a
batch). The port keeps those keys and builds, for each, a `_Decode`: three
kinds of `runtime.program.Program` over a state that lives on the device
(the KV cache with its length as a device int32, the conv carries, the
token buffer, the decoded count, the last token, the stop flags, the beam's
log-probs), on a card each a CUDA graph on the pipeline's `GraphPool`:
  * a prefill program for each prompt bucket (`_bucket`), which resets the
    state and runs the prefill and the first selection;
  * one step program, whose replay runs STEPS decode steps; a step freezes
    the request (the count, the tokens and the stop flags stop changing)
    once the stop token came (greedy: the token; beam: beam 0's; batch:
    every row's) or the count reached min(cap, buf), so the result is
    tts_tpu's exact `while_loop` stop, and a replay's steps past it are
    frozen steps, which still launch their kernels;
  * a codec program for the bucket's `fbuf` frames: positions past the
    generated frames are the group-base token, and the waveform is cropped
    on the host (the HiFiGAN is causal, so the kept samples equal a compact
    decode's).
The host replays the step program until the stop flag, read once a replay
through a non-blocking copy into pinned memory, is set; it reads each
replay's flag after queueing the next replay, so past a stop one more
replay runs, all frozen (at the cap none: the host counts the replays
min(cap, buf) needs). A step the cache
has no row for freezes the request, and the host raises afterwards, as the
host-driven loop raised at that step. On the CPU every program runs its
body eagerly, on the same state.

Prompt format: [64403] + tokenizer("speaker: text") + [2, 64404]; the codec
reads ids[2:num] as frames of 4 codebook tokens.
"""
from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..audio.wav import to_pcm16
from ..decoding.beam import beam_init, beam_step
from ..decoding.sampling import apply_repetition_penalty, greedy
from ..kv.cache import KVCache
from ..models.kani import KaniConfig, KaniState, embed_tokens, init_state, kani_step
from ..models.nanocodec import (NanoCodecConfig, fsq_dequantize, hifigan_decode,
                                tokens_to_codes)
from .program import GraphPool, HostSlots, Program, replay_ahead, weights_key

__all__ = ["KaniPipeline", "KaniDecodeConfig", "STEPS"]

HEAD_IDS = (64403,)
TAIL_IDS = (2, 64404)
MAX_PROMPT = 256
# decode steps a replay of a step program covers: the host reads the stop
# flag once a replay, and a request's last replay runs up to STEPS - 1
# frozen steps
STEPS = 8


@dataclass(frozen=True)
class KaniDecodeConfig:
    max_new_tokens: int = 1019
    use_beam: bool = False
    beam_size: int = 5
    top_k: int = 5
    repeat_penalty: float = 0.8
    penalty_range: int = 10
    # None = "step" (the qkv head and attention kernel) on every device;
    # True = the qkv head kernel only; False = plain ops. kani_step degrades
    # "step" off the M=1 plain-causal geometry by itself.
    fused_decode: bool | str | None = None


def _prefill_loop(params: dict, ids_buf: torch.Tensor, prompt_len: int,
                  state: KaniState, cfg: KaniConfig):
    """One causal pass over the padded id bucket; the conv carries and the
    logits come from the true prompt positions and the KV length is rewound
    to prompt_len, so decode overwrites the padded rows. Returns (state,
    logits at the last prompt position)."""
    h = embed_tokens(params, ids_buf)                     # (1, S, H)
    logits, state = kani_step(params, h, state, cfg, valid_len=prompt_len)
    return KaniState(state.kv.rewind(prompt_len), state.conv), logits


class _Decode:
    """One decode bucket's programs and the device state they share: the
    counterpart of one jitted `run` of tts_tpu's `_decode_cache[fbuf]`
    (`kind` "greedy" or "beam") or `_batch_fns[("batch", B, fbuf)]`
    ("batch"), for `rows` rows (1, the beam size, B) of `buf` tokens.

    `prefill(bucket)` is the prefill program of a prompt bucket, `step` the
    program of STEPS decode steps, `codec` the epilogue; `state` lists every
    tensor they update. `bound` is the rows a step may reach, the largest
    prompt bucket plus buf, within the cache: its attention reads them and
    kernel 12 is launched for positions up to bound - 1. A request holds
    `lock` from its prefill to its fetch: the state is one request's."""

    def __init__(self, pipe: "KaniPipeline", kind: str, rows: int, buf: int, fbuf: int):
        cfg, dev = pipe.cfg, pipe.device
        self.pipe, self.kind, self.rows, self.buf, self.fbuf = pipe, kind, rows, buf, fbuf
        self.bound = min(min(MAX_PROMPT, cfg.max_seq_len // 2) + buf, cfg.max_seq_len)
        st = init_state(cfg, rows, pipe.dtype, dev)
        self.k, self.v, self.conv = st.kv.k, st.kv.v, st.conv

        def i32(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        def flag(*shape):
            return torch.zeros(shape, dtype=torch.bool, device=dev)

        # pos: the cache length; num: tokens decoded; limit: min(cap, buf);
        # fin: the stop token came (a row's, in a batch); over: a step found
        # no cache row; stop: the loop's exit; done: a batch row's stop index
        self.pos, self.num, self.limit = i32(), i32(), i32()
        self.save, self.tok, self.done, self.pad = i32(rows, buf), i32(rows), i32(rows), i32(rows)
        self.fin = flag(rows) if kind == "batch" else flag()
        self.over, self.stop = flag(), flag()
        self.keep = torch.arange(rows, device=dev)
        self.lp = torch.zeros((rows, 1), dtype=pipe.dtype, device=dev)
        self.state = (self.k, self.v, self.conv, self.pos, self.num, self.limit, self.save,
                      self.tok, self.done, self.pad, self.fin, self.over, self.stop, self.lp)
        self._prefill: dict = {}
        self.lock = threading.Lock()
        self.step = Program(self._steps, [], dev, pipe._pool, self.state)
        self.codec = Program(self._codec, [], dev, pipe._pool, self.state)
        # two slots of the stop flag on the host: one replay runs ahead of
        # the flag the host reads
        self._slots = HostSlots((self.stop,), dev)

    # ------------------------------------------------------------ programs

    def prefill(self, bucket: int) -> Program:
        """The prefill program of a prompt bucket: ids (1 or B, bucket)
        int32, the prompt length () (a batch: each row's pad start (B,)),
        the limit () int32 -> (the stop flag,)."""
        if bucket not in self._prefill:
            lens = ((self.rows,), torch.int32) if self.kind == "batch" else ((), torch.int32)
            self._prefill[bucket] = Program(
                self._prefill_body, [((1 if self.kind != "batch" else self.rows, bucket),
                                      torch.int32), lens, ((), torch.int32)],
                self.pipe.device, self.pipe._pool, self.state)
        return self._prefill[bucket]

    def _prefill_body(self, ids, lens, limit) -> tuple:
        p, cfg = self.pipe, self.pipe.cfg
        for t in (self.k, self.v, self.conv, self.save, self.over):
            t.zero_()
        if self.kind == "batch":
            # prompts right-justified in the bucket; lens: each row's pad start
            valid = torch.arange(ids.shape[1], device=ids.device)[None, :] >= lens[:, None]
            emb = embed_tokens(p.params, ids) * valid[..., None]
            logits, _ = kani_step(p.params, emb, KaniState(KVCache(self.k, self.v, 0),
                                                           self.conv), cfg, key_valid_from=lens)
            tok = greedy(logits)
            self.fin.copy_(tok == cfg.stop_token)
            # done[b]: the index of row b's stop token (the tokens kept before it)
            self.done.copy_(torch.where(self.fin, 0, self.buf))
            self.pad.copy_(lens)
            self.pos.fill_(ids.shape[1])
        else:
            # one row's prefill, then (beam) its cache and carries tiled
            st = KaniState(KVCache(self.k[:, :1], self.v[:, :1], 0), self.conv[:, :1])
            logits, _ = kani_step(p.params, embed_tokens(p.params, ids), st, cfg,
                                  valid_len=lens)
            if self.rows > 1:
                for t in (self.k, self.v, self.conv):
                    t[:, 1:].copy_(t[:, :1].expand_as(t[:, 1:]))
            if self.kind == "beam":
                bs = beam_init(logits, self.rows)
                tok = bs.tokens
                self.lp.copy_(bs.log_probs)
            else:
                tok = greedy(logits)
            self.fin.copy_(tok[0] == cfg.stop_token)
            self.pos.copy_(lens)
        self.tok.copy_(tok)
        self.save[:, 0] = tok
        self.num.fill_(1)
        self.limit.copy_(limit)
        self._set_stop()
        return (self.stop,)

    def _steps(self) -> tuple:
        for _ in range(STEPS):
            self._one_step()
        return (self.stop,)

    def _set_stop(self) -> None:
        fin = self.fin.all() if self.kind == "batch" else self.fin
        self.stop.copy_(fin | (self.num >= self.limit) | self.over)

    def _one_step(self) -> None:
        """One decode step of tts_tpu's while-loop body, applied only while
        its condition holds (`go`); otherwise a frozen step."""
        p, cfg, dcfg = self.pipe, self.pipe.cfg, self.pipe.dcfg
        t_max = cfg.max_seq_len
        fin = self.fin.all() if self.kind == "batch" else self.fin
        active = ~fin & (self.num < self.limit)
        go = active & (self.pos < t_max)
        self.over.copy_(self.over | (active & ~go))
        kv = KVCache(self.k, self.v, self.pos.clamp(max=t_max - 1), self.bound)
        logits, _ = kani_step(p.params, embed_tokens(p.params, self.tok[:, None]),
                              KaniState(kv, self.conv), cfg,
                              key_valid_from=self.pad if self.kind == "batch" else None,
                              fused=p._fused)
        logits = p._penalized(logits, self.save, self.num)
        at = self.num.clamp(max=self.buf - 1).long().reshape(1)
        if self.kind == "beam":
            nbs = beam_step(logits, self.lp, self.rows, dcfg.top_k)
            parent = torch.where(go, nbs.parent, self.keep).long()
            kv.select_batch(parent)
            self.conv.copy_(self.conv.index_select(1, parent))
            self.save.copy_(self.save.index_select(0, parent))
            tok = nbs.tokens
            self.lp.copy_(torch.where(go, nbs.log_probs, self.lp))
            self.fin.copy_(self.fin | (go & (tok[0] == cfg.stop_token)))
        elif self.kind == "batch":
            tok = torch.where(self.fin, cfg.stop_token, greedy(logits)).to(torch.int32)
            newly = (tok == cfg.stop_token) & ~self.fin & go
            self.done.copy_(torch.where(newly, self.num, self.done))
            self.fin.copy_(self.fin | newly)
        else:
            tok = greedy(logits)
            self.fin.copy_(self.fin | (go & (tok[0] == cfg.stop_token)))
        cur = self.save.index_select(1, at)
        self.save.index_copy_(1, at, torch.where(go, tok[:, None], cur))
        self.tok.copy_(torch.where(go, tok, self.tok))
        step = go.to(torch.int32)
        self.num.add_(step)
        self.pos.add_(step)
        self._set_stop()

    def _counts(self) -> torch.Tensor:
        """(rows kept,) int32: the tokens each output row keeps."""
        if self.kind == "batch":
            return torch.minimum(self.done, self.num)
        return (self.num - self.fin.to(torch.int32)).reshape(1)

    def _codec(self) -> tuple:
        save = self.save if self.kind == "batch" else self.save[:1]
        n = self._counts()
        wav, peak = self.pipe._vocode(save, n, self.fbuf)
        return wav, n, peak, self.over

    # ---------------------------------------------------------------- host

    def decode(self, ids: np.ndarray, lens, limit: int) -> None:
        """The prefill of ids' bucket, then replays of the step program, at
        most enough for limit - 1 steps. Each replay is queued before the
        host reads the flag of the one before it (the prefill's, at first),
        so the card does not wait for the host between replays; after the
        stop, at most one replay of frozen steps runs."""
        first = self.prefill(ids.shape[1])(ids, lens, np.int32(limit))
        for stop, in replay_ahead(self._slots, first, self.step,
                                  -(-(limit - 1) // STEPS)):
            if stop:
                return

    def fetch(self) -> tuple:
        """The codec program's outputs on the host: (int16 waveforms (rows
        kept, fbuf * total_upsample), tokens each row keeps, peak |float
        waveform|); raises where a step found no cache row."""
        wav, n, peak, over = self.codec()
        wav, n, over = wav.cpu().numpy(), n.cpu().numpy(), bool(over.cpu())
        if over:
            raise ValueError(f"cache of {self.pipe.cfg.max_seq_len} rows cannot take the "
                             f"next decode step")
        return wav, n, float(peak)


class KaniPipeline:
    """KaniTTS over an LM params dict and a NanoCodec params dict (tts_tpu's
    layouts, e.g. from `weights.convert.params_from_jax` or the models'
    `init_params`). Runs on the device the params are on, through the
    decode programs of the module's docstring."""

    def __init__(self, params: dict, cfg: KaniConfig, codec_params: dict,
                 codec_cfg: NanoCodecConfig, decode_cfg: KaniDecodeConfig | None = None,
                 tokenizer=None, audio_tokens_start: int | None = None,
                 quantize: int | None = None):
        if quantize not in (None, 4, 8):
            raise ValueError(f"quantize must be None, 4 or 8, got {quantize!r}")
        if quantize:
            # weight-only int8 or int4 on the LM matmuls; the codec stays
            # float
            from ..quant.weight_only import quantize_pytree

            params = quantize_pytree(params, bits=quantize)
        # the decode programs, keyed as tts_tpu's: fbuf for a request of the
        # configured route, ("batch", B, fbuf) for a batch; on a card their
        # graphs share one memory pool
        self._decode_cache: dict = {}
        self._batch_fns: dict = {}
        self._pool = GraphPool()
        self._weights = None
        self.cfg = cfg
        self.params = params
        self.codec_params = codec_params
        self.codec_cfg = codec_cfg
        self.dcfg = decode_cfg or KaniDecodeConfig()
        fd = self.dcfg.fused_decode
        self._fused = "step" if fd is None else fd
        self.tokenizer = tokenizer
        self.audio_tokens_start = (audio_tokens_start if audio_tokens_start is not None
                                   else cfg.vocab_size - 4 * codec_cfg.codebook_size)

    @property
    def params(self) -> dict:
        """The LM's params (quantized where the pipeline was built with
        `quantize`). Setting them drops the decode programs built so far."""
        return self._params

    @params.setter
    def params(self, params: dict) -> None:
        self._params = params
        self.device = params["embed"].device
        self.dtype = params["embed"].dtype
        self._drop()

    @property
    def codec_params(self) -> dict:
        """The NanoCodec's params. Setting them drops the decode programs."""
        return self._codec_params

    @codec_params.setter
    def codec_params(self, params: dict) -> None:
        self._codec_params = params
        self._drop()

    def _drop(self) -> None:
        self._decode_cache.clear()
        self._batch_fns.clear()

    def _programs(self) -> None:
        """Drop the decode programs where a tensor they read was replaced,
        moved or cast since they were built (`weights_key`)."""
        key = weights_key(self.params, self.codec_params)
        if key != self._weights:
            self._drop()
            self._weights = key

    # ------------------------------------------------------------------ codec

    def _vocode(self, save_ids: torch.Tensor, num: torch.Tensor, fbuf: int):
        """save_ids rows (.., buf), num (B,) tokens kept -> (int16 waveforms
        (B, fbuf * total_upsample), max |float waveform|, nan or inf if it
        was not finite). Positions past the generated frames are the
        group-base token; the causal HiFiGAN leaves the samples before
        frames * upsample unaffected."""
        ccfg = self.codec_cfg
        g = ccfg.num_groups
        flat = save_ids[:, 2:2 + fbuf * g]
        frames = torch.clamp(torch.div(num - 2, g, rounding_mode="floor"), min=0)
        valid = torch.arange(fbuf * g, device=flat.device)[None, :] < \
            frames.reshape(-1, 1) * g
        flat = torch.where(valid, flat, self.audio_tokens_start)
        feats = fsq_dequantize(tokens_to_codes(flat, ccfg, self.audio_tokens_start), ccfg)
        wav = hifigan_decode(self.codec_params, feats, ccfg)   # conv1d casts to w.dtype
        return to_pcm16(torch.clamp(wav, -1.0, 1.0) * 32767.0), wav.abs().amax()

    # ------------------------------------------------------------------ LM

    def _penalized(self, logits, save_ids, num):
        d = self.dcfg
        if d.repeat_penalty == 1.0:
            return logits
        return apply_repetition_penalty(logits, save_ids, num, d.repeat_penalty,
                                        d.penalty_range)

    def _route(self) -> str:
        degenerate = self.dcfg.top_k < 2 or self.dcfg.beam_size < 2
        return "beam" if self.dcfg.use_beam and not degenerate else "greedy"

    def _solo(self, fbuf: int) -> _Decode:
        """The configured route's decode programs for a request of fbuf
        frames (tts_tpu's `_decode_cache[fbuf]`)."""
        self._programs()
        if fbuf not in self._decode_cache:
            kind = self._route()
            rows = self.dcfg.beam_size if kind == "beam" else 1
            self._decode_cache[fbuf] = _Decode(self, kind, rows,
                                               fbuf * self.codec_cfg.num_groups + 2, fbuf)
        return self._decode_cache[fbuf]

    def _batch(self, bsz: int, fbuf: int) -> _Decode:
        """A batch's decode programs (tts_tpu's `_batch_fns[("batch", B,
        fbuf)]`)."""
        self._programs()
        key = ("batch", bsz, fbuf)
        if key not in self._batch_fns:
            self._batch_fns[key] = _Decode(self, "batch", bsz,
                                           fbuf * self.codec_cfg.num_groups + 2, fbuf)
        return self._batch_fns[key]

    def _greedy_run(self, ids_buf, prompt_len: int, cap: int, buf: int):
        """The configured route's decode of one padded prompt through its
        programs, without the codec: (the kept row's token buffer (1, buf)
        on the device, tokens kept)."""
        dec = self._solo((buf - 2) // self.codec_cfg.num_groups)
        with dec.lock:
            dec.decode(torch.as_tensor(ids_buf).to(torch.int32), np.int32(prompt_len), cap)
            return dec.save[:1].clone(), int(dec._counts()[0])

    def _buf_for(self, max_new_tokens: int | None) -> tuple[int, int, int]:
        """(cap, buf, fbuf): token cap, the bucketed token capacity and the
        codec frame capacity, in 16-frame steps."""
        dcfg = self.dcfg
        g = self.codec_cfg.num_groups
        cap = min(max_new_tokens or dcfg.max_new_tokens, dcfg.max_new_tokens)
        fbuf_max = max(-(-(dcfg.max_new_tokens - 2) // g), 16)
        fbuf = min(fbuf_max, max(16, -(-max(cap - 2, 1) // (g * 16)) * 16))
        return cap, fbuf * g + 2, fbuf

    def _bucket(self, longest: int) -> int:
        pcap = min(MAX_PROMPT, self.cfg.max_seq_len // 2)
        return max(16, min(pcap, -(-longest // 64) * 64))

    # ---------------------------------------------------------------- public

    def tokenize(self, text: str, speaker: str = "jenny") -> np.ndarray:
        """(1, P) prompt ids: HEAD_IDS + tokenizer("speaker: text") + TAIL_IDS."""
        if self.tokenizer is None:
            raise ValueError("no tokenizer configured; pass ids to synthesize_ids")
        ids = self.tokenizer(f"{speaker}: {text}", return_tensors="np")[
            "input_ids"].astype(np.int32)
        return np.concatenate(
            [np.array([HEAD_IDS], np.int32), ids, np.array([TAIL_IDS], np.int32)],
            axis=1)

    @torch.no_grad()
    def synthesize_ids(self, ids: np.ndarray, max_new_tokens: int | None = None
                       ) -> tuple[np.ndarray, dict]:
        """ids: (1, P) full prompt (head and tail ids attached). Returns
        (int16 waveform, {"tokens", "wall_s", "tokens_per_s", "peak"})."""
        cap, buf, fbuf = self._buf_for(max_new_tokens)
        prompt_len = ids.shape[1]
        ids_buf = np.zeros((1, self._bucket(prompt_len)), np.int32)
        ids_buf[0, :prompt_len] = ids[0]
        if self.dcfg.use_beam and self._route() == "greedy":
            warnings.warn("beam search requested with beam_size/top_k < 2; "
                          "falling back to greedy", stacklevel=2)
        t0 = time.perf_counter()
        dec = self._solo(fbuf)
        with dec.lock:
            dec.decode(ids_buf, np.int32(prompt_len), min(cap, buf))
            wav, n, peak = dec.fetch()
        n = int(n[0])
        frames = max((n - 2) // self.codec_cfg.num_groups, 0)
        if frames == 0:
            return np.zeros(0, np.int16), {"tokens": n, "wall_s": 0.0}
        wav = wav[0, :frames * self.codec_cfg.total_upsample]
        wall = time.perf_counter() - t0
        return wav, {"tokens": n, "wall_s": wall, "tokens_per_s": n / max(wall, 1e-9),
                     "peak": peak}

    @torch.no_grad()
    def synthesize_ids_batch(self, ids_list: list[np.ndarray],
                             max_new_tokens: int | None = None
                             ) -> tuple[list[np.ndarray], dict]:
        """Decode B prompts together (per-row stop tracking) and vocode all
        rows at once. Returns (int16 waveforms, aggregate stats)."""
        bsz = len(ids_list)
        cap, buf, fbuf = self._buf_for(max_new_tokens)
        bucket = self._bucket(max(i.shape[1] for i in ids_list))
        ids_buf = np.zeros((bsz, bucket), np.int32)
        pad_start = np.zeros((bsz,), np.int32)
        for b, ids in enumerate(ids_list):
            p = ids.shape[1]
            ids_buf[b, bucket - p:] = ids[0]
            pad_start[b] = bucket - p
        t0 = time.perf_counter()
        dec = self._batch(bsz, fbuf)
        with dec.lock:
            dec.decode(ids_buf, pad_start, min(cap, buf))
            wav, done, peak = dec.fetch()
        g, up = self.codec_cfg.num_groups, self.codec_cfg.total_upsample
        wavs = []
        for b in range(bsz):
            frames = max((int(done[b]) - 2) // g, 0)
            wavs.append(wav[b, :frames * up] if frames else np.zeros(0, np.int16))
        wall = time.perf_counter() - t0
        total = int(done.sum())
        return wavs, {"tokens": total, "wall_s": wall,
                      "tokens_per_s": total / max(wall, 1e-9), "peak": peak}

    def synthesize(self, text: str, speaker: str = "jenny") -> tuple[np.ndarray, dict]:
        return self.synthesize_ids(self.tokenize(text, speaker))

    def synthesize_long(self, texts: list[str], speaker: str = "jenny",
                        separator_ms: float = 300.0) -> tuple[np.ndarray, list[dict]]:
        """One `synthesize` a sentence, each followed by separator_ms of
        silence (300 ms, as the reference's Export_Kani_TTS.py:1064)."""
        blank = np.zeros(int(self.codec_cfg.sample_rate * separator_ms / 1000), np.int16)
        wavs, stats = [], []
        for text in texts:
            wav, st = self.synthesize(text, speaker)
            wavs.extend([wav, blank])
            stats.append(st)
        return (np.concatenate(wavs) if wavs else np.zeros(0, np.int16), stats)

    def benchmark(self, ids: np.ndarray | None = None, iters: int = 2) -> dict:
        """Greedy (or beam, as configured) `synthesize_ids` on the bench
        prompt [[3, 9, 4, 17, 2]] after one warm-up call: the best of `iters`
        wall times, tokens, tokens/s, the audio seconds (frames *
        total_upsample / sample_rate) and the real-time factor."""
        ids = np.array([[3, 9, 4, 17, 2]], np.int32) if ids is None else ids
        self.synthesize_ids(ids)
        best = None
        for _ in range(iters):
            wav, stats = self.synthesize_ids(ids)
            if best is None or stats["wall_s"] < best[1]["wall_s"]:
                best = (wav, stats)
        wav, stats = best
        ccfg = self.codec_cfg
        frames = max((stats["tokens"] - 2) // ccfg.num_groups, 0)
        audio_s = frames * ccfg.total_upsample / ccfg.sample_rate
        return {"tokens": stats["tokens"], "wall_s": stats["wall_s"],
                "tokens_per_s": stats["tokens"] / max(stats["wall_s"], 1e-9),
                "audio_s": audio_s, "rtf": stats["wall_s"] / max(audio_s, 1e-9),
                "samples": len(wav)}
