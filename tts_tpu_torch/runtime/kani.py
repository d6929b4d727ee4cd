"""KaniTTS synthesis from token ids: prompt -> codec tokens -> waveform
(counterpart of tts_tpu/runtime/kani.py:KaniPipeline, without the text
tokenizer, `mesh` and int4, which are not ported yet).

One batched prefill over the padded prompt bucket, then a Python loop of
decode steps (LM step, repetition penalty, greedy or beam selection) that
stops where tts_tpu's while-loop stops: on the stop token (greedy), on beam
0's stop token (beam), when every row has stopped (batch), or at the cap.
The stop flag is read on the host once a token. The codec then runs over
the whole bucket of `fbuf` frames, positions past the generated frames
padded with the group-base token, and the waveform is cropped: the HiFiGAN
is causal, so the kept samples equal a compact decode's.

Prompt format: [64403] + tokenizer("speaker: text") + [2, 64404]; the codec
reads ids[2:num] as frames of 4 codebook tokens.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..decoding.beam import beam_init, beam_step
from ..decoding.sampling import apply_repetition_penalty, greedy
from ..models.kani import KaniConfig, KaniState, embed_tokens, init_state, kani_step
from ..models.nanocodec import (NanoCodecConfig, fsq_dequantize, hifigan_decode,
                                tokens_to_codes)

__all__ = ["KaniPipeline", "KaniDecodeConfig"]

MAX_PROMPT = 256


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


class KaniPipeline:
    """KaniTTS over an LM params dict and a NanoCodec params dict (tts_tpu's
    layouts, e.g. from `weights.convert.params_from_jax` or the models'
    `init_params`). Runs on the device the params are on."""

    def __init__(self, params: dict, cfg: KaniConfig, codec_params: dict,
                 codec_cfg: NanoCodecConfig, decode_cfg: KaniDecodeConfig | None = None,
                 audio_tokens_start: int | None = None, quantize: int | None = None):
        if quantize not in (None, 8):
            raise ValueError(f"quantize must be None or 8, got {quantize!r}")
        if quantize:
            # weight-only int8 on the LM matmuls; the codec stays float
            from ..quant.weight_only import quantize_pytree

            params = quantize_pytree(params, bits=quantize)
        self.params = params
        self.cfg = cfg
        self.codec_params = codec_params
        self.codec_cfg = codec_cfg
        self.dcfg = decode_cfg or KaniDecodeConfig()
        fd = self.dcfg.fused_decode
        self._fused = "step" if fd is None else fd
        self.audio_tokens_start = (audio_tokens_start if audio_tokens_start is not None
                                   else cfg.vocab_size - 4 * codec_cfg.codebook_size)
        self.device = params["embed"].device
        self.dtype = params["embed"].dtype

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
        return (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16), wav.abs().amax()

    # ------------------------------------------------------------------ LM

    def _penalized(self, logits, save_ids, num: int):
        d = self.dcfg
        if d.repeat_penalty == 1.0:
            return logits
        return apply_repetition_penalty(logits, save_ids, num, d.repeat_penalty,
                                        d.penalty_range)

    def _greedy_run(self, ids_buf, prompt_len: int, cap: int, buf: int):
        cfg, params = self.cfg, self.params
        state, logits = _prefill_loop(params, ids_buf, prompt_len,
                                      init_state(cfg, 1, self.dtype, self.device), cfg)
        tok = greedy(logits)
        save_ids = torch.zeros((1, buf), dtype=torch.int32, device=self.device)
        save_ids[:, 0] = tok
        num, finished = 1, bool(tok.item() == cfg.stop_token)
        while not finished and num < min(cap, buf):
            logits, state = kani_step(params, embed_tokens(params, tok[:, None]), state,
                                      cfg, fused=self._fused)
            tok = greedy(self._penalized(logits, save_ids, num))
            save_ids[:, num] = tok
            num += 1
            finished = tok.item() == cfg.stop_token
        return save_ids, num - int(finished)

    def _beam_run(self, ids_buf, prompt_len: int, cap: int, buf: int):
        cfg, params, beam = self.cfg, self.params, self.dcfg.beam_size
        state, logits = _prefill_loop(params, ids_buf, prompt_len,
                                      init_state(cfg, 1, self.dtype, self.device), cfg)
        bs = beam_init(logits, beam)
        state = KaniState(state.kv.repeat_batch(beam), state.conv.repeat(1, beam, 1, 1))
        save_ids = torch.zeros((beam, buf), dtype=torch.int32, device=self.device)
        save_ids[:, 0] = bs.tokens
        num, finished = 1, bool(bs.tokens[0].item() == cfg.stop_token)
        while not finished and num < min(cap, buf):
            logits, state = kani_step(params, embed_tokens(params, bs.tokens[:, None]),
                                      state, cfg, fused=self._fused)
            bs = beam_step(self._penalized(logits, save_ids, num), bs.log_probs, beam,
                           self.dcfg.top_k)
            parent = bs.parent.long()
            state = KaniState(state.kv.select_batch(parent),
                              state.conv.index_select(1, parent))
            save_ids = save_ids.index_select(0, parent)
            save_ids[:, num] = bs.tokens
            num += 1
            finished = bs.tokens[0].item() == cfg.stop_token
        return save_ids[:1], num - int(finished)

    def _batch_run(self, ids_buf, pad_start, cap: int, buf: int):
        """B prompts right-justified in one bucket; per-row stop tracking."""
        cfg, params, bsz = self.cfg, self.params, ids_buf.shape[0]
        valid = torch.arange(ids_buf.shape[1], device=self.device)[None, :] \
            >= pad_start[:, None]
        emb = embed_tokens(params, ids_buf) * valid[..., None]
        state = init_state(cfg, bsz, self.dtype, self.device)
        logits, state = kani_step(params, emb, state, cfg, key_valid_from=pad_start)
        tok = greedy(logits)
        save = torch.zeros((bsz, buf), dtype=torch.int32, device=self.device)
        save[:, 0] = tok
        fin = tok == cfg.stop_token
        # done[b]: index of row b's stop token (the tokens kept before it)
        done = torch.where(fin, 0, buf).to(torch.int32)
        num = 1
        while not bool(fin.all()) and num < min(cap, buf):
            logits, state = kani_step(params, embed_tokens(params, tok[:, None]), state,
                                      cfg, key_valid_from=pad_start, fused=self._fused)
            tok = greedy(self._penalized(logits, save, num))
            tok = torch.where(fin, cfg.stop_token, tok).to(torch.int32)
            save[:, num] = tok
            newly = (tok == cfg.stop_token) & ~fin
            done = torch.where(newly, num, done).to(torch.int32)
            fin = fin | newly
            num += 1
        return save, torch.clamp(done, max=num)

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

    @torch.no_grad()
    def synthesize_ids(self, ids: np.ndarray, max_new_tokens: int | None = None
                       ) -> tuple[np.ndarray, dict]:
        """ids: (1, P) full prompt (head and tail ids attached). Returns
        (int16 waveform, {"tokens", "wall_s", "tokens_per_s"})."""
        cap, buf, fbuf = self._buf_for(max_new_tokens)
        prompt_len = ids.shape[1]
        ids_buf = np.zeros((1, self._bucket(prompt_len)), np.int32)
        ids_buf[0, :prompt_len] = ids[0]
        t0 = time.perf_counter()
        ids_dev = torch.from_numpy(ids_buf).to(self.device)
        degenerate = self.dcfg.top_k < 2 or self.dcfg.beam_size < 2
        if self.dcfg.use_beam and degenerate:
            warnings.warn("beam search requested with beam_size/top_k < 2; "
                          "falling back to greedy", stacklevel=2)
        run = self._beam_run if (self.dcfg.use_beam and not degenerate) else self._greedy_run
        save_ids, n = run(ids_dev, prompt_len, min(cap, buf), buf)
        frames = max((n - 2) // self.codec_cfg.num_groups, 0)
        if frames == 0:
            return np.zeros(0, np.int16), {"tokens": n, "wall_s": 0.0}
        wav, peak = self._vocode(save_ids, torch.tensor([n], device=self.device), fbuf)
        wav = wav[0, :frames * self.codec_cfg.total_upsample].cpu().numpy()
        wall = time.perf_counter() - t0
        return wav, {"tokens": n, "wall_s": wall, "tokens_per_s": n / max(wall, 1e-9),
                     "peak": float(peak)}

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
        save, done = self._batch_run(torch.from_numpy(ids_buf).to(self.device),
                                     torch.from_numpy(pad_start).to(self.device),
                                     min(cap, buf), buf)
        wav, peak = self._vocode(save, done, fbuf)
        wav, done = wav.cpu().numpy(), done.cpu().numpy()
        g, up = self.codec_cfg.num_groups, self.codec_cfg.total_upsample
        wavs = []
        for b in range(bsz):
            frames = max((int(done[b]) - 2) // g, 0)
            wavs.append(wav[b, :frames * up] if frames else np.zeros(0, np.int16))
        wall = time.perf_counter() - t0
        total = int(done.sum())
        return wavs, {"tokens": total, "wall_s": wall,
                      "tokens_per_s": total / max(wall, 1e-9), "peak": float(peak)}

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
