"""Slot-based continuous batching for the Kani AR decode (counterpart of
tts_tpu/serving/continuous.py).

A family adapter over serving/slots.SlotEngine (see it for the chunked
decode, mid-decode admission and drain). Kani specifics:

- A chunk is a Python loop of `chunk` steps over device tensors: embed ->
  kani_step (GQA + the LFM2 conv carries, per-row key masks) -> per-row
  repetition penalty -> greedy, with dead rows embedding zeros. Nothing in
  it reads the device from the host; the engine reads (fin, done) once a
  chunk. At 1-8 slots each attention layer's step takes kernel 11 (the
  masked rows degrade kani_step's "step" route to the qkv head).
- Admission prefills ONE row at the batch's current shared position,
  written in place into the batch's KV and conv rows (rope sees only
  relative offsets, so the right-justified offset prefill decodes as a solo
  request does).
- Finished rows vocode through the pipeline's causal NanoCodec from the
  row's token buffer; `submit_stream` decodes windows as chunks produce
  them (runtime/streaming.ChunkedCodecStream).

Slot KV sizing: max_seq_len >= prompt_bucket + cap + chunk, with headroom
for several generations between drains.
"""
from __future__ import annotations

import numpy as np
import torch

from ..decoding.sampling import greedy
from ..kv.cache import KVCache
from ..models.kani import KaniState, embed_tokens, init_state, kani_step
from ..models.nanocodec import fsq_dequantize, hifigan_decode, tokens_to_codes
from ..runtime.streaming import ChunkedCodecStream
from .slots import SlotEngine, SlotStats, StreamHandle, row_penalty, stream_failure_hook

__all__ = ["KaniSlotServer", "SlotStats"]


class KaniSlotServer(SlotEngine):
    """Continuous-batching server over a KaniPipeline, on the device of its
    params.

    submit(ids) -> Future resolving to (int16 wav, n_tokens).
    ids: (1, P) int32 full prompt (head and tail ids attached).
    """

    def __init__(self, pipeline, *, slots: int = 4, chunk: int = 32,
                 prompt_bucket: int = 64, queue_limit: int = 256):
        self.pipe = pipeline
        self.cfg = pipeline.cfg
        self.ccfg = pipeline.codec_cfg
        self.bucket = prompt_bucket
        cap, buf, fbuf = pipeline._buf_for(pipeline.dcfg.max_new_tokens)
        self.cap, self.buf, self.fbuf = min(cap, buf), buf, fbuf
        if self.bucket + self.cap + chunk > self.cfg.max_seq_len:
            raise ValueError(
                f"max_seq_len {self.cfg.max_seq_len} too small for "
                f"bucket {self.bucket} + cap {self.cap} + chunk "
                f"{chunk}; lower max_new_tokens or raise max_seq_len")
        self._slots = slots
        self._rf_frames = None
        super().__init__(slots=slots, chunk=chunk, seq_limit=self.cfg.max_seq_len,
                         start_pos=self.bucket, queue_limit=queue_limit,
                         name="kani-slot-server", device=pipeline.device)

    # ------------------------------------------------------------- client

    def _cap(self, ids: np.ndarray, max_new_tokens: int | None) -> int:
        if ids.shape[1] > self.bucket:
            raise ValueError(f"prompt {ids.shape[1]} > bucket {self.bucket}")
        return min(max_new_tokens or self.cap, self.cap)

    def submit(self, ids: np.ndarray, max_new_tokens: int | None = None,
               deadline_s: float | None = None):
        cap = self._cap(ids, max_new_tokens)
        return self._submit((np.asarray(ids, np.int32), None), cap, deadline_s=deadline_s)

    def submit_stream(self, ids: np.ndarray, max_new_tokens: int | None = None,
                      window: int = 48, left_context: int | None = None) -> StreamHandle:
        """Streaming variant: a StreamHandle iterating int16 chunks as chunk
        boundaries produce codec frames; concurrent streams share the slot
        batch. The NanoCodec HiFiGAN is causal, so windowed decode with
        left_context >= its receptive field reproduces the full decode;
        left_context=None measures the receptive field once
        (_receptive_frames) and uses it."""
        cap = self._cap(ids, max_new_tokens)
        if left_context is None:
            left_context = self._receptive_frames()
        if left_context >= window:
            raise ValueError(f"left_context {left_context} >= window {window}; raise window")
        handle = StreamHandle()
        fut = self._submit((np.asarray(ids, np.int32), (handle, window, left_context)), cap)
        stream_failure_hook(fut, handle)
        return handle

    @torch.no_grad()
    def _receptive_frames(self) -> int:
        """The causal HiFiGAN's receptive field in codec frames, measured by
        an impulse probe: how many past frames can move the current output
        sample. One probe decode, cached."""
        if self._rf_frames is None:
            ccfg, dev = self.ccfg, self.pipe.device
            n = 64
            base = torch.zeros((1, n, ccfg.num_groups), dtype=torch.int32, device=dev)
            probe = base.clone()
            probe[0, 0] = 1

            def dec(c):
                return hifigan_decode(self.pipe.codec_params, fsq_dequantize(c, ccfg),
                                      ccfg).float()

            d = (dec(probe) - dec(base)).abs()[0].cpu().numpy()
            nz = np.nonzero(d > 1e-7)[0]
            last = int(nz[-1]) if len(nz) else 0
            self._rf_frames = min(last // ccfg.total_upsample + 1, n)
        return self._rf_frames

    def _window_fn(self, tokens: np.ndarray) -> torch.Tensor:
        """The codec decode of a streaming window of raw tokens (1, W, G) ->
        int16 on the device."""
        pipe = self.pipe
        flat = torch.from_numpy(tokens.reshape(1, -1).astype(np.int64)).to(pipe.device)
        codes = tokens_to_codes(flat, self.ccfg, pipe.audio_tokens_start)
        wav = hifigan_decode(pipe.codec_params, fsq_dequantize(codes, self.ccfg), self.ccfg)
        return (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)

    # ------------------------------------------------------ engine hooks

    def _fresh(self):
        bsz, buf, dev = self._slots, self.buf, self.pipe.device

        def z():
            return torch.zeros((bsz,), dtype=torch.int32, device=dev)

        return {
            "state": init_state(self.cfg, bsz, self.pipe.dtype, dev),
            "save": torch.zeros((bsz, buf), dtype=torch.int32, device=dev),
            "cnt": z(),
            "last": z(),
            "fin": torch.ones((bsz,), dtype=torch.bool, device=dev),
            "done": z(),
            "kvf": z(),                # each row's first valid key
            "cap": z(),
            "stream": [None] * bsz,    # {handle, codec, prev} per slot
        }

    def _step_chunk(self, s) -> None:
        cfg, params, dcfg = self.cfg, self.pipe.params, self.pipe.dcfg
        buf, stop = self.buf, cfg.stop_token
        state, save, cnt, last, fin, done = (s[k] for k in ("state", "save", "cnt", "last",
                                                            "fin", "done"))
        kvf, cap = s["kvf"], s["cap"]
        for _ in range(self.chunk):
            h = embed_tokens(params, torch.clamp(last, min=0)[:, None])
            h = h * (~fin)[:, None, None]                 # dead rows embed zeros
            logits, state = kani_step(params, h, state, cfg, key_valid_from=kvf,
                                      fused=self.pipe._fused)
            if dcfg.repeat_penalty != 1.0:
                logits = row_penalty(logits, save, cnt, dcfg.repeat_penalty,
                                     dcfg.penalty_range)
            tok = torch.where(fin, stop, greedy(logits)).to(torch.int32)
            idx = torch.clamp(cnt, max=buf - 1)[:, None].long()
            save.scatter_(1, idx, torch.where(fin[:, None], save.gather(1, idx), tok[:, None]))
            is_stop = tok == stop
            newly = (is_stop | (cnt + 1 >= cap)) & ~fin
            done = torch.where(newly, torch.where(is_stop, cnt, cnt + 1), done)
            cnt = torch.where(fin | newly, cnt, cnt + 1)
            fin = fin | newly
            last = tok
        s.update(state=state, cnt=cnt, last=last, fin=fin, done=done)

    def _admit_row(self, s, b: int, payload, cap: int) -> None:
        ids, stream = payload
        if stream is not None:
            handle, window, left_context = stream
            s["stream"][b] = {
                "handle": handle, "prev": 0,
                "codec": ChunkedCodecStream(self._window_fn, window=window,
                                            left_context=left_context,
                                            upsample=self.ccfg.total_upsample,
                                            num_groups=self.ccfg.num_groups)}
        else:
            s["stream"][b] = None
        cfg, params, dev = self.cfg, self.pipe.params, self.pipe.device
        p, pos = ids.shape[1], s["pos"]
        ids_buf = np.zeros((1, self.bucket), np.int64)
        ids_buf[0, self.bucket - p:] = ids[0]
        # the row's KV and conv views of the batch state: the prefill writes
        # them in place at [pos - bucket, pos), its prompt right-justified
        st = s["state"]
        conv = st.conv[:, b:b + 1]
        conv.zero_()
        row = KaniState(KVCache(st.kv.k[:, b:b + 1], st.kv.v[:, b:b + 1], pos - self.bucket),
                        conv)
        valid = torch.arange(self.bucket, device=dev)[None, :] >= self.bucket - p
        emb = embed_tokens(params, torch.from_numpy(ids_buf).to(dev)) * valid[..., None]
        logits, _ = kani_step(params, emb, row, cfg,
                              key_valid_from=torch.full((1,), pos - p, device=dev))
        first = greedy(logits)[0]
        s["state"] = KaniState(KVCache(st.kv.k, st.kv.v, pos), st.conv)
        s["save"][b] = 0
        s["save"][b, 0] = first
        s["cnt"][b] = 1
        s["last"][b] = first
        s["fin"][b] = first == cfg.stop_token
        s["done"][b] = 0
        s["kvf"][b] = pos - p
        s["cap"][b] = cap

    def _frames_of(self, n_tokens: int) -> int:
        return max((n_tokens - 2) // self.ccfg.num_groups, 0)

    def _push(self, st: dict, save_row: np.ndarray, new: int) -> None:
        """Feed a stream the frames [prev, new) of its row's tokens."""
        g = self.ccfg.num_groups
        if new > st["prev"]:
            toks = save_row[2 + st["prev"] * g: 2 + new * g]
            st["prev"] = new
            out = st["codec"].push_frames(toks.reshape(-1, g))
            if out is not None and len(out):
                st["handle"]._put(out)

    def _post_chunk(self, s) -> None:
        if not any(st is not None for st in s["stream"]):
            return
        cnt = s["cnt"].cpu().numpy()
        save_h = s["save"].cpu().numpy()       # one fetch for all rows
        for b, st in enumerate(s["stream"]):
            if st is not None:
                self._push(st, save_h[b], self._frames_of(int(cnt[b])))

    def _finalize(self, s, b: int, n: int):
        st = s["stream"][b]
        if st is not None:
            s["stream"][b] = None
            self._push(st, s["save"][b].cpu().numpy(), self._frames_of(n))
            for out in st["codec"].finish():
                st["handle"]._put(out)
            st["handle"]._close(n)
            return None, n
        frames = self._frames_of(n)
        if frames == 0:
            return np.zeros(0, np.int16), n
        wav, _ = self.pipe._vocode(s["save"][b:b + 1],
                                   torch.full((1,), n, device=self.pipe.device), self.fbuf)
        return wav[0, :frames * self.ccfg.total_upsample].cpu().numpy(), n
