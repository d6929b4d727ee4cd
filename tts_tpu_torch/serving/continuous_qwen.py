"""Slot-based continuous batching for the Qwen3-TTS two-level decode
(counterpart of tts_tpu/serving/continuous_qwen.py).

A family adapter over serving/slots.SlotEngine. Each chunk step runs the
FULL two-level frame: talker logits (+ the per-row repetition penalty over
the row's own token-0 history) -> greedy token 0 -> the 15-group predictor
(greedy, or per-request beams: runtime/qwen._predictor_batch) -> the next
talker input (each row gathers its own trailing-text row at its own frame)
-> one talker stack step with per-row key masks. The talker's layers take
kernel 11 on the default route, kernels 11 and 14 on "all", kernels 11
and 15 on "mlp_q8" (models/qwen_tts.stack_routes; the kv masks keep
kernels 12 and 13 off the talker).

Admission runs a one-row offset prefill: the prompt embeds right-justified
at the batch's current shared kv position, rope positions continued from
the shared counter, written in place into the batch's KV row, and the
row's hidden and trailing text set. A finished row's frames decode through
the 12 Hz codec at the pipeline's frame bucket.
"""
from __future__ import annotations

import numpy as np
import torch

from ..audio.wav import to_pcm16
from ..kv.cache import KVCache
from ..models.qwen_codec import codec_decode
from ..models.qwen_tts import next_talker_input_batch, qwen3_stack_step, talker_logits
from ..runtime.streaming import ChunkedCodecStream
from .slots import SlotEngine, StreamHandle, row_penalty, stream_failure_hook

__all__ = ["QwenSlotServer"]


class QwenSlotServer(SlotEngine):
    """Continuous-batching server over a QwenTTSPipeline, on the device of
    its params.

    submit(prefill, trailing) -> Future resolving to (int16 wav, n_frames).
    prefill (1, P, H) / trailing (1, Tt, H) float: the pipeline's
    build_prefill_embeds output (tensors or arrays).
    """

    def __init__(self, pipeline, *, slots: int = 4, chunk: int = 16,
                 prompt_bucket: int = 256, trailing_bucket: int = 64,
                 max_seq_len: int | None = None, queue_limit: int = 256):
        self.pipe = pipeline
        self.cfg = pipeline.cfg
        self.ccfg = pipeline.codec_cfg
        self.dcfg = pipeline.dcfg
        t = self.cfg.talker
        self.bucket = prompt_bucket
        self.tb = trailing_bucket
        self.fbuf = self.dcfg.max_frames
        rope_len = int(pipeline.params["rope_cos"].shape[0])
        kv_max = min(max_seq_len or t.max_seq_len, t.max_seq_len, rope_len)
        kv_max = (kv_max // 128) * 128 or kv_max
        if self.bucket + self.fbuf + chunk > kv_max:
            raise ValueError(
                f"kv budget {kv_max} too small for bucket {self.bucket} + "
                f"max_frames {self.fbuf} + chunk {chunk}; lower max_frames "
                f"or raise max_seq_len")
        self.kv_max = kv_max
        self._slots = slots
        super().__init__(slots=slots, chunk=chunk, seq_limit=kv_max,
                         start_pos=self.bucket, queue_limit=queue_limit,
                         name="qwen-slot-server", device=pipeline.device)

    # ------------------------------------------------------------- client

    def submit(self, prefill, trailing, max_frames: int | None = None,
               deadline_s: float | None = None):
        (prefill, trailing), cap = self._validate(prefill, trailing, max_frames)
        return self._submit((prefill, trailing, None), cap, deadline_s=deadline_s)

    def submit_stream(self, prefill, trailing, max_frames: int | None = None,
                      window: int = 72, left_context: int = 24) -> StreamHandle:
        """Streaming variant: a StreamHandle iterating int16 audio chunks as
        the row's chunk boundaries produce them; concurrent streams share
        the slot batch. Each codec window carries `left_context` frames of
        already-emitted codes whose audio is discarded (the reference's
        chunked_decode, Export_Qwen_TTS_ONNX.py:2706-2726)."""
        cms = getattr(self.ccfg, "max_seq_len", None)
        if cms is not None and window > cms:
            raise ValueError(f"window {window} > codec max_seq_len {cms}")
        (prefill, trailing), cap = self._validate(prefill, trailing, max_frames)
        handle = StreamHandle()
        fut = self._submit((prefill, trailing, (handle, window, left_context)), cap)
        stream_failure_hook(fut, handle)
        return handle

    def _validate(self, prefill, trailing, max_frames):
        if prefill.shape[1] > self.bucket:
            raise ValueError(f"prefill {prefill.shape[1]} > bucket {self.bucket}")
        if trailing.shape[1] > self.tb:
            raise ValueError(f"trailing {trailing.shape[1]} > bucket {self.tb}")
        cap = min(max_frames or self.fbuf, self.fbuf)
        return (torch.as_tensor(prefill).float(), torch.as_tensor(trailing).float()), cap

    def _window_fn(self, codes: np.ndarray) -> torch.Tensor:
        """The codec decode of a streaming window (1, W, G) -> int16 on the
        device."""
        c = torch.from_numpy(codes.astype(np.int64)).to(self.pipe.device)
        wav = codec_decode(self.pipe.codec_params, c, self.ccfg)
        return to_pcm16(wav * 32767.0)

    # ------------------------------------------------------ engine hooks

    def _fresh(self):
        bsz, t, dev, dt = self._slots, self.cfg.talker, self.pipe.device, self.pipe.dtype

        def z():
            return torch.zeros((bsz,), dtype=torch.int32, device=dev)

        return {
            "kv": KVCache.create(t.num_layers, bsz, t.num_kv_heads, self.kv_max,
                                 t.head_dim, dt, dev),
            "hid": torch.zeros((bsz, t.hidden_size), dtype=dt, device=dev),
            "frames": torch.zeros((bsz, self.fbuf, self.cfg.num_code_groups),
                                  dtype=torch.int32, device=dev),
            "save0": torch.zeros((bsz, self.fbuf), dtype=torch.int32, device=dev),
            "cnt": z(),
            "fin": torch.ones((bsz,), dtype=torch.bool, device=dev),
            "done": z(),
            "trailing": torch.zeros((bsz, self.tb, t.hidden_size), dtype=dt, device=dev),
            "kvf": z(),                # each row's first valid key
            "cap": z(),
            "stream": [None] * bsz,    # {handle, codec, prev} per slot
        }

    def _step_chunk(self, s) -> None:
        cfg, dcfg, params, pipe = self.cfg, self.dcfg, self.pipe.params, self.pipe
        t, fbuf, bsz = cfg.talker, self.fbuf, self._slots
        kv, hid, frames, save0, cnt, fin, done = (s[k] for k in (
            "kv", "hid", "frames", "save0", "cnt", "fin", "done"))
        trailing, cap = s["trailing"], s["cap"]
        g = cfg.num_code_groups
        kv_valid = torch.arange(self.kv_max, device=cnt.device)[None, :] >= s["kvf"][:, None]
        for _ in range(self.chunk):
            logits = talker_logits(params, hid, cfg)                        # (B, V)
            if dcfg.repeat_penalty != 1.0:
                logits = row_penalty(logits, save0, cnt, dcfg.repeat_penalty,
                                     dcfg.penalty_range)
            tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
            newly_eos = (tok0 == cfg.codec_eos_token_id) & ~fin
            done = torch.where(newly_eos, cnt, done)
            fin_e = fin | newly_eos
            tok0 = torch.where(fin_e, cfg.codec_pad_id, tok0).to(torch.int32)
            cur = torch.clamp(cnt, max=fbuf - 1)[:, None].long()
            save0.scatter_(1, cur, torch.where(fin_e[:, None], save0.gather(1, cur),
                                               tok0[:, None]))
            frame_ids, ce0 = pipe._predictor_batch(hid[:, None], tok0, bsz)   # (B, G)
            fcur = cur[:, :, None].expand(-1, 1, g)
            frames.scatter_(1, fcur, torch.where(fin_e[:, None, None], frames.gather(1, fcur),
                                                 frame_ids[:, None].to(torch.int32)))
            hit_cap = ~fin_e & (cnt + 1 >= cap)
            done = torch.where(hit_cap, cnt + 1, done)
            new_fin = fin_e | hit_cap
            nxt = next_talker_input_batch(params, frame_ids, ce0, trailing,
                                          torch.clamp(cnt, max=self.tb - 1), cfg)
            nxt = nxt * (~new_fin)[:, None, None]                         # dead rows: zeros
            pos = kv.length
            hid, kv = qwen3_stack_step(params["talker"], nxt.to(pipe.dtype), kv, t,
                                       params["rope_cos"][pos:pos + 1],
                                       params["rope_sin"][pos:pos + 1],
                                       kv_valid=kv_valid, fused=pipe._fused)
            cnt = torch.where(fin_e, cnt, cnt + 1)
            fin = new_fin
        s.update(kv=kv, hid=hid, cnt=cnt, fin=fin, done=done)

    def _admit_row(self, s, b: int, payload, cap: int) -> None:
        prefill, trailing, stream = payload
        if stream is not None:
            handle, window, left_context = stream
            s["stream"][b] = {
                "handle": handle, "prev": 0,
                "codec": ChunkedCodecStream(self._window_fn, window=window,
                                            left_context=left_context,
                                            upsample=self.ccfg.total_upsample,
                                            num_groups=self.cfg.num_code_groups)}
        else:
            s["stream"][b] = None
        params, t, dev, dt = self.pipe.params, self.cfg.talker, self.pipe.device, self.pipe.dtype
        p, pos, pb = prefill.shape[1], s["pos"], self.bucket
        buf = torch.zeros((1, pb, prefill.shape[2]), dtype=dt, device=dev)
        buf[0, pb - p:] = prefill[0].to(dev, dt)
        # the trailing text, its last (pad) embedding repeated, so a gather
        # past the true length returns the pad
        tr = trailing[0].to(dev, dt)
        s["trailing"][b, :tr.shape[0]] = tr
        s["trailing"][b, tr.shape[0]:] = tr[-1:]
        # the row's view of the batch cache: the prefill writes it in place
        # at [pos - bucket, pos), left pad masked
        kv = s["kv"]
        row = KVCache(kv.k[:, b:b + 1], kv.v[:, b:b + 1], pos - pb)
        kv_valid = torch.arange(self.kv_max, device=dev)[None, :] >= pos - p
        hid_all, _ = qwen3_stack_step(params["talker"], buf, row, t,
                                      params["rope_cos"][pos - pb:pos],
                                      params["rope_sin"][pos - pb:pos],
                                      kv_valid=kv_valid, return_all=True)
        s["kv"] = KVCache(kv.k, kv.v, pos)
        s["hid"][b] = hid_all[0, -1]
        s["frames"][b] = 0
        s["save0"][b] = 0
        s["cnt"][b] = 0
        s["fin"][b] = False
        s["done"][b] = cap
        s["kvf"][b] = pos - p
        s["cap"][b] = cap

    def _push(self, st: dict, frames_row: np.ndarray, new: int) -> None:
        if new > st["prev"]:
            out = st["codec"].push_frames(frames_row[st["prev"]:new])
            st["prev"] = new
            if out is not None and len(out):
                st["handle"]._put(out)

    def _post_chunk(self, s) -> None:
        if not any(st is not None for st in s["stream"]):
            return
        cnt = s["cnt"].cpu().numpy()
        frames_h = s["frames"].cpu().numpy()       # one fetch for all rows
        for b, st in enumerate(s["stream"]):
            if st is not None:
                self._push(st, frames_h[b], int(cnt[b]))

    def _finalize(self, s, b: int, n: int):
        st = s["stream"][b]
        if st is not None:
            s["stream"][b] = None
            self._push(st, s["frames"][b].cpu().numpy(), n)
            for out in st["codec"].finish():
                st["handle"]._put(out)
            st["handle"]._close(n)
            return None, n
        if n <= 0:
            return np.zeros(0, np.int16), 0
        wav, _ = self.pipe._vocode(s["frames"][b:b + 1],
                                   torch.full((1,), n, device=self.pipe.device),
                                   self.pipe._codec_fb(n))
        return wav[0, :n * self.ccfg.total_upsample].cpu().numpy(), n
