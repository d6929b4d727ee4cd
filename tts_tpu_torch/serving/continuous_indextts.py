"""Slot-based continuous batching for the IndexTTS AR decode (counterpart
of tts_tpu/serving/continuous_indextts.py).

A family adapter over serving/slots.SlotEngine. Each chunk step runs one
GPT-2 decode step a row with the reference's repetition-penalty VECTOR and
its sliding reset window (Export_IndexTTS.py:1197-1201), kept per row at
the row's own cursor; each attention layer's step takes kernel 11 at 1-8
slots (the kv masks degrade gpt_step's "step" route to the qkv head). The
shared kv position is sound here because this GPT-2 has no positional
encoding of its own: text and mel positions come from learned tables added
to the inputs, so a row spliced at any kv offset computes what it would
alone; only the causal mask and the per-row validity mask matter.

Admission assembles the [conds_latent | text_emb | mel_start] prefill (the
solo decode's layout, with the bucketed-text hole masked by the row's
validity) right-justified at the batch's shared position, written in place
into the batch's KV row. Finished rows vocode through the
speaker-conditioned BigVGAN (kernel 10 on its AMPBlock1 stages) from the
row's hidden buffer, with the conditioning captured at admission.

A mel position past the learned table is refused (at construction or at
submit), never clamped: tts_tpu's slot server clamps the gather.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kv.cache import KVCache
from ..models.indextts import gpt_step
from .slots import SlotEngine

__all__ = ["IndexTTSSlotServer"]


class IndexTTSSlotServer(SlotEngine):
    """Continuous-batching server over an IndexTTSPipeline, on the device of
    its params.

    submit(text_ids, ref) -> Future resolving to (int16 wav, n_tokens).
    text_ids (1, T) int32 BPE ids; ref = pipeline.encode_reference(...)
    (conds_latent, cond_embed, conds).
    """

    def __init__(self, pipeline, *, slots: int = 4, chunk: int = 32,
                 text_bucket: int = 32, max_gen: int | None = None,
                 max_seq_len: int | None = None, queue_limit: int = 256,
                 ref=None):
        self.pipe = pipeline
        # server-fixed conditioning (used when submit omits ref)
        self.ref = ref
        self.cfg = cfg = pipeline.cfg
        self.tb = text_bucket
        self.gbuf = max_gen or cfg.max_mel_tokens
        self.mel_positions = int(pipeline.params["gpt"]["mel_pos"].shape[0])
        if self.gbuf > self.mel_positions:
            raise ValueError(f"max_gen {self.gbuf} passes the {self.mel_positions} learned "
                             f"mel positions")
        # prefill layout: conds_latent + ([0] + bucketed ids + [1]) + mel start
        self.p_len = cfg.num_latents + self.tb + 2 + 1
        kv_max = min(max_seq_len or cfg.max_seq_len, cfg.max_seq_len)
        kv_max = (kv_max // 128) * 128 or kv_max
        if self.p_len + self.gbuf + chunk > kv_max:
            raise ValueError(f"kv budget {kv_max} too small for prefill {self.p_len} + "
                             f"max_gen {self.gbuf} + chunk {chunk}")
        self.kv_max = kv_max
        self._slots = slots
        super().__init__(slots=slots, chunk=chunk, seq_limit=kv_max,
                         start_pos=self.p_len, queue_limit=queue_limit,
                         name="indextts-slot-server", device=pipeline.device)

    # ------------------------------------------------------------- client

    def submit(self, text_ids: np.ndarray, ref=None, max_gen: int | None = None,
               deadline_s: float | None = None):
        ref = self.ref if ref is None else ref
        if ref is None:
            raise ValueError("no ref: pass encode_reference output to submit or "
                             "construct with ref=")
        if text_ids.shape[1] > self.tb:
            raise ValueError(f"text {text_ids.shape[1]} > bucket {self.tb}")
        if max_gen is not None and max_gen > self.mel_positions:
            raise ValueError(f"max_gen {max_gen} passes the {self.mel_positions} learned "
                             f"mel positions")
        cap = min(max_gen or self.gbuf, self.gbuf)
        return self._submit((np.asarray(text_ids, np.int32), ref), cap,
                            deadline_s=deadline_s)

    # ------------------------------------------------------ engine hooks

    def _row_valid(self, kvf: torch.Tensor, tlen: torch.Tensor) -> torch.Tensor:
        """(B, kv_max) key validity: a row starts at kvf, with the
        bucketed-text hole [kvf + n_lat + tlen + 2, kvf + p_len - 1) masked
        out (the solo prefill's hole, shifted by the row's offset)."""
        n_lat = self.cfg.num_latents
        idx = torch.arange(self.kv_max, device=kvf.device)[None, :]
        hole = (idx >= (kvf + n_lat + tlen + 2)[:, None]) & (idx < (kvf + self.p_len - 1)[:, None])
        return (idx >= kvf[:, None]) & ~hole

    def _fresh(self):
        bsz, cfg, dev, dt = self._slots, self.cfg, self.pipe.device, self.pipe.dtype

        def z():
            return torch.zeros((bsz,), dtype=torch.long, device=dev)

        return {
            "kv": KVCache.create(cfg.gpt_layers, bsz, cfg.gpt_heads, self.kv_max,
                                 cfg.gpt_head_dim, dt, dev),
            "vec": torch.ones((bsz, cfg.num_mel_codes), dtype=torch.float32, device=dev),
            "save": torch.zeros((bsz, self.gbuf), dtype=torch.long, device=dev),
            "hiddens": torch.zeros((bsz, self.gbuf, cfg.gpt_dim), dtype=dt, device=dev),
            "cnt": z(), "tok": z(), "rst": z(), "done": z(),
            "fin": torch.ones((bsz,), dtype=torch.bool, device=dev),
            "kvf": z(), "tlen": z(), "cap": z(),
            "voc": [None] * bsz,          # (cond_embed, conds) per slot
        }

    def _step_chunk(self, s) -> None:
        cfg, dcfg, gpt = self.cfg, self.pipe.dcfg, self.pipe.params["gpt"]
        penalty, prange, stop = dcfg.repeat_penalty, dcfg.penalty_range, cfg.stop_token
        kv, vec, save, hiddens, cnt, tok, rst, fin, done = (s[k] for k in (
            "kv", "vec", "save", "hiddens", "cnt", "tok", "rst", "fin", "done"))
        cap = s["cap"]
        kv_valid = self._row_valid(s["kvf"], s["tlen"])
        for _ in range(self.chunk):
            live = ~fin
            # the penalty vector (reference :1197-1201), per row; dead rows
            # index id 0 and write back what is there
            t = torch.where(fin, 0, tok)[:, None]
            vec.scatter_(1, t, torch.where(fin[:, None], vec.gather(1, t), penalty))
            old = torch.where(fin, 0, save.gather(1, rst[:, None])[:, 0])
            reset = (cnt > prange) & (old != tok) & live
            o = old[:, None]
            vec.scatter_(1, o, torch.where(reset[:, None], 1.0, vec.gather(1, o)))
            rst = rst + reset.long()
            # a live row's count is below its cap, which the table holds
            h = gpt["mel_embed"][torch.where(fin, 0, tok)] + gpt["mel_pos"][torch.where(fin, 0, cnt)]
            h = (h * live[:, None])[:, None]              # dead rows embed zeros
            logits, last_h, kv = gpt_step(gpt, h, kv, vec, cfg, kv_valid,
                                          fused=self.pipe._fused)
            ntok = torch.where(fin, stop, torch.argmax(logits, dim=-1))
            cur = torch.clamp(cnt, max=self.gbuf - 1)[:, None]
            save.scatter_(1, cur, torch.where(fin[:, None], save.gather(1, cur), ntok[:, None]))
            hcur = cur[:, :, None].expand(-1, 1, hiddens.shape[2])
            hiddens.scatter_(1, hcur, torch.where(fin[:, None, None], hiddens.gather(1, hcur),
                                                  last_h[:, None].to(hiddens.dtype)))
            newly = ((ntok == stop) | (cnt + 1 >= cap)) & live
            done = torch.where(newly, cnt + 1, done)
            cnt = torch.where(fin, cnt, cnt + 1)
            tok = ntok
            fin = fin | newly
        s.update(kv=kv, cnt=cnt, tok=tok, rst=rst, fin=fin, done=done)

    def _admit_row(self, s, b: int, payload, cap: int) -> None:
        text_ids, (conds_latent, cond_embed, conds) = payload
        cfg, gpt, dev = self.cfg, self.pipe.params["gpt"], self.pipe.device
        tlen, pos = text_ids.shape[1], s["pos"]
        ids = np.zeros((1, self.tb + 2), np.int64)
        ids[0, 1:1 + tlen] = text_ids[0]
        ids[0, -1] = 1
        tb2 = ids.shape[1]
        text_emb = gpt["text_embed"][torch.from_numpy(ids).to(dev)] + gpt["text_pos"][None, :tb2]
        # the [1] end token at its true position tlen + 1
        text_emb[:, tlen + 1] = gpt["text_embed"][1] + gpt["text_pos"][tlen + 1]
        mel_start = gpt["mel_embed"][cfg.start_mel_token] + gpt["mel_pos"][0]
        prefill = torch.cat([conds_latent.to(dev), text_emb, mel_start[None, None]], dim=1)
        base = pos - self.p_len
        kv = s["kv"]
        row = KVCache(kv.k[:, b:b + 1], kv.v[:, b:b + 1], base)
        kv_valid = self._row_valid(torch.full((1,), base, device=dev),
                                   torch.full((1,), tlen, device=dev))
        ones = torch.ones((1, cfg.num_mel_codes), dtype=torch.float32, device=dev)
        logits, last_h, _ = gpt_step(gpt, prefill, row, ones, cfg, kv_valid)
        tok = torch.argmax(logits, dim=-1)[0]
        s["kv"] = KVCache(kv.k, kv.v, pos)
        first_fin = tok == cfg.stop_token
        s["vec"][b] = 1.0
        s["save"][b] = 0
        s["save"][b, 0] = tok
        s["hiddens"][b] = 0
        s["hiddens"][b, 0] = last_h[0]
        s["cnt"][b] = 1
        s["tok"][b] = tok
        s["rst"][b] = 0
        s["fin"][b] = first_fin
        s["done"][b] = torch.where(first_fin, 1, cap)
        s["kvf"][b] = base
        s["tlen"][b] = tlen
        s["cap"][b] = cap
        s["voc"][b] = (cond_embed, conds)

    def _finalize(self, s, b: int, n: int):
        cond_embed, conds = s["voc"][b]
        s["voc"][b] = None
        n_frames = max(n - 2, 0)          # the reference's latent[:-2]
        if n_frames == 0:
            return np.zeros(0, np.int16), n
        fb = min(max(8, -(-n_frames // 8) * 8), self.gbuf)
        dev = self.pipe.device
        wav = self.pipe._vocode(s["hiddens"][b:b + 1], [n_frames], fb, cond_embed.to(dev),
                                [c.to(dev) for c in conds])
        return wav[0, :n_frames * self.pipe.vcfg.total_upsample].cpu().numpy(), n
