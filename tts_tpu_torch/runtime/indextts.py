"""IndexTTS synthesis from token ids: reference audio + text ids -> cloned
speech (counterpart of tts_tpu/runtime/indextts.py:IndexTTSPipeline,
without the text tokenizer and `mesh`).

Three stages, as tts_tpu's three programs:
  1. encode_reference: a 100 ms noise pad (numpy, from `seed`) in front of
     the audio, the 32768-sample bucket, the log-mel (constant STFT
     padding) -> conformer -> perceiver conds_latent; ECAPA -> cond_layer
     and the per-stage BigVGAN conds;
  2. decode: a prefill over [conds_latent | text | mel start] with the
     padded text positions masked (kv_valid), then a Python loop of GPT-2
     steps: the penalty vector and its sliding reset window stay on the
     device, the stop flag is read on the host once a step, and the
     hiddens buffer is kept in the compute dtype;
  3. vocode: rows past the generated frames zeroed, final_norm, the
     speaker-conditioned BigVGAN (kernel 10 on AMPBlock1 stages), int16.

Text lengths are bucketed to 16; this GPT-2 has no positional encoding of
its own, so the padded text positions are handled by the kv mask alone.
Decode steps take `fused_decode` ("step" by default, which the kv mask
degrades to kernel 11, as in tts_tpu).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..audio.mel import MelSpectrogram
from ..kv.cache import KVCache
from ..models.bigvgan import BigVGANConfig, bigvgan_apply
from ..models.indextts import (IndexTTSConfig, conformer_encoder, ecapa_speaker_encoder,
                               gpt_final_norm, gpt_step, perceiver_resample)
from ..quant.weight_only import quantize_int4, quantize_int8_eager

__all__ = ["IndexTTSPipeline", "IndexTTSDecodeConfig", "IndexTTSStats"]


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


class IndexTTSPipeline:
    """params: 'conformer', 'perceiver', 'ecapa', 'gpt', 'bigvgan',
    'cond_layer' ((spk_dim, C0) w, b) and 'conds' (one per BigVGAN stage),
    tts_tpu's tree (e.g. from `weights.convert.params_from_jax`). Runs on
    the device the params are on; `quantize` None, 8 or 4 (the GPT
    matmuls; encoders and vocoder stay float)."""

    def __init__(self, params: dict, cfg: IndexTTSConfig, bigvgan_cfg: BigVGANConfig,
                 sample_rate: int = 24000, n_fft: int = 1024, hop: int = 256,
                 seed: int = 0, decode_cfg: IndexTTSDecodeConfig | None = None,
                 quantize: int | None = None):
        if quantize not in (None, 8, 4):
            raise ValueError(f"quantize must be None, 8 or 4, got {quantize!r}")
        if quantize:
            params = {**params, "gpt": _quantize_gpt(params["gpt"], quantize)}
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
        gpt = params["gpt"]
        self.device = gpt["text_embed"].device
        self.dtype = gpt["text_embed"].dtype

    # -------------------------------------------------- reference encoding

    @torch.no_grad()
    def encode_reference(self, audio: np.ndarray):
        """audio: int16 or float mono at sample_rate. Returns the device
        tuple (conds_latent (1, L, D), cond_embed (1, 1, C0), conds)."""
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        rng = np.random.default_rng(self.seed)
        pad = rng.standard_normal(int(self.sample_rate * 0.1)).astype(np.float32)
        audio = np.concatenate([pad, audio.reshape(-1).astype(np.float32)])
        bucket = max(1, -(-len(audio) // 32768)) * 32768
        audio = np.pad(audio, (0, bucket - len(audio)))[None]
        p, cfg = self.params, self.cfg
        mel = self.melspec(torch.from_numpy(audio).to(self.device))    # (1, T, M) fp32
        conds_latent = perceiver_resample(
            p["perceiver"], conformer_encoder(p["conformer"], mel, cfg), cfg)
        spk = ecapa_speaker_encoder(p["ecapa"], mel, cfg)
        cond_embed = torch.matmul(spk, p["cond_layer"]["w"]) + p["cond_layer"]["b"]
        conds = [torch.matmul(spk, c["w"]) + c["b"] for c in p["conds"]]
        return conds_latent, cond_embed, conds

    # ------------------------------------------------------------- decode

    def _prefill(self, conds_latent: torch.Tensor, text_ids: np.ndarray,
                 text_len: np.ndarray, max_gen: int):
        """The prefill of B rows sharing a text bucket. Returns (logits, last
        hidden, cache, kv_valid (B, kv_max))."""
        cfg, gpt, dev = self.cfg, self.params["gpt"], self.device
        bsz, tb = text_ids.shape
        ids = np.concatenate([np.zeros((bsz, 1), np.int32), text_ids,
                              np.ones((bsz, 1), np.int32)], axis=1)
        tb2 = tb + 2
        tl = torch.from_numpy(text_len.astype(np.int64)).to(dev)
        text_emb = gpt["text_embed"][torch.from_numpy(ids).to(dev).long()] \
            + gpt["text_pos"][None, :tb2]
        # the [1] end token at its true position text_len + 1
        end_emb = (gpt["text_embed"][1][None] + gpt["text_pos"][tl + 1])[:, None]
        pos_idx = torch.arange(tb2, device=dev)[None, :, None]
        text_emb = torch.where(pos_idx == (tl + 1)[:, None, None], end_emb, text_emb)
        mel_start = (gpt["mel_embed"][cfg.start_mel_token] + gpt["mel_pos"][0])
        prefill = torch.cat([conds_latent, text_emb,
                             mel_start.expand(bsz, 1, cfg.gpt_dim)], dim=1)
        p_len = cfg.num_latents + tb2 + 1
        # the cache spans this call's prefill + generation budget, in the
        # params' compute dtype
        kv_max = min(cfg.max_seq_len, -(-(p_len + max_gen) // 256) * 256)
        kv_idx = torch.arange(kv_max, device=dev)[None, :]
        kv_valid = ~((kv_idx >= cfg.num_latents + (tl + 2)[:, None])
                     & (kv_idx < p_len - 1))
        kv = KVCache.create(cfg.gpt_layers, bsz, cfg.gpt_heads, kv_max, cfg.gpt_head_dim,
                            self.dtype, dev)
        ones = torch.ones((bsz, cfg.num_mel_codes), dtype=torch.float32, device=dev)
        logits, last, kv = gpt_step(gpt, prefill, kv, ones, cfg,
                                    kv_valid if bsz > 1 else kv_valid[0])
        return logits, last, kv, kv_valid, ones

    def _decode(self, conds_latent, text_ids: np.ndarray, text_len: np.ndarray,
                max_gen: int):
        """B rows of greedy decode with the repetition penalty. Returns
        (hiddens (B, max_gen, D), done (B,) host ints: tokens kept per row,
        the token ids (B, max_gen))."""
        cfg, gpt, dev = self.cfg, self.params["gpt"], self.device
        penalty, prange = self.dcfg.repeat_penalty, self.dcfg.penalty_range
        bsz = text_ids.shape[0]
        if max_gen > gpt["mel_pos"].shape[0]:
            # tts_tpu's gather clamps a position past the table; here it raises
            raise ValueError(f"max_gen {max_gen} exceeds the {gpt['mel_pos'].shape[0]} "
                             f"mel positions")
        logits, last, kv, kv_valid, vec = self._prefill(conds_latent, text_ids, text_len,
                                                        max_gen)
        mask = kv_valid if bsz > 1 else kv_valid[0]
        rows = torch.arange(bsz, device=dev)
        tok = torch.argmax(logits, dim=-1)                          # (B,)
        hiddens = torch.zeros((bsz, max_gen, cfg.gpt_dim), dtype=self.dtype, device=dev)
        hiddens[:, 0] = last
        save = torch.zeros((bsz, max_gen), dtype=torch.long, device=dev)
        save[:, 0] = tok
        fin = tok == cfg.stop_token
        done = torch.where(fin, 1, max_gen)
        rst = torch.zeros((bsz,), dtype=torch.long, device=dev)
        num = 1
        while num < max_gen and not bool(fin.all()):
            # the penalty vector and its sliding reset window (the
            # reference's host loop), on the device
            vec[rows, tok] = penalty
            if num > prange:
                old = save[rows, rst]
                reset = (old != tok) & ~fin
                vec[rows, old] = torch.where(reset, 1.0, vec[rows, old])
                rst = rst + reset.long()
            h = (gpt["mel_embed"][tok] + gpt["mel_pos"][num][None])[:, None]
            logits, last, kv = gpt_step(gpt, h, kv, vec, cfg, mask, fused=self._fused)
            ntok = torch.where(fin, cfg.stop_token, torch.argmax(logits, dim=-1))
            save[:, num] = ntok
            hiddens[:, num] = last
            newly = (ntok == cfg.stop_token) & ~fin
            done = torch.where(newly, num + 1, done)
            fin = fin | newly
            tok = ntok
            num += 1
        return hiddens, np.minimum(done.cpu().numpy(), num), save

    # ------------------------------------------------------------- vocode

    def _vocode(self, hiddens: torch.Tensor, frames: list[int], fb: int,
                cond_embed: torch.Tensor, conds: list) -> torch.Tensor:
        """hiddens (n, max_gen, D) -> int16 (n, fb * total_upsample): rows
        past each row's frame count zeroed, final_norm, the conditioned
        BigVGAN."""
        n = torch.tensor(frames, device=self.device)
        h = hiddens[:, :fb] * (torch.arange(fb, device=self.device)[None, :]
                               < n[:, None])[..., None]
        latent = gpt_final_norm(self.params["gpt"], h)
        wav = bigvgan_apply(self.params["bigvgan"], latent, self.vcfg, conds=conds,
                            cond_embed=cond_embed)
        return (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)

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
        hiddens, done, _ = self._decode(conds_latent, ids, np.array([tlen]), max_gen)
        num = int(done[0])
        # the last 2 collected hiddens are dropped (the reference's latent[:-2])
        n_frames = max(num - 2, 0)
        if n_frames == 0:
            return np.zeros(0, np.int16), IndexTTSStats(num, 0.0)
        fb = min(max(8, -(-n_frames // 8) * 8), max_gen)
        wav = self._vocode(hiddens, [n_frames], fb, cond_embed, conds)
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
        hiddens, done, _ = self._decode(conds_latent, ids, tlens, max_gen)
        frames = [max(int(d) - 2, 0) for d in done]
        live = [b for b in range(bsz) if frames[b] > 0]
        wavs = [np.zeros(0, np.int16)] * bsz
        if live:
            fb = min(max(8, -(-max(frames[b] for b in live) // 8) * 8), max_gen)
            refs = [requests[b][1] for b in live]
            cond_embed = torch.cat([r[1] for r in refs], dim=0)
            conds = [torch.cat([r[2][i] for r in refs], dim=0)
                     for i in range(len(refs[0][2]))]
            wav = self._vocode(hiddens[live], [frames[b] for b in live], fb, cond_embed,
                               conds).cpu().numpy()
            up = self.vcfg.total_upsample
            for i, b in enumerate(live):
                wavs[b] = wav[i, :frames[b] * up]
        wall = time.perf_counter() - t0
        total = int(done.sum())
        return wavs, {"tokens": total, "wall_s": wall,
                      "tokens_per_s": total / max(wall, 1e-9)}
