"""Qwen3-TTS synthesis: the two-level talker / code-predictor decode and the
12 Hz codec (counterpart of tts_tpu/runtime/qwen.py:QwenTTSPipeline,
without `synthesize_streaming`, voice clone, int4 and
`mesh`, which are not ported yet).

A frame step, as in tts_tpu's while-loop body: talker logits (codec head,
suppress bias, repetition penalty) -> greedy group-0 token -> the
predictor's 15 groups (greedy or beam) -> the next talker input (the
group embeddings and the trailing text) -> one talker step. Here it is a
Python loop over frames. Every selection stays on the device; the host
reads one flag a frame, the EOS stop (every row stopped, in a batch). The
EOS frame is computed and dropped, as in tts_tpu.

The prefill goes through the talker as one pass over the MAX_PREFILL
bucket, then the cache is rewound to the true length. The cache bucket is
tts_tpu's: kv_max = min(max_seq_len, ceil((512 + max_frames + 1) / 128) *
128), 640 rows at max_frames = 120 (where kernel 13's gate, 256 | T, fails
and "attn"/"all" take gqa_attention on the talker) and 768 at 128. The codec
decodes a bucket of fb = min(max(8, ceil(frames / 8) * 8), max_frames)
frames with the frames past the generated ones zeroed: its pre-transformer
attends both ways, so the bucket is part of the output.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..decoding.sampling import apply_repetition_penalty
from ..kv.cache import KVCache
from ..models.qwen_codec import QwenCodecDecoderConfig, codec_decode
from ..models.qwen_tts import (QwenTTSConfig, next_talker_input, next_talker_input_batch,
                               predictor_frame, predictor_frame_beam,
                               predictor_frame_beam_batch, qwen3_stack_step,
                               talker_logits)

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


class QwenTTSPipeline:
    """Qwen3-TTS over the merged talker + predictor params dict and the
    codec decoder's (tts_tpu's layouts, e.g. from
    `weights.convert.params_from_jax` or the models' init functions). Runs
    on the device the params are on."""

    # the 12 Hz codec's native rate (tts_tpu's default; resampling to another
    # rate is not ported)
    output_sample_rate = 24000

    def __init__(self, params: dict, cfg: QwenTTSConfig, codec_params: dict,
                 codec_cfg: QwenCodecDecoderConfig,
                 decode_cfg: QwenDecodeConfig | None = None, quantize: int | None = None):
        if quantize not in (None, 8):
            raise ValueError(f"quantize must be None or 8, got {quantize!r}")
        if quantize:
            # int8 on the talker and predictor matmuls; lm_heads,
            # group_embeds, codec_head and the codec stay float
            from ..quant.weight_only import quantize_pytree

            params = quantize_pytree(params, bits=quantize)
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
        self.device = params["talker_codec_embed"].device
        self.dtype = params["talker_codec_embed"].dtype

    # ------------------------------------------------------------- prefill

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
        p, cfg = self.params, self.cfg
        dev = self.device
        _check_special_ids(p["text_embed"].shape[0], cfg)

        def ids_t(ids) -> torch.Tensor:
            return torch.as_tensor(np.asarray(ids, np.int64), device=dev)

        def text_embed(ids):
            e = p["text_embed"][ids_t(ids)].float()
            return torch.matmul(e, p["text_proj_w"].float()) + p["text_proj_b"].float()

        def codec_embed(ids):
            return p["talker_codec_embed"][ids_t(ids)].float()

        tts_bos, tts_eos, tts_pad = text_embed(
            [[cfg.tts_bos_token_id, cfg.tts_eos_token_id, cfg.tts_pad_token_id]]).split(1, 1)
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

    # -------------------------------------------------------------- decode

    def _kv_max(self, prefill_rows: int) -> int:
        t = self.cfg.talker
        return min(t.max_seq_len,
                   -(-(prefill_rows + self.dcfg.max_frames + 1) // 128) * 128)

    def _penalized(self, logits: torch.Tensor, save0: torch.Tensor, num: int):
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

    def _rope(self, pos: int) -> tuple:
        p = self.params
        return p["rope_cos"][pos:pos + 1], p["rope_sin"][pos:pos + 1]

    def _decode(self, prefill_buf: torch.Tensor, prefill_len: int,
                trailing: torch.Tensor) -> tuple[torch.Tensor, int]:
        """One request: prefill over the bucket, rewind, then the frame loop.
        Returns (frames (max_frames, G) int32 on the device, frames kept)."""
        cfg, dcfg, params = self.cfg, self.dcfg, self.params
        t = cfg.talker
        s_buf = prefill_buf.shape[1]
        kv = KVCache.create(t.num_layers, 1, t.num_kv_heads, self._kv_max(s_buf),
                            t.head_dim, self.dtype, self.device)
        hid_all, kv = qwen3_stack_step(params["talker"], prefill_buf.to(self.dtype), kv, t,
                                       params["rope_cos"][:s_buf], params["rope_sin"][:s_buf],
                                       return_all=True)
        hid = hid_all[:, prefill_len - 1]
        kv = kv.rewind(prefill_len)
        trailing = trailing.to(self.dtype)
        frames = torch.zeros((dcfg.max_frames, cfg.num_code_groups), dtype=torch.int32,
                             device=self.device)
        save0 = torch.zeros((1, dcfg.max_frames), dtype=torch.int32, device=self.device)
        num, fin = 0, False
        while not fin and num < dcfg.max_frames:
            logits = self._penalized(talker_logits(params, hid, cfg), save0, num)
            tok0 = torch.argmax(logits, dim=-1).to(torch.int32)                 # (1,)
            save0[:, num] = tok0
            frame_ids, ce0 = self._predictor(hid[:, None], tok0)
            frames[num] = frame_ids
            nxt = next_talker_input(params, frame_ids, ce0, trailing,
                                    min(num, trailing.shape[1] - 1), cfg)
            hid, kv = qwen3_stack_step(params["talker"], nxt, kv, t, *self._rope(kv.length),
                                       fused=self._fused)
            num += 1
            fin = bool(tok0[0] == cfg.codec_eos_token_id)     # the one host read a frame
        return frames, num - int(fin)

    def _decode_batch(self, prefill_buf: torch.Tensor, pad_start: torch.Tensor,
                      trailing: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """B prefills right-justified in one bucket, per-row key validity
        masking the left pad, per-row stop tracking. Returns (frames (B,
        max_frames, G), frames kept per row (B,))."""
        cfg, dcfg, params = self.cfg, self.dcfg, self.params
        t = cfg.talker
        bsz, s_buf = prefill_buf.shape[:2]
        dev = self.device
        valid = torch.arange(s_buf, device=dev)[None, :] >= pad_start[:, None]
        prefill_buf = prefill_buf.to(self.dtype) * valid[..., None]
        kv_max = self._kv_max(s_buf)
        kv = KVCache.create(t.num_layers, bsz, t.num_kv_heads, kv_max, t.head_dim,
                            self.dtype, dev)
        kv_valid = torch.arange(kv_max, device=dev)[None, :] >= pad_start[:, None]
        hid_all, kv = qwen3_stack_step(params["talker"], prefill_buf, kv, t,
                                       params["rope_cos"][:s_buf], params["rope_sin"][:s_buf],
                                       kv_valid=kv_valid, return_all=True)
        hid = hid_all[:, -1]
        trailing = trailing.to(self.dtype)
        frames = torch.zeros((bsz, dcfg.max_frames, cfg.num_code_groups), dtype=torch.int32,
                             device=dev)
        save0 = torch.zeros((bsz, dcfg.max_frames), dtype=torch.int32, device=dev)
        fin = torch.zeros((bsz,), dtype=torch.bool, device=dev)
        done = torch.full((bsz,), dcfg.max_frames, dtype=torch.int32, device=dev)
        num = 0
        while num < dcfg.max_frames and not (num and bool(fin.all())):
            logits = self._penalized(talker_logits(params, hid, cfg), save0, num)
            tok0 = torch.argmax(logits, dim=-1).to(torch.int32)                 # (B,)
            newly = (tok0 == cfg.codec_eos_token_id) & ~fin
            done = torch.where(newly, num, done)
            fin = fin | newly
            tok0 = torch.where(fin, cfg.codec_pad_id, tok0).to(torch.int32)
            save0[:, num] = tok0
            frame_ids, ce0 = self._predictor_batch(hid[:, None], tok0, bsz)
            frames[:, num] = frame_ids
            nxt = next_talker_input_batch(params, frame_ids, ce0, trailing,
                                          min(num, trailing.shape[1] - 1), cfg)
            hid, kv = qwen3_stack_step(params["talker"], nxt, kv, t, *self._rope(kv.length),
                                       kv_valid=kv_valid, fused=self._fused)
            num += 1
        return frames, torch.clamp(done, max=num)

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
        return (wav * 32767.0).to(torch.int16), wav.abs().amax()

    # -------------------------------------------------------------- public

    @staticmethod
    def _trailing_bucket(trailing: torch.Tensor) -> int:
        return max(64, -(-trailing.shape[1] // 64) * 64)

    def _trailing_buf(self, trailing: torch.Tensor, tb: int) -> torch.Tensor:
        """(1, Tt, H) -> (1, tb, H): rows past the true length repeat the last
        (pad) embedding, so a gather beyond it returns the pad."""
        pad = trailing[:, -1:].expand(1, tb - trailing.shape[1], -1)
        return torch.cat([trailing, pad], dim=1)

    @torch.no_grad()
    def synthesize_from_prefill(self, prefill, trailing) -> tuple[np.ndarray, dict]:
        """prefill (1, P, H), trailing (1, Tt, H) (from build_prefill_embeds;
        numpy or tensors). Returns (int16 waveform, {"frames", "wall_s",
        "frames_per_s", "peak"})."""
        prefill = torch.as_tensor(prefill, device=self.device).float()
        trailing = torch.as_tensor(trailing, device=self.device).float()
        p_len = prefill.shape[1]
        if not 1 <= p_len <= MAX_PREFILL:
            raise ValueError(f"prefill of {p_len} rows, the bucket holds {MAX_PREFILL}")
        t0 = time.perf_counter()
        buf = torch.zeros((1, MAX_PREFILL, prefill.shape[2]), device=self.device)
        buf[:, :p_len] = prefill
        tr = self._trailing_buf(trailing, self._trailing_bucket(trailing))
        frames, num = self._decode(buf, p_len, tr)
        if num == 0:
            return np.zeros(0, np.int16), {"frames": 0, "wall_s": 0.0}
        wav, peak = self._vocode(frames[None], torch.tensor([num], device=self.device),
                                 self._codec_fb(num))
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
        pad_start = torch.tensor([pmax - p.shape[1] for p, _ in reqs], dtype=torch.int32,
                                 device=dev)
        for b, (p, _) in enumerate(reqs):
            buf[b, pmax - p.shape[1]:] = p[0]
        tr_buf = torch.cat([self._trailing_buf(tr, tb) for _, tr in reqs], dim=0)
        frames, done = self._decode_batch(buf, pad_start, tr_buf)
        nfr = [int(n) for n in done.cpu()]
        wavs = [np.zeros(0, np.int16)] * bsz
        live = [b for b in range(bsz) if nfr[b] > 0]
        peak = 0.0
        if live:
            rows = torch.tensor(live, device=dev)
            wav, pk = self._vocode(frames.index_select(0, rows), done.index_select(0, rows),
                                   self._codec_fb(max(nfr[b] for b in live)))
            wav, peak = wav.cpu().numpy(), float(pk)
            up = self.codec_cfg.total_upsample
            for i, b in enumerate(live):
                wavs[b] = wav[i, :nfr[b] * up]
        wall = time.perf_counter() - t0
        total = sum(nfr)
        return wavs, {"frames": total, "wall_s": wall,
                      "frames_per_s": total / max(wall, 1e-9), "peak": peak}

    def synthesize_ids(self, text_ids: np.ndarray, language_id: int = 0,
                       speaker_id: int | None = None,
                       instruct_ids: np.ndarray | None = None) -> tuple[np.ndarray, dict]:
        prefill, trailing = self.build_prefill_embeds(text_ids, language_id, speaker_id,
                                                      instruct_ids=instruct_ids)
        return self.synthesize_from_prefill(prefill, trailing)
