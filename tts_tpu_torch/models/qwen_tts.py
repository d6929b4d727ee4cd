"""Qwen3-TTS two-level AR LM: the talker and the RVQ code predictor
(counterpart of tts_tpu/models/qwen_tts.py).

Plain functions over a params dict with tts_tpu's keys and load-time folds:
Qwen3 decoder layers with the input/post norms absorbed into wqkv and
w_gate_up, per-head q/k RMSNorm carrying d^-0.25, GQA attention with
half-split RoPE, a SwiGLU MLP; the talker's codec head plus the bias that
suppresses the last 1024 ids but EOS; the predictor behind small_to_mtp,
with 15 stacked LM heads (15, H, V) and group embeddings (15, V, H).

`qwen3_stack_step` takes tts_tpu's decode routes (`fused`), under tts_tpu's
gates plus the CUDA kernels' own limits, on every device (the CPU runs each
kernel's twin):
  "step"    kernel 12 (qkv head + attention, ops/decode_step.py): B = 1, no
            kv_valid, causal, head_dim 128, a batch-1 cache; else True;
  True      kernel 11 (the qkv head, ops/decode_qkv.py), then attention;
  "attn"    kernel 13 (ops/decode_attention.py) for the attention, with a
            shared length, causal, and a cache bucket that min(256, T)
            divides; "all" adds kernel 11 and kernel 14;
  "mlp"     kernel 14 (ops/decode_mlp.fused_out_mlp) for the layer tail;
  "mlp_q8"  kernel 11 and kernel 15 (the W8A8 tail) when wo, w_gate_up and
            w_down of every layer are int8 QTensors;
  False     plain ops.
The KV cache is written in place (kv/cache.py). The decode loops of
runtime/qwen.py keep every selection on the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..decoding.beam import beam_init, beam_init_batch, beam_step, beam_step_batch
from ..decoding.sampling import apply_repetition_penalty
from ..kv.cache import KVCache
from ..nn.attention import attention_mask, combine_kv_valid, gqa_attention
from ..nn.norm import rms_norm
from ..nn.rope import apply_rope, rope_table
from ..ops.decode_attention import attn_fits, decode_gqa_attention
from ..ops.decode_mlp import fused_out_mlp, fused_out_mlp_q8, out_mlp_fits
from ..ops.decode_qkv import fusable_layout, fusable_weight, fused_qkv_rope, qkv_fits
from ..ops.decode_step import fused_qkv_attn, step_fits
from ..quant.weight_only import QTensor, dense

__all__ = ["Qwen3StackConfig", "QwenTTSConfig", "qwen3_stack_step", "stack_routes",
           "talker_logits", "make_suppress_bias", "predictor_frame",
           "predictor_frame_beam", "predictor_frame_beam_batch", "next_talker_input",
           "next_talker_input_batch", "init_stack_params", "init_talker_params",
           "init_predictor_params"]


@dataclass(frozen=True)
class Qwen3StackConfig:
    """One Qwen3 decoder stack (talker or code predictor)."""

    hidden_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    ffn_dim: int
    num_layers: int
    rms_eps: float = 1e-6
    rope_base: float = 1000000.0
    max_seq_len: int = 2048


@dataclass(frozen=True)
class QwenTTSConfig:
    """Defaults = Qwen3-TTS-0.6B-Base, as tts_tpu's."""

    talker: Qwen3StackConfig = Qwen3StackConfig(
        hidden_size=1024, num_heads=16, num_kv_heads=8, head_dim=128,
        ffn_dim=3072, num_layers=28, max_seq_len=2048)
    predictor: Qwen3StackConfig = Qwen3StackConfig(
        hidden_size=1024, num_heads=16, num_kv_heads=8, head_dim=128,
        ffn_dim=3072, num_layers=4, max_seq_len=32)
    codec_vocab: int = 3072            # talker codec head vocab
    group_vocab: int = 2048            # per-RVQ-group vocab
    num_code_groups: int = 16
    codec_eos_token_id: int = 2150
    codec_bos_id: int = 2149
    codec_pad_id: int = 2148
    codec_think_id: int = 2154
    codec_think_bos_id: int = 2155
    codec_think_eos_id: int = 2156
    # special TEXT tokens
    tts_bos_token_id: int = 151672
    tts_eos_token_id: int = 151673
    tts_pad_token_id: int = 151671
    text_vocab: int = 151936
    text_hidden: int = 2048            # talker text_embedding dim (projected)


# --------------------------------------------------------------------------
# Generic Qwen3 decoder stack

@dataclass(frozen=True)
class _Routes:
    step: bool = False       # kernel 12
    qkv: bool = False        # kernel 11
    attn: bool = False       # kernel 13
    mlp: bool = False        # kernel 14
    mlp_q8: bool = False     # kernel 15


def stack_routes(params: dict, cfg: Qwen3StackConfig, batch: int, s: int, kv: KVCache,
                 kv_valid, causal: bool, fused) -> _Routes:
    """tts_tpu's gates (models/qwen_tts.py:qwen3_stack_step), plus the CUDA
    kernels' own limits, so a step takes the same route on every device."""
    if not fused:
        return _Routes()
    if s != 1:
        raise ValueError("fused decode path requires S == 1")
    layers = params["layers"]
    heads, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wqkv_ok = all(fusable_weight(p["wqkv"]) for p in layers)
    # kernels 11/12: head dims 64 and 128, <= 8 rows, their input widths
    qkv_ok = qkv_fits(batch, cfg.hidden_size, hd)
    step = (fused == "step" and batch == 1 and kv_valid is None and causal
            and hd == 128 and kv.k.shape[1] == 1 and wqkv_ok and qkv_ok
            and heads % kvh == 0 and step_fits(heads // kvh, hd, kv.length))
    if fused == "step" and not step:
        fused = True                                  # degrade to the qkv head
    qkv = (fused in (True, "all", "qkv", "mlp_q8") and qkv_ok and wqkv_ok
           and fusable_layout(batch, heads, kvh, hd))
    a_dim, ffn = heads * hd, cfg.ffn_dim
    tail_fits = out_mlp_fits(batch, a_dim, cfg.hidden_size, ffn)
    mlp = fused in ("all", "mlp") and tail_fits
    mlp_q8 = (fused == "mlp_q8" and tail_fits and all(
        isinstance(p[k], QTensor) and p[k].q.dtype == torch.int8
        for p in layers for k in ("wo", "w_gate_up", "w_down")))
    attn = (fused in ("all", "attn") and kv_valid is None and causal
            and kv.max_len % min(256, kv.max_len) == 0
            and attn_fits(heads, kvh, hd, min(256, kv.max_len)))
    return _Routes(step=step, qkv=qkv, attn=attn, mlp=mlp, mlp_q8=mlp_q8)


def qwen3_stack_step(params: dict, hidden: torch.Tensor, kv: KVCache,
                     cfg: Qwen3StackConfig, rope_cos, rope_sin,
                     kv_valid: torch.Tensor | None = None, causal: bool = True,
                     return_all: bool = False, fused=False):
    """One pass over S new positions. hidden (B, S, H); kv_valid (B, T) key
    validity per row or None. Returns (final hidden rms-normed, (B, H), or
    (B, S, H) with return_all; the cache advanced by S). The cache rows are
    written in place."""
    b, s, _ = hidden.shape
    pos = kv.length
    n = pos + s
    routes = stack_routes(params, cfg, b, s, kv, kv_valid, causal, fused)
    heads, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q_sz, kv_sz = heads * hd, kvh * hd
    mask = None
    if not (routes.step or routes.attn):
        # keys past pos + s are masked: attend over the rows that can be valid
        mask = attention_mask(s, n, pos, n, causal=causal, device=hidden.device)
        if kv_valid is not None:
            mask = combine_kv_valid(mask, kv_valid[:, :n])
    x = hidden
    for i, p in enumerate(params["layers"]):
        if routes.step:
            out, kf, vf = fused_qkv_attn(
                x[:, 0], p["wqkv"], rope_cos, rope_sin, kv.k, kv.v, i, pos,
                heads=heads, kv_heads=kvh, head_dim=hd, q_norm=p["q_norm"],
                k_norm=p["k_norm"], bqkv=p.get("bqkv"), eps=cfg.rms_eps)
            kv.update_layer(i, kf.reshape(b, 1, kvh, hd), vf.reshape(b, 1, kvh, hd))
            out = out[:, None]
        else:
            if routes.qkv:
                qf, kf, vf = fused_qkv_rope(
                    x[:, 0], p["wqkv"], rope_cos, rope_sin, heads=heads, kv_heads=kvh,
                    head_dim=hd, q_norm=p["q_norm"], k_norm=p["k_norm"],
                    bqkv=p.get("bqkv"), eps=cfg.rms_eps)
                q = qf.reshape(b, 1, heads, hd)
                k = kf.reshape(b, 1, kvh, hd)
                v = vf.reshape(b, 1, kvh, hd)
            else:
                qkv = dense(rms_norm(x, eps=cfg.rms_eps), p["wqkv"])
                if "bqkv" in p:
                    qkv = qkv + p["bqkv"]
                q = qkv[..., :q_sz].reshape(b, s, heads, hd)
                k = qkv[..., q_sz:q_sz + kv_sz].reshape(b, s, kvh, hd)
                v = qkv[..., q_sz + kv_sz:].reshape(b, s, kvh, hd)
                q = apply_rope(rms_norm(q, p["q_norm"], eps=cfg.rms_eps), rope_cos, rope_sin)
                k = apply_rope(rms_norm(k, p["k_norm"], eps=cfg.rms_eps), rope_cos, rope_sin)
            _, k_full, v_full = kv.update_layer(i, k, v)
            if routes.attn:
                out = decode_gqa_attention(q.reshape(b, heads, hd), k_full, v_full,
                                           pos + 1).reshape(b, 1, -1)
            else:
                out = gqa_attention(q, k_full[:, :, :n], v_full[:, :, :n],
                                    mask).reshape(b, s, -1)
        if routes.mlp_q8:
            x = fused_out_mlp_q8(x[:, 0], out[:, 0], p["wo"], p["w_gate_up"],
                                 p["w_down"], eps=cfg.rms_eps)[:, None]
        elif routes.mlp:
            x = fused_out_mlp(x[:, 0], out[:, 0], p["wo"], p["w_gate_up"],
                              p["w_down"], eps=cfg.rms_eps)[:, None]
        else:
            x = x + dense(out, p["wo"])
            gate, up = dense(rms_norm(x, eps=cfg.rms_eps), p["w_gate_up"]).chunk(2, dim=-1)
            x = x + dense(F.silu(gate) * up, p["w_down"])
    kv = kv.advance(s)
    # the final norm weight is folded into the downstream head(s)
    if return_all:
        return rms_norm(x, eps=cfg.rms_eps), kv
    return rms_norm(x[:, -1], eps=cfg.rms_eps), kv


# --------------------------------------------------------------------------
# Talker head

def talker_logits(params: dict, final_hidden: torch.Tensor, cfg: QwenTTSConfig
                  ) -> torch.Tensor:
    """The codec head plus the suppress bias."""
    return torch.matmul(final_hidden, params["codec_head"]) + params["suppress_bias"]


def make_suppress_bias(vocab_size: int, eos_id: int, window: int = 1024) -> np.ndarray:
    """(1, vocab) bias of -1e7 on the last `window` ids but EOS; all zero
    for a vocabulary no larger than the window."""
    bias = np.zeros((1, vocab_size), np.float32)
    if vocab_size <= window:
        return bias
    ids = [t for t in range(vocab_size - window, vocab_size) if t != eos_id]
    bias[:, ids] = -1e7
    return bias


# --------------------------------------------------------------------------
# Predictor: one 16-group frame

def _rope_row(params: dict, pos: int) -> tuple:
    """The predictor's RoPE rows of position pos."""
    return params["pred_rope_cos"][pos:pos + 1], params["pred_rope_sin"][pos:pos + 1]


def _predictor_prefill(params: dict, talker_hidden: torch.Tensor,
                       codec_token0: torch.Tensor, cfg: QwenTTSConfig, rows: int):
    """The predictor's 2-position prefill [talker hidden, group-0 embedding],
    each request's rows repeated `rows // B` times. Returns (h, kv,
    codec_embed0)."""
    pcfg = cfg.predictor
    bsz = talker_hidden.shape[0]
    codec_embed0 = params["talker_codec_embed"][codec_token0.long()][:, None]   # (B,1,H)
    kv = KVCache.create(pcfg.num_layers, rows, pcfg.num_kv_heads, pcfg.max_seq_len,
                        pcfg.head_dim, talker_hidden.dtype, talker_hidden.device)
    prefill = torch.matmul(torch.cat([talker_hidden, codec_embed0], dim=1),
                           params["small_to_mtp"])                              # (B,2,pH)
    if rows != bsz:
        prefill = prefill.repeat_interleave(rows // bsz, dim=0)
    h, kv = qwen3_stack_step(params["predictor"], prefill, kv, pcfg,
                             params["pred_rope_cos"][:2], params["pred_rope_sin"][:2])
    return h, kv, codec_embed0


def _group_input(params: dict, g: int, toks: torch.Tensor) -> torch.Tensor:
    """Group g's embedding of toks (rows,), in talker space, projected into
    the predictor: (rows, 1, pH)."""
    return torch.matmul(params["group_embeds"][g][toks.long()][:, None],
                        params["small_to_mtp"])


def predictor_frame(params: dict, talker_hidden: torch.Tensor,
                    codec_token0: torch.Tensor, cfg: QwenTTSConfig,
                    repeat_penalty: float = 1.0, penalty_range: int = 10, fused=False):
    """One frame's remaining 15 RVQ groups, greedy, with the in-frame
    repetition penalty. talker_hidden (B, 1, tH); codec_token0 (B,) int32.
    Returns (frame_ids, codec_embed0): (16,) / (1, 1, tH) at B = 1, (B, 16)
    / (B, 1, tH) for B > 1. Every selection stays on the device."""
    pcfg = cfg.predictor
    bsz = talker_hidden.shape[0]
    h, kv, codec_embed0 = _predictor_prefill(params, talker_hidden, codec_token0, cfg, bsz)
    save = torch.zeros((bsz, cfg.num_code_groups - 1), dtype=torch.int32,
                       device=talker_hidden.device)
    for g in range(cfg.num_code_groups - 1):
        logits = torch.matmul(h, params["lm_heads"][g])                         # (B, Vg)
        if repeat_penalty != 1.0:
            logits = apply_repetition_penalty(logits, save, g, repeat_penalty,
                                              penalty_range)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        save[:, g] = tok
        rc, rs = _rope_row(params, kv.length)
        h, kv = qwen3_stack_step(params["predictor"], _group_input(params, g, tok), kv,
                                 pcfg, rc, rs, fused=fused)
    frame_ids = torch.cat([codec_token0.reshape(bsz, 1).to(torch.int32), save], dim=1)
    if bsz == 1:
        return frame_ids[0], codec_embed0
    return frame_ids, codec_embed0


def predictor_frame_beam(params: dict, talker_hidden: torch.Tensor,
                         codec_token0: torch.Tensor, cfg: QwenTTSConfig, beam_size: int,
                         top_k: int, repeat_penalty: float = 1.0, penalty_range: int = 10,
                         fused=False):
    """Beam search over the 15 groups of one request: the first group's
    logits expand into beam_size rows, each later group takes top_k per beam
    and prunes to the joint best beam_size, the cache and the history
    reordered by parent; beam 0's ids at the end. Returns (frame_ids (16,),
    codec_embed0 (1, 1, tH))."""
    pcfg = cfg.predictor
    h, kv, codec_embed0 = _predictor_prefill(params, talker_hidden, codec_token0, cfg,
                                             beam_size)
    state = beam_init(torch.matmul(h[:1], params["lm_heads"][0]), beam_size)
    save = torch.zeros((beam_size, cfg.num_code_groups - 1), dtype=torch.int32,
                       device=h.device)
    save[:, 0] = state.tokens
    log_probs, toks = state.log_probs, state.tokens
    for g in range(1, cfg.num_code_groups - 1):
        rc, rs = _rope_row(params, kv.length)
        h, kv = qwen3_stack_step(params["predictor"], _group_input(params, g - 1, toks),
                                 kv, pcfg, rc, rs, fused=fused)
        logits = torch.matmul(h, params["lm_heads"][g])                         # (beam, Vg)
        if repeat_penalty != 1.0:
            logits = apply_repetition_penalty(logits, save, g, repeat_penalty,
                                              penalty_range)
        st = beam_step(logits, log_probs, beam_size, top_k)
        parent = st.parent.long()
        kv = kv.select_batch(parent)
        save = save.index_select(0, parent)
        save[:, g] = st.tokens
        log_probs, toks = st.log_probs, st.tokens
    frame_ids = torch.cat([codec_token0.reshape(1).to(torch.int32), save[0]])
    return frame_ids, codec_embed0


def predictor_frame_beam_batch(params: dict, talker_hidden: torch.Tensor,
                               codec_token0: torch.Tensor, cfg: QwenTTSConfig,
                               beam_size: int, top_k: int, repeat_penalty: float = 1.0,
                               penalty_range: int = 10, fused=False):
    """B independent beams as B * beam_size predictor rows: one stack step
    per group for all, the pruning and the reorder per request. Row b is
    predictor_frame_beam on request b. talker_hidden (B, 1, tH);
    codec_token0 (B,). Returns (frame_ids (B, 16), codec_embed0 (B, 1, tH))."""
    pcfg = cfg.predictor
    bsz = talker_hidden.shape[0]
    rows = bsz * beam_size
    h, kv, codec_embed0 = _predictor_prefill(params, talker_hidden, codec_token0, cfg, rows)
    logits0 = torch.matmul(h.reshape(bsz, beam_size, -1)[:, 0], params["lm_heads"][0])
    st = beam_init_batch(logits0, beam_size)
    row_off = (torch.arange(bsz, device=h.device) * beam_size)[:, None]
    save = torch.zeros((rows, cfg.num_code_groups - 1), dtype=torch.int32, device=h.device)
    toks = st.tokens.reshape(rows)
    save[:, 0] = toks
    log_probs = st.log_probs                                                   # (B, beam, 1)
    for g in range(1, cfg.num_code_groups - 1):
        rc, rs = _rope_row(params, kv.length)
        h, kv = qwen3_stack_step(params["predictor"], _group_input(params, g - 1, toks),
                                 kv, pcfg, rc, rs, fused=fused)
        logits = torch.matmul(h, params["lm_heads"][g])                         # (rows, Vg)
        if repeat_penalty != 1.0:
            logits = apply_repetition_penalty(logits, save, g, repeat_penalty,
                                              penalty_range)
        st = beam_step_batch(logits.reshape(bsz, beam_size, -1), log_probs, beam_size,
                             top_k)
        parent = (st.parent + row_off).reshape(rows).long()
        kv = kv.select_batch(parent)
        save = save.index_select(0, parent)
        toks = st.tokens.reshape(rows)
        save[:, g] = toks
        log_probs = st.log_probs
    best = save.reshape(bsz, beam_size, -1)[:, 0]                              # (B, 15)
    frame_ids = torch.cat([codec_token0.reshape(bsz, 1).to(torch.int32), best], dim=1)
    return frame_ids, codec_embed0


def next_talker_input(params: dict, frame_ids: torch.Tensor, codec_embed0: torch.Tensor,
                      trailing_text: torch.Tensor, gather_id: int,
                      cfg: QwenTTSConfig) -> torch.Tensor:
    """The talker's next input: codec_embed0 + trailing_text[gather_id] +
    the 15 groups' embeddings, added in group order (1, 1, tH)."""
    groups = cfg.num_code_groups - 1
    picked = params["group_embeds"][torch.arange(groups, device=frame_ids.device),
                                    frame_ids[1:].long()]                       # (15, tH)
    emb = codec_embed0 + trailing_text[:, gather_id][:, None]
    for g in range(groups):
        emb = emb + picked[g]
    return emb


def next_talker_input_batch(params: dict, frame_ids: torch.Tensor,
                            codec_embed0: torch.Tensor, trailing_text: torch.Tensor,
                            gather_id, cfg: QwenTTSConfig) -> torch.Tensor:
    """Batched next input: frame_ids (B, 16); codec_embed0 (B, 1, tH);
    trailing_text (B, Tt, tH); gather_id an int for every row or a (B,)
    tensor, a row's own (the slot server's rows sit at their own frames).
    Returns (B, 1, tH)."""
    groups = cfg.num_code_groups - 1
    picked = params["group_embeds"][torch.arange(groups, device=frame_ids.device)[None],
                                    frame_ids[:, 1:].long()]                    # (B, 15, tH)
    if isinstance(gather_id, torch.Tensor):
        idx = gather_id.long()[:, None, None].expand(-1, 1, trailing_text.shape[2])
        emb = codec_embed0 + trailing_text.gather(1, idx)
    else:
        emb = codec_embed0 + trailing_text[:, gather_id:gather_id + 1]
    for g in range(groups):
        emb = emb + picked[:, g:g + 1]
    return emb


# --------------------------------------------------------------------------
# Random init (tests and the card's smoke run)

def init_stack_params(cfg: Qwen3StackConfig, generator: torch.Generator,
                      dtype: torch.dtype = torch.float32, bias: bool = False) -> dict:
    """Random stack parameters on `generator.device` with tts_tpu's
    structure and folds (norm weights absorbed, q/k norms carrying
    d^-0.25)."""
    dev = generator.device
    hs, hd = cfg.hidden_size, cfg.head_dim
    n_qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd

    def mat(cin, cout):
        return (torch.randn((cin, cout), generator=generator, device=dev) * 0.02).to(dtype)

    layers = []
    for _ in range(cfg.num_layers):
        p = {"wqkv": mat(hs, n_qkv),
             "q_norm": torch.full((hd,), hd ** -0.25, dtype=dtype, device=dev),
             "k_norm": torch.full((hd,), hd ** -0.25, dtype=dtype, device=dev),
             "wo": mat(cfg.num_heads * hd, hs),
             "w_gate_up": mat(hs, 2 * cfg.ffn_dim),
             "w_down": mat(cfg.ffn_dim, hs)}
        if bias:
            p["bqkv"] = torch.zeros((n_qkv,), dtype=dtype, device=dev)
        layers.append(p)
    return {"layers": layers}


def init_talker_params(cfg: QwenTTSConfig, generator: torch.Generator,
                       dtype: torch.dtype = torch.float32) -> dict:
    dev = generator.device
    t = cfg.talker

    def mat(cin, cout):
        return (torch.randn((cin, cout), generator=generator, device=dev) * 0.02).to(dtype)

    cos, sin = rope_table(t.max_seq_len, t.head_dim, t.rope_base)
    return {
        "talker": init_stack_params(t, generator, dtype),
        "codec_head": mat(t.hidden_size, cfg.codec_vocab),
        "suppress_bias": torch.as_tensor(
            make_suppress_bias(cfg.codec_vocab, cfg.codec_eos_token_id), device=dev).to(dtype),
        "talker_codec_embed": mat(cfg.codec_vocab, t.hidden_size),
        "text_embed": mat(cfg.text_vocab, cfg.text_hidden),
        "text_proj_w": mat(cfg.text_hidden, t.hidden_size),
        "text_proj_b": torch.zeros((t.hidden_size,), dtype=dtype, device=dev),
        "rope_cos": torch.as_tensor(cos, device=dev).to(dtype),
        "rope_sin": torch.as_tensor(sin, device=dev).to(dtype),
    }


def init_predictor_params(cfg: QwenTTSConfig, generator: torch.Generator,
                          dtype: torch.dtype = torch.float32) -> dict:
    dev = generator.device
    p, t = cfg.predictor, cfg.talker
    groups = cfg.num_code_groups - 1

    def mat(*shape):
        return (torch.randn(shape, generator=generator, device=dev) * 0.02).to(dtype)

    cos, sin = rope_table(p.max_seq_len, p.head_dim, p.rope_base)
    return {
        "predictor": init_stack_params(p, generator, dtype),
        "small_to_mtp": mat(t.hidden_size, p.hidden_size),
        "lm_heads": mat(groups, p.hidden_size, cfg.group_vocab),
        "group_embeds": mat(groups, cfg.group_vocab, t.hidden_size),
        "pred_rope_cos": torch.as_tensor(cos, device=dev).to(dtype),
        "pred_rope_sin": torch.as_tensor(sin, device=dev).to(dtype),
    }
