"""KaniTTS acoustic LM: the LFM2 hybrid of short-conv and GQA attention
layers (counterpart of tts_tpu/models/kani.py).

Plain functions over a params dict with tts_tpu's keys and load-time folds
(pre-norm weights absorbed into the next projection, d^-0.25 in the q/k
norm weights). Every layer: pre-RMSNorm, mixer (GQA attention with per-head
q/k RMSNorm and RoPE, or the short conv: in_proj -> B, C, x gates, causal
depthwise conv over a carried (k-1)-sample state, C * conv -> out_proj),
residual, SwiGLU FFN, residual; the last hidden state -> RMSNorm -> lm_head.

The KV cache and the conv carries are written in place (kv/cache.py); the
state kani_step returns shares its buffers with the one it was given. An
attention layer's decode step has three routes, as in tts_tpu: "step" (the
qkv head and attention in one kernel, ops/decode_step.py), True (the qkv
head kernel, ops/decode_qkv.py, then gqa_attention) and False (plain ops).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..kv.cache import KVCache
from ..nn.attention import attention_mask, combine_kv_valid, gqa_attention
from ..nn.norm import rms_norm
from ..nn.rope import apply_rope, rope_table
from ..ops.conv import conv1d
from ..ops.decode_qkv import fusable_layout, fusable_weight, fused_qkv_rope, qkv_fits
from ..ops.decode_step import fused_qkv_attn
from ..quant.weight_only import dense

__all__ = ["KaniConfig", "KaniState", "kani_step", "embed_tokens", "init_params",
           "init_state"]


@dataclass(frozen=True)
class KaniConfig:
    """Defaults = kani-tts-370m (LFM2-350M backbone), as tts_tpu's."""

    hidden_size: int = 1024
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 64
    ffn_dim: int = 4608
    vocab_size: int = 80538
    layer_types: tuple[str, ...] = (
        "conv", "conv", "attn", "conv", "conv", "attn", "conv", "conv",
        "attn", "conv", "attn", "conv", "attn", "conv", "attn", "conv",
    )
    conv_kernel: int = 3
    rope_base: float = 1000000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 1024
    stop_token: int = 64402

    @property
    def num_attn_layers(self) -> int:
        return sum(1 for t in self.layer_types if t == "attn")

    @property
    def num_conv_layers(self) -> int:
        return sum(1 for t in self.layer_types if t == "conv")


@dataclass
class KaniState:
    """The decode loop's state: the KV cache and the conv carries,
    conv (num_conv_layers, B, conv_kernel - 1, H)."""

    kv: KVCache
    conv: torch.Tensor

    def clone(self) -> "KaniState":
        """A copy that owns its buffers (a step from it leaves self alone)."""
        return KaniState(KVCache(self.kv.k.clone(), self.kv.v.clone(), self.kv.length),
                         self.conv.clone())


def init_state(cfg: KaniConfig, batch: int = 1, kv_dtype=torch.bfloat16,
               device=None) -> KaniState:
    return KaniState(
        kv=KVCache.create(cfg.num_attn_layers, batch, cfg.num_kv_heads,
                          cfg.max_seq_len, cfg.head_dim, kv_dtype, device),
        conv=torch.zeros((cfg.num_conv_layers, batch, cfg.conv_kernel - 1,
                          cfg.hidden_size), dtype=kv_dtype, device=device))


def _attn_layer(p: dict, x: torch.Tensor, state: KaniState, layer_idx: int,
                cfg: KaniConfig, rope_cos, rope_sin, mask, fused=False):
    """GQA attention with per-head q/k RMSNorm and the in-place KV append."""
    b, s, _ = x.shape
    heads, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q_sz, kv_sz = heads * hd, kvh * hd
    pos = state.kv.length
    if fused == "step":
        # kani_step's gate guarantees b == s == 1 and a plain causal mask
        attn, kf, vf = fused_qkv_attn(
            x[:, 0], p["wqkv"], rope_cos, rope_sin, state.kv.k, state.kv.v,
            layer_idx, pos, heads=heads, kv_heads=kvh, head_dim=hd,
            q_norm=p["q_norm"], k_norm=p["k_norm"], eps=cfg.rms_eps)
        state.kv.update_layer(layer_idx, kf.reshape(b, 1, kvh, hd),
                              vf.reshape(b, 1, kvh, hd))
        return dense(attn[:, None], p["wo"])
    if fused:
        qf, kf, vf = fused_qkv_rope(
            x[:, 0], p["wqkv"], rope_cos, rope_sin, heads=heads, kv_heads=kvh,
            head_dim=hd, q_norm=p["q_norm"], k_norm=p["k_norm"], eps=cfg.rms_eps)
        q = qf.reshape(b, 1, heads, hd)
        k = kf.reshape(b, 1, kvh, hd)
        v = vf.reshape(b, 1, kvh, hd)
    else:
        qkv = dense(rms_norm(x, eps=cfg.rms_eps), p["wqkv"])   # weight in wqkv
        q = qkv[..., :q_sz].reshape(b, s, heads, hd)
        k = qkv[..., q_sz:q_sz + kv_sz].reshape(b, s, kvh, hd)
        v = qkv[..., q_sz + kv_sz:].reshape(b, s, kvh, hd)
        q = apply_rope(rms_norm(q, p["q_norm"], eps=cfg.rms_eps), rope_cos, rope_sin)
        k = apply_rope(rms_norm(k, p["k_norm"], eps=cfg.rms_eps), rope_cos, rope_sin)
    _, k_full, v_full = state.kv.update_layer(layer_idx, k, v)
    # keys past pos + s are masked: attend over the rows that can be valid
    n = pos + s
    out = gqa_attention(q, k_full[:, :, :n], v_full[:, :, :n], mask)
    return dense(out.reshape(b, s, -1), p["wo"])


def _conv_layer(p: dict, x: torch.Tensor, state: KaniState, conv_idx: int,
                cfg: KaniConfig, valid_len: int | None = None):
    """LFM2 short-conv mixer. valid_len marks the true end of a padded
    bucket: the carry then comes from the last k-1 valid inputs."""
    bcx = dense(rms_norm(x, eps=cfg.rms_eps), p["in_proj"])     # weight in in_proj
    b_gate, c_gate, xv = bcx.chunk(3, dim=-1)
    bx = b_gate * xv                                            # (B, S, H)
    carry = state.conv[conv_idx].to(bx.dtype)                   # (B, k-1, H)
    seq = torch.cat([carry, bx], dim=1)                         # (B, k-1+S, H)
    km1 = cfg.conv_kernel - 1
    # seq is left-extended by the k-1 carry, so the last k-1 valid inputs
    # start at seq position valid_len
    start = seq.shape[1] - km1 if valid_len is None else valid_len
    state.conv[conv_idx] = seq[:, start:start + km1]
    conv_out = conv1d(seq, p["conv_w"], p.get("conv_b"), padding=0,
                      groups=cfg.hidden_size)                   # (B, S, H)
    return dense(c_gate * conv_out, p["out_proj"])


def _ffn(p: dict, x: torch.Tensor, cfg: KaniConfig) -> torch.Tensor:
    gu = dense(rms_norm(x, eps=cfg.rms_eps), p["w_gate_up"])  # ffn_norm in w_gate_up
    gate, up = gu.chunk(2, dim=-1)
    return dense(F.silu(gate) * up, p["w_down"])


def _route(params: dict, cfg: KaniConfig, b: int, s: int, key_valid_from, fused):
    """tts_tpu's gates for the fused routes, plus the CUDA kernels' limits
    (`qkv_fits`): False when the layout, the weights or the rows do not fuse;
    "step" degrades to True off the M=1 plain-causal geometry."""
    if fused:
        ok = (fusable_layout(b, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
              and qkv_fits(b, cfg.hidden_size, cfg.head_dim)
              and all(fusable_weight(p["wqkv"])
                      for lt, p in zip(cfg.layer_types, params["layers"]) if lt == "attn"))
        if not ok:
            fused = False
    if fused == "step" and (b != 1 or s != 1 or key_valid_from is not None
                            or cfg.head_dim not in (64, 128)
                            or (cfg.num_heads * cfg.head_dim) % 128
                            or (cfg.num_kv_heads * cfg.head_dim) % 128):
        fused = True
    return fused if s == 1 else False


def kani_step(params: dict, hidden: torch.Tensor, state: KaniState, cfg: KaniConfig,
              valid_len: int | None = None, key_valid_from: torch.Tensor | None = None,
              fused=False) -> tuple[torch.Tensor, KaniState]:
    """One LM step over S new tokens. hidden (B, S, H) embedded inputs.
    Returns (logits (B, vocab), the state with kv.length advanced by S).
    valid_len: the true length inside a padded bucket (batched prefill): the
    logits come from position valid_len - 1 and the conv carries from the
    last valid inputs; the caller rewinds kv.length to valid_len.
    key_valid_from: (B,) first valid key per row, for prompts right-
    justified in one bucket (the caller zeroes their pad embeddings)."""
    b, s, _ = hidden.shape
    pos = state.kv.length
    rope_cos = params["rope_cos"][pos:pos + s]
    rope_sin = params["rope_sin"][pos:pos + s]
    n = pos + s
    mask = attention_mask(s, n, pos, n, causal=True, device=hidden.device)
    if key_valid_from is not None:
        mask = combine_kv_valid(
            mask, torch.arange(n, device=hidden.device)[None, :] >= key_valid_from[:, None])
    fuse = _route(params, cfg, b, s, key_valid_from, fused)

    x = hidden
    attn_i = conv_i = 0
    for lt, p in zip(cfg.layer_types, params["layers"]):
        if lt == "attn":
            out = _attn_layer(p, x, state, attn_i, cfg, rope_cos, rope_sin, mask,
                              fused=fuse)
            attn_i += 1
        else:
            out = _conv_layer(p, x, state, conv_i, cfg, valid_len)
            conv_i += 1
        x = x + out
        x = x + _ffn(p["ffn"], x, cfg)

    state = KaniState(state.kv.advance(s), state.conv)
    last = x[:, -1] if valid_len is None else x[:, valid_len - 1]
    logits = dense(rms_norm(last, eps=cfg.rms_eps), params["lm_head"])
    return logits, state


def embed_tokens(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """(B, S) int ids -> (B, S, H)."""
    return params["embed"][ids.long()]


def init_params(cfg: KaniConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters on `generator.device` with tts_tpu's structure,
    scales and load-time folds (norm weights of 1 absorbed, q/k norms
    carrying d^-0.25)."""
    dev = generator.device
    hs, hd = cfg.hidden_size, cfg.head_dim

    def mat(cin, cout, scale=0.02):
        w = torch.randn((cin, cout), generator=generator, device=dev) * scale
        return w.to(dtype)

    scale = hd ** -0.25
    layers = []
    for lt in cfg.layer_types:
        p = {"ffn": {"w_gate_up": mat(hs, 2 * cfg.ffn_dim), "w_down": mat(cfg.ffn_dim, hs)}}
        if lt == "attn":
            p.update(wqkv=mat(hs, (cfg.num_heads + 2 * cfg.num_kv_heads) * hd),
                     q_norm=torch.full((hd,), scale, dtype=dtype, device=dev),
                     k_norm=torch.full((hd,), scale, dtype=dtype, device=dev),
                     wo=mat(cfg.num_heads * hd, hs))
        else:
            conv_w = torch.randn((cfg.conv_kernel, 1, hs), generator=generator,
                                 device=dev) * 0.2
            p.update(in_proj=mat(hs, 3 * hs), conv_w=conv_w.to(dtype),
                     out_proj=mat(hs, hs))
        layers.append(p)
    cos, sin = rope_table(cfg.max_seq_len, hd, cfg.rope_base)
    return {
        "embed": mat(cfg.vocab_size, hs),
        "layers": layers,
        "lm_head": mat(hs, cfg.vocab_size),
        "rope_cos": torch.as_tensor(cos, device=dev).to(dtype),
        "rope_sin": torch.as_tensor(sin, device=dev).to(dtype),
    }
