"""Qwen3-TTS reference-audio encoder, the voice-clone prompt path
(counterpart of tts_tpu/models/qwen_encoder.py): 24 kHz audio -> Mimi
embeddings -> split-RVQ codes.

  * the causal SEANet encoder: conv(7) -> per ratio of
    reversed(upsampling_ratios) [residual units (ELU, conv(3) at dilation
    growth_rate ** j, ELU, conv(1)) -> ELU -> strided conv(2r)] -> ELU ->
    conv(last); each conv left-pads k_eff - stride zeros;
  * the transformer with no mask (full attention over the sequence),
    LayerNorm without affine (eps 1e-5; the affines and the layer scales
    are folded into the linears at load), half-split RoPE, the exact erf
    GELU;
  * the frame-rate downsample conv, left-padded by repeating the first
    frame;
  * split-RVQ encode: the semantic codebook on its own projection, then a
    residual chain over the num_quantizers - 1 acoustic codebooks, each
    nearest code by argmin(||y||^2 - 2<x, y>).

Feature-last (B, T, C) layout and WIO conv weights, as in tts_tpu. Plain
PyTorch (cuDNN convolutions and cuBLAS GEMMs on the card): no Pallas
kernel lies on this path in tts_tpu, and it runs once a reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..nn.attention import gqa_attention
from ..nn.norm import layer_norm
from ..nn.rope import apply_rope, rope_table
from ..ops.conv import conv1d

__all__ = ["MimiEncoderConfig", "mimi_encode", "rvq_encode", "init_encoder_params"]


@dataclass(frozen=True)
class MimiEncoderConfig:
    """Defaults = the Qwen3-TTS 12 Hz speech tokenizer's Mimi encoder."""

    num_filters: int = 64
    upsampling_ratios: tuple[int, ...] = (8, 6, 5, 4)   # decode order
    num_residual_layers: int = 1
    dilation_growth_rate: int = 2
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    compress: int = 2
    hidden_size: int = 512
    # transformer
    num_heads: int = 8
    head_dim: int = 64
    ffn_dim: int = 2048
    num_layers: int = 8
    rope_base: float = 10000.0
    max_seq_len: int = 8192
    # downsample + quantizer
    downsample_stride: int = 2
    rvq_dim: int = 256
    codebook_size: int = 2048
    num_quantizers: int = 16


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                 stride: int = 1, dilation: int = 1, replicate: bool = False) -> torch.Tensor:
    """Left-pad k_eff - stride frames (zeros, or the first frame repeated),
    then a valid conv."""
    k_eff = (w.shape[0] - 1) * dilation + 1
    pad = max(k_eff - stride, 0)
    if replicate:
        x = torch.cat([x[:, :1].expand(-1, pad, -1), x], dim=1)
    else:
        x = F.pad(x, (0, 0, pad, 0))
    return conv1d(x, w, b, padding=0, stride=stride, dilation=dilation)


def mimi_encode(params: dict, audio: torch.Tensor, cfg: MimiEncoderConfig) -> torch.Tensor:
    """audio (B, N) float at 24 kHz -> embeddings (B, T, hidden) after the
    conv stack, the transformer and the downsample (before the quantizer)."""
    x = audio[..., None]
    x = _causal_conv(x, params["pre"]["w"], params["pre"]["b"])
    strides = tuple(reversed(cfg.upsampling_ratios))
    for bi, blk in enumerate(params["blocks"]):
        for j, unit in enumerate(blk["res"]):
            h = _causal_conv(F.elu(x), unit["c1"]["w"], unit["c1"]["b"],
                             dilation=cfg.dilation_growth_rate ** j)
            x = x + _causal_conv(F.elu(h), unit["c2"]["w"], unit["c2"]["b"])
        x = _causal_conv(F.elu(x), blk["down"]["w"], blk["down"]["b"], stride=strides[bi])
    x = _causal_conv(F.elu(x), params["post"]["w"], params["post"]["b"])

    t = x.shape[1]
    cos = params["rope_cos"][:t].to(x.dtype)
    sin = params["rope_sin"][:t].to(x.dtype)
    h, d = cfg.num_heads, cfg.head_dim
    for p in params["layers"]:
        n = layer_norm(x, eps=1e-5)
        qkv = torch.matmul(n, p["wqkv"]) + p["bqkv"]
        q, k, v = qkv.chunk(3, dim=-1)
        b_, s_, _ = n.shape
        q = apply_rope(q.reshape(b_, s_, h, d), cos, sin)
        k = apply_rope(k.reshape(b_, s_, h, d), cos, sin)
        v = v.reshape(b_, s_, h, d)
        out = gqa_attention(q, k.transpose(1, 2), v.transpose(1, 2), None).reshape(b_, s_, -1)
        x = x + (torch.matmul(out, p["wo"]) + p["bo"])
        n = layer_norm(x, eps=1e-5)
        hid = F.gelu(torch.matmul(n, p["fc1"]["w"]) + p["fc1"]["b"])   # the erf form
        x = x + (torch.matmul(hid, p["fc2"]["w"]) + p["fc2"]["b"])

    ds = params["downsample"]
    return _causal_conv(x, ds["w"], ds.get("b"), stride=cfg.downsample_stride,
                        replicate=True)


def _nearest_code(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """argmin over codes of ||y||^2 - 2<x, y> (the first on a tie). x (...,
    D), embed (V, D) -> (...,) int32."""
    dot = torch.matmul(x, embed.T)
    norm = (embed * embed).sum(dim=-1)
    return torch.argmin(norm - 2.0 * dot, dim=-1).to(torch.int32)


def rvq_encode(params: dict, emb: torch.Tensor, cfg: MimiEncoderConfig,
               num_quantizers: int | None = None) -> torch.Tensor:
    """emb (B, T, hidden) -> codes (B, T, Q) int32: the semantic code, then
    the acoustic residual chain."""
    nq = num_quantizers or cfg.num_quantizers
    codes = [_nearest_code(torch.matmul(emb, params["sem_in_proj"]), params["sem_codebook"])]
    residual = torch.matmul(emb, params["ac_in_proj"])
    for g in range(nq - 1):
        cb = params["ac_codebooks"][g]
        code = _nearest_code(residual, cb)
        residual = residual - cb[code.long()]
        codes.append(code)
    return torch.stack(codes, dim=-1)


def init_encoder_params(cfg: MimiEncoderConfig, generator: torch.Generator,
                        dtype: torch.dtype = torch.float32) -> dict:
    """Random encoder parameters on `generator.device` with tts_tpu's
    structure (q and k weights carrying head_dim^-0.25, zero biases); the
    RoPE tables stay fp32."""
    dev = generator.device

    def mat(*shape, s=0.02):
        return (torch.randn(shape, generator=generator, device=dev) * s).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    def conv_p(k, cin, cout):
        return {"w": mat(k, cin, cout, s=0.1), "b": zeros(cout)}

    blocks = []
    ch = cfg.num_filters
    for ratio in reversed(cfg.upsampling_ratios):
        hidden = ch // cfg.compress
        res = [{"c1": conv_p(cfg.residual_kernel_size, ch, hidden), "c2": conv_p(1, hidden, ch)}
               for _ in range(cfg.num_residual_layers)]
        blocks.append({"res": res, "down": conv_p(2 * ratio, ch, 2 * ch)})
        ch *= 2
    inner = cfg.num_heads * cfg.head_dim
    scale = cfg.head_dim ** -0.25
    layers = []
    for _ in range(cfg.num_layers):
        wq = mat(cfg.hidden_size, inner) * scale
        wk = mat(cfg.hidden_size, inner) * scale
        wv = mat(cfg.hidden_size, inner)
        layers.append({
            "wqkv": torch.cat([wq, wk, wv], dim=-1), "bqkv": zeros(3 * inner),
            "wo": mat(inner, cfg.hidden_size), "bo": zeros(cfg.hidden_size),
            "fc1": {"w": mat(cfg.hidden_size, cfg.ffn_dim), "b": zeros(cfg.ffn_dim)},
            "fc2": {"w": mat(cfg.ffn_dim, cfg.hidden_size), "b": zeros(cfg.hidden_size)},
        })
    cos, sin = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_base)
    return {
        "pre": conv_p(cfg.kernel_size, 1, cfg.num_filters),
        "blocks": blocks,
        "post": conv_p(cfg.last_kernel_size, ch, cfg.hidden_size),
        "layers": layers,
        "rope_cos": torch.as_tensor(cos, device=dev),
        "rope_sin": torch.as_tensor(sin, device=dev),
        "downsample": conv_p(2 * cfg.downsample_stride, cfg.hidden_size, cfg.hidden_size),
        "sem_in_proj": mat(cfg.hidden_size, cfg.rvq_dim),
        "sem_codebook": mat(cfg.codebook_size, cfg.rvq_dim, s=1.0),
        "ac_in_proj": mat(cfg.hidden_size, cfg.rvq_dim),
        "ac_codebooks": mat(cfg.num_quantizers - 1, cfg.codebook_size, cfg.rvq_dim, s=1.0),
    }
