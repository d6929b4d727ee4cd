"""Qwen3-TTS 12 Hz codec decoder (counterpart of the decoder half of
tts_tpu/models/qwen_codec.py): RVQ codes -> 24 kHz waveform.

  * split RVQ dequantize: group 0 through the semantic codebook, groups
    1.. summed (in group order) through the acoustic codebooks, each then
    projected (codebooks normalized at load);
  * causal pre_conv (k 3) -> input_proj -> the bidirectional pre-transformer
    (RMSNorm-folded Qwen-style layers, RoPE, no mask, no cache) ->
    output_proj (final norm folded);
  * per upsampling ratio: causal transposed conv (k = stride = r) and a
    causal ConvNeXt block (LayerNorm affine folded into pw1, gamma into pw2);
  * causal conv (7) -> per rate [SnakeBeta -> causal transposed conv (2r, r)
    -> 3 residual units (SnakeBeta, dilated conv 7, SnakeBeta, conv 1) with
    dilations 1, 3, 9] -> SnakeBeta -> causal conv (7) -> clip to [-1, 1].

Feature-last (B, T, C) layout and WIO conv weights, as in tts_tpu. Plain
PyTorch (cuDNN convolutions on the card): the JAX package has no kernel
here.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.snake import snake_beta
from ..nn.attention import gqa_attention
from ..nn.norm import layer_norm, rms_norm
from ..nn.rope import apply_rope, rope_table
from ..ops.conv import conv1d, conv_transpose1d

__all__ = ["QwenCodecDecoderConfig", "rvq_dequantize", "codec_decode",
           "init_decoder_params"]


@dataclass(frozen=True)
class QwenCodecDecoderConfig:
    """Defaults = the Qwen3-TTS 12 Hz codec decoder, as tts_tpu's."""

    num_quantizers: int = 16
    codebook_size: int = 2048
    codebook_dim: int = 512            # quantizer output dim
    rvq_dim: int = 256                 # codebook_dim // 2 internal dim
    latent_dim: int = 1024
    decoder_dim: int = 1536
    upsampling_ratios: tuple[int, ...] = (2,)      # pre-decoder upsample
    upsample_rates: tuple[int, ...] = (8, 5, 5, 5) # decoder conv stack
    # pre-transformer
    hidden_size: int = 1024
    num_heads: int = 16
    num_kv_heads: int = 16
    head_dim: int = 64
    ffn_dim: int = 4096
    num_layers: int = 8
    rms_eps: float = 1e-6
    rope_base: float = 10000.0
    max_seq_len: int = 4096

    @property
    def total_upsample(self) -> int:
        return int(np.prod(self.upsample_rates) * np.prod(self.upsampling_ratios))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b=None, dilation: int = 1,
                 groups: int = 1) -> torch.Tensor:
    """Left-pad by the receptive field less one, then a valid conv."""
    pad = (w.shape[0] - 1) * dilation
    x = F.pad(x, (0, 0, pad, 0))
    return conv1d(x, w, b, padding=0, dilation=dilation, groups=groups)


def _causal_conv_transpose(x: torch.Tensor, w: torch.Tensor, b=None,
                           stride: int = 1) -> torch.Tensor:
    """Transposed conv trimmed on the right by (k - stride)."""
    y = conv_transpose1d(x, w, b, stride=stride, padding=0)
    trim = w.shape[0] - stride
    return y[:, : y.shape[1] - trim] if trim > 0 else y


def rvq_dequantize(params: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, T, num_quantizers) -> (B, T, codebook_dim). A code past the
    codebook takes its last entry, as tts_tpu's clamped gather does (a
    talker whose vocabulary is wider than the codebook and not suppressed,
    as in small test configs, can emit one)."""
    codes = codes.long().clamp(0, params["sem_codebook"].shape[0] - 1)
    sem = torch.matmul(params["sem_codebook"][codes[..., 0]], params["sem_out_proj"])
    ac_books = params["ac_codebooks"]
    ac = ac_books[0][codes[..., 1]]
    for g in range(1, ac_books.shape[0]):
        ac = ac + ac_books[g][codes[..., g + 1]]
    return sem + torch.matmul(ac, params["ac_out_proj"])


def _pre_transformer(params: dict, x: torch.Tensor, cfg: QwenCodecDecoderConfig
                     ) -> torch.Tensor:
    """Full-attention (non-causal) transformer with folded norms and scales."""
    b, t, _ = x.shape
    rope_cos, rope_sin = params["rope_cos"][:t], params["rope_sin"][:t]
    q_sz, kv_sz = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    x = torch.matmul(x, params["input_proj"]["w"]) + params["input_proj"]["b"]
    for p in params["layers"]:
        qkv = torch.matmul(rms_norm(x, eps=cfg.rms_eps), p["wqkv"])
        if "bqkv" in p:
            qkv = qkv + p["bqkv"]
        q = qkv[..., :q_sz].reshape(b, t, cfg.num_heads, cfg.head_dim)
        k = qkv[..., q_sz:q_sz + kv_sz].reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        v = qkv[..., q_sz + kv_sz:].reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
        # no cache: k/v go straight to the (B, KVH, T, D) attention layout
        out = gqa_attention(q, k.transpose(1, 2), v.transpose(1, 2), None).reshape(b, t, -1)
        x = x + torch.matmul(out, p["wo"])
        gate, up = torch.matmul(rms_norm(x, eps=cfg.rms_eps), p["w_gate_up"]).chunk(2, dim=-1)
        x = x + torch.matmul(F.silu(gate) * up, p["w_down"])
    x = rms_norm(x, eps=cfg.rms_eps)       # the final norm weight is in output_proj
    return torch.matmul(x, params["output_proj"]["w"]) + params["output_proj"]["b"]


def _convnext_causal(x: torch.Tensor, p: dict) -> torch.Tensor:
    r = x
    x = _causal_conv(x, p["dwconv"]["w"], p["dwconv"]["b"], groups=x.shape[-1])
    x = layer_norm(x, eps=1e-6)
    x = torch.matmul(x, p["pw1"]["w"]) + p["pw1"]["b"]
    x = F.gelu(x, approximate="tanh")
    x = torch.matmul(x, p["pw2"]["w"]) + p["pw2"]["b"]
    return r + x


def _residual_unit(x: torch.Tensor, p: dict, dilation: int) -> torch.Tensor:
    h = snake_beta(x, p["act1"]["alpha"], p["act1"]["beta_recip"])
    h = _causal_conv(h, p["conv1"]["w"], p["conv1"].get("b"), dilation=dilation)
    h = snake_beta(h, p["act2"]["alpha"], p["act2"]["beta_recip"])
    h = _causal_conv(h, p["conv2"]["w"], p["conv2"].get("b"))
    return x + h


def codec_decode(params: dict, codes: torch.Tensor, cfg: QwenCodecDecoderConfig
                 ) -> torch.Tensor:
    """codes (B, T, num_quantizers) int -> waveform (B, T * total_upsample),
    float, clipped to [-1, 1]."""
    h = rvq_dequantize(params, codes)
    h = _causal_conv(h, params["pre_conv"]["w"], params["pre_conv"].get("b"))
    h = _pre_transformer(params, h, cfg)
    for i, ratio in enumerate(cfg.upsampling_ratios):
        up = params["upsample"][i]
        h = _causal_conv_transpose(h, up["conv"]["w"], up["conv"].get("b"), stride=ratio)
        h = _convnext_causal(h, up["convnext"])
    w = _causal_conv(h, params["dec_pre"]["w"], params["dec_pre"].get("b"))
    for i, rate in enumerate(cfg.upsample_rates):
        blk = params["dec_blocks"][i]
        w = snake_beta(w, blk["act"]["alpha"], blk["act"]["beta_recip"])
        w = _causal_conv_transpose(w, blk["up"]["w"], blk["up"].get("b"), stride=rate)
        for j, dil in enumerate((1, 3, 9)):
            w = _residual_unit(w, blk["units"][j], dil)
    w = snake_beta(w, params["dec_post_act"]["alpha"], params["dec_post_act"]["beta_recip"])
    w = _causal_conv(w, params["dec_post"]["w"], params["dec_post"].get("b"))
    return torch.clamp(w[..., 0], -1.0, 1.0)


def init_decoder_params(cfg: QwenCodecDecoderConfig, generator: torch.Generator,
                        dtype: torch.dtype = torch.float32) -> dict:
    """Random decoder parameters on `generator.device` with tts_tpu's
    structure (q and k weights carrying head_dim^-0.25, snake alphas and
    reciprocals of 1)."""
    dev = generator.device

    def mat(*shape):
        return (torch.randn(shape, generator=generator, device=dev) * 0.02).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    def conv_p(k, cin, cout):
        return {"w": mat(k, cin, cout), "b": zeros(cout)}

    def act_p(c):
        return {"alpha": torch.ones((c,), dtype=dtype, device=dev),
                "beta_recip": torch.ones((c,), dtype=dtype, device=dev)}

    scale = cfg.head_dim ** -0.25
    hs = cfg.hidden_size
    layers = [{"wqkv": torch.cat([mat(hs, cfg.num_heads * cfg.head_dim) * scale,
                                  mat(hs, cfg.num_kv_heads * cfg.head_dim) * scale,
                                  mat(hs, cfg.num_kv_heads * cfg.head_dim)], dim=-1),
               "wo": mat(cfg.num_heads * cfg.head_dim, hs),
               "w_gate_up": mat(hs, 2 * cfg.ffn_dim),
               "w_down": mat(cfg.ffn_dim, hs)} for _ in range(cfg.num_layers)]
    cos, sin = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_base)
    d0 = cfg.decoder_dim
    dec_blocks = []
    for i, r in enumerate(cfg.upsample_rates):
        cin, cout = d0 // (2 ** i), d0 // (2 ** (i + 1))
        dec_blocks.append({
            "act": act_p(cin),
            "up": conv_p(2 * r, cin, cout),
            "units": [{"act1": act_p(cout), "conv1": conv_p(7, cout, cout),
                       "act2": act_p(cout), "conv2": conv_p(1, cout, cout)}
                      for _ in range(3)],
        })
    out_dim = d0 // (2 ** len(cfg.upsample_rates))
    lat = cfg.latent_dim
    return {
        "sem_codebook": mat(cfg.codebook_size, cfg.rvq_dim),
        "sem_out_proj": mat(cfg.rvq_dim, cfg.codebook_dim),
        "ac_codebooks": mat(cfg.num_quantizers - 1, cfg.codebook_size, cfg.rvq_dim),
        "ac_out_proj": mat(cfg.rvq_dim, cfg.codebook_dim),
        "pre_conv": conv_p(3, cfg.codebook_dim, lat),
        "input_proj": {"w": mat(lat, hs), "b": zeros(hs)},
        "layers": layers,
        "output_proj": {"w": mat(hs, lat), "b": zeros(lat)},
        "rope_cos": torch.as_tensor(cos, device=dev).to(dtype),
        "rope_sin": torch.as_tensor(sin, device=dev).to(dtype),
        "upsample": [{"conv": conv_p(r, lat, lat),
                      "convnext": {"dwconv": conv_p(7, 1, lat),
                                   "pw1": {"w": mat(lat, 4 * lat), "b": zeros(4 * lat)},
                                   "pw2": {"w": mat(4 * lat, lat), "b": zeros(lat)}}}
                     for r in cfg.upsampling_ratios],
        "dec_pre": conv_p(7, lat, d0),
        "dec_blocks": dec_blocks,
        "dec_post_act": act_p(out_dim),
        "dec_post": conv_p(7, out_dim, 1),
    }
