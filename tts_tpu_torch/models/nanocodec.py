"""NeMo NanoCodec decoder: FSQ dequantize + causal HiFiGAN (counterpart of
tts_tpu/models/nanocodec.py).

Token ids -> per-codebook indices -> FSQ values in [-1, 1] -> pre conv ->
per stage [activation -> causal transposed-conv upsample -> mean of the
kernel-size branches of dilated residual units] -> activation -> post conv.
Feature-last (B, T, C) layout; causal convs are a left pad and a valid conv.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.snake import snake
from ..ops.conv import conv1d, conv_transpose1d

__all__ = ["NanoCodecConfig", "fsq_dequantize", "tokens_to_codes",
           "hifigan_decode", "init_params"]


@dataclass(frozen=True)
class NanoCodecConfig:
    """Defaults = nvidia/nemo-nano-codec-22khz-0.6kbps-12.5fps (4 FSQ groups
    x 4 dims, levels [9, 8, 8, 7]), as tts_tpu's."""

    num_groups: int = 4
    dims_per_group: int = 4
    levels: tuple[int, ...] = (9, 8, 8, 7)
    codebook_size: int = 4032
    base_channels: int = 864
    up_sample_rates: tuple[int, ...] = (7, 7, 6, 6)
    kernel_sizes: tuple[int, ...] = (3, 7, 11)
    dilations: tuple[int, ...] = (1, 3, 5)
    pre_kernel: int = 7
    post_kernel: int = 3
    activation: str = "half_snake"            # 'snake' | 'half_snake' | 'lrelu'
    lrelu_slope: float = 0.1
    sample_rate: int = 22050

    @property
    def input_dim(self) -> int:
        return self.num_groups * self.dims_per_group

    @property
    def total_upsample(self) -> int:
        return int(np.prod(self.up_sample_rates))


def fsq_dequantize(codes: torch.Tensor, cfg: NanoCodecConfig) -> torch.Tensor:
    """codes (B, T, groups) int per-codebook indices -> (B, T, groups*dims)
    fp32: per dim (code // prod(levels[:d])) % levels[d], scaled by
    levels[d] // 2 and shifted by -1 (floor division and modulo as Python's
    and jnp's, for codes out of range too)."""
    levels = np.asarray(cfg.levels, np.int64)
    base = torch.as_tensor(np.concatenate([[1], np.cumprod(levels[:-1])]),
                           device=codes.device)
    lv = torch.as_tensor(levels, device=codes.device)
    half = torch.as_tensor((levels // 2).astype(np.float32), device=codes.device)
    c = codes.long()[..., None]                                 # (B, T, G, 1)
    nonneg = torch.remainder(torch.div(c, base, rounding_mode="floor"), lv)
    out = nonneg.float() / half - 1.0
    b, t = codes.shape[:2]
    return out.reshape(b, t, cfg.input_dim)


def tokens_to_codes(save_ids: torch.Tensor, cfg: NanoCodecConfig,
                    audio_tokens_start: int) -> torch.Tensor:
    """(B, T*G) flat LM ids -> (B, T, G) per-codebook indices."""
    b = save_ids.shape[0]
    codes = save_ids.reshape(b, -1, cfg.num_groups)
    offsets = (torch.arange(cfg.num_groups, dtype=codes.dtype, device=codes.device)
               * cfg.codebook_size + audio_tokens_start)
    return codes - offsets


def _act(x: torch.Tensor, p: dict, cfg: NanoCodecConfig) -> torch.Tensor:
    if cfg.activation == "snake":
        return snake(x, p["alpha"], p.get("alpha_recip"))
    if cfg.activation == "half_snake":
        half = x.shape[-1] // 2
        a = snake(x[..., :half], p["alpha"], p.get("alpha_recip"))
        b = F.leaky_relu(x[..., half:], cfg.lrelu_slope)
        return torch.cat([a, b], dim=-1)
    return F.leaky_relu(x, cfg.lrelu_slope)


def _causal_conv(x, w, b=None, dilation: int = 1) -> torch.Tensor:
    """Left-padded valid conv: output[t] sees inputs <= t."""
    pad = (w.shape[0] - 1) * dilation
    return conv1d(F.pad(x, (0, 0, pad, 0)), w, b, padding=0, dilation=dilation)


def _causal_conv_transpose(x, w, b=None, stride: int = 1) -> torch.Tensor:
    """Transposed conv trimmed to T * stride from the left (no lookahead)."""
    return conv_transpose1d(x, w, b, stride=stride)[:, :x.shape[1] * stride]


def _res_block(x, p: dict, cfg: NanoCodecConfig) -> torch.Tensor:
    """Chain of dilated residual units: x += conv_k1(act(conv_kd(act(x))))."""
    for j, dil in enumerate(cfg.dilations):
        h = _act(x, p["acts1"][j], cfg)
        h = _causal_conv(h, p["convs1"][j]["w"], p["convs1"][j].get("b"), dilation=dil)
        h = _act(h, p["acts2"][j], cfg)
        h = _causal_conv(h, p["convs2"][j]["w"], p["convs2"][j].get("b"))
        x = x + h
    return x


def hifigan_decode(params: dict, features: torch.Tensor,
                   cfg: NanoCodecConfig) -> torch.Tensor:
    """features (B, T, input_dim) -> waveform (B, T * total_upsample)."""
    x = _causal_conv(features, params["pre_conv"]["w"], params["pre_conv"].get("b"))
    for i, rate in enumerate(cfg.up_sample_rates):
        x = _act(x, params["stage_acts"][i], cfg)
        x = _causal_conv_transpose(x, params["ups"][i]["w"], params["ups"][i].get("b"),
                                   stride=rate)
        acc = None
        for block in params["res_layers"][i]:
            r = _res_block(x, block, cfg)
            acc = r if acc is None else acc + r
        x = acc / len(cfg.kernel_sizes)
    x = _act(x, params["post_act"], cfg)
    x = _causal_conv(x, params["post_conv"]["w"], params["post_conv"].get("b"))
    return x[..., 0]


def init_params(cfg: NanoCodecConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters on `generator.device`, structured as tts_tpu's."""
    dev = generator.device

    def conv_p(k, cin, cout):
        w = torch.randn((k, cin, cout), generator=generator, device=dev) * 0.02
        return {"w": w.to(dtype), "b": torch.zeros(cout, dtype=dtype, device=dev)}

    def act_p(c):
        n = c // 2 if cfg.activation == "half_snake" else c
        return {"alpha": torch.ones(n, dtype=dtype, device=dev),
                "alpha_recip": torch.ones(n, dtype=dtype, device=dev)}

    ch = [cfg.base_channels // (2 ** i) for i in range(len(cfg.up_sample_rates) + 1)]
    return {
        "pre_conv": conv_p(cfg.pre_kernel, cfg.input_dim, ch[0]),
        "stage_acts": [act_p(ch[i]) for i in range(len(cfg.up_sample_rates))],
        "ups": [conv_p(2 * r, ch[i], ch[i + 1])
                for i, r in enumerate(cfg.up_sample_rates)],
        "res_layers": [
            [{"acts1": [act_p(ch[i + 1]) for _ in cfg.dilations],
              "convs1": [conv_p(k, ch[i + 1], ch[i + 1]) for _ in cfg.dilations],
              "acts2": [act_p(ch[i + 1]) for _ in cfg.dilations],
              "convs2": [conv_p(k, ch[i + 1], ch[i + 1]) for _ in cfg.dilations]}
             for k in cfg.kernel_sizes]
            for i in range(len(cfg.up_sample_rates))
        ],
        "post_act": act_p(ch[-1]),
        "post_conv": conv_p(cfg.post_kernel, ch[-1], 1),
    }
