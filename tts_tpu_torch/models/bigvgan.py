"""BigVGAN vocoder: mel (B, T, n_mels) -> waveform (counterpart of
tts_tpu/models/bigvgan.py).

conv_pre(7) -> per stage [transposed-conv upsample -> mean of num_kernels
AMP resblocks] -> anti-aliased snake -> conv_post(7) -> tanh or clamp.
AMPBlock1 = per dilation d: x += conv_k_1(act(conv_k_d(act(x)))); AMPBlock2
= per dilation d: x += conv_k_d(act(x)). Feature-last (B, T, C) layout,
weight-norm folded at load, snake parameters stored transformed (alpha =
exp(a), beta_recip = 1/exp(b)), as tts_tpu's params tree has them.

`bigvgan_stage` routes an AMPBlock1 stage through kernel 10
(ops/bigvgan_stage.amp_block_fused) where `fusable_stage` admits it:
tts_tpu's gate (C <= 256 in bf16, <= 128 in fp32, T >= 256) plus, on the
card, the CUDA kernel's limits (bf16, C a multiple of 8). `fused=None`
means that route on every device, so the CPU takes the kernel's twin where
the card takes the kernel. The plain chain's act is
AliasFreeResample.alias_free_act in the activation dtype.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..audio.filters import AliasFreeResample
from ..audio.snake import snake, snake_beta
from ..ops import bigvgan_stage as _k10
from ..ops.conv import conv1d, conv_transpose1d

__all__ = ["BigVGANConfig", "bigvgan_apply", "bigvgan_pre", "bigvgan_stage",
           "bigvgan_post", "init_params", "linear_upsample_4x"]


@dataclass(frozen=True)
class BigVGANConfig:
    """Defaults = bigvgan_v2_24khz_100band_256x, as tts_tpu's."""

    num_mels: int = 100
    upsample_initial_channel: int = 1536
    upsample_rates: tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5),
    )
    activation: str = "snakebeta"          # 'snake' | 'snakebeta'
    snake_logscale: bool = True
    use_bias_at_final: bool = False        # v2 models: no bias, no tanh
    use_tanh_at_final: bool = False
    sample_rate: int = 24000
    resblock: str = "1"                    # '1' = AMPBlock1, '2' = AMPBlock2
    # IndexTTS variant: 4x linear interpolation of the input latents
    feat_upsample: bool = False

    @property
    def num_kernels(self) -> int:
        return len(self.resblock_kernel_sizes)

    @property
    def stage_channels(self) -> tuple[int, ...]:
        return tuple(self.upsample_initial_channel // (2 ** (i + 1))
                     for i in range(len(self.upsample_rates)))

    @property
    def total_upsample(self) -> int:
        """Samples per input frame, including the feat_upsample 4x."""
        return int(np.prod(self.upsample_rates)) * (4 if self.feat_upsample else 1)


_RESAMPLE = AliasFreeResample(2)


def _act(x: torch.Tensor, p: dict, cfg: BigVGANConfig) -> torch.Tensor:
    """Anti-aliased snake / snakebeta in phase space."""
    if cfg.activation == "snakebeta":
        act = lambda u: snake_beta(u, p["alpha"], p["beta_recip"])
    else:
        act = lambda u: snake(u, p["alpha"], p["alpha_recip"])
    return _RESAMPLE.alias_free_act(x, act)


def _amp_block(x, p, kernel_size: int, dilations, cfg: BigVGANConfig):
    """AMPBlock1: per dilation d: x += conv_k_1(act(conv_k_d(act(x))))."""
    pad2 = (kernel_size - 1) // 2
    for j, d in enumerate(dilations):
        xt = _act(x, p["acts1"][j], cfg)
        xt = conv1d(xt, p["convs1"][j]["w"], p["convs1"][j]["b"],
                    padding=(kernel_size * d - d) // 2, dilation=d)
        xt = _act(xt, p["acts2"][j], cfg)
        xt = conv1d(xt, p["convs2"][j]["w"], p["convs2"][j]["b"], padding=pad2)
        x = x + xt
    return x


def _amp_block2(x, p, kernel_size: int, dilations, cfg: BigVGANConfig):
    """AMPBlock2: per dilation d: x += conv_k_d(act(x))."""
    for j, d in enumerate(dilations):
        xt = _act(x, p["acts"][j], cfg)
        xt = conv1d(xt, p["convs"][j]["w"], p["convs"][j]["b"],
                    padding=(kernel_size * d - d) // 2, dilation=d)
        x = x + xt
    return x


def linear_upsample_4x(x: torch.Tensor) -> torch.Tensor:
    """4x linear interpolation along axis 1 of (B, T, C), as
    torch.nn.functional.interpolate(scale_factor=4, mode='linear',
    align_corners=False), written as tts_tpu writes it: four static blends
    of x[t-1], x[t], x[t+1] (edge-clamped), interleaved."""
    xp = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    xn = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    y = torch.stack([0.375 * xp + 0.625 * x, 0.125 * xp + 0.875 * x,
                     0.875 * x + 0.125 * xn, 0.625 * x + 0.375 * xn], dim=2)
    return y.reshape(x.shape[0], 4 * x.shape[1], x.shape[2])


def _amp_block_kernel(x, p, kernel_size: int, dilations, cfg: BigVGANConfig):
    """AMPBlock1 through kernel 10: the whole act -> conv -> act -> conv
    branch chain, one read and one write of x per branch."""
    def st(key, sub):
        return torch.stack([br[sub] for br in p[key]]).to(x.dtype)

    rk = "beta_recip" if cfg.activation == "snakebeta" else "alpha_recip"
    return _k10.amp_block_fused(
        x, st("convs1", "w"), st("convs1", "b"), st("convs2", "w"), st("convs2", "b"),
        st("acts1", "alpha"), st("acts1", rk), st("acts2", "alpha"), st("acts2", rk),
        k=kernel_size, dils=tuple(dilations))


def bigvgan_pre(params, mel: torch.Tensor, cfg: BigVGANConfig,
                cond_embed: torch.Tensor | None = None) -> torch.Tensor:
    """feat-upsample (IndexTTS variant) + conv_pre + speaker embed."""
    if cfg.feat_upsample:
        mel = linear_upsample_4x(mel)
    x = conv1d(mel, params["conv_pre"]["w"], params["conv_pre"]["b"], padding=3)
    if cond_embed is not None:
        x = x + cond_embed
    return x


def bigvgan_stage(params, x: torch.Tensor, i: int, cfg: BigVGANConfig,
                  fused: bool = False, cond: torch.Tensor | None = None) -> torch.Tensor:
    """One upsample stage: transposed conv -> num_kernels AMP blocks
    averaged."""
    rate, ks = cfg.upsample_rates[i], cfg.upsample_kernel_sizes[i]
    up = params["ups"][i]
    x = conv_transpose1d(x, up["w"], up["b"], stride=rate, padding=(ks - rate) // 2)
    if cond is not None:
        x = x + cond
    use_kernel = (fused and cfg.resblock == "1"
                  and _k10.fusable_stage(x.shape[-1], x.shape[1], x.dtype, x.device))
    if use_kernel:
        x = x.contiguous()        # the transposed conv's output is a (B, C, T) view
    block_fn = _amp_block if cfg.resblock == "1" else _amp_block2
    acc = None
    for j, (k, dil) in enumerate(zip(cfg.resblock_kernel_sizes,
                                     cfg.resblock_dilation_sizes)):
        p = params["resblocks"][i * cfg.num_kernels + j]
        r = (_amp_block_kernel(x, p, k, dil, cfg) if use_kernel
             else block_fn(x, p, k, dil, cfg))
        acc = r if acc is None else acc + r
    return acc * (1.0 / cfg.num_kernels)


def bigvgan_post(params, x: torch.Tensor, cfg: BigVGANConfig) -> torch.Tensor:
    """post activation + conv_post + tanh/clamp."""
    x = _act(x, params["act_post"], cfg)
    x = conv1d(x, params["conv_post"]["w"], params["conv_post"].get("b"), padding=3)
    x = x[..., 0]
    if cfg.use_tanh_at_final:
        return torch.tanh(x)
    return torch.clamp(x, -1.0, 1.0)


def bigvgan_apply(params, mel: torch.Tensor, cfg: BigVGANConfig, conds=None,
                  cond_embed: torch.Tensor | None = None,
                  fused: bool | None = None) -> torch.Tensor:
    """mel (B, T, num_mels) -> waveform (B, T * total_upsample) in [-1, 1].

    Speaker conditioning (IndexTTS): `cond_embed` (B, 1, C0) adds after
    conv_pre, `conds[i]` (B, 1, C_i) after each upsample. `fused`: route
    AMPBlock1 stages through kernel 10 where the gate admits them (None:
    on every device)."""
    fused = True if fused is None else fused
    x = bigvgan_pre(params, mel, cfg, cond_embed=cond_embed)
    for i in range(len(cfg.upsample_rates)):
        x = bigvgan_stage(params, x, i, cfg, fused=fused,
                          cond=None if conds is None else conds[i])
    return bigvgan_post(params, x, cfg)


def init_params(cfg: BigVGANConfig, generator: torch.Generator,
                dtype=torch.float32) -> dict:
    """Random-init params with tts_tpu's shapes and scales: conv weights
    N(0, 0.02²), zero biases, unit snake parameters."""
    device = generator.device

    def conv_p(k, cin, cout, bias=True):
        w = torch.randn((k, cin, cout), generator=generator, device=device) * 0.02
        p = {"w": w.to(dtype)}
        if bias:
            p["b"] = torch.zeros((cout,), dtype=dtype, device=device)
        return p

    def act_p(c):
        rk = "beta_recip" if cfg.activation == "snakebeta" else "alpha_recip"
        return {"alpha": torch.ones((c,), dtype=dtype, device=device),
                rk: torch.ones((c,), dtype=dtype, device=device)}

    c0 = cfg.upsample_initial_channel
    params = {"conv_pre": conv_p(7, cfg.num_mels, c0), "ups": [], "resblocks": []}
    ch_in = c0
    for i, ks in enumerate(cfg.upsample_kernel_sizes):
        ch_out = cfg.stage_channels[i]
        params["ups"].append(conv_p(ks, ch_in, ch_out))
        for k, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            if cfg.resblock == "2":
                params["resblocks"].append({
                    "convs": [conv_p(k, ch_out, ch_out) for _ in dil],
                    "acts": [act_p(ch_out) for _ in dil]})
            else:
                params["resblocks"].append({
                    "convs1": [conv_p(k, ch_out, ch_out) for _ in dil],
                    "convs2": [conv_p(k, ch_out, ch_out) for _ in dil],
                    "acts1": [act_p(ch_out) for _ in dil],
                    "acts2": [act_p(ch_out) for _ in dil]})
        ch_in = ch_out
    params["act_post"] = act_p(ch_in)
    params["conv_post"] = conv_p(7, ch_in, 1, bias=cfg.use_bias_at_final)
    return params
