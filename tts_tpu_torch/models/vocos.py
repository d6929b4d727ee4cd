"""Vocos mel vocoder: ConvNeXt backbone + ISTFT head (counterpart of
tts_tpu/models/vocos.py).

embed conv(7) -> LayerNorm -> N ConvNeXt blocks (dwconv7 / LN / pw1 /
exact GELU / pw2, layer scale folded into pw2) -> final LayerNorm -> linear
head -> (exp-clamped magnitude, phase) -> ISTFT. It keeps the true
LayerNorm, as tts_tpu does. The head and the ISTFT run in fp32.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..audio.stft import IstftKernel
from ..nn.norm import layer_norm
from ..ops.conv import conv1d
from ._params import ParamTree

__all__ = ["VocosConfig", "VocosModel", "vocos_backbone", "vocos_decode",
           "init_params"]


@dataclass(frozen=True)
class VocosConfig:
    """Defaults = charactr/vocos-mel-24khz (the F5 vocoder)."""

    input_channels: int = 100
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop: int = 256
    sample_rate: int = 24000


@functools.lru_cache(maxsize=8)
def _istft(n_fft: int, hop: int) -> IstftKernel:
    return IstftKernel(n_fft, hop, n_fft)


def _convnext_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    r = x
    x = conv1d(x, p["dwconv"]["w"], p["dwconv"]["b"], padding=3, groups=x.shape[-1])
    x = layer_norm(x, p["norm"]["w"], p["norm"]["b"], eps=1e-6)
    x = torch.matmul(x, p["pw1"]["w"]) + p["pw1"]["b"]
    x = F.gelu(x)
    x = torch.matmul(x, p["pw2"]["w"]) + p["pw2"]["b"]
    return r + x


def vocos_backbone(params: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, input_channels) -> hidden (B, T, dim)."""
    x = conv1d(mel, params["embed"]["w"], params["embed"]["b"], padding=3)
    x = layer_norm(x, params["norm"]["w"], params["norm"]["b"], eps=1e-6)
    for p in params["blocks"]:
        x = _convnext_block(x, p)
    return layer_norm(x, params["final_norm"]["w"], params["final_norm"]["b"],
                      eps=1e-6)


def vocos_decode(params: dict, mel: torch.Tensor, cfg: VocosConfig) -> torch.Tensor:
    """mel (B, T, input_channels) -> waveform (B, (T-1)*hop), float,
    unclamped."""
    x = vocos_backbone(params, mel.to(params["embed"]["w"].dtype))
    spec = torch.matmul(x.float(), params["head"]["w"].float()) \
        + params["head"]["b"].float()                               # (B, T, n_fft+2)
    mag, phase = torch.chunk(spec.transpose(-1, -2), 2, dim=-2)
    mag = torch.clamp(torch.exp(mag), max=1e2)
    return _istft(cfg.n_fft, cfg.hop).from_mag_phase(mag, phase)


def init_params(cfg: VocosConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters on `generator.device`, structured as tts_tpu's."""
    dev = generator.device

    def lin(cin, cout):
        w = torch.randn((cin, cout), generator=generator, device=dev) * 0.02
        return {"w": w.to(dtype), "b": torch.zeros(cout, dtype=dtype, device=dev)}

    def conv(k, cin, cout, groups=1):
        w = torch.randn((k, cin // groups, cout), generator=generator, device=dev) * 0.02
        return {"w": w.to(dtype), "b": torch.zeros(cout, dtype=dtype, device=dev)}

    def ln(c):
        return {"w": torch.ones(c, dtype=dtype, device=dev),
                "b": torch.zeros(c, dtype=dtype, device=dev)}

    return {
        "embed": conv(7, cfg.input_channels, cfg.dim),
        "norm": ln(cfg.dim),
        "blocks": [
            {"dwconv": conv(7, cfg.dim, cfg.dim, groups=cfg.dim),
             "norm": ln(cfg.dim),
             "pw1": lin(cfg.dim, cfg.intermediate_dim),
             "pw2": lin(cfg.intermediate_dim, cfg.dim)}
            for _ in range(cfg.num_layers)
        ],
        "final_norm": ln(cfg.dim),
        "head": lin(cfg.dim, cfg.n_fft + 2),
    }


class VocosModel(ParamTree):
    """Vocos parameters as a module: `VocosModel(cfg, params).to(device, dtype)`."""

    def __init__(self, cfg: VocosConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg
