"""IndexTTS-1.5 checkpoint loader (counterpart of
tts_tpu/weights/indextts_loader.py): gpt.pth + bigvgan.pth + config.yaml.

The export-time folds, at load, in numpy:
  * GPT-2 c_attn with the d^-0.25 scale folded into the q and k columns;
  * conformer attention q/k/pos/bias_u/bias_v scaled by d^-0.25 and laid
    out per head, (H, D, d); the subsampling's out linear scaled by
    sqrt(d) (its xscale);
  * perceiver to_q/to_k scaled, to_kv split;
  * ECAPA BatchNorm folded to (scale, shift) from the running statistics;
  * conv weights to the (k, in, out) layout.

The vocoder's rates come from the checkpoint's config.yaml (its `bigvgan:`
section); without that file the loader raises rather than guess them.
"""
from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from ..models.bigvgan import BigVGANConfig
from ..models.indextts import IndexTTSConfig
from .loaders import (CheckpointDict, _f32, _yaml, bigvgan_params_from_state_dict,
                      host_state_dict, load_torch_state_dict, place)

__all__ = ["load_indextts", "indextts_gpt_from_state_dict",
           "indextts_conformer_from_state_dict", "indextts_perceiver_from_state_dict",
           "indextts_ecapa_from_state_dict"]


def _t(w):
    return np.asarray(w).T


def _conv_w(w):
    """(out, in, k) -> (k, in, out)."""
    return np.transpose(np.asarray(w), (2, 1, 0))


def _heads(w, heads, head_dim):
    """(H*d, in) torch linear -> (H, in, d) per-head layout."""
    return np.asarray(w).reshape(heads, head_dim, -1).transpose(0, 2, 1)


def _ln(sd, pre):
    return {"w": _f32(sd[f"{pre}.weight"]), "b": _f32(sd[f"{pre}.bias"])}


def indextts_gpt_from_state_dict(sd: Mapping[str, np.ndarray], cfg: IndexTTSConfig) -> dict:
    """UnifiedVoice state dict (gpt.*, *_embedding, final_norm, mel_head) ->
    the host GPT tree of models/indextts.py."""
    sd = CheckpointDict.wrap(sd, "indextts-gpt")
    scale = cfg.gpt_head_dim ** -0.25
    d = cfg.gpt_dim
    layers = []
    for i in range(cfg.gpt_layers):
        pre = f"gpt.h.{i}"
        w = np.asarray(sd[f"{pre}.attn.c_attn.weight"])         # GPT-2 Conv1D (in, 3d)
        if w.shape[0] == 3 * d:                                 # a plain Linear's layout
            w = w.T
        w = w.copy()
        b = np.asarray(sd[f"{pre}.attn.c_attn.bias"]).copy()
        w[:, :2 * d] *= scale                                   # the q and k columns
        b[:2 * d] *= scale
        layers.append({
            "ln1": _ln(sd, f"{pre}.ln_1"),
            "wqkv": _f32(w),
            "bqkv": _f32(b),
            "wo": _f32(sd[f"{pre}.attn.c_proj.weight"]),
            "bo": _f32(sd[f"{pre}.attn.c_proj.bias"]),
            "ln2": _ln(sd, f"{pre}.ln_2"),
            "fc": {"w": _f32(sd[f"{pre}.mlp.c_fc.weight"]), "b": _f32(sd[f"{pre}.mlp.c_fc.bias"])},
            "proj": {"w": _f32(sd[f"{pre}.mlp.c_proj.weight"]),
                     "b": _f32(sd[f"{pre}.mlp.c_proj.bias"])},
        })
    head_b = sd["mel_head.bias"] if "mel_head.bias" in sd else np.zeros(cfg.num_mel_codes)
    return {
        "text_embed": _f32(sd["text_embedding.weight"]),
        "text_pos": _f32(sd["text_pos_embedding.emb.weight"]),
        "mel_embed": _f32(sd["mel_embedding.weight"]),
        "mel_pos": _f32(sd["mel_pos_embedding.emb.weight"]),
        "layers": layers,
        "ln_f": _ln(sd, "gpt.ln_f"),
        "final_norm": _ln(sd, "final_norm"),
        "lm_head": _f32(_t(sd["mel_head.weight"])),
        "lm_head_b": _f32(head_b),
    }


def _rel_pos_table(d: int, max_len: int) -> np.ndarray:
    """The ESPnet (legacy) positional encoding table."""
    pe = np.zeros((max_len, d), np.float64)
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(np.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


def indextts_conformer_from_state_dict(sd: Mapping[str, np.ndarray],
                                       cfg: IndexTTSConfig) -> dict:
    """conditioning_encoder.* -> the host conformer tree (scales folded)."""
    sd = CheckpointDict.wrap(sd, "indextts-conformer")
    h, d = cfg.enc_heads, cfg.enc_dim
    hd = d // h
    scale = hd ** -0.25
    p = "conditioning_encoder"

    def scaled_heads(key):
        return _f32(_heads(np.asarray(sd[key]) * scale, h, hd))

    def head_rows(key, s=1.0):
        return _f32((np.asarray(sd[key]) * s).reshape(h, 1, hd))

    def pw(key):
        return _f32(_conv_w(sd[key])[0])

    layers = []
    for i in range(cfg.enc_layers):
        pre = f"{p}.encoders.{i}"
        a = f"{pre}.self_attn"
        cm = f"{pre}.conv_module"
        layers.append({
            "norm_mha": _ln(sd, f"{pre}.norm_mha"),
            "attn": {
                "wq": scaled_heads(f"{a}.linear_q.weight"),
                "bq": head_rows(f"{a}.linear_q.bias", scale),
                "wk": scaled_heads(f"{a}.linear_k.weight"),
                "bk": head_rows(f"{a}.linear_k.bias", scale),
                "wv": _f32(_heads(sd[f"{a}.linear_v.weight"], h, hd)),
                "bv": head_rows(f"{a}.linear_v.bias"),
                "wpos": scaled_heads(f"{a}.linear_pos.weight"),
                "bias_u": head_rows(f"{a}.pos_bias_u", scale),
                "bias_v": head_rows(f"{a}.pos_bias_v", scale),
                "wo": _f32(np.asarray(sd[f"{a}.linear_out.weight"])
                           .reshape(d, h, hd).transpose(1, 2, 0)),
                "bo": _f32(sd[f"{a}.linear_out.bias"]),
            },
            "norm_conv": _ln(sd, f"{pre}.norm_conv"),
            "conv": {
                "pw1": {"w": pw(f"{cm}.pointwise_conv1.weight"),
                        "b": _f32(sd[f"{cm}.pointwise_conv1.bias"])},
                "dw": {"w": _f32(_conv_w(sd[f"{cm}.depthwise_conv.weight"])),
                       "b": _f32(sd[f"{cm}.depthwise_conv.bias"])},
                "norm": _ln(sd, f"{cm}.norm"),
                "pw2": {"w": pw(f"{cm}.pointwise_conv2.weight"),
                        "b": _f32(sd[f"{cm}.pointwise_conv2.bias"])},
            },
            "norm_ff": _ln(sd, f"{pre}.norm_ff"),
            "ff1": {"w": _f32(_t(sd[f"{pre}.feed_forward.w_1.weight"])),
                    "b": _f32(sd[f"{pre}.feed_forward.w_1.bias"])},
            "ff2": {"w": _f32(_t(sd[f"{pre}.feed_forward.w_2.weight"])),
                    "b": _f32(sd[f"{pre}.feed_forward.w_2.bias"])},
            "norm_final": _ln(sd, f"{pre}.norm_final"),
        })
    # the subsampling's out linear with xscale = sqrt(d) folded
    xscale = float(d) ** 0.5
    out_w = np.asarray(sd[f"{p}.embed.out.0.weight"]).T * xscale
    out_b = np.asarray(sd[f"{p}.embed.out.0.bias"]) * xscale
    return {
        "sub_convs": [{"w": _f32(sd[f"{p}.embed.conv.{j}.weight"]),
                       "b": _f32(sd[f"{p}.embed.conv.{j}.bias"])} for j in (0, 2)],
        "out": {"w": _f32(out_w), "b": _f32(out_b)},
        # the RelPositionalEncoding table is deterministic: rebuilt here
        "pos_enc": _rel_pos_table(d, 4096),
        "layers": layers,
        "after_norm": _ln(sd, f"{p}.after_norm"),
    }


def indextts_perceiver_from_state_dict(sd: Mapping[str, np.ndarray],
                                       cfg: IndexTTSConfig) -> dict:
    """perceiver_encoder.* -> the host perceiver tree (to_q / to_k scaled)."""
    sd = CheckpointDict.wrap(sd, "indextts-perceiver")
    h, hd = cfg.perceiver_heads, cfg.perceiver_dim_head
    scale = hd ** -0.25
    p = "perceiver_encoder"
    layers = []
    for i in range(2):
        pre = f"{p}.layers.{i}"
        to_q = np.asarray(sd[f"{pre}.0.to_q.weight"]) * scale
        to_kv = np.asarray(sd[f"{pre}.0.to_kv.weight"])
        inner = to_q.shape[0]
        layers.append({
            "wq": _f32(_heads(to_q, h, hd)),
            "wk": _f32(_heads(to_kv[:inner] * scale, h, hd)),
            "wv": _f32(_heads(to_kv[inner:], h, hd)),
            "wo": _f32(np.asarray(sd[f"{pre}.0.to_out.weight"]).reshape(-1, h, hd)
                       .transpose(1, 2, 0)),
            "ff_norm": _ln(sd, f"{pre}.1.0"),
            "ff1": {"w": _f32(_t(sd[f"{pre}.1.1.weight"])), "b": _f32(sd[f"{pre}.1.1.bias"])},
            "ff2": {"w": _f32(_t(sd[f"{pre}.1.3.weight"])), "b": _f32(sd[f"{pre}.1.3.bias"])},
        })
    return {
        "proj_context": {"w": _f32(_t(sd[f"{p}.proj_context.weight"])),
                         "b": _f32(sd[f"{p}.proj_context.bias"])},
        "latents": _f32(sd[f"{p}.latents"]),
        "layers": layers,
        "norm": _ln(sd, f"{p}.norm"),
    }


def _bn_fold(sd, pre, eps: float = 1e-5) -> dict:
    """BatchNorm1d running statistics -> per-channel (scale, shift)."""
    g = np.asarray(sd[f"{pre}.weight"])
    b = np.asarray(sd[f"{pre}.bias"])
    mean = np.asarray(sd[f"{pre}.running_mean"])
    var = np.asarray(sd[f"{pre}.running_var"])
    scale = g / np.sqrt(var + eps)
    return {"scale": _f32(scale), "shift": _f32(b - mean * scale)}


def indextts_ecapa_from_state_dict(sd: Mapping[str, np.ndarray], cfg: IndexTTSConfig) -> dict:
    """speaker_encoder.* (speechbrain ECAPA-TDNN layout) -> the host ECAPA tree."""
    sd = CheckpointDict.wrap(sd, "indextts-ecapa")
    p = "speaker_encoder"

    def tdnn(pre):
        return {"conv": {"w": _f32(_conv_w(sd[f"{pre}.conv.weight"])),
                         "b": _f32(sd[f"{pre}.conv.bias"])},
                "bn": _bn_fold(sd, f"{pre}.norm.norm")}

    se_blocks = []
    for i in (1, 2, 3):
        pre = f"{p}.blocks.{i}"
        se_blocks.append({
            "tdnn1": tdnn(f"{pre}.tdnn1"),
            "res2net": {"blocks": [tdnn(f"{pre}.res2net_block.blocks.{j}")
                                   for j in range(cfg.res2net_scale - 1)]},
            "tdnn2": tdnn(f"{pre}.tdnn2"),
            "se": {"w1": _f32(_conv_w(sd[f"{pre}.se_block.conv1.weight"])[0]),
                   "b1": _f32(sd[f"{pre}.se_block.conv1.bias"]),
                   "w2": _f32(_conv_w(sd[f"{pre}.se_block.conv2.weight"])[0]),
                   "b2": _f32(sd[f"{pre}.se_block.conv2.bias"])},
        })
    fc_b = (sd[f"{p}.fc.bias"] if f"{p}.fc.bias" in sd
            else np.zeros(cfg.speaker_embed_dim))
    return {
        "block0": tdnn(f"{p}.blocks.0"),
        "se_blocks": se_blocks,
        "mfa": tdnn(f"{p}.mfa"),
        "asp_tdnn": tdnn(f"{p}.asp.tdnn"),
        "asp_conv": {"w": _f32(_conv_w(sd[f"{p}.asp.conv.weight"])[0]),
                     "b": _f32(sd[f"{p}.asp.conv.bias"])},
        "asp_bn": _bn_fold(sd, f"{p}.asp_bn"),
        "fc": {"w": _f32(_conv_w(sd[f"{p}.fc.weight"])[0]), "b": _f32(fc_b)},
    }


def _bigvgan_config_from_yaml(path: str, cfg: IndexTTSConfig) -> BigVGANConfig:
    """The IndexTTS vocoder config from the checkpoint's config.yaml
    `bigvgan:` section (the dict the reference BigVGAN reads as `h`). The
    file is required: without it the vocoder's rates are unknown."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: IndexTTS needs the checkpoint's config.yaml for its vocoder's "
            "rates (its `bigvgan:` section); none is guessed")
    with open(path) as f:
        full = _yaml("IndexTTS's config.yaml").safe_load(f) or {}
    h = full.get("bigvgan", {}) or {}
    return BigVGANConfig(
        num_mels=cfg.gpt_dim,
        upsample_initial_channel=h.get("upsample_initial_channel", 1536),
        upsample_rates=tuple(h.get("upsample_rates", (4, 4, 2, 2, 2, 2))),
        upsample_kernel_sizes=tuple(h.get("upsample_kernel_sizes", (8, 8, 4, 4, 4, 4))),
        resblock_kernel_sizes=tuple(h.get("resblock_kernel_sizes", (3, 7, 11))),
        resblock_dilation_sizes=tuple(tuple(d) for d in h.get(
            "resblock_dilation_sizes", ((1, 3, 5), (1, 3, 5), (1, 3, 5)))),
        activation=h.get("activation", "snakebeta"),
        snake_logscale=bool(h.get("snake_logscale", True)),
        use_bias_at_final=True,
        use_tanh_at_final=True,
        sample_rate=h.get("sampling_rate", 24000),
        resblock=str(h.get("resblock", "1")),
        feat_upsample=bool(h.get("feat_upsample", False)),
    )


def load_indextts(model_dir: str, cfg: IndexTTSConfig | None = None,
                  dtype: torch.dtype = torch.float32, device="cuda"):
    """An IndexTTS-1.5 model dir (gpt.pth, bigvgan.pth, config.yaml) ->
    (params on `device` in `dtype` for runtime/indextts.py, cfg, the
    vocoder's BigVGANConfig)."""
    cfg = cfg or IndexTTSConfig()
    vcfg = _bigvgan_config_from_yaml(os.path.join(model_dir, "config.yaml"), cfg)
    gpt_sd = host_state_dict(load_torch_state_dict(os.path.join(model_dir, "gpt.pth")))
    bv_sd = host_state_dict(load_torch_state_dict(os.path.join(model_dir, "bigvgan.pth")))
    gen_sd = {k: v for k, v in bv_sd.items()
              if not k.startswith(("speaker_encoder.", "cond_layer.", "conds."))}
    params = {
        "gpt": indextts_gpt_from_state_dict(gpt_sd, cfg),
        "conformer": indextts_conformer_from_state_dict(gpt_sd, cfg),
        "perceiver": indextts_perceiver_from_state_dict(gpt_sd, cfg),
        "ecapa": indextts_ecapa_from_state_dict(bv_sd, cfg),
        "bigvgan": bigvgan_params_from_state_dict(gen_sd, vcfg),
        "cond_layer": {"w": _f32(_conv_w(bv_sd["cond_layer.weight"])[0]),
                       "b": _f32(bv_sd["cond_layer.bias"])},
        "conds": [{"w": _f32(_conv_w(bv_sd[f"conds.{i}.weight"])[0]),
                   "b": _f32(bv_sd[f"conds.{i}.bias"])}
                  for i in range(len(vcfg.upsample_rates))],
    }
    return place(params, device, dtype), cfg, vcfg
