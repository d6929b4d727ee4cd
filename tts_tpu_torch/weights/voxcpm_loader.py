"""VoxCPM-1.5 / VoxCPM-2 checkpoint loader (counterpart of
tts_tpu/weights/voxcpm_loader.py): a pytorch_model.bin or model.safetensors
directory.

The export-time folds, at load, in numpy:
  * qkv fused with the input RMSNorm absorbed, the scale d^-0.25 into q/k;
  * gate/up fused with the post-attention norm absorbed;
  * the residual LM's final norm folded into res_to_dit_proj, the feature
    encoder's into enc_to_lm_proj, the estimator's into its out_proj;
  * lm_to_dit_proj and stop_proj fused into one matmul;
  * the CFM time tables at the sway schedule;
  * VoxCPM-2's muP (`use_mup`): scale_emb into the embedding and
    scale_depth / sqrt(L) into o_proj / down_proj;
  * the VAE's weight norm collapsed.
"""
from __future__ import annotations

import math
import os
from typing import Mapping

import numpy as np
import torch

from ..models.voxcpm import LlamaStackConfig, VoxCPMConfig, cfm_time_schedule
from ..nn.rope import rope_table
from .loaders import (CheckpointDict, _f32, collapse_weight_norm, host_state_dict,
                      load_torch_state_dict, place, read_safetensors)

__all__ = ["load_voxcpm", "llama_stack_from_state_dict", "vae_from_state_dict"]


def llama_stack_from_state_dict(sd: Mapping[str, np.ndarray], prefix: str,
                                cfg: LlamaStackConfig, residual_scale: float = 1.0) -> dict:
    """`{prefix}.layers.{i}` MiniCPM/Llama weights -> the host tree of a
    stack with the norm folds (place it with `place(tree,
    kind="llama_stack")`); residual_scale (MiniCPM's scale_depth / sqrt(L))
    folds into o_proj / down_proj."""
    sd = CheckpointDict.wrap(sd, "voxcpm-lm")
    scale = cfg.head_dim ** -0.25
    layers = []
    for i in range(cfg.num_layers):
        p = f"{prefix}.layers.{i}"
        in_norm = np.asarray(sd[f"{p}.input_layernorm.weight"])[None, :]
        post_norm = np.asarray(sd[f"{p}.post_attention_layernorm.weight"])[None, :]
        wq = np.asarray(sd[f"{p}.self_attn.q_proj.weight"]) * in_norm * scale
        wk = np.asarray(sd[f"{p}.self_attn.k_proj.weight"]) * in_norm * scale
        wv = np.asarray(sd[f"{p}.self_attn.v_proj.weight"]) * in_norm
        layers.append({
            "wqkv": _f32(np.concatenate([wq, wk, wv], axis=0).T),
            "wo": _f32((np.asarray(sd[f"{p}.self_attn.o_proj.weight"]) * residual_scale).T),
            "w_gate_up": _f32(np.concatenate(
                [np.asarray(sd[f"{p}.mlp.gate_proj.weight"]) * post_norm,
                 np.asarray(sd[f"{p}.mlp.up_proj.weight"]) * post_norm], axis=0).T),
            "w_down": _f32((np.asarray(sd[f"{p}.mlp.down_proj.weight"]) * residual_scale).T),
        })
    return {"layers": layers}


def _wn(sd, pre):
    """A conv's weight under `pre`, its (parametrized) weight norm collapsed."""
    for g_key, v_key in ((f"{pre}.weight_g", f"{pre}.weight_v"),
                         (f"{pre}.parametrizations.weight.original0",
                          f"{pre}.parametrizations.weight.original1")):
        if g_key in sd:
            return collapse_weight_norm(np.asarray(sd[g_key]), np.asarray(sd[v_key]))
    return np.asarray(sd[f"{pre}.weight"])


def _conv(sd, pre, transposed=False, scale=1.0):
    w = _wn(sd, pre) * scale
    p = {"w": _f32(np.transpose(w, (2, 0, 1) if transposed else (2, 1, 0)))}
    if f"{pre}.bias" in sd:
        p["b"] = _f32(np.asarray(sd[f"{pre}.bias"]) * scale)
    return p


def _snake(sd, pre):
    alpha = np.asarray(sd[f"{pre}.alpha"]).reshape(-1).astype(np.float64)
    return {"alpha": _f32(alpha), "alpha_recip": _f32(1.0 / (alpha + 1e-9))}


def _unit(sd, pre):
    return {"s1": _snake(sd, f"{pre}.block.0"), "c1": _conv(sd, f"{pre}.block.1"),
            "s2": _snake(sd, f"{pre}.block.2"), "c2": _conv(sd, f"{pre}.block.3")}


def vae_from_state_dict(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """audio_vae.* -> the host VAE tree of models/voxcpm.py. Encoder:
    block.0 the first conv, block.{1..} CausalEncoderBlock (3 units, snake,
    down). Decoder: model.0 the pre conv (or model.0/1 the depthwise and
    pointwise pair), then CausalDecoderBlock (snake, up, an optional noise
    linear, 3 units), each paired with a sr_cond_model.{i} rate layer where
    present, then the post snake and conv. The input stays float in
    [-1, 1], so the reference's 1/32768 fold into the first conv is not
    applied."""
    sd = CheckpointDict.wrap(sd, "voxcpm-vae")
    e = "audio_vae.encoder"
    enc_blocks = []
    for i, _ in enumerate(cfg.strides):
        b = f"{e}.block.{i + 1}.block"
        enc_blocks.append({"units": [_unit(sd, f"{b}.{j}") for j in range(3)],
                           "snake": _snake(sd, f"{b}.3"), "down": _conv(sd, f"{b}.4")})
    d = "audio_vae.decoder.model"
    dec_rates = cfg.decoder_rates or tuple(reversed(cfg.strides))
    n = len(dec_rates)
    first_block = 2 if cfg.depthwise else 1
    dec_blocks = []
    for i in range(n):
        b = f"{d}.{i + first_block}.block"
        sr = f"audio_vae.decoder.sr_cond_model.{i + first_block}"
        off = 2
        blk = {"snake": _snake(sd, f"{b}.0"), "up": _conv(sd, f"{b}.1", transposed=True)}
        if (f"{b}.2.linear.weight" in sd or f"{b}.2.linear.weight_g" in sd
                or f"{b}.2.linear.parametrizations.weight.original0" in sd):
            blk["noise"] = {"w": _conv(sd, f"{b}.2.linear")["w"]}
            off = 3
        blk["units"] = [_unit(sd, f"{b}.{off + j}") for j in range(3)]
        if f"{sr}.scale_embed.weight" in sd:
            blk["sr_scale"] = _f32(sd[f"{sr}.scale_embed.weight"])
            blk["sr_bias"] = _f32(sd[f"{sr}.bias_embed.weight"])
            if f"{sr}.out_layer.0.alpha" in sd:
                blk["sr_out_snake"] = _snake(sd, f"{sr}.out_layer.0")
                blk["sr_out_conv"] = _conv(sd, f"{sr}.out_layer.1")
        dec_blocks.append(blk)
    if cfg.depthwise:
        dec = {"pre_dw": _conv(sd, f"{d}.0"), "pre": _conv(sd, f"{d}.1"),
               "dec_blocks": dec_blocks, "post_snake": _snake(sd, f"{d}.{n + 2}"),
               "post": _conv(sd, f"{d}.{n + 3}")}
    else:
        dec = {"pre": _conv(sd, f"{d}.0"), "dec_blocks": dec_blocks,
               "post_snake": _snake(sd, f"{d}.{n + 1}"), "post": _conv(sd, f"{d}.{n + 2}")}
    return {"pre": _conv(sd, f"{e}.block.0"), "enc_blocks": enc_blocks,
            "fc_mu": _conv(sd, f"{e}.fc_mu"), "dec": dec}


def _sinusoidal_time_embed(t: np.ndarray, dim: int) -> np.ndarray:
    """The estimator's diffusers-style SinusoidalPosEmb."""
    half = dim // 2
    emb = np.log(10000.0) / (half - 1)
    emb = np.exp(np.arange(half) * -emb)
    emb = 1000.0 * t[:, None] * emb[None, :]
    return np.concatenate([np.sin(emb), np.cos(emb)], axis=-1)


def _mlp(x, w1, b1, w2, b2):
    h = x @ w1.T + b1
    h = h / (1.0 + np.exp(-h))
    return h @ w2.T + b2


def _cfm_tables(sd, cfg: VoxCPMConfig) -> dict:
    """The estimator's time embedding (+ the delta-time MLP) at the sway
    schedule, a pure function of the fixed schedule folded into a table."""
    ts, dts = cfm_time_schedule(cfg.cfm_steps, cfg.cfm_sway)
    est = "feat_decoder.estimator"
    d = cfg.estimator.hidden_size
    t_tab = _mlp(_sinusoidal_time_embed(ts[:-1], d),
                 np.asarray(sd[f"{est}.time_mlp.0.weight"]),
                 np.asarray(sd[f"{est}.time_mlp.0.bias"]),
                 np.asarray(sd[f"{est}.time_mlp.2.weight"]),
                 np.asarray(sd[f"{est}.time_mlp.2.bias"]))
    if f"{est}.delta_time_mlp.0.weight" in sd:
        # mean mode embeds the per-step dt; otherwise a constant zero time
        dt_in = dts if cfg.cfm_mean_mode else np.zeros(1, np.float32)
        dt_tab = _mlp(_sinusoidal_time_embed(np.asarray(dt_in, np.float32), d),
                      np.asarray(sd[f"{est}.delta_time_mlp.0.weight"]),
                      np.asarray(sd[f"{est}.delta_time_mlp.0.bias"]),
                      np.asarray(sd[f"{est}.delta_time_mlp.2.weight"]),
                      np.asarray(sd[f"{est}.delta_time_mlp.2.bias"]))
        t_tab = t_tab + dt_tab
    return {"cfm_t_table": _f32(t_tab), "cfm_dt": _f32(dts)}


def load_voxcpm(model_dir: str, cfg: VoxCPMConfig | None = None,
                dtype: torch.dtype = torch.float32, use_mup: bool = False,
                scale_emb: float = 1.0, scale_depth: float = 1.0, device="cuda"):
    """(params, vae_params, cfg), both trees on `device` in `dtype`.

    VoxCPM-2 checkpoints use MiniCPM's muP: pass use_mup=True with the
    config's scale_emb / scale_depth (the embedding scale folds into
    embed_tokens, scale_depth / sqrt(L) into o_proj / down_proj)."""
    path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(path):
        sd = host_state_dict(load_torch_state_dict(path))
    else:
        sd = host_state_dict(read_safetensors(os.path.join(model_dir, "model.safetensors")))
    cfg = cfg or VoxCPMConfig()
    base_res = scale_depth / math.sqrt(cfg.base.num_layers) if use_mup else 1.0
    res_res = scale_depth / math.sqrt(cfg.residual.num_layers) if use_mup else 1.0
    est_norm = np.asarray(sd["feat_decoder.estimator.decoder.norm.weight"])[None, :]
    fe_norm = np.asarray(sd["feat_encoder.encoder.norm.weight"])[None, :]
    res_norm = np.asarray(sd["residual_lm.norm.weight"])[None, :]
    dit_w = np.asarray(sd["lm_to_dit_proj.weight"])
    stop_w = np.asarray(sd["stop_proj.weight"])

    def get(key, default):
        return sd[key] if key in sd else default

    params = {
        "embed": _f32(np.asarray(sd["base_lm.embed_tokens.weight"])
                      * (scale_emb if use_mup else 1.0)),
        "base": llama_stack_from_state_dict(sd, "base_lm", cfg.base, residual_scale=base_res),
        "base_norm": _f32(sd["base_lm.norm.weight"]),
        "residual": llama_stack_from_state_dict(sd, "residual_lm", cfg.residual,
                                                residual_scale=res_res),
        "fsq_down": {"w": _f32(np.asarray(sd["fsq_layer.in_proj.weight"]).T),
                     "b": _f32(get("fsq_layer.in_proj.bias", np.zeros(cfg.fsq_dim)))},
        "fsq_up": {"w": _f32(np.asarray(sd["fsq_layer.out_proj.weight"]).T),
                   "b": _f32(get("fsq_layer.out_proj.bias", np.zeros(cfg.base.hidden_size)))},
        "dit_stop": {"w": _f32(np.concatenate([dit_w, stop_w], axis=0).T)},
        "res_to_dit": {"w": _f32((np.asarray(sd["res_to_dit_proj.weight"]) * res_norm).T)},
        "stop_head": {"w": _f32(np.asarray(sd["stop_head.weight"]).T),
                      "b": _f32(get("stop_head.bias", np.zeros(2)))},
        "fe": llama_stack_from_state_dict(sd, "feat_encoder.encoder", cfg.feat_encoder),
        "fe_in_proj": {"w": _f32(np.asarray(sd["feat_encoder.in_proj.weight"]).T),
                       "b": _f32(sd["feat_encoder.in_proj.bias"])},
        "fe_special": _f32(np.asarray(sd["feat_encoder.special_token"]).reshape(1, -1)),
        "enc_to_lm": {"w": _f32((np.asarray(sd["enc_to_lm_proj.weight"]) * fe_norm).T)},
        "cond_proj": {"w": _f32(np.asarray(sd["feat_decoder.estimator.cond_proj.weight"]).T),
                      "b": _f32(sd["feat_decoder.estimator.cond_proj.bias"])},
        "est": llama_stack_from_state_dict(sd, "feat_decoder.estimator.decoder", cfg.estimator),
        "est_in_proj": {"w": _f32(np.asarray(sd["feat_decoder.estimator.in_proj.weight"]).T),
                        "b": _f32(sd["feat_decoder.estimator.in_proj.bias"])},
        "est_out_proj": {"w": _f32((np.asarray(sd["feat_decoder.estimator.out_proj.weight"])
                                    * est_norm).T)},
    }
    params.update(_cfm_tables(sd, cfg))
    for name, c in (("rope", cfg.base), ("fe_rope", cfg.feat_encoder),
                    ("est_rope", cfg.estimator)):
        cos, sin = rope_table(c.max_seq_len, c.head_dim, c.rope_base)
        params[f"{name}_cos"], params[f"{name}_sin"] = _f32(cos), _f32(sin)
    vae_params = vae_from_state_dict(sd, cfg.vae)
    return place(params, device, dtype), place(vae_params, device, dtype), cfg
