"""KaniTTS checkpoint loaders (counterpart of tts_tpu/weights/kani_loader.py):
the HF LFM2 acoustic LM and the NeMo NanoCodec `.nemo` tar.

The export-time folds, at load, in numpy:
  * operator_norm absorbed into the fused QKV / the conv in_proj;
  * ffn_norm absorbed into w1/w3 (fused gate_up);
  * embedding_norm absorbed into lm_head;
  * the attention scale d^-0.25 folded into each of the q/k per-head norms;
  * the codec's weight norm collapsed (its 32767 output scale optional).

The reference folds norm_weight * sqrt(H) because its RMSNorm is sum-based;
the port's is mean-based, so only norm_weight is folded — the same math.
"""
from __future__ import annotations

import io
import json
import os
import tarfile
from typing import Mapping

import numpy as np
import torch

from ..models.kani import KaniConfig
from ..models.nanocodec import NanoCodecConfig
from ..nn.rope import rope_table
from .loaders import (CheckpointDict, _f32, _yaml, collapse_weight_norm, host_state_dict,
                      load_hf_state_dict, place)

__all__ = ["load_kani_lm", "kani_params_from_state_dict", "kani_config_from_json",
           "load_nanocodec", "nanocodec_params_from_state_dict", "nanocodec_config_from_yaml"]


# --------------------------------------------------------------------------
# LFM2 acoustic LM

def kani_config_from_json(path: str) -> KaniConfig:
    with open(path) as f:
        c = json.load(f)
    layer_types = tuple("attn" if t == "full_attention" else "conv" for t in c["layer_types"])
    hidden = c["hidden_size"]
    heads = c["num_attention_heads"]
    return KaniConfig(
        hidden_size=hidden,
        num_heads=heads,
        num_kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim") or hidden // heads,
        ffn_dim=c.get("block_ff_dim") or c.get("intermediate_size"),
        vocab_size=c["vocab_size"],
        layer_types=layer_types,
        conv_kernel=c.get("conv_L_cache", 3),
        rope_base=c.get("rope_theta", 1000000.0),
        rms_eps=c.get("norm_eps", 1e-5),
    )


def kani_params_from_state_dict(sd: Mapping[str, np.ndarray], cfg: KaniConfig) -> dict:
    """HF LFM2 weights (model.layers.{i}.*) -> the host tree of models/kani.py."""
    sd = CheckpointDict.wrap(sd, "kani-lm")
    scale = cfg.head_dim ** -0.25
    layers = []
    for i, lt in enumerate(cfg.layer_types):
        pre = f"model.layers.{i}"
        op_norm = sd[f"{pre}.operator_norm.weight"][None, :]   # (1, H)
        ffn_norm = sd[f"{pre}.ffn_norm.weight"][None, :]
        p = {"ffn": {
            "w_gate_up": _f32(np.concatenate(
                [(sd[f"{pre}.feed_forward.w1.weight"] * ffn_norm).T,
                 (sd[f"{pre}.feed_forward.w3.weight"] * ffn_norm).T], axis=-1)),
            "w_down": _f32(sd[f"{pre}.feed_forward.w2.weight"].T),
        }}
        if lt == "attn":
            a = f"{pre}.self_attn"
            wqkv = np.concatenate([sd[f"{a}.q_proj.weight"] * op_norm,
                                   sd[f"{a}.k_proj.weight"] * op_norm,
                                   sd[f"{a}.v_proj.weight"] * op_norm], axis=0).T
            p.update(wqkv=_f32(wqkv),
                     q_norm=_f32(sd[f"{a}.q_layernorm.weight"] * scale),
                     k_norm=_f32(sd[f"{a}.k_layernorm.weight"] * scale),
                     wo=_f32(sd[f"{a}.out_proj.weight"].T))
        else:
            c = f"{pre}.conv"
            conv_w = sd[f"{c}.conv.weight"]                    # (H, 1, K)
            p.update(in_proj=_f32((sd[f"{c}.in_proj.weight"] * op_norm).T),
                     conv_w=_f32(np.transpose(conv_w, (2, 1, 0))),
                     out_proj=_f32(sd[f"{c}.out_proj.weight"].T))
            if f"{c}.conv.bias" in sd:
                p["conv_b"] = _f32(sd[f"{c}.conv.bias"])
        layers.append(p)

    emb_norm = sd["model.embedding_norm.weight"][None, :]
    lm_head = sd["lm_head.weight"] if "lm_head.weight" in sd else sd["model.embed_tokens.weight"]
    rope_cos, rope_sin = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_base)
    return {"embed": _f32(sd["model.embed_tokens.weight"]), "layers": layers,
            "lm_head": _f32((lm_head * emb_norm).T),
            "rope_cos": _f32(rope_cos), "rope_sin": _f32(rope_sin)}


def load_kani_lm(model_dir: str, dtype: torch.dtype = torch.float32, device="cuda"):
    """A kani-tts HF dir (config.json + safetensors shards or
    pytorch_model.bin) -> (params on `device` in `dtype`, cfg)."""
    cfg = kani_config_from_json(os.path.join(model_dir, "config.json"))
    sd = CheckpointDict(host_state_dict(load_hf_state_dict(model_dir)), "kani-lm")
    params = kani_params_from_state_dict(sd, cfg)
    sd.warn_unused()
    return place(params, device, dtype), cfg


# --------------------------------------------------------------------------
# NanoCodec (.nemo tar = model_config.yaml + model_weights.ckpt)

def _read_nemo(nemo_path: str):
    """(config dict, host state dict) of a .nemo tar, read without NeMo."""
    yaml = _yaml("a .nemo config (model_config.yaml)")
    cfg = sd = None
    with tarfile.open(nemo_path) as tar:
        for m in tar.getmembers():
            name = os.path.basename(m.name)
            if name == "model_config.yaml":
                cfg = yaml.safe_load(tar.extractfile(m).read())
            elif name in ("model_weights.ckpt", "model_weights.pt"):
                sd = torch.load(io.BytesIO(tar.extractfile(m).read()),
                                map_location="cpu", weights_only=True)
    if cfg is None or sd is None:
        raise FileNotFoundError(f"{nemo_path}: missing config or weights")
    return cfg, host_state_dict({k: v for k, v in sd.items() if isinstance(v, torch.Tensor)})


def nanocodec_config_from_yaml(cfg: dict) -> NanoCodecConfig:
    dec = cfg["audio_decoder"]
    vq = cfg["vector_quantizer"]
    levels = tuple(vq.get("codebook_dim_levels") or vq.get("num_levels") or (9, 8, 8, 7))
    groups = int(vq.get("num_groups", 4))
    return NanoCodecConfig(
        num_groups=groups,
        dims_per_group=len(levels),
        levels=levels,
        codebook_size=int(np.prod(levels)),
        base_channels=int(dec.get("base_channels", 864)),
        up_sample_rates=tuple(dec.get("up_sample_rates", (7, 7, 6, 6))),
        activation=dec.get("activation", "half_snake"),
        sample_rate=int(cfg.get("sample_rate", 22050)),
    )


def _wn_conv(sd: Mapping[str, np.ndarray], prefix: str, transposed=False):
    """A conv with torch's parametrized weight norm (parametrizations.weight.
    original0/original1), the old weight_g/weight_v, or a plain weight ->
    (k, in, out) layout."""
    if f"{prefix}.parametrizations.weight.original0" in sd:
        w = collapse_weight_norm(sd[f"{prefix}.parametrizations.weight.original0"],
                                 sd[f"{prefix}.parametrizations.weight.original1"])
    elif f"{prefix}.weight_g" in sd:
        w = collapse_weight_norm(sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"])
    else:
        w = sd[f"{prefix}.weight"]
    p = {"w": _f32(np.transpose(w, (2, 0, 1) if transposed else (2, 1, 0)))}
    if f"{prefix}.bias" in sd:
        p["b"] = _f32(sd[f"{prefix}.bias"])
    return p


def _codec_act(sd: Mapping[str, np.ndarray], prefix: str):
    """CodecActivation params: the snake alpha (linear scale in NeMo) and its
    reciprocal in float64; lrelu has none."""
    for key in (f"{prefix}.snake.alpha", f"{prefix}.alpha", f"{prefix}.snake_act.alpha"):
        if key in sd:
            alpha = sd[key].reshape(-1).astype(np.float64)
            return {"alpha": _f32(alpha), "alpha_recip": _f32(1.0 / (alpha + 1e-9))}
    return {}


def nanocodec_params_from_state_dict(sd: Mapping[str, np.ndarray], cfg: NanoCodecConfig,
                                     out_scale: float = 1.0) -> dict:
    """The NeMo decoder (audio_decoder.*) -> the host tree of
    models/nanocodec.py. out_scale optionally folds the int16 scale into
    post_conv as the reference's export does; the pipeline scales after
    clipping instead, so the default keeps the weights unscaled."""
    sd = CheckpointDict.wrap(sd, "nanocodec")
    d = "audio_decoder"
    n = len(cfg.up_sample_rates)
    params = {
        "pre_conv": _wn_conv(sd, f"{d}.pre_conv.conv"),
        "stage_acts": [_codec_act(sd, f"{d}.activations.{i}") for i in range(n)],
        "ups": [_wn_conv(sd, f"{d}.up_sample_conv_layers.{i}.conv", transposed=True)
                for i in range(n)],
        "res_layers": [],
        "post_act": _codec_act(sd, f"{d}.post_activation"),
    }
    for i in range(n):
        blocks = []
        for j in range(len(cfg.kernel_sizes)):
            rb = f"{d}.res_layers.{i}.res_blocks.{j}.res_blocks"
            ks = range(len(cfg.dilations))
            blocks.append({
                "acts1": [_codec_act(sd, f"{rb}.{k}.input_activation") for k in ks],
                "convs1": [_wn_conv(sd, f"{rb}.{k}.input_conv.conv") for k in ks],
                "acts2": [_codec_act(sd, f"{rb}.{k}.skip_activation") for k in ks],
                "convs2": [_wn_conv(sd, f"{rb}.{k}.skip_conv.conv") for k in ks],
            })
        params["res_layers"].append(blocks)
    post = _wn_conv(sd, f"{d}.post_conv.conv")
    post["w"] = _f32(post["w"] * np.float32(out_scale))
    if "b" in post:
        post["b"] = _f32(post["b"] * np.float32(out_scale))
    params["post_conv"] = post
    return params


def load_nanocodec(nemo_path: str, dtype: torch.dtype = torch.float32, device="cuda"):
    """A nemo-nano-codec `.nemo` tar -> (params on `device` in `dtype`, cfg)."""
    ycfg, sd = _read_nemo(nemo_path)
    cfg = nanocodec_config_from_yaml(ycfg)
    sd = CheckpointDict(sd, "nanocodec")
    params = nanocodec_params_from_state_dict(sd, cfg)
    # .nemo checkpoints carry the encoder and the discriminator: decode only
    sd.warn_unused(ignore_substrings=("discriminator", "audio_encoder", "encoder."))
    return place(params, device, dtype), cfg
