"""F5-TTS and Vocos checkpoint loaders (counterpart of
tts_tpu/weights/f5_loader.py).

Reads the upstream artifacts (SWivid/F5-TTS `model_1250000.safetensors` +
`vocab.txt`, charactr/vocos-mel-24khz `pytorch_model.bin`) and applies the
export-time transforms at load, in numpy as tts_tpu does:
  * EMA weight selection (keys `ema_model.<name>`);
  * attention-scale folding: Wq, Wk (and biases) *= head_dim ** -0.25, the
    q/k columns permuted per head to the half-split RoPE layout
    (models/f5.hs_perm), then QKV concatenated into one matmul;
  * the time-MLP table at the sway schedule and the AdaLN tables
    (models/f5.attach_mod_tables, in fp32 on the host from the weights
    rounded to `dtype`, as tts_tpu builds them from its cast leaves);
  * Vocos layer-scale gamma folded into pwconv2;
  * torch (out, in) linears transposed to (in, out); convs to (k, in, out).

The tree is folded in fp32 whatever `dtype` is, then cast leaf by leaf on
the host and moved to `device`: a bf16 load is the fp32 load cast to bf16
(`delta_t`, the Euler steps, stays fp32), but for the two AdaLN tables,
which come from the bf16 time table and AdaLN weights. An fp32 tree cast
in the model (`F5Model.to`) keeps the tables of the fp32 weights.
"""
from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from ..models.f5 import (F5Config, _text_freqs_cis, attach_mod_tables, f5_rope_tables,
                         f5_time_embed_table, f5_time_schedule, hs_perm)
from ..models.vocos import VocosConfig
from .loaders import (CheckpointDict, _f32, host_state_dict, load_torch_state_dict, place,
                      read_safetensors)

__all__ = ["load_f5_vocab", "load_f5", "load_vocos",
           "f5_params_from_state_dict", "vocos_params_from_state_dict"]


def load_f5_vocab(path: str) -> dict[str, int]:
    """vocab.txt -> {char: idx}; a line keeps its content without the
    trailing newline, the leading space entry included."""
    vocab = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line[:-1] if line.endswith("\n") else line] = i
    return vocab


def _strip_ema(sd: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The EMA weights when present (keys 'ema_model.<name>'), as f5_tts's
    load_checkpoint(use_ema=True)."""
    ema = {k[len("ema_model."):]: v for k, v in sd.items()
           if k.startswith("ema_model.") and k not in ("ema_model.initted", "ema_model.step")}
    return ema if ema else dict(sd)


def _lin(sd, prefix):
    p = {"w": _f32(sd[f"{prefix}.weight"].T)}
    if f"{prefix}.bias" in sd:
        p["b"] = _f32(sd[f"{prefix}.bias"])
    return p


def _conv(sd, prefix):
    p = {"w": _f32(np.transpose(sd[f"{prefix}.weight"], (2, 1, 0)))}
    if f"{prefix}.bias" in sd:
        p["b"] = _f32(sd[f"{prefix}.bias"])
    return p


def _ln(sd, prefix):
    return {"w": _f32(sd[f"{prefix}.weight"]), "b": _f32(sd[f"{prefix}.bias"])}


def _mod_tables(params: dict, cfg: F5Config, dtype: torch.dtype) -> dict:
    """The AdaLN tables of models/f5.attach_mod_tables, computed in fp32 on
    the host from the time table and AdaLN weights rounded to `dtype` (the
    leaves the tree will hold)."""
    def leaf(a):
        return torch.from_numpy(a).to(dtype).float()

    view = {"time_table": leaf(params["time_table"]),
            "blocks": [{"ada": {k: leaf(v) for k, v in b["ada"].items()}}
                       for b in params["blocks"]],
            "norm_out": {k: leaf(v) for k, v in params["norm_out"].items()},
            "proj_out": {"w": torch.from_numpy(params["proj_out"]["w"])}}
    attach_mod_tables(view, cfg)
    params["ada_table"] = _f32(view["ada_table"].numpy())
    params["norm_out_table"] = _f32(view["norm_out_table"].numpy())
    return params


def f5_params_from_state_dict(sd: Mapping[str, np.ndarray], cfg: F5Config,
                              dtype: torch.dtype = torch.float32) -> dict:
    """The upstream DiT state dict (transformer.* keys) -> the host tree of
    models/f5.py (fp32 numpy arrays), its AdaLN tables those of a tree in
    `dtype`."""
    sd = CheckpointDict.wrap(sd, "f5")
    scale = cfg.head_dim ** -0.25
    t = "transformer"
    heads = cfg.inner_dim // cfg.head_dim
    col_perm = (np.arange(cfg.inner_dim).reshape(heads, cfg.head_dim)
                [:, hs_perm(cfg.head_dim)].reshape(-1))

    def attn_p(i):
        pre = f"{t}.transformer_blocks.{i}.attn"
        wq = (sd[f"{pre}.to_q.weight"].T * scale)[:, col_perm]
        wk = (sd[f"{pre}.to_k.weight"].T * scale)[:, col_perm]
        wv = sd[f"{pre}.to_v.weight"].T
        bq = (sd[f"{pre}.to_q.bias"] * scale)[col_perm]
        bk = (sd[f"{pre}.to_k.bias"] * scale)[col_perm]
        bv = sd[f"{pre}.to_v.bias"]
        return {"wqkv": _f32(np.concatenate([wq, wk, wv], axis=-1)),
                "bqkv": _f32(np.concatenate([bq, bk, bv])),
                "wo": _f32(sd[f"{pre}.to_out.0.weight"].T),
                "bo": _f32(sd[f"{pre}.to_out.0.bias"])}

    def convnext_v2(pre):
        return {"dwconv": _conv(sd, f"{pre}.dwconv"), "norm": _ln(sd, f"{pre}.norm"),
                "pw1": _lin(sd, f"{pre}.pwconv1"),
                "grn": {"gamma": _f32(sd[f"{pre}.grn.gamma"]),
                        "beta": _f32(sd[f"{pre}.grn.beta"])},
                "pw2": _lin(sd, f"{pre}.pwconv2")}

    params = {
        "text_embed": {
            "embed": _f32(sd[f"{t}.text_embed.text_embed.weight"]),
            "blocks": [convnext_v2(f"{t}.text_embed.text_blocks.{i}")
                       for i in range(cfg.conv_layers)],
        },
        "text_freqs_cis": _f32(_text_freqs_cis(cfg.text_dim, 4096)),
        "input_embed": {
            "proj": _lin(sd, f"{t}.input_embed.proj"),
            "conv1": _conv(sd, f"{t}.input_embed.conv_pos_embed.conv1d.0"),
            "conv2": _conv(sd, f"{t}.input_embed.conv_pos_embed.conv1d.2"),
        },
        "blocks": [
            {"ada": _lin(sd, f"{t}.transformer_blocks.{i}.attn_norm.linear"),
             "attn": attn_p(i),
             "ff1": _lin(sd, f"{t}.transformer_blocks.{i}.ff.ff.0.0"),
             "ff2": _lin(sd, f"{t}.transformer_blocks.{i}.ff.ff.2")}
            for i in range(cfg.depth)
        ],
        "norm_out": _lin(sd, f"{t}.norm_out.linear"),
        "proj_out": _lin(sd, f"{t}.proj_out"),
    }
    rope_cos, rope_sin = f5_rope_tables(cfg.max_signal_len, cfg.head_dim)
    params["rope_cos"], params["rope_sin"] = _f32(rope_cos), _f32(rope_sin)
    ts, dts = f5_time_schedule(cfg.nfe_steps, cfg.sway_coef)
    params["time_table"] = _f32(f5_time_embed_table(
        ts, sd[f"{t}.time_embed.time_mlp.0.weight"].T, sd[f"{t}.time_embed.time_mlp.0.bias"],
        sd[f"{t}.time_embed.time_mlp.2.weight"].T, sd[f"{t}.time_embed.time_mlp.2.bias"],
        cfg.freq_embed_dim))
    params["delta_t"] = _f32(dts)
    return _mod_tables(params, cfg, dtype)


def load_f5(safetensors_path: str, vocab_path: str, cfg: F5Config | None = None,
            dtype: torch.dtype = torch.float32, device="cuda"):
    """Returns (params on `device` in `dtype`, cfg, vocab)."""
    vocab = load_f5_vocab(vocab_path)
    if cfg is None:
        cfg = F5Config(vocab_size=len(vocab))
    sd = CheckpointDict(_strip_ema(host_state_dict(read_safetensors(safetensors_path))), "f5")
    params = f5_params_from_state_dict(sd, cfg, dtype)
    # mel_spec.* buffers ride along in the upstream checkpoint; not params
    sd.warn_unused(ignore_substrings=("mel_spec",))
    return place(params, device, dtype), cfg, vocab


# --------------------------------------------------------------------------
# Vocos

def vocos_params_from_state_dict(sd: Mapping[str, np.ndarray], cfg: VocosConfig) -> dict:
    """charactr/vocos-mel-24khz state dict -> the host tree of
    models/vocos.py; layer-scale gamma folded into pwconv2."""
    sd = CheckpointDict.wrap(sd, "vocos")

    def block(i):
        pre = f"backbone.convnext.{i}"
        gamma = sd[f"{pre}.gamma"]                        # (dim,)
        return {"dwconv": _conv(sd, f"{pre}.dwconv"), "norm": _ln(sd, f"{pre}.norm"),
                "pw1": _lin(sd, f"{pre}.pwconv1"),
                "pw2": {"w": _f32(sd[f"{pre}.pwconv2.weight"].T * gamma[None, :]),
                        "b": _f32(sd[f"{pre}.pwconv2.bias"] * gamma)}}

    return {"embed": _conv(sd, "backbone.embed"), "norm": _ln(sd, "backbone.norm"),
            "blocks": [block(i) for i in range(cfg.num_layers)],
            "final_norm": _ln(sd, "backbone.final_layer_norm"),
            "head": _lin(sd, "head.out")}


def load_vocos(model_dir: str, cfg: VocosConfig | None = None,
               dtype: torch.dtype = torch.float32, device="cuda"):
    """A charactr/vocos-mel-24khz style dir (pytorch_model.bin) -> (params
    on `device` in `dtype`, cfg)."""
    cfg = cfg or VocosConfig()
    sd = CheckpointDict(host_state_dict(load_torch_state_dict(
        os.path.join(model_dir, "pytorch_model.bin"))), "vocos")
    params = vocos_params_from_state_dict(sd, cfg)
    # feature_extractor.* (the mel frontend) is audio/mel.py's
    sd.warn_unused(ignore_substrings=("feature_extractor",))
    return place(params, device, dtype), cfg
