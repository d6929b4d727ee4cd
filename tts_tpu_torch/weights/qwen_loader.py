"""Qwen3-TTS checkpoint loader (counterpart of tts_tpu/weights/qwen_loader.py):
the HF safetensors directory's talker, code predictor, codec decoder, Mimi
prompt encoder and speaker encoder.

The export-time folds, at load, in numpy:
  * qkv fused, the input RMSNorm absorbed into qkv;
  * the q/k per-head norm weights scaled by d^-0.25 (mean-based norms, so
    only the scale is folded);
  * gate/up fused with the post-attention norm absorbed;
  * the final norm folded into codec_head and the 15 stacked LM heads;
  * the 15 predictor LM heads stacked to (15, H, V) and the 15 group
    embedding tables to (15, V, H);
  * the Mimi encoder's LayerNorm affines into its qkv and fc1, its layer
    scales into o_proj and fc2, its codebooks from embed_sum /
    cluster_usage.
Half-precision entries are upcast exactly to fp32 before any fold.
"""
from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np
import torch

from ..models.qwen_codec import QwenCodecDecoderConfig
from ..models.qwen_tts import Qwen3StackConfig, QwenTTSConfig, make_suppress_bias
from ..nn.rope import rope_table
from .loaders import CheckpointDict, _f32, host_state_dict, load_hf_state_dict, place

__all__ = ["load_qwen_tts", "qwen3_stack_from_state_dict", "qwen_config_from_json",
           "load_qwen_codec", "qwen_codec_from_state_dict", "load_qwen_encoder",
           "mimi_encoder_from_state_dict", "qwen_speaker_from_state_dict"]


def qwen3_stack_from_state_dict(sd: Mapping[str, np.ndarray], prefix: str,
                                cfg: Qwen3StackConfig) -> dict:
    """`{prefix}.layers.{i}.*` Qwen3 decoder weights -> the host tree of a
    stack, with the folds (place it with `place(tree, kind="qwen3_stack")`)."""
    sd = CheckpointDict.wrap(sd, f"qwen3[{prefix}]")
    scale = cfg.head_dim ** -0.25
    layers = []
    for i in range(cfg.num_layers):
        p = f"{prefix}.layers.{i}"
        in_norm = np.asarray(sd[f"{p}.input_layernorm.weight"])[None, :]
        post_norm = np.asarray(sd[f"{p}.post_attention_layernorm.weight"])[None, :]
        wq = np.asarray(sd[f"{p}.self_attn.q_proj.weight"]) * in_norm
        wk = np.asarray(sd[f"{p}.self_attn.k_proj.weight"]) * in_norm
        wv = np.asarray(sd[f"{p}.self_attn.v_proj.weight"]) * in_norm
        layer = {
            "wqkv": _f32(np.concatenate([wq, wk, wv], axis=0).T),
            "q_norm": _f32(np.asarray(sd[f"{p}.self_attn.q_norm.weight"]) * scale),
            "k_norm": _f32(np.asarray(sd[f"{p}.self_attn.k_norm.weight"]) * scale),
            "wo": _f32(np.asarray(sd[f"{p}.self_attn.o_proj.weight"]).T),
            "w_gate_up": _f32(np.concatenate(
                [np.asarray(sd[f"{p}.mlp.gate_proj.weight"]) * post_norm,
                 np.asarray(sd[f"{p}.mlp.up_proj.weight"]) * post_norm], axis=0).T),
            "w_down": _f32(np.asarray(sd[f"{p}.mlp.down_proj.weight"]).T),
        }
        if f"{p}.self_attn.q_proj.bias" in sd:
            layer["bqkv"] = _f32(np.concatenate([sd[f"{p}.self_attn.q_proj.bias"],
                                                 sd[f"{p}.self_attn.k_proj.bias"],
                                                 sd[f"{p}.self_attn.v_proj.bias"]]))
        layers.append(layer)
    return {"layers": layers}


def qwen_config_from_json(model_dir: str) -> QwenTTSConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        c = json.load(f)
    tk = c.get("talker_config", c)
    pk = tk.get("code_predictor_config", {})

    def stack(cc, default_layers, max_seq):
        return Qwen3StackConfig(
            hidden_size=cc.get("hidden_size", 1024),
            num_heads=cc.get("num_attention_heads", 16),
            num_kv_heads=cc.get("num_key_value_heads", 8),
            head_dim=cc.get("head_dim", cc.get("hidden_size", 1024)
                            // cc.get("num_attention_heads", 16)),
            ffn_dim=cc.get("intermediate_size", 3072),
            num_layers=cc.get("num_hidden_layers", default_layers),
            rms_eps=cc.get("rms_norm_eps", 1e-6),
            rope_base=cc.get("rope_theta", 1000000.0),
            max_seq_len=max_seq,
        )

    return QwenTTSConfig(
        talker=stack(tk, 28, 2048),
        predictor=stack(pk, 4, 40),
        codec_vocab=tk.get("vocab_size", 3072),
        group_vocab=pk.get("vocab_size", 2048),
        num_code_groups=pk.get("num_code_groups", 16),
        codec_eos_token_id=tk.get("codec_eos_token_id", 2150),
        codec_bos_id=tk.get("codec_bos_id", 2149),
        codec_pad_id=tk.get("codec_pad_id", 2148),
        codec_think_id=tk.get("codec_think_id", 2154),
        codec_think_bos_id=tk.get("codec_think_bos_id", 2155),
        codec_think_eos_id=tk.get("codec_think_eos_id", 2156),
        tts_bos_token_id=c.get("tts_bos_token_id", 151672),
        tts_eos_token_id=c.get("tts_eos_token_id", 151673),
        tts_pad_token_id=c.get("tts_pad_token_id", 151671),
        text_vocab=c.get("text_vocab_size", 151936),
        text_hidden=c.get("text_hidden_size", 2048),
    )


def load_qwen_tts(model_dir: str, cfg: QwenTTSConfig | None = None,
                  dtype: torch.dtype = torch.float32, device="cuda"):
    """(params on `device` in `dtype`, cfg) for runtime/qwen.QwenTTSPipeline
    (talker and predictor; the codec decoder loads separately)."""
    sd = host_state_dict(load_hf_state_dict(model_dir))
    cfg = cfg or qwen_config_from_json(model_dir)
    t, p = cfg.talker, cfg.predictor
    tp = "talker.model"
    pp = "talker.code_predictor.model"
    talker_norm = np.asarray(sd[f"{tp}.norm.weight"])[None, :]
    pred_norm = np.asarray(sd[f"{pp}.norm.weight"])[None, :]
    lm_heads = np.stack([
        np.asarray(sd[f"talker.code_predictor.lm_head.{g}.weight"]) * pred_norm
        for g in range(cfg.num_code_groups - 1)]).transpose(0, 2, 1)      # (15, H, V)
    group_embeds = np.stack([np.asarray(sd[f"{pp}.codec_embedding.{g}.weight"])
                             for g in range(cfg.num_code_groups - 1)])    # (15, V, tH)
    rope_cos, rope_sin = rope_table(t.max_seq_len, t.head_dim, t.rope_base)
    p_cos, p_sin = rope_table(p.max_seq_len, p.head_dim, p.rope_base)
    text_proj_b = sd.get("talker.text_projection.bias", np.zeros(t.hidden_size))
    params = {
        "talker": qwen3_stack_from_state_dict(sd, tp, t),
        "codec_head": _f32((np.asarray(sd["talker.codec_head.weight"]) * talker_norm).T),
        "suppress_bias": _f32(make_suppress_bias(cfg.codec_vocab, cfg.codec_eos_token_id)),
        "talker_codec_embed": _f32(sd[f"{tp}.codec_embedding.weight"]),
        "text_embed": _f32(sd[f"{tp}.text_embedding.weight"]),
        "text_proj_w": _f32(np.asarray(sd["talker.text_projection.weight"]).T),
        "text_proj_b": _f32(text_proj_b),
        "rope_cos": _f32(rope_cos),
        "rope_sin": _f32(rope_sin),
        "predictor": qwen3_stack_from_state_dict(sd, pp, p),
        "small_to_mtp": _f32(np.asarray(
            sd["talker.code_predictor.small_to_mtp_projection.weight"]).T),
        "lm_heads": _f32(lm_heads),
        "group_embeds": _f32(group_embeds),
        "pred_rope_cos": _f32(p_cos),
        "pred_rope_sin": _f32(p_sin),
    }
    return place(params, device, dtype), cfg


# ---------------------------------------------------------------------------
# Codec decoder (speech_tokenizer.model.decoder.* in the same HF checkpoint)

def _cdconv(sd, pre, transposed=False):
    """CausalConvNet / CausalTransConvNet `{pre}.conv` -> (k, in, out); a
    missing bias is zeros."""
    w = np.asarray(sd[f"{pre}.conv.weight"])
    w = np.transpose(w, (2, 0, 1) if transposed else (2, 1, 0))
    p = {"w": _f32(w)}
    if f"{pre}.conv.bias" in sd:
        p["b"] = _f32(sd[f"{pre}.conv.bias"])
    else:
        p["b"] = np.zeros((w.shape[-1 if not transposed else 1],), np.float32)
    return p


def _snake_beta(sd, pre):
    """SnakeBeta stores log-scale alpha/beta: exp(alpha) and
    1 / (exp(beta) + 1e-9), in float64."""
    alpha = np.asarray(sd[f"{pre}.alpha"]).astype(np.float64)
    beta = np.asarray(sd[f"{pre}.beta"]).astype(np.float64)
    return {"alpha": _f32(np.exp(alpha)), "beta_recip": _f32(1.0 / (np.exp(beta) + 1e-9))}


def _codebook(sd, pre) -> np.ndarray:
    """EuclideanCodebook: embedding = embedding_sum / clamp(cluster_usage)."""
    s = np.asarray(sd[f"{pre}.embedding_sum"], np.float64)
    u = np.asarray(sd[f"{pre}.cluster_usage"], np.float64)
    return s / np.clip(u, 1e-5, None)[:, None]


def qwen_codec_from_state_dict(sd: Mapping[str, np.ndarray], cfg: QwenCodecDecoderConfig,
                               prefix: str = "speech_tokenizer.model.decoder") -> dict:
    """The Qwen3-TTS tokenizer-v2 decoder -> the host tree of
    models/qwen_codec.py, with the export's folds: QKV fused with d^-0.25,
    the input/post RMSNorm weights into qkv / gate_up, the per-layer scales
    into wo / w_down, the final norm into output_proj, the ConvNeXt
    LayerNorm affine into pw1 and gamma into pw2; SnakeBeta exp/recip; the
    RVQ codebooks normalized by cluster usage."""
    sd = CheckpointDict.wrap(sd, "qwen-codec")
    d = prefix
    scale = cfg.head_dim ** -0.25

    layers = []
    for i in range(cfg.num_layers):
        p = f"{d}.pre_transformer.layers.{i}"
        in_norm = np.asarray(sd[f"{p}.input_layernorm.weight"])[None, :]
        post_norm = np.asarray(sd[f"{p}.post_attention_layernorm.weight"])[None, :]
        attn_scale = np.asarray(sd[f"{p}.self_attn_layer_scale.scale"])[:, None]
        mlp_scale = np.asarray(sd[f"{p}.mlp_layer_scale.scale"])[:, None]
        wq = np.asarray(sd[f"{p}.self_attn.q_proj.weight"]) * in_norm * scale
        wk = np.asarray(sd[f"{p}.self_attn.k_proj.weight"]) * in_norm * scale
        wv = np.asarray(sd[f"{p}.self_attn.v_proj.weight"]) * in_norm
        layer = {
            "wqkv": _f32(np.concatenate([wq, wk, wv], axis=0).T),
            "wo": _f32((np.asarray(sd[f"{p}.self_attn.o_proj.weight"]) * attn_scale).T),
            "w_gate_up": _f32(np.concatenate(
                [np.asarray(sd[f"{p}.mlp.gate_proj.weight"]) * post_norm,
                 np.asarray(sd[f"{p}.mlp.up_proj.weight"]) * post_norm], axis=0).T),
            "w_down": _f32((np.asarray(sd[f"{p}.mlp.down_proj.weight"]) * mlp_scale).T),
        }
        if f"{p}.self_attn.q_proj.bias" in sd:
            layer["bqkv"] = _f32(np.concatenate(
                [np.asarray(sd[f"{p}.self_attn.q_proj.bias"]) * scale,
                 np.asarray(sd[f"{p}.self_attn.k_proj.bias"]) * scale,
                 np.asarray(sd[f"{p}.self_attn.v_proj.bias"])]))
        layers.append(layer)

    final_norm = np.asarray(sd[f"{d}.pre_transformer.norm.weight"])[None, :]
    out_proj_w = np.asarray(sd[f"{d}.pre_transformer.output_proj.weight"]) * final_norm
    ac_codebooks = np.stack([_codebook(sd, f"{d}.quantizer.rvq_rest.vq.layers.{g}._codebook")
                             for g in range(cfg.num_quantizers - 1)])

    def upsample_block(i):
        up = _cdconv(sd, f"{d}.upsample.{i}.0", transposed=True)
        c = f"{d}.upsample.{i}.1"
        nw = np.asarray(sd[f"{c}.norm.weight"])[None, :]
        nb = np.asarray(sd[f"{c}.norm.bias"])
        gamma = np.asarray(sd[f"{c}.gamma"])[:, None]
        pw1_w = np.asarray(sd[f"{c}.pwconv1.weight"])
        pw1_b = np.asarray(sd[f"{c}.pwconv1.bias"]) + pw1_w @ nb
        pw1_w = pw1_w * nw
        pw2_w = np.asarray(sd[f"{c}.pwconv2.weight"]) * gamma
        pw2_b = np.asarray(sd[f"{c}.pwconv2.bias"]) * gamma[:, 0]
        return {"conv": up, "convnext": {
            "dwconv": _cdconv(sd, f"{c}.dwconv"),
            "pw1": {"w": _f32(pw1_w.T), "b": _f32(pw1_b)},
            "pw2": {"w": _f32(pw2_w.T), "b": _f32(pw2_b)},
        }}

    n_rates = len(cfg.upsample_rates)

    def dec_block(i):
        b = f"{d}.decoder.{i + 1}.block"
        return {"act": _snake_beta(sd, f"{b}.0"),
                "up": _cdconv(sd, f"{b}.1", transposed=True),
                "units": [{"act1": _snake_beta(sd, f"{b}.{2 + j}.act1"),
                           "conv1": _cdconv(sd, f"{b}.{2 + j}.conv1"),
                           "act2": _snake_beta(sd, f"{b}.{2 + j}.act2"),
                           "conv2": _cdconv(sd, f"{b}.{2 + j}.conv2")}
                          for j in range(3)]}

    rope_cos, rope_sin = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_base)
    sem_out = np.asarray(sd[f"{d}.quantizer.rvq_first.output_proj.weight"])[:, :, 0]
    ac_out = np.asarray(sd[f"{d}.quantizer.rvq_rest.output_proj.weight"])[:, :, 0]
    return {
        "sem_codebook": _f32(_codebook(sd, f"{d}.quantizer.rvq_first.vq.layers.0._codebook")),
        "sem_out_proj": _f32(sem_out.T),
        "ac_codebooks": _f32(ac_codebooks),
        "ac_out_proj": _f32(ac_out.T),
        "pre_conv": _cdconv(sd, f"{d}.pre_conv"),
        "input_proj": {"w": _f32(np.asarray(sd[f"{d}.pre_transformer.input_proj.weight"]).T),
                       "b": _f32(sd[f"{d}.pre_transformer.input_proj.bias"])},
        "layers": layers,
        "output_proj": {"w": _f32(out_proj_w.T),
                        "b": _f32(sd[f"{d}.pre_transformer.output_proj.bias"])},
        "rope_cos": _f32(rope_cos),
        "rope_sin": _f32(rope_sin),
        "upsample": [upsample_block(i) for i in range(len(cfg.upsampling_ratios))],
        "dec_pre": _cdconv(sd, f"{d}.decoder.0"),
        "dec_blocks": [dec_block(i) for i in range(n_rates)],
        "dec_post_act": _snake_beta(sd, f"{d}.decoder.{n_rates + 1}"),
        "dec_post": _cdconv(sd, f"{d}.decoder.{n_rates + 2}"),
    }


def load_qwen_codec(model_dir: str, cfg: QwenCodecDecoderConfig | None = None,
                    dtype: torch.dtype = torch.float32, device="cuda"):
    """The codec decoder from the same HF directory as load_qwen_tts ->
    (params on `device` in `dtype`, cfg)."""
    sd = host_state_dict(load_hf_state_dict(model_dir))
    cfg = cfg or QwenCodecDecoderConfig()
    return place(qwen_codec_from_state_dict(sd, cfg), device, dtype), cfg


# ---------------------------------------------------------------------------
# Mimi prompt encoder (speech_tokenizer.model.encoder.*: the voice-clone path)

def _mimi_conv(sd, pre, bias=True) -> dict:
    """MimiConv1d `{pre}.conv`, its weight norm (either spelling) collapsed
    in float64, -> (k, in, out), and its bias (zeros where it has none)."""
    for gk, vk in ((f"{pre}.conv.weight_g", f"{pre}.conv.weight_v"),
                   (f"{pre}.conv.parametrizations.weight.original0",
                    f"{pre}.conv.parametrizations.weight.original1")):
        if gk in sd:
            g, v = np.asarray(sd[gk], np.float64), np.asarray(sd[vk], np.float64)
            w = g * v / np.linalg.norm(v.reshape(v.shape[0], -1), axis=1).reshape(-1, 1, 1)
            break
    else:
        w = np.asarray(sd[f"{pre}.conv.weight"])
    p = {"w": _f32(np.transpose(w, (2, 1, 0)))}
    if bias and f"{pre}.conv.bias" in sd:
        p["b"] = _f32(sd[f"{pre}.conv.bias"])
    else:
        p["b"] = np.zeros((w.shape[0],), np.float32)
    return p


def _mimi_codebook(sd, pre) -> np.ndarray:
    """MimiEuclideanCodebook: embed = embed_sum / clip(cluster_usage, 1e-5),
    in float64."""
    s = np.asarray(sd[f"{pre}.embed_sum"], np.float64)
    u = np.asarray(sd[f"{pre}.cluster_usage"], np.float64)
    return s / np.clip(u, 1e-5, None)[:, None]


def mimi_encoder_from_state_dict(sd: Mapping[str, np.ndarray], cfg,
                                 prefix: str = "speech_tokenizer.model.encoder") -> dict:
    """The HF Mimi encoder (SEANet convs, transformer, downsample, split
    RVQ) -> the host tree of models/qwen_encoder.py: the transformer's
    LayerNorm affines folded into qkv / fc1 and its layer scales into wo /
    fc2, q and k carrying head_dim^-0.25."""
    sd = CheckpointDict.wrap(sd, "qwen-encoder")
    e = f"{prefix}.encoder"
    scale = cfg.head_dim ** -0.25

    # SEANet layer indices follow the upstream constructor: ELUs hold slots
    idx = 0
    pre_conv = _mimi_conv(sd, f"{e}.layers.{idx}")
    idx += 1
    blocks = []
    for _ in reversed(cfg.upsampling_ratios):
        res = []
        for _ in range(cfg.num_residual_layers):
            res.append({"c1": _mimi_conv(sd, f"{e}.layers.{idx}.block.1"),
                        "c2": _mimi_conv(sd, f"{e}.layers.{idx}.block.3")})
            idx += 1
        idx += 1                                   # the ELU
        blocks.append({"res": res, "down": _mimi_conv(sd, f"{e}.layers.{idx}")})
        idx += 1
    idx += 1                                       # the final ELU
    post_conv = _mimi_conv(sd, f"{e}.layers.{idx}")

    t = f"{prefix}.encoder_transformer"
    layers = []
    for i in range(cfg.num_layers):
        p = f"{t}.layers.{i}"
        ln_w = np.asarray(sd[f"{p}.input_layernorm.weight"])[None, :]
        ln_b = np.asarray(sd[f"{p}.input_layernorm.bias"])
        pn_w = np.asarray(sd[f"{p}.post_attention_layernorm.weight"])[None, :]
        pn_b = np.asarray(sd[f"{p}.post_attention_layernorm.bias"])
        a_sc = np.asarray(sd[f"{p}.self_attn_layer_scale.scale"])[:, None]
        m_sc = np.asarray(sd[f"{p}.mlp_layer_scale.scale"])[:, None]
        wq = np.asarray(sd[f"{p}.self_attn.q_proj.weight"])
        wk = np.asarray(sd[f"{p}.self_attn.k_proj.weight"])
        wv = np.asarray(sd[f"{p}.self_attn.v_proj.weight"])
        fc1 = np.asarray(sd[f"{p}.mlp.fc1.weight"])
        # W (x_hat * ln_w + ln_b) = (W * ln_w) x_hat + W @ ln_b
        qkv_w = np.concatenate([wq * ln_w * scale, wk * ln_w * scale, wv * ln_w], axis=0)
        qkv_b = np.concatenate([wq @ ln_b * scale, wk @ ln_b * scale, wv @ ln_b])
        layers.append({
            "wqkv": _f32(qkv_w.T),
            "bqkv": _f32(qkv_b),
            "wo": _f32((np.asarray(sd[f"{p}.self_attn.o_proj.weight"]) * a_sc).T),
            "bo": np.zeros((cfg.hidden_size,), np.float32),
            "fc1": {"w": _f32((fc1 * pn_w).T), "b": _f32(fc1 @ pn_b)},
            "fc2": {"w": _f32((np.asarray(sd[f"{p}.mlp.fc2.weight"]) * m_sc).T),
                    "b": np.zeros((cfg.hidden_size,), np.float32)},
        })

    q = f"{prefix}.quantizer"
    sem = f"{q}.semantic_residual_vector_quantizer"
    ac = f"{q}.acoustic_residual_vector_quantizer"
    rope_cos, rope_sin = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_base)
    return {
        "pre": pre_conv,
        "blocks": blocks,
        "post": post_conv,
        "layers": layers,
        "rope_cos": _f32(rope_cos),
        "rope_sin": _f32(rope_sin),
        "downsample": _mimi_conv(sd, f"{prefix}.downsample"),
        "sem_in_proj": _f32(np.asarray(sd[f"{sem}.input_proj.weight"])[:, :, 0].T),
        "sem_codebook": _f32(_mimi_codebook(sd, f"{sem}.layers.0.codebook")),
        "ac_in_proj": _f32(np.asarray(sd[f"{ac}.input_proj.weight"])[:, :, 0].T),
        "ac_codebooks": _f32(np.stack([_mimi_codebook(sd, f"{ac}.layers.{g}.codebook")
                                       for g in range(cfg.num_quantizers - 1)])),
    }


def load_qwen_encoder(model_dir: str, cfg=None, dtype: torch.dtype = torch.float32,
                      device="cuda"):
    """The Mimi prompt encoder from the same HF directory as load_qwen_tts ->
    (params on `device` in `dtype`, the RoPE tables fp32; cfg)."""
    from ..models.qwen_encoder import MimiEncoderConfig

    sd = host_state_dict(load_hf_state_dict(model_dir))
    cfg = cfg or MimiEncoderConfig()
    return place(mimi_encoder_from_state_dict(sd, cfg), device, dtype), cfg


# ---------------------------------------------------------------------------
# Speaker encoder (speaker_encoder.*: the ECAPA of models/indextts, Qwen variant)

def qwen_speaker_from_state_dict(sd: Mapping[str, np.ndarray], prefix: str = "speaker_encoder",
                                 res2net_scale: int = 8, n_se_blocks: int = 3) -> dict:
    """Qwen3TTSSpeakerEncoder weights -> the host tree of
    models/indextts.ecapa_speaker_encoder, Qwen variant (place it with
    `place(tree, kind="ecapa")`).

    The Qwen encoder is the BatchNorm-free, reflect-padded ECAPA (its
    TimeDelayNetBlock is Conv1d + ReLU only), so the tree has no "bn" or
    "asp_bn" entries; the forward tells the variant by that (call it with
    reflect_pad=True, std_clip=None)."""
    sd = CheckpointDict.wrap(sd, "qwen-speaker")

    def cw(key):
        return np.transpose(np.asarray(sd[key]), (2, 1, 0))

    def tdnn(pre):
        return {"conv": {"w": _f32(cw(f"{pre}.conv.weight")), "b": _f32(sd[f"{pre}.conv.bias"])}}

    se_blocks = []
    for i in range(1, 1 + n_se_blocks):
        pre = f"{prefix}.blocks.{i}"
        se_blocks.append({
            "tdnn1": tdnn(f"{pre}.tdnn1"),
            "res2net": {"blocks": [tdnn(f"{pre}.res2net_block.blocks.{j}")
                                   for j in range(res2net_scale - 1)]},
            "tdnn2": tdnn(f"{pre}.tdnn2"),
            "se": {"w1": _f32(cw(f"{pre}.se_block.conv1.weight")[0]),
                   "b1": _f32(sd[f"{pre}.se_block.conv1.bias"]),
                   "w2": _f32(cw(f"{pre}.se_block.conv2.weight")[0]),
                   "b2": _f32(sd[f"{pre}.se_block.conv2.bias"])},
        })
    return {
        "block0": tdnn(f"{prefix}.blocks.0"),
        "se_blocks": se_blocks,
        "mfa": tdnn(f"{prefix}.mfa"),
        "asp_tdnn": tdnn(f"{prefix}.asp.tdnn"),
        "asp_conv": {"w": _f32(cw(f"{prefix}.asp.conv.weight")[0]),
                     "b": _f32(sd[f"{prefix}.asp.conv.bias"])},
        "fc": {"w": _f32(cw(f"{prefix}.fc.weight")[0]), "b": _f32(sd[f"{prefix}.fc.bias"])},
    }
