"""Convert tts_tpu parameter pytrees to the port's tensors.

`params_from_jax` takes tts_tpu's F5, Vocos, Kani LM, NanoCodec, Qwen3-TTS
(the merged talker + predictor tree), Qwen codec decoder, BigVGAN (either
resblock kind), IndexTTS (conformer, perceiver, ECAPA, GPT, speaker-
conditioned BigVGAN), VoxCPM (the dual LM, feature encoder and estimator)
or VoxCPM audio VAE (encoder and "dec" decoder) tree as
nested dicts and lists of numpy arrays (`jax.tree.map(np.asarray, params)`
on the JAX side) and returns the same tree of torch tensors, key for key;
the family is told by the tree's keys. Each tree is checked against a
schema of its keys and shapes: dimension names bind at their first use and
must agree wherever they recur (None matches any size), so an unknown or
missing key or an inconsistent shape raises. `_Opt` marks an optional key,
`_OneOf` a dict of one of several kinds (Kani's attention and conv layers,
BigVGAN's two resblock kinds).

tts_tpu's quantized leaves (objects with `.q` and `.scale` after the tree
map) become the port's, q int8 and scale fp32 whatever `dtype` is: an int8
QTensor (q (in, out), scale (out,)); a packed int4 QTensor4 (q (in/2, out),
scale (in/G, out), told by its `unpack_runtime`) or an unpacked QTensorG (q
(in, out), scale (in/G, out), told by its `pack`), each with its
`group_size` G. The schema checks the unpacked (in, out) shape.
"""
from __future__ import annotations

import numpy as np
import torch

from ..quant.weight_only import QTensor, QTensor4, QTensorG, _unpack_int4_int8

__all__ = ["params_from_jax"]


class _Opt:
    """A dict entry that may be absent."""

    def __init__(self, schema):
        self.schema = schema


class _OneOf:
    """A dict that matches one of several dict schemas: the one whose
    required keys it has and whose keys it does not exceed."""

    def __init__(self, *schemas: dict):
        self.schemas = schemas

    def pick(self, tree: dict, where: str) -> dict:
        for sch in self.schemas:
            required = {k for k, v in sch.items() if not isinstance(v, _Opt)}
            if required <= set(tree) <= set(sch):
                return sch
        raise KeyError(f"{where}: keys {sorted(tree)} fit none of the layer kinds")


def _ln(dim: str) -> dict:
    return {"w": (dim,), "b": (dim,)}


def _lin(cin: str, cout: str) -> dict:
    return {"w": (cin, cout), "b": (cout,)}


_F5 = {
    "text_embed": {
        "embed": ("vocab1", "td"),
        "blocks": [{
            "dwconv": {"w": ("kt", 1, "td"), "b": ("td",)},
            "norm": _ln("td"),
            "pw1": _lin("td", "tm"),
            "grn": {"gamma": (1, 1, "tm"), "beta": (1, 1, "tm")},
            "pw2": _lin("tm", "td"),
        }],
    },
    "text_freqs_cis": ("max_len", "td"),
    "input_embed": {
        "proj": _lin("proj_in", "d"),
        "conv1": {"w": ("kc", "cpg", "d"), "b": ("d",)},
        "conv2": {"w": ("kc", "cpg", "d"), "b": ("d",)},
    },
    "blocks": [{
        "ada": _lin("d", "d6"),
        "attn": {"wqkv": ("d", "qkv"), "bqkv": ("qkv",), "wo": ("inner", "d"),
                 "bo": ("d",)},
        "ff1": _lin("d", "ff"),
        "ff2": _lin("ff", "d"),
    }],
    "norm_out": _lin("d", "d2"),
    "proj_out": _lin("d", "n_mels"),
    "rope_cos": ("max_len", "head_dim"),
    "rope_sin": ("max_len", "head_dim"),
    "time_table": ("nfe", "d"),
    "delta_t": ("nfe_1",),
    "ada_table": ("nfe", "depth", "d6"),
    "norm_out_table": ("nfe", "d2"),
}

_VOCOS = {
    "embed": {"w": ("ke", "n_mels", "dim"), "b": ("dim",)},
    "norm": _ln("dim"),
    "blocks": [{
        "dwconv": {"w": ("kd", 1, "dim"), "b": ("dim",)},
        "norm": _ln("dim"),
        "pw1": _lin("dim", "inter"),
        "pw2": _lin("inter", "dim"),
    }],
    "final_norm": _ln("dim"),
    "head": _lin("dim", "n_head"),
}

_KANI_FFN = {"w_gate_up": ("hs", "ff2"), "w_down": ("ff", "hs")}
_KANI = {
    "embed": ("vocab", "hs"),
    "layers": [_OneOf(
        {"ffn": _KANI_FFN, "wqkv": ("hs", "qkv"), "q_norm": ("hd",),
         "k_norm": ("hd",), "wo": ("q_sz", "hs")},
        {"ffn": _KANI_FFN, "in_proj": ("hs", "hs3"), "conv_w": ("kc", 1, "hs"),
         "conv_b": _Opt(("hs",)), "out_proj": ("hs", "hs")},
    )],
    "lm_head": ("hs", "vocab"),
    "rope_cos": ("max_len", "hd"),
    "rope_sin": ("max_len", "hd"),
}

# channel counts halve stage by stage, so the codec's dims stay unbound
_CODEC_CONV = {"w": (None, None, None), "b": _Opt((None,))}
_CODEC_ACT = {"alpha": (None,), "alpha_recip": _Opt((None,))}
_NANOCODEC = {
    "pre_conv": _CODEC_CONV,
    "stage_acts": [_CODEC_ACT],
    "ups": [_CODEC_CONV],
    "res_layers": [[{"acts1": [_CODEC_ACT], "convs1": [_CODEC_CONV],
                     "acts2": [_CODEC_ACT], "convs2": [_CODEC_CONV]}]],
    "post_act": _CODEC_ACT,
    "post_conv": _CODEC_CONV,
}


def _qwen_stack(p: str) -> dict:
    """A Qwen3 decoder stack; its dims bind under prefix p (the talker's and
    the predictor's widths may differ)."""
    return {"layers": [{
        "wqkv": (f"{p}hs", f"{p}qkv"), "bqkv": _Opt((f"{p}qkv",)),
        "q_norm": (f"{p}hd",), "k_norm": (f"{p}hd",), "wo": (f"{p}q_sz", f"{p}hs"),
        "w_gate_up": (f"{p}hs", f"{p}ff2"), "w_down": (f"{p}ff", f"{p}hs")}]}


_QWEN = {
    "talker": _qwen_stack("t_"),
    "codec_head": ("t_hs", "codec_vocab"),
    "suppress_bias": (1, "codec_vocab"),
    "talker_codec_embed": ("codec_vocab", "t_hs"),
    "text_embed": ("text_vocab", "text_hidden"),
    "text_proj_w": ("text_hidden", "t_hs"),
    "text_proj_b": ("t_hs",),
    "rope_cos": ("t_max_len", "t_hd"),
    "rope_sin": ("t_max_len", "t_hd"),
    "predictor": _qwen_stack("p_"),
    "small_to_mtp": ("t_hs", "p_hs"),
    "lm_heads": ("groups", "p_hs", "group_vocab"),
    "group_embeds": ("groups", "group_vocab", "t_hs"),
    "pred_rope_cos": ("p_max_len", "p_hd"),
    "pred_rope_sin": ("p_max_len", "p_hd"),
}

_QWEN_CONV = {"w": (None, None, None), "b": _Opt((None,))}
_QWEN_ACT = {"alpha": (None,), "beta_recip": (None,)}
_QWEN_CODEC = {
    "sem_codebook": ("bins", "rvq"),
    "sem_out_proj": ("rvq", "cb_dim"),
    "ac_codebooks": ("n_ac", "bins", "rvq"),
    "ac_out_proj": ("rvq", "cb_dim"),
    "pre_conv": _QWEN_CONV,
    "input_proj": _lin("latent", "hs"),
    "layers": [{"wqkv": ("hs", "qkv"), "bqkv": _Opt(("qkv",)), "wo": ("q_sz", "hs"),
                "w_gate_up": ("hs", "ff2"), "w_down": ("ff", "hs")}],
    "output_proj": _lin("hs", "latent"),
    "rope_cos": ("max_len", "hd"),
    "rope_sin": ("max_len", "hd"),
    "upsample": [{"conv": _QWEN_CONV,
                  "convnext": {"dwconv": _QWEN_CONV, "pw1": _lin("latent", "latent4"),
                               "pw2": _lin("latent4", "latent")}}],
    "dec_pre": _QWEN_CONV,
    "dec_blocks": [{"act": _QWEN_ACT, "up": _QWEN_CONV,
                    "units": [{"act1": _QWEN_ACT, "conv1": _QWEN_CONV,
                               "act2": _QWEN_ACT, "conv2": _QWEN_CONV}]}],
    "dec_post_act": _QWEN_ACT,
    "dec_post": _QWEN_CONV,
}

# stage widths halve stage by stage, so BigVGAN's dims stay unbound
_BV_CONV = {"w": (None, None, None), "b": _Opt((None,))}
_BV_ACT = {"alpha": (None,), "beta_recip": _Opt((None,)), "alpha_recip": _Opt((None,))}
_BIGVGAN = {
    "conv_pre": _BV_CONV,
    "ups": [_BV_CONV],
    "resblocks": [_OneOf(
        {"convs1": [_BV_CONV], "convs2": [_BV_CONV], "acts1": [_BV_ACT],
         "acts2": [_BV_ACT]},                                  # AMPBlock1
        {"convs": [_BV_CONV], "acts": [_BV_ACT]},              # AMPBlock2
    )],
    "act_post": _BV_ACT,
    "conv_post": _BV_CONV,
}

_ECAPA_TDNN = {"conv": {"w": (None, None, None), "b": (None,)},
               "bn": _Opt({"scale": (None,), "shift": (None,)})}
_INDEXTTS = {
    "gpt": {
        "text_embed": ("text_vocab", "d"),
        "text_pos": ("text_pos", "d"),
        "mel_embed": ("mel_vocab", "d"),
        "mel_pos": ("mel_pos", "d"),
        "layers": [{"ln1": _ln("d"), "wqkv": ("d", "qkv"), "bqkv": ("qkv",),
                    "wo": ("d", "d"), "bo": ("d",), "ln2": _ln("d"),
                    "fc": _lin("d", "ff"), "proj": _lin("ff", "d")}],
        "ln_f": _ln("d"),
        "final_norm": _ln("d"),
        "lm_head": ("d", "mel_vocab"),
        "lm_head_b": ("mel_vocab",),
    },
    "conformer": {
        "sub_convs": [{"w": ("e", None, 3, 3), "b": ("e",)}],
        "out": _lin("sub_out", "e"),
        "pos_enc": ("max_pos", "e"),
        "layers": [{
            "norm_mha": _ln("e"),
            "attn": {"wq": ("eh", "e", "ehd"), "bq": ("eh", 1, "ehd"),
                     "wk": ("eh", "e", "ehd"), "bk": ("eh", 1, "ehd"),
                     "wv": ("eh", "e", "ehd"), "bv": ("eh", 1, "ehd"),
                     "wpos": ("eh", "e", "ehd"), "bias_u": ("eh", 1, "ehd"),
                     "bias_v": ("eh", 1, "ehd"), "wo": ("eh", "ehd", "e"), "bo": ("e",)},
            "norm_conv": _ln("e"),
            "conv": {"pw1": _lin("e", "e2"), "dw": {"w": ("ek", 1, "e"), "b": ("e",)},
                     "norm": _ln("e"), "pw2": _lin("e", "e")},
            "norm_ff": _ln("e"),
            "ff1": _lin("e", "eff"),
            "ff2": _lin("eff", "e"),
            "norm_final": _ln("e"),
        }],
        "after_norm": _ln("e"),
    },
    "perceiver": {
        "proj_context": _lin("e", "d"),
        "latents": ("latents", "d"),
        "layers": [{"wq": ("ph", "d", "phd"), "wk": ("ph", "d", "phd"),
                    "wv": ("ph", "d", "phd"), "wo": ("ph", "phd", "d"),
                    "ff_norm": _ln("d"), "ff1": _lin("d", "pff"), "ff2": _lin("pff", "d")}],
        "norm": _ln("d"),
    },
    "ecapa": {
        "block0": _ECAPA_TDNN,
        "se_blocks": [{"tdnn1": _ECAPA_TDNN, "res2net": {"blocks": [_ECAPA_TDNN]},
                       "tdnn2": _ECAPA_TDNN,
                       "se": {"w1": ("ec", "se"), "b1": ("se",), "w2": ("se", "ec"),
                              "b2": ("ec",)}}],
        "mfa": _ECAPA_TDNN,
        "asp_tdnn": _ECAPA_TDNN,
        "asp_conv": _lin("asp", "mfa"),
        "asp_bn": _Opt({"scale": ("mfa2",), "shift": ("mfa2",)}),
        "fc": _lin("mfa2", "spk"),
    },
    "bigvgan": _BIGVGAN,
    "cond_layer": _lin("spk", "c0"),
    "conds": [{"w": ("spk", None), "b": (None,)}],
}


def _llama_stack(hs: str, p: str) -> dict:
    """A VoxCPM Llama stack of width hs; its other dims bind under prefix p."""
    return {"layers": [{
        "wqkv": (hs, f"{p}qkv"), "bqkv": _Opt((f"{p}qkv",)), "wo": (f"{p}q_sz", hs),
        "w_gate_up": (hs, f"{p}ff2"), "w_down": (f"{p}ff", hs)}]}


_VOXCPM = {
    "embed": ("vocab", "hs"),
    "base": _llama_stack("hs", "b_"),
    "base_norm": ("hs",),
    "residual": _llama_stack("hs", "r_"),
    "fsq_down": _lin("hs", "fsq"),
    "fsq_up": _lin("fsq", "hs"),
    "dit_stop": {"w": ("hs", "dit_stop"), "b": _Opt(("dit_stop",))},
    "res_to_dit": {"w": ("hs", "est_hs")},
    "stop_head": _lin("stop_in", "stop_out"),
    "fe": _llama_stack("fe_hs", "fe_"),
    "fe_in_proj": _lin("latent", "fe_hs"),
    "fe_special": (1, "fe_hs"),
    "enc_to_lm": {"w": ("fe_hs", "hs"), "b": _Opt(("hs",))},
    "cond_proj": _lin("latent", "est_hs"),
    "est": _llama_stack("est_hs", "est_"),
    "est_in_proj": _lin("latent", "est_hs"),
    "est_out_proj": {"w": ("est_hs", "latent"), "b": _Opt(("latent",))},
    "cfm_t_table": ("cfm_steps", "est_hs"),
    "cfm_dt": ("cfm_steps",),
    "rope_cos": ("max_len", "hd"),
    "rope_sin": ("max_len", "hd"),
    "fe_rope_cos": ("fe_max_len", "fe_hd"),
    "fe_rope_sin": ("fe_max_len", "fe_hd"),
    "est_rope_cos": ("est_max_len", "est_hd"),
    "est_rope_sin": ("est_max_len", "est_hd"),
}

# channel counts double (encoder) and halve (decoder) block by block, so
# the VAE's dims stay unbound but the latent width and the rate bins
_VAE_CONV = {"w": (None, None, None), "b": _Opt((None,))}
_VAE_SNAKE = {"alpha": (None,), "alpha_recip": (None,)}
_VAE_UNIT = {"s1": _VAE_SNAKE, "c1": _VAE_CONV, "s2": _VAE_SNAKE, "c2": _VAE_CONV}
_VOXCPM_VAE = {
    "pre": {"w": (None, 1, None), "b": _Opt((None,))},
    "enc_blocks": [{"units": [_VAE_UNIT], "snake": _VAE_SNAKE, "down": _VAE_CONV}],
    "fc_mu": {"w": (None, None, "latent"), "b": _Opt(("latent",))},
    "dec": {
        "pre_dw": _Opt({"w": (None, 1, "latent"), "b": _Opt(("latent",))}),
        "pre": {"w": (None, "latent", None), "b": _Opt((None,))},
        "dec_blocks": [{
            "snake": _VAE_SNAKE, "up": _VAE_CONV, "units": [_VAE_UNIT],
            "noise": _Opt({"w": (1, None, None)}),
            "sr_scale": _Opt(("sr_bins", None)), "sr_bias": _Opt(("sr_bins", None)),
            "sr_out_snake": _Opt(_VAE_SNAKE), "sr_out_conv": _Opt(_VAE_CONV)}],
        "post_snake": _VAE_SNAKE,
        "post": {"w": (None, None, 1), "b": _Opt((1,))},
    },
}

# keys that keep fp32 whatever dtype the weights take (tts_tpu's Euler steps)
_KEEP_FP32 = {"delta_t"}


def _leaf(a, schema, where: str, dims: dict) -> np.ndarray:
    a = np.asarray(a)
    if len(a.shape) != len(schema):
        raise ValueError(f"{where}: shape {a.shape} does not match {schema}")
    for size, want in zip(a.shape, schema):
        if isinstance(want, str):
            want = dims.setdefault(want, size)
        if want is not None and size != want:
            raise ValueError(f"{where}: shape {a.shape} does not match {schema} "
                             f"with {dims}")
    if a.dtype.name == "bfloat16":          # ml_dtypes' bf16 has no torch view
        a = a.astype(np.float32)
    return np.array(a)


def _convert(tree, schema, path, dims, device, dtype):
    where = "/".join(path) or "<root>"
    if isinstance(schema, _OneOf):
        if not isinstance(tree, dict):
            raise TypeError(f"{where}: expected a dict, got {type(tree).__name__}")
        schema = schema.pick(tree, where)
    if isinstance(schema, dict):
        if not isinstance(tree, dict):
            raise TypeError(f"{where}: expected a dict, got {type(tree).__name__}")
        required = {k for k, v in schema.items() if not isinstance(v, _Opt)}
        unknown, missing = set(tree) - set(schema), required - set(tree)
        if unknown or missing:
            raise KeyError(f"{where}: unknown keys {sorted(unknown)}, "
                           f"missing keys {sorted(missing)}")
        return {k: _convert(tree[k], getattr(schema[k], "schema", schema[k]),
                            path + (k,), dims, device, dtype)
                for k in schema if k in tree}
    if isinstance(schema, list):
        if not isinstance(tree, (list, tuple)):
            raise TypeError(f"{where}: expected a list, got {type(tree).__name__}")
        return [_convert(v, schema[0], path + (str(i),), dims, device, dtype)
                for i, v in enumerate(tree)]
    if hasattr(tree, "q") and hasattr(tree, "scale"):      # a tts_tpu quantized leaf
        return _quantized(tree, schema, where, dims, device)
    t = torch.from_numpy(_leaf(tree, schema, where, dims))
    if t.is_floating_point() and path[-1] not in _KEEP_FP32:
        t = t.to(dtype)
    return t.to(device)


def _quantized(tree, schema, where: str, dims: dict, device):
    q = np.asarray(tree.q)
    if q.dtype != np.int8:
        raise TypeError(f"{where}: quantized weights of {q.dtype} are not ported")
    qt = torch.from_numpy(np.array(q))
    group = getattr(tree, "group_size", None)
    if group is None:                                       # int8 QTensor
        _leaf(q, schema, where + "/q", dims)
        scale = _leaf(tree.scale, schema[-1:], where + "/scale", dims)
        return QTensor(q=qt.to(device), scale=torch.from_numpy(scale).float().to(device))
    packed = hasattr(tree, "unpack_runtime")                # QTensor4, else QTensorG
    if not packed and not hasattr(tree, "pack"):
        raise TypeError(f"{where}: a grouped {type(tree).__name__} is neither "
                        f"packed nor unpacked int4")
    full = _unpack_int4_int8(qt) if packed else qt
    _leaf(full.numpy(), schema, where + "/q", dims)
    scale = _leaf(tree.scale, (None,) + tuple(schema[-1:]), where + "/scale", dims)
    if scale.shape[0] * group != full.shape[0]:
        raise ValueError(f"{where}: scale {scale.shape} does not fit group {group} "
                         f"of q {tuple(full.shape)}")
    cls = QTensor4 if packed else QTensorG
    return cls(q=qt.to(device), scale=torch.from_numpy(scale).float().to(device),
               group_size=int(group))


def _schema_of(tree: dict) -> dict:
    for key, schema in (("fsq_down", _VOXCPM), ("enc_blocks", _VOXCPM_VAE),
                        ("gpt", _INDEXTTS), ("conv_pre", _BIGVGAN),
                        ("talker", _QWEN), ("sem_codebook", _QWEN_CODEC),
                        ("text_embed", _F5), ("lm_head", _KANI),
                        ("pre_conv", _NANOCODEC), ("head", _VOCOS)):
        if key in tree:
            return schema
    raise KeyError(f"keys {sorted(tree)} are none of F5, Vocos, Kani, NanoCodec, "
                   f"Qwen3-TTS, the Qwen codec, BigVGAN, IndexTTS, VoxCPM or its VAE")


def params_from_jax(tree: dict, device, dtype: torch.dtype) -> dict:
    """tts_tpu F5, Vocos, Kani, NanoCodec, Qwen3-TTS, Qwen codec, BigVGAN,
    IndexTTS, VoxCPM or VoxCPM VAE params (nested dicts/lists of numpy
    arrays) -> the same tree of torch tensors on `device`, floats cast to
    `dtype`."""
    if not isinstance(tree, dict):
        raise TypeError(f"expected a params dict, got {type(tree).__name__}")
    return _convert(tree, _schema_of(tree), (), {}, torch.device(device), dtype)
