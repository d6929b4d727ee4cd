"""Convert tts_tpu parameter pytrees to the port's tensors.

`params_from_jax` takes tts_tpu's F5 or Vocos tree as nested dicts and
lists of numpy arrays (`jax.tree.map(np.asarray, params)` on the JAX side)
and returns the same tree of torch tensors, key for key. Each tree is
checked against a schema of its keys and shapes: dimension names bind at
their first use and must agree wherever they recur, so an unknown or
missing key or an inconsistent shape raises.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


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

# keys that keep fp32 whatever dtype the weights take (tts_tpu's Euler steps)
_KEEP_FP32 = {"delta_t"}


def _convert(tree, schema, path, dims, device, dtype):
    where = "/".join(path) or "<root>"
    if isinstance(schema, dict):
        if not isinstance(tree, dict):
            raise TypeError(f"{where}: expected a dict, got {type(tree).__name__}")
        unknown, missing = set(tree) - set(schema), set(schema) - set(tree)
        if unknown or missing:
            raise KeyError(f"{where}: unknown keys {sorted(unknown)}, "
                           f"missing keys {sorted(missing)}")
        return {k: _convert(tree[k], schema[k], path + (k,), dims, device, dtype)
                for k in schema}
    if isinstance(schema, list):
        if not isinstance(tree, (list, tuple)):
            raise TypeError(f"{where}: expected a list, got {type(tree).__name__}")
        return [_convert(v, schema[0], path + (str(i),), dims, device, dtype)
                for i, v in enumerate(tree)]
    a = np.asarray(tree)
    if len(a.shape) != len(schema):
        raise ValueError(f"{where}: shape {a.shape} does not match {schema}")
    for size, want in zip(a.shape, schema):
        if isinstance(want, str):
            want = dims.setdefault(want, size)
        if size != want:
            raise ValueError(f"{where}: shape {a.shape} does not match {schema} "
                             f"with {dims}")
    if a.dtype.name == "bfloat16":          # ml_dtypes' bf16 has no torch view
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a))
    if t.is_floating_point() and path[-1] not in _KEEP_FP32:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: dict, device, dtype: torch.dtype) -> dict:
    """tts_tpu F5 or Vocos params (nested dicts/lists of numpy arrays) ->
    the same tree of torch tensors on `device`, floats cast to `dtype`."""
    if not isinstance(tree, dict):
        raise TypeError(f"expected a params dict, got {type(tree).__name__}")
    schema = _F5 if "text_embed" in tree else _VOCOS
    return _convert(tree, schema, (), {}, torch.device(device), dtype)
