"""Save/load fused parameter trees (counterpart of tts_tpu/weights/save.py).

After a loader has folded a checkpoint (and a pipeline perhaps quantized
it), the tree persists to one .npz so later runs skip the checkpoint parsing
and the fold math. The layout is tts_tpu's, so a bundle saved by either
package loads in the other: leaf paths joined by "/", a `||kind` suffix
(`arr`, `bf16` as raw uint16 bits, `none`, `listlen`), and quantized leaves
as their fields: `q8.q`/`q8.scale` (QTensor), `q4.*` (packed QTensor4) and
`q4r.*` (QTensorG, re-packed to nibbles; it loads back unpacked).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..quant.weight_only import QTensor, QTensor4, QTensorG

__all__ = ["save_params", "load_params", "config_to_dict", "config_from_dict"]

_SEP = "||"


def _host(t) -> np.ndarray:
    """A leaf as a host array (a bf16 tensor as its uint16 bits)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(t)


def _flatten(node, prefix, out):
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(node, (list, tuple)):
        out[f"{prefix}{_SEP}listlen"] = np.asarray(len(node))
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}/{i}", out)
    elif isinstance(node, QTensor):
        out[f"{prefix}{_SEP}q8.q"] = _host(node.q)
        out[f"{prefix}{_SEP}q8.scale"] = _host(node.scale)
    elif isinstance(node, QTensorG):
        # the runtime int4 form re-packs to nibbles (0.5 B a parameter)
        packed = node.pack()
        out[f"{prefix}{_SEP}q4r.q"] = _host(packed.q)
        out[f"{prefix}{_SEP}q4r.scale"] = _host(packed.scale)
        out[f"{prefix}{_SEP}q4r.group"] = np.asarray(packed.group_size)
    elif isinstance(node, QTensor4):
        out[f"{prefix}{_SEP}q4.q"] = _host(node.q)
        out[f"{prefix}{_SEP}q4.scale"] = _host(node.scale)
        out[f"{prefix}{_SEP}q4.group"] = np.asarray(node.group_size)
    elif node is None:
        out[f"{prefix}{_SEP}none"] = np.asarray(0)
    elif isinstance(node, torch.Tensor) and node.dtype == torch.bfloat16:
        out[f"{prefix}{_SEP}bf16"] = _host(node)
    else:
        out[f"{prefix}{_SEP}arr"] = _host(node)


def save_params(path: str, params) -> None:
    """Persist a parameter tree (dicts/lists of tensors or arrays and
    quantized leaves, on any device) to .npz."""
    flat: dict[str, np.ndarray] = {}
    _flatten(params, "", flat)
    np.savez(path, **flat)


def load_params(path: str, device="cuda"):
    """A tree saved by save_params (of either package) -> its tensors on
    `device`, bf16 leaves as bf16."""
    data = np.load(path)
    dev = torch.device(device)
    root: dict = {}
    q_accum: dict[str, dict] = {}

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, order="C")).to(dev)

    def set_path(container, parts, value):
        for p in parts[:-1]:
            key = int(p) if p.isdigit() else p
            if isinstance(container, dict):
                container = container.setdefault(key, {})
            else:
                container = container[key]
        last = parts[-1]
        container[int(last) if last.isdigit() else last] = value

    listlens: dict[tuple, int] = {}
    for name in data.files:
        prefix, kind = name.rsplit(_SEP, 1)
        parts = [p for p in prefix.split("/") if p != ""]
        if kind == "listlen":
            listlens[tuple(parts)] = int(data[name])
        elif kind == "arr":
            set_path(root, parts, put(data[name]))
        elif kind == "bf16":
            set_path(root, parts, put(data[name].view(np.int16)).view(torch.bfloat16))
        elif kind == "none":
            set_path(root, parts, None)
        else:
            q_accum.setdefault(prefix, {})[kind] = data[name]

    for prefix, fields in q_accum.items():
        parts = [p for p in prefix.split("/") if p != ""]
        if "q8.q" in fields:
            val = QTensor(q=put(fields["q8.q"]), scale=put(fields["q8.scale"]))
        elif "q4r.q" in fields:
            val = QTensor4(q=put(fields["q4r.q"]), scale=put(fields["q4r.scale"]),
                           group_size=int(fields["q4r.group"])).unpack_runtime()
        else:
            val = QTensor4(q=put(fields["q4.q"]), scale=put(fields["q4.scale"]),
                           group_size=int(fields["q4.group"]))
        set_path(root, parts, val)

    def listify(node, path=()):
        if isinstance(node, dict):
            if path in listlens:
                return [listify(node[i], path + (str(i),)) for i in range(listlens[path])]
            return {k: listify(v, path + (str(k),)) for k, v in node.items()}
        return node

    return listify(root)


def config_to_dict(cfg) -> dict:
    """Frozen-dataclass config -> JSON-able dict (nested configs recurse)."""

    def conv(v):
        if dataclasses.is_dataclass(v):
            return {k: conv(w) for k, w in dataclasses.asdict(v).items()}
        if isinstance(v, tuple):
            return list(v)
        return v

    return {f.name: conv(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


def config_from_dict(cls, d: dict):
    """Rebuild a config dataclass from config_to_dict output. Nested config
    types are inferred from the class's default instances; lists restore to
    tuples (configs hold tuples, never lists)."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        default = f.default
        if default is dataclasses.MISSING and f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        if dataclasses.is_dataclass(default) and isinstance(v, dict):
            v = config_from_dict(type(default), v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)
