"""Per-device pipeline replication for serving on several cards
(counterpart of tts_tpu/serving/devices.py).

TTS requests are independent, so serving scales across cards as pure data
parallelism with no collectives: one pipeline (and one slot server) a
card, a host-side least-loaded router in front (serving/router.SlotRouter).
`replicate_pipeline` shallow-copies a constructed pipeline with every
attribute that holds tensors (params, codec or vocoder params, tables)
moved to the target device; configs and other host state are shared.
"""
from __future__ import annotations

import copy
import dataclasses

import torch

from ..models._params import ParamTree

__all__ = ["pipeline_device", "replicate_pipeline", "pipelines_for_devices"]


def _leaves(tree):
    """The tensors of a tree of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def _to(tree, device: torch.device):
    """The same tree with every tensor moved by `.to(device)`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _to(getattr(tree, f.name), device)
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def pipeline_device(pipe) -> torch.device:
    """The device holding `pipe`'s parameters (its first tensor leaf)."""
    for leaf in _leaves(getattr(pipe, "params", None)):
        return leaf.device
    raise ValueError("pipeline has no tensor params attribute")


def replicate_pipeline(pipe, device):
    """A shallow copy of `pipe` with every attribute that contains tensors
    moved to `device` (nested dicts, lists and quantized leaves included;
    a model module, as F5's `F5Model`, rebuilt over its moved tree), and
    its `device` attribute, where it has one, set to it. Other
    attributes (configs, caches of host values) are shared with the
    original."""
    device = torch.device(device)
    clone = copy.copy(pipe)
    for name, val in list(vars(clone).items()):
        if isinstance(val, torch.device):
            setattr(clone, name, device)
        elif isinstance(val, ParamTree):
            setattr(clone, name, type(val)(val.cfg, _to(val.params, device)))
        elif any(True for _ in _leaves(val)):
            setattr(clone, name, _to(val, device))
    return clone


def pipelines_for_devices(pipe, devices=None) -> list:
    """One pipeline a device, each a `replicate_pipeline` clone. With no
    list, every visible CUDA device; with none visible this raises (it
    never falls back to the CPU). Pass the result to
    `serving.families.continuous_server`, which builds one slot server a
    pipeline behind a least-loaded SlotRouter."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device is visible: pass devices= to serve "
                               "on others")
        devices = [torch.device("cuda", i) for i in range(n)]
    return [replicate_pipeline(pipe, d) for d in devices]
