"""A module that owns a parameter tree (nested dicts and lists of tensors)."""
from __future__ import annotations

from torch import nn

__all__ = ["ParamTree", "tree_map"]


def tree_map(fn, tree, path=()):
    """Apply fn(path, leaf) to every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


class ParamTree(nn.Module):
    """Holds every leaf of a parameter tree as a buffer, so `.to(device,
    dtype)` moves and casts the whole tree; `params` is the nested-dict view
    (same keys and layouts as tts_tpu's pytree) that the model functions
    take. Top-level keys listed in `keep_fp32` keep their dtype under a cast
    and only follow the device."""

    keep_fp32: tuple[str, ...] = ()

    def __init__(self, params: dict):
        super().__init__()

        def register(path, t):
            name = "__".join(path)
            self.register_buffer(name, t)
            return name

        self._skeleton = tree_map(register, params)

    @property
    def params(self) -> dict:
        return tree_map(lambda _, name: self._buffers[name], self._skeleton)

    def _apply(self, fn, recurse=True):
        kept = {k: self._buffers.pop(k) for k in self.keep_fp32 if k in self._buffers}
        super()._apply(fn, recurse)
        device = next(iter(self._buffers.values())).device
        for k, t in kept.items():
            self._buffers[k] = t.to(device)
        return self
