"""Static-shape KV cache (counterpart of tts_tpu/kv/cache.py).

Buffers of (num_layers, batch, kv_heads, max_len, head_dim) are allocated
once; `length` is the number of valid positions. `update_layer` writes the
new rows into the buffers in place, and the k/v it returns for attention are
views of them, not copies: rebuilding the stacked buffer every layer is the
copy that cost tts_tpu 3.5 ms a decode step.

`length` is a host int, or a 0-dim int32 tensor on the buffers' device
(tts_tpu's form, which a CUDA graph replays without a host read: the Kani
decode programs, runtime/kani.py). In the device form the append writes at
the device index (`index_copy_`), and `bound`, a host int, is the static
number of rows a step may reach (its attention reads rows [0, bound) under
a mask, the beam reorder moves them); None means max_len.

`advance`, `rewind`, `repeat_batch` and `select_batch` return a new
KVCache, as tts_tpu's do. `advance` and `rewind` share the buffers with the
old object, so an older KVCache sees later writes: the decode loops keep
only the newest.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["KVCache"]


@dataclasses.dataclass
class KVCache:
    """k, v: (num_layers, batch, kv_heads, max_len, head_dim); length: int,
    or a 0-dim int32 device tensor; bound: see the module's docstring."""

    k: torch.Tensor
    v: torch.Tensor
    length: int | torch.Tensor = 0
    bound: int | None = None

    @classmethod
    def create(cls, num_layers: int, batch: int, kv_heads: int, max_len: int,
               head_dim: int, dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (num_layers, batch, kv_heads, max_len, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0)

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def on_device(self) -> bool:
        """Whether `length` lives on the device."""
        return isinstance(self.length, torch.Tensor)

    @property
    def rows(self) -> int:
        """The rows a step's attention reads in the device form."""
        return self.max_len if self.bound is None else self.bound

    def update_layer(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor):
        """Write (B, S, KVH, D) keys/values at rows [length, length + S) of
        one layer, in place. Returns (self, k_full, v_full), the full
        (B, KVH, max_len, D) views of that layer. Does not advance length.
        In the device form the caller keeps length + S <= max_len."""
        pos, s = self.length, k_new.shape[1]
        if self.on_device:
            idx = pos.long() + torch.arange(s, device=pos.device)
            self.k[layer].index_copy_(2, idx, k_new.transpose(1, 2).to(self.k.dtype))
            self.v[layer].index_copy_(2, idx, v_new.transpose(1, 2).to(self.v.dtype))
            return self, self.k[layer], self.v[layer]
        if pos + s > self.max_len:
            raise ValueError(f"cache of {self.max_len} rows cannot take rows "
                             f"[{pos}, {pos + s})")
        self.k[layer, :, :, pos:pos + s] = k_new.transpose(1, 2)
        self.v[layer, :, :, pos:pos + s] = v_new.transpose(1, 2)
        return self, self.k[layer], self.v[layer]

    def advance(self, num_tokens: int) -> "KVCache":
        return dataclasses.replace(self, length=self.length + int(num_tokens))

    def rewind(self, length) -> "KVCache":
        """Set length to a value <= the current one: after a prefill over a
        padded bucket, decode appends at the true prompt length and
        overwrites the padded rows, which the causal mask never exposes.
        In the device form `length` may be a 0-dim device tensor: it is
        written into the cache's length tensor in place (a graph replays
        the write), and the new KVCache shares that tensor."""
        if self.on_device and isinstance(length, torch.Tensor):
            self.length.copy_(length.reshape(()))
            return dataclasses.replace(self)
        return dataclasses.replace(self, length=int(length))

    def repeat_batch(self, n: int) -> "KVCache":
        """Tile the batch dim (beam expansion)."""
        return dataclasses.replace(self, k=self.k.repeat(1, n, 1, 1, 1),
                                   v=self.v.repeat(1, n, 1, 1, 1))

    def select_batch(self, idx: torch.Tensor) -> "KVCache":
        """Reorder batch rows (beam pruning), in place and over the valid
        rows only: rows >= length are written before any step reads them.
        In the device form over the `rows` a step may reach, which holds
        every valid row."""
        n = self.rows if self.on_device else self.length
        self.k[:, :, :, :n] = self.k[:, idx, :, :n]
        self.v[:, :, :, :n] = self.v[:, idx, :, :n]
        return dataclasses.replace(self)
