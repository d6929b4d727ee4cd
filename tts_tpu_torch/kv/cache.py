"""Static-shape KV cache (counterpart of tts_tpu/kv/cache.py).

Buffers of (num_layers, batch, kv_heads, max_len, head_dim) are allocated
once; `length` is a host int, the number of valid positions. `update_layer`
writes the new rows into the buffers in place, and the k/v it returns for
attention are views of them, not copies: rebuilding the stacked buffer
every layer is the copy that cost tts_tpu 3.5 ms a decode step.

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
    """k, v: (num_layers, batch, kv_heads, max_len, head_dim); length: int."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0

    @classmethod
    def create(cls, num_layers: int, batch: int, kv_heads: int, max_len: int,
               head_dim: int, dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (num_layers, batch, kv_heads, max_len, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0)

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    def update_layer(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor):
        """Write (B, S, KVH, D) keys/values at rows [length, length + S) of
        one layer, in place. Returns (self, k_full, v_full), the full
        (B, KVH, max_len, D) views of that layer. Does not advance length."""
        pos, s = self.length, k_new.shape[1]
        if pos + s > self.max_len:
            raise ValueError(f"cache of {self.max_len} rows cannot take rows "
                             f"[{pos}, {pos + s})")
        self.k[layer, :, :, pos:pos + s] = k_new.transpose(1, 2)
        self.v[layer, :, :, pos:pos + s] = v_new.transpose(1, 2)
        return self, self.k[layer], self.v[layer]

    def advance(self, num_tokens: int) -> "KVCache":
        return dataclasses.replace(self, length=self.length + int(num_tokens))

    def rewind(self, length: int) -> "KVCache":
        """Set length to a value <= the current one: after a prefill over a
        padded bucket, decode appends at the true prompt length and
        overwrites the padded rows, which the causal mask never exposes."""
        return dataclasses.replace(self, length=int(length))

    def repeat_batch(self, n: int) -> "KVCache":
        """Tile the batch dim (beam expansion)."""
        return dataclasses.replace(self, k=self.k.repeat(1, n, 1, 1, 1),
                                   v=self.v.repeat(1, n, 1, 1, 1))

    def select_batch(self, idx: torch.Tensor) -> "KVCache":
        """Reorder batch rows (beam pruning), in place and over the valid
        rows only: rows >= length are written before any step reads them."""
        n = self.length
        self.k[:, :, :, :n] = self.k[:, idx, :, :n]
        self.v[:, :, :, :n] = self.v[:, idx, :, :n]
        return dataclasses.replace(self)
