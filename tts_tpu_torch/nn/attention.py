"""Grouped-query attention with static-length masking (counterpart of
tts_tpu/nn/attention.py).

GQA runs as grouped products over (B, KVH, G, S, D) with no repeat of the
keys and values; scores and softmax in fp32, masked scores at -1e30, the
probabilities cast to the activation dtype before P.V. The d^-0.5 scale is
folded into the weights at load (`scale` takes it where it is not).
"""
from __future__ import annotations

import torch

__all__ = ["attention_mask", "combine_kv_valid", "gqa_attention"]

NEG_INF = -1e30


def attention_mask(q_len: int, kv_max: int, q_start: int, kv_len: int,
                   causal: bool = True, device=None) -> torch.Tensor:
    """Boolean (q_len, kv_max) mask, True = attend. q_start is the first
    query's position on the key timeline; kv_len the valid keys."""
    kv_idx = torch.arange(kv_max, device=device)[None, :]
    valid = kv_idx < kv_len
    if causal:
        q_idx = torch.arange(q_len, device=device)[:, None] + q_start
        valid = valid & (kv_idx <= q_idx)
    return valid


def combine_kv_valid(mask: torch.Tensor, kv_valid: torch.Tensor) -> torch.Tensor:
    """AND an (S, T) mask with a key-validity mask: (T,) shared by the batch
    gives (S, T), (B, T) per row gives (B, S, T)."""
    if kv_valid.dim() == 1:
        return mask & kv_valid[None, :]
    return mask[None] & kv_valid[:, None, :]


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None, scale: float = 1.0) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, KVH, T, D); mask (S, T) or (B, S, T), True =
    attend, or None (every key). `scale` multiplies the fp32 scores (1.0:
    d^-0.5 folded into the weights). Returns (B, S, H, D)."""
    b, s, h, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    dt = q.dtype
    qg = q.reshape(b, s, kvh, g, d).permute(0, 2, 3, 1, 4)       # (B, KVH, G, S, D)
    # bf16 products are exact in fp32: fp32 operands give the fp32 accumulation
    scores = torch.matmul(qg.float(), k.to(dt).float().transpose(-1, -2)[:, :, None])
    if scale != 1.0:
        scores = scores * scale
    if mask is not None:
        m = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
        scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = torch.matmul(probs.float(), v.to(dt).float()[:, :, None]).to(dt)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
