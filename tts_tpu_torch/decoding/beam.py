"""Beam search over (log-probs, KV cache batch rows) (counterpart of
tts_tpu/decoding/beam.py).

`lax.top_k` breaks ties toward the lower index; `torch.topk` promises no
order on ties, and bf16 logits over an 80k vocabulary do tie. `_top_k`
takes the first k of a stable descending sort, which keeps equal values in
index order, so both packages pick the same beams. The `_batch` forms are
tts_tpu's `jax.vmap` of the single forms over B independent requests.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["BeamState", "beam_init", "beam_step", "beam_init_batch", "beam_step_batch"]


class BeamState(NamedTuple):
    log_probs: torch.Tensor   # (beam, 1) cumulative log-probabilities
    tokens: torch.Tensor      # (beam,) int32 last token per beam
    parent: torch.Tensor      # (beam,) int32 row each beam came from


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_init_batch(logits: torch.Tensor, beam_size: int) -> BeamState:
    """First expansion per request. logits (B, V) -> log_probs (B, beam, 1),
    tokens (B, beam), parent (B, beam)."""
    log_probs = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    top_lp, top_idx = _top_k(log_probs, beam_size)
    return BeamState(log_probs=top_lp[..., None], tokens=top_idx.to(torch.int32),
                     parent=torch.zeros_like(top_idx, dtype=torch.int32))


def beam_step_batch(logits: torch.Tensor, prev_log_probs: torch.Tensor,
                    beam_size: int, top_k: int) -> BeamState:
    """Per request: logits (B, beam, V), prev_log_probs (B, beam, 1); top_k
    per beam, then the joint top beam_size over beam x top_k. parent
    indexes the request's own beams."""
    bsz = logits.shape[0]
    lp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    topk_lp, topk_idx = _top_k(lp, top_k)                        # (B, beam, top_k)
    joint = (topk_lp + prev_log_probs).reshape(bsz, -1)
    best_lp, flat = _top_k(joint, beam_size)                     # (B, beam)
    parent = torch.div(flat, top_k, rounding_mode="floor").to(torch.int32)
    tokens = topk_idx.reshape(bsz, -1).gather(1, flat).to(torch.int32)
    return BeamState(log_probs=best_lp[..., None], tokens=tokens, parent=parent)


def beam_init(logits: torch.Tensor, beam_size: int) -> BeamState:
    """First expansion from one hypothesis. logits: (1, V)."""
    return BeamState(*(t[0] for t in beam_init_batch(logits, beam_size)))


def beam_step(logits: torch.Tensor, prev_log_probs: torch.Tensor,
              beam_size: int, top_k: int) -> BeamState:
    """logits (beam, V), prev_log_probs (beam, 1)."""
    st = beam_step_batch(logits[None], prev_log_probs[None], beam_size, top_k)
    return BeamState(*(t[0] for t in st))
