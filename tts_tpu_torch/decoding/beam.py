"""Beam search over (log-probs, KV cache batch rows) (counterpart of
tts_tpu/decoding/beam.py).

`lax.top_k` breaks ties toward the lower index; `torch.topk` promises no
order on ties, and bf16 logits over an 80k vocabulary do tie. `_top_k`
takes the first k of a stable descending sort, which keeps equal values in
index order, so both packages pick the same beams.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["BeamState", "beam_init", "beam_step"]


class BeamState(NamedTuple):
    log_probs: torch.Tensor   # (beam, 1) cumulative log-probabilities
    tokens: torch.Tensor      # (beam,) int32 last token per beam
    parent: torch.Tensor      # (beam,) int32 row each beam came from


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_init(logits: torch.Tensor, beam_size: int) -> BeamState:
    """First expansion from one hypothesis. logits: (1, V)."""
    log_probs = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    top_lp, top_idx = _top_k(log_probs[0], beam_size)
    return BeamState(log_probs=top_lp[:, None], tokens=top_idx.to(torch.int32),
                     parent=torch.zeros(beam_size, dtype=torch.int32,
                                        device=logits.device))


def beam_step(logits: torch.Tensor, prev_log_probs: torch.Tensor,
              beam_size: int, top_k: int) -> BeamState:
    """logits (beam, V), prev_log_probs (beam, 1): top_k per beam, then the
    joint top beam_size over beam x top_k."""
    lp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    topk_lp, topk_idx = _top_k(lp, top_k)                        # (beam, top_k)
    joint = (topk_lp + prev_log_probs).reshape(-1)
    best_lp, flat = _top_k(joint, beam_size)
    parent = torch.div(flat, top_k, rounding_mode="floor").to(torch.int32)
    tokens = topk_idx.reshape(-1)[flat].to(torch.int32)
    return BeamState(log_probs=best_lp[:, None], tokens=tokens, parent=parent)
