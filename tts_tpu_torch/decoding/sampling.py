"""Token selection: greedy and the repetition penalty (counterpart of
tts_tpu/decoding/sampling.py)."""
from __future__ import annotations

import torch

__all__ = ["greedy", "apply_repetition_penalty"]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B,) int32 argmax ids (the first of equal maxima)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def apply_repetition_penalty(logits: torch.Tensor, save_ids: torch.Tensor,
                             num_decoded: int, penalty: float,
                             penalty_range: int) -> torch.Tensor:
    """Multiply the logits of the last `penalty_range` decoded ids by
    `penalty`, whatever their sign, once `num_decoded >= penalty_range`
    (the reference's gather -> x penalty -> scatter; an id repeated in the
    window is scaled once). save_ids (B, max_len) holds the decoded ids."""
    penalty_range = min(penalty_range, save_ids.shape[1])
    if num_decoded < penalty_range:
        return logits
    start = num_decoded - penalty_range
    window = save_ids[:, start:start + penalty_range].long()        # (B, R)
    return logits.scatter(1, window, logits.gather(1, window) * penalty)
