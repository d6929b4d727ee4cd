"""Weight-only int8 quantization and the quant-aware `dense` (counterpart of
tts_tpu/quant/weight_only.py). The int4 forms (`QTensor4`, `QTensorG`) are
not ported yet.

A `QTensor` is per-output-channel symmetric int8: w ~ q * scale, q (in,
out) int8, scale (out,) fp32. `quantize_int8` gives the q and scale of
tts_tpu's `quantize_pytree` bit for bit: that runs `quantize_int8` under
`jax.jit`, where XLA turns amax / 127 into amax * float32(1/127) (an eager
call divides, and about one weight in 10^5 then rounds the other way); the
rounding is half to even, as `jnp.round`'s.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["QTensor", "quantize_int8", "dense", "quantize_pytree"]

_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)   # XLA's constant


@dataclasses.dataclass
class QTensor:
    """q: (..., in, out) int8; scale: (out,) float32."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape



def quantize_int8(w: torch.Tensor) -> QTensor:
    """Quantize a (..., in, out) weight per output channel (last axis)."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(w.dim() - 1)))
    scale = torch.clamp(amax, min=1e-8) * _INV_127
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a float weight or an int8 QTensor. The int8 form takes
    tts_tpu's rounding points: the product in the activation dtype, rounded,
    then times the scale cast to that dtype. (The cast of q materialises a
    copy of the weight in the activation dtype per call, where XLA fused it
    into the matmul's read.)"""
    if isinstance(w, QTensor):
        y = torch.matmul(x, w.q.to(x.dtype))
        return y * w.scale.to(x.dtype)
    if w.is_floating_point():
        return torch.matmul(x, w)
    raise TypeError(f"no dense for a {type(w).__name__} of {w.dtype}")


# matmul weights of the AR stacks eligible for weight-only quantization;
# codecs and DSP stay float
_DEFAULT_KEYS = ("wqkv", "wo", "w_gate_up", "w_down", "in_proj", "out_proj",
                 "lm_head")


def quantize_pytree(params, keys: tuple[str, ...] = _DEFAULT_KEYS,
                    min_size: int = 1 << 16, bits: int = 8):
    """Replace the float weights reached through dict keys in `keys`, of
    ndim >= 2 and at least `min_size` elements, with int8 QTensors."""
    if bits != 8:
        raise NotImplementedError(f"{bits}-bit weights are not ported yet")

    def walk(node):
        if isinstance(node, dict):
            return {k: quantize_int8(v)
                    if (k in keys and isinstance(v, torch.Tensor) and v.dim() >= 2
                        and v.numel() >= min_size and v.is_floating_point())
                    else walk(v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)
