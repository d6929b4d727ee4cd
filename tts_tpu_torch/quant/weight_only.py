"""Weight-only quantization and the quant-aware `dense` (counterpart of
tts_tpu/quant/weight_only.py).

A `QTensor` is per-output-channel symmetric int8: w ~ q * scale, q (in,
out) int8, scale (out,) fp32. tts_tpu computes its scale in two ways, and
the port keeps both, each bit-equal to its counterpart:
  - `quantize_int8_eager`: `max(amax, 1e-8) / 127` as a true fp32
    division, as tts_tpu's `quantize_int8` called eagerly (F5Pipeline's
    quantize modes);
  - `quantize_int8_jit`: `max(amax, 1e-8) * float32(1/127)`, as
    `jax.jit(quantize_int8)`, where XLA turns the division by a constant
    into a multiply (tts_tpu's `quantize_pytree`, so Kani's `quantize=8`).
A few percent of the channel scales differ by one ulp between the two, and
about one weight in 10^5 then rounds the other way. Rounding is half to even, as
`jnp.round`'s.

The int4 forms are group-wise symmetric, `group_size` input rows a group:
`QTensor4` is the packed storage form (two nibbles an int8 along the input
axis), `QTensorG` the runtime form (values in [-7, 7] in an int8
container). tts_tpu's k_quant scale search also has two forms, both kept:
`quantize_int4` takes the group sums in index order, as XLA's eager
reduction does (F5 and IndexTTS quantize eagerly); `quantize_int4_jit`
takes them as XLA's CPU code under jit does (`quantize_pytree`, so Kani,
Qwen3-TTS and VoxCPM at quantize=4). Each matches its counterpart's q and
scale bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["QTensor", "QTensor4", "QTensorG", "quantize_int8_eager",
           "quantize_int8_jit", "quantize_int4", "quantize_int4_jit", "dequantize", "dense", "quantize_pytree"]

_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)   # XLA's constant


@dataclasses.dataclass
class QTensor:
    """q: (..., in, out) int8; scale: (out,) float32."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape


@dataclasses.dataclass
class QTensor4:
    """Packed int4: w[2i] in the low nibble of q[i], w[2i+1] in the high.
    q: (in//2, out) int8; scale: (in//group_size, out) float32."""

    q: torch.Tensor
    scale: torch.Tensor
    group_size: int = 32

    def unpack_runtime(self) -> "QTensorG":
        return QTensorG(q=_unpack_int4_int8(self.q), scale=self.scale,
                        group_size=self.group_size)


@dataclasses.dataclass
class QTensorG:
    """Unpacked int4: q (in, out) int8 in [-7, 7]; scale (in//group_size,
    out) float32, applied per group after the contraction."""

    q: torch.Tensor
    scale: torch.Tensor
    group_size: int = 32

    @property
    def shape(self):
        return self.q.shape

    def pack(self) -> QTensor4:
        lo = self.q[0::2] & 0x0F
        hi = (self.q[1::2] & 0x0F) << 4
        return QTensor4(q=(lo | hi).to(torch.int8), scale=self.scale,
                        group_size=self.group_size)


def _amax_per_channel(w: torch.Tensor) -> torch.Tensor:
    return w.float().abs().amax(dim=tuple(range(w.dim() - 1)))


def _to_int8(wf: torch.Tensor, scale: torch.Tensor) -> QTensor:
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def quantize_int8_eager(w: torch.Tensor) -> QTensor:
    """Per output channel (last axis) of a (..., in, out) weight, scale
    amax / 127 divided in fp32: tts_tpu's quantize_int8 called eagerly."""
    scale = torch.clamp(_amax_per_channel(w), min=1e-8) / 127.0
    return _to_int8(w.float(), scale)


def quantize_int8_jit(w: torch.Tensor) -> QTensor:
    """Per output channel, scale amax * float32(1/127): jax.jit of tts_tpu's
    quantize_int8, as its quantize_pytree runs it."""
    scale = torch.clamp(_amax_per_channel(w), min=1e-8) * _INV_127.to(w.device)
    return _to_int8(w.float(), scale)


def _sum_in_order(v: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 in index order (XLA's eager reduction order; torch's
    own sum associates differently and moves the refit scales by ulps)."""
    acc = v[:, 0]
    for k in range(1, v.shape[1]):
        acc = acc + v[:, k]
    return acc


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 a * b + c rounded once, emulated in float64: the product is exact
    there, and the sum's two roundings differ from one only where it lies
    within 2^-53 (relative) of an fp32 midpoint."""
    return (a.double() * b.double() + c.double()).float()


def _sum_fma8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ a·b over dim 1 (a multiple of 8) as XLA's CPU code computes it under
    jit: eight interleaved fp32 FMA accumulators (term j into accumulator
    j % 8), then halved pairwise (i + i+4, i + i+2, 0 + 1)."""
    g, n, out = a.shape
    a8, b8 = a.reshape(g, n // 8, 8, out), b.reshape(g, n // 8, 8, out)
    acc = torch.zeros((g, 8, out), dtype=torch.float32, device=a.device)
    for m in range(n // 8):
        acc = _fma(a8[:, m], b8[:, m], acc)
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0]


def _k_quant(w: torch.Tensor, jit: bool) -> QTensor4:
    cin, cout = w.shape
    group = 32
    if cin % group:
        raise ValueError(f"in dim {cin} must be a multiple of {group}")
    wf = w.float().reshape(cin // group, group, cout)
    amax = torch.clamp(wf.abs().amax(dim=1), min=1e-8)                 # (G, out)
    best_err = best_q = best_s = None
    for d in np.linspace(7.0, 9.4, 14):
        if jit:          # XLA turns the division by a constant into a multiply
            cand = amax * float(np.float32(1.0) / np.float32(d))
        else:
            cand = amax / float(np.float32(d))
        q = torch.clamp(torch.round(wf / cand[:, None]), -7, 7)
        if jit:
            s = _sum_fma8(wf, q) / torch.clamp(_sum_fma8(q, q), min=1e-8)
            sub = _fma(-q, s[:, None].expand_as(q), wf)
            err = _sum_fma8(sub, sub)
        else:
            s = _sum_in_order(wf * q) / torch.clamp(_sum_in_order(q * q), min=1e-8)
            err = _sum_in_order((wf - q * s[:, None]) ** 2)
        if best_err is None:
            best_err, best_q, best_s = err, q, s
        else:
            take = err < best_err
            best_err = torch.where(take, err, best_err)
            best_s = torch.where(take, s, best_s)
            best_q = torch.where(take[:, None], q, best_q)
    scale = torch.clamp(best_s.abs(), min=1e-12) * torch.sign(
        torch.where(best_s == 0, 1.0, best_s))
    g = QTensorG(q=best_q.reshape(cin, cout).to(torch.int8), scale=scale,
                 group_size=group)
    return g.pack()


def quantize_int4(w: torch.Tensor) -> QTensor4:
    """Int4 of a (in, out) weight in groups of 32 input rows, in % 32 == 0:
    tts_tpu's k_quant search (its default), as an eager call computes it.
    14 scales from amax/7 to amax/9.4, each refit by least squares on its
    own rounding pattern (Σw·q / Σq²), the pair with the least squared
    error kept (the first on a tie)."""
    return _k_quant(w, jit=False)


def quantize_int4_jit(w: torch.Tensor) -> QTensor4:
    """quantize_int4 as `jax.jit` of tts_tpu's computes it on an x86 CPU, so
    its quantize_pytree: the candidate scales amax * f32(1/d), and the
    group sums in XLA's order with fused multiply-adds (`_sum_fma8`; the
    residual w - q·s an FMA too). Against the eager form, most refit
    scales move by an ulp, and a near tie may pick another candidate."""
    return _k_quant(w, jit=True)


def _unpack_int4_int8(packed: torch.Tensor) -> torch.Tensor:
    """Packed (in//2, out) -> (in, out) int8 in [-7, 7] (sign-extended
    nibbles, low nibble first); scales not applied."""
    raw = packed.to(torch.int32)
    lo, hi = raw & 0x0F, (raw >> 4) & 0x0F
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    cin2, cout = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * cin2, cout).to(torch.int8)


def dequantize(qt: QTensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """An int8 QTensor's weight, q * scale in fp32, cast to `dtype`."""
    return (qt.q.float() * qt.scale).to(dtype)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a float weight, an int8 QTensor or either int4 form, with
    tts_tpu's rounding points.
      int8: the product in the activation dtype, rounded, then times the
        scale cast to that dtype. (The cast of q materialises a copy of the
        weight in the activation dtype per call, where XLA fused it into
        the matmul's read.)
      int4: one fp32 dot per group of input rows, then the groups' partial
        outputs times their scales summed in fp32, rounded once. A packed
        QTensor4 is unpacked first."""
    if isinstance(w, QTensor):
        y = torch.matmul(x, w.q.to(x.dtype))
        return y * w.scale.to(x.dtype)
    if isinstance(w, QTensor4):
        w = w.unpack_runtime()
    if isinstance(w, QTensorG):
        cin, cout = w.q.shape
        g = w.group_size
        xg = x.reshape(*x.shape[:-1], cin // g, g).float()
        partial = torch.einsum("...gk,gkn->...gn", xg,
                               w.q.reshape(cin // g, g, cout).float())
        return (partial * w.scale).sum(dim=-2).to(x.dtype)
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
    ndim >= 2 and at least `min_size` elements, with quantized ones.
    bits=8: int8 QTensors, as tts_tpu's jitted quantizer gives them.
    bits=4: the unpacked int4 QTensorG (groups of 32, the k_quant search in
    its jitted form, as tts_tpu's quantize_pytree runs it) for 2-D weights
    whose input dim 32 divides, int8 for the rest."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def quant(v):
        if bits == 4 and v.dim() == 2 and v.shape[0] % 32 == 0:
            return quantize_int4_jit(v).unpack_runtime()
        return quantize_int8_jit(v)

    def walk(node):
        if isinstance(node, dict):
            return {k: quant(v)
                    if (k in keys and isinstance(v, torch.Tensor) and v.dim() >= 2
                        and v.numel() >= min_size and v.is_floating_point())
                    else walk(v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)
