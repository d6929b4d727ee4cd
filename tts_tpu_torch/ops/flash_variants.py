"""Kernel 16: ablations of the flat flash attention's epilogue (counterpart
of benchmarks/flash_ablation.py: `flash_variant`, and its `kv_split` sweep
of kernel 1).

Each variant computes kernel 1's function (ops/flash_attention.
flash_attention_flat: RoPE on q and k off the flat (B, T, 3*H*D) qkv, the
exp2 softmax with no row max, keys clamped at +100 in the log2 domain and
shifted by -30) over every key (no mask), with a logit scale `scale`, and
changes one piece of its epilogue:

  base     the scores times f32(scale * log2e), as kernel 1 (at scale 1.0
           it is kernel 1 with kv_len = T, bit for bit);
  qscale   f32(scale * log2e) folded into q's RoPE tables (multiplied in
           fp32 first), q rounded to bf16 after its RoPE; the scores are
           not scaled;
  bf16sm   qscale, then the clamped and shifted score rounded to bf16 and
           exp2 taken in bf16 (on the card `ex2.approx.ftz.bf16x2`, two
           results an instruction); l summed in fp32 over the bf16 p, which
           is the P.V operand as it is;
  nodiv    bf16sm, then o * (1 / l) in place of o / l.

`kv_split` (2 or 4, `base` only) splits each 128-row block's keys over a
thread-block cluster of that many CTAs, each leaving its O and l in shared
memory for rank 0 to add in rank order (kernel 4's fp32 key split): it
changes only the fp32 order of the sums, so its twin is `base`'s.

`flash_variant` runs the hand-written CUDA kernel (csrc/flash_variants.cu on
the flash core, csrc/flash_core.cuh) on a CUDA tensor and the plain twin
`flash_variant_plain` on a CPU tensor. The CUDA kernel takes bf16 qkv at
head dim 64 with T a multiple of 64. No pipeline calls it: the ablation
entry point (tts_tpu_torch/ablations/flash_ablation.py) and the smoke run
do.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .flash_attention import _LOG2E, _TINY, _kv_lengths, _stream, rope_qk_plain

__all__ = ["VARIANTS", "SPLITS", "flash_variant", "flash_variant_plain"]

VARIANTS = ("base", "qscale", "bf16sm", "nodiv")
SPLITS = (1, 2, 4)           # CTAs of a cluster sharing a row block's keys
_HEAD_DIM = 64               # the CUDA kernel is built for this head dim only
_TILE = 64                   # T must be a multiple of a warpgroup's rows
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# qkv, cos, sin, kv_len, qk scratch, out, B, T, H, D, c, variant, split, stream
_ARGTYPES = [_P] * 6 + [_I] * 4 + [_F, _I, _I, _P]


def _check(qkv, rope_cos, rope_sin, heads: int, variant: str, kv_split: int) -> int:
    """Validate the call; returns the head dim."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    if kv_split not in SPLITS or (kv_split > 1 and variant != "base"):
        raise ValueError(f"kv_split {kv_split}: {SPLITS} for base, 1 for the others")
    b, t, n3 = qkv.shape
    if n3 % (3 * heads):
        raise ValueError(f"qkv feature dim {n3} is not 3 * heads ({heads}) * d")
    d = n3 // (3 * heads)
    if rope_cos.shape[-1] != d or rope_sin.shape[-1] != d \
            or rope_cos.shape[0] < t or rope_sin.shape[0] < t:
        raise ValueError(f"rope tables {tuple(rope_cos.shape)} / "
                         f"{tuple(rope_sin.shape)} do not cover ({t}, {d})")
    return d


def flash_variant_plain(qkv: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor, *,
                        heads: int, scale: float, variant: str,
                        kv_split: int = 1) -> torch.Tensor:
    """Plain PyTorch twin of kernel 16 at the rounding points of the Pallas
    `_kernel` in benchmarks/flash_ablation.py: RoPE in fp32, q and k
    rounded to qkv's dtype; the dots in fp32 (fp32 operands: the products
    of bf16 values are exact); p below 2^-126 flushed to 0, as the card's
    exp2 flushes it. `kv_split` does not change the twin."""
    d = _check(qkv, rope_cos, rope_sin, heads, variant, kv_split)
    b, t, _ = qkv.shape
    dt = qkv.dtype
    f = torch.tensor(np.float32(scale * _LOG2E), dtype=torch.float32, device=qkv.device)
    cos, sin = rope_cos[:t].float(), rope_sin[:t].float()
    if variant == "base":
        q, k = rope_qk_plain(qkv, cos, sin, heads=heads).float()
    else:
        q = rope_qk_plain(qkv, cos * f, sin * f, heads=heads)[0].float()
        k = rope_qk_plain(qkv, cos, sin, heads=heads)[1].float()
    v = qkv.reshape(b, t, 3, heads, d)[:, :, 2].float()
    s = torch.einsum("bhqd,bhkd->bhqk", q, k)
    if variant == "base":
        s = s * f
    s = torch.clamp(s, max=100.0) - 30.0
    if variant in ("base", "qscale"):
        p = torch.exp2(s)
        p = torch.where(p >= _TINY, p, 0.0)
        l = p.sum(dim=-1, keepdim=True) + 1e-37
        p = p.to(dt).float()
    else:
        p = torch.exp2(s.to(torch.bfloat16).float()).to(torch.bfloat16).float()
        p = torch.where(p >= _TINY, p, 0.0)
        l = p.sum(dim=-1, keepdim=True) + 1e-37
    o = torch.einsum("bhqk,bkhd->bhqd", p, v)
    o = o * (1.0 / l) if variant == "nodiv" else o / l
    return o.to(dt).permute(0, 2, 1, 3).reshape(b, t, heads * d)


def flash_variant(qkv: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor, *,
                  heads: int, scale: float, variant: str, kv_split: int = 1) -> torch.Tensor:
    """Kernel 1's attention over the flat qkv (B, T, 3*H*D), every key
    kept, with logit scale `scale`, in epilogue `variant` (one of VARIANTS)
    and, for `base`, each row block's keys over `kv_split` CTAs (SPLITS).
    rope_cos/rope_sin (>= T, D) half-split tables. Returns (B, T, H*D)."""
    d = _check(qkv, rope_cos, rope_sin, heads, variant, kv_split)
    b, t, _ = qkv.shape
    if qkv.device.type == "cpu":
        return flash_variant_plain(qkv, rope_cos, rope_sin, heads=heads, scale=scale,
                                   variant=variant, kv_split=kv_split)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if qkv.dtype != torch.bfloat16 or d != _HEAD_DIM or t % _TILE:
        raise ValueError(f"the CUDA kernel takes bf16 qkv at head dim {_HEAD_DIM} and T a "
                         f"multiple of {_TILE}; got {qkv.dtype}, head dim {d}, T {t}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    cos = rope_cos[:t].to(device=qkv.device, dtype=torch.float32).contiguous()
    sin = rope_sin[:t].to(device=qkv.device, dtype=torch.float32).contiguous()
    kv = _kv_lengths(t, b, t, qkv.device)
    qk = torch.empty((2, b, heads, t, d), dtype=qkv.dtype, device=qkv.device)
    out = torch.empty((b, t, heads * d), dtype=qkv.dtype, device=qkv.device)
    _build.launch("flash_variant", _ARGTYPES, qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                  kv.data_ptr(), qk.data_ptr(), out.data_ptr(), b, t, heads, d,
                  float(np.float32(scale * _LOG2E)), VARIANTS.index(variant), kv_split,
                  _stream(qkv), device=qkv.device)
    return out
