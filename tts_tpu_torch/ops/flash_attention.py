"""Flat-qkv flash attention for the F5 DiT (counterpart of
tts_tpu/ops/flash_attention.py:flash_attention_flat).

`flash_attention_flat` runs the hand-written CUDA kernel
(csrc/flash_attention.cu) on a CUDA tensor and its plain PyTorch twin
`flash_attention_flat_plain` on a CPU tensor. Both compute the TPU kernel's
contract: half-split RoPE on q and k in fp32, rounded to the input dtype
before the dots; scores in fp32; keys >= kv_len masked; the exp2 softmax
with no row max (clamp at +100 in the log2 domain, a -30 shift and a 1e-37
guard on the normaliser); P rounded to the input dtype before the P.V dot.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention_flat", "flash_attention_flat_plain"]

_LOG2E = 1.4426950408889634
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
_HEAD_DIM = 64   # the kernel is built for D = 64 (F5)
_TILE = 64       # query rows per block and keys per tile


def _kv_lengths(kv_len, b: int, t: int, device) -> torch.Tensor:
    """None | int | () or (B,) integer tensor -> (B,) int32 on `device`."""
    if kv_len is None:
        kv_len = t
    if isinstance(kv_len, int):
        return torch.full((b,), kv_len, dtype=torch.int32, device=device)
    kv = kv_len.to(device=device, dtype=torch.int32).reshape(-1)
    if kv.numel() == 1:
        return kv.expand(b).contiguous()
    if kv.numel() != b:
        raise ValueError(f"kv_len has {kv.numel()} entries for batch {b}")
    return kv.contiguous()


def flash_attention_flat_plain(qkv: torch.Tensor, rope_cos: torch.Tensor,
                               rope_sin: torch.Tensor, kv_len, *,
                               heads: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: same contract, same rounding
    points. Dots take fp32 operands (the products of bf16 values are exact
    in fp32), so they accumulate in fp32 as the kernel's tensor cores do."""
    b, t, n3 = qkv.shape
    d = n3 // (3 * heads)
    dt = qkv.dtype
    x = qkv.reshape(b, t, 3, heads, d).float()
    cos = rope_cos[:t].float()[None, :, None, :]
    sin = rope_sin[:t].float()[None, :, None, :]

    def rope(u):
        rot = torch.cat([-u[..., d // 2:], u[..., :d // 2]], dim=-1)
        return (u * cos + rot * sin).to(dt).float()

    q, k, v = rope(x[:, :, 0]), rope(x[:, :, 1]), x[:, :, 2]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    s = torch.clamp(s * _LOG2E, max=100.0) - 30.0
    kv = _kv_lengths(kv_len, b, t, qkv.device)
    valid = torch.arange(t, device=qkv.device)[None, :] < kv[:, None]
    p = torch.where(valid[:, None, None, :], torch.exp2(s), 0.0)
    denom = p.sum(dim=-1, keepdim=True) + 1e-37
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), v) / denom
    return o.to(dt).permute(0, 2, 1, 3).reshape(b, t, heads * d)


def flash_attention_flat(qkv: torch.Tensor, rope_cos: torch.Tensor,
                         rope_sin: torch.Tensor, kv_len=None, *,
                         heads: int) -> torch.Tensor:
    """Non-causal attention over the flat qkv tensor.

    qkv (B, T, 3*H*D): q|k|v on the feature axis, head-major in each.
    rope_cos/rope_sin (>= T, D) half-split tables. kv_len masks keys >=
    kv_len: None (no mask), an int, or a () or (B,) integer tensor.
    Returns (B, T, H*D).

    The TPU kernel's `kv_split` is not taken: it only chunked the one-pass
    sums for the TPU's scheduler, and this kernel tiles the keys anyway."""
    b, t, n3 = qkv.shape
    if n3 % (3 * heads):
        raise ValueError(f"qkv feature dim {n3} is not 3 * heads ({heads}) * d")
    d = n3 // (3 * heads)
    if rope_cos.shape[-1] != d or rope_sin.shape[-1] != d \
            or rope_cos.shape[0] < t or rope_sin.shape[0] < t:
        raise ValueError(f"rope tables {tuple(rope_cos.shape)} / "
                         f"{tuple(rope_sin.shape)} do not cover ({t}, {d})")
    if qkv.device.type == "cpu":
        return flash_attention_flat_plain(qkv, rope_cos, rope_sin, kv_len,
                                          heads=heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 qkv, got {qkv.dtype}")
    if d != _HEAD_DIM:
        raise ValueError(f"the CUDA kernel is built for head dim {_HEAD_DIM}, "
                         f"got {d}")
    if t % _TILE:
        raise ValueError(f"sequence {t} is not a multiple of {_TILE}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    cos = rope_cos[:t].to(device=qkv.device, dtype=torch.float32).contiguous()
    sin = rope_sin[:t].to(device=qkv.device, dtype=torch.float32).contiguous()
    kv = _kv_lengths(kv_len, b, t, qkv.device)
    out = torch.empty((b, t, heads * d), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    _build.launch("flash_attention_flat", _ARGTYPES, qkv.data_ptr(),
                  cos.data_ptr(), sin.data_ptr(), kv.data_ptr(), out.data_ptr(),
                  b, t, heads, stream)
    return out
