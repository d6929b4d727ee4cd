"""Flash attention for the F5 DiT (counterpart of
tts_tpu/ops/flash_attention.py: flash_attention_flat and flash_attention).

`flash_attention_flat` (kernel 1, csrc/flash_attention.cu; twin
`flash_attention_flat_plain`) reads q, k and v off the fused (B, T, 3*H*D)
qkv tensor: half-split RoPE on q and k in fp32, rounded to the input dtype
before the dots (on the card a pre-pass, twin `rope_qk_plain`, writes them
to a scratch once); scores in fp32; keys >= kv_len masked; the exp2
softmax with no row max (clamp at +100 in the log2 domain, a -30 shift, p
below 2^-126 flushed to 0 as the TPU flushes it, and a 1e-37 guard on the
normaliser); P rounded to the input dtype before the P.V dot. Head dim 64
or 128.

`flash_attention` takes roped (B, H, S, D) q, k and v and dispatches as
tts_tpu's does: `block_kv == S` with `H % head_block == 0` takes the single
pass (kernel 4, twin `flash_onepass_plain`: kernel 1's softmax over the
whole key row, a scalar or (B,) kv_len, optionally the packed (B, S, H*D)
output), anything else the online softmax (kernel 5, twin
`flash_online_plain`: a running row max over kv blocks, natural exp, a
scalar kv_len). Both are in csrc/flash_mha.cu, for bf16 (tensor cores) and
fp32 (CUDA cores), D a multiple of 64 up to 256; kernel 1 and kernel 5's
bf16 form run the register-resident flash core (csrc/flash_core.cuh). The
block sizes and `head_block` select the route and the errors only: the
CUDA kernels pick their own tiles.

Every wrapper runs its CUDA kernel on a CUDA tensor and its plain PyTorch
twin on a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention_flat", "flash_attention_flat_plain", "rope_qk_plain",
           "flash_attention", "flash_attention_plain", "flash_onepass_plain",
           "flash_online_plain", "flat_kernel_fits", "mha_kernel_fits"]

_LOG2E = 1.4426950408889634
NEG_INF = -1e30
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# qkv, cos, sin, kv_len, qk scratch, out, B, T, H, D, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
# q, k, v, kv_len, out, scale constant, B, H, S, D, fp32, packed, stream
_MHA_ARGTYPES = [_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _P]
_FLAT_HEAD_DIMS = (64, 128)   # kernel 1 is built for these head dims
_MHA_MAX_D = 256              # kernels 4 and 5: D a multiple of 64 up to this
_TILE = 64                    # query rows per block and keys per tile
_TINY = 2.0 ** -126           # exp2 results below this flush to 0 (TPU, kernel 1)


def flat_kernel_fits(dtype, head_dim: int, t: int) -> bool:
    """Whether kernel 1's CUDA form takes this call: bf16, head dim 64 or
    128, T a multiple of its 64-row tile."""
    return dtype == torch.bfloat16 and head_dim in _FLAT_HEAD_DIMS and t % _TILE == 0


def mha_kernel_fits(dtype, head_dim: int, s: int) -> bool:
    """Whether kernels 4 and 5 take this call on a CUDA device: bf16 or fp32,
    D a multiple of 64 up to 256, S a multiple of their 64-row tile."""
    return (dtype in (torch.bfloat16, torch.float32) and head_dim % 64 == 0
            and 0 < head_dim <= _MHA_MAX_D and s % _TILE == 0)


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


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# --------------------------------------------------------------------------
# kernel 1: flat qkv with RoPE in the prologue

def rope_qk_plain(qkv: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor, *,
                  heads: int) -> torch.Tensor:
    """Plain twin of kernel 1's RoPE pre-pass: q and k of the (B, T, 3*H*D)
    qkv tensor as x * cos + rot_half(x) * sin in fp32 (each product and the
    sum rounded once), rot_half(x) = [-x[D/2:], x[:D/2]], rounded to qkv's
    dtype. Returns (2, B, H, T, D): roped q, then roped k."""
    b, t, n3 = qkv.shape
    d = n3 // (3 * heads)
    x = qkv.reshape(b, t, 3, heads, d)[:, :, :2].float()
    cos = rope_cos[:t].float()[None, :, None, None, :]
    sin = rope_sin[:t].float()[None, :, None, None, :]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return (x * cos + rot * sin).to(qkv.dtype).permute(2, 0, 3, 1, 4)


def flash_attention_flat_plain(qkv: torch.Tensor, rope_cos: torch.Tensor,
                               rope_sin: torch.Tensor, kv_len, *,
                               heads: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: same contract, same rounding
    points. Dots take fp32 operands (the products of bf16 values are exact
    in fp32), so they accumulate in fp32 as the kernel's tensor cores do."""
    b, t, n3 = qkv.shape
    d = n3 // (3 * heads)
    dt = qkv.dtype
    q, k = rope_qk_plain(qkv, rope_cos, rope_sin, heads=heads).float()
    v = qkv.reshape(b, t, 3, heads, d)[:, :, 2].float()
    s = torch.einsum("bhqd,bhkd->bhqk", q, k)
    s = torch.clamp(s * _LOG2E, max=100.0) - 30.0
    kv = _kv_lengths(kv_len, b, t, qkv.device)
    valid = torch.arange(t, device=qkv.device)[None, :] < kv[:, None]
    p = torch.exp2(s)
    p = torch.where(valid[:, None, None, :] & (p >= _TINY), p, 0.0)
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
    if not flat_kernel_fits(qkv.dtype, d, t):
        raise ValueError(f"the CUDA kernel takes bf16 qkv at head dim "
                         f"{_FLAT_HEAD_DIMS} and T a multiple of {_TILE}; got "
                         f"{qkv.dtype}, head dim {d}, T {t}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    cos = rope_cos[:t].to(device=qkv.device, dtype=torch.float32).contiguous()
    sin = rope_sin[:t].to(device=qkv.device, dtype=torch.float32).contiguous()
    kv = _kv_lengths(kv_len, b, t, qkv.device)
    qk = torch.empty((2, b, heads, t, d), dtype=qkv.dtype, device=qkv.device)
    out = torch.empty((b, t, heads * d), dtype=qkv.dtype, device=qkv.device)
    _build.launch("flash_attention_flat", _ARGTYPES, qkv.data_ptr(),
                  cos.data_ptr(), sin.data_ptr(), kv.data_ptr(), qk.data_ptr(),
                  out.data_ptr(), b, t, heads, d, _stream(qkv), device=qkv.device)
    return out


# --------------------------------------------------------------------------
# kernels 4 and 5: roped (B, H, S, D) q, k, v

def _pack(o: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H*D)."""
    b, h, s, d = o.shape
    return o.permute(0, 2, 1, 3).reshape(b, s, h * d)


def flash_onepass_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len,
                        scale: float = 1.0, packed_out: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of kernel 4 (tts_tpu's `_kernel_onepass`), at its
    rounding points: s * f32(scale * log2e), clamped at +100, plus a bias
    row of -30 (valid keys) or -1e30 (keys >= kv_len); exp2; l = sum(p) +
    1e-37; P rounded to v's dtype before the P.V dot (fp32 accumulation);
    then the divide, rounded to q's dtype. kv_len: None, an int, or a () or
    (B,) integer tensor."""
    b, h, s, d = q.shape
    kv = _kv_lengths(kv_len, b, s, q.device)
    bias = torch.where(torch.arange(s, device=q.device)[None, :] < kv[:, None],
                       -30.0, NEG_INF).float()[:, None, None, :]
    c = torch.tensor(scale * _LOG2E, dtype=torch.float32)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    p = torch.exp2(torch.clamp(sc * c, max=100.0) + bias)
    l = p.sum(dim=-1, keepdim=True) + 1e-37
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    o = (o / l).to(q.dtype)
    return _pack(o) if packed_out else o


def flash_online_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len,
                       scale: float = 1.0, block_kv: int | None = None) -> torch.Tensor:
    """Plain PyTorch twin of kernel 5 (tts_tpu's `_kernel`): the online
    softmax over kv blocks of `block_kv` keys (default: one block), at its
    rounding points: scores in fp32, times scale unless it is 1, -1e30 at
    keys >= kv_len before the max; a running row max m (from -1e30), p =
    exp(s - m_new), alpha = exp(m - m_new), l = l alpha + sum(p), acc = acc
    alpha + bf16(P).V; acc / l at the end, rounded to q's dtype. kv_len is
    a scalar: None, an int or a one-element integer tensor. With kv_len 0
    every score is -1e30 and each row is the mean of v over all S keys."""
    b, h, s, d = q.shape
    bkv = s if block_kv is None else block_kv
    kvl = s if kv_len is None else kv_len
    if isinstance(kvl, torch.Tensor):
        kvl = kvl.to(device=q.device, dtype=torch.int32).reshape(())
    qf = q.float()
    m = torch.full((b, h, s, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    for j in range(0, s, bkv):
        sc = torch.einsum("bhqd,bhkd->bhqk", qf, k[:, :, j:j + bkv].float())
        if scale != 1.0:
            sc = sc * torch.tensor(scale, dtype=torch.float32)
        idx = torch.arange(j, j + sc.shape[-1], device=q.device)
        sc = torch.where(idx < kvl, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                                         v[:, :, j:j + bkv].float())
    return (acc / l).to(q.dtype)


def _mha_route(q, k, v, kv_len, block_q: int, block_kv: int, head_block: int,
               packed_out: bool):
    """tts_tpu's dispatch and errors: (single pass?, block_kv)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, S, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _, h, s, _ = q.shape
    block_q, block_kv = min(block_q, s), min(block_kv, s)
    if s % block_q or s % block_kv:
        raise ValueError(f"seq {s} must divide block sizes ({block_q}, {block_kv})")
    if block_kv == s and head_block and h % head_block == 0:
        return True, block_kv
    if packed_out:
        raise NotImplementedError("packed_out needs the single-pass kernel")
    if isinstance(kv_len, torch.Tensor) and kv_len.numel() != 1:
        raise NotImplementedError(
            "per-request (B,) kv_len vectors are only supported on the "
            "single-pass full-kv kernel (block_kv == seq); the online-softmax "
            "kernel masks with a shared scalar")
    return False, block_kv


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len=None, scale: float = 1.0, block_q: int = 256,
                          block_kv: int = 256, head_block: int = 1,
                          packed_out: bool = False) -> torch.Tensor:
    """`flash_attention` through the twins, on any device."""
    onepass, bkv = _mha_route(q, k, v, kv_len, block_q, block_kv, head_block,
                              packed_out)
    if onepass:
        return flash_onepass_plain(q, k, v, kv_len, scale, packed_out)
    return flash_online_plain(q, k, v, kv_len, scale, bkv)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len=None, scale: float = 1.0, block_q: int = 256,
                    block_kv: int = 256, head_block: int = 1,
                    packed_out: bool = False) -> torch.Tensor:
    """q, k, v (B, H, S, D) -> (B, H, S, D), non-causal; keys at positions
    >= kv_len are masked (kv_len defaults to S). When block_kv covers the
    whole sequence and H % head_block == 0, the single-pass kernel 4 runs
    (kv_len a scalar or (B,); packed_out returns (B, S, H*D)); otherwise the
    online-softmax kernel 5 (scalar kv_len only). Errors as tts_tpu's:
    ValueError when S is not a multiple of the blocks, NotImplementedError
    for packed_out or a (B,) kv_len off the single pass."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len, scale, block_q, block_kv,
                                     head_block, packed_out)
    onepass, _ = _mha_route(q, k, v, kv_len, block_q, block_kv, head_block, packed_out)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    b, h, s, d = q.shape
    if not mha_kernel_fits(q.dtype, d, s):
        raise ValueError(f"the CUDA kernels take bf16 or fp32, D a multiple of 64 "
                         f"up to {_MHA_MAX_D} and S a multiple of {_TILE}; got "
                         f"{q.dtype}, D {d}, S {s}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.dtype != q.dtype or a.device != q.device:
            raise TypeError(f"{name} is {a.dtype} on {a.device}, q {q.dtype} on {q.device}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    kv = _kv_lengths(kv_len, b, s, q.device)
    if onepass:
        name, const = "flash_attention_onepass", scale * _LOG2E
        out = torch.empty((b, s, h * d) if packed_out else q.shape, dtype=q.dtype,
                          device=q.device)
    else:
        name, const = "flash_attention_online", scale
        out = torch.empty_like(q)
    _build.launch(name, _MHA_ARGTYPES, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  kv.data_ptr(), out.data_ptr(), const, b, h, s, d,
                  int(q.dtype == torch.float32), int(packed_out), _stream(q),
                  device=q.device)
    return out
