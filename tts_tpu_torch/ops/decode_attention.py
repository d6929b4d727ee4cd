"""Decode-step GQA attention over the live rows of a static KV cache
(counterpart of tts_tpu/ops/decode_attention.py:decode_gqa_attention).

q (B, H, D) single-step queries, roped upstream; k, v the layer's
(B, KVH, T, D) cache view (the in-place buffer); kv_len a host int, the live
rows including the step's own appended row. Heads are grouped kvh-major
(h = kvh * G + g), as gqa_attention groups them.

`decode_gqa_attention` runs the hand-written CUDA kernel
(csrc/decode_attention.cu) on a CUDA tensor and its plain PyTorch twin
`decode_gqa_attention_plain` on a CPU tensor. The twin repeats the TPU
kernel's block loop: blocks of bkv = min(block_kv, T) rows in order, fp32
scores (times `scale` when it is not 1), rows >= kv_len at -1e30, an online
softmax (running max m, denominator l from the unrounded p = exp(s - m)),
p rounded to the value dtype for the P.V product with fp32 accumulation,
and (acc / l) rounded once. The CUDA kernel is one launch at every
kv_len: `cluster_plan(kv_len)` splits the live rows of each (kv head,
batch row) into contiguous slices, one CTA each (one CTA alone, or one
thread-block cluster); every slice takes its own max, and the cluster's
first CTA merges the slices in order, scaling each by exp(m_i - M). So
its p round to bf16 at the slice's max, not at the TPU's running one: the
same sums, other bf16 roundings. The block size selects tts_tpu's errors
and the route only. Rows >= kv_len are never read, by either.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["decode_gqa_attention", "decode_gqa_attention_plain", "attn_fits",
           "cluster_plan"]

NEG_INF = -1e30
_HEAD_DIMS = (64, 128)        # head widths the CUDA kernel is built for
_MAX_GROUP = 8                # q heads per kv head it takes
_MAX_BLOCK = 256              # tts_tpu's largest block: the route's gate
_MAX_CTAS = 8                 # CTAs a cluster (the portable cluster size)
_ONE_CTA_ROWS = 128           # live rows one CTA takes alone, without a cluster
_CTA_ROWS = 64                # rows a CTA of a cluster takes before the slices grow
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, out, B, KVH, G, T, kv_len, ctas, rows, hd, scale, stream
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]


def cluster_plan(kv_len: int) -> tuple[int, int]:
    """The CUDA kernel's split of the live rows 0 .. kv_len - 1 over the
    CTAs of one cluster: (ctas, rows). CTA r takes rows r * rows ..
    min((r + 1) * rows, kv_len) - 1: in order, each row in one slice, none
    empty. Up to 128 rows one CTA takes them all (a cluster's launch and
    merge cost more than they save there); past that one CTA for each 64
    rows, at most 8 (the slices then grow)."""
    if kv_len < 1:
        raise ValueError(f"kv_len {kv_len} < 1")
    if kv_len <= _ONE_CTA_ROWS:
        return 1, kv_len
    ctas = min(_MAX_CTAS, -(-kv_len // _CTA_ROWS))
    rows = -(-kv_len // ctas)
    return -(-kv_len // rows), rows


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int,
           block_kv: int) -> int:
    """tts_tpu's errors, and the kv_len range. Returns the block rows."""
    b, h, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    kvh, t = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    bkv = min(block_kv, t)
    if t % bkv:
        raise ValueError(f"kv buffer {t} must divide block_kv {bkv}")
    if not 1 <= kv_len <= t:
        raise ValueError(f"kv_len {kv_len} outside 1..{t}")
    return bkv


def attn_fits(heads: int, kv_heads: int, head_dim: int, block_kv: int = 256) -> bool:
    """Whether the CUDA kernel takes this geometry: head_dim 64 or 128, at
    most 8 q heads per kv head, blocks of at most 256 rows."""
    return (head_dim in _HEAD_DIMS and heads % kv_heads == 0
            and heads // kv_heads <= _MAX_GROUP and block_kv <= _MAX_BLOCK)


def decode_gqa_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               kv_len: int, scale: float = 1.0,
                               block_kv: int = 256) -> torch.Tensor:
    """Plain PyTorch twin: the TPU kernel's block loop, rounding points and
    all."""
    bkv = _check(q, k, v, kv_len, block_kv)
    b, h, d = q.shape
    kvh = k.shape[1]
    dt = q.dtype
    qr = q.reshape(b, kvh, h // kvh, d).float()
    m = torch.full((b, kvh, h // kvh, 1), NEG_INF, device=q.device)
    l_run = torch.zeros_like(m)
    acc = torch.zeros_like(qr)
    for i in range(-(-kv_len // bkv)):
        # the live rows of block i: a masked row adds exp(-1e30 - m) = 0
        lo, hi = i * bkv, min((i + 1) * bkv, kv_len)
        s = torch.matmul(qr, k[:, :, lo:hi].to(dt).float().transpose(-1, -2))
        if scale != 1.0:
            s = s * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_run = l_run * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(dt).float(), v[:, :, lo:hi].to(dt).float())
        acc = acc * alpha + pv
        m = m_new
    return (acc / l_run).to(dt).reshape(b, h, d)


def decode_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: int, scale: float = 1.0,
                         block_kv: int = 256) -> torch.Tensor:
    """q (B, H, D); k, v (B, KVH, T, D); kv_len host int, 1 <= kv_len <= T.
    Returns (B, H, D) in q's dtype."""
    kv_len = int(kv_len)
    bkv = _check(q, k, v, kv_len, block_kv)
    if q.device.type == "cpu":
        return decode_gqa_attention_plain(q, k, v, kv_len, scale, block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    b, h, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    if not attn_fits(h, kvh, d, bkv):
        raise ValueError(f"the CUDA kernel takes head_dim {_HEAD_DIMS}, at most "
                         f"{_MAX_GROUP} q heads per kv head and blocks of at most "
                         f"{_MAX_BLOCK} rows; got {h}/{kvh} heads x {d}, block {bkv}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.dtype != torch.bfloat16 or a.device != q.device \
                or not a.is_contiguous() or a.data_ptr() % 16:
            raise TypeError(f"{name} must be a contiguous, 16-byte aligned bf16 "
                            f"tensor on {q.device}")
    ctas, rows = cluster_plan(kv_len)
    out = torch.empty_like(q)
    _build.launch("decode_gqa_attention", _ARGTYPES, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, kvh, h // kvh, t, kv_len, ctas, rows, d,
                  scale, torch.cuda.current_stream(q.device).cuda_stream, device=q.device)
    return out
