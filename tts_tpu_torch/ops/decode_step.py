"""Fused decode step head for the M = 1 AR decode row (counterpart of
tts_tpu/ops/decode_step.py:fused_qkv_attn): the qkv head of
ops/decode_qkv.py, then GQA attention of layer `layer` of the stacked
(L, 1, KVH, T, D) cache over the rows < pos plus the step's own k/v row.
It does not write the cache: the caller's `update_layer` appends after.

`fused_qkv_attn` runs the hand-written CUDA kernel (csrc/decode_step.cu:
kernel 11's launch at one row, in the form `decode_qkv.qkv_plan` gives it,
writing q to a bf16 scratch row and the step's k and v rows; then the
attention in a cluster of CTAs a kv head, split as `step_plan` says, which
with the plan's programmatic dependent launch starts under the first
launch's tail and loads its cache rows before it waits for q) on a CUDA
tensor and its plain PyTorch twin `fused_qkv_attn_plain` on a CPU tensor. Both keep the TPU kernel's softmax: fp32 scores, one-shot
max-then-exp (not the online form), m = max(max_t s, s_new), denom =
sum p + p_new, probabilities rounded to the activation dtype before a P.V
product with fp32 accumulation. The new row's terms follow the TPU kernel's
two branches:

  | term      | head_dim 64 (packed branch)          | head_dim >= 128 |
  | s_new     | fp32 sum of q * k_new, both in fp32  | a dot           |
  | probs_new | stays fp32                           | rounded         |
  | v_new     | taken to fp32                        | taken to fp32   |

Cache rows >= pos are never read: masked rows add exp(-1e30 - m) = 0 in
fp32, so skipping them changes nothing and bounds the work by the real
context rather than the cache length.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_qkv import check_contract, fused_qkv_rope_plain, launch_args

__all__ = ["fused_qkv_attn", "fused_qkv_attn_plain", "MAX_GROUP", "step_fits",
           "step_plan"]

MAX_GROUP = 8                     # q heads per kv head the CUDA kernel takes
_MAX_SMEM = 200 * 1024            # the route gate's shared-memory budget
_MAX_CTAS = 8                     # CTAs a kv head's cluster (the portable size)
_CTA_ROWS = {64: 64, 128: 128}    # live rows a CTA takes before the cluster grows
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# x, w, w_int8, scale, bias, q_norm, k_norm, cos, sin, ln_w, ln_b, q (scratch),
# k, v, H, heads, kv_heads, head_dim, qkv ctas, qkv rows, pdl, eps, k_cache,
# v_cache (the layer's (KVH, T, D) slices), attn, T, pos, ctas, rows, stream
_ARGTYPES = [_P, _P, _I] + [_P] * 11 + [_I] * 7 + [_F, _P, _P, _P] + [_I] * 4 + [_P]


def _smem_bytes(group: int, head_dim: int, pos: int) -> int:
    """The route gate's measure of the shared memory `pos` rows need (the
    earlier one-CTA form's: q, the warps' P.V sums, the scores). The cluster
    form splits the scores over its CTAs and needs at most 95 KB, within
    the card's 227 KB wherever this is within 200 KB."""
    return 4 * (9 * group * head_dim + group * pos)


def step_fits(group: int, head_dim: int, pos: int) -> bool:
    """Whether the CUDA kernel takes `group` q heads per kv head and `pos`
    cache rows in its shared memory (the model gates add this)."""
    return group <= MAX_GROUP and _smem_bytes(group, head_dim, pos) <= _MAX_SMEM


def step_plan(pos: int, head_dim: int) -> tuple[int, int]:
    """The attention launch's split of the live rows 0 .. pos - 1 over the
    CTAs of a kv head's cluster: (ctas, rows). CTA r takes rows r * rows ..
    min((r + 1) * rows, pos) - 1: in order, each row in one slice, none
    empty. Up to 128 rows at head_dim 128 (64 at 64) one CTA takes them
    all (a cluster's three barriers cost more than the split saves there);
    past that one CTA for each such share, at most 8 (the slices then
    grow). pos 0 (no cache row, the new row alone): one CTA of 0 rows."""
    if pos < 0:
        raise ValueError(f"pos {pos} < 0")
    if pos == 0:
        return 1, 0
    ctas = min(_MAX_CTAS, -(-pos // _CTA_ROWS[head_dim]))
    rows = -(-pos // ctas)
    return -(-pos // rows), rows


def _attend(q, k_row, v_row, kc, vc, pos: int, heads: int, kv_heads: int,
            head_dim: int) -> torch.Tensor:
    """The twin's attention: q (1, heads*hd), k_row/v_row (1, kvh*hd), kc/vc
    the layer's (KVH, T, D) cache; returns (1, heads*hd)."""
    dt = q.dtype
    g = heads // kv_heads
    qh = q.reshape(kv_heads, g, head_dim).float()
    kn = k_row.reshape(kv_heads, 1, head_dim).float()
    vn = v_row.reshape(kv_heads, 1, head_dim).float()
    s = torch.matmul(qh, kc[:, :pos].float().transpose(1, 2))      # (KVH, G, pos)
    s_new = (qh * kn).sum(dim=-1, keepdim=True)                     # (KVH, G, 1)
    m = torch.maximum(s.amax(dim=-1, keepdim=True), s_new) if pos else s_new
    p = torch.exp(s - m)
    p_new = torch.exp(s_new - m)
    denom = p.sum(dim=-1, keepdim=True) + p_new
    probs = (p / denom).to(dt).float()
    probs_new = p_new / denom
    if head_dim >= 128:
        probs_new = probs_new.to(dt).float()
    pv = torch.matmul(probs, vc[:, :pos].float()) + probs_new * vn
    return pv.to(dt).reshape(1, heads * head_dim)


def fused_qkv_attn_plain(x: torch.Tensor, wqkv, rope_cos=None, rope_sin=None,
                         k_cache: torch.Tensor = None, v_cache: torch.Tensor = None,
                         layer: int = 0, pos: int = 0, *, heads: int, kv_heads: int,
                         head_dim: int, q_norm=None, k_norm=None, bqkv=None,
                         norm: str = "rms", ln_weight=None, ln_bias=None,
                         eps: float = 1e-6):
    """Plain PyTorch twin of the kernel: same contract, same rounding points."""
    q, k, v = fused_qkv_rope_plain(
        x, wqkv, rope_cos, rope_sin, heads=heads, kv_heads=kv_heads,
        head_dim=head_dim, q_norm=q_norm, k_norm=k_norm, bqkv=bqkv, norm=norm,
        ln_weight=ln_weight, ln_bias=ln_bias, eps=eps)
    attn = _attend(q, k, v, k_cache[layer, 0], v_cache[layer, 0], pos, heads,
                   kv_heads, head_dim)
    return attn, k, v


def _check_cache(x, k_cache, v_cache, layer: int, pos: int, kv_heads: int,
                 head_dim: int) -> None:
    if x.shape[0] != 1:
        raise ValueError("fused_qkv_attn is the M=1 decode head")
    if k_cache is None or v_cache is None or k_cache.shape != v_cache.shape:
        raise ValueError("k_cache and v_cache must be given with one shape")
    num_layers, cb, kvh, t, d = k_cache.shape
    if cb != 1 or kvh != kv_heads or d != head_dim:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} != (L, 1, "
                         f"{kv_heads}, T, {head_dim})")
    if not 0 <= layer < num_layers:
        raise ValueError(f"layer {layer} outside a cache of {num_layers} layers")
    if not 0 <= pos < t:
        raise ValueError(f"pos {pos} outside a cache of {t} rows")


def fused_qkv_attn(x: torch.Tensor, wqkv, rope_cos=None, rope_sin=None,
                   k_cache: torch.Tensor = None, v_cache: torch.Tensor = None,
                   layer: int = 0, pos: int = 0, *, heads: int, kv_heads: int,
                   head_dim: int, q_norm=None, k_norm=None, bqkv=None,
                   norm: str = "rms", ln_weight=None, ln_bias=None,
                   eps: float = 1e-6):
    """x (1, H); wqkv (H, (heads+2*kvh)*hd), a tensor or an int8 QTensor;
    rope_cos/rope_sin the (1, hd) rows of position `pos` (None: no RoPE);
    k_cache/v_cache the stacked (L, 1, KVH, T, D) buffers, read only;
    `layer` and `pos` host ints (cache rows < pos are valid).

    Returns (attn (1, heads*hd), k_row (1, kvh*hd), v_row (1, kvh*hd)):
    attention over cache[:pos] and the step's own roped k/v row, and the
    rows for the caller's cache append."""
    check_contract(x, wqkv, heads, kv_heads, head_dim, q_norm, k_norm, rope_cos,
                   rope_sin, norm, ln_weight, ln_bias)
    _check_cache(x, k_cache, v_cache, layer, pos, kv_heads, head_dim)
    if heads % kv_heads:
        raise ValueError(f"heads {heads} is not a multiple of kv_heads {kv_heads}")
    if x.device.type == "cpu":
        return fused_qkv_attn_plain(
            x, wqkv, rope_cos, rope_sin, k_cache, v_cache, layer, pos, heads=heads,
            kv_heads=kv_heads, head_dim=head_dim, q_norm=q_norm, k_norm=k_norm,
            bqkv=bqkv, norm=norm, ln_weight=ln_weight, ln_bias=ln_bias, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    g = heads // kv_heads
    if g > MAX_GROUP:
        raise ValueError(f"the CUDA kernel takes at most {MAX_GROUP} q heads per "
                         f"kv head, got {g}")
    if not step_fits(g, head_dim, pos):
        raise ValueError(f"pos {pos} needs {_smem_bytes(g, head_dim, pos)} bytes of "
                         f"shared memory, over the kernel's {_MAX_SMEM}")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if c.dtype != torch.bfloat16 or c.device != x.device \
                or not c.is_contiguous() or c.data_ptr() % 16:
            raise TypeError(f"{name} must be a contiguous, 16-byte aligned bf16 "
                            f"tensor on {x.device}")
    args, (_, k, v), attn, plan = launch_args(
        x, wqkv, rope_cos, rope_sin, heads, kv_heads, head_dim, q_norm, k_norm, bqkv, norm,
        ln_weight, ln_bias, extra=heads * head_dim)
    ctas, rows = step_plan(pos, head_dim)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.launch("fused_qkv_attn", _ARGTYPES, *args, x.shape[1], heads, kv_heads, head_dim,
                  plan.ctas, plan.rows, int(plan.pdl), eps, k_cache[layer].data_ptr(),
                  v_cache[layer].data_ptr(), attn.data_ptr(), k_cache.shape[3], pos, ctas,
                  rows, stream, device=x.device)
    return attn.view(1, heads * head_dim), k, v
