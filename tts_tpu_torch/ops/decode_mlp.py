"""Fused decode-layer tail for M = 1..8 AR decode rows (counterpart of
tts_tpu/ops/decode_mlp.py): attention out-projection -> residual ->
RMSNorm -> SwiGLU MLP -> residual,

    x2 = x + dense(att, wo);  h = rms_norm(x2)
    g, u = split(dense(h, w_gate_up));  out = x2 + dense(silu(g) * u, w_down)

`fused_out_mlp` (kernel 14) takes bf16 weights or int8 weight-only
QTensors, all three of one kind; `fused_out_mlp_q8` (kernel 15) is the W8A8
form over int8 QTensors. Each runs the hand-written CUDA kernel
(csrc/decode_mlp.cu, csrc/decode_mlp_q8.cu, on the kernels of
csrc/decode_mlp.cuh) on a CUDA tensor and its plain PyTorch twin on a CPU
tensor; `out_mlp_reference` is the plain chain (dense, rms_norm, silu in
the activation dtype) the kernels replace.

Kernel 14's rounding points, in the activation dtype: each dot accumulates
in fp32 and is rounded, then (int8) times the scale rounded to the dtype;
x2 and the output are rounded sums; h is rounded once from fp32; a =
silu(g) * u is computed in fp32 from the rounded g and u and rounded once.

Kernel 15's quantization (tts_tpu's _kernel_q8, with the att row
quantization its wrapper ran ahead of it): att per row, xs = max(amax,
1e-8) * f32(1/127), q = clip(round_half_even(v / xs), -127, 127);
y = (acc * ats) * so in fp32, x2 = x + y rounded; n = x2 * rsqrt(mean(x2^2)
+ eps) in fp32, unrounded, quantized per row; per F-block of
fb = _pick_block(F) columns (512 at F = 3072): g, u rescaled in fp32, a =
silu(g) * u, quantized per row of the block, its down product rescaled and
summed over the blocks in order; out = x2 + (accf * sd) rounded. The block
size sets the activation scales, so it is part of the contract. The twin
sums the int8 products as a float64 matmul, exact below 2^53.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..quant.weight_only import QTensor, dense
from . import _build
from .decode_qkv import _ptr
from .quant_matmul import int_dot, quantize_rows

__all__ = ["fused_out_mlp", "fused_out_mlp_plain", "fused_out_mlp_q8",
           "fused_out_mlp_q8_plain", "out_mlp_reference", "out_mlp_fits"]

MAX_ROWS = 8                 # decode rows the CUDA kernels take
_H_MAX, _F_MAX = 4096, 4096  # widest hidden and FFN they hold on chip
_OP_COLS = 32                # out-projection columns a CTA covers
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# x, att, wo, wgu, wd, w_int8, so, sgu, sd, partial, x2, a, out, B, A, H, F,
# kslice, ks, eps, stream
_ARGTYPES = [_P] * 5 + [_I] + [_P] * 7 + [_I] * 6 + [_F, _P]
# x, att, wo, wgu, wd, so, sgu, sd, partial, ats, x2, a, out, B, A, H, F,
# kslice, ks, fb, eps, stream
_ARGTYPES_Q8 = [_P] * 13 + [_I] * 7 + [_F, _P]


def _pick_block(dim: int, target: int = 512, mult: int = 128) -> int:
    """Largest divisor of `dim` that is a multiple of `mult` and <= target;
    falls back to the smallest multiple-of-mult divisor (or dim itself).
    tts_tpu's block rule, copied: kernel 15's activation scales follow it."""
    best = None
    for b in range(mult, dim + 1, mult):
        if dim % b == 0:
            if b <= target:
                best = b
            elif best is None:
                best = b
                break
    return best if best is not None else dim


def out_mlp_fits(batch: int, a_dim: int, hidden: int, ffn: int) -> bool:
    """Whether the CUDA kernels take these widths: 1..8 rows, the attention
    width a multiple of 8, hidden and FFN multiples of 32 up to 4096, and
    (W8A8) an F-block that 32 divides."""
    fb = _pick_block(ffn)
    return (1 <= batch <= MAX_ROWS and a_dim % 8 == 0 and hidden % 32 == 0
            and ffn % 32 == 0 and hidden <= _H_MAX and ffn <= _F_MAX and fb % 32 == 0)


def _parts(wo, w_gate_up, w_down, x, att):
    """(quantized, f_dim) after tts_tpu's checks: one kind of weight, shapes
    that chain (A, H) -> (H, 2F) -> (F, H)."""
    quant = isinstance(wo, QTensor)
    if quant != isinstance(w_gate_up, QTensor) or quant != isinstance(w_down, QTensor):
        raise ValueError("wo/w_gate_up/w_down must be uniformly quantized")
    b, hd = x.shape
    a_dim = att.shape[1]
    f_dim = w_down.shape[0]
    if att.shape[0] != b or tuple(w_gate_up.shape) != (hd, 2 * f_dim) \
            or tuple(wo.shape) != (a_dim, hd) or tuple(w_down.shape) != (f_dim, hd):
        raise ValueError(f"shape mismatch: wo {tuple(wo.shape)}, gate_up "
                         f"{tuple(w_gate_up.shape)}, down {tuple(w_down.shape)} for x "
                         f"{tuple(x.shape)}, att {tuple(att.shape)}")
    return quant, f_dim


# --------------------------------------------------------------------------
# plain twins

def out_mlp_reference(x, att, wo, w_gate_up, w_down, *, eps: float = 1e-6):
    """The plain chain the kernels replace (the layer tail of
    models/qwen_tts when no fused route is taken)."""
    from ..nn.norm import rms_norm

    x = x + dense(att, wo)
    gate, up = dense(rms_norm(x, eps=eps), w_gate_up).chunk(2, dim=-1)
    return x + dense(F.silu(gate) * up, w_down)


def _dot(a: torch.Tensor, w, cols: slice | None = None) -> torch.Tensor:
    """fp32 dot rounded to a.dtype, then (int8) times the scale in a.dtype."""
    wq = w.q if isinstance(w, QTensor) else w
    if cols is not None:
        wq = wq[:, cols]
    y = torch.matmul(a.float(), wq.float()).to(a.dtype)
    if isinstance(w, QTensor):
        s = w.scale if cols is None else w.scale[cols]
        y = y * s.to(a.dtype)
    return y


def fused_out_mlp_plain(x, att, wo, w_gate_up, w_down, *, eps: float = 1e-6):
    """Plain PyTorch twin of kernel 14: same contract, same rounding points."""
    _, f_dim = _parts(wo, w_gate_up, w_down, x, att)
    x2 = x + _dot(att.to(x.dtype), wo)
    xf = x2.float()
    h = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)).to(x.dtype)
    g = _dot(h, w_gate_up, slice(0, f_dim))
    u = _dot(h, w_gate_up, slice(f_dim, 2 * f_dim))
    a = (F.silu(g.float()) * u.float()).to(x.dtype)
    return x2 + _dot(a, w_down)


def fused_out_mlp_q8_plain(x, att, wo, w_gate_up, w_down, *, eps: float = 1e-6):
    """Plain PyTorch twin of kernel 15: same contract, same rounding points."""
    if not all(isinstance(w, QTensor) for w in (wo, w_gate_up, w_down)):
        raise ValueError("fused_out_mlp_q8 needs int8 QTensor weights")
    _, f_dim = _parts(wo, w_gate_up, w_down, x, att)
    dt = x.dtype
    attq, ats = quantize_rows(att.float())
    x2 = x + (int_dot(attq, wo.q) * ats * wo.scale).to(dt)
    xf = x2.float()
    n = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    hq, hs = quantize_rows(n)
    fb = _pick_block(f_dim)
    accf = torch.zeros_like(xf)
    for j in range(f_dim // fb):
        g_cols = slice(j * fb, (j + 1) * fb)
        u_cols = slice(f_dim + j * fb, f_dim + (j + 1) * fb)
        g = int_dot(hq, w_gate_up.q[:, g_cols]) * hs * w_gate_up.scale[g_cols]
        u = int_dot(hq, w_gate_up.q[:, u_cols]) * hs * w_gate_up.scale[u_cols]
        aq, as_ = quantize_rows(F.silu(g) * u)
        accf = accf + int_dot(aq, w_down.q[g_cols]) * as_
    return x2 + (accf * w_down.scale).to(dt)


# --------------------------------------------------------------------------
# CUDA kernels

@functools.lru_cache(maxsize=64)
def _k_split(device: torch.device, a_dim: int, hidden: int) -> tuple[int, int]:
    """(slices of the attention width, rows per slice) of the out-projection:
    about one CTA per SM over its column tiles."""
    sms = torch.cuda.get_device_properties(device.index or 0).multi_processor_count
    tiles = hidden // _OP_COLS
    ks = max(1, min(8, sms // max(tiles, 1), a_dim // 64))
    kslice = -(-a_dim // ks)
    return -(-a_dim // kslice), kslice


def _operands(x, att, ws) -> None:
    """The CUDA kernels' operand rules: contiguous 16-byte-aligned tensors on
    x's card, bf16 activations, bf16 or int8 weights, fp32 scales."""
    dev = x.device
    for name, a in (("x", x), ("att", att)):
        if a.dtype != torch.bfloat16 or a.device != dev or not a.is_contiguous() \
                or a.data_ptr() % 16:
            raise TypeError(f"the CUDA kernel takes {name} as a contiguous bf16 tensor "
                            f"on {dev}")
    for name, w in ws:
        wq = w.q if isinstance(w, QTensor) else w
        want = torch.int8 if isinstance(w, QTensor) else torch.bfloat16
        if wq.dtype != want or wq.device != dev or not wq.is_contiguous() \
                or wq.data_ptr() % 16:
            raise TypeError(f"{name} must be contiguous, 16-byte aligned {want} on {dev}")
        if isinstance(w, QTensor) and (w.scale.dtype != torch.float32 or w.scale.device
                                       != dev or not w.scale.is_contiguous()):
            raise TypeError(f"{name}'s scale must be contiguous fp32 on {dev}")


def _prepare(x, att, wo, w_gate_up, w_down):
    """Device checks, the kernels' limits and the out-projection split.
    Returns (f_dim, quant, ks, kslice) or None for a CPU tensor."""
    quant, f_dim = _parts(wo, w_gate_up, w_down, x, att)
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    b, hd = x.shape
    if not out_mlp_fits(b, att.shape[1], hd, f_dim):
        raise ValueError(f"the CUDA kernels take 1..{MAX_ROWS} rows, an attention width "
                         f"a multiple of 8, hidden and FFN multiples of 32 up to "
                         f"{_H_MAX}; got B={b}, A={att.shape[1]}, H={hd}, F={f_dim}")
    _operands(x, att, (("wo", wo), ("w_gate_up", w_gate_up), ("w_down", w_down)))
    ks, kslice = _k_split(x.device, att.shape[1], hd)
    return f_dim, quant, ks, kslice


def fused_out_mlp(x: torch.Tensor, att: torch.Tensor, wo, w_gate_up, w_down, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """x (B, H) residual input; att (B, A) attention rows; wo (A, H),
    w_gate_up (H, 2F), w_down (F, H), all bf16 tensors or all int8 QTensors.
    Returns (B, H) in x's dtype."""
    prep = _prepare(x, att, wo, w_gate_up, w_down)
    if prep is None:
        return fused_out_mlp_plain(x, att, wo, w_gate_up, w_down, eps=eps)
    f_dim, quant, ks, kslice = prep
    b, hd = x.shape
    # fp32 scratch: out-projection partials, then x2 and a as bf16
    scratch = torch.empty((ks * b * hd + (b * hd + b * f_dim) // 2 + 8,),
                          dtype=torch.float32, device=x.device)
    x2 = scratch[ks * b * hd:].view(torch.bfloat16)[:b * hd]
    a = scratch[ks * b * hd:].view(torch.bfloat16)[b * hd:b * hd + b * f_dim]
    out = torch.empty_like(x)
    w = [t.q if quant else t for t in (wo, w_gate_up, w_down)]
    scales = [t.scale if quant else None for t in (wo, w_gate_up, w_down)]
    _build.launch("fused_out_mlp", _ARGTYPES, x.data_ptr(), att.data_ptr(),
                  *(t.data_ptr() for t in w), int(quant), *map(_ptr, scales),
                  scratch.data_ptr(), x2.data_ptr(), a.data_ptr(), out.data_ptr(), b,
                  att.shape[1], hd, f_dim, kslice, ks, eps,
                  torch.cuda.current_stream(x.device).cuda_stream, device=x.device)
    return out


def fused_out_mlp_q8(x: torch.Tensor, att: torch.Tensor, wo, w_gate_up, w_down, *,
                     eps: float = 1e-6) -> torch.Tensor:
    """The W8A8 tail: as fused_out_mlp, all three weights int8 QTensors with
    fp32 scales; att, h and a quantized per row (a per F-block)."""
    if not all(isinstance(w, QTensor) for w in (wo, w_gate_up, w_down)):
        raise ValueError("fused_out_mlp_q8 needs int8 QTensor weights")
    prep = _prepare(x, att, wo, w_gate_up, w_down)
    if prep is None:
        return fused_out_mlp_q8_plain(x, att, wo, w_gate_up, w_down, eps=eps)
    f_dim, _, ks, kslice = prep
    b, hd = x.shape
    # int32 partials, the att row scales, x2 (bf16) and a (fp32)
    n_part, n_x2 = ks * b * hd, (b * hd + 1) // 2
    scratch = torch.empty((n_part + 8 + n_x2 + b * f_dim,), dtype=torch.float32,
                          device=x.device)
    ats = scratch[n_part:n_part + 8]
    x2 = scratch[n_part + 8:n_part + 8 + n_x2]
    a = scratch[n_part + 8 + n_x2:]
    out = torch.empty_like(x)
    _build.launch("fused_out_mlp_q8", _ARGTYPES_Q8, x.data_ptr(), att.data_ptr(),
                  wo.q.data_ptr(), w_gate_up.q.data_ptr(), w_down.q.data_ptr(),
                  wo.scale.data_ptr(), w_gate_up.scale.data_ptr(), w_down.scale.data_ptr(),
                  scratch.data_ptr(), ats.data_ptr(), x2.data_ptr(), a.data_ptr(),
                  out.data_ptr(), b, att.shape[1], hd, f_dim, kslice, ks,
                  _pick_block(f_dim), eps, torch.cuda.current_stream(x.device).cuda_stream,
                  device=x.device)
    return out
