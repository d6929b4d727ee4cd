"""W8A8 matmuls (counterparts of tts_tpu/ops/quant_matmul.py): the bare
int8 matmul `quantized_matmul` (kernel 9) and the F5 DiT attention's two
projections, `ln_qkv_q8` (kernel 7) and `out_proj_residual_q8` (kernel 8).

Each wrapper runs the hand-written CUDA kernel (csrc/quant_matmul.cu, on the
int8 core of csrc/q8_core.cuh; kernel 7's GEMM on the s8 wgmma GEMM of
csrc/q8_wgmma.cuh, in the form `q8_plan` picks) on a CUDA tensor and its
plain PyTorch twin on a CPU tensor. Both compute the TPU kernels' contract:
each row of the activations quantized to int8 with xs = max(amax, 1e-8) *
f32(1/127) and q = clip(round_half_even(v / xs), -127, 127); the s8 x s8
product summed exactly in integers and converted to fp32; the rescale
((acc * xs) * ws + b) in fp32; the tails below in their dtypes. The twins compute the
integer product as a float64 matmul of the int8 values, exact below 2^53.

The weights are tts_tpu's int8 QTensor parts: q (K, N) int8, scale (N,)
fp32, per output channel. The s8 wgmma GEMM reads its weight K-major: on a
card, kernel 7's q is the (K, N) view of (N, K) storage (`to_kmajor`, which
runtime/f5.quantize_dit applies once), and the wrapper refuses any other
layout rather than transpose the weight for a call. Kernels 7 and 8 take bf16 or fp32 activations
(`activation_dtype`) and write their dtype, as tts_tpu's kernels do;
kernel 9 takes bf16.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["quantized_matmul", "quantized_matmul_plain", "ln_qkv_q8",
           "ln_qkv_q8_plain", "out_proj_residual_q8", "out_proj_residual_q8_plain",
           "quantize_rows", "int_dot", "q8_fits", "activation_dtype", "check_cuda_args",
           "row_scratch", "kmajor", "to_kmajor", "Q8Plan", "q8_plan"]

_INV_127 = 1.0 / 127.0     # taken to fp32 where it multiplies: float32(1/127)
_P, _I = ctypes.c_void_p, ctypes.c_int
_K_TILE, _N_TILE, _K_MAX = 64, 128, 2048   # the CUDA kernels' depth step, column
                                           # tile and the longest row they quantize
_ACT_DTYPES = (torch.bfloat16, torch.float32)   # what the W8A8 kernels read and write
_WM, _WN, _WK = 128, 128, 128   # the s8 wgmma GEMM's CTA rows and columns, K step
_MAX_CLUSTER = 16     # the H100's non-portable thread-block cluster limit
_MAX_OFFSET = 1 << 32   # the s8 wgmma GEMM's copies index its operands in 32 bits


def quantize_rows(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 rows -> (int8 values as fp32, per-row scale (..., 1) fp32)."""
    amax = v.abs().amax(dim=-1, keepdim=True)
    xs = torch.clamp(amax, min=1e-8) * torch.tensor(_INV_127, dtype=torch.float32)
    return torch.clamp(torch.round(v / xs), -127, 127), xs


def int_dot(q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8-valued q (..., K) and w_q (K, N),
    converted to fp32 (round to nearest, as the kernels' and the TPU's)."""
    return (q.double() @ w_q.double()).float()


def _layer_norm_mod(x: torch.Tensor, shift: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """LayerNorm (eps 1e-6, no affine) * (1 + scale) + shift, all fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + 1e-6) * (1 + scale.float()) + shift.float()


def quantized_matmul_plain(x, w_q, w_scale) -> torch.Tensor:
    q, xs = quantize_rows(x.float())
    return (int_dot(q, w_q) * xs * w_scale.float()).to(x.dtype)


def ln_qkv_q8_plain(x, mods, w_q, w_scale, b) -> torch.Tensor:
    """Plain PyTorch twin of kernel 7."""
    q, xs = quantize_rows(_layer_norm_mod(x, mods[0], mods[1]))
    return (int_dot(q, w_q) * xs * w_scale.float() + b.float()).to(x.dtype)


def out_proj_residual_q8_plain(o, w_q, w_scale, b, gate, x_res) -> torch.Tensor:
    q, xs = quantize_rows(o.float())
    y = int_dot(q, w_q) * xs * w_scale.float() + b.float()
    dt = x_res.dtype
    return x_res + gate.to(dt) * y.to(dt)


def q8_fits(k: int, n: int) -> bool:
    """Whether the CUDA kernels take a (K, N) int8 weight: K % 64 == 0,
    K <= 2048 (the row kernel stages 4 rows of K fp32 in 48 KB of shared
    memory) and N % 128 == 0."""
    return k % _K_TILE == 0 and k <= _K_MAX and n % _N_TILE == 0


class Q8Plan(NamedTuple):
    """The form of one s8 wgmma GEMM (csrc/q8_wgmma.cuh), in CTAs of 128 x
    128 outputs."""
    stages: int    # K steps in the shared-memory ring: 4 (1 CTA an SM) or 3 (2 an SM)
    cluster: int   # CTAs of a thread-block cluster across the columns (1: none)


@functools.lru_cache(maxsize=None)     # a request repeats a few shapes 682 times
def q8_plan(rows: int, n: int, k: int, sms: int, whole_rows: bool = False) -> Q8Plan:
    """The form of the s8 wgmma GEMM with `rows` x `n` outputs over depth
    `k` on a card of `sms` SMs, for a weight `q8_fits` admits and operands
    of fewer than 2^32 values (ValueError otherwise). A GEMM with a bias or
    residual epilogue (kernel 7, kernel 6's ff2) whose grid fits one CTA an
    SM takes a 4-stage ring, one CTA an SM; a larger grid 3 stages, two
    CTAs an SM, so that one CTA's epilogue and copies overlap the other's
    products (on an H100 each form is the faster on its side: PERF.md §6).
    With `whole_rows` (kernel 6's ff1, whose epilogue quantizes each output
    row whole) one thread-block cluster spans the n columns: n / 128 <= 16
    CTAs (past 8 the non-portable size the H100 allows), 3 stages, two CTAs
    an SM."""
    if not q8_fits(k, n) or rows < 1 or rows * k >= _MAX_OFFSET or n * k >= _MAX_OFFSET:
        raise ValueError(f"no s8 wgmma GEMM form for rows {rows}, depth {k}, width {n}")
    col_tiles = n // _WN
    if whole_rows:
        if col_tiles > _MAX_CLUSTER:
            raise ValueError(f"a cluster of {col_tiles} CTAs exceeds {_MAX_CLUSTER}")
        return Q8Plan(3, col_tiles)
    return Q8Plan(4 if -(-rows // _WM) * col_tiles <= sms else 3, 1)


def activation_dtype(**acts: torch.Tensor) -> torch.dtype:
    """The one dtype of the named activation tensors of a W8A8 kernel call,
    bf16 or fp32 (the CUDA kernels are built for both); TypeError for
    mixed dtypes or any other."""
    dts = {a.dtype for a in acts.values()}
    if len(dts) != 1 or next(iter(dts)) not in _ACT_DTYPES:
        got = ", ".join(f"{name} {a.dtype}" for name, a in acts.items())
        raise TypeError(f"the W8A8 kernels take activations of one dtype, bf16 or "
                        f"fp32; got {got}")
    return dts.pop()


def check_cuda_args(ref: torch.Tensor, k: int, n: int, **tensors) -> None:
    """The CUDA kernels' constraints: every tensor on ref's card, contiguous
    and 16-byte aligned, of its listed dtype; a weight shape `q8_fits`
    admits."""
    for name, (a, dtype) in tensors.items():
        if a.device != ref.device or a.dtype != dtype:
            raise TypeError(f"the CUDA kernel takes {name} as {dtype} on "
                            f"{ref.device}; got {a.dtype} on {a.device}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not q8_fits(k, n):
        raise ValueError(f"depth {k} must be a multiple of {_K_TILE} up to {_K_MAX}, "
                         f"and width {n} a multiple of {_N_TILE}")


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type


def _fp32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32).contiguous()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def to_kmajor(w_q: torch.Tensor) -> torch.Tensor:
    """The same (K, N) int8 weight, stored K-major: the (K, N) view of an
    (N, K) contiguous copy, the layout kernels 7 and 6 read on a card."""
    return w_q.t().contiguous().t()


def kmajor(w_q: torch.Tensor) -> torch.Tensor:
    """The (N, K) storage under a K-major (K, N) weight, as the s8 wgmma
    GEMM reads it; ValueError for any other layout."""
    wt = w_q.t()
    if not wt.is_contiguous():
        raise ValueError(f"the s8 wgmma GEMM reads its int8 weight K-major; got w_q "
                         f"{tuple(w_q.shape)} with strides {w_q.stride()} (lay it out "
                         f"once with to_kmajor, as runtime/f5.quantize_dit does)")
    return wt


def row_scratch(x: torch.Tensor, m: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' int8 rows (m, k) and their fp32 scales (m,) on x's card."""
    return (torch.empty((m, k), dtype=torch.int8, device=x.device),
            torch.empty((m,), dtype=torch.float32, device=x.device))


def quantized_matmul(x: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) float -> x @ (w_q * w_scale) through int8: w_q (K, N) int8,
    w_scale (N,) fp32. Returns (M, N) in x's dtype."""
    m, k = x.shape
    n = w_q.shape[1]
    if w_q.shape != (k, n) or w_scale.shape != (n,):
        raise ValueError(f"w_q {tuple(w_q.shape)} / w_scale {tuple(w_scale.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if _device_of(x) == "cpu":
        return quantized_matmul_plain(x, w_q, w_scale)
    ws = _fp32(w_scale)
    check_cuda_args(x, k, n, x=(x, torch.bfloat16), w_q=(w_q, torch.int8),
                    w_scale=(ws, torch.float32))
    xq, xs = row_scratch(x, m, k)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _build.launch("quantized_matmul", [_P] * 6 + [_I] * 3 + [_P],
                  x.data_ptr(), w_q.data_ptr(), ws.data_ptr(), xq.data_ptr(),
                  xs.data_ptr(), out.data_ptr(), m, k, n, _stream(x), device=x.device)
    return out


def ln_qkv_q8(x: torch.Tensor, mods: torch.Tensor, w_q: torch.Tensor,
              w_scale: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B, T, D); mods (2, D) = [shift, scale]; w_q (D, N) int8, K-major
    on a card (`to_kmajor`), with per-column fp32 w_scale (N,); b (N,).
    Returns dense(LN(x) * (1 + scale) + shift) + b as (B, T, N) in x's
    dtype."""
    bsz, t, d = x.shape
    n = w_q.shape[1]
    if mods.shape != (2, d) or w_q.shape != (d, n) or w_scale.shape != (n,) \
            or b.shape != (n,):
        raise ValueError(f"mods {tuple(mods.shape)}, w_q {tuple(w_q.shape)}, "
                         f"w_scale {tuple(w_scale.shape)}, b {tuple(b.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if _device_of(x) == "cpu":
        return ln_qkv_q8_plain(x, mods, w_q, w_scale, b)
    dt = activation_dtype(x=x)
    mods, ws, bias, wt = _fp32(mods), _fp32(w_scale), _fp32(b), kmajor(w_q)
    check_cuda_args(x, d, n, x=(x, dt), w_qt=(wt, torch.int8),
                    mods=(mods, torch.float32), w_scale=(ws, torch.float32),
                    b=(bias, torch.float32))
    m = bsz * t
    plan = q8_plan(m, n, d, _build.sm_count(x.device))
    xq, xs = row_scratch(x, m, d)
    out = torch.empty((bsz, t, n), dtype=x.dtype, device=x.device)
    _build.launch("ln_qkv_q8", [_P] * 8 + [_I] * 5 + [_P],
                  x.data_ptr(), mods.data_ptr(), wt.data_ptr(), ws.data_ptr(),
                  bias.data_ptr(), xq.data_ptr(), xs.data_ptr(), out.data_ptr(),
                  m, d, n, int(dt == torch.float32), plan.stages, _stream(x),
                  device=x.device)
    return out


def out_proj_residual_q8(o: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                         b: torch.Tensor, gate: torch.Tensor,
                         x_res: torch.Tensor) -> torch.Tensor:
    """o (B, T, HD) attention output; w_q (HD, D) int8 + fp32 w_scale (D,);
    b (D,); gate (D,); x_res (B, T, D). Returns x_res + gate * (o @ w + b)
    in x_res's dtype."""
    bsz, t, hd = o.shape
    d = w_q.shape[1]
    if w_q.shape != (hd, d) or x_res.shape != (bsz, t, d) or w_scale.shape != (d,) \
            or b.shape != (d,) or gate.shape != (d,):
        raise ValueError(f"w_q {tuple(w_q.shape)}, w_scale {tuple(w_scale.shape)}, "
                         f"b {tuple(b.shape)}, gate {tuple(gate.shape)}, x_res "
                         f"{tuple(x_res.shape)} do not fit o {tuple(o.shape)}")
    if _device_of(o) == "cpu":
        return out_proj_residual_q8_plain(o, w_q, w_scale, b, gate, x_res)
    dt = activation_dtype(o=o, x_res=x_res)
    ws, bias, g = _fp32(w_scale), _fp32(b), _fp32(gate)
    check_cuda_args(o, hd, d, o=(o, dt), w_q=(w_q, torch.int8),
                    w_scale=(ws, torch.float32), b=(bias, torch.float32),
                    gate=(g, torch.float32), x_res=(x_res, dt))
    xq, xs = row_scratch(o, bsz * t, hd)
    out = torch.empty_like(x_res)
    _build.launch("out_proj_residual_q8", [_P] * 9 + [_I] * 4 + [_P],
                  o.data_ptr(), w_q.data_ptr(), ws.data_ptr(), bias.data_ptr(),
                  g.data_ptr(), x_res.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                  out.data_ptr(), bsz * t, hd, d, int(dt == torch.float32), _stream(o),
                  device=o.device)
    return out
