"""Fused BigVGAN AMP resblock (counterpart of
tts_tpu/ops/bigvgan_stage.py:amp_block_fused).

One AMPBlock1 on x (B, T, C): for each dilation branch j,

    x += crop(conv(crop(act(crop(conv(crop(act(x, a1, r1)), w1, b1, d)),
                        a2, r2)), w2, b2, 1))

`act` is the anti-aliased snakebeta in phase space (the two polyphase
streams of the 2x upsample, the snake on each, cropped to [0, T), then the
12-tap decimation split by parity); `conv` is a 'same' conv with taps d
apart; `crop` zeroes everything outside [0, T), which is XLA's per-op zero
padding at the edges.

`amp_block_fused` runs the hand-written CUDA kernel (csrc/amp_block.cu) on
a CUDA tensor and its plain PyTorch twin `amp_block_fused_plain` on a CPU
tensor. Both keep the TPU kernel's rounding points: each act in fp32 (taps
and snake parameters as the kernel sees them), rounded to the dtype once;
each conv accumulated in fp32, rounded, then the bias added in the dtype;
the residual added in the dtype. The CUDA kernel takes bf16 at C <= 256
and fp32 at C <= 128 (`kernel_fits`), launched as "amp_block_fused" and
"amp_block_fused_f32" (each counted under its name).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.filters import AliasFreeResample
from . import _build

__all__ = ["LAUNCHES", "amp_block_fused", "amp_block_fused_plain", "fusable_stage",
           "kernel_fits", "act_plan"]

LAUNCHES = _build.LAUNCHES     # counted under "amp_block_fused" / "amp_block_fused_f32"

_H = 128          # tts_tpu's halo: the chained receptive radius it covers
_S = 32           # tts_tpu's staging margin: the widest conv tap offset
# channels the CUDA kernel's shared-memory tiles take, by dtype
_MAX_C = {torch.bfloat16: 256, torch.float32: 128}
_ENTRY = {torch.bfloat16: "amp_block_fused", torch.float32: "amp_block_fused_f32"}
_MAX_TAPS = 11    # conv width it is built for (odd)
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, out, tmp, w1, b1, w2, b2, a1, r1, a2, r2, taps (24 host floats), dils
# (J host ints), J, B, T, C, K, stream
_ARGTYPES = [_P] * 13 + [_I] * 5 + [_P]


@functools.lru_cache(maxsize=1)
def act_plan() -> tuple[tuple, tuple]:
    """Static (offset, tap) lists of the phase-space anti-aliased act
    (tts_tpu's _act_plan): `up` for the two phase streams (input offsets,
    upsample taps), `dn` for the even and odd phase streams (offsets into
    them, decimation taps), each in tts_tpu's summation order."""
    rs = AliasFreeResample(2)
    k, kp = rs.kernel_size, rs.kernel_size // 2
    wu, wd = rs.up_filter, rs.down_filter
    up = []
    for p in (0, 1):
        r = (p + rs.up_crop_left) % 2
        o = (p + rs.up_crop_left - r) // 2 - rs.up_pad
        up.append(tuple((o - m, float(wu[r + 2 * m])) for m in range(kp) if r + 2 * m < k))
    dn = ([], [])
    for kk in range(k):
        i0 = kk - rs.down_pad_left
        if i0 % 2 == 0:
            dn[0].append((i0 // 2, float(wd[kk])))
        else:
            dn[1].append(((i0 - 1) // 2, float(wd[kk])))
    return tuple(up), tuple(tuple(d) for d in dn)


def fusable_stage(c: int, t: int, dtype, device=None) -> bool:
    """tts_tpu's gate: C <= 256 in bf16, C <= 128 in fp32, T of at least one
    tile (256). On a CUDA device the kernel's own limits are added
    (`kernel_fits`: C a multiple of 8)."""
    if dtype == torch.bfloat16:
        cmax = 256
    elif dtype == torch.float32:
        cmax = 128
    else:
        return False
    ok = c <= cmax and t >= 256
    if device is not None and torch.device(device).type == "cuda":
        ok = ok and kernel_fits(c, dtype)
    return ok


def kernel_fits(c: int, dtype) -> bool:
    """Whether the CUDA kernel takes C channels of `dtype`: C a multiple of 8
    (16-byte row loads), at most 256 in bf16 and 128 in fp32 (its
    shared-memory tiles)."""
    return dtype in _MAX_C and c <= _MAX_C[dtype] and c % 8 == 0


def _check(x, w1, b1, w2, b2, a1, r1, a2, r2, k: int, dils: tuple) -> None:
    """tts_tpu's geometry guards and the operand shapes (both paths)."""
    mid = (k - 1) // 2
    if mid * max(dils) > _S:
        raise ValueError(f"amp_block_fused: conv tap offset {mid * max(dils)} "
                         f"(k={k}, dils={dils}) exceeds staging margin {_S}")
    radius = sum(12 + mid * d + mid for d in dils)
    if radius > _H:
        raise ValueError(f"amp_block_fused: chained receptive radius {radius} "
                         f"(k={k}, dils={dils}) exceeds halo {_H}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    c, j = x.shape[2], len(dils)
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != (j, k, c, c):
            raise ValueError(f"{name} {tuple(w.shape)} != {(j, k, c, c)}")
    for name, v in (("b1", b1), ("b2", b2), ("a1", a1), ("r1", r1), ("a2", a2),
                    ("r2", r2)):
        if tuple(v.shape) != (j, c):
            raise ValueError(f"{name} {tuple(v.shape)} != {(j, c)}")


# --------------------------------------------------------------------------
# plain twin

def _shift(u: torch.Tensor, off: int) -> torch.Tensor:
    """u[:, t + off] over t in [0, T), zero outside [0, T)."""
    if off == 0:
        return u
    t = u.shape[1]
    if off > 0:
        return F.pad(u[:, off:], (0, 0, 0, min(off, t)))[:, :t]
    return F.pad(u[:, :t + off], (0, 0, min(-off, t), 0))[:, :t]


def _act(u: torch.Tensor, alpha: torch.Tensor, recip: torch.Tensor) -> torch.Tensor:
    """The phase-space anti-aliased snakebeta in fp32, rounded once."""
    up, dn = act_plan()
    uf = u.float()
    ph = []
    for taps in up:
        acc = None
        for off, tap in taps:
            term = _shift(uf, off) * tap
            acc = term if acc is None else acc + term
        s = torch.sin(alpha * acc)
        ph.append(acc + recip * (s * s))
    out = None
    for src, taps in zip(ph, dn):
        for off, tap in taps:
            term = _shift(src, off) * tap
            out = term if out is None else out + term
    return out.to(u.dtype)


def _conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """'same' conv with taps d apart, w (k, C_in, C_out): fp32 accumulation,
    rounded to u's dtype, then the bias added in that dtype."""
    k = w.shape[0]
    pad = (k - 1) // 2 * d
    y = F.conv1d(F.pad(u.float().transpose(1, 2), (pad, pad)),
                 w.to(u.dtype).float().permute(2, 1, 0), dilation=d)
    return y.transpose(1, 2).to(u.dtype) + b.to(u.dtype)


def amp_block_fused_plain(x, w1, b1, w2, b2, a1, r1, a2, r2, *, k: int,
                          dils: tuple[int, ...]) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: same contract, same rounding points.
    The snake parameters are rounded to x's dtype first, as the TPU kernel
    receives them."""
    _check(x, w1, b1, w2, b2, a1, r1, a2, r2, k, tuple(dils))
    dt = x.dtype

    def par(v, j):
        return v[j].to(dt).float()

    xcur = x
    for j, d in enumerate(dils):
        t1 = _act(xcur, par(a1, j), par(r1, j))
        t2 = _conv(t1, w1[j], b1[j], d)
        t3 = _act(t2, par(a2, j), par(r2, j))
        xcur = xcur + _conv(t3, w2[j], b2[j], 1)
    return xcur


# --------------------------------------------------------------------------
# CUDA kernel

@functools.lru_cache(maxsize=1)
def _kernel_taps():
    """The act's 24 taps as a host fp32 array, in the kernel's order: the two
    upsample phases (6 each, offsets 2..-3 and 3..-2), then the even and odd
    decimation taps (6 each, offsets -2..3 and -3..2)."""
    up, dn = act_plan()
    want_up = ((2, 1, 0, -1, -2, -3), (3, 2, 1, 0, -1, -2))
    want_dn = ((-2, -1, 0, 1, 2, 3), (-3, -2, -1, 0, 1, 2))
    if tuple(tuple(o for o, _ in t) for t in up) != want_up or \
            tuple(tuple(o for o, _ in t) for t in dn) != want_dn:
        raise AssertionError("the act's tap offsets are not the kernel's")
    vals = np.asarray([tap for taps in up + dn for _, tap in taps], np.float32)
    return (ctypes.c_float * 24)(*vals.tolist())


def amp_block_fused(x: torch.Tensor, w1, b1, w2, b2, a1, r1, a2, r2, *, k: int,
                    dils: tuple[int, ...]) -> torch.Tensor:
    """One AMPBlock1 on x (B, T, C). w1/w2 (J, k, C_in, C_out) conv stacks
    (convs1 dilated, convs2 dilation 1); b1/b2 (J, C); a1/r1/a2/r2 (J, C)
    snake alpha / reciprocal pairs (acts1, acts2); J = len(dils)."""
    dils = tuple(int(d) for d in dils)
    _check(x, w1, b1, w2, b2, a1, r1, a2, r2, k, dils)
    if not x.is_contiguous():
        # checked on every device, so the CPU tests catch what the card refuses
        raise ValueError("x must be contiguous")
    if x.device.type == "cpu":
        return amp_block_fused_plain(x, w1, b1, w2, b2, a1, r1, a2, r2, k=k, dils=dils)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    bsz, t, c = x.shape
    if not kernel_fits(c, x.dtype):
        raise TypeError(f"the CUDA kernel takes bf16 x with at most 256 channels or "
                        f"fp32 with at most 128, C a multiple of 8; got {x.dtype} with {c}")
    if k % 2 == 0 or k > _MAX_TAPS:
        raise ValueError(f"the CUDA kernel takes an odd width <= {_MAX_TAPS}, got {k}")
    ops = {"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2, "a1": a1, "r1": r1,
           "a2": a2, "r2": r2}
    for name, a in ops.items():
        if a.dtype != x.dtype or a.device != x.device:
            raise TypeError(f"the CUDA kernel takes {x.dtype} tensors on {x.device}; "
                            f"{name} is {a.dtype} on {a.device}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    cp = -(-c // 16) * 16
    if cp != c:
        # the kernel's tiles read 16 channels at a time: zero-pad the
        # weights to a multiple of 16 in and out
        w1 = F.pad(w1, (0, cp - c, 0, cp - c))
        w2 = F.pad(w2, (0, cp - c, 0, cp - c))
    out = torch.empty_like(x)
    # branches ping-pong between out and tmp: a CTA's halo reads rows that
    # its neighbours write
    tmp = torch.empty_like(x) if len(dils) > 1 else out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # the dilations go as a host array: the C entry sizes each branch's
    # halo and shared memory from them
    _build.launch(_ENTRY[x.dtype], _ARGTYPES, x.data_ptr(), out.data_ptr(),
                  tmp.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  a1.data_ptr(), r1.data_ptr(), a2.data_ptr(), r2.data_ptr(),
                  _kernel_taps(), (ctypes.c_int * len(dils))(*dils),
                  len(dils), bsz, t, c, k, stream, device=x.device)
    return out
