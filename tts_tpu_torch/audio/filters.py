"""Kaiser-windowed sinc low-pass filters and anti-aliased 2x resampling
(counterpart of tts_tpu/audio/filters.py).

`kaiser_sinc_filter` is tts_tpu's numpy design, copied. `AliasFreeResample`
keeps tts_tpu's polyphase forms on (B, T, C) tensors: `upsample` (zero-pad,
zero-stuffed transposed depthwise conv, crop, as R polyphase branches of
shifted scalar multiply-adds), `downsample` (strided depthwise conv over the
R-phase reshape) and `alias_free_act`, the fused upsample -> act ->
downsample in phase space that BigVGAN's plain chain runs. Every tap is
the filter value rounded to the activation dtype, and every product and sum
is one op in that dtype, in tts_tpu's order: `upsample` + `downsample` agree
with `alias_free_act` only to rounding.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["kaiser_sinc_filter", "AliasFreeResample"]


@functools.lru_cache(maxsize=32)
def kaiser_sinc_filter(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Length-`kernel_size` zero-phase low-pass, normalized to unit DC gain."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * np.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return torch.tensor(value, dtype=dtype).item()


def _tap(value: float, like: torch.Tensor) -> float:
    """A filter tap rounded to the activation's dtype (tts_tpu's
    jnp.asarray(tap, x.dtype)), as a Python float: the product of two values
    of that dtype, taken in fp32 and rounded once, is the dtype's own
    product, and no 0-d tensor goes to the device per tap."""
    return _rounded(value, like.dtype)


class AliasFreeResample:
    """2x (or Rx) up/down resampling pair used around snake activations."""

    def __init__(self, ratio: int = 2, kernel_size: int | None = None):
        self.ratio = ratio
        self.kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        filt = kaiser_sinc_filter(0.5 / ratio, 0.6 / ratio, self.kernel_size)
        self.up_filter = filt * ratio
        self.down_filter = filt
        # torch-equivalent crop amounts for the transposed conv
        self.up_pad = self.kernel_size // ratio - 1
        self.up_crop_left = self.up_pad * ratio + (self.kernel_size - ratio) // 2
        self.up_crop_right = self.up_pad * ratio + (self.kernel_size - ratio + 1) // 2
        self.down_pad_left = self.kernel_size // 2 - (1 if self.kernel_size % 2 == 0 else 0)
        self.down_pad_right = self.kernel_size // 2

    def upsample(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) -> (B, R*T, C): y_full[R*u + r] = sum_m xp[u - m] *
        w[r + R*m] over the padded input, interleaved, then cropped."""
        r_, k = self.ratio, self.kernel_size
        kp = -(-k // r_)
        xp = F.pad(x, (0, 0, self.up_pad + kp - 1, self.up_pad + kp - 1))
        tp = x.shape[1] + 2 * self.up_pad
        u_len = tp + kp - 1
        phases = []
        for r in range(r_):
            acc = None
            for m in range(kp):
                if r + r_ * m >= k:
                    break
                term = xp[:, kp - 1 - m:kp - 1 - m + u_len] * _tap(
                    float(self.up_filter[r + r_ * m]), x)
                acc = term if acc is None else acc + term
            phases.append(acc)
        y = torch.stack(phases, dim=2).reshape(x.shape[0], u_len * r_, x.shape[-1])
        y = y[:, :(tp - 1) * r_ + k]
        return y[:, self.up_crop_left:y.shape[1] - self.up_crop_right]

    def downsample(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) -> (B, T//R, C): y[t] = sum_{r,m} Z_r[t+m] * w[r + R*m]
        with Z_r[u] = xp[u*R + r]."""
        r_, k = self.ratio, self.kernel_size
        kp = -(-k // r_)
        xp = F.pad(x, (0, 0, self.down_pad_left, self.down_pad_right))
        tp = xp.shape[1]
        t_out = (tp - k) // r_ + 1
        u_len = t_out + kp
        xp = F.pad(xp, (0, 0, 0, max(0, u_len * r_ - tp)))
        z = xp[:, :u_len * r_].reshape(x.shape[0], u_len, r_, x.shape[-1])
        acc = None
        for r in range(r_):
            for m in range(kp):
                if r + r_ * m >= k:
                    break
                term = z[:, m:m + t_out, r] * _tap(float(self.down_filter[r + r_ * m]), x)
                acc = term if acc is None else acc + term
        return acc

    def alias_free_act(self, x: torch.Tensor, act) -> torch.Tensor:
        """upsample -> act -> downsample without the 2x-rate signal: the two
        upsample phase streams (the even and odd samples of the 2x signal)
        stay apart, `act` runs on each, and the decimating taps split by the
        parity of the 2x index they read. Ratio 2 only; other ratios take
        the unfused pair."""
        if self.ratio != 2:
            return self.downsample(act(self.upsample(x)))
        k, kp, t = self.kernel_size, -(-self.kernel_size // 2), x.shape[1]
        wu, wd = self.up_filter, self.down_filter

        def phase(p):
            # E/O[t] = y_up[2t + p] = sum_m x[t + o - m] * wu[r + 2m]
            r = (p + self.up_crop_left) % 2
            o = (p + self.up_crop_left - r) // 2 - self.up_pad
            lo, hi = o - (kp - 1), o
            xp = F.pad(x, (0, 0, max(0, -lo), max(0, hi)))
            base = max(0, -lo) + o
            acc = None
            for m in range(kp):
                if r + 2 * m >= k:
                    break
                term = xp[:, base - m:base - m + t] * _tap(float(wu[r + 2 * m]), x)
                acc = term if acc is None else acc + term
            return acc

        se, so = act(phase(0)), act(phase(1))
        # y[t] = sum_k' s[2t + k' - dpl] * wd[k'] with s[2u] = se[u],
        # s[2u+1] = so[u], zero outside [0, 2T) (act(0) = 0 for the snakes)
        dpl = self.down_pad_left
        offs = [((i0 // 2 if i0 % 2 == 0 else (i0 - 1) // 2), i0 % 2, kk)
                for kk, i0 in ((kk, kk - dpl) for kk in range(k))]
        pad_l = max(0, -min(e for e, _, _ in offs))
        pad_r = max(0, max(e for e, _, _ in offs))
        sep = F.pad(se, (0, 0, pad_l, pad_r))
        sop = F.pad(so, (0, 0, pad_l, pad_r))
        acc = None
        for e, parity, kk in offs:
            src = sop if parity else sep
            term = src[:, pad_l + e:pad_l + e + t] * _tap(float(wd[kk]), x)
            acc = term if acc is None else acc + term
        return acc
