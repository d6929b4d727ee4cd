"""The small helpers the port exports beside tts_tpu's (nn.norm.l2_norm,
nn.rope.apply_rope_interleaved, ops.conv.depthwise_conv1d, the one-shot
audio.stft.stft / istft, quant.weight_only.dequantize), each against
tts_tpu's function on the same seeded inputs on the CPU, fp32, and each
exported from its package's __init__ as in tts_tpu.

Tolerance: atol/rtol 1e-6 (elementwise helpers agree to rounding; the STFT
is an fp32 framed matmul on both sides; dequantize is exact)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = dict(atol=1e-6, rtol=1e-6)
RNG = np.random.default_rng(61)
X = RNG.standard_normal((2, 9, 4, 16)).astype(np.float32)
COS, SIN = (RNG.standard_normal((9, 16)).astype(np.float32) for _ in range(2))
SIG = RNG.standard_normal((2, 1000)).astype(np.float32)
CONV_X = RNG.standard_normal((2, 21, 6)).astype(np.float32)
CONV_W = RNG.standard_normal((5, 1, 6)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cases():
    """name -> (package, attribute, port call, tts_tpu call); each call takes
    the module it runs under."""
    spec = (np.abs(RNG.standard_normal((2, 33, 12))) + 0.1).astype(np.float32)
    phase = RNG.uniform(-3, 3, (2, 33, 12)).astype(np.float32)
    real, imag = spec * np.cos(phase), spec * np.sin(phase)
    w8 = RNG.standard_normal((64, 48)).astype(np.float32)
    return {
        "l2_norm": ("nn", "l2_norm", lambda f: f(_t(X)), lambda f: f(jnp.asarray(X))),
        "apply_rope_interleaved": (
            "nn", "apply_rope_interleaved", lambda f: f(_t(X), _t(COS), _t(SIN)),
            lambda f: f(jnp.asarray(X), jnp.asarray(COS), jnp.asarray(SIN))),
        "depthwise_conv1d": (
            "ops", "depthwise_conv1d", lambda f: f(_t(CONV_X), _t(CONV_W), padding=2),
            lambda f: f(jnp.asarray(CONV_X), jnp.asarray(CONV_W), padding=2)),
        "depthwise_conv1d_lr_stride": (
            "ops", "depthwise_conv1d",
            lambda f: f(_t(CONV_X), _t(CONV_W), stride=2, padding=(4, 0)),
            lambda f: f(jnp.asarray(CONV_X), jnp.asarray(CONV_W), stride=2, padding=(4, 0))),
        "stft": ("audio", "stft", lambda f: torch.stack(f(_t(SIG), 64, 16, 48)),
                 lambda f: jnp.stack(f(jnp.asarray(SIG), 64, 16, 48))),
        "istft": ("audio", "istft", lambda f: f(_t(real), _t(imag), 64, 16),
                  lambda f: f(jnp.asarray(real), jnp.asarray(imag), 64, 16)),
        "dequantize": (
            "quant", "dequantize",
            lambda f: f(importlib.import_module("tts_tpu_torch.quant").quantize_int8_jit(
                _t(w8)), torch.float32),
            lambda f: f(importlib.import_module("tts_tpu.quant").quantize_int8(
                jnp.asarray(w8)), jnp.float32)),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_exported_helper_matches_jax(name):
    pkg, attr, port_call, jax_call = _cases()[name]
    port_fn = getattr(importlib.import_module(f"tts_tpu_torch.{pkg}"), attr)
    jax_fn = getattr(importlib.import_module(f"tts_tpu.{pkg}"), attr)
    assert attr in importlib.import_module(f"tts_tpu_torch.{pkg}").__all__
    got, ref = port_call(port_fn), np.asarray(jax_call(jax_fn))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
