"""The port's parity metrics (tts_tpu_torch/parity/compare.py) and F5's
stage functions (`f5_preprocess`, `f5_denoise`) against tts_tpu's, on the
CPU in fp32.

`mel_l1` is numpy on both sides (bitwise); `wav_mel_l1` runs the port's
MelSpectrogram where tts_tpu runs its own: the same fp32 log-mels in
another summation order, so the metrics agree to ~1e-7. F5's stages run
at a small config with tts_tpu's noise injected into the port; the DiT
pass sums in another order and tts_tpu's `f5_denoise` forms each AdaLN
vector from the time embedding where the port reads the precomputed
tables, within 1e-5 relative L2 over the NFE loop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.models import f5 as jf5
from tts_tpu.parity import compare as jcmp
from tts_tpu_torch.models import f5 as tf5
from tts_tpu_torch.parity import compare as tcmp
from tts_tpu_torch.weights.convert import params_from_jax

SMALL = dict(dim=128, depth=2, heads=2, head_dim=64, text_dim=64, conv_layers=1,
             nfe_steps=4, max_signal_len=512, vocab_size=40)
REL_TOL = 1e-5
METRIC_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _signals(kind: str):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(24000).astype(np.float32) * 0.1
    if kind == "same":
        return x, x
    if kind == "int16":
        return x, np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)
    if kind == "scaled":
        return x, 3.0 * x + 0.01 * rng.standard_normal(24000).astype(np.float32)
    if kind == "other":
        return x, rng.standard_normal(20000).astype(np.float32) * 0.1
    # a tone over a faint noise floor: a pure tone leaves most mel bins near
    # the log's 1e-5 clamp, where fp32 rounding of the magnitudes moves the
    # metric by ~6e-4 of its value between the two summation orders
    tone = np.sin(np.linspace(0, 3000, 24000)) * 0.5 + 1e-3 * rng.standard_normal(24000)
    return x, tone.astype(np.float32)


@pytest.mark.parametrize("kind", ["same", "int16", "scaled", "other", "tone"])
def test_wav_mel_l1_matches_tts_tpu(kind):
    a, b = _signals(kind)
    got = tcmp.wav_mel_l1(a, b, device="cpu")
    assert abs(got - jcmp.wav_mel_l1(a, b)) <= METRIC_TOL


@pytest.mark.parametrize("shape", [(1, 50, 100), (2, 7, 80)])
def test_mel_l1_matches_tts_tpu(shape):
    rng = np.random.default_rng(4)
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal((*shape[:-2], shape[-2] + 3, shape[-1])).astype(np.float32)
    assert tcmp.mel_l1(a, b) == jcmp.mel_l1(a, b)


def test_wav_mel_l1_metric():
    """tests/test_parity.py's three behaviours through the port."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(24000).astype(np.float32) * 0.1
    assert tcmp.wav_mel_l1(x, x, device="cpu") < 1e-6
    xi = np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)
    assert tcmp.wav_mel_l1(x, xi, device="cpu") < 1e-2
    y = rng.standard_normal(24000).astype(np.float32) * 0.1
    assert tcmp.wav_mel_l1(x, y, device="cpu") > 1e-1


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (1024, 256)])
def test_stft_kernels_match_torch(n_fft, hop):
    """tests/test_parity.py's limits, at its size and at F5's STFT."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(16384).astype(np.float32) * 0.1
    rep = tcmp.stft_diff_report(x, n_fft=n_fft, hop=hop, device="cpu")
    assert rep["stft_mean_abs_err"] < 1e-5
    assert rep["istft_vs_torch_mean_abs_err"] < 1e-6
    assert rep["roundtrip_mean_abs_err"] < 1e-6


def test_device_default_is_the_card():
    """The metrics run on the card unless asked for the CPU."""
    import inspect

    for fn in (tcmp.wav_mel_l1, tcmp.stft_diff_report):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ---------------------------------------------------------------- F5 stages

@pytest.fixture(scope="module")
def f5():
    jc, tc = jf5.F5Config(**SMALL), tf5.F5Config(**SMALL)
    jp = jf5.init_params(jc, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    rng = np.random.default_rng(7)
    audio = (rng.standard_normal((1, 256 * 30)) * 0.2).astype(np.float32)
    ids = rng.integers(-1, 30, (1, 12)).astype(np.int32)
    ids[0, -3:] = -1
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, audio=audio, ids=ids)


@pytest.mark.parametrize("max_duration", [48, 64])
def test_f5_preprocess_matches_tts_tpu(f5, max_duration):
    jnoise, jcat, jdrop, jref = jf5.f5_preprocess(
        f5["jp"], jnp.asarray(f5["audio"]), jnp.asarray(f5["ids"]), max_duration, f5["jc"],
        jax.random.key(5))
    noise, cat, drop, ref = tf5.f5_preprocess(
        f5["tp"], torch.from_numpy(f5["audio"]), torch.from_numpy(f5["ids"]), max_duration,
        f5["tc"], noise=np.array(jnoise))
    assert ref == jref == 31
    np.testing.assert_array_equal(noise.numpy(), np.asarray(jnoise))
    for got, want in ((cat, jcat), (drop, jdrop)):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= REL_TOL


def test_f5_preprocess_draws_from_its_generator(f5):
    args = (f5["tp"], torch.from_numpy(f5["audio"]), torch.from_numpy(f5["ids"]), 48, f5["tc"])
    a = tf5.f5_preprocess(*args, generator=torch.Generator().manual_seed(3))[0]
    b = tf5.f5_preprocess(*args, generator=torch.Generator().manual_seed(3))[0]
    assert a.shape == (1, 48, 100) and torch.equal(a, b)
    with pytest.raises(ValueError):
        tf5.f5_preprocess(*args)


def test_f5_denoise_matches_tts_tpu(f5):
    jnoise, jcat, jdrop, _ = jf5.f5_preprocess(
        f5["jp"], jnp.asarray(f5["audio"]), jnp.asarray(f5["ids"]), 64, f5["jc"],
        jax.random.key(6))
    want = np.asarray(jf5.f5_denoise(f5["jp"], jnoise, jcat, jdrop, f5["jc"]))
    got = tf5.f5_denoise(f5["tp"], torch.from_numpy(np.array(jnoise)),
                         torch.from_numpy(np.array(jcat)),
                         torch.from_numpy(np.array(jdrop)), f5["tc"])
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= REL_TOL
    # the loop moved the carry: a denoise that returned its noise would pass
    # a loose comparison of two unmoved tensors
    assert _rel(np.asarray(jnoise), want) > 1e-2
