"""The port's host tables are tts_tpu's bit for bit, and its STFT, ISTFT
and log-mel agree with tts_tpu's on the same numpy input.

Tolerance for the DSP outputs: both sides run the same fp32 products on
the same bases, only in another summation order. The log-mel and the
waveform take atol 1e-5; the raw spectra, 1024-term sums whose partial
sums reach ~10, take atol 3e-5 with rtol 1e-5 (fp32 rounding of such a
sum is ~1e-5 in either order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.audio import mel as jmel
from tts_tpu.audio import windows as jwin
from tts_tpu.audio.stft import IstftKernel as JIstft
from tts_tpu.audio.stft import StftKernel as JStft
from tts_tpu.models import f5 as jf5
from tts_tpu.nn import rope as jrope
from tts_tpu_torch.audio import mel as tmel
from tts_tpu_torch.audio import stft as tstft
from tts_tpu_torch.audio import windows as twin
from tts_tpu_torch.models import f5 as tf5
from tts_tpu_torch.nn import rope as trope


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["hann", "hamming", "bartlett", "blackman",
                                  "kaiser", "other"])
def test_windows_equal(kind):
    for n in (1, 7, 400, 1024):
        np.testing.assert_array_equal(twin.make_window(kind, n),
                                      jwin.make_window(kind, n))
    for win, n_fft in ((1024, 1024), (800, 1024), (1024, 800)):
        np.testing.assert_array_equal(twin.padded_window(kind, win, n_fft),
                                      jwin.padded_window(kind, win, n_fft))


@pytest.mark.parametrize("norm,scale", [(None, "htk"), ("slaney", "slaney")])
def test_mel_filterbank_equal(norm, scale):
    args = (513, 0.0, 12000.0, 100, 24000, norm, scale)
    np.testing.assert_array_equal(tmel.mel_filterbank(*args),
                                  jmel.mel_filterbank(*args))


@pytest.mark.parametrize("n_fft,hop,win", [(1024, 256, 1024), (400, 160, 320)])
def test_stft_bases_equal(n_fft, hop, win):
    np.testing.assert_array_equal(tstft.StftKernel(n_fft, hop, win).basis,
                                  JStft(n_fft, hop, win).basis)
    ti, ji = tstft.IstftKernel(n_fft, hop, win), JIstft(n_fft, hop, win)
    np.testing.assert_array_equal(ti.basis, ji.basis)
    np.testing.assert_array_equal(ti.win_sq, ji.win_sq)
    np.testing.assert_array_equal(ti._window_sum_inv(37), ji._window_sum_inv(37))


def test_f5_tables_equal():
    ts_t, dts_t = tf5.f5_time_schedule(32, -1.0)
    ts_j, dts_j = jf5.f5_time_schedule(32, -1.0)
    np.testing.assert_array_equal(ts_t, ts_j)
    np.testing.assert_array_equal(dts_t, dts_j)
    rng = np.random.default_rng(0)
    w1 = rng.standard_normal((256, 64)).astype(np.float32) * 0.02
    w2 = rng.standard_normal((64, 64)).astype(np.float32) * 0.02
    b = np.zeros(64, np.float32)
    np.testing.assert_array_equal(tf5.f5_time_embed_table(ts_t, w1, b, w2, b),
                                  jf5.f5_time_embed_table(ts_j, w1, b, w2, b))
    np.testing.assert_array_equal(tf5.hs_perm(64), jf5.hs_perm(64))
    for a, b_ in zip(tf5.f5_rope_tables(4096, 64), jf5.f5_rope_tables(4096, 64)):
        np.testing.assert_array_equal(a, b_)
    for a, b_ in zip(trope.rope_table_interleaved(512, 32),
                     jrope.rope_table_interleaved(512, 32)):
        np.testing.assert_array_equal(a, b_)
    np.testing.assert_array_equal(tf5._text_freqs_cis(512, 4096),
                                  jf5._text_freqs_cis(512, 4096))


def _audio(n, seed=0):
    return (np.random.default_rng(seed).standard_normal((2, n)) * 0.3
            ).astype(np.float32)


@pytest.mark.parametrize("pad_mode", ["reflect", "constant"])
def test_stft_matches_jax(pad_mode):
    x = _audio(6000)
    re_t, im_t = tstft.StftKernel(1024, 256, 1024)(torch.from_numpy(x), pad_mode)
    re_j, im_j = JStft(1024, 256, 1024)(jnp.asarray(x), pad_mode=pad_mode)
    np.testing.assert_allclose(re_t.numpy(), np.asarray(re_j), atol=3e-5, rtol=1e-5)
    np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), atol=3e-5, rtol=1e-5)


def test_istft_matches_jax():
    rng = np.random.default_rng(1)
    mag = np.exp(rng.standard_normal((1, 513, 40))).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (1, 513, 40)).astype(np.float32)
    out_t = tstft.IstftKernel(1024, 256, 1024).from_mag_phase(
        torch.from_numpy(mag), torch.from_numpy(phase))
    out_j = JIstft(1024, 256, 1024).from_mag_phase(
        jnp.asarray(mag), jnp.asarray(phase))
    assert out_t.shape == (1, 39 * 256)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=0)


def test_log_mel_matches_jax():
    x = _audio(24000, seed=2)
    out_t = tmel.MelSpectrogram(24000, 1024, 256, 1024, 100)(torch.from_numpy(x))
    out_j = jmel.MelSpectrogram(24000, 1024, 256, 1024, 100)(jnp.asarray(x))
    assert out_t.shape == (2, 24000 // 256 + 1, 100)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=0)
