"""The port's WAV I/O (tts_tpu_torch/audio/wav.py) and native host audio
helpers (tts_tpu_torch/native) against tts_tpu's, on the CPU.

tests/test_wav_io.py's cases run here against the port's module, each also
held bit for bit against tts_tpu's result on the same file or samples; the
native C helpers (built into tts_tpu_torch/_build/native) against their
numpy twins."""
import math
import stat
import sys

import numpy as np
import pytest

import tts_tpu.audio.wav as jwav
import tts_tpu_torch.audio.wav as twav
from tests.test_wav_io import _make_wav
from tts_tpu_torch import native


@pytest.fixture
def sine_i16():
    t = np.arange(2400) / 24000.0
    return (0.5 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16)


def _both(fn_name, *args, **kw):
    """The port's and tts_tpu's function of that name on the same arguments;
    the results must agree exactly."""
    got = getattr(twav, fn_name)(*args, **kw)
    ref = getattr(jwav, fn_name)(*args, **kw)
    if isinstance(got, tuple):
        assert got[1] == ref[1]
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[0].dtype == ref[0].dtype
    else:
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype
    return got


def _pcm24(x16):
    v24 = x16.astype(np.int32) << 8
    b = np.zeros((len(v24), 3), np.uint8)
    b[:, 0], b[:, 1], b[:, 2] = v24 & 0xFF, (v24 >> 8) & 0xFF, (v24 >> 16) & 0xFF
    return b.tobytes()


# each layout: (fmt tag, bits, data from the int16 sine, channels, WAVEX, the
# largest |difference| from the sine the reader may return)
LAYOUTS = {
    "float32": (3, 32, lambda s: (0.5 * np.sin(2 * np.pi * 440 * np.arange(2400) / 24000.0)
                                  ).astype(np.float32).tobytes(), 1, False, 1),
    "float64": (3, 64, lambda s: (0.5 * np.sin(2 * np.pi * 440 * np.arange(2400) / 24000.0)
                                  ).astype(np.float64).tobytes(), 1, False, 1),
    "pcm8": (1, 8, lambda s: ((s.astype(np.int32) >> 8) + 128).astype(np.uint8).tobytes(),
             1, False, 255),
    "pcm16": (1, 16, lambda s: s.tobytes(), 1, False, 0),
    "pcm24": (1, 24, _pcm24, 1, False, 0),
    "pcm32": (1, 32, lambda s: (s.astype(np.int32) << 16).tobytes(), 1, False, 0),
    "wavex_stereo": (1, 16, lambda s: np.stack([s, s], 1).reshape(-1).tobytes(), 2, True, 0),
    "wavex_float32": (3, 32, lambda s: (s.astype(np.float32) / 32767.0).tobytes(), 1, True, 1),
    "three_channels": (1, 16, lambda s: np.stack([s, s, s], 1).reshape(-1).tobytes(), 3,
                       False, 0),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_read_wav_layouts(tmp_path, sine_i16, layout):
    tag, bits, data, ch, wavex, tol = LAYOUTS[layout]
    path = str(tmp_path / "a.wav")
    _make_wav(path, tag, bits, data(sine_i16), ch=ch, wavex=wavex)
    x, r = _both("read_wav", path)
    assert r == 24000 and x.dtype == np.int16
    assert np.abs(x.astype(int) - sine_i16).max() <= tol


def test_stereo_downmix_of_different_channels(tmp_path):
    rng = np.random.default_rng(0)
    st = (rng.standard_normal((4000, 2)) * 8000).astype(np.int16)
    _make_wav(str(tmp_path / "s.wav"), 1, 16, st.reshape(-1).tobytes(), ch=2)
    x, _ = _both("read_wav", str(tmp_path / "s.wav"))
    # the channels' mean, truncated toward zero
    np.testing.assert_array_equal(x, np.trunc(st.astype(np.float64).mean(1)).astype(np.int16))


def test_compressed_raises_naming_ffmpeg(tmp_path, sine_i16):
    _make_wav(str(tmp_path / "f.wav"), 0x0055, 16, sine_i16.tobytes())   # the MP3 tag
    with pytest.raises(ValueError, match="ffmpeg"):
        twav.read_wav(str(tmp_path / "f.wav"))


@pytest.mark.parametrize("kind", ["int16", "float"])
def test_roundtrip_own_writer(tmp_path, sine_i16, kind):
    samples = sine_i16 if kind == "int16" else sine_i16.astype(np.float32) / 32767.0
    twav.write_wav(str(tmp_path / "g.wav"), samples, 24000)
    jwav.write_wav(str(tmp_path / "h.wav"), samples, 24000)
    assert (tmp_path / "g.wav").read_bytes() == (tmp_path / "h.wav").read_bytes()
    x, r = twav.read_wav(str(tmp_path / "g.wav"))
    assert r == 24000 and np.abs(x.astype(int) - sine_i16).max() <= (0 if kind == "int16" else 1)


def test_kaiser_resample_beats_linear():
    t48 = np.arange(9600) / 48000.0
    s48 = (0.5 * np.sin(2 * np.pi * 440 * t48) * 32767).astype(np.int16)
    yk = _both("resample_kaiser", s48, 48000, 24000)
    yl = _both("resample_linear", s48, 48000, 24000)
    ideal = 0.5 * np.sin(2 * np.pi * 440 * np.arange(len(yk)) / 24000.0) * 32767
    rmse_k = math.sqrt(np.mean((yk[100:-100] - ideal[100:-100]) ** 2))
    rmse_l = math.sqrt(np.mean((yl[100:-100] - ideal[100:-100]) ** 2))
    assert rmse_k < 5.0 and rmse_k < rmse_l / 50


@pytest.mark.parametrize("src,dst", [(44100, 24000), (24000, 44100), (16000, 24000),
                                     (48000, 16000), (22050, 24000)])
def test_kaiser_rational_ratio_and_dc(src, dst):
    t = np.arange(src // 10) / src
    s = (0.3 * np.sin(2 * np.pi * 1000 * t) * 32767).astype(np.int16)
    y = _both("resample_kaiser", s, src, dst)
    assert len(y) == len(s) * dst // src
    yd = _both("resample_kaiser", np.full(1000, 1000, np.int16), src, dst)
    assert np.abs(yd[50:-50].astype(int) - 1000).max() <= 1


def test_read_wav_target_rate_uses_kaiser(tmp_path):
    s48 = (0.5 * np.sin(2 * np.pi * 440 * np.arange(9600) / 48000.0) * 32767).astype(np.int16)
    twav.write_wav(str(tmp_path / "h.wav"), s48, 48000)
    x, r = _both("read_wav", str(tmp_path / "h.wav"), target_rate=24000)
    assert r == 24000
    ideal = 0.5 * np.sin(2 * np.pi * 440 * np.arange(len(x)) / 24000.0) * 32767
    assert math.sqrt(np.mean((x[100:-100] - ideal[100:-100]) ** 2)) < 5.0
    xl, _ = _both("read_wav", str(tmp_path / "h.wav"), target_rate=24000, resample="linear")
    assert len(xl) == len(x)


def test_stereo_44k_to_24k(tmp_path):
    """The chip smoke run's reference layout: 16-bit stereo at 44.1 kHz read
    at 24 kHz (downmix, then the kaiser resample)."""
    rng = np.random.default_rng(1)
    st = (rng.standard_normal((44100, 2)) * 3000).astype(np.int16)
    _make_wav(str(tmp_path / "r.wav"), 1, 16, st.reshape(-1).tobytes(), rate=44100, ch=2,
              extra_chunk=False)
    x, r = _both("read_wav", str(tmp_path / "r.wav"), target_rate=24000)
    assert r == 24000 and len(x) == 24000


def test_read_audio_riff_passthrough(tmp_path, sine_i16):
    twav.write_wav(str(tmp_path / "a.wav"), sine_i16, 24000)
    x, r = twav.read_audio(str(tmp_path / "a.wav"))
    assert r == 24000 and np.array_equal(x, sine_i16)


def test_read_audio_no_ffmpeg_raises(tmp_path, monkeypatch):
    p = tmp_path / "a.mp3"
    p.write_bytes(b"ID3\x04" + b"\x00" * 64)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="ffmpeg"):
        twav.read_audio(str(p))


def test_read_audio_ffmpeg_shim_plumbing(tmp_path, sine_i16, monkeypatch):
    """A stand-in `ffmpeg` that turns the input into a PCM WAV exercises the
    subprocess plumbing (argument order, the temp file, the RIFF re-parse)."""
    src = tmp_path / "a.fake"
    src.write_bytes(b"FAKE" + sine_i16.tobytes())
    conv = tmp_path / "conv.py"
    conv.write_text(
        "import struct, sys\n"
        "args = sys.argv[1:]\n"
        "inp = args[args.index('-i') + 1]\n"
        "out = args[-1]\n"
        "data = open(inp, 'rb').read()[4:]\n"
        "fmt = struct.pack('<HHIIHH', 1, 1, 24000, 48000, 2, 16)\n"
        "body = (b'WAVE' + b'fmt ' + struct.pack('<I', len(fmt)) + fmt\n"
        "        + b'data' + struct.pack('<I', len(data)) + data)\n"
        "open(out, 'wb').write(b'RIFF' + struct.pack('<I', len(body)) + body)\n")
    ff = tmp_path / "ffmpeg"
    ff.write_text(f"#!/bin/sh\nexec {sys.executable} {conv} \"$@\"\n")
    ff.chmod(ff.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(tmp_path))
    x, r = twav.read_audio(str(src))
    assert r == 24000 and np.array_equal(x, sine_i16)


def test_read_audio_ffmpeg_failure_surfaces_stderr(tmp_path, monkeypatch):
    src = tmp_path / "bad.ogg"
    src.write_bytes(b"OggS" + b"\x00" * 16)
    ff = tmp_path / "ffmpeg"
    ff.write_text("#!/bin/sh\necho 'boom: no stream' >&2\nexit 1\n")
    ff.chmod(ff.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="boom: no stream"):
        twav.read_audio(str(src))


def test_audio_package_exports_wav():
    import tts_tpu_torch.audio as audio

    for name in ("read_audio", "read_wav", "resample_kaiser", "resample_linear", "write_wav"):
        assert getattr(audio, name) is getattr(twav, name)


# ------------------------------------------------------ the native helpers


def test_native_builds_into_the_build_dir():
    assert native.native_available()
    built = list(native.BUILD_DIR.glob("audio_io-*.so"))
    assert built and native.BUILD_DIR.parent.name == "_build"
    assert native.SOURCE.parent.name == "csrc"


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 0.3).astype(np.float32)
    x[: min(n, 4)] = [1.5, -1.5, 1.0, -1.0][: min(n, 4)]   # clamps and the ends
    return x


@pytest.mark.parametrize("n", [0, 1, 17, 48000])
def test_native_pcm_conversions_match_twins(n):
    x = _signal(n, 2)
    np.testing.assert_array_equal(native.f32_to_pcm16(x), native.f32_to_pcm16_plain(x))
    i16 = native.f32_to_pcm16_plain(x)
    np.testing.assert_array_equal(native.pcm16_to_f32(i16), native.pcm16_to_f32_plain(i16))


@pytest.mark.parametrize("src,dst", [(44100, 24000), (16000, 24000), (48000, 16000)])
def test_native_resample_linear_matches_twin(src, dst):
    x = _signal(src // 5, 3)
    got, ref = native.resample_linear(x, src, dst), native.resample_linear_plain(x, src, dst)
    assert got.shape == ref.shape == (round(len(x) * dst / src),)
    # the C loop interpolates in float64 from its own step; np.interp from
    # linspace positions: the same points to a few fp32 ulps of |x| <= 1.5
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("channels", [2, 3, 6])
def test_native_downmix_matches_twin(channels):
    rng = np.random.default_rng(channels)
    x = rng.integers(-32768, 32768, (5000, channels)).astype(np.int16)
    np.testing.assert_array_equal(native.downmix_to_mono(x), native.downmix_to_mono_plain(x))


@pytest.mark.parametrize("target", [0.05, 0.15, 0.5])
def test_native_rms_normalize_matches_twin(target):
    x = _signal(30000, 4)
    got, ref = native.rms_normalize(x, target), native.rms_normalize_plain(x, target)
    # the C sum runs in float64, the twin's mean in fp32 pairwise sums
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert abs(math.sqrt(np.mean(got.astype(np.float64) ** 2)) - target) < 1e-6
