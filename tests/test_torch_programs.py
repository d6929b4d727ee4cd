"""The port's per-bucket programs (`runtime/program.py`, F5's `_build` /
`_get_fn` / `_fn_cache` and `_build_batch`, BigVGAN's forward) against
tts_tpu's jitted programs on the CPU, fp32 on both sides, at a small
config; and the launch bookkeeping of a capture and its replays, with a
stand-in for the CUDA graph.

On the CPU a program runs its body eagerly (the kernel wrappers take their
plain twins); tts_tpu runs its CPU path. Both compute the same fp32 math in
another summation order, so int16 audio agrees to 2 LSB: a sample on an
integer boundary may truncate one LSB apart (as tests/test_torch_f5.py)."""
import jax
import numpy as np
import pytest
import torch

from tts_tpu.models import bigvgan as jbv
from tts_tpu.models import f5 as jf5
from tts_tpu.models import vocos as jvo
from tts_tpu.runtime.f5 import F5Pipeline as JaxPipeline
from tts_tpu.runtime.vocoder import BigVGANVocoder as JaxVocoder
from tts_tpu_torch.models import bigvgan as tbv
from tts_tpu_torch.models import f5 as tf5
from tts_tpu_torch.models import vocos as tvo
from tts_tpu_torch.ops import _build
from tts_tpu_torch.runtime import program
from tts_tpu_torch.runtime.f5 import F5Pipeline
from tts_tpu_torch.runtime.vocoder import BigVGANVocoder
from tts_tpu_torch.weights.convert import params_from_jax

# tests/test_torch_f5.py's small config
SMALL = dict(dim=128, depth=2, heads=2, head_dim=64, text_dim=64, conv_layers=1,
             nfe_steps=4, max_signal_len=512, vocab_size=40)
VOCOS = dict(dim=32, intermediate_dim=64, num_layers=2)
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz,.")}
LSB = 2
# three requests of one bucket (audio 32768, text 64, frames 256, generated
# 64), each with its own ref_signal_len and duration
ONE_BUCKET = ((9000, "hello there.", " some words here"),
              (12000, "hello there!", " some more words"),
              (10000, "hello there.", " a few words"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jc, tc = jf5.F5Config(**SMALL), tf5.F5Config(**SMALL)
    jvc, tvc = jvo.VocosConfig(**VOCOS), tvo.VocosConfig(**VOCOS)
    jp = jf5.init_params(jc, jax.random.key(0))
    jvp = jvo.init_params(jvc, jax.random.key(1))
    # a louder vocoder (magnitude bias e^3), as tests/test_torch_f5.py
    jvp["head"]["b"] = jvp["head"]["b"].at[:jvc.n_fft // 2 + 1].set(3.0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    tvp = params_from_jax(jax.tree.map(np.asarray, jvp), "cpu", torch.float32)
    return dict(jc=jc, tc=tc, jvc=jvc, tvc=tvc, jp=jp, jvp=jvp, tp=tp, tvp=tvp)


def _pipes(models, **kw):
    jpipe = JaxPipeline(models["jp"], models["jc"], VOCAB, models["jvp"], models["jvc"], **kw)
    pipe = F5Pipeline(tf5.F5Model(models["tc"], models["tp"]), VOCAB,
                      tvo.VocosModel(models["tvc"], models["tvp"]), **kw)
    return jpipe, pipe


def _audio(seed: int, n: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 3000).astype(np.int16)


def _close(got: np.ndarray, ref: np.ndarray) -> None:
    assert got.dtype == np.int16 and got.shape == ref.shape
    assert np.abs(ref.astype(np.int32)).max() > 3000
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= LSB


def test_one_program_per_bucket_matches_tts_tpu(models):
    """Three requests of one bucket with different ref_signal_len and
    duration run the bucket's one program, each within 2 LSB of tts_tpu's
    `_get_fn(*buckets)` program on the same inputs and draw; the lengths
    are data, so the port builds one program as tts_tpu compiles one."""
    jpipe, pipe = _pipes(models)
    preps = [pipe._prepare(_audio(i, n), r, g) for i, (n, r, g) in enumerate(ONE_BUCKET)]
    buckets = preps[0][4]
    assert all(p[4] == buckets for p in preps)
    assert len({p[2] for p in preps}) == len({p[3] for p in preps}) == len(preps)
    jfn, fn = jpipe._get_fn(*buckets), pipe._get_fn(*buckets)
    for seed, (audio_p, ids_p, ref, dur, _, n_keep) in enumerate(preps, start=7):
        key = jax.random.key(seed)
        want = np.asarray(jfn(jpipe.params, jpipe.vparams, audio_p, ids_p, np.int32(ref),
                              np.int32(dur), key))
        noise = np.asarray(jax.random.normal(key, (1, buckets[2], models["jc"].n_mels)))
        pcm, peak = fn(*pipe._inputs(audio_p, ids_p, [ref], [dur], buckets[2], None, noise))
        _close(pcm.numpy(), want)
        assert np.isfinite(float(peak)) and n_keep < pcm.shape[-1]
        assert pipe._get_fn(*buckets) is fn
    assert list(pipe._fn_cache) == list(jpipe._fn_cache) == [buckets]


def test_fn_cache_keys_match_tts_tpu(models):
    """After the same requests (two buckets, one repeated, then a batch of
    two), the port's `_fn_cache` holds tts_tpu's keys, and the audio agrees."""
    jpipe, pipe = _pipes(models)
    frame = models["jc"].n_mels
    seq = [(_audio(1, 9000), "hello there.", " some words here"),
           (_audio(2, 8000), "hi.", " and a bit more text, again."),
           (_audio(3, 12000), "hello there!", " some more words")]
    for i, req in enumerate(seq):
        wav_j, _ = jpipe.synthesize(*req, seed=i)
        frames = pipe._prepare(*req)[4][2]
        noise = np.asarray(jax.random.normal(jax.random.key(i), (1, frames, frame)))
        wav_t, _ = pipe.synthesize(*req, noise=noise)
        _close(wav_t, wav_j)
    batch = seq[:2]
    outs_j, _ = jpipe.synthesize_batch(batch, seed=5)
    frames = pipe._prepare_batch(batch)[5]
    noise = np.asarray(jax.random.normal(jax.random.key(5), (2, frames, frame)))
    outs_t, _ = pipe.synthesize_batch(batch, noise=noise)
    for got, ref in zip(outs_t, outs_j):
        _close(got, ref)
    assert len(pipe._fn_cache) == 3
    assert sorted(pipe._fn_cache) == sorted(jpipe._fn_cache)


def test_batch_program_matches_tts_tpu(models):
    """The `_build_batch` counterpart, keyed (B, buckets) as tts_tpu's: per-row
    ref_signal_len and duration in (B,) buffers, each row within 2 LSB of
    tts_tpu's batch program on the same inputs and draw."""
    jpipe, pipe = _pipes(models)
    reqs = [(_audio(10 + i, 8000 + 3000 * i), r, g) for i, (_, r, g) in enumerate(ONE_BUCKET)]
    audio_p, ids_p, refs, durs, gens, frames, gen_frames = pipe._prepare_batch(reqs)
    key = (len(reqs), audio_p.shape[1], ids_p.shape[1], frames, gen_frames)
    rkey = jax.random.key(3)
    want = np.asarray(jpipe._build_batch(*key)(
        jpipe.params, jpipe.vparams, audio_p, ids_p, np.asarray(refs, np.int32),
        np.asarray(durs, np.int32), rkey))
    noise = np.asarray(jax.random.normal(rkey, (len(reqs), frames, models["jc"].n_mels)))
    fn = pipe._get_batch_fn(*key)
    pcm, _ = fn(*pipe._inputs(audio_p, ids_p, refs, durs, frames, None, noise))
    assert pcm.shape == want.shape and len(set(refs)) == len(set(durs)) == len(reqs)
    for b, g in enumerate(gens):
        _close(pcm[b, :g * pipe.cfg.hop].numpy(), want[b, :g * pipe.cfg.hop])
    assert list(pipe._fn_cache) == [key]


def test_layer_cache_interval_rebuilds_programs(models):
    """A program is built for one layer cache interval: setting another
    drops the programs, so the next request builds one for it."""
    _, pipe = _pipes(models, layer_cache_interval=2)
    audio = _audio(6, 9000)
    pipe.synthesize(audio, "hello there.", " some words here", seed=1)
    assert len(pipe._fn_cache) == 1
    pipe.layer_cache_interval = 1
    assert pipe.layer_cache_interval == 1 and not pipe._fn_cache
    pipe.layer_cache_interval = 0
    assert pipe.layer_cache_interval == 1


def test_bigvgan_forward_matches_tts_tpu():
    """BigVGANVocoder.forward through the program of (B, T) against
    tts_tpu's jitted `_forward`, within 2 LSB; one program a mel shape."""
    cfg_kw = dict(num_mels=8, upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
                  resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), upsample_rates=(4, 2),
                  upsample_kernel_sizes=(8, 4), use_tanh_at_final=False,
                  use_bias_at_final=False)
    jcfg, tcfg = jbv.BigVGANConfig(**cfg_kw), tbv.BigVGANConfig(**cfg_kw)
    jp = jbv.init_params(jcfg, jax.random.key(3))
    jp["conv_post"]["w"] = jp["conv_post"]["w"] * 2000.0   # a waveform that spans int16
    jv = JaxVocoder(jp, jcfg, dtype=np.float32)
    tv = BigVGANVocoder(params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32),
                        tcfg, dtype=torch.float32)
    rng = np.random.default_rng(11)
    for shape in ((1, 40, 8), (2, 40, 8), (1, 40, 8)):
        mel = rng.standard_normal(shape).astype(np.float32)
        ref = np.asarray(jv._forward(jv.params, mel))
        got = tv.forward(torch.from_numpy(mel))
        assert got.shape == ref.shape == (shape[0], 40 * 8)
        _close(got.numpy(), ref)
    assert list(tv._fn_cache) == [(1, 40), (2, 40)]


class StandInGraph:
    """program._Graph on the CPU: the capture runs the body once and keeps
    its outputs as the static ones; a replay runs it again into those
    buffers with its launches discarded, as a CUDA graph replays without a
    wrapper call."""

    def __init__(self, device, pool):
        self.fn, self.outs = None, ()

    def warm_up(self, fn):
        fn()

    def capture(self, fn):
        self.fn = fn
        self.outs = fn()
        return self.outs

    def replay(self):
        with _build.recording():
            new = self.fn()
        for o, n in zip(self.outs, new):
            o.copy_(n)


def _fake_body(x, y):
    """Two launches of "k_a" and one of "k_b", as kernel wrappers count them."""
    for name in ("k_a", "k_a", "k_b"):
        _build.count_launch(name)
    return x * 2 + y, x.sum()


def test_capture_and_replay_launch_bookkeeping(monkeypatch):
    """Warm-up and capture add nothing to LAUNCHES; each replay adds the
    recorded counts once, through `_build.count_launch` as replaced at the
    call (chip_smoke.py's ablation hook); queued replays return outputs of
    their own."""
    monkeypatch.setattr(program, "_Graph", StandInGraph)
    seen = []
    real = _build.count_launch

    def hook(name, n=1):
        seen.append((name, n))
        real(name, n)

    monkeypatch.setattr(_build, "count_launch", hook)
    prog = program.Program(_fake_body, [((2, 3), torch.float32), ((2, 3), torch.float32)],
                           "cpu", program.GraphPool())
    x1, y1 = torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)
    x2, y2 = -x1, 3 * y1
    start = {k: _build.LAUNCHES[k] for k in ("k_a", "k_b")}

    def grew():
        return {k: _build.LAUNCHES[k] - n for k, n in start.items()}

    prog._capture(prog._coerce((x1, y1)))
    assert grew() == {"k_a": 0, "k_b": 0}
    assert prog.launches == {"k_a": 2, "k_b": 1}
    assert prog.warmup_s >= 0 and prog.capture_s >= 0 and prog.pool_bytes == 0
    seen.clear()
    out1 = prog._replay(prog._coerce((x1, y1)))
    assert grew() == {"k_a": 2, "k_b": 1}
    assert [s for s in seen if s[1] > 1] == [("k_a", 2)]
    out2 = prog._replay(prog._coerce((x2.numpy(), y2.numpy())))
    out3 = prog._replay(prog._coerce((x1, y1)))
    assert grew() == {"k_a": 6, "k_b": 3}
    ptrs = {o[0].data_ptr() for o in (out1, out2, out3)} | {prog._outs[0].data_ptr()}
    assert len(ptrs) == 4
    torch.testing.assert_close(out1[0], x1 * 2 + y1, rtol=0, atol=0)
    torch.testing.assert_close(out2[0], x2 * 2 + y2, rtol=0, atol=0)
    torch.testing.assert_close(out3, _fake_body(x1, y1), rtol=0, atol=0)


def test_replay_raises_through_the_hook(monkeypatch):
    """A replaced count_launch that refuses a kernel (chip_smoke.py's guard
    on kernels no pipeline may launch) refuses it at the capture and at a
    replay alike."""
    monkeypatch.setattr(program, "_Graph", StandInGraph)
    real = _build.count_launch

    def refuse(name, n=1):
        if name == "k_b":
            raise AssertionError(f"a pipeline launched {name}")
        real(name, n)

    prog = program.Program(_fake_body, [((2,), torch.float32)] * 2, "cpu",
                           program.GraphPool())
    monkeypatch.setattr(_build, "count_launch", refuse)
    with pytest.raises(AssertionError, match="k_b"):
        prog._replay(prog._coerce((torch.ones(2), torch.ones(2))))
    monkeypatch.setattr(_build, "count_launch", real)
    prog._replay(prog._coerce((torch.ones(2), torch.ones(2))))
    monkeypatch.setattr(_build, "count_launch", refuse)
    with pytest.raises(AssertionError, match="k_b"):
        prog._replay(prog._coerce((torch.ones(2), torch.ones(2))))


def test_program_checks_its_inputs():
    """A bucket's program takes its inputs' shapes only; host inputs are
    cast to the buffer's dtype; on the CPU a call runs the body."""
    prog = program.Program(_fake_body, [((2, 3), torch.float32)] * 2, "cpu",
                           program.GraphPool())
    with pytest.raises(ValueError, match="shape"):
        prog(torch.ones(3, 2), torch.ones(2, 3))
    with pytest.raises(TypeError):
        prog(torch.ones(2, 3))
    out, total = prog(np.ones((2, 3), np.float64), torch.ones(2, 3, dtype=torch.int32))
    assert out.dtype == torch.float32 and float(total) == 6.0


def test_recording_is_per_thread():
    """A capture's recorder takes only its own thread's launches: a slot
    server's worker counting at the same time still adds to LAUNCHES."""
    import threading

    name = "recording_thread_test"
    with _build.recording() as rec:
        _build.count_launch(name, 3)
        th = threading.Thread(target=_build.count_launch, args=(name, 5))
        th.start()
        th.join(10)
        assert not th.is_alive()
    try:
        assert rec == {name: 3} and _build.LAUNCHES[name] == 5
    finally:
        del _build.LAUNCHES[name]
