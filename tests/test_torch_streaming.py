"""The port's streaming synthesis against tts_tpu on the CPU, fp32 on both
sides: QwenTTSPipeline.synthesize_streaming (tests/test_torch_qwen.py's
models) and VoxCPMPipeline.synthesize_streaming (tests/test_torch_voxcpm.py's
v1.5 TINY, tts_tpu's CFM draws injected), each against tts_tpu's generator,
against the window assembly over the port's own non-streaming decode, and
the port's Qwen and VoxCPM slot-server streams against the pipelines'
(tests/test_torch_continuous.py's families).

Tolerances: the frames and latent counts equal; every chunk's int16 audio
within 1 LSB of tts_tpu's (float waveforms that agree to ~1e-6 can
truncate to neighbouring integers); the port's stream bitwise its own
assembly over _decode's frames or latents (the same kernels, bucket and
windows); a slot server's stream within 1 LSB of the pipeline's (a masked
batch of 2 rows sums in another order than the solo step)."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_continuous import RESULT_S
from tests.test_torch_continuous import Qwen as QwenFamily
from tests.test_torch_continuous import VoxCPM as VoxFamily
from tests.test_torch_qwen import IDS
from tests.test_torch_qwen import _pipes as qwen_pipes
from tests.test_torch_qwen import models  # noqa: F401  (the fixture)
from tests.test_torch_voxcpm import _jax_noise
from tts_tpu_torch.runtime.streaming import ChunkedCodecStream

LSB = 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_chunks(got: list, ref: list, lsb: int = LSB) -> None:
    assert [len(c) for c in got] == [len(c) for c in ref] and len(got) > 1
    a, b = np.concatenate(got), np.concatenate([np.asarray(c) for c in ref])
    assert a.dtype == np.int16 and np.abs(b.astype(np.int32)).max() > 1000
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= lsb


def _assembled(decode_fn, frames: np.ndarray, chunk: int, window: int, left: int,
               upsample: int, groups: int) -> np.ndarray:
    """ChunkedCodecStream over `frames`, pushed `chunk` at a time."""
    stream = ChunkedCodecStream(decode_fn, window=window, left_context=left,
                                upsample=upsample, num_groups=groups)
    out = []
    for i in range(0, len(frames), chunk):
        c = stream.push_frames(frames[i:i + chunk])
        if c is not None and len(c):
            out.append(c)
    out.extend(stream.finish())
    return np.concatenate(out)


# ---------------------------------------------------------------- Qwen3-TTS

def _eos_at(models, frame: int, **decode):  # noqa: F811
    """A group-0 EOS id that the unstopped decode first emits at `frame`."""
    _, probe = qwen_pipes(models, **decode)
    pre, tr = probe.build_prefill_embeds(IDS, 3)
    frames, n = probe._decode(*probe._request_bufs(pre, tr))
    tok = frames[:, 0].numpy()
    for f in range(frame, n):
        if tok[f] not in tok[:f]:
            return int(tok[f]), f
    pytest.fail("no fresh group-0 token to stop on")


@pytest.mark.parametrize("case", ["c3w4l2", "divides", "eos_on_boundary"])
def test_qwen_streaming_matches_jax(models, case):  # noqa: F811
    """chunk 3 / window 4 / left 2 over 8 frames; chunk 4 over 8 (it divides
    max_frames); and an EOS that ends a chunk (frame 6 of 8 at chunk 3: the
    EOS frame itself dropped)."""
    decode = dict(max_frames=8, repeat_penalty=0.8, penalty_range=3)
    chunk, window, left = (4, 6, 2) if case == "divides" else (3, 4, 2)
    eos, frames = 62, 8
    if case == "eos_on_boundary":
        eos, at = _eos_at(models, 5, **decode)
        assert (at + 1) % chunk == 0, at
        frames = at
    jpipe, tpipe = qwen_pipes(models, eos=eos, **decode)
    pre, tr = jpipe.build_prefill_embeds(IDS, 3)
    ref = list(jpipe.synthesize_streaming(pre, tr, chunk_frames=chunk, window=window,
                                          left_context=left))
    got = list(tpipe.synthesize_streaming(pre, tr, chunk_frames=chunk, window=window,
                                          left_context=left))
    up = tpipe.codec_cfg.total_upsample
    assert sum(len(c) for c in got) == sum(len(c) for c in ref) == frames * up
    _same_chunks(got, ref)


@pytest.mark.parametrize("chunk", [3, 5])
def test_qwen_stream_is_the_assembly_over_decode(models, chunk):  # noqa: F811
    """The port's stream, bit for bit, the window assembly over _decode's
    frames for the same prefill (the frames the non-streaming request
    gives)."""
    _, tpipe = qwen_pipes(models, max_frames=8, repeat_penalty=0.8, penalty_range=3)
    pre, tr = tpipe.build_prefill_embeds(IDS, 3)
    got = np.concatenate(list(tpipe.synthesize_streaming(pre, tr, chunk_frames=chunk,
                                                         window=5, left_context=2)))
    frames, n = tpipe._decode(*tpipe._request_bufs(pre, tr))
    ref = _assembled(tpipe._codec_window, frames[:n].numpy(), chunk, 5, 2,
                     tpipe.codec_cfg.total_upsample, tpipe.cfg.num_code_groups)
    np.testing.assert_array_equal(got, ref)
    wav, st = tpipe.synthesize_from_prefill(pre, tr)
    assert len(got) == len(wav) and st["frames"] == n


# ---------------------------------------------------------------- VoxCPM

def _vox_pipes(latents: int, seed: int = 11):
    fam = VoxFamily()
    from tts_tpu.runtime.voxcpm import VoxCPMDecodeConfig as JD
    from tts_tpu.runtime.voxcpm import VoxCPMPipeline as JP
    from tts_tpu_torch.runtime.voxcpm import VoxCPMDecodeConfig, VoxCPMPipeline

    d = dict(max_latents=latents, min_latents=latents, seed=seed)
    return (fam, JP(fam.jp, fam.jc, fam.jvae, JD(**d)),
            VoxCPMPipeline(fam.tp, fam.tc, fam.tvae, VoxCPMDecodeConfig(**d)))


def _vox_segments(fam, p_ids, t_ids):
    return [("text", np.concatenate([p_ids[0], t_ids[0], [fam.tc.audio_start_id]])
             .astype(np.int32))]


@pytest.mark.parametrize("chunk,latents", [(2, 7), (4, 8)])
def test_voxcpm_streaming_matches_jax(chunk, latents):
    """tts_tpu's streaming generator against the port's with its draws
    injected: the latent count (in samples) and each chunk's audio."""
    fam, jpipe, tpipe = _vox_pipes(latents)
    p_ids, t_ids = np.array([[5, 9]], np.int32), np.array([[11, 3, 7]], np.int32)
    segs = _vox_segments(fam, p_ids, t_ids)
    cap = t_ids.shape[1] * tpipe.dcfg.decode_limit_factor + 10
    zero = np.zeros((2, fam.tc.patch_size, fam.tc.estimator.hidden_size), np.float32)
    ref = list(jpipe.synthesize_streaming(segs, jnp.asarray(zero), cap, seed=3, chunk=chunk))
    got = list(tpipe.synthesize_streaming(segs, torch.from_numpy(zero), cap, seed=3,
                                          chunk=chunk, noise=_jax_noise(3, latents, 1, fam.tc)))
    spl = fam.tc.samples_per_latent
    assert sum(len(c) for c in got) == sum(len(c) for c in ref) == latents * spl
    _same_chunks(got, ref)


def test_voxcpm_stream_is_the_assembly_over_decode():
    """The port's stream, bit for bit, the window assembly over the latents
    _run_segments generates with the same draws (the count equal too)."""
    fam, _, tpipe = _vox_pipes(7)
    segs = _vox_segments(fam, np.array([[5, 9]], np.int32), np.array([[11, 3, 7]], np.int32))
    zero = torch.zeros((2, fam.tc.patch_size, fam.tc.estimator.hidden_size))
    noise = _jax_noise(4, 7, 1, fam.tc)
    got = np.concatenate(list(tpipe.synthesize_streaming(segs, zero, 40, chunk=3,
                                                         noise=noise)))
    text, is_audio, fe, pos = tpipe._prompt_bufs(segs)
    lat = num = None
    for lat, num, _ in tpipe._latent_steps(text, is_audio, pos, fe, zero, 40,
                                           tpipe._latent_buf(40), tpipe.dcfg.seed, noise):
        pass
    wav, st = tpipe._run_segments(segs, zero, 40, None, noise)
    assert st["latents"] == num == 7 and len(wav) == len(got)
    ref = _assembled(tpipe._vae_dec_fn, lat[0, :num].numpy(), 3, 4, 1,
                     fam.tc.samples_per_latent, fam.tc.patch_size)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- slot servers

def _drain(handle) -> list:
    chunks = []
    box = threading.Thread(target=lambda: chunks.extend(handle), daemon=True)
    box.start()
    box.join(RESULT_S)
    assert not box.is_alive(), "the stream never ended"
    return chunks


def test_qwen_slot_stream_matches_pipeline_stream():
    """QwenSlotServer.submit_stream (chunk 4, window 6, left 2), sharing the
    batch with a plain request, against the pipeline's synthesize_streaming
    at the same cadence."""
    from tts_tpu_torch.serving.continuous_qwen import QwenSlotServer

    fam = QwenFamily()
    _, tpipe = fam.pipes()
    prefill, trailing, cap = fam.reqs[0]
    ref = list(tpipe.synthesize_streaming(prefill, trailing, chunk_frames=4, window=6,
                                          left_context=2))
    srv = QwenSlotServer(tpipe, **fam.slot_kw)
    try:
        other = fam.submit(srv, fam.reqs[1])
        handle = fam.stream(srv, fam.reqs[0])
        got = _drain(handle)
        assert handle.n_frames == cap
        other.result(timeout=RESULT_S)
    finally:
        srv.close()
    _same_chunks(got, ref)


def test_voxcpm_slot_stream_matches_pipeline_stream():
    """VoxCPMSlotServer.submit_stream (chunk 2, window 3) with tts_tpu's
    draws, sharing the batch with a plain request, against the pipeline's
    synthesize_streaming(chunk=2) with the same draws."""
    from tts_tpu_torch.serving.continuous_voxcpm import VoxCPMSlotServer

    fam = VoxFamily()
    _, tpipe = fam.pipes()
    p_ids, t_ids, seed = fam.reqs[0]
    cap = t_ids.shape[1] * tpipe.dcfg.decode_limit_factor + 10
    zero = torch.zeros((2, fam.tc.patch_size, fam.tc.estimator.hidden_size))
    ref = list(tpipe.synthesize_streaming(_vox_segments(fam, p_ids, t_ids), zero, cap,
                                          chunk=2, noise=fam.noise(seed)))
    srv = VoxCPMSlotServer(tpipe, **fam.slot_kw)
    try:
        handle = fam.stream(srv, fam.reqs[0])
        other = fam.submit(srv, fam.reqs[1])
        got = _drain(handle)
        assert handle.n_frames == fam.LATENTS
        other.result(timeout=RESULT_S)
    finally:
        srv.close()
    _same_chunks(got, ref)


def test_voxcpm_slot_server_output_rate():
    """A VoxCPMSlotServer over a pipeline at output_sample_rate 16000 returns
    resample_linear of what the same server gives at the native rate (the
    same draws), as tts_tpu's slot server resamples."""
    import dataclasses

    from tts_tpu_torch.audio.wav import resample_linear
    from tts_tpu_torch.runtime.voxcpm import VoxCPMPipeline
    from tts_tpu_torch.serving.continuous_voxcpm import VoxCPMSlotServer

    fam = VoxFamily()
    _, native = fam.pipes()
    at16 = VoxCPMPipeline(fam.tp, fam.tc, fam.tvae, dataclasses.replace(native.dcfg),
                          output_sample_rate=16000)
    outs = []
    for pipe in (native, at16):
        srv = VoxCPMSlotServer(pipe, **fam.slot_kw)
        try:
            outs.append(fam.submit(srv, fam.reqs[0]).result(timeout=RESULT_S))
        finally:
            srv.close()
    (w48, n48), (w16, n16) = outs
    assert n16 == n48 == fam.LATENTS and len(w48) == n48 * fam.tc.samples_per_latent
    np.testing.assert_array_equal(w16, resample_linear(w48, fam.tc.output_sample_rate, 16000))
