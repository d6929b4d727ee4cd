"""The Qwen3-TTS decode programs (runtime/qwen.py's `_Decode`: a prefill and
a step program of one frame step over a state on the device, and the codec
programs) against tts_tpu on the CPU, fp32 on both sides, at
tests/test_torch_qwen.py's small config: qwen3_stack_step at a device
length on every route, the requests (greedy, int8, beam, a batch, a stream)
stopped by an EOS (the replay queued ahead of the host's read then a frozen
frame) and at the max_frames cap, two streams of one bucket consumed in
turn, the programs' keys, a frame past the cache, the weights' bookkeeping,
and kernel 13's device form (its plan and its twin).

On the CPU every program runs its body eagerly on the same state a card's
graph replays; the kernel wrappers take their plain twins. tts_tpu's
frames of a request run to the cap are computed once a configuration
(`unstopped`): the cap cases compare with them, and the EOS cases take
their stop id from them. Tolerances are tests/test_torch_qwen.py's, for the
same reasons: a stack step within STEP_TOL (Q8_TOL on the W8A8 route), the
frames and counts exactly tts_tpu's, int16 audio within 2 LSB
(_same_audio)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_qwen import (IDS, Q8_TOL, STEP_TOL, _cfgs, _conv, _np, _pipes,
                                   _same_audio, _t)
from tests.test_torch_qwen import models  # noqa: F401  (the fixture)
from tts_tpu.kv.cache import KVCache as JKV
from tts_tpu.models import qwen_tts as jq
from tts_tpu.runtime.qwen import QwenTTSPipeline as JaxPipeline
from tts_tpu_torch.kv.cache import KVCache
from tts_tpu_torch.models import qwen_tts as tq
from tts_tpu_torch.runtime import qwen as rq
from tts_tpu_torch.runtime.qwen import QwenDecodeConfig, QwenTTSPipeline

DECODE = dict(max_frames=8, repeat_penalty=0.8, penalty_range=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the step

STEP_CASES = ["False", "True", "step", "all", "mlp_q8_int8", "batch_False", "batch_True"]


@pytest.mark.parametrize("case", STEP_CASES)
def test_stack_step_at_a_device_length_matches_jax(models, case):  # noqa: F811
    """The talker stack (head_dim 128) after a 5-row prefill, then three
    steps with kv.length a device int32 and a bound of 200 rows of a 256-row
    cache (so kernel 13's gate, 256 | T, holds on "all"), against tts_tpu's
    steps at host positions 5, 6 and 7 (its kernels in interpret mode): the
    hidden state each step, and the cache rows written. The batch cases
    run 2 rows under a key mask (row 1 left-padded by 2), which takes kernel
    11 or the plain chain."""
    from tts_tpu.quant.weight_only import quantize_pytree as jqp

    quant = case == "mlp_q8_int8"
    route = {"False": False, "True": True, "step": "step", "all": "all",
             "mlp_q8_int8": "mlp_q8", "batch_False": False, "batch_True": True}[case]
    jp_all = jqp(models["jp"], min_size=1) if quant else models["jp"]
    jp, tp, cfg = jp_all["talker"], _conv(jp_all)["talker"], models["jc"].talker
    b = 2 if case.startswith("batch") else 1
    rng = np.random.default_rng(61)
    pre = (rng.standard_normal((b, 5, cfg.hidden_size)) * 0.5).astype(np.float32)
    xs = (rng.standard_normal((3, b, 1, cfg.hidden_size)) * 0.5).astype(np.float32)
    valid = np.arange(256)[None, :] >= np.array([0, 2][:b])[:, None]
    kvv = valid if b > 1 else None
    cos, sin = models["jp"]["rope_cos"], models["jp"]["rope_sin"]
    jkv = JKV.create(cfg.num_layers, b, cfg.num_kv_heads, 256, cfg.head_dim, jnp.float32)
    _, jkv = jax.jit(partial(jq.qwen3_stack_step, cfg=cfg))(
        jp, jnp.asarray(pre), jkv, rope_cos=cos[:5], rope_sin=sin[:5],
        kv_valid=None if kvv is None else jnp.asarray(kvv))
    tcos, tsin = models["tp"]["rope_cos"], models["tp"]["rope_sin"]
    tkv = KVCache.create(cfg.num_layers, b, cfg.num_kv_heads, 256, cfg.head_dim, torch.float32)
    _, tkv = tq.qwen3_stack_step(tp, _t(pre), tkv, cfg, tcos[:5], tsin[:5],
                                 kv_valid=None if kvv is None else _t(kvv))
    pos = torch.tensor(5, dtype=torch.int32)
    dkv = KVCache(tkv.k, tkv.v, pos, bound=200)
    routes = tq.stack_routes(tp, cfg, b, 1, dkv, None if kvv is None else _t(kvv), True,
                             route)
    want = {"False": {}, "True": dict(qkv=True), "step": dict(step=True),
            "all": dict(qkv=True, attn=True, mlp=True),
            "mlp_q8_int8": dict(qkv=True, mlp_q8=True),
            "batch_False": {}, "batch_True": dict(qkv=True)}[case]
    fields = ("step", "qkv", "attn", "mlp", "mlp_q8")
    assert {k: getattr(routes, k) for k in fields} == {k: want.get(k, False) for k in fields}
    tol = Q8_TOL if quant else STEP_TOL
    # jitted, as tts_tpu's programs run it (the length a traced value)
    jstep = jax.jit(partial(jq.qwen3_stack_step, cfg=cfg, fused=route, _interpret=True))
    for i, x in enumerate(xs):
        p = 5 + i
        hj, jkv = jstep(jp, jnp.asarray(x), jkv, rope_cos=cos[p:p + 1], rope_sin=sin[p:p + 1],
                        kv_valid=None if kvv is None else jnp.asarray(kvv))
        idx = pos.reshape(1).long()
        ht, _ = tq.qwen3_stack_step(tp, _t(x), dkv, cfg, tcos.index_select(0, idx),
                                    tsin.index_select(0, idx),
                                    kv_valid=None if kvv is None else _t(kvv), fused=route)
        np.testing.assert_allclose(ht.numpy(), _np(hj), **tol)
        pos.add_(1)
    assert int(pos) == int(jkv.length) == 8
    # a left-pad row's keys are garbage on both sides (its query saw no
    # valid key), which no valid query reads: compare each row's valid rows
    for r, start in enumerate((0, 2)[:b]):
        for got, ref in ((tkv.k, jkv.k), (tkv.v, jkv.v)):
            np.testing.assert_allclose(got[:, r, :, start:8].numpy(),
                                       _np(ref)[:, r, :, start:8], **tol)


# ---------------------------------------------------------------- the requests

def _bufs(pipe, ids=IDS, lang=3):
    """(prefill bucket, its rows, trailing bucket) as numpy, for both
    packages' decode programs."""
    pre, tr = pipe.build_prefill_embeds(ids, lang)
    buf, p_len, trb = pipe._request_bufs(pre, tr)
    return buf.numpy(), p_len, trb.numpy()


def _jax_decode(jpipe, buf, p_len, tr):
    """tts_tpu's `_decode_fn[tb]` program (the one its request ran, or a new
    one) on the same bucket: (frames, frames kept)."""
    if jpipe._decode_fn is None or tr.shape[1] not in jpipe._decode_fn:
        jpipe._decode_fn = {**(jpipe._decode_fn or {}),
                            tr.shape[1]: jpipe._build_decode(tr.shape[1])}
    frames, num = jpipe._decode_fn[tr.shape[1]](jpipe.params, jnp.asarray(buf),
                                                np.int32(p_len), jnp.asarray(tr))
    return _np(frames), int(num)


@pytest.fixture(scope="module")
def unstopped():
    """tts_tpu's frames of requests at the test config's stop id (62, which
    the solo requests never emit: they run to the cap), by configuration:
    the cap cases store them, the EOS cases read them (_unstopped)."""
    return {}


def _unstopped(cache, label, run):
    """cache[label], computed by run() where no cap case stored it."""
    if label not in cache:
        cache[label] = run()
    return cache[label]


def _solo_ref(models, quantize, decode):  # noqa: F811
    """tts_tpu's `_decode_fn[tb]` frames (max_frames, G) of the request run
    to the cap."""
    jpipe, tpipe = _pipes(models, quantize, **decode)
    return _jax_decode(jpipe, *_bufs(tpipe))[0]


def _fresh_token(tok: np.ndarray, first: int = 2) -> tuple[int, int]:
    """(a group-0 id first emitted at frame f, f + 1) for the first f >=
    first: an EOS there stops the request after f + 1 frame steps."""
    for f in range(first, len(tok) - 1):
        if tok[f] not in tok[:f]:
            return int(tok[f]), f + 1
    pytest.fail("no fresh group-0 token to stop on")


@pytest.fixture
def frame_steps(monkeypatch):
    """Counts the frame steps the step programs run, frozen ones included."""
    calls = []
    one = rq._Decode._one_frame
    monkeypatch.setattr(rq._Decode, "_one_frame", lambda self: calls.append(1) or one(self))
    return calls


@pytest.mark.parametrize("case", ["greedy_cap", "greedy", "int8_cap", "int8", "beam_cap",
                                  "beam"])
def test_request_on_the_programs_matches_jax(models, case, unstopped,  # noqa: F811
                                             frame_steps):
    """One request through the decode programs, stopped by an EOS (the
    replay queued ahead of the host's read of the stop flag is a frozen
    frame: one frame step more than the frames computed, the state as the
    EOS frame left it) or at the max_frames cap (exactly max_frames frame
    steps): the frames and the count exactly tts_tpu's `_decode_fn[tb]`,
    the audio within 2 LSB of tts_tpu's request."""
    decode = dict(DECODE)
    config = case.removesuffix("_cap")
    quantize = 8 if config == "int8" else None
    if config == "beam":
        decode.update(use_beam=True, beam_size=3, beam_top_k=2)
    cap = case.endswith("cap")
    if cap:
        eos, n_want = 62, decode["max_frames"]
    else:
        ref = _unstopped(unstopped, config, lambda: _solo_ref(models, quantize, decode))
        eos, n_want = _fresh_token(ref[:, 0])
    jpipe, tpipe = _pipes(models, quantize, eos, **decode)
    wj, sj = jpipe.synthesize_ids(IDS, language_id=3)
    wt, st = tpipe.synthesize_ids(IDS, language_id=3)
    kept = n_want - (0 if cap else 1)
    assert st["frames"] == sj["frames"] == kept
    assert len(frame_steps) == n_want + (0 if cap else 1)
    _same_audio(wt, wj)
    buf, p_len, tr = _bufs(tpipe)
    fj, nj = _jax_decode(jpipe, buf, p_len, tr)
    (dec,) = tpipe._decode_fn[64]
    assert nj == kept and int(dec.num) - int(dec.fin) == kept
    np.testing.assert_array_equal(dec.frames[0].numpy(), fj)
    if cap:
        unstopped.setdefault(config, fj)
    # the frozen frame changed nothing
    assert int(dec.num) == n_want and int(dec.pos) == p_len + n_want and bool(dec.stop)
    assert bool(dec.fin) == (not cap)


BATCH = [(IDS, 3), (np.array([[7, 1, 4, 30, 22, 8]], np.int32), 2), (IDS[:, :2], 5)]


def _batch_bufs(reqs):
    """tts_tpu's batch program's inputs: right-justified prefills, their pad
    starts, the trailing texts padded with their last row."""
    buf = np.zeros((3, 64, 128), np.float32)
    pad = np.zeros((3,), np.int32)
    tr = np.zeros((3, 64, 128), np.float32)
    for b, (p, t) in enumerate(reqs):
        buf[b, 64 - p.shape[1]:] = p[0]
        pad[b] = 64 - p.shape[1]
        tr[b, :t.shape[1]] = t[0]
        tr[b, t.shape[1]:] = t[0, -1:]
    return jnp.asarray(buf), pad, jnp.asarray(tr)


def _batch_ref(models):  # noqa: F811
    """tts_tpu's batch frames (B, max_frames, G) run to the cap."""
    jpipe, _ = _pipes(models, **DECODE)
    reqs = [jpipe.build_prefill_embeds(i, la) for i, la in BATCH]
    return _np(jpipe._build_decode_batch(3)(jpipe.params, *_batch_bufs(reqs))[0])


@pytest.mark.parametrize("case", ["cap", "eos"])
def test_batch_on_the_programs_matches_jax(models, case, unstopped, frame_steps):  # noqa: F811
    """A batch of 3 through its programs, stopped for row 0 by an EOS it
    emits (its later frames padded, the other rows running on), or for
    every row at the max_frames cap: the frames and each row's count
    exactly tts_tpu's `_batch_fns[("batch", B, pmax, tb)]` program, the
    audio within 2 LSB of tts_tpu's batch."""
    decode = dict(DECODE)
    if case == "cap":
        eos = 62
    else:
        ref = _unstopped(unstopped, "batch", lambda: _batch_ref(models))
        eos, stop_at = _fresh_token(ref[0, :, 0])
    jpipe, tpipe = _pipes(models, eos=eos, **decode)
    reqs_j = [jpipe.build_prefill_embeds(i, la) for i, la in BATCH]
    reqs_t = [tpipe.build_prefill_embeds(i, la) for i, la in BATCH]
    wj, sj = jpipe.synthesize_from_prefill_batch(reqs_j)
    wt, st = tpipe.synthesize_from_prefill_batch(reqs_t)
    (key, (dec,)), = tpipe._batch_fns.items()
    assert key == ("batch", 3, 64, 64) and key in jpipe._batch_fns
    fj, dj = jpipe._batch_fns[key](jpipe.params, *_batch_bufs(reqs_j))
    done = torch.clamp(dec.done, max=dec.num).numpy()
    np.testing.assert_array_equal(done, _np(dj))
    np.testing.assert_array_equal(dec.frames.numpy(), _np(fj))
    assert st["frames"] == sj["frames"] == int(done.sum())
    # the loop ends when every row is done (a frozen frame follows) or at
    # the cap (none does)
    n = int(dec.num)
    assert bool(dec.stop) and len(frame_steps) == n + (n < 8)
    if case == "cap":
        unstopped.setdefault("batch", _np(fj))
    else:
        assert done[0] == stop_at - 1
    for a, j in zip(wt, wj):
        if len(j):
            _same_audio(a, j)
        else:
            assert len(a) == 0


STREAM = dict(chunk_frames=3, window=4, left_context=2)


@pytest.mark.parametrize("case", ["cap", "eos"])
def test_stream_on_the_programs_matches_jax(models, case, unstopped):  # noqa: F811
    """A stream (chunk 3, window 4, left 2) on its own decode programs
    (tts_tpu's `_codec_cache[("chunk", 3, tb)]` with `_prefill_fn`), stopped
    by an EOS or at the cap: its frames exactly tts_tpu's decode's, its
    chunks within 1 LSB of tts_tpu's stream, and bitwise the window
    assembly over the port's non-streaming decode."""
    from tests.test_torch_streaming import _assembled, _same_chunks

    decode = dict(DECODE)
    # an EOS past the first chunk: a chunk, then the rest at the end
    eos = 62 if case == "cap" else _fresh_token(
        _unstopped(unstopped, "greedy", lambda: _solo_ref(models, None, decode))[:, 0], 4)[0]
    jpipe, tpipe = _pipes(models, eos=eos, **decode)
    pre, tr = jpipe.build_prefill_embeds(IDS, 3)
    want_chunks = list(jpipe.synthesize_streaming(pre, tr, **STREAM))
    got = list(tpipe.synthesize_streaming(pre, tr, **STREAM))
    _same_chunks(got, want_chunks)
    buf, p_len, trb = _bufs(tpipe)
    fj, nj = _jax_decode(jpipe, buf, p_len, trb)
    (dec,) = tpipe._codec_cache[("chunk", 3, 64)]
    n = int(dec.num) - int(dec.fin)
    assert n == nj and sum(len(c) for c in got) == n * tpipe.codec_cfg.total_upsample
    np.testing.assert_array_equal(dec.frames[0, :n].numpy(), fj[:n])
    frames, kept = tpipe._decode(torch.as_tensor(buf), p_len, torch.as_tensor(trb))
    want = _assembled(tpipe._codec_window, frames[:kept].numpy(), 3, 4, 2,
                      tpipe.codec_cfg.total_upsample, tpipe.cfg.num_code_groups)
    np.testing.assert_array_equal(np.concatenate(got), want)


def test_streams_of_one_bucket_consumed_in_turn(models):  # noqa: F811
    """Two streams of the same bucket, their chunks taken in turn (zipped),
    each decode on a state of its own and give bitwise their solo runs'
    chunks; a stream closed before its end frees its state for the next."""
    from itertools import zip_longest

    _, tpipe = _pipes(models, **DECODE)
    reqs = [tpipe.build_prefill_embeds(IDS, 3),
            tpipe.build_prefill_embeds(np.array([[7, 1, 4, 30]], np.int32), 2)]
    solo = [list(tpipe.synthesize_streaming(*r, **STREAM)) for r in reqs]
    assert len(tpipe._codec_cache[("chunk", 3, 64)]) == 1
    turns = [[], []]
    for pair in zip_longest(*(tpipe.synthesize_streaming(*r, **STREAM) for r in reqs)):
        for out, c in zip(turns, pair):
            if c is not None:
                out.append(c)
    assert len(tpipe._codec_cache[("chunk", 3, 64)]) == 2
    for got, want in zip(turns, solo):
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    first = tpipe.synthesize_streaming(*reqs[0], **STREAM)
    next(first)
    first.close()
    assert [list(c) for c in tpipe.synthesize_streaming(*reqs[1], **STREAM)] == \
        [list(c) for c in solo[1]]
    assert not any(d.lock.locked() for d in tpipe._codec_cache[("chunk", 3, 64)])
    assert len(tpipe._codec_cache[("chunk", 3, 64)]) == 2


def test_program_keys_match_tts_tpu(models, monkeypatch):  # noqa: F811
    """After the same requests (two trailing buckets, the first repeated,
    batches of 2 and 3, a stream) the port's `_decode_fn`, `_batch_fns` and
    `_codec_cache` hold tts_tpu's keys. tts_tpu's `_build_*` methods are
    stubbed to a 3-frame result (its codec programs run): the keys are set
    before a program runs, and the port's 8-frame requests take the same
    codec bucket (8 frames)."""
    g = models["jc"].num_code_groups

    def solo(self, tb):
        return lambda params, buf, p_len, tr: (jnp.zeros((self.dcfg.max_frames, g), jnp.int32),
                                               jnp.int32(3))

    def batch(self, bsz):
        return lambda params, buf, pad, tr: (
            jnp.zeros((bsz, self.dcfg.max_frames, g), jnp.int32), jnp.full((bsz,), 3))

    def chunk(self, n):
        return lambda params, kv, hid, save0, tr, num, budget: (
            kv, hid, jnp.zeros((n, g), jnp.int32), save0, np.int32(3), np.int32(3),
            np.bool_(True))

    monkeypatch.setattr(JaxPipeline, "_build_decode", solo)
    monkeypatch.setattr(JaxPipeline, "_build_decode_batch", batch)
    monkeypatch.setattr(JaxPipeline, "_build_prefill", lambda self: lambda *a: (None, None))
    monkeypatch.setattr(JaxPipeline, "_build_chunk", chunk)
    jpipe, tpipe = _pipes(models, **DECODE)
    long_ids = np.arange(5, 80, dtype=np.int32)[None]
    for ids in (IDS, long_ids, IDS):
        jpipe.synthesize_ids(ids, language_id=3)
        tpipe.synthesize_ids(ids, language_id=3)
    prompts = [(IDS, 3), (np.array([[7, 1, 4, 30, 22, 8]], np.int32), 2), (IDS[:, :2], 5)]
    for rows in (2, 3):
        jpipe.synthesize_from_prefill_batch([jpipe.build_prefill_embeds(i, la)
                                             for i, la in prompts[:rows]])
        tpipe.synthesize_from_prefill_batch([tpipe.build_prefill_embeds(i, la)
                                             for i, la in prompts[:rows]])
    pre, tr = jpipe.build_prefill_embeds(IDS, 3)
    list(jpipe.synthesize_streaming(pre, tr, chunk_frames=3, window=4, left_context=2))
    list(tpipe.synthesize_streaming(pre, tr, chunk_frames=3, window=4, left_context=2))
    assert sorted(tpipe._decode_fn) == sorted(jpipe._decode_fn) == [64, 128]
    assert sorted(tpipe._batch_fns) == sorted(jpipe._batch_fns)
    assert sorted(map(str, tpipe._codec_cache)) == sorted(map(str, jpipe._codec_cache))
    assert ("chunk", 3, 64) in tpipe._codec_cache and 4 in tpipe._codec_cache
    assert (8, "dev", None) in tpipe._codec_cache and (8, "dev", 3) in tpipe._codec_cache


def test_a_frame_past_the_cache_raises(models):  # noqa: F811
    """A request whose frames reach a talker row the cache does not have (a
    520-row talker, a 512-row prefill: 8 frames fit) raises, as the
    host-driven loop raised at that frame's talker step; the programs
    freeze it there. One that stops before does not."""
    tc = _cfgs(tq, talker_len=520)
    pipe = QwenTTSPipeline(models["tp"], tc, models["tcp"], models["tcc"],
                           QwenDecodeConfig(max_frames=12))
    rng = np.random.default_rng(62)
    pre = (rng.standard_normal((1, 512, 128)) * 0.3).astype(np.float32)
    tr = (rng.standard_normal((1, 5, 128)) * 0.3).astype(np.float32)
    with pytest.raises(ValueError, match="cache of 520 rows"):
        pipe.synthesize_from_prefill(pre, tr)
    (dec,) = pipe._decode_fn[64]
    assert bool(dec.over) and int(dec.num) == 8 and int(dec.pos) == 520
    eos = int(dec.frames[0, 3, 0])
    stop = QwenTTSPipeline(models["tp"], _cfgs(tq, eos, talker_len=520), models["tcp"],
                           models["tcc"], QwenDecodeConfig(max_frames=12))
    assert stop.synthesize_from_prefill(pre, tr)[1]["frames"] <= 3
    with pytest.raises(ValueError, match="cache of 520 rows"):
        list(pipe.synthesize_streaming(pre, tr, chunk_frames=3, window=4, left_context=2))


def test_qwen_weights_drop_the_programs(models):  # noqa: F811
    """Setting params or codec_params, or replacing a tensor of them in
    place, drops the programs; the next request builds them on the new
    weights and equals a fresh pipeline's."""
    _, pipe = _pipes(models, **DECODE)
    pipe.synthesize_ids(IDS, language_id=3)
    (old,) = pipe._decode_fn[64]
    assert pipe._codec_cache
    pipe.codec_params = {**models["tcp"]}
    assert not pipe._decode_fn and not pipe._codec_cache
    pipe.synthesize_ids(IDS, language_id=3)
    assert pipe._decode_fn[64][0] is not old
    other = {**tq.init_talker_params(models["tc"], torch.Generator().manual_seed(7)),
             **tq.init_predictor_params(models["tc"], torch.Generator().manual_seed(8))}
    pipe.params = other
    assert not pipe._decode_fn and not pipe._codec_cache
    got, _ = pipe.synthesize_ids(IDS, language_id=3)
    fresh = QwenTTSPipeline(other, models["tc"], models["tcp"], models["tcc"],
                            QwenDecodeConfig(**DECODE))
    np.testing.assert_array_equal(got, fresh.synthesize_ids(IDS, language_id=3)[0])
    (kept,) = pipe._decode_fn[64]
    pipe.params["codec_head"] = pipe.params["codec_head"].clone()
    pipe.synthesize_ids(IDS, language_id=3)
    assert pipe._decode_fn[64][0] is not kept


# ---------------------------------------------------------------- kernel 13

def test_device_attention_plan_mirrors_the_kernel():
    """csrc/decode_attention.cu's plan_slice is cluster_plan; cluster_bound
    is the most CTAs and rows cluster_plan gives up to top, and the C
    entries refuse what does not cover it; the rank-0 merge reads the
    plan's CTAs alone; the wrapper refuses a device kv_len without a top
    inside the buffer or of another dtype."""
    from pathlib import Path

    from tts_tpu_torch.ops.decode_attention import (_CTA_ROWS, _MAX_CTAS, _ONE_CTA_ROWS,
                                                    cluster_bound, cluster_plan,
                                                    decode_gqa_attention)

    src = " ".join((Path(rq.__file__).parents[1] / "csrc" / "decode_attention.cu").read_text()
                   .split())
    for part in ("if (kv_len <= 128) { ctas = 1, rows = kv_len; return; }",
                 "const int c = min(DA_MAX_CTAS, (kv_len + 63) / 64); rows = (kv_len + c - 1) "
                 "/ c; ctas = (kv_len + rows - 1) / rows;",
                 "if (kv_len < 1 || kv_len > a.top) __trap();",
                 "if (live > nct || rows > a.stride) __trap();",
                 "const int n = max(0, min(kv_len - r0, rows));",
                 "for (int r = 0; r < live; ++r) M = fmaxf(M, cluster.map_shared_rank(m_s, r)[g]);",
                 "for (int r = 0; r < live; ++r) { const float w",
                 "rows < 1 || (long long)ctas * rows < top)",
                 "constexpr int DA_MAX_CTAS = 8;"):
        assert part in src, part
    assert (_ONE_CTA_ROWS, _CTA_ROWS, _MAX_CTAS) == (128, 64, 8)
    for top in (1, 17, 128, 129, 200, 511, 640, 767, 2047):
        ctas, rows = cluster_bound(top)
        plans = [cluster_plan(n) for n in range(1, top + 1)]
        assert ctas == max(c for c, _ in plans) and rows == max(r for _, r in plans)
        assert ctas * rows >= top
    q, k = torch.zeros(1, 4, 64), torch.zeros(1, 2, 32, 64)
    with pytest.raises(ValueError, match="top"):
        decode_gqa_attention(q, k, k, torch.tensor(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="top"):
        decode_gqa_attention(q, k, k, torch.tensor(3, dtype=torch.int32), top=33)
    with pytest.raises(TypeError, match="int32"):
        decode_gqa_attention(q, k, k, torch.tensor(3), top=32)


@pytest.mark.parametrize("t", [64, 512])
def test_device_attention_twin_matches_the_host_twin(t):
    """Kernel 13's twin at a device kv_len (every block of the buffer, the
    rows >= kv_len masked) against its host form at every kv_len 1..T: one
    block (T 64) and two of 256 rows (T 512)."""
    from tts_tpu_torch.ops.decode_attention import decode_gqa_attention_plain

    g = torch.Generator().manual_seed(6)
    q = torch.randn(1, 4, 64, generator=g)
    k, v = torch.randn(1, 2, t, 64, generator=g), torch.randn(1, 2, t, 64, generator=g)
    for n in range(1, t + 1):
        host = decode_gqa_attention_plain(q, k, v, n, 0.125)
        dev = decode_gqa_attention_plain(q, k, v, torch.tensor(n, dtype=torch.int32), 0.125,
                                         top=t)
        torch.testing.assert_close(dev, host, atol=1e-6, rtol=1e-5)
