"""The IndexTTS programs (runtime/indextts.py: the encode program, a
`_Decode`'s prefill and step programs over a state on the device, the
vocode programs) against tts_tpu on the CPU, fp32 on both sides, at
tests/test_torch_indextts.py's small configs (GPT64 for the step, TINY
for the pipelines, the same arrays on both sides): gpt_step at a device
length on every route (False and True with and without a text hole at B
1 and 3, "step" at B 1), requests stopped at the prefill's token, inside a replay
(one decode step a replay, and four) and at the max_gen cap, a batch whose
rows stop at different steps, the encode, the programs' keys, the weights'
bookkeeping and a max_gen past the mel positions.

On the CPU every program runs its body eagerly on the same state a card's
graph replays; the kernel wrappers take their plain twins. The stop is
steered through the lm_head: its stop column gets a bias of -1e4 (never:
the cap) or +1e4 (the prefill's token), or a copy of the column of a token
x that the unstopped decode first emits at step f, with a bias 1e-5 above
x's, so that the stop token wins exactly where x first would.

Tolerances are tests/test_torch_indextts.py's: a GPT step's logits and
hiddens within STEP_TOL (atol 5e-5, rtol 5e-4), the token ids and counts
exactly tts_tpu's, int16 audio within 4 LSB (_same_audio), the encodes
within 1e-4 relative L2."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_indextts import (GPT64, STEP_TOL, TINY, VOC, _conv, _rel, _same_audio,
                                       _t, gpt64)  # noqa: F401  (the fixture)
from tts_tpu.kv.cache import KVCache as JKV
from tts_tpu.models import bigvgan as jbv
from tts_tpu.models import indextts as ji
from tts_tpu.runtime.indextts import IndexTTSPipeline as JaxPipeline
from tts_tpu_torch.kv.cache import KVCache
from tts_tpu_torch.models import bigvgan as tbv
from tts_tpu_torch.models import indextts as ti
from tts_tpu_torch.runtime import indextts as ri
from tts_tpu_torch.runtime.indextts import IndexTTSPipeline

MAX_GEN = 12
AUDIO = (np.random.default_rng(0).standard_normal(4000) * 3000).astype(np.int16)
IDS = np.array([[5, 9, 13]], np.int32)
RATES = dict(sample_rate=8000, n_fft=256, hop=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the step

@pytest.mark.parametrize("route,hole,b", [
    (False, False, 1), (False, True, 3), (True, True, 1), (True, False, 3), ("step", False, 1)])
def test_gpt_step_at_a_device_length_matches_jax(gpt64, route, hole, b):  # noqa: F811
    """After a 5-row prefill at host length 0, a 3-row chunk and two
    decode steps with kv.length a device int32 and a bound of 48 rows of a
    64-row cache, against tts_tpu's gpt_step at host lengths 5, 8 and 9
    (its kernels in interpret mode): the logits and hiddens each call, the
    route taken, and the cache rows written. With a hole each row's text
    positions [1 + r, 3 + r) are masked, which degrades "step" to kernel 11
    on both sides; "step" at B 1 without one takes kernel 12's device form
    (its twin here)."""
    from jax.experimental.pallas import tpu as pltpu

    jc, tc, jp, tp = gpt64["jc"], gpt64["tc"], gpt64["jp"], gpt64["tp"]
    rng = np.random.default_rng(31)
    d, t_max = jc.gpt_dim, 64
    pre = rng.standard_normal((b, 5, d)).astype(np.float32)
    xs = [rng.standard_normal((b, s, d)).astype(np.float32) for s in (3, 1, 1)]
    valid = np.ones((b, t_max), bool)
    for r in range(b):
        valid[r, 1 + r:3 + r] = not hole
    kvv = (valid if b > 1 else valid[0]) if hole else None
    jvalid, tvalid = (None, None) if kvv is None else (jnp.asarray(kvv), _t(kvv))
    vec = np.ones((b, jc.num_mel_codes), np.float32)
    vec[:, 3] = 0.9
    jkv = JKV.create(jc.gpt_layers, b, jc.gpt_heads, t_max, jc.gpt_head_dim, jnp.float32)
    tkv = KVCache.create(tc.gpt_layers, b, tc.gpt_heads, t_max, tc.gpt_head_dim,
                         torch.float32)
    _, _, jkv = ji.gpt_step(jp, jnp.asarray(pre), jkv, jnp.asarray(vec), jc, jvalid)
    ti.gpt_step(tp, _t(pre), tkv, _t(vec), tc, tvalid)
    pos = torch.tensor(5, dtype=torch.int32)
    dkv = KVCache(tkv.k, tkv.v, pos, bound=48)
    want = {False: False, True: True, "step": "step" if not hole and b == 1 else True}[route]
    assert ti.gpt_route(tp, tc, b, 1, dkv, tvalid, route) == want
    # jitted, as tts_tpu's programs run it (the length a traced value)
    jstep = jax.jit(partial(ji.gpt_step, cfg=jc, fused=route))
    for x in xs:
        with pltpu.force_tpu_interpret_mode():
            lj, hj, jkv = jstep(jp, jnp.asarray(x), jkv, jnp.asarray(vec), kv_valid=jvalid)
        lt, ht, out = ti.gpt_step(tp, _t(x), dkv, _t(vec), tc, tvalid, fused=route)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **STEP_TOL)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **STEP_TOL)
        assert int(out.length) == int(pos) + x.shape[1]
        pos.add_(x.shape[1])
    assert int(pos) == int(jkv.length) == 10
    for got, ref in ((tkv.k, jkv.k), (tkv.v, jkv.v)):
        np.testing.assert_allclose(got[:, :, :, :10].numpy(), np.asarray(ref)[:, :, :, :10],
                                   **STEP_TOL)


# ---------------------------------------------------------------- requests

@pytest.fixture(scope="module")
def small():
    """TINY's models from seeds: the port's init functions (fixed torch
    seeds) for the encoders, the GPT and the BigVGAN (its conv_post x300, so
    int16 sees the waveform), numpy draws for cond_layer and conds; the
    same arrays as tts_tpu's tree ("jp") and the port's ("tp"). tts_tpu's
    pipelines ("jax", by quantize) are built once: a test swaps their
    params, which their jitted programs take as an argument, so each
    program compiles once for the module."""
    jc, tc = ji.IndexTTSConfig(**TINY), ti.IndexTTSConfig(**TINY)
    voc = dict(VOC, num_mels=jc.gpt_dim)
    jv, tv = jbv.BigVGANConfig(**voc), tbv.BigVGANConfig(**voc)
    gen = torch.Generator().manual_seed(11)
    tree = {"conformer": ti.init_conformer_params(tc, gen),
            "perceiver": ti.init_perceiver_params(tc, gen),
            "ecapa": ti.init_ecapa_params(tc, gen), "gpt": ti.init_gpt_params(tc, gen),
            "bigvgan": tbv.init_params(tv, gen)}
    tree = jax.tree.map(lambda t: t.numpy(), tree)
    tree["bigvgan"]["conv_post"]["w"] = tree["bigvgan"]["conv_post"]["w"] * 300.0
    rng = np.random.default_rng(12)
    c0 = tv.upsample_initial_channel
    tree["cond_layer"] = {"w": (rng.standard_normal((tc.speaker_embed_dim, c0)) * 0.5
                                ).astype(np.float32), "b": np.zeros(c0, np.float32)}
    tree["conds"] = [{"w": (rng.standard_normal((tc.speaker_embed_dim, c)) * 0.5
                            ).astype(np.float32), "b": np.zeros(c, np.float32)}
                     for c in tv.stage_channels]
    jp = jax.tree.map(jnp.asarray, tree)
    m = dict(jc=jc, tc=tc, jv=jv, tv=tv, jp=jp, tp=_conv(jp))
    m["jax"] = {q: JaxPipeline(jp, jc, jv, quantize=q, **RATES) for q in (None, 8)}
    m["jref"] = m["jax"][None].encode_reference(AUDIO)
    return m


def _steered(jp: dict, stop: int, how, x: int | None = None) -> dict:
    """tts_tpu's params with the lm_head's stop column steered (see the
    module's docstring): how "never", "first" or "at" (x's column, 1e-5
    above it)."""
    gpt = dict(jp["gpt"])
    w, bias = np.array(gpt["lm_head"]), np.array(gpt["lm_head_b"])
    if how == "at":
        w[:, stop], bias[stop] = w[:, x], bias[x] + 1e-5
    else:
        bias[stop] = -1e4 if how == "never" else 1e4
    gpt["lm_head"], gpt["lm_head_b"] = jnp.asarray(w), jnp.asarray(bias)
    return {**jp, "gpt": gpt}


def _pair(small, jp: dict, quantize=None) -> tuple:
    """(tts_tpu's pipeline of `quantize` on jp, quantized as its constructor
    does; a new port pipeline on the same arrays)."""
    jpipe = small["jax"][quantize]
    jpipe.params = JaxPipeline(jp, small["jc"], small["jv"], quantize=quantize,
                               **RATES).params
    return jpipe, IndexTTSPipeline(_conv(jp), small["tc"], small["tv"], quantize=quantize,
                                   **RATES)


def _padded(ids: list) -> tuple:
    tb = max(16, -(-max(i.shape[1] for i in ids) // 16) * 16)
    out = np.zeros((len(ids), tb), np.int32)
    for r, i in enumerate(ids):
        out[r, :i.shape[1]] = i[0]
    return out, np.array([i.shape[1] for i in ids], np.int32)


def _first_at(save: np.ndarray, first: int = 2) -> tuple[int, int]:
    """(a token x first emitted at step f >= first, f)."""
    for f in range(first, len(save) - 1):
        if save[f] not in save[:f]:
            return int(save[f]), f
    pytest.fail("no fresh token to stop on")


@pytest.fixture
def decode_steps(monkeypatch):
    """Counts the decode steps the step programs run, frozen ones
    included."""
    calls = []
    one = ri._Decode._one_step
    monkeypatch.setattr(ri._Decode, "_one_step", lambda self: calls.append(1) or one(self))
    return calls


@pytest.mark.parametrize("case", ["cap", "first", "inside", "inside_steps4", "int8_cap",
                                  "int8_first", "int8_inside"])
def test_request_on_the_programs_matches_jax(small, case, decode_steps, monkeypatch):
    """One request through the encode, decode and vocode programs, stopped
    at the prefill's token (no frame: an empty waveform, as tts_tpu's),
    inside a replay (one decode step a replay, and four) or at the max_gen
    cap: the token ids and count exactly tts_tpu's `_decode_fn[(tb,
    max_gen)]`, the audio within 4 LSB of tts_tpu's request, the decode
    steps run (the frozen ones after a stop included) as the host's
    replays queue them, the frozen steps changing no state."""
    quantize = 8 if case.startswith("int8") else None
    how = case.removeprefix("int8_").removesuffix("_steps4")
    steps = 4 if case.endswith("steps4") else 1
    monkeypatch.setattr(ri, "STEPS", steps)
    stop, jref = small["jc"].stop_token, small["jref"]
    ids, tlens = _padded([IDS])

    def decode(jpipe):
        return jpipe._decode_fn(16, MAX_GEN)(jpipe.params, jref[0], jnp.asarray(ids),
                                             np.int32(tlens[0]))

    x = f = None
    if how == "inside":
        jpipe, _ = _pair(small, _steered(small["jp"], stop, "never"), quantize)
        x, f = _first_at(np.asarray(decode(jpipe)[2]))
    steer = {"cap": "never", "first": "first", "inside": "at"}[how]
    jpipe, tpipe = _pair(small, _steered(small["jp"], stop, steer, x), quantize)
    tref = tpipe.encode_reference(AUDIO)
    wj, sj = jpipe.synthesize_ids(IDS, jref, max_gen=MAX_GEN)
    wt, st = tpipe.synthesize_ids(IDS, tref, max_gen=MAX_GEN)
    n_want = {"cap": MAX_GEN, "first": 1}.get(how) or f + 1
    assert st.tokens == sj.tokens == n_want
    _same_audio(wt, wj)
    assert (len(wt) == 0) == (how == "first")
    _, num, jsave = decode(jpipe)
    assert int(num) == n_want
    (dec,) = tpipe._dec_cache[(16, MAX_GEN)]
    np.testing.assert_array_equal(dec.save[0, :n_want].numpy(), np.asarray(jsave)[:n_want])
    most = -(-(MAX_GEN - 1) // steps)
    replays = most if how == "cap" else min(most, 1 + (-(-(n_want - 1) // steps)))
    assert len(decode_steps) == steps * replays
    # the frozen steps changed nothing
    assert int(dec.num) == n_want and int(dec.pos) == dec.p_len + n_want - 1
    assert bool(dec.stop) and bool(dec.fin[0]) == (how != "cap")
    assert not dec.save[0, n_want:].any() and not dec.hiddens[0, n_want:].any()


BATCH = [IDS, np.array([[2, 7, 4, 11, 3]], np.int32), np.arange(1, 19, dtype=np.int32)[None]]


def test_batch_on_the_programs_matches_jax(small):
    """A batch of 3 (mixed text lengths, each with its own reference)
    whose rows stop at different steps (the lm_head steered to a token the
    rows first emit at different steps, or never), through its programs:
    each row's count and token ids exactly tts_tpu's `_dec_cache[("batch",
    3, tb, max_gen)]` program, the audio within 4 LSB of tts_tpu's batch,
    the vocode program keyed as tts_tpu's."""
    stop = small["jc"].stop_token
    rng = np.random.default_rng(3)
    audios = [(rng.standard_normal(n) * 3000).astype(np.int16) for n in (4000, 5000, 3000)]
    ids, tlens = _padded(BATCH)
    jpipe, _ = _pair(small, _steered(small["jp"], stop, "never"))
    jreq = [(i, jpipe.encode_reference(a)) for i, a in zip(BATCH, audios)]
    jlat = jnp.concatenate([r[0] for _, r in jreq], axis=0)

    def decode():
        return jpipe._decode_batch_fn(3, 32, MAX_GEN)(jpipe.params, jlat, jnp.asarray(ids),
                                                      jnp.asarray(tlens))

    save = np.asarray(decode()[2])

    def dones(x):
        return [next((f + 1 for f in range(MAX_GEN) if save[r, f] == x), MAX_GEN)
                for r in range(3)]

    # the most distinct counts, then the most rows stopped inside
    x = max(range(stop), key=lambda c: (len(set(dones(c))),
                                        sum(1 < d < MAX_GEN for d in dones(c))))
    want = dones(x)
    assert len(set(want)) >= 2
    jpipe, tpipe = _pair(small, _steered(small["jp"], stop, "at", x))
    treq = [(i, tpipe.encode_reference(a)) for i, a in zip(BATCH, audios)]
    wj, sj = jpipe.synthesize_ids_batch(jreq, max_gen=MAX_GEN)
    wt, st = tpipe.synthesize_ids_batch(treq, max_gen=MAX_GEN)
    _, jdone, jsave = decode()
    (dec,) = tpipe._dec_cache[("batch", 3, 32, MAX_GEN)]
    done = dec.cnt.numpy()
    np.testing.assert_array_equal(done, np.asarray(jdone))
    np.testing.assert_array_equal(done, want)
    assert st["tokens"] == sj["tokens"] == sum(want)
    for r in range(3):
        np.testing.assert_array_equal(dec.save[r, :done[r]].numpy(),
                                      np.asarray(jsave)[r, :done[r]])
    for got, ref in zip(wt, wj):
        _same_audio(got, ref)
    fb = min(max(8, -(-(max(done) - 2) // 8) * 8), MAX_GEN)
    assert list(tpipe._voc_cache) == [("batch", fb, int(sum(done > 2)))]
    assert ("batch", fb, int(sum(done > 2))) in jpipe._voc_cache


# ---------------------------------------------------------------- bookkeeping

def test_encode_and_program_keys_match_tts_tpu(small):
    """Two references of two buckets through the encode programs (within
    1e-4 relative L2 of tts_tpu's), requests of two text buckets (the first
    repeated) and a batch of 3: the port's `_enc_cache`, `_dec_cache` and
    `_voc_cache` hold a new tts_tpu pipeline's keys, a decode key one state
    (each request freed its own), none held."""
    jpipe = JaxPipeline(small["jp"], small["jc"], small["jv"], **RATES)
    tpipe = IndexTTSPipeline(small["tp"], small["tc"], small["tv"], **RATES)
    refs = []
    for audio in (AUDIO, np.tile(AUDIO, 9)):
        jr, tr = jpipe.encode_reference(audio), tpipe.encode_reference(audio)
        for got, ref in [(tr[0], jr[0]), (tr[1], jr[1])] + list(zip(tr[2], jr[2])):
            assert got.shape == ref.shape and _rel(got.numpy(), ref) < 1e-4
        refs.append((jr, tr))
    (jr, tr), _ = refs
    for ids in (IDS, np.arange(2, 20, dtype=np.int32)[None], IDS):
        jpipe.synthesize_ids(ids, jr, max_gen=MAX_GEN)
        tpipe.synthesize_ids(ids, tr, max_gen=MAX_GEN)
    jpipe.synthesize_ids_batch([(i, jr) for i in BATCH], max_gen=MAX_GEN)
    tpipe.synthesize_ids_batch([(i, tr) for i in BATCH], max_gen=MAX_GEN)
    assert sorted(tpipe._enc_cache) == sorted(jpipe._enc_cache) == [32768, 65536]
    for mine, theirs in ((tpipe._dec_cache, jpipe._dec_cache),
                         (tpipe._voc_cache, jpipe._voc_cache)):
        assert sorted(map(str, mine)) == sorted(map(str, theirs))
    assert (16, MAX_GEN) in tpipe._dec_cache and ("batch", 3, 32, MAX_GEN) in tpipe._dec_cache
    assert all(len(v) == 1 and not v[0].lock.locked() for v in tpipe._dec_cache.values())


def test_indextts_weights_drop_the_programs(small):
    """Setting params, replacing a tensor of them or casting one drops
    every program; the next request builds them on the new weights and
    equals a fresh pipeline's."""
    pipe = IndexTTSPipeline(small["tp"], small["tc"], small["tv"], **RATES)
    ref = pipe.encode_reference(AUDIO)
    pipe.synthesize_ids(IDS, ref, max_gen=MAX_GEN)
    (old,) = pipe._dec_cache[(16, MAX_GEN)]
    assert pipe._enc_cache and pipe._voc_cache
    other = _conv(_steered(small["jp"], small["jc"].stop_token, "never"))
    pipe.params = other
    assert not pipe._enc_cache and not pipe._dec_cache and not pipe._voc_cache
    got, _ = pipe.synthesize_ids(IDS, ref, max_gen=MAX_GEN)
    assert pipe._dec_cache[(16, MAX_GEN)][0] is not old
    fresh = IndexTTSPipeline(other, small["tc"], small["tv"], **RATES)
    np.testing.assert_array_equal(got, fresh.synthesize_ids(IDS, ref, max_gen=MAX_GEN)[0])
    (kept,) = pipe._dec_cache[(16, MAX_GEN)]
    pipe.params["gpt"]["lm_head_b"] = pipe.params["gpt"]["lm_head_b"].clone()
    pipe.synthesize_ids(IDS, ref, max_gen=MAX_GEN)
    assert pipe._dec_cache[(16, MAX_GEN)][0] is not kept and len(pipe._voc_cache) == 1
    pipe.params["bigvgan"]["conv_pre"]["b"] = pipe.params["bigvgan"]["conv_pre"]["b"].double()
    pipe._programs()
    assert not pipe._enc_cache and not pipe._dec_cache and not pipe._voc_cache


def test_max_gen_past_the_mel_positions_raises(small):
    """A max_gen past the learned mel positions raises before any decode
    program is built (tts_tpu's gather would clamp it)."""
    pipe = IndexTTSPipeline(small["tp"], small["tc"], small["tv"], **RATES)
    ref = pipe.encode_reference(AUDIO)
    rows = pipe.params["gpt"]["mel_pos"].shape[0]
    with pytest.raises(ValueError, match="mel positions"):
        pipe.synthesize_ids(IDS, ref, max_gen=rows + 1)
    with pytest.raises(ValueError, match="mel positions"):
        pipe.synthesize_ids_batch([(IDS, ref), (IDS, ref)], max_gen=rows + 1)
    assert not pipe._dec_cache
