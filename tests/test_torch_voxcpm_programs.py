"""The VoxCPM programs (runtime/voxcpm.py: the encode program, a `_Decode`'s
prefill and step programs over a state on the device, the VAE programs)
against tts_tpu on the CPU, fp32 on both sides, at tests/test_torch_voxcpm.py's
small configs (the same arrays on both sides, tts_tpu's CFM draws passed as
`noise=`): voxcpm_main_step at a device length (the "step" route through
kernel 12's device form and True through kernel 11, their twins here, and
False, each against tts_tpu's fused=False step); requests whose stop falls at
min_latents, inside the loop and not at all (the cap), float and int8, the
v1.5 layout at VoxCPM's head geometry (16/2 heads x 64, where the kernel
routes hold) and two VoxCPM-2 modes; a batch of 3 whose rows stop at
different steps and a mixed-mode v2 batch; a stream stopped inside; the
encode; the programs' keys; the weights' bookkeeping; a short `noise`.

On the CPU every program runs its body eagerly on the same state a card's
graph replays; the kernel wrappers take their plain twins. The stop is
steered through the stop head: its bias +1e4 on the stop logit (a stop at
min_latents) or -1e4 (never: the cap); to stop inside the loop, a request
that never stops first records the stop head's inputs at every step (on
the port's side, float64; the head does not move them), and a head is
chosen whose stop logit first passes 0 inside the loop, at least 1e-3 from
0 at every step it decides (a seeded direction of the 32 inputs and a bias
between two of the logits the steps reach; the FSQ codes of a random model
repeat, so a linear head cannot part every step).

Tolerances are tests/test_torch_voxcpm.py's: a dual-LM step's dit_hidden
within STEP_TOL (atol 5e-6, rtol 2e-5), the stop flags and latent counts
exactly tts_tpu's, int16 audio within 1 LSB (_same_audio), stream chunks
within 1 LSB of tts_tpu's stream and bitwise the window assembly over the
request's own latents, the encodes within FN_TOL (atol 2e-5, rtol 1e-4)."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_streaming import _assembled, _same_chunks
from tests.test_torch_voxcpm import (FN_TOL, P_IDS, STEP_TOL, T_IDS, _audio, _caches, _cfg,
                                     _conv, _jax_noise, _np, _same_audio, _t,
                                     models)  # noqa: F401  (the fixture)
from tts_tpu.models import voxcpm as jv
from tts_tpu.runtime.voxcpm import VoxCPMDecodeConfig as JaxDecodeConfig
from tts_tpu.runtime.voxcpm import VoxCPMPipeline as JaxPipeline
from tts_tpu_torch.kv.cache import KVCache
from tts_tpu_torch.models import voxcpm as tv
from tts_tpu_torch.runtime import voxcpm as rv
from tts_tpu_torch.runtime.voxcpm import VoxCPMDecodeConfig, VoxCPMPipeline

LATENTS = 8
MIN = 2
MARGIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack_cfg(mod, models):
    """TINY with base and residual stacks at VoxCPM's head geometry (the
    fixture's `jsp` tree: 128 wide, 16/2 heads x 64, 64 positions)."""
    s = mod.LlamaStackConfig(**{k: getattr(models["scfg"], k) for k in (
        "hidden_size", "num_heads", "num_kv_heads", "head_dim", "ffn_dim", "num_layers",
        "max_seq_len")})
    return dataclasses.replace(_cfg(mod), base=s, residual=dataclasses.replace(s, num_layers=1))


# ---------------------------------------------------------------- the step

@pytest.mark.parametrize("route,b", [(False, 1), (True, 1), ("step", 1), (False, 2),
                                     ("step", 2)])
def test_main_step_at_a_device_length_matches_jax(models, route, b):
    """A 12-position prefill at host length 0 (B 1: an (S,) audio mask and a
    device valid_len of 9, then the caches rewound on the device; B 2: a
    (B, S) mask with row 1 left-padded by 3 and per-row key validity), then
    three decode steps with the length a device int32 and a bound of 48
    rows of a 64-row cache, against tts_tpu's jitted voxcpm_main_step at
    host lengths: dit_hidden and the stop flag each call, the route taken
    (at B 2 the key validity degrades "step" to kernel 11), and the cache
    rows written."""
    jc, tc = _stack_cfg(jv, models), _stack_cfg(tv, models)
    jp, tp = models["jsp"], _conv(models["jsp"])
    rng = np.random.default_rng(71)
    hid = jc.base.hidden_size
    h = rng.standard_normal((b, 12, hid)).astype(np.float32)
    fe = rng.standard_normal((b, 12, hid)).astype(np.float32)
    mask = rng.random((b, 12)) < 0.5
    jbk, jrk = _caches(jv, jc, b)
    tbk, trk = _caches(tv, tc, b)
    kw_j, kw_t = {}, {}
    if b == 2:
        valid = np.arange(64)[None, :] >= np.array([0, 3])[:, None]
        kw_j, kw_t = dict(kv_valid=jnp.asarray(valid)), dict(kv_valid=_t(valid))
        cj, ct = jnp.asarray(mask), _t(mask)
        dj, sj, jbk, jrk = jv.voxcpm_main_step(jp, jnp.asarray(h), jnp.asarray(fe), cj, jbk,
                                               jrk, jc, **kw_j)
        dt_, st, _, _ = tv.voxcpm_main_step(tp, _t(h), _t(fe), ct, tbk, trk, tc, **kw_t)
        pos = torch.tensor(12, dtype=torch.int32)
    else:
        cj, ct = jnp.asarray(mask[0]), _t(mask[0])
        dj, sj, jbk, jrk = jv.voxcpm_main_step(jp, jnp.asarray(h), jnp.asarray(fe), cj, jbk,
                                               jrk, jc, valid_len=jnp.int32(9))
        dt_, st, _, _ = tv.voxcpm_main_step(tp, _t(h), _t(fe), ct, tbk, trk, tc,
                                            valid_len=torch.tensor(9, dtype=torch.int32))
        jbk, jrk = jbk.rewind(9), jrk.rewind(9)
        pos = torch.tensor(0, dtype=torch.int32)
        KVCache(tbk.k, tbk.v, pos).rewind(torch.tensor(9, dtype=torch.int32))
        assert int(pos) == 9
    np.testing.assert_allclose(dt_.numpy(), _np(dj), **STEP_TOL)
    np.testing.assert_array_equal(st.numpy(), _np(sj))
    dbk, drk = KVCache(tbk.k, tbk.v, pos, bound=48), KVCache(trk.k, trk.v, pos, bound=48)
    r = tv.stack_routes(tp["base"], tc.base, b, 1, dbk, kw_t.get("kv_valid"), route)
    want = {False: (False, False), True: (False, True),
            "step": (True, False) if b == 1 else (False, True)}[route]
    assert (r.step, r.qkv) == want
    jstep = jax.jit(partial(jv.voxcpm_main_step, cfg=jc))
    start = int(pos)
    for _ in range(3):
        x = rng.standard_normal((b, 1, hid)).astype(np.float32)
        dj, sj, jbk, jrk = jstep(jp, jnp.asarray(x), jnp.asarray(x), jnp.int32(0), jbk, jrk,
                                 kv_valid=kw_j.get("kv_valid"))
        dt_, st, out, _ = tv.voxcpm_main_step(tp, _t(x), _t(x), 0, dbk, drk, tc,
                                              kv_valid=kw_t.get("kv_valid"), fused=route)
        np.testing.assert_allclose(dt_.numpy(), _np(dj), **STEP_TOL)
        np.testing.assert_array_equal(st.numpy(), _np(sj))
        assert int(out.length) == int(pos) + 1
        pos.add_(1)
    end = start + 3
    assert int(pos) == int(jbk.length) == end
    for got, ref in ((tbk.k, jbk.k), (tbk.v, jbk.v), (trk.k, jrk.k), (trk.v, jrk.v)):
        np.testing.assert_allclose(got[:, :, :, start:end].numpy(),
                                   _np(ref)[:, :, :, start:end], **STEP_TOL)


# ---------------------------------------------------------------- steering

def _stop_inputs(run, pipe) -> np.ndarray:
    """run() on the port, recording the stop head's inputs at every call
    (float64): (rows, steps, 32), the prefill's call dropped."""
    rec, real = [], tv._linear

    def spy(x, p):
        if p is pipe.params["stop_head"]:
            rec.append(x.detach().double().numpy()[:, -1])
        return real(x, p)

    tv._linear = spy
    try:
        run()
    finally:
        tv._linear = real
    return np.stack(rec[1:], axis=1)


def _counts(d: np.ndarray, shift: float, caps) -> tuple:
    """Each row's latents where a step stops once d + shift > 0 (d: (rows,
    steps) stop-minus-go logits before the bias), and the least |d + shift|
    the decisions read."""
    counts, least = [], np.inf
    for r, cap in enumerate(caps):
        c = cap
        for k in range(MIN - 1, cap):
            least = min(least, abs(d[r, k] + shift))
            if d[r, k] + shift > 0:
                c = k + 1
                break
        counts.append(c)
    return counts, least


def _steer(x: np.ndarray, caps, rows_apart: bool, lo: int = MIN) -> tuple:
    """A stop head (w, b) for which rows stop inside the loop, past `lo`
    latents (a batch: at the most distinct counts), every decision at
    least MARGIN from its tie: over seeded directions v of the 32 inputs,
    the bias between two of the logits x . v the steps reach. Returns (w,
    b, counts)."""
    rng = np.random.default_rng(5)
    best = None
    for _ in range(64):
        v = rng.standard_normal(x.shape[-1]).astype(np.float32)
        d = x @ v.astype(np.float64)
        vals = np.sort(np.unique(-d[:, MIN - 1:]))
        for shift in ((vals[:-1] + vals[1:]) / 2).astype(np.float32):
            counts, least = _counts(d, float(shift), caps)
            inside = sum(lo < c < cap for c, cap in zip(counts, caps))
            if least < MARGIN or not inside:
                continue
            score = (len(set(counts)) if rows_apart else 0, inside, least)
            if best is None or score > best[0]:
                best = (score, v, shift, counts)
    assert best is not None, ("no stop head stops a row inside the loop", [
        [len({tuple(v) for v in row[:k + 1]}) for k in range(row.shape[0])] for row in x])
    _, v, shift, counts = best
    w = np.zeros((x.shape[-1], 2), np.float32)
    w[:, 1] = v
    return w, np.array([0.0, shift], np.float32), counts


def _shifted(jp: dict, shift: float) -> dict:
    """tts_tpu's tree with the stop logit's bias moved by `shift`."""
    b = np.array(jp["stop_head"]["b"])
    b[1] = np.float32(b[1] + shift)
    return {**jp, "stop_head": {**jp["stop_head"], "b": jnp.asarray(b)}}


def _headed(jp: dict, w: np.ndarray, b: np.ndarray) -> dict:
    """tts_tpu's tree with the stop head (w, b)."""
    return {**jp, "stop_head": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}


# ---------------------------------------------------------------- requests

@pytest.fixture(scope="module")
def jax_pipes(models):
    """tts_tpu's pipelines, built once (a test swaps their params, which
    their jitted programs take as an argument, so each program compiles
    once for the module): the v1.5 layout at VoxCPM's head geometry (float
    and int8), the v2 TINY, the v1.5 TINY."""
    dec = JaxDecodeConfig(max_latents=LATENTS, min_latents=MIN, seed=11)
    jsc = _stack_cfg(jv, models)
    jc2 = _cfg(jv, True, noise=False)
    return {"stack": JaxPipeline(models["jsp"], jsc, models["jvae"], dec),
            "stack8": JaxPipeline(models["jsp"], jsc, models["jvae"], dec, quantize=8),
            "v2": JaxPipeline(models["jp"], jc2, models["jvae2"], dec),
            "v15": JaxPipeline(models["jp"], models["jc"], models["jvae"], dec)}


def _kind(models, kind: str) -> tuple:
    """(tts_tpu's tree, the port's config, the port's VAE, quantize) of a
    jax_pipes entry."""
    if kind.startswith("stack"):
        return (models["jsp"], _stack_cfg(tv, models), models["tvae"],
                8 if kind == "stack8" else None)
    if kind == "v2":
        return models["jp"], _cfg(tv, True, noise=False), models["tvae2"], None
    return models["jp"], models["tc"], models["tvae"], None


def _pair(models, jax_pipes, kind: str, jp: dict) -> tuple:
    """(tts_tpu's pipeline of `kind` on jp, quantized as its constructor
    does; a new port pipeline on the same arrays)."""
    _, tc, tvae, q = _kind(models, kind)
    jpipe = jax_pipes[kind]
    jpipe.params = JaxPipeline(jp, jpipe.cfg, jpipe.vae_params, jpipe.dcfg, quantize=q).params
    tpipe = VoxCPMPipeline(_conv(jp), tc, tvae,
                           VoxCPMDecodeConfig(max_latents=LATENTS, min_latents=MIN, seed=11),
                           quantize=q)
    return jpipe, tpipe


V2_KW = {"voice_design": dict(target_ids=T_IDS),
         "continuation": dict(target_ids=T_IDS, prompt_audio=_audio(260, 2),
                              prompt_ids=P_IDS)}


def _request(pipe, mode: str, noise=None, seed: int = 11):
    """A request on tts_tpu's pipeline (noise None: its own draws from
    `seed`) or the port's (tts_tpu's draws passed)."""
    kw = {"seed": seed} if noise is None else {"noise": noise}
    if mode == "ids":
        return pipe.synthesize_ids(P_IDS, T_IDS, _audio(200, 0), **kw)
    if mode == "ids_long":
        return pipe.synthesize_ids(P_IDS, np.arange(11, 31, dtype=np.int32)[None], **kw)
    return pipe.synthesize_v2(mode, **V2_KW[mode], **kw)


@pytest.fixture
def latent_steps(monkeypatch):
    """Counts the latent steps the step programs run, frozen ones included."""
    calls = []
    one = rv._Decode._one_step
    monkeypatch.setattr(rv._Decode, "_one_step", lambda self: calls.append(1) or one(self))
    return calls


@pytest.mark.parametrize("kind,mode,how", [
    ("stack", "ids", "first"), ("stack", "ids", "inside"), ("stack", "ids", "cap"),
    ("stack8", "ids", "first"), ("stack8", "ids_long", "inside"), ("stack8", "ids", "cap"),
    ("v2", "voice_design", "inside"), ("v2", "continuation", "inside")])
def test_request_on_the_programs_matches_jax(models, jax_pipes, latent_steps, kind, mode,
                                             how):
    """One request through the encode, decode and VAE programs (v1.5 at
    VoxCPM's head geometry: the "step" route, kernel 12's device form;
    float and int8), its stop at min_latents, inside the loop or at the
    cap: the latent count exactly tts_tpu's, the audio within 1 LSB (int8:
    2), the latent steps run as the host's replays queue them (one frozen
    replay after a stop inside, none at the cap), the frozen step changing
    no state."""
    jp = _kind(models, kind)[0]
    seed, cap = 11, LATENTS
    noise = _jax_noise(seed, LATENTS, 1, _kind(models, kind)[1])
    if how == "inside":
        _, tpipe = _pair(models, jax_pipes, kind, _shifted(jp, -1e4))
        # the first seed whose stop inputs change past the second step (the
        # FSQ codes of a random int8 model can stay put)
        for seed in range(11, 19):
            noise = _jax_noise(seed, LATENTS, 1, _kind(models, kind)[1])
            x = _stop_inputs(lambda: _request(tpipe, mode, noise), tpipe)
            if len({tuple(v) for v in x[0, MIN - 1:]}) > 1:
                break
        w, b, (want,) = _steer(x, [cap], False)
        steered = _headed(jp, w, b)
    else:
        want = MIN if how == "first" else cap
        steered = _shifted(jp, 1e4 if how == "first" else -1e4)
    jpipe, tpipe = _pair(models, jax_pipes, kind, steered)
    wj, sj = _request(jpipe, mode, seed=seed)
    latent_steps.clear()
    wt, st = _request(tpipe, mode, noise)
    assert st["latents"] == sj["latents"] == want
    _same_audio(wt, wj)
    assert len(latent_steps) == (want if want == cap else want + 1)
    (key,) = tpipe._dec_cache
    (dec,) = tpipe._dec_cache[key]
    assert key == (64, LATENTS) and not dec.lock.locked()
    assert int(dec.num) == int(dec.cnt[0]) == want and bool(dec.stop)
    # the prompt: text ids (and audio_start), then every patch of the audio's bucket
    prompt = {"ids": 6 + 8, "ids_long": 23, "voice_design": 3, "continuation": 5 + 16}[mode]
    assert int(dec.pos) == prompt + want
    assert not dec.latents[0, want:].any() and dec.latents[0, want - 1].any()


def test_batch_on_the_programs_matches_jax(models, jax_pipes):
    """A batch of 3 (at VoxCPM's head geometry: kernel 11's route, one with
    prompt audio) whose rows stop at different steps, through its programs:
    each row's count exactly tts_tpu's batch program's, the audio within 1
    LSB, the programs keyed as tts_tpu's."""
    jp = models["jsp"]
    reqs = [(P_IDS, T_IDS), (np.array([[4]], np.int32), np.array([[20]], np.int32)),
            (np.array([[9, 8, 7, 6]], np.int32), T_IDS)]
    audios = [_audio(200, 0), None, None]
    noise = _jax_noise(11, LATENTS, 3, _kind(models, "stack")[1])
    _, tpipe = _pair(models, jax_pipes, "stack", _shifted(jp, -1e4))
    w, b, want = _steer(_stop_inputs(
        lambda: tpipe.synthesize_ids_batch(reqs, audios, noise=noise), tpipe),
        [LATENTS] * 3, True)
    assert len(set(want)) >= 2
    jpipe, tpipe = _pair(models, jax_pipes, "stack", _headed(jp, w, b))
    wj, sj = jpipe.synthesize_ids_batch(reqs, audios)
    wt, st = tpipe.synthesize_ids_batch(reqs, audios, noise=noise)
    assert st["latents"] == sj["latents"] == sum(want)
    spl = tpipe.cfg.samples_per_latent
    for a, b, n in zip(wt, wj, want):
        assert len(a) == n * spl
        _same_audio(a, b)
    assert list(tpipe._batch_fns) == list(jpipe._batch_fns)[-1:] == [("batch", 3, 16, 8)]
    (dec,) = tpipe._batch_fns[("batch", 3, 16, 8)]
    np.testing.assert_array_equal(dec.cnt.numpy(), want)
    assert list(tpipe._voc_cache) == [(3, LATENTS)]


def test_v2_batch_on_the_programs_matches_jax(models, jax_pipes):
    """A mixed-mode synthesize_v2_batch (voice_design, continuation,
    reference_only) whose rows stop at different steps: each row's count
    exactly tts_tpu's, the audio within 1 LSB."""
    jp = models["jp"]
    reqs = [dict(mode="voice_design", target_ids=T_IDS),
            dict(mode="continuation", target_ids=T_IDS[:, :2], prompt_ids=P_IDS,
                 prompt_audio=_audio(260, 2)),
            dict(mode="reference_only", target_ids=np.array([[5, 9, 21, 30]], np.int32),
                 ref_audio=_audio(150, 1))]
    noise = _jax_noise(11, LATENTS, 3, _kind(models, "v2")[1])
    _, tpipe = _pair(models, jax_pipes, "v2", _shifted(jp, -1e4))
    w, b, want = _steer(_stop_inputs(lambda: tpipe.synthesize_v2_batch(reqs, noise=noise),
                                     tpipe), [LATENTS] * 3, True)
    jpipe, tpipe = _pair(models, jax_pipes, "v2", _headed(jp, w, b))
    wj, sj = jpipe.synthesize_v2_batch(reqs)
    wt, st = tpipe.synthesize_v2_batch(reqs, noise=noise)
    assert st["latents"] == sj["latents"] == sum(want) and len(set(want)) >= 2
    for a, b in zip(wt, wj):
        _same_audio(a, b)


def test_stream_on_the_programs_matches_jax(models, jax_pipes):
    """A v1.5 stream (chunk 3) stopped inside the loop: its chunks within 1
    LSB of tts_tpu's stream, bitwise the window assembly over the latents
    of the same request's non-streaming run (whose count is tts_tpu's)."""
    jp = models["jp"]
    segs = [("text", np.concatenate([P_IDS[0], T_IDS[0], [101]]).astype(np.int32))]
    zero = np.zeros((2, 4, 24), np.float32)
    noise = _jax_noise(3, LATENTS, 1, models["tc"])
    _, tpipe = _pair(models, jax_pipes, "v15", _shifted(jp, -1e4))
    w, b, (want,) = _steer(_stop_inputs(
        lambda: list(tpipe.synthesize_streaming(segs, _t(zero), 40, chunk=3, noise=noise)),
        tpipe), [LATENTS], False, lo=3)
    jpipe, tpipe = _pair(models, jax_pipes, "v15", _headed(jp, w, b))
    ref = list(jpipe.synthesize_streaming(segs, jnp.asarray(zero), 40, seed=3, chunk=3))
    got = list(tpipe.synthesize_streaming(segs, _t(zero), 40, chunk=3, noise=noise))
    spl = models["tc"].samples_per_latent
    assert sum(len(c) for c in got) == sum(len(c) for c in ref) == want * spl
    _same_chunks(got, ref)
    text, is_audio, fe, pos = tpipe._prompt_bufs(segs)
    for lat, num, _ in tpipe._latent_steps(text, is_audio, pos, fe, _t(zero), 40,
                                           tpipe._latent_buf(40), 0, noise):
        pass
    assert num == want
    np.testing.assert_array_equal(
        np.concatenate(got), _assembled(tpipe._vae_dec_fn, lat[0, :num].numpy(), 3, 4, 1,
                                        spl, 4))
    assert sorted(tpipe._vae_dec_cache) == [4]
    assert 4 in jpipe._vae_dec_cache


# ---------------------------------------------------------------- bookkeeping

def test_encode_and_program_keys_match_tts_tpu(models):
    """Prompts of two buckets through the encode programs (within FN_TOL of
    tts_tpu's), requests of two latent buckets (the first repeated), a
    batch and a stream: the port's `_enc_cache`, `_batch_fns` and
    `_vae_dec_cache` (its windows) hold a new tts_tpu pipeline's keys;
    `_dec_cache` holds (s_buf, buf) for tts_tpu's buf, s_buf the 64-position
    prompt bucket; a decode key one state (each request freed its own)."""
    dec = dict(max_latents=64, min_latents=3, seed=11)
    jpipe = JaxPipeline(models["jp"], models["jc"], models["jvae"], JaxDecodeConfig(**dec))
    tpipe = VoxCPMPipeline(models["tp"], models["tc"], models["tvae"],
                           VoxCPMDecodeConfig(**dec))
    for audio in (_audio(200, 0), _audio(900, 4)):
        for fj, ft in zip(jpipe.encode_prompt(audio), tpipe.encode_prompt(audio)):
            assert ft.shape == fj.shape
            np.testing.assert_allclose(ft.numpy(), _np(fj), **FN_TOL)
    for t_ids in (T_IDS, T_IDS[:, :1], T_IDS):
        jpipe.synthesize_ids(P_IDS, t_ids)
        tpipe.synthesize_ids(P_IDS, t_ids, noise=_jax_noise(11, 64, 1, models["tc"]))
    reqs = [(P_IDS, T_IDS), (P_IDS, T_IDS[:, :1])]
    jpipe.synthesize_ids_batch(reqs)
    tpipe.synthesize_ids_batch(reqs, noise=_jax_noise(11, 64, 2, models["tc"]))
    segs = [("text", np.concatenate([P_IDS[0], T_IDS[0], [101]]).astype(np.int32))]
    zero = np.zeros((2, 4, 24), np.float32)
    list(jpipe.synthesize_streaming(segs, jnp.asarray(zero), 6, chunk=2))
    list(tpipe.synthesize_streaming(segs, _t(zero), 6, chunk=2,
                                    noise=_jax_noise(11, 64, 1, models["tc"])))
    assert sorted(tpipe._enc_cache) == sorted(jpipe._enc_cache) and len(tpipe._enc_cache) == 2
    assert sorted(tpipe._batch_fns) == sorted(jpipe._batch_fns)
    assert sorted(tpipe._vae_dec_cache) == sorted(k for k in jpipe._vae_dec_cache
                                                   if isinstance(k, int)) == [3]
    assert sorted(buf for _, buf in tpipe._dec_cache) == sorted(jpipe._dec_cache) == [32, 64]
    assert {s for s, _ in tpipe._dec_cache} == {64}
    for table in (tpipe._dec_cache, tpipe._batch_fns):
        assert all(len(v) == 1 and not v[0].lock.locked() for v in table.values())


def test_voxcpm_weights_drop_the_programs(models):
    """Setting params or vae_params, replacing a tensor of them or casting
    one drops every program; the next request builds them on the new
    weights and equals a fresh pipeline's."""
    dec = VoxCPMDecodeConfig(max_latents=LATENTS, min_latents=LATENTS, seed=11)
    noise = _jax_noise(11, LATENTS, 1, models["tc"])
    pipe = VoxCPMPipeline(_conv(models["jp"]), models["tc"], _conv(models["jvae"]), dec)

    def request(p):
        return p.synthesize_ids(P_IDS, T_IDS, _audio(200, 0), noise=noise)[0]

    def tables(p):
        return (p._enc_cache, p._dec_cache, p._batch_fns, p._vae_dec_cache, p._voc_cache)

    request(pipe)
    (old,) = pipe._dec_cache[(64, LATENTS)]
    assert pipe._enc_cache and pipe._voc_cache
    other = _conv(_shifted(models["jp"], 0.5))
    pipe.params = other
    assert not any(tables(pipe))
    got = request(pipe)
    assert pipe._dec_cache[(64, LATENTS)][0] is not old
    np.testing.assert_array_equal(got, request(VoxCPMPipeline(other, models["tc"],
                                                              models["tvae"], dec)))
    (kept,) = pipe._dec_cache[(64, LATENTS)]
    pipe.params["fsq_up"]["b"] = pipe.params["fsq_up"]["b"].clone()
    request(pipe)
    assert pipe._dec_cache[(64, LATENTS)][0] is not kept and len(pipe._voc_cache) == 1
    pipe.vae_params["dec"]["post"]["b"] = pipe.vae_params["dec"]["post"]["b"].double()
    pipe._programs()
    assert not any(tables(pipe))
    request(VoxCPMPipeline(other, models["tc"], models["tvae"], dec))
    pipe._programs()
    pipe.vae_params = models["tvae"]
    assert not any(tables(pipe))


def test_short_noise_raises(models):
    """A `noise` argument of fewer rows than the latents the request makes
    raises after the run, as indexing its missing row did; one of enough
    rows does not."""
    dec = VoxCPMDecodeConfig(max_latents=LATENTS, min_latents=LATENTS, seed=11)
    pipe = VoxCPMPipeline(models["tp"], models["tc"], models["tvae"], dec)
    noise = _jax_noise(11, LATENTS, 1, models["tc"])
    with pytest.raises(IndexError, match="noise"):
        pipe.synthesize_ids(P_IDS, T_IDS, noise=noise[:LATENTS - 1])
    assert pipe.synthesize_ids(P_IDS, T_IDS, noise=noise)[1]["latents"] == LATENTS
