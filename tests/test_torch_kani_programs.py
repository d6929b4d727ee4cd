"""The Kani decode programs (runtime/kani.py's `_Decode`: the prefill, step
and codec programs over a state on the device) against tts_tpu on the CPU,
fp32 on both sides, at tests/test_torch_kani.py's small config: kani_step at
a device position, the repetition penalty at a device count, greedy, beam
and batch requests stopped inside a replay of STEPS decode steps, the
programs' keys, kernel 12's device form's plan, and the bookkeeping that
drops a pipeline's programs when its weights change (F5, BigVGAN, Kani).

On the CPU every program runs its body eagerly on the same state a card's
graph replays; the kernel wrappers take their plain twins. Tolerances are
tests/test_torch_kani.py's, for the same reasons."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.models import kani as jk
from tts_tpu.models import nanocodec as jnc
from tts_tpu.runtime.kani import KaniDecodeConfig as JaxDecodeConfig
from tts_tpu.runtime.kani import KaniPipeline as JaxPipeline
from tts_tpu_torch.kv.cache import KVCache
from tts_tpu_torch.models import kani as tk
from tts_tpu_torch.models import nanocodec as tnc
from tts_tpu_torch.runtime import kani as rk
from tts_tpu_torch.runtime import program
from tts_tpu_torch.runtime.kani import STEPS, KaniDecodeConfig, KaniPipeline
from tts_tpu_torch.weights.convert import params_from_jax

LM = dict(hidden_size=128, num_heads=16, num_kv_heads=8, head_dim=64, ffn_dim=192,
          vocab_size=64, layer_types=("conv", "attn", "conv", "attn"), max_seq_len=64,
          stop_token=-1)
CODEC = dict(base_channels=16, up_sample_rates=(2, 2), kernel_sizes=(3,),
             dilations=(1, 3), activation="half_snake")
IDS = np.array([[3, 9, 4, 17, 2]], np.int32)
PROMPTS = [IDS, np.array([[7, 11, 2, 30, 14, 8]], np.int32), IDS[:, :3]]
STEP_TOL = dict(atol=5e-5, rtol=5e-4)
CAP = 24
# decode configs of the three routes (a repetition penalty on each)
ROUTES = {"greedy": dict(repeat_penalty=0.8),
          "beam": dict(use_beam=True, beam_size=3, top_k=3, repeat_penalty=0.8,
                       penalty_range=4),
          "batch": dict(repeat_penalty=0.8)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    jc, tc = jk.KaniConfig(**LM), tk.KaniConfig(**LM)
    jcc, tcc = jnc.NanoCodecConfig(**CODEC), tnc.NanoCodecConfig(**CODEC)
    # jitted inits: a few seconds where the op-by-op ones take ~15 s
    jp = jax.jit(lambda key: jk.init_params(jc, key))(jax.random.key(0))
    jcp = jax.jit(lambda key: jnc.init_params(jcc, key))(jax.random.key(1))
    jcp["post_conv"]["w"] = jcp["post_conv"]["w"] * 4000.0
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    tcp = params_from_jax(jax.tree.map(np.asarray, jcp), "cpu", torch.float32)
    return dict(jc=jc, tc=tc, jcc=jcc, tcc=tcc, jp=jp, jcp=jcp, tp=tp, tcp=tcp)


def _port(models, stop: int = -1, cap: int = CAP, **decode) -> KaniPipeline:
    return KaniPipeline(models["tp"], tk.KaniConfig(**{**LM, "stop_token": stop}),
                        models["tcp"], models["tcc"],
                        KaniDecodeConfig(max_new_tokens=cap, **decode), audio_tokens_start=0)


def _jax(models, stop: int = -1, cap: int = CAP, **decode) -> JaxPipeline:
    return JaxPipeline(models["jp"], jk.KaniConfig(**{**LM, "stop_token": stop}),
                       models["jcp"], models["jcc"],
                       JaxDecodeConfig(max_new_tokens=cap, fused_decode=False, **decode),
                       audio_tokens_start=0)


def _same_audio(wt, wj):
    assert wt.dtype == np.int16 and wt.shape == wj.shape and len(wj)
    assert np.abs(wt.astype(np.int32) - wj.astype(np.int32)).max() <= 2


# ---------------------------------------------------------------- the step

@pytest.mark.parametrize("fused", [False, "step"])
def test_kani_step_at_a_device_position_matches_jax(models, fused):
    """kani_step with kv.length a device int32 (and a bound below the cache
    length) against tts_tpu's kani_step at host positions 3, 4 and 5 after
    a 3-token prefill; the plain route reads the bound's rows under a mask,
    "step" is kernel 12's device-form twin."""
    jc, tc, jp, tp = models["jc"], models["tc"], models["jp"], models["tp"]
    step = jax.jit(jk.kani_step, static_argnums=(3,))
    ids = IDS[:, :3]
    lj, state = step(jp, jk.embed_tokens(jp, jnp.asarray(ids)),
                     jk.init_state(jc, 1, jnp.float32), jc)
    ts = tk.init_state(tc, 1, torch.float32)
    lt, ts = tk.kani_step(tp, tk.embed_tokens(tp, _t(ids)), ts, tc)
    pos = torch.tensor(3, dtype=torch.int32)
    ts = tk.KaniState(KVCache(ts.kv.k, ts.kv.v, pos, bound=40), ts.conv)
    for _ in range(3):
        tok = jnp.argmax(lj, -1).astype(jnp.int32)
        lj, state = step(jp, jk.embed_tokens(jp, tok[:, None]), state, jc)
        lt, _ = tk.kani_step(tp, tk.embed_tokens(tp, _t(_np(tok))[:, None]), ts, tc,
                             fused=fused)
        np.testing.assert_allclose(lt.numpy(), _np(lj), **STEP_TOL)
        pos.add_(1)
    assert int(pos) == int(state.kv.length) == 6
    np.testing.assert_allclose(ts.kv.k[:, :, :, :6].numpy(), _np(state.kv.k)[:, :, :, :6],
                               **STEP_TOL)
    np.testing.assert_allclose(ts.conv.numpy(), _np(state.conv), **STEP_TOL)


@pytest.mark.parametrize("num", [3, 9, 10, 11, 17, 24])
def test_repetition_penalty_at_a_device_count_matches_jax(num):
    """The device form (num a 0-dim tensor: the window gathered at
    num - range + arange(range), applied under torch.where) bitwise
    tts_tpu's and the host form's, below, at and above the range."""
    from tts_tpu.decoding.sampling import apply_repetition_penalty as jpen
    from tts_tpu_torch.decoding.sampling import apply_repetition_penalty

    rng = np.random.default_rng(36)
    logits = rng.standard_normal((2, 40)).astype(np.float32)
    save = rng.integers(0, 40, size=(2, 24)).astype(np.int32)
    save[0, 8:12] = 5
    ref = _np(jpen(jnp.asarray(logits), jnp.asarray(save), jnp.int32(num), 0.8, 10))
    dev = apply_repetition_penalty(_t(logits), _t(save), torch.tensor(num, dtype=torch.int32),
                                   0.8, 10)
    host = apply_repetition_penalty(_t(logits), _t(save), num, 0.8, 10)
    np.testing.assert_array_equal(dev.numpy(), ref)
    np.testing.assert_array_equal(host.numpy(), ref)


# ---------------------------------------------------------------- the programs

def _unstopped(pipe: KaniPipeline, route: str) -> np.ndarray:
    """The route's kept token rows of an unstopped request."""
    if route == "batch":
        pipe.synthesize_ids_batch(PROMPTS)
        return pipe._batch_fns[("batch", len(PROMPTS), 16)].save.numpy()
    pipe.synthesize_ids(IDS)
    return pipe._decode_cache[16].save[:1].numpy()


def _stop_inside_a_replay(models, route: str) -> int:
    """A stop token that ends the route's decode inside a replay: its count
    is not a multiple of STEPS, the replay's later steps are frozen."""
    rows = _unstopped(_port(models, **ROUTES[route]), route)
    for i in range(STEPS + 2, CAP - 2):
        tok = int(rows[0, i])
        if tok in rows[0, :i] or i % STEPS == 0:
            continue
        if route != "beam":
            return tok
        # beam 0's token at a step may differ from the kept path's: take
        # the candidate whose stopped count lands inside a replay
        pipe = _port(models, tok, **ROUTES[route])
        n = pipe.synthesize_ids(IDS)[1]["tokens"]
        if n % STEPS and STEPS < n < CAP:
            return tok
    raise AssertionError("no token stops the decode inside a replay")


@pytest.mark.parametrize("route", ["greedy", "beam", "batch"])
def test_programs_stop_inside_a_replay_as_tts_tpu(models, route):
    """Each route through its programs with a stop token that comes inside
    a replay of STEPS steps: the count (each row's, in a batch) is tts_tpu's
    exact while-loop stop, the kept tokens the unstopped run's prefix, the
    audio within 2 LSB; the steps after the stop in that replay change
    nothing."""
    stop = _stop_inside_a_replay(models, route)
    tpipe, jpipe = _port(models, stop, **ROUTES[route]), _jax(models, stop, **ROUTES[route])
    free = _unstopped(_port(models, **ROUTES[route]), route)
    if route == "batch":
        wt, st = tpipe.synthesize_ids_batch(PROMPTS)
        wj, sj = jpipe.synthesize_ids_batch(PROMPTS)
        dec = tpipe._batch_fns[("batch", len(PROMPTS), 16)]
        done = dec._counts().numpy()
        assert st["tokens"] == sj["tokens"] == int(done.sum())
        assert done[0] % STEPS and done[0] < CAP
        for b, (a, j) in enumerate(zip(wt, wj)):
            assert (dec.save[b, :done[b]].numpy() == free[b, :done[b]]).all()
            if done[b] > 6:
                _same_audio(a, j)
            else:
                assert len(a) == len(j) == 0
        return
    wt, st = tpipe.synthesize_ids(IDS)
    wj, sj = jpipe.synthesize_ids(IDS)
    n = st["tokens"]
    assert n == sj["tokens"] and n % STEPS and STEPS < n < CAP
    dec = tpipe._decode_cache[16]
    assert int(dec.num) == n + 1 and bool(dec.fin) and bool(dec.stop)
    if route == "greedy":
        assert (dec.save[0, :n].numpy() == free[0, :n]).all()
    _same_audio(wt, wj)


def test_program_keys_match_tts_tpu(models, monkeypatch):
    """After the same requests (two token caps, the first repeated, batches
    of 2 and 3) the port's `_decode_cache` and `_batch_fns` hold tts_tpu's
    keys; a `_Decode` holds a prefill program a prompt bucket (one here:
    max_seq_len 64 caps the bucket at 32). tts_tpu's program builders are
    stubbed: the keys are set before a program runs."""
    ccfg = models["tcc"]

    def stub(self, *shape):
        fbuf = shape[-1]
        rows = shape[0] if len(shape) == 3 else 1
        return lambda *a: (np.zeros((rows, fbuf * ccfg.total_upsample), np.int16),
                           np.full((rows,), 2, np.int32) if rows > 1 else np.int32(2))

    monkeypatch.setattr(JaxPipeline, "_build_decode", stub)
    monkeypatch.setattr(JaxPipeline, "_build_decode_batch", stub)
    # a stop token two steps in keeps the port's requests short
    stop = int(_unstopped(_port(models, **ROUTES["greedy"]), "greedy")[0, 2])
    tpipe, jpipe = _port(models, stop, cap=80), _jax(models, stop, cap=80)
    for ids, cap in ((IDS, CAP), (IDS, 70), (PROMPTS[1], CAP)):
        jpipe.synthesize_ids(ids, max_new_tokens=cap)
        tpipe.synthesize_ids(ids, max_new_tokens=cap)
    for prompts in (PROMPTS[:2], PROMPTS):
        jpipe.synthesize_ids_batch(prompts, max_new_tokens=CAP)
        tpipe.synthesize_ids_batch(prompts, max_new_tokens=CAP)
    assert sorted(tpipe._decode_cache) == sorted(jpipe._decode_cache) == [16, 20]
    assert sorted(tpipe._batch_fns) == sorted(jpipe._batch_fns)
    assert sorted(tpipe._decode_cache[16]._prefill) == [32]


def test_a_step_past_the_cache_raises(models):
    """A request whose decode reaches a position the cache has no row for
    raises, as the host-driven loop raised at that step (its update_layer);
    the programs freeze it there. One that stops before does not."""
    lm = tk.KaniConfig(**{**LM, "max_seq_len": 24})
    tp = {**models["tp"], "rope_cos": models["tp"]["rope_cos"][:24],
          "rope_sin": models["tp"]["rope_sin"][:24]}
    pipe = KaniPipeline(tp, lm, models["tcp"], models["tcc"],
                        KaniDecodeConfig(max_new_tokens=CAP), audio_tokens_start=0)
    with pytest.raises(ValueError, match="cache of 24 rows"):
        pipe.synthesize_ids(IDS)
    dec = pipe._decode_cache[16]
    # the 20th step found row 24 past the cache: frozen there (pos = prompt + num - 1)
    assert bool(dec.over) and int(dec.pos) == 24 and int(dec.num) == 24 - IDS.shape[1] + 1
    stop = int(dec.save[0, 3])
    pipe = KaniPipeline(tp, tk.KaniConfig(**{**LM, "max_seq_len": 24, "stop_token": stop}),
                        models["tcp"], models["tcc"], KaniDecodeConfig(max_new_tokens=CAP),
                        audio_tokens_start=0)
    assert pipe.synthesize_ids(IDS)[1]["tokens"] <= 3


def test_warm_up_leaves_a_programs_state(monkeypatch):
    """A stateful program's warm-up runs its body on the state and puts the
    state back: the first call advances it once, as every later call."""

    class Graph:
        def __init__(self, device, pool):
            self.fn = None

        def warm_up(self, fn):
            fn()

        def capture(self, fn):
            self.fn = fn
            return ()

        def replay(self):
            self.fn()

    monkeypatch.setattr(program, "_Graph", Graph)
    count = torch.zeros((), dtype=torch.int32)

    def body():
        count.add_(1)
        return ()

    prog = program.Program(body, [], "cpu", program.GraphPool(), state=(count,))
    prog._replay([])
    assert int(count) == 1
    prog._replay([])
    assert int(count) == 2


def test_device_step_plan_mirrors_the_kernel():
    """csrc/decode_step.cu's plan_slice is step_plan; step_bound is the
    most CTAs and rows step_plan gives up to top, and its C entry refuses
    what does not cover top; the wrapper refuses a device pos without a top
    inside the cache."""
    from pathlib import Path

    from tts_tpu_torch.ops.decode_step import (_CTA_ROWS, fused_qkv_attn, step_bound,
                                               step_plan)

    src = " ".join((Path(rk.__file__).parents[1] / "csrc" / "decode_step.cu").read_text()
                   .split())
    for part in ("constexpr int CR = HD == 64 ? 64 : 128;",
                 "const int c = min(ST_MAX_CTAS, (pos + CR - 1) / CR); rows = (pos + c - 1) "
                 "/ c; ctas = (pos + rows - 1) / rows;",
                 "if (pos < 0 || pos > a.top) __trap();",
                 "if (ctas > nct || rows > a.stride) __trap();",
                 "rows < 0 || (long long)ctas * rows < top)"):
        assert part in src, part
    assert _CTA_ROWS == {64: 64, 128: 128}
    for hd in (64, 128):
        for top in (0, 1, 63, 64, 65, 129, 513, 1023, 2047):
            ctas, rows = step_bound(top, hd)
            plans = [step_plan(p, hd) for p in range(top + 1)]
            assert ctas == max(c for c, _ in plans) and rows == max(r for _, r in plans)
            assert ctas * rows >= top
    x = torch.zeros(1, 128)
    kc = torch.zeros(1, 1, 8, 16, 64)
    with pytest.raises(ValueError, match="top"):
        fused_qkv_attn(x, torch.zeros(128, 32 * 64), None, None, kc, kc, 0,
                       torch.tensor(3, dtype=torch.int32), heads=16, kv_heads=8, head_dim=64)
    with pytest.raises(TypeError, match="int32"):
        fused_qkv_attn(x, torch.zeros(128, 32 * 64), None, None, kc, kc, 0,
                       torch.tensor(3), heads=16, kv_heads=8, head_dim=64, top=15)


def test_device_twin_matches_the_host_twin():
    """Kernel 12's twin at a device pos (every cache row, those >= pos
    masked) against the host form at the same pos, pos 0 included."""
    from tts_tpu_torch.ops.decode_step import fused_qkv_attn_plain

    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 128, generator=g)
    w = torch.randn(128, 32 * 64, generator=g) * 0.05
    kc, vc = torch.randn(2, 1, 8, 32, 64, generator=g), torch.randn(2, 1, 8, 32, 64, generator=g)
    kw = dict(heads=16, kv_heads=8, head_dim=64)
    for pos in (0, 1, 17, 31):
        host = fused_qkv_attn_plain(x, w, None, None, kc, vc, 1, pos, **kw)
        dev = fused_qkv_attn_plain(x, w, None, None, kc, vc, 1,
                                   torch.tensor(pos, dtype=torch.int32), top=31, **kw)
        for a, b in zip(dev, host):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------- the weights

def test_kani_weights_drop_the_programs(models):
    """Setting params or codec_params, or replacing a tensor of them in
    place, drops the decode programs; the next request builds them on the
    new weights and equals a fresh pipeline's."""
    pipe = _port(models)
    pipe.synthesize_ids(IDS)
    pipe.synthesize_ids_batch(PROMPTS[:2])
    assert pipe._decode_cache and pipe._batch_fns
    old = pipe._decode_cache[16]
    pipe.codec_params = {**models["tcp"]}
    assert not pipe._decode_cache and not pipe._batch_fns
    pipe.synthesize_ids(IDS)
    assert pipe._decode_cache[16] is not old
    other = tk.init_params(models["tc"], torch.Generator().manual_seed(9))
    pipe.params = other
    assert not pipe._decode_cache
    got, _ = pipe.synthesize_ids(IDS)
    fresh = KaniPipeline(other, models["tc"], models["tcp"], models["tcc"],
                         KaniDecodeConfig(max_new_tokens=CAP), audio_tokens_start=0)
    np.testing.assert_array_equal(got, fresh.synthesize_ids(IDS)[0])
    kept = pipe._decode_cache[16]
    pipe.params["lm_head"] = pipe.params["lm_head"].clone()
    pipe.synthesize_ids(IDS)
    assert pipe._decode_cache[16] is not kept


def test_f5_and_bigvgan_weights_drop_the_programs():
    """F5Pipeline: setting f5 or vocos, or casting the model in place,
    drops the programs (and remakes the quantized weights); BigVGANVocoder:
    setting params, or replacing a tensor of them, drops its programs."""
    from tts_tpu_torch.models import bigvgan as tbv
    from tts_tpu_torch.models import f5 as tf5
    from tts_tpu_torch.models import vocos as tvo
    from tts_tpu_torch.runtime.f5 import F5Pipeline
    from tts_tpu_torch.runtime.vocoder import BigVGANVocoder

    cfg = tf5.F5Config(dim=64, depth=1, heads=2, head_dim=32, text_dim=32, conv_layers=1,
                       nfe_steps=2, max_signal_len=256, vocab_size=40)
    vcfg = tvo.VocosConfig(dim=16, intermediate_dim=32, num_layers=1)

    def f5(seed):
        return tf5.F5Model(cfg, tf5.init_params(cfg, torch.Generator().manual_seed(seed)))

    def vocos(seed):
        return tvo.VocosModel(vcfg, tvo.init_params(vcfg, torch.Generator().manual_seed(seed)))

    vocab = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz,.")}
    for quantize in (None, 8):
        pipe = F5Pipeline(f5(0), vocab, vocos(1), quantize=quantize)
        key = (1024, 16, 64, 32)
        prog = pipe._get_fn(*key)
        assert pipe._get_fn(*key) is prog and len(pipe._fn_cache) == 1
        q0 = pipe._qparams
        pipe.f5 = f5(2)
        assert not pipe._fn_cache and (quantize is None or pipe._qparams is not q0)
        prog = pipe._get_fn(*key)
        pipe.vocos = vocos(3)
        assert not pipe._fn_cache
        prog = pipe._get_fn(*key)
        pipe.vocos.to(torch.float64)
        assert pipe._get_fn(*key) is not prog

    bcfg = tbv.BigVGANConfig(num_mels=8, upsample_initial_channel=16, upsample_rates=(2,),
                             upsample_kernel_sizes=(4,), resblock_kernel_sizes=(3,),
                             resblock_dilation_sizes=((1,),))
    params = tbv.init_params(bcfg, torch.Generator().manual_seed(4))
    voc = BigVGANVocoder(params, bcfg, dtype=torch.float32)
    mel = torch.randn(1, 12, 8, generator=torch.Generator().manual_seed(5))
    out = voc.forward(mel)
    prog = voc._get_fn(1, 12)
    voc.params = tbv.init_params(bcfg, torch.Generator().manual_seed(6))
    assert not voc._fn_cache
    assert not torch.equal(voc.forward(mel), out)
    prog = voc._get_fn(1, 12)
    voc.params["conv_pre"]["w"] = voc.params["conv_pre"]["w"] * 2
    assert voc._get_fn(1, 12) is not prog
    voc.params = params
    torch.testing.assert_close(voc.forward(mel), out, rtol=0, atol=0)
