"""The port's IndexTTS slice against tts_tpu on the CPU, fp32 on both sides:
tts_tpu's init functions -> params_from_jax, then the modules (rel_shift,
the conformer, the perceiver, ECAPA in both variants), gpt_step's prefill
and decode steps through each route (tts_tpu's Pallas kernels in interpret
mode, the port's twins), the route gates with the port's batch-1 cache
guard, and IndexTTSPipeline (encode_reference, synthesize_ids, the batch,
int8 and int4) against tts_tpu's.

Tolerances: the encoders to 1e-4 relative L2 (fp32 sums in another order
through six blocks); a GPT step's logits to atol 5e-5 rtol 5e-4 (the
port's Kani bound for a fused step); the pipelines give the same tokens
and token ids and int16 audio within 4 LSB (float waveforms that agree
to ~1e-5 truncate to neighbouring integers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.kv.cache import KVCache as JKV
from tts_tpu.models import bigvgan as jbv
from tts_tpu.models import indextts as ji
from tts_tpu.runtime.indextts import IndexTTSPipeline as JaxPipeline
from tts_tpu_torch.kv.cache import KVCache
from tts_tpu_torch.models import bigvgan as tbv
from tts_tpu_torch.models import indextts as ti
from tts_tpu_torch.quant.weight_only import QTensor, QTensor4
from tts_tpu_torch.runtime.indextts import IndexTTSPipeline, IndexTTSStats
from tts_tpu_torch.weights.convert import params_from_jax

# tts_tpu's TINY config (tests/test_indextts.py)
TINY = dict(enc_dim=32, enc_heads=2, enc_ff_dim=64, enc_layers=2, enc_conv_kernel=7,
            num_latents=4, perceiver_heads=2, perceiver_dim_head=8, n_mels=24,
            ecapa_channels=16, ecapa_attn_channels=8, res2net_scale=4, se_channels=8,
            speaker_embed_dim=12, gpt_dim=32, gpt_heads=2, gpt_layers=2, num_mel_codes=64,
            num_text_tokens=50, max_text_tokens=32, max_mel_tokens=32, max_seq_len=128,
            stop_token=63, start_mel_token=62)
# head_dim 64, which packs for the fused routes (kernels 11 and 12)
GPT64 = dict(TINY, gpt_dim=128, gpt_heads=2, max_mel_tokens=64, max_seq_len=256)
VOC = dict(upsample_initial_channel=16, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
           use_tanh_at_final=True, use_bias_at_final=True)
STEP_TOL = dict(atol=5e-5, rtol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _conv(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu", torch.float32)


def _jax_params(cfg: ji.IndexTTSConfig, vcfg: jbv.BigVGANConfig, seed: int = 0) -> dict:
    """tts_tpu's pipeline params (tests/test_indextts.py), with a BigVGAN
    loud enough that int16 sees the waveform."""
    ks = jax.random.split(jax.random.key(seed), 8)
    c0 = vcfg.upsample_initial_channel
    bv = jbv.init_params(vcfg, ks[4])
    bv["conv_post"]["w"] = bv["conv_post"]["w"] * 300.0
    return {
        "conformer": ji.init_conformer_params(cfg, ks[0]),
        "perceiver": ji.init_perceiver_params(cfg, ks[1]),
        "ecapa": ji.init_ecapa_params(cfg, ks[2]),
        "gpt": ji.init_gpt_params(cfg, ks[3]),
        "bigvgan": bv,
        "cond_layer": {"w": jax.random.normal(ks[5], (cfg.speaker_embed_dim, c0)) * 0.5,
                       "b": jnp.zeros((c0,))},
        "conds": [{"w": jax.random.normal(ks[6], (cfg.speaker_embed_dim, c)) * 0.5,
                   "b": jnp.zeros((c,))} for c in vcfg.stage_channels],
    }


@pytest.fixture(scope="module")
def tiny():
    jc, tc = ji.IndexTTSConfig(**TINY), ti.IndexTTSConfig(**TINY)
    voc = dict(VOC, num_mels=jc.gpt_dim)
    jv, tv = jbv.BigVGANConfig(**voc), tbv.BigVGANConfig(**voc)
    jp = _jax_params(jc, jv)
    return dict(jc=jc, tc=tc, jv=jv, tv=tv, jp=jp, tp=_conv(jp))


# ---------------------------------------------------------------- modules

def test_rel_shift_exact():
    x = np.random.default_rng(0).standard_normal((3, 7, 7)).astype(np.float32)
    np.testing.assert_array_equal(ti._rel_shift(_t(x)).numpy(),
                                  np.asarray(ji._rel_shift(jnp.asarray(x))))


def test_conformer_and_perceiver_match_jax(tiny):
    jc, tc, jp, tp = tiny["jc"], tiny["tc"], tiny["jp"], tiny["tp"]
    mel = np.random.default_rng(1).standard_normal((1, 41, jc.n_mels)).astype(np.float32)
    ref = ji.conformer_encoder(jp["conformer"], jnp.asarray(mel), jc)
    got = ti.conformer_encoder(tp["conformer"], _t(mel), tc)
    assert got.shape == ref.shape == (1, 9, jc.enc_dim)
    assert _rel(got.numpy(), ref) < 1e-4
    ref_p = ji.perceiver_resample(jp["perceiver"], ref, jc)
    got_p = ti.perceiver_resample(tp["perceiver"], _t(np.asarray(ref)), tc)
    assert got_p.shape == ref_p.shape == (1, jc.num_latents, jc.gpt_dim)
    assert _rel(got_p.numpy(), ref_p) < 1e-4


@pytest.mark.parametrize("variant", ["indextts", "qwen"])
def test_ecapa_matches_jax(tiny, variant):
    """The speechbrain layout (zero padding, BatchNorm, clipped std) and the
    Qwen3-TTS one (reflect padding, no BatchNorm, unclipped std)."""
    jc, tc = tiny["jc"], tiny["tc"]
    rng = np.random.default_rng(2)
    jp = ji.init_ecapa_params(jc, jax.random.key(4))
    kw = {}
    if variant == "qwen":
        def strip(node):
            if isinstance(node, dict):
                return {k: strip(v) for k, v in node.items() if k not in ("bn", "asp_bn")}
            if isinstance(node, list):
                return [strip(v) for v in node]
            return node
        jp = strip(jp)
        kw = dict(reflect_pad=True, std_clip=None)
    else:
        # BatchNorm folds that are not the identity
        jp["block0"]["bn"]["scale"] = jnp.asarray(rng.uniform(0.5, 1.5, 16), jnp.float32)
        jp["asp_bn"]["shift"] = jnp.asarray(rng.standard_normal(96) * 0.1, jnp.float32)
    mel = rng.standard_normal((1, 50, jc.n_mels)).astype(np.float32)
    ref = ji.ecapa_speaker_encoder(jp, jnp.asarray(mel), jc, **kw)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    got = ti.ecapa_speaker_encoder(tp, _t(mel), tc, **kw)
    assert got.shape == ref.shape == (1, 1, jc.speaker_embed_dim)
    assert _rel(got.numpy(), ref) < 1e-4


def test_gpt_embeds_match_jax(tiny):
    jp, tp = tiny["jp"]["gpt"], tiny["tp"]["gpt"]
    ids = np.array([[0, 5, 9, 13, 1], [0, 2, 3, 4, 1]], np.int32)
    np.testing.assert_array_equal(ti.gpt_embed_text(tp, _t(ids).long()).numpy(),
                                  np.asarray(ji.gpt_embed_text(jp, jnp.asarray(ids))))
    mel = np.array([[62, 7, 9]], np.int32)
    np.testing.assert_array_equal(ti.gpt_embed_mel(tp, _t(mel).long(), 4).numpy(),
                                  np.asarray(ji.gpt_embed_mel(jp, jnp.asarray(mel), 4)))


# ---------------------------------------------------------------- gpt_step

@pytest.fixture(scope="module")
def gpt64():
    jc, tc = ji.IndexTTSConfig(**GPT64), ti.IndexTTSConfig(**GPT64)
    jp = ji.init_gpt_params(jc, jax.random.key(5))
    # LN affine and biases that are not the identity, so the fused heads see them
    rng = np.random.default_rng(5)
    for lyr in jp["layers"]:
        lyr["ln1"]["w"] = jnp.asarray(1 + rng.standard_normal(128) * 0.1, jnp.float32)
        lyr["ln1"]["b"] = jnp.asarray(rng.standard_normal(128) * 0.1, jnp.float32)
        lyr["bqkv"] = jnp.asarray(rng.standard_normal(384) * 0.1, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp)


@pytest.mark.parametrize("route,hole", [(False, True), (True, True), ("step", False),
                                        ("step", True)])
def test_gpt_step_routes_match_jax(gpt64, route, hole):
    """A prefill (with a kv hole when `hole`) and 4 decode steps through
    `route`, fed each side's own greedy token: tts_tpu's gpt_step with the
    same route (its kernels in interpret mode) against the port's (its
    kernels' twins). With the hole every decode step passes kv_valid, which
    degrades "step" to the qkv head (kernel 11) on both sides."""
    from jax.experimental.pallas import tpu as pltpu

    jc, tc, jp, tp = gpt64["jc"], gpt64["tc"], gpt64["jp"], gpt64["tp"]
    rng = np.random.default_rng(6)
    hidden = rng.standard_normal((1, 9, jc.gpt_dim)).astype(np.float32)
    t_max = 64
    valid = np.ones(t_max, bool)
    if hole:
        valid[4:6] = False
    jvalid = jnp.asarray(valid) if hole else None
    tvalid = _t(valid) if hole else None
    vec = np.ones((1, jc.num_mel_codes), np.float32)
    vec[0, 3] = 0.9
    jkv = JKV.create(jc.gpt_layers, 1, jc.gpt_heads, t_max, jc.gpt_head_dim, jnp.float32)
    tkv = KVCache.create(tc.gpt_layers, 1, tc.gpt_heads, t_max, tc.gpt_head_dim,
                         torch.float32)
    lj, hj, jkv = ji.gpt_step(jp, jnp.asarray(hidden), jkv, jnp.asarray(vec), jc, jvalid)
    lt, ht, tkv = ti.gpt_step(tp, _t(hidden), tkv, _t(vec), tc, tvalid)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **STEP_TOL)
    for i in range(4):
        tok = int(np.argmax(np.asarray(lj)[0]))
        assert int(torch.argmax(lt[0])) == tok
        jh = ji.gpt_embed_mel(jp, jnp.asarray([[tok]]), i + 1)
        th = ti.gpt_embed_mel(tp, torch.tensor([[tok]]), i + 1)
        with pltpu.force_tpu_interpret_mode():
            lj, hj, jkv = ji.gpt_step(jp, jh, jkv, jnp.asarray(vec), jc, jvalid, fused=route)
        lt, ht, tkv = ti.gpt_step(tp, th, tkv, _t(vec), tc, tvalid, fused=route)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **STEP_TOL)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **STEP_TOL)
    assert tkv.length == int(jkv.length) == 13
    np.testing.assert_allclose(tkv.k.numpy()[:, :, :, :13],
                               np.asarray(jkv.k)[:, :, :, :13], **STEP_TOL)


@pytest.mark.parametrize("case,want", [
    ("b1", "step"), ("kv_valid", True), ("b2", True), ("cache_b2", True),
    ("prefill", False), ("int4", False), ("no_layout", False), ("true", True),
    ("off", False)])
def test_gpt_route_gates(gpt64, case, want):
    """tts_tpu's gates plus the kernels' limits. "cache_b2" is the port's
    repair: a batch-1 step over a cache of 2 rows takes kernel 11, not
    kernel 12 (tts_tpu's IndexTTS check, models/indextts.py:341-344, lacks
    this guard; Qwen's has it)."""
    from tts_tpu_torch.quant.weight_only import quantize_int4

    tc, tp = gpt64["tc"], gpt64["tp"]
    batch = 2 if case == "b2" else 1
    kv = KVCache.create(tc.gpt_layers, 2 if case in ("b2", "cache_b2") else 1,
                        tc.gpt_heads, 64, tc.gpt_head_dim, torch.float32).advance(5)
    cfg, params = tc, tp
    if case == "no_layout":
        cfg = ti.IndexTTSConfig(**dict(GPT64, gpt_heads=4))           # head_dim 32
    if case == "int4":
        params = {**tp, "layers": [{**lyr, "wqkv": quantize_int4(lyr["wqkv"])}
                                   for lyr in tp["layers"]]}
    route = {"true": True, "off": False}.get(case, "step")
    got = ti.gpt_route(params, cfg, batch, 3 if case == "prefill" else 1, kv,
                       torch.ones(64, dtype=torch.bool) if case == "kv_valid" else None,
                       route)
    assert got == want


def test_gpt_step_calls_kernel_wrappers(gpt64, monkeypatch):
    """The "step" route launches kernel 12's wrapper once a layer, the kv
    mask degrades it to kernel 11's, and the repaired cache guard too."""
    calls = []
    for name in ("fused_qkv_attn", "fused_qkv_rope"):
        real = getattr(ti, name)
        monkeypatch.setattr(ti, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    tc, tp = gpt64["tc"], gpt64["tp"]
    vec = torch.ones((1, tc.num_mel_codes))
    x = torch.randn((1, 1, tc.gpt_dim), generator=torch.Generator().manual_seed(0))
    for cache_rows, kv_valid, want in ((1, None, "fused_qkv_attn"),
                                       (1, torch.ones(64, dtype=torch.bool), "fused_qkv_rope"),
                                       (2, None, "fused_qkv_rope")):
        calls.clear()
        kv = KVCache.create(tc.gpt_layers, cache_rows, tc.gpt_heads, 64, tc.gpt_head_dim,
                            torch.float32).advance(3)
        if cache_rows == 1:
            ti.gpt_step(tp, x, kv, vec, tc, kv_valid, fused="step")
        else:
            assert ti.gpt_route(tp, tc, 1, 1, kv, None, "step") is True
            ti.gpt_step(tp, x.expand(2, 1, -1).contiguous(), kv, vec.expand(2, -1), tc,
                        fused="step")
        assert calls == [want] * tc.gpt_layers


# ---------------------------------------------------------------- the slice

def _pipes(m, **kw):
    jpipe = JaxPipeline(m["jp"], m["jc"], m["jv"], sample_rate=8000, n_fft=256, hop=64, **kw)
    tpipe = IndexTTSPipeline(m["tp"], m["tc"], m["tv"], sample_rate=8000, n_fft=256, hop=64,
                             **kw)
    return jpipe, tpipe


def _same_audio(got, ref):
    assert got.dtype == np.int16 and got.shape == ref.shape
    if ref.size:
        assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 4


def test_encode_reference_matches_jax(tiny):
    jpipe, tpipe = _pipes(tiny)
    audio = (np.random.default_rng(0).standard_normal(4000) * 3000).astype(np.int16)
    (jl, je, jc), (tl, te, tcd) = jpipe.encode_reference(audio), tpipe.encode_reference(audio)
    for got, ref in [(tl, jl), (te, je)] + list(zip(tcd, jc)):
        assert got.shape == ref.shape
        assert _rel(got.numpy(), ref) < 1e-4


@pytest.mark.parametrize("quantize", [None, 8, 4])
def test_synthesize_ids_matches_jax(tiny, quantize):
    jpipe, tpipe = _pipes(tiny, quantize=quantize)
    if quantize == 8:
        assert isinstance(tpipe.params["gpt"]["layers"][0]["wqkv"], QTensor)
    if quantize == 4:
        assert isinstance(tpipe.params["gpt"]["layers"][0]["wqkv"], QTensor4)
    audio = (np.random.default_rng(0).standard_normal(4000) * 3000).astype(np.int16)
    jref, tref = jpipe.encode_reference(audio), tpipe.encode_reference(audio)
    for ids in (np.array([[5, 9, 13]], np.int32), np.arange(2, 20, dtype=np.int32)[None]):
        # the decode's token ids, on the 16-id text bucket both pipelines use
        tlen = ids.shape[1]
        tb = max(16, -(-tlen // 16) * 16)
        padded = np.zeros((1, tb), np.int32)
        padded[0, :tlen] = ids[0]
        _, num, jsave = jpipe._decode_fn(tb, 34)(jpipe.params, jref[0], jnp.asarray(padded),
                                                 np.int32(tlen))
        _, done, tsave = tpipe._decode(tref[0], padded, np.array([tlen]), 34)
        assert int(done[0]) == int(num)
        np.testing.assert_array_equal(tsave[0, :int(num)].numpy(), np.asarray(jsave)[:int(num)])
        ref, jst = jpipe.synthesize_ids(ids, jref, max_gen=34)
        got, st = tpipe.synthesize_ids(ids, tref, max_gen=34)
        assert isinstance(st, IndexTTSStats) and st.tokens == jst.tokens
        assert len(ref) == max(jst.tokens - 2, 0) * tiny["jv"].total_upsample
        _same_audio(got, ref)
        assert np.abs(ref).max() > 1000


def test_synthesize_ids_batch_matches_jax(tiny):
    """B = 3 with mixed text lengths, each with its own reference."""
    jpipe, tpipe = _pipes(tiny)
    rng = np.random.default_rng(3)
    audios = [(rng.standard_normal(n) * 3000).astype(np.int16) for n in (4000, 5000, 3000)]
    ids = [np.array([[5, 9, 13]], np.int32), np.array([[2, 7, 4, 11, 3]], np.int32),
           np.arange(1, 19, dtype=np.int32)[None]]
    jreq = [(i, jpipe.encode_reference(a)) for i, a in zip(ids, audios)]
    treq = [(i, tpipe.encode_reference(a)) for i, a in zip(ids, audios)]
    ref, jst = jpipe.synthesize_ids_batch(jreq, max_gen=34)
    got, st = tpipe.synthesize_ids_batch(treq, max_gen=34)
    assert st["tokens"] == jst["tokens"]
    # the decode's token ids, row by row, on the shared 32-id text bucket
    padded = np.zeros((3, 32), np.int32)
    for b, i in enumerate(ids):
        padded[b, :i.shape[1]] = i[0]
    tlens = np.array([i.shape[1] for i in ids], np.int32)
    jlat = jnp.concatenate([r[0] for _, r in jreq], axis=0)
    _, jdone, jsave = jpipe._decode_batch_fn(3, 32, 34)(jpipe.params, jlat,
                                                        jnp.asarray(padded), jnp.asarray(tlens))
    _, tdone, tsave = tpipe._decode(torch.cat([r[0] for _, r in treq]), padded, tlens, 34)
    np.testing.assert_array_equal(tdone, np.asarray(jdone))
    for b in range(3):
        n = int(tdone[b])
        np.testing.assert_array_equal(tsave[b, :n].numpy(), np.asarray(jsave)[b, :n])
    for g, r in zip(got, ref):
        _same_audio(g, r)


def test_pipeline_fused_route_matches_jax():
    """At head_dim 64 the port's default route takes kernel 11's twin every
    decode step (kernel 12 never: the kv mask degrades it); tts_tpu's plain
    route gives the same tokens and audio."""
    jc, tc = ji.IndexTTSConfig(**GPT64), ti.IndexTTSConfig(**GPT64)
    voc = dict(VOC, num_mels=jc.gpt_dim)
    m = dict(jc=jc, tc=tc, jv=jbv.BigVGANConfig(**voc), tv=tbv.BigVGANConfig(**voc))
    m["jp"] = _jax_params(jc, m["jv"], seed=1)
    m["tp"] = _conv(m["jp"])
    jpipe, tpipe = _pipes(m)
    assert tpipe._fused == "step"
    audio = (np.random.default_rng(4).standard_normal(4000) * 3000).astype(np.int16)
    ids = np.array([[5, 9, 13, 2]], np.int32)
    ref, jst = jpipe.synthesize_ids(ids, jpipe.encode_reference(audio), max_gen=48)
    got, st = tpipe.synthesize_ids(ids, tpipe.encode_reference(audio), max_gen=48)
    assert st.tokens == jst.tokens
    _same_audio(got, ref)


def test_params_from_jax_quantized_gpt(tiny):
    """int8 and int4 GPT leaves carry across; a wrong shape raises."""
    from tts_tpu.quant.weight_only import quantize_int4, quantize_int8

    jp = dict(tiny["jp"])
    gpt = jp["gpt"]
    jp["gpt"] = {**gpt, "lm_head": quantize_int8(gpt["lm_head"]),
                 "layers": [{**lyr, "wqkv": quantize_int4(lyr["wqkv"])}
                            for lyr in gpt["layers"]]}
    tp = _conv(jp)
    assert isinstance(tp["gpt"]["lm_head"], QTensor)
    assert isinstance(tp["gpt"]["layers"][0]["wqkv"], QTensor4)
    bad = dict(tiny["jp"], cond_layer={"w": jnp.zeros((5, 16)), "b": jnp.zeros((16,))})
    with pytest.raises(ValueError, match="cond_layer"):
        _conv(bad)


def test_init_params_shapes_match_jax(tiny):
    jc, tc = tiny["jc"], tiny["tc"]
    gen = torch.Generator().manual_seed(0)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(np.shape(a)), tree)
    for jfn, tfn in ((ji.init_gpt_params, ti.init_gpt_params),
                     (ji.init_conformer_params, ti.init_conformer_params),
                     (ji.init_perceiver_params, ti.init_perceiver_params),
                     (ji.init_ecapa_params, ti.init_ecapa_params)):
        ours = jax.tree.map(lambda t: t.numpy(), tfn(tc, gen))
        assert shapes(ours) == shapes(jfn(jc, jax.random.key(0)))
