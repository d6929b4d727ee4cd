"""The port's Qwen3-TTS slice against tts_tpu on the CPU, fp32 on both
sides, at small configs with head_dim 128 (so the "step" route holds):
tts_tpu's init functions -> params_from_jax, then qwen3_stack_step through
every decode route (tts_tpu's Pallas kernels in interpret mode, the port's
twins), the prefill, the route gates, the predictor (greedy with the
in-frame penalty, beam, beam batch), the next talker input, the codec, and
the whole QwenTTSPipeline (float, int8, beam, a batch, an EOS stop) against
tts_tpu's (fused_decode=False).

Tolerances: a stack step agrees to rounding noise, atol 5e-6 rtol 2e-5
(tts_tpu's own bound for its fused routes against the plain one: the same
fp32 math, sums in another order); the W8A8 route ("mlp_q8") to atol 3e-5
rtol 1e-4, the bound of the W8A8 kernel tests. The pipelines give the same
frames, token for token, and int16 audio within 2 LSB: float waveforms that
agree to ~1e-6 can truncate to neighbouring integers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.kv.cache import KVCache as JKV
from tts_tpu.models import qwen_codec as jcm
from tts_tpu.models import qwen_tts as jq
from tts_tpu.runtime.qwen import QwenDecodeConfig as JaxDecodeConfig
from tts_tpu.runtime.qwen import QwenTTSPipeline as JaxPipeline
from tts_tpu_torch.kv.cache import KVCache
from tts_tpu_torch.models import qwen_codec as tcm
from tts_tpu_torch.models import qwen_tts as tq
from tts_tpu_torch.runtime.qwen import QwenDecodeConfig, QwenTTSPipeline
from tts_tpu_torch.weights.convert import params_from_jax

STACK = dict(hidden_size=128, num_heads=2, num_kv_heads=1, head_dim=128, ffn_dim=256,
             num_layers=2)
TTS = dict(codec_vocab=64, group_vocab=32, num_code_groups=6, codec_eos_token_id=62,
           codec_bos_id=61, codec_pad_id=60, codec_think_id=59, codec_think_bos_id=58,
           codec_think_eos_id=57, tts_bos_token_id=97, tts_eos_token_id=98,
           tts_pad_token_id=99, text_vocab=100, text_hidden=16)
CODEC = dict(num_quantizers=6, codebook_size=32, codebook_dim=16, rvq_dim=8,
             latent_dim=24, decoder_dim=32, upsampling_ratios=(2,), upsample_rates=(4, 2),
             hidden_size=24, num_heads=2, num_kv_heads=2, head_dim=12, ffn_dim=48,
             num_layers=2, max_seq_len=64)
IDS = np.array([[5, 9, 13, 2]], np.int32)
STEP_TOL = dict(atol=5e-6, rtol=2e-5)
Q8_TOL = dict(atol=3e-5, rtol=1e-4)


def _cfgs(mod, eos: int = 62, talker_len: int = 1024):
    return mod.QwenTTSConfig(
        talker=mod.Qwen3StackConfig(**STACK, max_seq_len=talker_len),
        predictor=mod.Qwen3StackConfig(**STACK, max_seq_len=32),
        **{**TTS, "codec_eos_token_id": eos})


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


def _conv(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu", torch.float32)


@pytest.fixture(scope="module")
def models():
    jc, tc = _cfgs(jq), _cfgs(tq)
    jcc, tcc = jcm.QwenCodecDecoderConfig(**CODEC), tcm.QwenCodecDecoderConfig(**CODEC)
    jp = {**jax.jit(lambda k: jq.init_talker_params(jc, k))(jax.random.key(0)),
          **jax.jit(lambda k: jq.init_predictor_params(jc, k))(jax.random.key(1))}
    jcp = jax.jit(lambda k: jcm.init_decoder_params(jcc, k))(jax.random.key(2))
    # a louder codec (its random output peaks near 3e-5) so the int16
    # comparison sees a good part of the sample range
    jcp["dec_post"]["w"] = jcp["dec_post"]["w"] * 3e4
    return dict(jc=jc, tc=tc, jcc=jcc, tcc=tcc, jp=jp, jcp=jcp, tp=_conv(jp), tcp=_conv(jcp))


# ---------------------------------------------------------------- modules

def test_snake_beta_and_unmasked_attention_match_jax():
    from tts_tpu.audio.snake import snake_beta as jsb
    from tts_tpu.nn.attention import gqa_attention as jga

    from tts_tpu_torch.audio.snake import snake_beta
    from tts_tpu_torch.nn.attention import gqa_attention

    rng = np.random.default_rng(51)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    al, br = (0.5 + rng.random(6)).astype(np.float32), (0.5 + rng.random(6)).astype(np.float32)
    np.testing.assert_allclose(snake_beta(_t(x), _t(al), _t(br)).numpy(),
                               _np(jsb(jnp.asarray(x), jnp.asarray(al), jnp.asarray(br))),
                               atol=1e-6, rtol=1e-6)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 5, 16)).astype(np.float32)
    for scale in (1.0, 0.25):
        ref = jga(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), None, scale=scale)
        out = gqa_attention(_t(q), _t(k), _t(k), None, scale=scale)
        np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5, rtol=1e-5)


def test_params_from_jax_qwen_trees_key_for_key(models):
    from tts_tpu.quant.weight_only import quantize_pytree as jqp

    from tts_tpu_torch.quant.weight_only import QTensor

    def paths(tree, path=()):
        if isinstance(tree, dict):
            return {p for k, v in tree.items() for p in paths(v, path + (k,))}
        if isinstance(tree, list):
            return {p for i, v in enumerate(tree) for p in paths(v, path + (str(i),))}
        return {path}

    def jpaths(tree):
        return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
                for p, _ in jax.tree_util.tree_leaves_with_path(tree)}

    assert paths(models["tp"]) == jpaths(models["jp"])
    assert paths(models["tcp"]) == jpaths(models["jcp"])
    q = _conv(jqp(models["jp"], bits=8, min_size=1))
    wo = q["talker"]["layers"][0]["wo"]
    assert isinstance(wo, QTensor) and wo.q.dtype == torch.int8 and wo.scale.dtype == torch.float32
    assert isinstance(q["lm_heads"], torch.Tensor)            # 3-D stacks stay float
    # the port's init gives tts_tpu's structure
    shapes = lambda tree: jax.tree.map(lambda t: tuple(t.shape), tree)   # noqa: E731
    ours = {**tq.init_talker_params(models["tc"], torch.Generator().manual_seed(0)),
            **tq.init_predictor_params(models["tc"], torch.Generator().manual_seed(1))}
    assert shapes(ours) == shapes(models["tp"])
    np.testing.assert_array_equal(ours["suppress_bias"].numpy(), _np(models["jp"]["suppress_bias"]))
    cours = tcm.init_decoder_params(models["tcc"], torch.Generator().manual_seed(2))
    assert shapes(cours) == shapes(models["tcp"])


@pytest.mark.parametrize("fault", ["missing", "shape", "predictor_width"])
def test_params_from_jax_rejects_bad_qwen_trees(models, fault):
    tree = jax.tree.map(np.asarray, models["jp"])
    if fault == "missing":
        del tree["talker"]["layers"][1]["k_norm"]
    elif fault == "shape":
        tree["talker"]["layers"][1]["q_norm"] = np.zeros(64, np.float32)
    else:                        # small_to_mtp must map the talker into the predictor
        tree["small_to_mtp"] = np.zeros((128, 96), np.float32)
    with pytest.raises((KeyError, ValueError)):
        params_from_jax(tree, "cpu", torch.float32)


def test_suppress_bias_and_talker_logits_match_jax(models):
    np.testing.assert_array_equal(tq.make_suppress_bias(3072, 2150),
                                  jq.make_suppress_bias(3072, 2150))
    np.testing.assert_array_equal(tq.make_suppress_bias(64, 62), jq.make_suppress_bias(64, 62))
    h = np.random.default_rng(52).standard_normal((2, 128)).astype(np.float32)
    np.testing.assert_allclose(
        tq.talker_logits(models["tp"], _t(h), models["tc"]).numpy(),
        _np(jq.talker_logits(models["jp"], jnp.asarray(h), models["jc"])), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- the stack step

ROUTES = [False, True, "step", "attn", "all", "mlp", "mlp_q8"]


def _stack(models, quant: bool):
    """(jax stack params, port stack params, stack config) of the predictor
    stack (T = 32 rows), int8 with min_size=1 so every matrix quantizes."""
    from tts_tpu.quant.weight_only import quantize_pytree as jqp

    jp = jqp(models["jp"], min_size=1) if quant else models["jp"]
    return jp["predictor"], _conv(jp)["predictor"], models["jc"].predictor


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("route", ROUTES, ids=[str(r) for r in ROUTES])
def test_stack_step_routes_match_jax(models, route, quant):
    """A 5-row prefill, then one decode step through `route` on both sides
    (tts_tpu's kernels in interpret mode): the hidden state and the cache."""
    jp, tp, cfg = _stack(models, quant)
    rng = np.random.default_rng(53)
    pre = (rng.standard_normal((1, 5, cfg.hidden_size)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((1, 1, cfg.hidden_size)) * 0.5).astype(np.float32)
    cos, sin = models["jp"]["pred_rope_cos"], models["jp"]["pred_rope_sin"]
    jkv = JKV.create(cfg.num_layers, 1, cfg.num_kv_heads, 32, cfg.head_dim, jnp.float32)
    _, jkv = jq.qwen3_stack_step(jp, jnp.asarray(pre), jkv, cfg, cos[:5], sin[:5])
    hj, jkv = jq.qwen3_stack_step(jp, jnp.asarray(x), jkv, cfg, cos[5:6], sin[5:6],
                                  fused=route, _interpret=True)
    tcos, tsin = models["tp"]["pred_rope_cos"], models["tp"]["pred_rope_sin"]
    tkv = KVCache.create(cfg.num_layers, 1, cfg.num_kv_heads, 32, cfg.head_dim, torch.float32)
    _, tkv = tq.qwen3_stack_step(tp, _t(pre), tkv, cfg, tcos[:5], tsin[:5])
    ht, tkv = tq.qwen3_stack_step(tp, _t(x), tkv, cfg, tcos[5:6], tsin[5:6], fused=route)
    tol = Q8_TOL if (route == "mlp_q8" and quant) else STEP_TOL
    np.testing.assert_allclose(ht.numpy(), _np(hj), **tol)
    assert tkv.length == int(jkv.length) == 6
    np.testing.assert_allclose(tkv.k.numpy(), _np(jkv.k), **STEP_TOL)
    np.testing.assert_allclose(tkv.v.numpy(), _np(jkv.v), **STEP_TOL)


def test_prefill_return_all_and_batch_mask_match_jax(models):
    """The talker prefill over a padded bucket (return_all) with per-row key
    validity (row 1 left-padded by 5)."""
    jp, tp, cfg = models["jp"]["talker"], models["tp"]["talker"], models["jc"].talker
    rng = np.random.default_rng(54)
    pre = (rng.standard_normal((2, 16, cfg.hidden_size)) * 0.5).astype(np.float32)
    cos, sin = models["jp"]["rope_cos"][:16], models["jp"]["rope_sin"][:16]
    pad = np.array([0, 5], np.int32)
    valid = np.arange(128)[None, :] >= pad[:, None]
    jkv = JKV.create(cfg.num_layers, 2, cfg.num_kv_heads, 128, cfg.head_dim, jnp.float32)
    hj, jkv = jq.qwen3_stack_step(jp, jnp.asarray(pre), jkv, cfg, cos, sin,
                                  kv_valid=jnp.asarray(valid), return_all=True)
    tkv = KVCache.create(cfg.num_layers, 2, cfg.num_kv_heads, 128, cfg.head_dim, torch.float32)
    ht, tkv = tq.qwen3_stack_step(tp, _t(pre), tkv, cfg, _t(_np(cos)), _t(_np(sin)),
                                  kv_valid=_t(valid), return_all=True)
    assert ht.shape == (2, 16, cfg.hidden_size)
    # a left-pad query sees no valid key: its softmax is uniform over the
    # keys each side holds (16 here, the 128-row buffer in tts_tpu), garbage
    # that no valid query reads. Compare the valid positions.
    for b in range(2):
        np.testing.assert_allclose(ht[b, pad[b]:].numpy(), _np(hj)[b, pad[b]:], **STEP_TOL)
        np.testing.assert_allclose(tkv.k[:, b, :, pad[b]:16].numpy(),
                                   _np(jkv.k)[:, b, :, pad[b]:16], **STEP_TOL)


@pytest.mark.parametrize("case", ["step_b1", "step_b2", "step_kv_valid", "all_640",
                                  "all_768", "mlp_q8_float", "mlp_q8_int8", "prefill"])
def test_stack_routes_as_tts_tpu(models, case):
    """The gates: "step" holds at B = 1 only (batch rows and per-row key masks
    degrade to kernel 11); kernel 13 needs 256 | T (a 640-row talker bucket
    fails, 768 holds); "mlp_q8" needs int8 weights; fused routes need S = 1."""
    from tts_tpu_torch.quant.weight_only import quantize_pytree

    tp, cfg = models["tp"]["talker"], models["tc"].talker
    b = 2 if case == "step_b2" else 1
    t = {"all_640": 640, "all_768": 768}.get(case, 128)
    kv = KVCache(torch.zeros(2, b, 1, t, 128), torch.zeros(2, b, 1, t, 128), 6)
    kv_valid = torch.ones(b, t, dtype=torch.bool) if case == "step_kv_valid" else None
    fused = {"all_640": "all", "all_768": "all", "mlp_q8_float": "mlp_q8",
             "mlp_q8_int8": "mlp_q8"}.get(case, "step")
    if case == "mlp_q8_int8":
        tp = quantize_pytree(tp, min_size=1)
    if case == "prefill":
        with pytest.raises(ValueError):
            tq.stack_routes(tp, cfg, b, 3, kv, kv_valid, True, fused)
        return
    r = tq.stack_routes(tp, cfg, b, 1, kv, kv_valid, True, fused)
    want = {"step_b1": dict(step=True), "step_b2": dict(qkv=True),
            "step_kv_valid": dict(qkv=True), "all_640": dict(qkv=True, mlp=True),
            "all_768": dict(qkv=True, attn=True, mlp=True), "mlp_q8_float": dict(qkv=True),
            "mlp_q8_int8": dict(qkv=True, mlp_q8=True)}[case]
    fields = ("step", "qkv", "attn", "mlp", "mlp_q8")
    assert {k: getattr(r, k) for k in fields} == {k: want.get(k, False) for k in fields}


# ---------------------------------------------------------------- predictor

@pytest.mark.parametrize("kind", ["greedy", "greedy_b3", "beam", "beam_batch"])
def test_predictor_matches_jax(models, kind):
    """Greedy with the in-frame repetition penalty (penalty_range 2, so it
    applies from group 2), beam 3 / top-k 2, and per-request beams over 3
    requests, through the "step" route on the port's side."""
    rng = np.random.default_rng(55)
    b = 3 if kind in ("greedy_b3", "beam_batch") else 1
    hid = (rng.standard_normal((b, 1, 128)) * 2).astype(np.float32)
    tok0 = np.array([3, 11, 40][:b], np.int32)
    jc, tc, jp, tp = models["jc"], models["tc"], models["jp"], models["tp"]
    if kind.startswith("greedy"):
        fj = lambda h, t: jq.predictor_frame(jp, h, t, jc, 0.8, 2)       # noqa: E731
        ft = lambda h, t: tq.predictor_frame(tp, h, t, tc, 0.8, 2, fused="step")  # noqa: E731
    elif kind == "beam":
        fj = lambda h, t: jq.predictor_frame_beam(jp, h, t, jc, 3, 2, 0.8, 2)     # noqa: E731
        ft = lambda h, t: tq.predictor_frame_beam(tp, h, t, tc, 3, 2, 0.8, 2,     # noqa: E731
                                                  fused="step")
    else:
        fj = lambda h, t: jq.predictor_frame_beam_batch(jp, h, t, jc, 3, 2, 0.8, 2)  # noqa: E731
        ft = lambda h, t: tq.predictor_frame_beam_batch(tp, h, t, tc, 3, 2, 0.8, 2,  # noqa: E731
                                                        fused="step")
    ids_j, ce_j = jax.jit(fj)(jnp.asarray(hid), jnp.asarray(tok0))
    ids_t, ce_t = ft(_t(hid), _t(tok0))
    np.testing.assert_array_equal(ids_t.numpy(), _np(ids_j))
    np.testing.assert_allclose(ce_t.numpy(), _np(ce_j), atol=0)


@pytest.mark.parametrize("batch", [False, True])
def test_next_talker_input_matches_jax(models, batch):
    rng = np.random.default_rng(56)
    jc, tc, jp, tp = models["jc"], models["tc"], models["jp"], models["tp"]
    b = 3 if batch else 1
    frames = rng.integers(0, 32, size=(b, 6)).astype(np.int32)
    ce0 = rng.standard_normal((b, 1, 128)).astype(np.float32)
    trailing = rng.standard_normal((b, 7, 128)).astype(np.float32)
    if batch:
        ref = jq.next_talker_input_batch(jp, jnp.asarray(frames), jnp.asarray(ce0),
                                         jnp.asarray(trailing), jnp.full((b,), 4), jc)
        out = tq.next_talker_input_batch(tp, _t(frames), _t(ce0), _t(trailing), 4, tc)
    else:
        ref = jq.next_talker_input(jp, jnp.asarray(frames[0]), jnp.asarray(ce0),
                                   jnp.asarray(trailing), jnp.int32(4), jc)
        out = tq.next_talker_input(tp, _t(frames[0]), _t(ce0), _t(trailing), 4, tc)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-6, rtol=1e-6)


def test_codec_decode_matches_jax(models):
    """The 12 Hz decoder at tts_tpu's TINY_CODEC widths, two rows, a code past
    the codebook among them (tts_tpu's gather clamps it)."""
    codes = np.random.default_rng(57).integers(0, 32, size=(2, 10, 6)).astype(np.int32)
    codes[1, 3, 0] = 45
    ref = jax.jit(lambda c: jcm.codec_decode(models["jcp"], c, models["jcc"]))(
        jnp.asarray(codes))
    out = tcm.codec_decode(models["tcp"], _t(codes), models["tcc"])
    assert out.shape == ref.shape == (2, 10 * models["tcc"].total_upsample)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=2e-6 * float(jnp.abs(ref).max()),
                               rtol=1e-4)


# ---------------------------------------------------------------- the slice

def _pipes(models, quantize=None, eos: int = 62, **decode):
    jc, tc = _cfgs(jq, eos), _cfgs(tq, eos)
    jpipe = JaxPipeline(models["jp"], jc, models["jcp"], models["jcc"],
                        JaxDecodeConfig(fused_decode=False, **decode), quantize=quantize)
    tpipe = QwenTTSPipeline(models["tp"], tc, models["tcp"], models["tcc"],
                            QwenDecodeConfig(**decode), quantize=quantize)
    return jpipe, tpipe


def _same_audio(wt, wj):
    assert wt.dtype == np.int16 and wt.shape == wj.shape
    assert np.abs(wj.astype(np.int32)).max() > 1000
    assert np.abs(wt.astype(np.int32) - wj.astype(np.int32)).max() <= 2


def test_build_prefill_embeds_matches_jax(models):
    jpipe, tpipe = _pipes(models, max_frames=4)
    for kw in (dict(language_id=3), dict(language_id=2, speaker_id=7,
                                          instruct_ids=np.array([[1, 2]], np.int32))):
        pj, trj = jpipe.build_prefill_embeds(IDS, **kw)
        pt, trt = tpipe.build_prefill_embeds(IDS, **kw)
        np.testing.assert_allclose(pt.numpy(), pj, atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(trt.numpy(), trj, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("case", ["float", "int8", "beam", "stop"])
def test_synthesize_ids_matches_jax(models, case):
    decode = dict(max_frames=8, repeat_penalty=0.8, penalty_range=3)
    quantize, eos = (8 if case == "int8" else None), 62
    if case == "beam":
        decode.update(use_beam=True, beam_size=3, beam_top_k=2)
    if case == "stop":
        # stop on the group-0 token of the 4th frame the unstopped decode emits
        _, probe = _pipes(models, **decode)
        pre, tr = probe.build_prefill_embeds(IDS, 3)
        buf = torch.zeros(1, 512, 128)
        buf[:, :pre.shape[1]] = pre
        frames, n = probe._decode(buf, pre.shape[1], probe._trailing_buf(tr, 64))
        assert n == 8
        eos = int(frames[3, 0])
    jpipe, tpipe = _pipes(models, quantize, eos, **decode)
    wj, sj = jpipe.synthesize_ids(IDS, language_id=3)
    wt, st = tpipe.synthesize_ids(IDS, language_id=3)
    assert st["frames"] == sj["frames"]
    assert st["frames"] <= 3 if case == "stop" else st["frames"] == 8
    if st["frames"]:
        _same_audio(wt, wj)
    # and the frames themselves, token for token
    pre, tr = jpipe.build_prefill_embeds(IDS, 3)
    jbuf = np.zeros((1, 512, 128), np.float32)
    jbuf[:, :pre.shape[1]] = pre
    jtr = np.concatenate([tr, np.repeat(tr[:, -1:], 64 - tr.shape[1], 1)], 1)
    fj, nj = jpipe._decode_fn[64](jpipe.params, jnp.asarray(jbuf), np.int32(pre.shape[1]),
                                  jnp.asarray(jtr))           # the program synthesize_ids ran
    ft, nt = tpipe._decode(_t(jbuf), pre.shape[1], _t(jtr))
    assert nt == int(nj)
    np.testing.assert_array_equal(ft.numpy()[:nt + 1], _np(fj)[:nt + 1])


@pytest.mark.parametrize("beam", [False, True])
def test_synthesize_from_prefill_batch_matches_jax(models, beam):
    decode = dict(max_frames=6, repeat_penalty=0.8, penalty_range=3)
    if beam:
        decode.update(use_beam=True, beam_size=2, beam_top_k=2)
    jpipe, tpipe = _pipes(models, **decode)
    prompts = [(IDS, 3), (np.array([[7, 1, 4, 30, 22, 8]], np.int32), 2),
               (IDS[:, :2], 5)][:2 if beam else 3]
    reqs_j = [jpipe.build_prefill_embeds(i, lang) for i, lang in prompts]
    reqs_t = [tpipe.build_prefill_embeds(i, lang) for i, lang in prompts]
    wj, sj = jpipe.synthesize_from_prefill_batch(reqs_j)
    wt, st = tpipe.synthesize_from_prefill_batch(reqs_t)
    assert st["frames"] == sj["frames"] == 6 * len(prompts)
    for a, b in zip(wt, wj):
        _same_audio(a, b)


def test_pipeline_rejects_unported_quantize_and_degenerate_beam(models):
    with pytest.raises(ValueError):
        QwenTTSPipeline(models["tp"], models["tc"], models["tcp"], models["tcc"], quantize=4)
    with pytest.warns(UserWarning):
        pipe = QwenTTSPipeline(models["tp"], models["tc"], models["tcp"], models["tcc"],
                               QwenDecodeConfig(use_beam=True, beam_size=1))
    assert not pipe.dcfg.use_beam
