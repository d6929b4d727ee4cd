"""The port's KaniTTS slice against tts_tpu on the CPU, fp32 on both sides,
at a small config: tts_tpu's init_params -> params_from_jax, then the AR
core's modules (int8 quantization, convs, NanoCodec, sampling, beam search,
attention, the KV cache), one kani_step run through the fused decode step,
and the whole synthesize_ids (greedy with a repetition penalty, beam,
batch, int8) against tts_tpu's KaniPipeline.

The port's kernel wrappers run their plain twins here; tts_tpu runs its XLA
path, or its Pallas kernel in interpret mode where a test says so. Both
compute the same fp32 math in another summation order; the tolerances
below give each reason."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.models import kani as jk
from tts_tpu.models import nanocodec as jnc
from tts_tpu.runtime.kani import KaniDecodeConfig as JaxDecodeConfig
from tts_tpu.runtime.kani import KaniPipeline as JaxPipeline
from tts_tpu_torch.models import kani as tk
from tts_tpu_torch.models import nanocodec as tnc
from tts_tpu_torch.quant.weight_only import QTensor, quantize_int8_jit, quantize_pytree
from tts_tpu_torch.runtime.kani import KaniDecodeConfig, KaniPipeline
from tts_tpu_torch.weights.convert import params_from_jax

# tts_tpu's hd-64 decode-step config (tests/test_decode_step.py), which
# packs for both fused routes
LM = dict(hidden_size=128, num_heads=16, num_kv_heads=8, head_dim=64, ffn_dim=192,
          vocab_size=64, layer_types=("conv", "attn", "conv", "attn"), max_seq_len=64,
          stop_token=-1)
CODEC = dict(base_channels=16, up_sample_rates=(2, 2), kernel_sizes=(3,),
             dilations=(1, 3), activation="half_snake")
IDS = np.array([[3, 9, 4, 17, 2]], np.int32)
# fp32 logits of a 4-layer step that agree to ~1e-6 relative
STEP_TOL = dict(atol=5e-5, rtol=5e-4)


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
    jp = jk.init_params(jc, jax.random.key(0))
    jcp = jnc.init_params(jcc, jax.random.key(1))
    # a louder codec (its random output peaks near 1e-4) so the int16
    # comparison sees a good part of the sample range
    jcp["post_conv"]["w"] = jcp["post_conv"]["w"] * 4000.0
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    tcp = params_from_jax(jax.tree.map(np.asarray, jcp), "cpu", torch.float32)
    return dict(jc=jc, tc=tc, jcc=jcc, tcc=tcc, jp=jp, jcp=jcp, tp=tp, tcp=tcp)


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("shape,scale", [((256, 384), 0.05), ((3, 64, 96), 1.0),
                                         ((128, 64), 1e-9)])
def test_quantize_int8_is_bit_equal(shape, scale):
    """Against the compiled form tts_tpu's quantize_pytree runs."""
    from tts_tpu.quant.weight_only import quantize_int8 as jq

    w = (np.random.default_rng(31).standard_normal(shape) * scale).astype(np.float32)
    w.reshape(-1)[:7] = np.array([0.5, -0.5, 1.5, 2.5, -2.5, 0.0, 3.5]) * scale
    ref = jax.jit(jq)(jnp.asarray(w))
    out = quantize_int8_jit(_t(w))
    assert out.q.dtype == torch.int8 and out.scale.dtype == torch.float32
    np.testing.assert_array_equal(out.q.numpy(), _np(ref.q))
    np.testing.assert_array_equal(out.scale.numpy(), _np(ref.scale))


def test_quantize_pytree_takes_tts_tpus_leaves(models):
    from tts_tpu.quant.weight_only import QTensor as JQ
    from tts_tpu.quant.weight_only import quantize_pytree as jqp

    ref = jqp(models["jp"], bits=8)
    out = quantize_pytree(models["tp"], bits=8)
    for lj, lt in zip(ref["layers"], out["layers"]):
        for key in ("wqkv", "wo", "in_proj", "out_proj"):
            if key in lj:
                assert isinstance(lj[key], JQ) == isinstance(lt[key], QTensor), key
                if isinstance(lt[key], QTensor):
                    np.testing.assert_array_equal(lt[key].q.numpy(), _np(lj[key].q))
    assert isinstance(out["lm_head"], torch.Tensor)        # 8192 < min_size


@pytest.mark.parametrize("k,stride,padding", [(14, 7, 0), (4, 2, 0), (5, 3, 1)])
def test_conv_transpose1d_matches_jax(k, stride, padding):
    from tts_tpu.ops.conv import conv_transpose1d as jct
    from tts_tpu_torch.ops.conv import conv_transpose1d

    rng = np.random.default_rng(32)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ref = jct(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
              padding=padding)
    out = conv_transpose1d(_t(x), _t(w), _t(b), stride=stride, padding=padding)
    assert out.shape == ref.shape == (2, (11 - 1) * stride - 2 * padding + k, 5)
    # sums of <= k * 6 fp32 products of O(1) values
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("groups,dilation", [(1, 3), (8, 5), (1, 1)])
def test_conv1d_dilation_matches_jax(groups, dilation):
    from tts_tpu.ops.conv import conv1d as jconv
    from tts_tpu_torch.ops.conv import conv1d

    rng = np.random.default_rng(33)
    x = rng.standard_normal((2, 40, 8)).astype(np.float32)
    w = rng.standard_normal((3, 8 // groups, 8)).astype(np.float32)
    ref = jconv(jnp.asarray(x), jnp.asarray(w), padding=2, dilation=dilation,
                groups=groups)
    out = conv1d(_t(x), _t(w), padding=2, dilation=dilation, groups=groups)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5, rtol=1e-5)


def test_fsq_and_codes_match_jax(models):
    jcc, tcc = models["jcc"], models["tcc"]
    rng = np.random.default_rng(34)
    flat = rng.integers(-9000, 20000, size=(2, 24)).astype(np.int32)   # out of range too
    cj = jnc.tokens_to_codes(jnp.asarray(flat), jcc, 100)
    ct = tnc.tokens_to_codes(_t(flat), tcc, 100)
    np.testing.assert_array_equal(ct.numpy(), _np(cj))
    np.testing.assert_array_equal(tnc.fsq_dequantize(ct, tcc).numpy(),
                                  _np(jnc.fsq_dequantize(cj, jcc)))


@pytest.mark.parametrize("activation", ["half_snake", "snake", "lrelu"])
def test_hifigan_decode_matches_jax(activation):
    jcc = jnc.NanoCodecConfig(**{**CODEC, "activation": activation})
    tcc = tnc.NanoCodecConfig(**{**CODEC, "activation": activation})
    jcp = jnc.init_params(jcc, jax.random.key(2))
    rng = np.random.default_rng(35)
    for leaf in ("stage_acts", "post_act"):      # alphas away from 1
        acts = jcp[leaf] if isinstance(jcp[leaf], list) else [jcp[leaf]]
        for a in acts:
            a["alpha"] = jnp.asarray(0.5 + rng.random(a["alpha"].shape), jnp.float32)
            a["alpha_recip"] = 1.0 / a["alpha"]
    tcp = params_from_jax(jax.tree.map(np.asarray, jcp), "cpu", torch.float32)
    feats = rng.standard_normal((2, 16, jcc.input_dim)).astype(np.float32)
    ref = jnc.hifigan_decode(jcp, jnp.asarray(feats), jcc)
    out = tnc.hifigan_decode(tcp, _t(feats), tcc)
    assert out.shape == ref.shape == (2, 16 * jcc.total_upsample)
    # a chain of ~20 fp32 convs: relative agreement ~1e-6 of the peak
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-6 * float(
        jnp.abs(ref).max()), rtol=1e-4)


@pytest.mark.parametrize("num", [3, 10, 17])
def test_repetition_penalty_matches_jax(num):
    from tts_tpu.decoding.sampling import apply_repetition_penalty as jpen
    from tts_tpu_torch.decoding.sampling import apply_repetition_penalty

    rng = np.random.default_rng(36)
    logits = rng.standard_normal((2, 40)).astype(np.float32)      # both signs
    save = rng.integers(0, 40, size=(2, 24)).astype(np.int32)
    save[0, 8:12] = 5                                             # a repeated id
    ref = jpen(jnp.asarray(logits), jnp.asarray(save), jnp.int32(num), 0.8, 10)
    out = apply_repetition_penalty(_t(logits), _t(save), num, 0.8, 10)
    np.testing.assert_array_equal(out.numpy(), _np(ref))


def test_beam_matches_jax_with_ties():
    from tts_tpu.decoding import beam as jb
    from tts_tpu_torch.decoding import beam as tb

    rng = np.random.default_rng(37)
    # bf16-like logits: few distinct values, many ties
    logits = np.round(rng.standard_normal((4, 200)) * 4) / 4
    logits = logits.astype(np.float32)
    prev = np.array([[-0.5], [-0.5], [-1.0], [-0.25]], np.float32)
    ref = jb.beam_step(jnp.asarray(logits), jnp.asarray(prev), 4, 5)
    out = tb.beam_step(_t(logits), _t(prev), 4, 5)
    np.testing.assert_array_equal(out.tokens.numpy(), _np(ref.tokens))
    np.testing.assert_array_equal(out.parent.numpy(), _np(ref.parent))
    np.testing.assert_allclose(out.log_probs.numpy(), _np(ref.log_probs), atol=1e-6)
    ri = jb.beam_init(jnp.asarray(logits[:1]), 4)
    oi = tb.beam_init(_t(logits[:1]), 4)
    np.testing.assert_array_equal(oi.tokens.numpy(), _np(ri.tokens))
    np.testing.assert_allclose(oi.log_probs.numpy(), _np(ri.log_probs), atol=1e-6)


@pytest.mark.parametrize("per_row", [False, True])
def test_gqa_attention_matches_jax(per_row):
    from tts_tpu.nn import attention as ja
    from tts_tpu_torch.nn import attention as ta

    rng = np.random.default_rng(38)
    b, s, h, kvh, t, d = 2, 3, 8, 2, 12, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, t, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, t, d)).astype(np.float32)
    mj = ja.attention_mask(s, t, 6, 9)
    mt = ta.attention_mask(s, t, 6, 9)
    np.testing.assert_array_equal(mt.numpy(), _np(mj))
    if per_row:
        kvf = np.array([0, 4], np.int32)
        mj = ja.combine_kv_valid(mj, jnp.arange(t)[None, :] >= jnp.asarray(kvf)[:, None])
        mt = ta.combine_kv_valid(mt, torch.arange(t)[None, :] >= _t(kvf)[:, None])
    ref = ja.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mj)
    out = ta.gqa_attention(_t(q), _t(k), _t(v), mt)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5, rtol=1e-5)


def test_kv_cache_writes_in_place():
    from tts_tpu.kv.cache import KVCache as JKV
    from tts_tpu_torch.kv.cache import KVCache

    rng = np.random.default_rng(39)
    kv = KVCache.create(2, 3, 2, 8, 4, torch.float32)
    jkv = JKV.create(2, 3, 2, 8, 4, jnp.float32)
    kptr = kv.k.data_ptr()
    for step in (3, 1):
        kn = rng.standard_normal((3, step, 2, 4)).astype(np.float32)
        vn = rng.standard_normal((3, step, 2, 4)).astype(np.float32)
        kv, kf, _ = kv.update_layer(1, _t(kn), _t(vn))
        jkv, jkf, _ = jkv.update_layer(1, jnp.asarray(kn), jnp.asarray(vn))
        assert kf.data_ptr() == kv.k[1].data_ptr() == kptr + kv.k[1].storage_offset() * 4
        np.testing.assert_array_equal(kf.numpy(), _np(jkf))
        kv, jkv = kv.advance(step), jkv.advance(step)
    assert kv.length == int(jkv.length) == 4 and kv.k.data_ptr() == kptr
    idx = np.array([2, 0, 0], np.int32)
    sel, jsel = kv.select_batch(_t(idx).long()), jkv.select_batch(jnp.asarray(idx))
    np.testing.assert_array_equal(sel.k[:, :, :, :4].numpy(), _np(jsel.k)[:, :, :, :4])
    np.testing.assert_array_equal(sel.v[:, :, :, :4].numpy(), _np(jsel.v)[:, :, :, :4])
    assert kv.rewind(2).length == 2 and kv.rewind(2).k is kv.k
    with pytest.raises(ValueError):
        kv.rewind(7).update_layer(0, _t(kn[:, :1].repeat(2, 1)), _t(vn[:, :1].repeat(2, 1)))


def test_rope_and_norms_match_jax():
    from tts_tpu.nn import norm as jn
    from tts_tpu.nn.rope import apply_rope as japply
    from tts_tpu_torch.nn.norm import rms_norm
    from tts_tpu_torch.nn.rope import apply_rope

    rng = np.random.default_rng(40)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    cos = rng.standard_normal((3, 16)).astype(np.float32)
    sin = rng.standard_normal((3, 16)).astype(np.float32)
    np.testing.assert_allclose(apply_rope(_t(x), _t(cos), _t(sin)).numpy(),
                               _np(japply(jnp.asarray(x), jnp.asarray(cos),
                                          jnp.asarray(sin))), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(rms_norm(_t(x), _t(w), 1e-5).numpy(),
                               _np(jn.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
                               atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------- weights

def test_params_from_jax_kani_and_codec_key_for_key(models):
    from tts_tpu.quant.weight_only import quantize_pytree as jqp

    def paths(tree, path=()):
        if isinstance(tree, dict):
            return {p for k, v in tree.items() for p in paths(v, path + (k,))}
        if isinstance(tree, list):
            return {p for i, v in enumerate(tree) for p in paths(v, path + (str(i),))}
        return {path}

    def jpaths(tree):
        flat = jax.tree_util.tree_leaves_with_path(tree)
        return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
                for p, _ in flat}

    assert paths(models["tp"]) == jpaths(models["jp"])
    assert paths(models["tcp"]) == jpaths(models["jcp"])
    # an optional conv bias, and int8 leaves taken as the port's QTensor
    jp = dict(models["jp"], layers=list(models["jp"]["layers"]))
    jp["layers"][0] = dict(jp["layers"][0], conv_b=jnp.ones((LM["hidden_size"],)))
    q = params_from_jax(jax.tree.map(np.asarray, jqp(jp, bits=8)), "cpu", torch.bfloat16)
    assert q["layers"][0]["conv_b"].dtype == torch.bfloat16
    wqkv = q["layers"][1]["wqkv"]
    assert isinstance(wqkv, QTensor) and wqkv.q.dtype == torch.int8
    assert wqkv.scale.dtype == torch.float32


@pytest.mark.parametrize("fault", ["mixed", "missing", "shape"])
def test_params_from_jax_rejects_bad_kani_trees(models, fault):
    tree = jax.tree.map(np.asarray, models["jp"])
    if fault == "mixed":                      # a layer of both kinds
        tree["layers"][0]["wo"] = tree["layers"][1]["wo"]
    elif fault == "missing":
        del tree["layers"][1]["k_norm"]
    else:                                     # a head width that does not match
        tree["layers"][1]["q_norm"] = np.zeros(32, np.float32)
    with pytest.raises((KeyError, ValueError)):
        params_from_jax(tree, "cpu", torch.float32)


def test_init_params_has_tts_tpu_structure(models):
    shapes = lambda tree: jax.tree.map(lambda t: tuple(t.shape), tree)   # noqa: E731
    ours = tk.init_params(models["tc"], torch.Generator().manual_seed(0))
    assert shapes(ours) == shapes(models["tp"])
    np.testing.assert_array_equal(ours["rope_cos"].numpy(), _np(models["jp"]["rope_cos"]))
    cours = tnc.init_params(models["tcc"], torch.Generator().manual_seed(1))
    assert shapes(cours) == shapes(params_from_jax(
        jax.tree.map(np.asarray, jnc.init_params(models["jcc"], jax.random.key(1))),
        "cpu", torch.float32))


# ---------------------------------------------------------------- the LM step

def test_kani_step_fused_step_matches_jax(models):
    """The port's "step" route (kernel 12's twin) against tts_tpu's kani_step
    with fused="step" (its Pallas kernel in interpret mode): a prefill and 4
    decode steps, fed each side's own greedy token."""
    from jax.experimental.pallas import tpu as pltpu

    jc, tc, jp, tp = models["jc"], models["tc"], models["jp"], models["tp"]
    ids = IDS[:, :3]
    state = jk.init_state(jc, 1, jnp.float32)
    lj, state = jk.kani_step(jp, jk.embed_tokens(jp, jnp.asarray(ids)), state, jc)
    tstate = tk.init_state(tc, 1, torch.float32)
    lt, tstate = tk.kani_step(tp, tk.embed_tokens(tp, _t(ids)), tstate, tc)
    np.testing.assert_allclose(lt.numpy(), _np(lj), **STEP_TOL)
    for _ in range(4):
        tok = jnp.argmax(lj, -1).astype(jnp.int32)
        assert int(torch.argmax(lt, -1)) == int(tok[0])
        with pltpu.force_tpu_interpret_mode():
            lj, state = jk.kani_step(jp, jk.embed_tokens(jp, tok[:, None]), state, jc,
                                     fused="step")
        lt, tstate = tk.kani_step(tp, tk.embed_tokens(tp, _t(_np(tok))[:, None]), tstate,
                                  tc, fused="step")
        np.testing.assert_allclose(lt.numpy(), _np(lj), **STEP_TOL)
    np.testing.assert_allclose(tstate.kv.k.numpy(), _np(state.kv.k), **STEP_TOL)
    np.testing.assert_allclose(tstate.conv.numpy(), _np(state.conv), **STEP_TOL)
    assert tstate.kv.length == int(state.kv.length) == 7


@pytest.mark.parametrize("case", ["b1", "b2", "prefill", "kv_valid", "no_layout"])
def test_kani_step_routes_as_tts_tpu(models, monkeypatch, case):
    """fused="step" reaches kernel 12 at B=1, S=1 only; batch rows and
    per-row key masks degrade to kernel 11, a prefill or a layout that does
    not pack to the plain path."""
    from tts_tpu_torch.models import kani as mod

    calls = []
    for name in ("fused_qkv_attn", "fused_qkv_rope"):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    cfg = models["tc"] if case != "no_layout" else tk.KaniConfig(
        **{**LM, "num_heads": 3, "num_kv_heads": 3})
    tp = models["tp"] if case != "no_layout" else tk.init_params(
        cfg, torch.Generator().manual_seed(3))
    b = 2 if case in ("b2", "kv_valid") else 1
    s = 3 if case == "prefill" else 1
    state = tk.init_state(cfg, b, torch.float32)
    state = tk.KaniState(state.kv.advance(4), state.conv)
    kvf = torch.tensor([0, 2]) if case == "kv_valid" else None
    x = torch.randn((b, s, cfg.hidden_size), generator=torch.Generator().manual_seed(4))
    tk.kani_step(tp, x, state, cfg, key_valid_from=kvf, fused="step")
    want = {"b1": ["fused_qkv_attn"] * 2, "b2": ["fused_qkv_rope"] * 2,
            "kv_valid": ["fused_qkv_rope"] * 2, "prefill": [], "no_layout": []}[case]
    assert calls == want


# ---------------------------------------------------------------- the slice

def _pipes(models, **decode):
    cfg = dict(decode)
    quantize = cfg.pop("quantize", None)
    lm = cfg.pop("lm", {})
    jc, tc = jk.KaniConfig(**{**LM, **lm}), tk.KaniConfig(**{**LM, **lm})
    jpipe = JaxPipeline(models["jp"], jc, models["jcp"], models["jcc"],
                        JaxDecodeConfig(fused_decode=False, **cfg),
                        audio_tokens_start=0, quantize=quantize)
    tpipe = KaniPipeline(models["tp"], tc, models["tcp"], models["tcc"],
                         KaniDecodeConfig(**cfg), audio_tokens_start=0,
                         quantize=quantize)
    return jpipe, tpipe


def _same_audio(wt, wj):
    assert wt.dtype == np.int16 and wt.shape == wj.shape
    assert np.abs(wj.astype(np.int32)).max() > 3000
    # int16 truncation of float waveforms that agree to ~1e-6: a sample on
    # an integer boundary may land one LSB apart; 2 LSB leaves room for that
    assert np.abs(wt.astype(np.int32) - wj.astype(np.int32)).max() <= 2


@pytest.mark.parametrize("case", ["greedy_penalty", "beam", "int8", "stop"])
def test_synthesize_ids_matches_jax(models, case):
    decode = {"greedy_penalty": dict(max_new_tokens=24, repeat_penalty=0.8),
              "beam": dict(max_new_tokens=20, use_beam=True, beam_size=3, top_k=3,
                           repeat_penalty=0.8, penalty_range=4),
              "int8": dict(max_new_tokens=24, repeat_penalty=1.0, quantize=8),
              "stop": dict(max_new_tokens=24, repeat_penalty=0.8)}[case]
    if case == "stop":
        # stop on the 8th token the unstopped decode emits
        _, probe = _pipes(models, **decode)
        save, n = probe._greedy_run(torch.from_numpy(np.pad(IDS, ((0, 0), (0, 27)))),
                                    IDS.shape[1], 24, 66)
        assert n == 24
        stop = int(save[0, 7])
        decode["lm"] = {"stop_token": stop}
    jpipe, tpipe = _pipes(models, **decode)
    wj, sj = jpipe.synthesize_ids(IDS)
    wt, st = tpipe.synthesize_ids(IDS)
    assert st["tokens"] == sj["tokens"]
    if case == "stop":
        assert st["tokens"] <= 7
    else:
        assert st["tokens"] == decode["max_new_tokens"]
    if st["tokens"] > 6:
        _same_audio(wt, wj)
    else:
        assert len(wt) == len(wj)


@pytest.mark.parametrize("quantize", [4, 16, "w8a8"])
def test_kani_pipeline_rejects_unported_quantize(models, quantize):
    """Only int8 is ported for Kani: int4 and anything else raise."""
    with pytest.raises(ValueError):
        KaniPipeline(models["tp"], tk.KaniConfig(**LM), models["tcp"], models["tcc"],
                     KaniDecodeConfig(), audio_tokens_start=0, quantize=quantize)


def test_synthesize_ids_batch_matches_jax(models):
    jpipe, tpipe = _pipes(models, max_new_tokens=24, repeat_penalty=0.8)
    prompts = [IDS, np.array([[7, 11, 2, 30, 14, 8]], np.int32), IDS[:, :3]]
    wj, sj = jpipe.synthesize_ids_batch(prompts)
    wt, st = tpipe.synthesize_ids_batch(prompts)
    assert st["tokens"] == sj["tokens"] == 3 * 24
    for a, b in zip(wt, wj):
        _same_audio(a, b)


def test_benchmark_reports_rates(models):
    _, tpipe = _pipes(models, max_new_tokens=16, repeat_penalty=1.0)
    out = tpipe.benchmark(iters=1)
    up, sr = models["tcc"].total_upsample, models["tcc"].sample_rate
    assert out["tokens"] == 16 and out["samples"] == (16 - 2) // 4 * up
    assert out["audio_s"] == (16 - 2) // 4 * up / sr
    assert out["tokens_per_s"] > 0 and out["rtf"] == out["wall_s"] / out["audio_s"]
