"""The port's quantizers, int4 `dense`, quantized-leaf conversion and F5
text frontend against tts_tpu's, on the CPU.

Quantizers are pinned bit for bit: the eager int8 form against tts_tpu's
`quantize_int8` called eagerly (what its F5Pipeline runs), the jitted form
against `jax.jit(quantize_int8)`, and the int4 k_quant search against an
eager `quantize_int4`. Where tts_tpu runs the int4 search under jit
(`quantize_pytree`), XLA sums each group in another order: the refit scales
then differ by ulps, and a (group, column) whose two best candidates' errors
lie within 1e-6 (relative) of each other may pick the other one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu_torch.quant.weight_only import (QTensor, QTensor4, QTensorG, dense,
                                             quantize_int4, quantize_int8_eager,
                                             quantize_int8_jit, quantize_pytree)
from tts_tpu_torch.weights.convert import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weight(shape, scale, seed):
    w = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    w.reshape(-1)[:7] = np.array([0.5, -0.5, 1.5, 2.5, -2.5, 0.0, 3.5]) * scale
    return w


@pytest.mark.parametrize("shape,scale", [((256, 384), 0.05), ((3, 64, 96), 1.0),
                                         ((1024, 3072), 1.0), ((128, 64), 1e-9)])
def test_quantize_int8_forms_are_bit_equal(shape, scale):
    """The eager form against an eager call, the jitted form against
    jax.jit, q and scale both; on a (1024, 3072) weight the two forms'
    scales differ (the divide against the multiply by f32(1/127))."""
    from tts_tpu.quant.weight_only import quantize_int8 as jq

    w = _weight(shape, scale, 41)
    for ours, ref in ((quantize_int8_eager(_t(w)), jq(jnp.asarray(w))),
                      (quantize_int8_jit(_t(w)), jax.jit(jq)(jnp.asarray(w)))):
        assert ours.q.dtype == torch.int8 and ours.scale.dtype == torch.float32
        np.testing.assert_array_equal(ours.q.numpy(), np.asarray(ref.q))
        np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref.scale))
    if shape == (1024, 3072):
        assert (quantize_int8_eager(_t(w)).scale != quantize_int8_jit(_t(w)).scale).any()


def _near_ties(w, group=32):
    """(G, out) mask of the groups whose best k_quant candidate and the best
    one that rounds the group otherwise have errors within 1e-6 of each
    other (relative), in float64. (Candidates that round alike refit to the
    same scale: they tie exactly and pick the same pair.)"""
    cin, cout = w.shape
    wf = w.astype(np.float64).reshape(cin // group, group, cout)
    amax = np.maximum(np.abs(w.reshape(cin // group, group, cout)).max(1), 1e-8)
    errs, qs = [], []
    for d in np.linspace(7.0, 9.4, 14):
        cand = (amax / np.float32(d)).astype(np.float64)
        q = np.clip(np.round(wf / cand[:, None]), -7, 7)
        s = (wf * q).sum(1) / np.maximum((q * q).sum(1), 1e-8)
        errs.append(((wf - q * s[:, None]) ** 2).sum(1))
        qs.append(q)
    errs, qs = np.stack(errs), np.stack(qs)                  # (14, G, out), (14, G, g, out)
    best = errs.argmin(0)
    q_best = np.take_along_axis(qs, best[None, :, None, :], 0)[0]
    other = (qs != q_best[None]).any(2)                      # (14, G, out)
    e1 = errs.min(0)
    e2 = np.where(other, errs, np.inf).min(0)
    return (e2 - e1) <= 1e-6 * np.maximum(e1, 1e-30)


def _assert_int4_matches(ours: QTensorG, q_ref, s_ref, w, scale_rtol=0.0):
    """q and scale equal in every (group, column) but near ties (< 0.1%)."""
    ties = _near_ties(w)
    qo = ours.q.numpy().reshape(ties.shape[0], -1, ties.shape[1])
    qr = np.asarray(q_ref).reshape(qo.shape)
    same_q = (qo == qr).all(1)
    close_s = np.isclose(ours.scale.numpy(), s_ref, rtol=scale_rtol, atol=0)
    bad = ~(same_q & close_s)
    assert not (bad & ~ties).any(), f"{int((bad & ~ties).sum())} groups differ"
    assert ties.mean() < 1e-3, f"{ties.sum()} near ties of {ties.size}"


@pytest.mark.parametrize("shape,scale", [((256, 384), 0.02), ((96, 64), 1.0)])
def test_quantize_int4_matches_eager(shape, scale):
    from tts_tpu.quant.weight_only import _unpack_int4_int8
    from tts_tpu.quant.weight_only import quantize_int4 as jq4

    w = _weight(shape, scale, 42)
    ref = jq4(jnp.asarray(w))
    out = quantize_int4(_t(w))
    assert isinstance(out, QTensor4) and out.q.shape == (shape[0] // 2, shape[1])
    with pytest.raises(ValueError):
        quantize_int4(_t(w[:shape[0] - 16]))
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(ref.q))      # packed bytes
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(out.unpack_runtime().q.numpy(),
                                  np.asarray(_unpack_int4_int8(ref)))
    _assert_int4_matches(out.unpack_runtime(), _unpack_int4_int8(ref),
                         np.asarray(ref.scale), w)
    g = out.unpack_runtime()
    assert g.pack().q.equal(out.q) and int(g.q.abs().max()) <= 7


def test_quantize_pytree_int4_against_jitted_search():
    from tts_tpu.quant.weight_only import quantize_pytree as jqp

    w = _weight((512, 384), 0.02, 43)
    small = _weight((48, 40), 0.02, 44)        # 48 % 32 != 0: int8
    tree = {"wqkv": w, "wo": small, "norm": np.ones(384, np.float32)}
    ref = jqp(jax.tree.map(jnp.asarray, tree), bits=4, min_size=1)
    out = quantize_pytree({k: _t(v) for k, v in tree.items()}, bits=4, min_size=1)
    assert isinstance(out["wqkv"], QTensorG) and isinstance(out["wo"], QTensor)
    assert isinstance(out["norm"], torch.Tensor)
    _assert_int4_matches(out["wqkv"], ref["wqkv"].q, np.asarray(ref["wqkv"].scale), w,
                         scale_rtol=1e-6)
    np.testing.assert_array_equal(out["wo"].q.numpy(), np.asarray(ref["wo"].q))
    with pytest.raises(ValueError):
        quantize_pytree(tree, bits=3)


@pytest.mark.parametrize("form", ["packed", "runtime", "int8"])
def test_dense_matches_jax(form):
    from tts_tpu.quant.weight_only import dense as jdense
    from tts_tpu.quant.weight_only import quantize_int4 as jq4
    from tts_tpu.quant.weight_only import quantize_int8 as jq8

    rng = np.random.default_rng(45)
    w = (rng.standard_normal((128, 96)) * 0.05).astype(np.float32)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    if form == "int8":
        jw, tw = jq8(jnp.asarray(w)), quantize_int8_eager(_t(w))
    else:
        jw, tw = jq4(jnp.asarray(w)), quantize_int4(_t(w))
        if form == "runtime":
            jw, tw = jw.unpack_runtime(), tw.unpack_runtime()
    ref = np.asarray(jdense(jnp.asarray(x), jw))
    out = dense(_t(x), tw)
    # fp32 dots of 128 (int8) or 4 x 32 (int4, scaled per group) products
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6, rtol=1e-5)


def test_params_from_jax_takes_int4_leaves():
    from tts_tpu.models import f5 as jf5
    from tts_tpu.quant.weight_only import quantize_int4 as jq4

    cfg = jf5.F5Config(dim=64, depth=1, heads=1, head_dim=64, text_dim=32,
                       conv_layers=1, nfe_steps=4, max_signal_len=256, vocab_size=10)
    jp = jf5.init_params(cfg, jax.random.key(0))
    blk = jp["blocks"][0]
    blk["attn"]["wqkv"] = jq4(blk["attn"]["wqkv"])                   # packed
    blk["ff1"]["w"] = jq4(blk["ff1"]["w"]).unpack_runtime()           # unpacked
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.bfloat16)
    wqkv, ff1 = tp["blocks"][0]["attn"]["wqkv"], tp["blocks"][0]["ff1"]["w"]
    assert isinstance(wqkv, QTensor4) and isinstance(ff1, QTensorG)
    np.testing.assert_array_equal(wqkv.q.numpy(), np.asarray(blk["attn"]["wqkv"].q))
    np.testing.assert_array_equal(ff1.q.numpy(), np.asarray(blk["ff1"]["w"].q))
    assert wqkv.scale.dtype == torch.float32 and wqkv.group_size == 32
    np.testing.assert_array_equal(ff1.scale.numpy(), np.asarray(blk["ff1"]["w"].scale))
    # a packed q of the wrong size no longer fits the block's dims
    blk["attn"]["wqkv"].q = blk["attn"]["wqkv"].q[:16]
    with pytest.raises(ValueError):
        params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


_TEXTS = ["你好，世界。Hello", "我们在1.5%的时候AT&T", "中文“引号”‘单’;x"]


@pytest.mark.parametrize("text", _TEXTS)
def test_f5_duration_and_text_to_ids_match_tts_tpu(text):
    """The copied host helpers, which need no jieba."""
    from tts_tpu.frontend import f5_text as ref
    from tts_tpu_torch.frontend import f5_text as ours

    assert ours.f5_duration(12345, text, "abc。", 256, 1.1) == \
        ref.f5_duration(12345, text, "abc。", 256, 1.1)
    assert (ours.text_to_ids(list(text), {"a": 3, "你": 5}) ==
            ref.text_to_ids(list(text), {"a": 3, "你": 5})).all()


@pytest.mark.parametrize("text", _TEXTS)
def test_jieba_frontend_matches_tts_tpu(text):
    """The copied jieba path (pypinyin's absence degrades both alike when
    allowed, and raises in both when not)."""
    import warnings

    from tts_tpu.frontend import f5_text as ref
    from tts_tpu_torch.frontend import f5_text as ours

    pytest.importorskip("jieba")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert ours.convert_char_to_pinyin([text], allow_degraded=True) == \
            ref.convert_char_to_pinyin([text], allow_degraded=True)
    try:
        import pypinyin  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError):
            ours.convert_char_to_pinyin([text])
