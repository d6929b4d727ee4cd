"""The port's decode kernels' wrappers on CPU tensors (their plain PyTorch
twins) against tts_tpu's Pallas kernels run in interpret mode, as tts_tpu's
own decode kernel tests run them: ops/decode_qkv.fused_qkv_rope (kernel 11)
and ops/decode_step.fused_qkv_attn (kernel 12). Same numpy inputs on both
sides, fp32 on both sides.

Tolerance: atol 3e-5, rtol 3e-4, tts_tpu's own bound for the fused decode
step against its XLA chain (tests/test_decode_step.py): both sides compute
the same fp32 math, and only the order of the fp32 sums differs (the
matvec's K reduction, the attention's P.V and the new row's term)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.nn.rope import rope_table
from tts_tpu.quant.weight_only import quantize_int8 as jax_quantize_int8
from tts_tpu_torch.ops.decode_qkv import fusable_layout, fused_qkv_rope
from tts_tpu_torch.ops.decode_step import fused_qkv_attn
from tts_tpu_torch.quant.weight_only import QTensor

TOL = dict(atol=3e-5, rtol=3e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _weights(w: np.ndarray, quant: bool):
    """(jax weight, port weight): the float matrix, or tts_tpu's int8
    QTensor of it and the same q and scale as the port's QTensor."""
    if not quant:
        return jnp.asarray(w), _t(w)
    qt = jax_quantize_int8(jnp.asarray(w))
    return qt, QTensor(q=_t(np.asarray(qt.q)), scale=_t(np.asarray(qt.scale)))


# (norm, q/k norms, bias, rope, head_dim): Kani, Qwen, Qwen with a bias,
# VoxCPM (rope only) and IndexTTS (LayerNorm, bias, no rope)
_QKV_VARIANTS = [("rms", True, False, True, 64), ("rms", True, False, True, 128),
                 ("rms", False, True, True, 128), ("rms", False, False, True, 64),
                 ("ln", False, True, False, 64)]


@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("variant", _QKV_VARIANTS, ids=lambda v: "-".join(map(str, v)))
def test_fused_qkv_rope_matches_pallas(variant, quant, b):
    from tts_tpu.ops.decode_qkv import fused_qkv_rope as pallas

    norm, qknorm, bias, rope, hd = variant
    heads, kvh, hin = 4, 2, 256
    n = (heads + 2 * kvh) * hd
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((b, hin)) * np.logspace(-1, 1, b)[:, None]).astype(np.float32)
    w = (rng.standard_normal((hin, n)) * 0.05).astype(np.float32)
    qn = (1.0 + rng.standard_normal(hd) * 0.2).astype(np.float32) if qknorm else None
    kn = (1.0 + rng.standard_normal(hd) * 0.2).astype(np.float32) if qknorm else None
    bq = (rng.standard_normal(n) * 0.02).astype(np.float32) if bias else None
    lw = (1.0 + rng.standard_normal(hin) * 0.1).astype(np.float32) if norm == "ln" else None
    lb = (rng.standard_normal(hin) * 0.1).astype(np.float32) if norm == "ln" else None
    cos, sin = rope_table(16, hd, 1e6)
    cos, sin = (cos[9:10], sin[9:10]) if rope else (None, None)
    wj, wt = _weights(w, quant)
    eps = 1e-5 if norm == "ln" else 1e-6
    kw = dict(heads=heads, kv_heads=kvh, head_dim=hd, norm=norm, eps=eps)
    jx = lambda a: None if a is None else jnp.asarray(a)   # noqa: E731
    ref = pallas(jnp.asarray(x), wj, jx(cos), jx(sin), q_norm=jx(qn), k_norm=jx(kn),
                 bqkv=jx(bq), ln_weight=jx(lw), ln_bias=jx(lb), interpret=True, **kw)
    out = fused_qkv_rope(_t(x), wt, _t(cos), _t(sin), q_norm=_t(qn), k_norm=_t(kn),
                         bqkv=_t(bq), ln_weight=_t(lw), ln_bias=_t(lb), **kw)
    for o, r, width in zip(out, ref, (heads * hd, kvh * hd, kvh * hd)):
        assert o.shape == (b, width) and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("pos", [0, 9, 31])
@pytest.mark.parametrize("geom", [(16, 8, 64), (8, 2, 128)], ids=["hd64", "hd128"])
def test_fused_qkv_attn_matches_pallas(geom, pos, quant):
    """hd 64 takes the TPU kernel's packed branch, hd 128 its other one;
    pos 0 attends only to the step's own row, pos 31 to all but the last
    cache row."""
    from tts_tpu.ops.decode_step import fused_qkv_attn as pallas

    heads, kvh, hd = geom
    hin, t, layers, layer = 256, 32, 3, 1
    rng = np.random.default_rng(22)
    x = (rng.standard_normal((1, hin)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((hin, (heads + 2 * kvh) * hd)) * 0.05).astype(np.float32)
    kc = (rng.standard_normal((layers, 1, kvh, t, hd)) * 0.5).astype(np.float32)
    vc = (rng.standard_normal((layers, 1, kvh, t, hd)) * 0.5).astype(np.float32)
    qn = (1.0 + rng.standard_normal(hd) * 0.1).astype(np.float32)
    kn = (1.0 + rng.standard_normal(hd) * 0.1).astype(np.float32)
    cos, sin = rope_table(t, hd, 1e6)
    rc, rs = cos[pos:pos + 1], sin[pos:pos + 1]
    wj, wt = _weights(w, quant)
    kw = dict(heads=heads, kv_heads=kvh, head_dim=hd, eps=1e-5)
    ref = pallas(jnp.asarray(x), wj, jnp.asarray(rc), jnp.asarray(rs), jnp.asarray(kc),
                 jnp.asarray(vc), layer, jnp.int32(pos), q_norm=jnp.asarray(qn),
                 k_norm=jnp.asarray(kn), interpret=True, **kw)
    out = fused_qkv_attn(_t(x), wt, _t(rc), _t(rs), _t(kc), _t(vc), layer, pos,
                         q_norm=_t(qn), k_norm=_t(kn), **kw)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_fusable_gates_match_tts_tpu():
    from tts_tpu.ops import decode_qkv as jq

    for geom in [(1, 16, 8, 64), (5, 16, 8, 64), (3, 3, 3, 16), (1, 2, 1, 12),
                 (1, 16, 2, 64), (2, 16, 8, 128), (1, 1, 1, 64)]:
        assert fusable_layout(*geom) == jq.fusable_layout(*geom), geom


@pytest.mark.parametrize("bad", ["split", "rows", "pos", "layer", "pairs"])
def test_decode_wrappers_reject_out_of_contract(bad):
    hin, heads, kvh, hd = 128, 4, 2, 64
    x = torch.zeros(2 if bad == "rows" else 1, hin)
    w = torch.zeros(hin, (heads + 2 * kvh) * hd + (64 if bad == "split" else 0))
    cache = torch.zeros(2, 1, kvh, 16, hd)
    pos = 16 if bad == "pos" else 3
    layer = 2 if bad == "layer" else 0
    qn = torch.ones(hd)
    kn = None if bad == "pairs" else qn
    with pytest.raises(ValueError):
        fused_qkv_attn(x, w, None, None, cache, cache, layer, pos, heads=heads,
                       kv_heads=kvh, head_dim=hd, q_norm=qn, k_norm=kn)
    if bad in ("split", "pairs"):
        with pytest.raises(ValueError):
            fused_qkv_rope(x, w, heads=heads, kv_heads=kvh, head_dim=hd,
                           q_norm=qn, k_norm=kn)
