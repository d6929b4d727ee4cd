"""The port's F5 route table against tts_tpu's on the CPU.

`attention_route` is held against tts_tpu's own gates: tts_tpu's
`_dit_attention` runs with its backend reported as "tpu" and its kernel
entry points replaced by recorders, so the route it would take on a TPU is
read off the call it makes. On "cuda" the CUDA kernels' limits come on top
(kernel 1 bf16 only; kernels 4 and 5 bf16 or fp32 with head_dim <= 256).

Then `_dit_attention` and `_dit_block` at tiny widths, fp32, through each
route the port takes on the CPU (the kernels' twins: kernel 1 at head dim
128, kernel 4 at head dim 192 and at odd heads, kernel 5 at T 4224, the
plain chain), against tts_tpu's CPU path (its XLA chain: per-head RoPE and a
max-subtracted softmax). Tolerance: atol 2e-5 and rtol 1e-5, as
tests/test_torch_f5.py: both sides compute the same fp32 math, the softmax
in two forms (the twins' exp2 with a fixed shift, or the online max,
against one max-subtracted pass) that agree to fp32 rounding. The W8A8 block
on its non-flat route (kernel 4's twin) is held against tts_tpu's W8A8
route in interpret mode to a mean |diff| of 5e-5, as
tests/test_torch_f5_q8.py explains (an ulp in attention can flip one int8
rounding of a row's quantized input), with the rows off by more than 1e-4
at most 2% of the rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tts_tpu.models.f5 as jf5
import tts_tpu.ops.flash_attention as jfa
from tts_tpu_torch.models import f5 as tf5
from tts_tpu_torch.quant.weight_only import quantize_int8_eager

DIM = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attn_params(heads: int, head_dim: int, seed: int, dim: int = DIM) -> dict:
    """numpy attention params at a scale that makes the softmax peaky."""
    rng = np.random.default_rng(seed)
    inner = heads * head_dim

    def rn(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"wqkv": rn(dim, 3 * inner, scale=0.6 / np.sqrt(dim)),
            "bqkv": rn(3 * inner, scale=0.1),
            "wo": rn(inner, dim, scale=1 / np.sqrt(inner)), "bo": rn(dim, scale=0.1)}


def _tts_tpu_route(dtype, head_dim: int, heads: int, t: int, monkeypatch) -> str:
    """The route tts_tpu's `_dit_attention` takes on a TPU, read off the
    kernel call it makes."""
    calls = []
    inner = heads * head_dim

    def flat(qkv, *a, **k):
        calls.append("flat")
        return jnp.zeros((qkv.shape[0], t, inner), qkv.dtype)

    def mha(q, *a, block_kv=256, packed_out=False, **k):
        calls.append("onepass" if block_kv == t else "online")
        b = q.shape[0]
        return jnp.zeros((b, t, inner) if packed_out else (b, heads, t, head_dim), q.dtype)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jfa, "flash_attention_flat", flat)
    monkeypatch.setattr(jfa, "flash_attention", mha)
    p = {k: jnp.asarray(v, dtype) for k, v in _attn_params(heads, head_dim, 0, 8).items()}
    cos, sin = (jnp.zeros((t, head_dim), jnp.float32),) * 2
    jf5._dit_attention(p, jnp.zeros((1, t, 8), dtype), cos, sin, heads, head_dim)
    assert len(calls) <= 1
    return calls[0] if calls else "plain"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim,heads,t", [
    (64, 16, 1408),      # F5TTS_v1_Base
    (64, 3, 256),        # odd heads at 64: not flat
    (128, 2, 256),
    (128, 3, 4096),
    (192, 2, 256),
    (256, 1, 128),
    (320, 1, 128),       # past the CUDA kernels' 256
    (64, 2, 4224),       # past 4096
    (192, 2, 4224),
    (96, 2, 256),        # not a multiple of 64
    (64, 2, 200),        # T not a multiple of 128
])
def test_attention_route_agrees(dtype, head_dim, heads, t, monkeypatch):
    want = _tts_tpu_route(getattr(jnp, dtype), head_dim, heads, t, monkeypatch)
    tdt = getattr(torch, dtype)
    assert tf5.attention_route(tdt, head_dim, heads, t) == want
    assert tf5.attention_route(tdt, head_dim, heads, t, "cpu") == want
    on_card = want
    if on_card == "flat" and tdt != torch.bfloat16:
        on_card = "onepass"          # kernel 1 is bf16 only: the same contract
    if on_card in ("onepass", "online") and head_dim > 256:
        on_card = "plain"
    assert tf5.attention_route(tdt, head_dim, heads, t, "cuda") == on_card
    if want != "plain":
        assert tf5.attention_route(torch.float16, head_dim, heads, t, "cuda") == "plain"


@pytest.mark.parametrize("dtype,cin,k,t,device,want", [
    (torch.bfloat16, 64, 31, 1408, "cuda", True),
    (torch.bfloat16, 64, 31, 4096, "cuda", True),     # past tts_tpu's 7 MB gate
    (torch.float32, 64, 31, 1408, "cuda", False),
    (torch.float32, 64, 31, 1408, "cpu", True),
    (torch.bfloat16, 8, 31, 256, "cuda", False),      # 8 channels a group
    (torch.bfloat16, 8, 31, 256, "cpu", True),
    (torch.bfloat16, 64, 35, 256, "cuda", False),     # wider than 33 taps
    (torch.bfloat16, 64, 31, 200, "cpu", True),
    (torch.bfloat16, 64, 31, 200, "cuda", False),     # T % 64
    (torch.bfloat16, 64, 31, 100, "cpu", False),      # tts_tpu's T % 8
])
def test_conv_fits(dtype, cin, k, t, device, want):
    assert tf5.conv_fits(dtype, cin, k, t, device) == want


@pytest.mark.parametrize("dtype,rows,d,f,t,device,want", [
    (torch.bfloat16, 2816, 1024, 2048, 1408, "cuda", True),
    (torch.float32, 2816, 1024, 2048, 1408, "cuda", False),
    (torch.float32, 2816, 1024, 2048, 1408, "cpu", False),   # 16.8 MB of weights
    (torch.float32, 512, 128, 256, 256, "cpu", True),
    (torch.float32, 512, 128, 256, 256, "cuda", False),      # the kernel is bf16
    (torch.bfloat16, 512, 96, 256, 256, "cuda", False),      # D % 64
    (torch.bfloat16, 400, 128, 256, 200, "cpu", True),
    (torch.bfloat16, 400, 128, 256, 200, "cuda", False),     # rows % 64
    (torch.bfloat16, 2, 128, 256, 1, "cpu", False),          # tts_tpu's T % 8
])
def test_mlp_fits(dtype, rows, d, f, t, device, want):
    assert tf5.mlp_fits(dtype, rows, d, f, t, device) == want


# (heads, head_dim, T, the port's CPU route)
CASES = [
    (2, 128, 256, "flat"),
    (2, 192, 256, "onepass"),
    (3, 64, 256, "onepass"),
    (2, 64, 4224, "online"),
    (2, 64, 200, "plain"),
    (2, 96, 256, "plain"),
]
IDS = [f"H{h}xD{d}-T{t}-{r}" for h, d, t, r in CASES]


def _inputs(heads, head_dim, t, seed, dim=DIM):
    rng = np.random.default_rng(seed)
    p = _attn_params(heads, head_dim, seed, dim)
    x = rng.standard_normal((1, t, dim)).astype(np.float32)
    cos, sin = jf5.f5_rope_tables(t, head_dim)
    kv = t - 37
    return p, x, cos, sin, kv


@pytest.mark.parametrize("heads,head_dim,t,route", CASES, ids=IDS)
def test_dit_attention_matches_jax(heads, head_dim, t, route):
    assert tf5.attention_route(torch.float32, head_dim, heads, t, "cpu") == route
    p, x, cos, sin, kv = _inputs(heads, head_dim, t, 50 + head_dim + t)
    ref = jf5._dit_attention({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                             jnp.asarray(cos), jnp.asarray(sin), heads, head_dim,
                             jnp.int32(kv))
    out = tf5._dit_attention({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), torch.from_numpy(cos),
                             torch.from_numpy(sin), heads, head_dim, kv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def _block(heads, head_dim, seed, dim=DIM):
    rng = np.random.default_rng(seed)
    p = {"attn": _attn_params(heads, head_dim, seed, dim),
         "ff1": {"w": (rng.standard_normal((dim, 2 * dim)) * 0.1).astype(np.float32),
                 "b": (rng.standard_normal(2 * dim) * 0.1).astype(np.float32)},
         "ff2": {"w": (rng.standard_normal((2 * dim, dim)) * 0.1).astype(np.float32),
                 "b": (rng.standard_normal(dim) * 0.1).astype(np.float32)}}
    mod = (rng.standard_normal((1, 1, 6 * dim)) * 0.3).astype(np.float32)
    return p, mod


def _cfgs(heads, head_dim, dim=DIM):
    kw = dict(dim=dim, depth=1, heads=heads, head_dim=head_dim, ff_mult=2)
    return jf5.F5Config(**kw), tf5.F5Config(**kw)


@pytest.mark.parametrize("heads,head_dim,t,route", CASES, ids=IDS)
def test_dit_block_matches_jax(heads, head_dim, t, route):
    p, mod = _block(heads, head_dim, 70 + head_dim + t)
    _, x, cos, sin, kv = _inputs(heads, head_dim, t, 71 + head_dim + t)
    jc, tc = _cfgs(heads, head_dim)
    ref = jf5._dit_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x), None,
                         jnp.asarray(cos), jnp.asarray(sin), jc, jnp.int32(kv),
                         mod=jnp.asarray(mod))
    tp = jax.tree.map(torch.from_numpy, p)
    out = tf5._dit_block(tp, torch.from_numpy(x), torch.from_numpy(mod),
                         torch.from_numpy(cos), torch.from_numpy(sin), tc, kv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_online_route_rejects_per_row_kv_len():
    """Past T 4096 the route is kernel 5, which masks with a scalar, as in
    tts_tpu."""
    p, x, cos, sin, _ = _inputs(2, 64, 4224, 3)
    with pytest.raises(NotImplementedError):
        tf5._dit_attention({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(np.concatenate([x, x])), torch.from_numpy(cos),
                           torch.from_numpy(sin), 2, 64, torch.tensor([4200, 4000]))


@pytest.mark.parametrize("heads,head_dim", [(2, 192), (1, 256)])
def test_w8a8_block_non_flat_route(heads, head_dim, monkeypatch):
    """Int8 weights at a head geometry kernel 1 does not take: the port's
    kernel 7, then `_rope_qkv_flat` + kernel 4, kernel 8 and kernel 6 (all
    twins here) against tts_tpu's W8A8 route in interpret mode. Width 128,
    so that the weights fit the int8 kernels' limits (`q8_fits`)."""
    from tts_tpu.quant.weight_only import quantize_int8

    t, dim = 256, 128
    p, mod = _block(heads, head_dim, 90 + head_dim, dim)
    _, x, cos, sin, kv = _inputs(heads, head_dim, t, 91 + head_dim, dim)
    jc, tc = _cfgs(heads, head_dim, dim)
    jp = jax.tree.map(jnp.asarray, p)
    jp["attn"] = {**jp["attn"], "wqkv": quantize_int8(jp["attn"]["wqkv"]),
                  "wo": quantize_int8(jp["attn"]["wo"])}
    jp["ff1"] = {**jp["ff1"], "w": quantize_int8(jp["ff1"]["w"])}
    jp["ff2"] = {**jp["ff2"], "w": quantize_int8(jp["ff2"]["w"])}
    monkeypatch.setattr(jf5, "Q8_INTERPRET", True)
    ref = jf5._dit_block(jp, jnp.asarray(x), None, jnp.asarray(cos), jnp.asarray(sin), jc,
                         jnp.int32(kv), mod=jnp.asarray(mod))
    tp = jax.tree.map(torch.from_numpy, p)
    tp["attn"] = {**tp["attn"], "wqkv": quantize_int8_eager(tp["attn"]["wqkv"]),
                  "wo": quantize_int8_eager(tp["attn"]["wo"])}
    tp["ff1"] = {**tp["ff1"], "w": quantize_int8_eager(tp["ff1"]["w"])}
    tp["ff2"] = {**tp["ff2"], "w": quantize_int8_eager(tp["ff2"]["w"])}
    calls = []
    for name in ("flash_attention", "flash_attention_flat", "ln_qkv_q8"):
        fn = getattr(tf5, name)
        monkeypatch.setattr(tf5, name, lambda *a, _f=fn, _n=name, **k:
                            (calls.append(_n), _f(*a, **k))[1])
    out = tf5._dit_block(tp, torch.from_numpy(x), torch.from_numpy(mod),
                         torch.from_numpy(cos), torch.from_numpy(sin), tc, kv)
    assert calls == ["ln_qkv_q8", "flash_attention"]
    diff = np.abs(out.numpy() - np.asarray(ref))
    assert diff.mean() <= 5e-5, f"mean |diff| {diff.mean():.3g}"
    # an int8 rounding flips for a whole row's quantized input at once, so
    # the rows off by more than fp32 rounding are few: at most 2%
    rows = np.unique(np.argwhere(diff > 1e-4)[:, 1])
    assert len(rows) <= 0.02 * t, f"{len(rows)} rows differ: {rows}"
