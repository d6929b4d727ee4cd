"""The port's VoxCPM slice against tts_tpu on the CPU, fp32 on both sides:
tts_tpu's init functions -> params_from_jax, then conv1d with a stride, the
VAE (v1.5 and a v2 decoder with rate conditioning, depthwise init convs and
a noise block, its draws injected), the feature encoder, the CFM schedule
and decoder (the CFM noise injected), the FSQ bottleneck, llama_stack_step
on every decode route, voxcpm_main_step with each kind of audio mask, the
route gates, and the pipelines end to end (synthesize_ids, every
synthesize_v2 mode and synthesize_ids_batch) against tts_tpu's
(fused_decode None, which is False on the CPU), with tts_tpu's CFM draws.

Configs: tests/test_voxcpm.py's TINY, a v2-style TINY beside it, and a
stack of VoxCPM's head geometry (16 q heads over 2 kv heads of 64: 8 a kv
head) at a narrow width, where the kernel routes hold.

Tolerances: a stack step agrees to rounding noise, atol 5e-6 rtol 2e-5
(as tests/test_torch_qwen.py); the int8 route to atol 3e-5 rtol 1e-4.
Waveforms agree to within 1 int16 step: float waveforms that agree to ~1e-6
can truncate to neighbouring integers. FSQ rounding and the stop argmax are
discontinuous: the pipelines run min_latents == max_latents."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.kv.cache import KVCache as JKV
from tts_tpu.models import voxcpm as jv
from tts_tpu.ops import conv as jconv
from tts_tpu.runtime.voxcpm import VoxCPMDecodeConfig as JaxDecodeConfig
from tts_tpu.runtime.voxcpm import VoxCPMPipeline as JaxPipeline
from tts_tpu_torch.kv.cache import KVCache
from tts_tpu_torch.models import voxcpm as tv
from tts_tpu_torch.ops import conv as tconv
from tts_tpu_torch.runtime.voxcpm import VoxCPMDecodeConfig, VoxCPMPipeline
from tts_tpu_torch.weights.convert import params_from_jax

STEP_TOL = dict(atol=5e-6, rtol=2e-5)
Q8_TOL = dict(atol=3e-5, rtol=1e-4)
FN_TOL = dict(atol=2e-5, rtol=1e-4)        # a whole module (VAE, CFM) in fp32


def _cfg(mod, v2: bool = False, noise: bool = True):
    """tests/test_voxcpm.py's TINY; v2: a 16 kHz input and a decoder of
    other rates (x12: 24 kHz out) with sample-rate bins, depthwise init
    convs and (noise) a noise block."""
    stack = mod.LlamaStackConfig
    vae = mod.VaeConfig(d_model=4, latent_dim=8, strides=(2, 4), decoder_channels=16)
    if v2:
        vae = mod.VaeConfig(d_model=4, latent_dim=8, strides=(2, 4), decoder_channels=16,
                            decoder_rates=(4, 3), sr_bins=(22050.0, 44100.0),
                            use_noise_block=noise)
    return mod.VoxCPMConfig(
        base=stack(hidden_size=32, num_heads=2, num_kv_heads=1, head_dim=16, ffn_dim=64,
                   num_layers=2, max_seq_len=512),
        residual=stack(hidden_size=32, num_heads=2, num_kv_heads=1, head_dim=16,
                       ffn_dim=64, num_layers=1, max_seq_len=512),
        feat_encoder=stack(hidden_size=24, num_heads=2, num_kv_heads=1, head_dim=12,
                           ffn_dim=48, num_layers=1, max_seq_len=8),
        estimator=stack(hidden_size=24, num_heads=2, num_kv_heads=1, head_dim=12,
                        ffn_dim=48, num_layers=1, max_seq_len=16),
        vae=vae, patch_size=4, chunk_size=8, fsq_dim=8, vocab_size=128,
        audio_start_id=101, cfm_steps=4, sample_rate=16000 if v2 else 44100)


# VoxCPM's head geometry (16/2 heads x 64) at a narrow width
STACK = dict(hidden_size=128, num_heads=16, num_kv_heads=2, head_dim=64, ffn_dim=256,
             num_layers=2, max_seq_len=64)


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


def _louder(jvae):
    """Random decoder weights give a waveform near 1e-3: scale the last conv
    so the int16 comparison sees a good part of the range."""
    jvae["dec"]["post"]["w"] = jvae["dec"]["post"]["w"] * 300.0
    return jvae


@pytest.fixture(scope="module")
def models():
    jc, jc2 = _cfg(jv), _cfg(jv, v2=True)
    jp = jv.init_params(jc, jax.random.key(0))
    jvae = _louder(jv.init_vae_params(jc.vae, jax.random.key(1)))
    jvae2 = _louder(jv.init_vae_params(jc2.vae, jax.random.key(2)))
    # rate conditioning away from identity, and the optional out layer on
    # the first block (tts_tpu's init leaves both out)
    rng = np.random.default_rng(60)
    for blk in jvae2["dec"]["dec_blocks"]:
        c = blk["sr_scale"].shape[1]
        blk["sr_scale"] = jnp.asarray(1 + 0.2 * rng.standard_normal((3, c)), jnp.float32)
        blk["sr_bias"] = jnp.asarray(0.1 * rng.standard_normal((3, c)), jnp.float32)
    c0 = jc2.vae.decoder_channels
    jvae2["dec"]["dec_blocks"][0]["sr_out_snake"] = {
        "alpha": jnp.full((c0,), 1.3), "alpha_recip": jnp.full((c0,), 1 / 1.3)}
    jvae2["dec"]["dec_blocks"][0]["sr_out_conv"] = {
        "w": jnp.asarray(0.1 * rng.standard_normal((3, c0, c0)), jnp.float32),
        "b": jnp.zeros((c0,))}
    # a full tree at VoxCPM's head geometry: its base stack is the one the
    # route tests step
    scfg = jv.LlamaStackConfig(**STACK)
    jsc = dataclasses.replace(jc, base=scfg, residual=dataclasses.replace(scfg, num_layers=1))
    jsp = jv.init_params(jsc, jax.random.key(3))
    return dict(jc=jc, tc=_cfg(tv), jc2=jc2, tc2=_cfg(tv, v2=True), jp=jp, tp=_conv(jp),
                jvae=jvae, tvae=_conv(jvae), jvae2=jvae2, tvae2=_conv(jvae2), jsp=jsp,
                scfg=scfg, tsc=dataclasses.replace(_cfg(tv), base=tv.LlamaStackConfig(**STACK),
                                                   residual=tv.LlamaStackConfig(
                                                       **{**STACK, "num_layers": 1})))


def _stack_params(models, quant: bool):
    """(jax base-stack params, port base-stack params, rope cos, rope sin) of
    the VoxCPM-geometry tree, int8 with min_size=1 so every matrix
    quantizes."""
    from tts_tpu.quant.weight_only import quantize_pytree as jqp

    jp = jqp(models["jsp"], min_size=1) if quant else models["jsp"]
    return jp["base"], _conv(jp)["base"], jp["rope_cos"], jp["rope_sin"]


# ---------------------------------------------------------------- params

def _paths(tree, path=()):
    if isinstance(tree, dict):
        return {p for k, v in tree.items() for p in _paths(v, path + (k,))}
    if isinstance(tree, list):
        return {p for i, v in enumerate(tree) for p in _paths(v, path + (str(i),))}
    return {path}


def _jpaths(tree):
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)}


def test_params_from_jax_voxcpm_trees_key_for_key(models):
    from tts_tpu.quant.weight_only import quantize_pytree as jqp

    from tts_tpu_torch.quant.weight_only import QTensor

    for j, t in (("jp", "tp"), ("jvae", "tvae"), ("jvae2", "tvae2")):
        assert _paths(models[t]) == _jpaths(models[j])
    q = _conv(jqp(models["jp"], bits=8, min_size=1))
    wqkv = q["base"]["layers"][0]["wqkv"]
    assert isinstance(wqkv, QTensor) and wqkv.q.dtype == torch.int8
    assert isinstance(q["est_in_proj"]["w"], torch.Tensor)       # not a stack key
    # the port's init gives tts_tpu's structure
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)   # noqa: E731
    assert shapes(tv.init_params(models["tc"], torch.Generator().manual_seed(0))) == \
        shapes(models["tp"])
    for cfg, j in ((models["tc"], "tvae"), (models["tc2"], "tvae2")):
        ours = tv.init_vae_params(cfg.vae, torch.Generator().manual_seed(1))
        theirs = shapes(models[j])
        if j == "tvae2":                     # the out layer the test added
            for key in ("sr_out_snake", "sr_out_conv"):
                del theirs["dec"]["dec_blocks"][0][key]
        assert shapes(ours) == theirs
    np.testing.assert_array_equal(
        tv.init_params(models["tc"], torch.Generator().manual_seed(0))["cfm_dt"].numpy(),
        _np(models["jp"]["cfm_dt"]))


@pytest.mark.parametrize("fault", ["missing", "shape", "residual_width", "vae_missing",
                                   "vae_latent", "vae_sr_bins"])
def test_params_from_jax_rejects_bad_voxcpm_trees(models, fault):
    tree = jax.tree.map(np.asarray, models["jvae2" if fault.startswith("vae") else "jp"])
    if fault == "missing":
        del tree["fsq_up"]
    elif fault == "shape":
        tree["fe_special"] = np.zeros((1, 20), np.float32)
    elif fault == "residual_width":              # the stacks share the base width
        tree["residual"]["layers"][0]["w_down"] = np.zeros((64, 48), np.float32)
    elif fault == "vae_missing":
        del tree["dec"]["post"]
    elif fault == "vae_latent":                  # the decoder must take fc_mu's width
        tree["dec"]["pre"]["w"] = np.zeros((1, 6, 16), np.float32)
    else:                                        # one set of rate bins for every block
        tree["dec"]["dec_blocks"][1]["sr_bias"] = np.zeros((2, 8), np.float32)
    with pytest.raises((KeyError, ValueError)):
        params_from_jax(tree, "cpu", torch.float32)


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("stride,groups,dilation", [(2, 1, 1), (3, 1, 2), (2, 6, 1),
                                                    (1, 6, 3), (4, 2, 1)])
def test_conv1d_stride_matches_jax(stride, groups, dilation):
    rng = np.random.default_rng(61)
    x = rng.standard_normal((2, 37, 6)).astype(np.float32)
    w = rng.standard_normal((5, 6 // groups, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ref = jconv.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                       padding=2, dilation=dilation, groups=groups)
    out = tconv.conv1d(_t(x), _t(w), _t(b), padding=2, groups=groups, dilation=dilation,
                       stride=stride)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("v2", [False, True], ids=["v1.5", "v2"])
def test_vae_matches_jax(models, v2):
    """vae_encode, then vae_decode of its latents (v2: at each rate bin, the
    noise block's draws from tts_tpu's per-block keys injected)."""
    jc, tc = (models["jc2"], models["tc2"]) if v2 else (models["jc"], models["tc"])
    jvae, tvae = (models["jvae2"], models["tvae2"]) if v2 else (models["jvae"], models["tvae"])
    rng = np.random.default_rng(62)
    audio = (0.3 * rng.standard_normal((2, 24 * jc.vae.encoder_stride))).astype(np.float32)
    lat_j = jv.vae_encode(jvae, jnp.asarray(audio), jc.vae)
    lat_t = tv.vae_encode(tvae, _t(audio), tc.vae)
    assert lat_t.shape == lat_j.shape == (2, 24, 8)
    np.testing.assert_allclose(lat_t.numpy(), _np(lat_j), **FN_TOL)
    rates = jc.vae.decoder_rates or tuple(reversed(jc.vae.strides))
    for sr_idx in ((0, 1, 2) if v2 else (0,)):
        ref = jv.vae_decode(jvae["dec"], lat_j, jc.vae, sr_idx=sr_idx)
        noise = None
        if v2:                  # tts_tpu's draws: jax.random.key(i) for block i
            noise = [_t(jax.random.normal(jax.random.key(i),
                                          (2, 24 * int(np.prod(rates[:i + 1])), 1)))
                     for i in range(len(rates))]
        out = tv.vae_decode(tvae["dec"], _t(_np(lat_j)), tc.vae, sr_idx=sr_idx, noise=noise)
        assert out.shape == ref.shape == (2, 24 * jc.vae.decoder_stride)
        np.testing.assert_allclose(out.numpy(), _np(ref), **FN_TOL)


@pytest.mark.parametrize("batch", [False, True])
def test_feat_encoder_cond_matches_jax(models, batch):
    rng = np.random.default_rng(63)
    feats = rng.standard_normal((3, 4, 8)).astype(np.float32)
    f = (jv.feat_encoder_cond_batch, tv.feat_encoder_cond_batch) if batch else \
        (jv.feat_encoder_cond, tv.feat_encoder_cond)
    ej, cj = f[0](models["jp"], jnp.asarray(feats), models["jc"])
    et, ct = f[1](models["tp"], _t(feats), models["tc"])
    assert et.shape == ej.shape and ct.shape == cj.shape
    np.testing.assert_allclose(et.numpy(), _np(ej), **FN_TOL)
    np.testing.assert_allclose(ct.numpy(), _np(cj), **FN_TOL)


@pytest.mark.parametrize("steps,sway", [(10, 1.0), (4, 1.0), (6, 0.5)])
def test_cfm_time_schedule_matches_jax(steps, sway):
    for a, b in zip(tv.cfm_time_schedule(steps, sway), jv.cfm_time_schedule(steps, sway)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch", [False, True])
def test_cfm_feat_decoder_matches_jax(models, batch):
    """The same noise on both sides; the batch form with its [pos | neg]
    feat_cond rows of 3 streams."""
    rng = np.random.default_rng(64)
    b = 3 if batch else 1
    noise = rng.standard_normal((b, 4, 8)).astype(np.float32)
    dit = rng.standard_normal((b, 1, 24)).astype(np.float32)
    cond = rng.standard_normal((2 * b, 4, 24)).astype(np.float32)
    f = (jv.cfm_feat_decoder_batch, tv.cfm_feat_decoder_batch) if batch else \
        (jv.cfm_feat_decoder, tv.cfm_feat_decoder)
    ref = f[0](models["jp"], jnp.asarray(noise), jnp.asarray(dit), jnp.asarray(cond),
               models["jc"])
    out = f[1](models["tp"], _t(noise), _t(dit), _t(cond), models["tc"])
    assert out.shape == ref.shape == (b, 4, 8)
    np.testing.assert_allclose(out.numpy(), _np(ref), **FN_TOL)


def test_fsq_layer_matches_jax(models):
    x = np.random.default_rng(65).standard_normal((2, 7, 32)).astype(np.float32)
    np.testing.assert_allclose(tv.fsq_layer(models["tp"], _t(x), models["tc"]).numpy(),
                               _np(jv.fsq_layer(models["jp"], jnp.asarray(x), models["jc"])),
                               **STEP_TOL)


# ---------------------------------------------------------------- the stack step

ROUTES = [False, True, "step"]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("route", ROUTES, ids=[str(r) for r in ROUTES])
def test_llama_stack_step_routes_match_jax(models, route, quant):
    """A 5-row prefill, then 5 decode steps through `route` on the port's
    side (kernels 11 and 12 by their twins) against tts_tpu's fused=False:
    the hidden states and the cache."""
    jp, tp, cos, sin = _stack_params(models, quant)
    cfg = models["scfg"]
    rng = np.random.default_rng(66)
    xs = (rng.standard_normal((1, 10, cfg.hidden_size)) * 0.5).astype(np.float32)
    jkv = JKV.create(cfg.num_layers, 1, cfg.num_kv_heads, 64, cfg.head_dim, jnp.float32)
    tkv = KVCache.create(cfg.num_layers, 1, cfg.num_kv_heads, 64, cfg.head_dim, torch.float32)
    hj, jkv = jv.llama_stack_step(jp, jnp.asarray(xs[:, :5]), jkv, cfg, cos[:5], sin[:5])
    ht, tkv = tv.llama_stack_step(tp, _t(xs[:, :5]), tkv, cfg, _t(_np(cos[:5])),
                                  _t(_np(sin[:5])))
    np.testing.assert_allclose(ht.numpy(), _np(hj), **STEP_TOL)
    tol = Q8_TOL if quant and route else STEP_TOL
    for p in range(5, 10):
        hj, jkv = jv.llama_stack_step(jp, jnp.asarray(xs[:, p:p + 1]), jkv, cfg,
                                      cos[p:p + 1], sin[p:p + 1])
        ht, tkv = tv.llama_stack_step(tp, _t(xs[:, p:p + 1]), tkv, cfg,
                                      _t(_np(cos[p:p + 1])), _t(_np(sin[p:p + 1])),
                                      fused=route)
        np.testing.assert_allclose(ht.numpy(), _np(hj), **tol)
    assert tkv.length == int(jkv.length) == 10
    np.testing.assert_allclose(tkv.k[:, :, :, :10].numpy(), _np(jkv.k)[:, :, :, :10], **tol)
    np.testing.assert_allclose(tkv.v[:, :, :, :10].numpy(), _np(jkv.v)[:, :, :, :10], **tol)


def _caches(mod, cfg, b, t=64):
    kvc = JKV if mod is jv else KVCache
    dt = jnp.float32 if mod is jv else torch.float32
    return (kvc.create(cfg.base.num_layers, b, cfg.base.num_kv_heads, t, cfg.base.head_dim, dt),
            kvc.create(cfg.residual.num_layers, b, cfg.residual.num_kv_heads, t,
                       cfg.residual.head_dim, dt))


@pytest.mark.parametrize("ctl", ["scalar", "mask_s", "mask_bs", "valid_len"])
def test_voxcpm_main_step_matches_jax(models, ctl):
    """A 12-position pass with the audio positions given as an int boundary,
    an (S,) mask, a (B, S) mask with per-row key validity (row 1 left-padded
    by 3), or the (S,) mask with the true length 9 inside the bucket; then
    one decode step on the "step" route."""
    jc, tc, jp, tp = models["jc"], models["tc"], models["jp"], models["tp"]
    rng = np.random.default_rng(67)
    b = 2 if ctl == "mask_bs" else 1
    h = rng.standard_normal((b, 12, 32)).astype(np.float32)
    fe = rng.standard_normal((b, 12, 32)).astype(np.float32)
    mask = rng.random((b, 12)) < 0.5
    kw_j, kw_t = {}, {}
    if ctl == "scalar":
        cj, ct = jnp.int32(7), 7
    elif ctl == "mask_bs":
        cj, ct = jnp.asarray(mask), _t(mask)
        valid = np.arange(64)[None, :] >= np.array([0, 3])[:, None]
        kw_j, kw_t = dict(kv_valid=jnp.asarray(valid)), dict(kv_valid=_t(valid))
    else:
        cj, ct = jnp.asarray(mask[0]), _t(mask[0])
        if ctl == "valid_len":
            kw_j, kw_t = dict(valid_len=9), dict(valid_len=9)
    jbk, jrk = _caches(jv, jc, b)
    tbk, trk = _caches(tv, tc, b)
    dj, sj, jbk, jrk = jv.voxcpm_main_step(jp, jnp.asarray(h), jnp.asarray(fe), cj, jbk, jrk,
                                           jc, **kw_j)
    dt_, st, tbk, trk = tv.voxcpm_main_step(tp, _t(h), _t(fe), ct, tbk, trk, tc, **kw_t)
    np.testing.assert_allclose(dt_.numpy(), _np(dj), **STEP_TOL)
    np.testing.assert_array_equal(st.numpy(), _np(sj))
    assert st.shape == (() if b == 1 else (b,)) and st.dtype == torch.int32
    if ctl == "valid_len":
        jbk, jrk, tbk, trk = jbk.rewind(9), jrk.rewind(9), tbk.rewind(9), trk.rewind(9)
    x = rng.standard_normal((b, 1, 32)).astype(np.float32)
    dj, sj, _, _ = jv.voxcpm_main_step(jp, jnp.asarray(x), jnp.asarray(x), jnp.int32(0),
                                       jbk, jrk, jc, kv_valid=kw_j.get("kv_valid"))
    dt_, st, _, _ = tv.voxcpm_main_step(tp, _t(x), _t(x), 0, tbk, trk, tc,
                                        kv_valid=kw_t.get("kv_valid"), fused="step")
    np.testing.assert_allclose(dt_.numpy(), _np(dj), **STEP_TOL)
    np.testing.assert_array_equal(st.numpy(), _np(sj))


# ---------------------------------------------------------------- the route gates

def _layers(n, w):
    return {"layers": [{"wqkv": w} for _ in range(n)]}


@pytest.mark.parametrize("case", ["b1", "b1_none", "cache_b2", "kv_valid", "b8", "b9",
                                  "plain", "prefill"])
def test_stack_routes_as_tts_tpu(models, case):
    """At VoxCPM's base geometry (1024, 16/2 heads x 64): "step" (the
    pipelines' default for None) takes kernel 12 at B = 1; a batch-2 cache
    under a batch-1 hidden (the guard tts_tpu lacks), a per-row key mask and
    8 rows degrade to kernel 11; 9 rows pass the kernels' limit and take the
    plain route; fused routes need S = 1."""
    cfg = tv.VoxCPMConfig().base
    params = _layers(cfg.num_layers, torch.zeros(1024, 1280))
    b = {"b8": 8, "b9": 9}.get(case, 1)
    cb = 2 if case == "cache_b2" else b
    kv = KVCache(torch.zeros(1, cb, 2, 128, 64), torch.zeros(1, cb, 2, 128, 64), 49)
    kv_valid = torch.ones(b, 128, dtype=torch.bool) if case == "kv_valid" else None
    fused = False if case == "plain" else "step"
    if case == "b1_none":           # the pipeline's default: None means "step"
        fused = VoxCPMPipeline(models["tp"], models["tc"], models["tvae"])._fused
    if case == "prefill":
        with pytest.raises(ValueError):
            tv.stack_routes(params, cfg, b, 3, kv, kv_valid, fused)
        return
    r = tv.stack_routes(params, cfg, b, 1, kv, kv_valid, fused)
    want = {"b1": (True, False), "b1_none": (True, False), "cache_b2": (False, True),
            "kv_valid": (False, True), "b8": (False, True), "b9": (False, False),
            "plain": (False, False)}[case]
    assert (r.step, r.qkv) == want


def test_main_step_keeps_the_step_route(models, monkeypatch):
    """voxcpm_main_step at S = 1 passes "step" on to both stacks: at B = 1
    every layer of the base and residual stacks calls kernel 12 (counted at
    its twin) and none kernel 11 (tts_tpu's `fused and s == 1` makes it
    True); at B = 2 every layer degrades to kernel 11."""
    from tts_tpu_torch.ops import decode_qkv, decode_step

    calls = {"attn": 0, "rope": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tv, "fused_qkv_attn", count("attn", decode_step.fused_qkv_attn))
    monkeypatch.setattr(tv, "fused_qkv_rope", count("rope", decode_qkv.fused_qkv_rope))
    cfg = models["tsc"]
    params = _conv(models["jsp"])
    for b, want in ((1, {"attn": 3, "rope": 0}), (2, {"attn": 0, "rope": 3})):
        calls.update(attn=0, rope=0)
        bk, rk = _caches(tv, cfg, b)
        x = torch.randn(b, 1, 128, generator=torch.Generator().manual_seed(6))
        tv.voxcpm_main_step(params, x, x, 0, bk.advance(4), rk.advance(4), cfg, fused="step")
        assert calls == want


def test_pipeline_rejects_unported_options(models):
    with pytest.raises(ValueError):
        VoxCPMPipeline(models["tp"], models["tc"], models["tvae"], quantize=4)
    with pytest.raises(ValueError):
        VoxCPMPipeline(models["tp"], models["tc"], models["tvae"], output_sample_rate=16000)


# ---------------------------------------------------------------- the pipelines

LATENTS = 5


def _jax_noise(seed: int, steps: int, bsz: int, cfg) -> torch.Tensor:
    """tts_tpu's CFM draws: a split of the running key, then a normal, a
    latent step (runtime/voxcpm.py's loop bodies)."""
    key, out = jax.random.key(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(_np(jax.random.normal(sub, (bsz, cfg.patch_size, cfg.vae.latent_dim))))
    return _t(np.stack(out))


def _pipes(models, v2: bool, latents: int = LATENTS):
    dec = dict(max_latents=latents, min_latents=latents, seed=11)
    jc = _cfg(jv, v2, noise=False) if v2 else models["jc"]
    tc = _cfg(tv, v2, noise=False) if v2 else models["tc"]
    jvae, tvae = (models["jvae2"], models["tvae2"]) if v2 else (models["jvae"], models["tvae"])
    return (JaxPipeline(models["jp"], jc, jvae, JaxDecodeConfig(**dec)),
            VoxCPMPipeline(models["tp"], tc, tvae, VoxCPMDecodeConfig(**dec)), tc)


def _same_audio(wt, wj):
    assert wt.dtype == np.int16 and wt.shape == wj.shape
    assert np.abs(wj.astype(np.int32)).max() > 1000
    assert np.abs(wt.astype(np.int32) - wj.astype(np.int32)).max() <= 1


def _audio(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 3000).astype(np.int16)


P_IDS = np.array([[3, 7]], np.int32)
T_IDS = np.array([[11, 13, 17]], np.int32)


@pytest.mark.parametrize("mode", ["ids", "ids_no_prompt", "voice_design", "reference_only",
                                  "continuation", "combined"])
def test_synthesize_matches_jax(models, mode):
    """synthesize_ids (v1.5, with and without prompt audio) and each
    synthesize_v2 mode (a v2 decoder at its native rate)."""
    v2 = mode not in ("ids", "ids_no_prompt")
    jpipe, tpipe, tc = _pipes(models, v2)
    noise = _jax_noise(11, LATENTS, 1, tc)
    if v2:
        kw = dict(target_ids=T_IDS, ref_audio=_audio(150, 1), prompt_audio=_audio(260, 2),
                  prompt_ids=P_IDS)
        kw = {k: v for k, v in kw.items()
              if k == "target_ids" or (k == "ref_audio" and mode in ("reference_only",
                                                                     "combined"))
              or (k != "ref_audio" and mode in ("continuation", "combined"))}
        wj, sj = jpipe.synthesize_v2(mode, **kw)
        wt, st = tpipe.synthesize_v2(mode, **kw, noise=noise)
    else:
        audio = _audio(200, 0) if mode == "ids" else None
        wj, sj = jpipe.synthesize_ids(P_IDS, T_IDS, audio)
        wt, st = tpipe.synthesize_ids(P_IDS, T_IDS, audio, noise=noise)
    assert st["latents"] == sj["latents"] == LATENTS
    assert st["sample_rate"] == sj["sample_rate"] == tc.output_sample_rate
    assert len(wt) == LATENTS * tc.samples_per_latent
    _same_audio(wt, wj)


def test_encode_prompt_matches_jax(models):
    jpipe, tpipe, _ = _pipes(models, v2=False)
    for fj, ft in zip(jpipe.encode_prompt(_audio(200, 0)), tpipe.encode_prompt(_audio(200, 0))):
        assert ft.shape == fj.shape
        np.testing.assert_allclose(ft.numpy(), _np(fj), **FN_TOL)


@pytest.mark.parametrize("v2", [False, True], ids=["ids", "v2"])
def test_synthesize_batch_matches_jax(models, v2):
    """Three requests of different lengths decoded together. ids: one with
    prompt audio, one whose single target id caps it at 18 latents while
    the others run 20 (its tail zeroed before the batched VAE decode); v2:
    mixed modes, 5 latents each."""
    latents = 5 if v2 else 20
    jpipe, tpipe, tc = _pipes(models, v2, latents)
    noise = _jax_noise(11, latents, 3, tc)
    if v2:
        reqs = [dict(mode="voice_design", target_ids=T_IDS),
                dict(mode="continuation", target_ids=T_IDS[:, :2], prompt_ids=P_IDS,
                     prompt_audio=_audio(260, 2)),
                dict(mode="reference_only", target_ids=np.array([[5, 9, 21, 30]], np.int32),
                     ref_audio=_audio(150, 1))]
        wj, sj = jpipe.synthesize_v2_batch(reqs)
        wt, st = tpipe.synthesize_v2_batch(reqs, noise=noise)
        counts = [latents] * 3
    else:
        reqs = [(P_IDS, T_IDS), (np.array([[4]], np.int32), np.array([[20]], np.int32)),
                (np.array([[9, 8, 7, 6]], np.int32), T_IDS)]
        audios = [_audio(200, 0), None, None]
        wj, sj = jpipe.synthesize_ids_batch(reqs, audios)
        wt, st = tpipe.synthesize_ids_batch(reqs, audios, noise=noise)
        counts = [20, 18, 20]
    assert st["latents"] == sj["latents"] == sum(counts)
    for a, b, n in zip(wt, wj, counts):
        assert len(a) == n * tc.samples_per_latent
        _same_audio(a, b)
