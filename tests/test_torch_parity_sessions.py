"""The port's session-mode parity drivers (tts_tpu_torch/parity/sessions.py)
against mock sessions built from tts_tpu's stage functions, on the CPU.

As tests/test_parity_sessions.py does for tts_tpu's drivers, each mock
carries a reference graph's input names and declared shapes and runs
tts_tpu's stage function behind it; the port's driver feeds it and runs the
port's stage functions on params converted from the same tts_tpu trees
(`params_from_jax`), fp32 on both sides. Every stage must agree within
1e-4 (fp32 sums in another order; an int16 waveform may move by one LSB,
3e-5), the stage names must come as tts_tpu's driver gives them for the
same mocks, and a corrupted mock must fail its own stage only. The port's
stand-in sessions (`parity/standins.py`), which chip_smoke.py drives on
the card, must carry the mocks' names and shapes and agree with the
drivers too. Configs: tts_tpu's tests' TINY ones, with codecs scaled
louder so the int16 comparison sees the waveform."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_parity_sessions import MockSession
from tts_tpu.kv.cache import KVCache
from tts_tpu.parity import sessions as JS
from tts_tpu_torch.parity import sessions as TS
from tts_tpu_torch.parity import standins as SI
from tts_tpu_torch.weights.convert import params_from_jax

TOL = 1e-4
FAMILIES = ("kani", "indextts", "qwen", "voxcpm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conv(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu", torch.float32)


def _port_cfg(cfg, *modules):
    """A tts_tpu config dataclass -> the port's class of the same name
    (nested configs too), over the fields the port's class has."""
    cls = next(getattr(m, type(cfg).__name__) for m in modules
               if hasattr(m, type(cfg).__name__))
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name in names}
    return cls(**{k: _port_cfg(v, *modules) if dataclasses.is_dataclass(v) else v
                  for k, v in kw.items()})


def _init(fn, cfg, seed):
    """tts_tpu's random init in one compiled program (op by op it compiles
    every op)."""
    return jax.jit(lambda k: fn(cfg, k))(jax.random.key(seed))


def _i16(wav):
    return (np.clip(np.asarray(wav), -1, 1) * 32767).astype(np.int16)


def _pads(n):
    return [np.zeros(1, np.float32)] * n


# ----------------------------------------------------------- the families
# each builder: (tts_tpu's params, configs), the port's, the mocks from
# tts_tpu's stage functions (one corrupted while corrupt[0] is set), the
# stage the corruption hits, and the port's stand-ins over the port's trees

def _kani(corrupt):
    from tests.test_kani import TINY, TINY_CODEC
    from tts_tpu.models import kani as jk
    from tts_tpu.models import nanocodec as jnc
    from tts_tpu_torch.models import kani as tk
    from tts_tpu_torch.models import nanocodec as tnc

    cfg, ccfg = TINY, TINY_CODEC
    params = _init(jk.init_params, cfg, 0)
    cparams = _init(jnc.init_params, ccfg, 1)
    cparams["post_conv"]["w"] = cparams["post_conv"]["w"] * 4000.0
    n_attn = sum(1 for t in cfg.layer_types if t == "attn")
    n_conv = len(cfg.layer_types) - n_attn
    kv_inputs = ([(f"in_key_{i}", (1, cfg.num_kv_heads, 1, cfg.head_dim, "hist"))
                  for i in range(n_attn)]
                 + [(f"in_value_{i}", (1, cfg.num_kv_heads, 1, "hist", cfg.head_dim))
                    for i in range(n_attn)]
                 + [(f"in_conv_{i}", (1, cfg.hidden_size, 2)) for i in range(n_conv)])

    # an fp32 cache, as the fp32 reference graph keeps (tts_tpu's test mock
    # takes init_state's bf16 default)
    step = jax.jit(lambda h: jk.kani_step(params, h, jk.init_state(cfg, kv_dtype=jnp.float32),
                                          cfg)[0])
    start = cfg.vocab_size - ccfg.num_groups * ccfg.codebook_size
    codec = jax.jit(lambda t: jnc.hifigan_decode(
        cparams, jnc.fsq_dequantize(jnc.tokens_to_codes(t, ccfg, start), ccfg), ccfg))

    def main_fn(feed):
        hidden = feed["hidden_states"]
        logits = np.asarray(step(jnp.asarray(hidden))) + (1.0 if corrupt[0] else 0.0)
        return _pads(len(kv_inputs)) + [logits, np.array([hidden.shape[1]], np.int64)]

    def codec_fn(feed):
        return [_i16(codec(jnp.asarray(feed["save_id"])))]

    mocks = {
        "embed": MockSession([("input_ids", (1, "T"))], lambda feed: [
            np.asarray(jk.embed_tokens(params, jnp.asarray(feed["input_ids"])))]),
        "main": MockSession(kv_inputs + [("hidden_states", (1, "T", cfg.hidden_size)),
                                         ("history_len", (1,)), ("ids_len", (1,))], main_fn),
        "codec": MockSession([("save_id", (1, "N")), ("num_decode", (1,))], codec_fn),
    }
    tcfg, tccfg = _port_cfg(cfg, tk), _port_cfg(ccfg, tnc)
    return dict(jax=(params, cfg, cparams, ccfg), port=(_conv(params), tcfg, _conv(cparams), tccfg),
                mocks=mocks, hit="kani/main_step",
                standins=lambda p: SI.kani_standins(p[0], p[1], p[2], p[3]))


def _indextts(corrupt):
    from tests.test_indextts import TINY as cfg
    from tts_tpu.models import indextts as ji
    from tts_tpu_torch.models import indextts as ti

    params = _init(ji.init_gpt_params, cfg, 0)

    def c_fn(feed):
        emb = np.asarray(ji.gpt_embed_mel(params, jnp.asarray(feed["gpt_ids"]),
                                          int(feed["kv_seq_len"][0])))
        return [emb + (1.0 if corrupt[0] else 0.0)]

    step = jax.jit(lambda h, pen: ji.gpt_step(
        params, h, KVCache.create(cfg.gpt_layers, 1, cfg.gpt_heads, cfg.max_seq_len,
                                  cfg.gpt_head_dim, jnp.float32), pen, cfg)[:2])

    def e_fn(feed):
        logits, last = step(jnp.asarray(feed["hidden_states"]),
                            jnp.asarray(feed["repeat_penality"]))
        max_id = np.argmax(np.asarray(logits), -1).astype(np.int64)
        return _pads(2 * cfg.gpt_layers) + [
            np.array([feed["hidden_states"].shape[1]], np.int64), np.asarray(last), max_id]

    kv_ins = ([(f"in_key_{i}", (cfg.gpt_heads, cfg.gpt_head_dim, "T"))
               for i in range(cfg.gpt_layers)]
              + [(f"in_value_{i}", (cfg.gpt_heads, "T", cfg.gpt_head_dim))
                 for i in range(cfg.gpt_layers)])
    mocks = {
        "b": MockSession([("text_ids", (1, "T"))], lambda feed: [
            np.asarray(ji.gpt_embed_text(params, jnp.asarray(feed["text_ids"])))]),
        "c": MockSession([("gpt_ids", (1, 1)), ("kv_seq_len", (1,))], c_fn),
        "e": MockSession(kv_ins + [("history_len", (1,)),
                                   ("repeat_penality", (1, cfg.num_mel_codes)),
                                   ("ids_len", (1,)), ("hidden_states", (1, "T", cfg.gpt_dim)),
                                   ("attention_mask_flag", (1,))], e_fn),
    }
    # a GPT-only tree (params_from_jax takes whole pipelines): leaf for leaf
    tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    return dict(jax=(params, cfg), port=(tree, _port_cfg(cfg, ti)), mocks=mocks,
                hit="indextts/step_embed", standins=lambda p: SI.indextts_standins(p[0], p[1]))


def _qwen(corrupt):
    from tests.test_qwen import TINY as cfg
    from tests.test_qwen import TINY_CODEC as ccfg
    from tts_tpu.models import qwen_codec as jqc
    from tts_tpu.models import qwen_tts as jq
    from tts_tpu_torch.models import qwen_codec as tqc
    from tts_tpu_torch.models import qwen_tts as tq

    params = {**_init(jq.init_talker_params, cfg, 0), **_init(jq.init_predictor_params, cfg, 1)}
    cparams = _init(jqc.init_decoder_params, ccfg, 2)
    cparams["dec_post"]["w"] = cparams["dec_post"]["w"] * 3e4
    tcfg, pcfg = cfg.talker, cfg.predictor

    @jax.jit
    def talker(hidden):
        kv = KVCache.create(tcfg.num_layers, 1, tcfg.num_kv_heads, tcfg.max_seq_len,
                            tcfg.head_dim, jnp.float32)
        s = hidden.shape[1]
        h, _ = jq.qwen3_stack_step(params["talker"], hidden, kv, tcfg,
                                   params["rope_cos"][:s], params["rope_sin"][:s])
        return h, jq.talker_logits(params, h, cfg)

    def main_fn(feed):
        h, logits = talker(jnp.asarray(feed["hidden_states"]))
        logits = np.asarray(logits) + (1.0 if corrupt[0] else 0.0)
        return _pads(2 * tcfg.num_layers) + [np.asarray(h), logits]

    stack = jax.jit(lambda x, kv, rc, rs: jq.qwen3_stack_step(params["predictor"], x, kv,
                                                              pcfg, rc, rs))

    state = {"kv": None}

    def predictor_fn(feed):
        hidden = jnp.asarray(feed["hidden_states"])
        proj = jnp.matmul(hidden, params["small_to_mtp"])
        if state["kv"] is None or hidden.shape[1] > 1:
            state["kv"] = KVCache.create(pcfg.num_layers, 1, pcfg.num_kv_heads,
                                         pcfg.max_seq_len, pcfg.head_dim, jnp.float32)
        kv = state["kv"]
        pos, s = int(kv.length), hidden.shape[1]
        h, state["kv"] = stack(proj, kv, params["pred_rope_cos"][pos:pos + s],
                               params["pred_rope_sin"][pos:pos + s])
        return _pads(2 * pcfg.num_layers) + [np.asarray(h)]

    decode = jax.jit(lambda c: jqc.codec_decode(cparams, c, ccfg))

    def decoder_fn(feed):
        codes = feed["codec_ids"].reshape(1, -1, ccfg.num_quantizers).astype(np.int32)
        return [_i16(decode(jnp.asarray(codes)))]

    kv_ins = ([(f"in_key_{i}", (1, pcfg.num_kv_heads, 1, pcfg.head_dim, "T"))
               for i in range(pcfg.num_layers)]
              + [(f"in_value_{i}", (1, pcfg.num_kv_heads, 1, "T", pcfg.head_dim))
                 for i in range(pcfg.num_layers)])
    mocks = {
        "main": MockSession(
            [(f"k_{i}", (1,)) for i in range(2 * tcfg.num_layers)]
            + [("hidden_states", (1, "T", tcfg.hidden_size)),
               ("rotary_cos", (1, "T", tcfg.head_dim)), ("rotary_sin", (1, "T", tcfg.head_dim)),
               ("attention_mask", (1, 1, "T", "T"))], main_fn),
        "predictor": MockSession(
            kv_ins + [("hidden_states", (1, "T", tcfg.hidden_size)),
                      ("rotary_cos", (1, "T", pcfg.head_dim)),
                      ("rotary_sin", (1, "T", pcfg.head_dim)),
                      ("attention_mask", (1, 1, "T", "T"))], predictor_fn),
        "decoder": MockSession([("codec_ids", (1, "N"))], decoder_fn),
    }
    for g in range(cfg.num_code_groups - 1):
        mocks[f"lm_head_{g}"] = MockSession(
            [("last_hidden_state", (1, pcfg.hidden_size))], lambda feed, g=g: [np.asarray(
                jnp.matmul(jnp.asarray(feed["last_hidden_state"]), params["lm_heads"][g]))])
        mocks[f"embed_d_{g}"] = MockSession([("input_ids", (1, 1))], lambda feed, g=g: [
            np.asarray(params["group_embeds"][g][int(feed["input_ids"].reshape(-1)[0])])[
                None, None]])
    return dict(jax=(params, cfg, cparams, ccfg),
                port=(_conv(params), _port_cfg(cfg, tq), _conv(cparams), _port_cfg(ccfg, tqc)),
                mocks=mocks, hit="qwen/talker_logits",
                standins=lambda p: SI.qwen_standins(p[0], p[1], p[2], p[3]))


def _voxcpm(corrupt):
    from tests.test_voxcpm import TINY as cfg
    from tts_tpu.models import voxcpm as jv
    from tts_tpu_torch.models import voxcpm as tv

    params = _init(jv.init_params, cfg, 0)
    vae = _init(jv.init_vae_params, cfg.vae, 1)
    vae["dec"]["post"]["w"] = vae["dec"]["post"]["w"] * 300.0
    n_kv = 2 * (cfg.base.num_layers + cfg.residual.num_layers)

    encode = jax.jit(lambda a: jv.feat_encoder_cond(params, a, cfg))

    def fe_fn(feed):
        fe, fc = encode(jnp.asarray(feed["audio_feat"]))
        return [np.asarray(fe), np.asarray(fc)]

    @jax.jit
    def dual_lm(hidden, feat_embed, text_len):
        b, r = cfg.base, cfg.residual
        base_kv = KVCache.create(b.num_layers, 1, b.num_kv_heads, b.max_seq_len, b.head_dim,
                                 jnp.float32)
        res_kv = KVCache.create(r.num_layers, 1, r.num_kv_heads, r.max_seq_len, r.head_dim,
                                jnp.float32)
        return jv.voxcpm_main_step(params, hidden, feat_embed, text_len, base_kv, res_kv,
                                   cfg)[:2]

    cfm = jax.jit(lambda n, d, c: jv.cfm_feat_decoder(params, n, d, c, cfg))
    vae_fn = jax.jit(lambda z: jv.vae_decode(vae["dec"], z, cfg.vae))

    def main_fn(feed):
        dit, stop = dual_lm(jnp.asarray(feed["hidden_states"]), jnp.asarray(feed["feat_embed"]),
                            int(feed["concat_text_len"][0]))
        return _pads(n_kv) + [np.asarray(dit), np.asarray(stop, np.int64).reshape(1),
                              np.zeros((1, cfg.patch_size, cfg.vae.latent_dim), np.float32)]

    def fd_fn(feed):
        out = cfm(jnp.asarray(feed["random"]), jnp.asarray(feed["dit_hidden"]),
                  jnp.asarray(feed["feat_cond"]))
        return [np.asarray(out) + (1.0 if corrupt[0] else 0.0)]

    b = cfg.base
    mocks = {
        "feat_encoder": MockSession(
            [("audio_feat", ("T", cfg.patch_size, cfg.vae.latent_dim))], fe_fn),
        "main": MockSession(
            [(f"kv_{i}", (1,)) for i in range(n_kv)]
            + [("feat_embed", (1, "T", b.hidden_size)), ("concat_text_len", (1,)),
               ("hidden_states", (1, "T", b.hidden_size)), ("rotary_cos", (1, "T", b.head_dim)),
               ("rotary_sin", (1, "T", b.head_dim)), ("attention_mask", (1, 1, "T", "T"))],
            main_fn),
        "feat_decoder": MockSession(
            [("random", (1, cfg.patch_size, cfg.vae.latent_dim)),
             ("dit_hidden", (1, 1, cfg.estimator.hidden_size)),
             ("feat_cond", (2, cfg.patch_size, cfg.estimator.hidden_size)),
             ("cfg_value", (1,)), ("cfg_value_minus", (1,))], fd_fn),
        "vae_decoder": MockSession(
            [("latent_pred", (1, "T", cfg.vae.latent_dim))], lambda feed: [
                _i16(vae_fn(jnp.asarray(feed["latent_pred"])))]),
    }
    return dict(jax=(params, cfg, vae["dec"]),
                port=(_conv(params), _port_cfg(cfg, tv), _conv(vae)["dec"]),
                mocks=mocks, hit="voxcpm/feat_decoder",
                standins=lambda p: SI.voxcpm_standins(p[0], p[1], p[2]))


BUILD = {"kani": _kani, "indextts": _indextts, "qwen": _qwen, "voxcpm": _voxcpm}


@functools.lru_cache(maxsize=None)
def _built(fam):
    """A family's build, made once (its jitted mocks compile once); the
    corruption is a flag the mocks read at each call."""
    flag = [False]
    return {**BUILD[fam](flag), "corrupt": flag}
DRIVE = {"kani": "kani_session_stages", "indextts": "indextts_session_stages",
         "qwen": "qwen_session_stages", "voxcpm": "voxcpm_session_stages"}
# the standins' graph file -> the driver's key (run_reference's globs)
KEYS = {"kani": {"KaniTTS_Embed.onnx": "embed", "KaniTTS_Main.onnx": "main",
                 "KaniTTS_Codec.onnx": "codec"},
        "indextts": {"IndexTTS_B.onnx": "b", "IndexTTS_C.onnx": "c", "IndexTTS_E.onnx": "e"},
        "voxcpm": {"VoxCPM_Feat_Encoder.onnx": "feat_encoder", "VoxCPM_Main.onnx": "main",
                   "VoxCPM_Feat_Decoder.onnx": "feat_decoder",
                   "VoxCPM_VAE_Decoder.onnx": "vae_decoder"}}


def _drive(pkg, fam, sessions, trees):
    fn = getattr(pkg, DRIVE[fam])
    if fam == "voxcpm":
        return fn(sessions, trees[0], trees[1], vae_params=trees[2])
    return fn(sessions, *trees)


def _keyed(fam, table):
    """A standins table -> the driver's session keys."""
    if fam != "qwen":
        return {KEYS[fam][f]: s for f, s in table.items()}
    out = {}
    for f, s in table.items():
        stem = f[:-len(".onnx")]
        if "LmHead_" in stem:
            out[f"lm_head_{stem.rsplit('_', 1)[1]}"] = s
        elif "Embed_D_" in stem:
            out[f"embed_d_{stem.rsplit('_', 1)[1]}"] = s
        else:
            out[{"Main": "main", "Predictor": "predictor",
                 "Decoder": "decoder"}[stem.rsplit("_", 1)[1]]] = s
    return out


@pytest.mark.parametrize("fam", FAMILIES)
def test_driver_matches_tts_tpu_mocks(fam):
    b = _built(fam)
    diffs = _drive(TS, fam, b["mocks"], b["port"])
    want = _drive(JS, fam, b["mocks"], b["jax"])
    assert [d.stage for d in diffs] == [d.stage for d in want] and len(diffs) >= 3
    for d in diffs:
        assert d.max_abs <= TOL and d.ok, d.line()


@pytest.mark.parametrize("fam", FAMILIES)
def test_corrupted_mock_fails_its_stage_only(fam):
    b = _built(fam)
    b["corrupt"][0] = True
    try:
        diffs = {d.stage: d for d in _drive(TS, fam, b["mocks"], b["port"])}
    finally:
        b["corrupt"][0] = False
    assert diffs[b["hit"]].max_abs >= 0.5 and not diffs[b["hit"]].ok
    for stage, d in diffs.items():
        if stage != b["hit"]:
            assert d.max_abs <= TOL, d.line()


@pytest.mark.parametrize("fam", FAMILIES)
def test_standins_carry_the_mocks_contract(fam):
    """The stand-ins the card runs: the mocks' names and declared shapes,
    and the drivers within 1e-4 of them (the port on both sides)."""
    b = _built(fam)
    table = _keyed(fam, b["standins"](b["port"]))
    assert set(table) == set(b["mocks"])
    for key, mock in b["mocks"].items():
        assert ([(i.name, tuple(i.shape)) for i in table[key].get_inputs()]
                == [(i.name, tuple(i.shape)) for i in mock.get_inputs()]), key
    diffs = _drive(TS, fam, table, b["port"])
    assert [d.stage for d in diffs] == [d.stage for d in _drive(TS, fam, b["mocks"], b["port"])]
    for d in diffs:
        assert d.max_abs <= TOL, d.line()


def test_stage_diff_line_and_threshold():
    assert TS.StageDiff("a", 1e-2).ok and not TS.StageDiff("a", 1.01e-2).ok
    assert TS.StageDiff("kani/embed", 0.5).line().split()[1] == "FAIL"
    d = TS._diff("x", torch.ones(3), np.ones(4))
    assert d.max_abs == float("inf") and "shape" in d.detail
    np.testing.assert_array_equal(TS._additive_causal_mask(2, 3),
                                  JS._additive_causal_mask(2, 3))
