"""The port's F5 slice against tts_tpu on the CPU, fp32 on both sides, at a
small config: tts_tpu's init_params -> params_from_jax, then text
embedding, input embedding, the DiT pass, the vocoder and the whole
synthesize, with the noise tts_tpu's pipeline draws handed to the port.

The port's kernel wrappers run their plain twins here; tts_tpu runs its
CPU path (plain softmax attention, im2col conv, unfused MLP). Both compute
the same fp32 math in another summation order, so component outputs agree
to fp32 rounding (tolerances below, each with its reason)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.models import f5 as jf5
from tts_tpu.models import vocos as jvo
from tts_tpu.runtime.f5 import F5Pipeline as JaxPipeline
from tts_tpu_torch.models import f5 as tf5
from tts_tpu_torch.models import vocos as tvo
from tts_tpu_torch.runtime.f5 import F5Pipeline
from tts_tpu_torch.weights.convert import params_from_jax

SMALL = dict(dim=128, depth=2, heads=2, head_dim=64, text_dim=64, conv_layers=1,
             nfe_steps=4, max_signal_len=512, vocab_size=40)
VOCOS = dict(dim=32, intermediate_dim=64, num_layers=2)
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz,.")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jc, tc = jf5.F5Config(**SMALL), tf5.F5Config(**SMALL)
    jvc, tvc = jvo.VocosConfig(**VOCOS), tvo.VocosConfig(**VOCOS)
    jp = jf5.init_params(jc, jax.random.key(0))
    jvp = jvo.init_params(jvc, jax.random.key(1))
    # a louder vocoder (magnitude bias e^3) so the int16 comparison of the
    # whole slice sees a good part of the sample range
    jvp["head"]["b"] = jvp["head"]["b"].at[:jvc.n_fft // 2 + 1].set(3.0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    tvp = params_from_jax(jax.tree.map(np.asarray, jvp), "cpu", torch.float32)
    return dict(jc=jc, tc=tc, jvc=jvc, tvc=tvc, jp=jp, jvp=jvp, tp=tp, tvp=tvp)


def _np(x):
    return np.asarray(x)


def test_params_from_jax_is_key_for_key(models):
    flat_j = jax.tree_util.tree_leaves_with_path(models["jp"])
    flat_t = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
              for path, _ in flat_j}
    seen = set()

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (str(i),))
        else:
            seen.add(path)
    walk(models["tp"])
    assert seen == flat_t
    np.testing.assert_array_equal(models["tp"]["blocks"][1]["attn"]["wqkv"].numpy(),
                                  _np(models["jp"]["blocks"][1]["attn"]["wqkv"]))
    assert models["tp"]["delta_t"].dtype == torch.float32
    bf = params_from_jax(jax.tree.map(np.asarray, models["jp"]), "cpu", torch.bfloat16)
    assert bf["delta_t"].dtype == torch.float32
    assert bf["ada_table"].dtype == torch.bfloat16


@pytest.mark.parametrize("fault", ["unknown", "missing", "shape"])
def test_params_from_jax_rejects_bad_trees(models, fault):
    tree = jax.tree.map(np.asarray, models["jvp"])
    if fault == "unknown":
        tree["blocks"][0]["extra"] = np.zeros(3, np.float32)
    elif fault == "missing":
        del tree["final_norm"]
    else:   # pw2 that no longer fits pw1's hidden width
        tree["blocks"][1]["pw2"]["w"] = np.zeros((65, 32), np.float32)
    with pytest.raises((KeyError, ValueError)):
        params_from_jax(tree, "cpu", torch.float32)


def test_init_params_has_tts_tpu_structure(models):
    ours = tf5.init_params(models["tc"], torch.Generator().manual_seed(0))
    conv = params_from_jax(jax.tree.map(np.asarray, models["jp"]), "cpu", torch.float32)
    shapes = jax.tree.map(lambda t: tuple(t.shape), ours)
    assert shapes == jax.tree.map(lambda t: tuple(t.shape), conv)
    np.testing.assert_array_equal(ours["time_table"].numpy(), _np(models["jp"]["time_table"]))
    np.testing.assert_array_equal(ours["delta_t"].numpy(), _np(models["jp"]["delta_t"]))
    vours = tvo.init_params(models["tvc"], torch.Generator().manual_seed(1))
    assert jax.tree.map(lambda t: tuple(t.shape), vours) == \
        jax.tree.map(lambda t: tuple(t.shape), models["tvp"])


def test_model_cast_keeps_delta_t_fp32(models):
    m = tf5.F5Model(models["tc"], models["tp"]).to(torch.bfloat16)
    p = m.params
    assert p["delta_t"].dtype == torch.float32
    assert p["blocks"][0]["ff1"]["w"].dtype == torch.bfloat16
    torch.testing.assert_close(p["delta_t"], models["tp"]["delta_t"], atol=0, rtol=0)
    v = tvo.VocosModel(models["tvc"], models["tvp"]).to(torch.bfloat16)
    assert v.params["head"]["w"].dtype == torch.bfloat16


def test_text_embedding_matches_jax(models):
    ids = np.array([[3, 7, 0, 12, 5, 1, 9]], np.int32)
    ids = np.pad(ids, ((0, 0), (0, 64 - ids.shape[1])), constant_values=-1)
    tj, dj = jf5.text_embedding(models["jp"], jnp.asarray(ids), 256, models["jc"])
    tt, dt = tf5.text_embedding(models["tp"], torch.from_numpy(ids), 256, models["tc"])
    # fp32 LN, GELU and GRN over 256 frames: ~1e-6 relative to O(1) values
    np.testing.assert_allclose(tt.numpy(), _np(tj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dt.numpy(), _np(dj), atol=1e-5, rtol=1e-5)


def test_input_embedding_matches_jax(models):
    rng = np.random.default_rng(3)
    cfg = models["jc"]
    x = rng.standard_normal((2, 256, cfg.n_mels)).astype(np.float32)
    cond = rng.standard_normal((2, 256, cfg.n_mels + cfg.text_dim)).astype(np.float32)
    ref = jf5.input_embedding(models["jp"], jnp.asarray(x), jnp.asarray(cond))
    out = tf5.input_embedding(models["tp"], torch.from_numpy(x), torch.from_numpy(cond))
    # 264-deep projection then two 248-deep convs in fp32
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_len,step", [(256, 0), (200, 2)])
def test_dit_forward_matches_jax(models, kv_len, step):
    rng = np.random.default_rng(4)
    cfg = models["jc"]
    noise = rng.standard_normal((1, 256, cfg.n_mels)).astype(np.float32)
    cond = rng.standard_normal((1, 256, cfg.n_mels + cfg.text_dim)).astype(np.float32)
    drop = rng.standard_normal((1, 256, cfg.n_mels + cfg.text_dim)).astype(np.float32)
    jp = models["jp"]
    pj, pj1 = jf5.dit_forward(jp, jnp.asarray(noise), jnp.asarray(cond), jnp.asarray(drop),
                              jp["time_table"][step], jp["rope_cos"][:256],
                              jp["rope_sin"][:256], cfg, kv_len=jnp.int32(kv_len),
                              step_idx=step)
    tp = models["tp"]
    pt, pt1 = tf5.dit_forward(tp, torch.from_numpy(noise), torch.from_numpy(cond),
                              torch.from_numpy(drop), tp["rope_cos"][:256],
                              tp["rope_sin"][:256], models["tc"], kv_len=kv_len,
                              step_idx=step)
    # two blocks of fp32 attention (the twin's exp2 softmax against a
    # max-subtracted one: equal up to fp32 rounding) and MLP
    np.testing.assert_allclose(pt.numpy(), _np(pj), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(pt1.numpy(), _np(pj1), atol=2e-5, rtol=1e-5)


def test_vocos_decode_matches_jax(models):
    mel = np.random.default_rng(5).standard_normal((1, 48, 100)).astype(np.float32)
    # log-magnitude biases up to 6, past the exp clamp at 1e2
    jvp = dict(models["jvp"])
    jvp["head"] = {"w": jvp["head"]["w"], "b": jvp["head"]["b"].at[:513].set(
        jnp.linspace(0.0, 6.0, 513))}
    tvp = params_from_jax(jax.tree.map(np.asarray, jvp), "cpu", torch.float32)
    ref = jvo.vocos_decode(jvp, jnp.asarray(mel), models["jvc"])
    out = tvo.vocos_decode(tvp, torch.from_numpy(mel), models["tvc"])
    assert out.shape == (1, 47 * 256)
    # fp32 ISTFT of magnitudes up to 1e2: waveform values of a few units
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("gen_text", [" some words here", " and a bit more text, again."])
def test_synthesize_matches_jax(models, gen_text):
    rng = np.random.default_rng(6)
    audio = (rng.standard_normal(12000) * 3000).astype(np.int16)
    ref_text = "hello there."
    jpipe = JaxPipeline(models["jp"], models["jc"], VOCAB, models["jvp"], models["jvc"])
    wav_j, _ = jpipe.synthesize(audio, ref_text, gen_text, seed=7)
    pipe = F5Pipeline(tf5.F5Model(models["tc"], models["tp"]), VOCAB,
                      tvo.VocosModel(models["tvc"], models["tvp"]))
    frames = pipe._prepare(audio, ref_text, gen_text)[4][2]
    noise = np.asarray(jax.random.normal(jax.random.key(7),
                                         (1, frames, models["jc"].n_mels)))
    wav_t, stats = pipe.synthesize(audio, ref_text, gen_text, noise=noise)
    assert wav_t.dtype == np.int16 and wav_t.shape == wav_j.shape
    assert np.abs(wav_j.astype(np.int32)).max() > 3000
    # int16 truncation of float waveforms that agree to ~1e-6: a sample on
    # an integer boundary may land one LSB apart; 2 LSB leaves room for that
    assert np.abs(wav_t.astype(np.int32) - wav_j.astype(np.int32)).max() <= 2
    assert np.isfinite(stats.peak) and stats.audio_s == len(wav_t) / 24000


def test_synthesize_draws_seeded_noise(models):
    pipe = F5Pipeline(tf5.F5Model(models["tc"], models["tp"]), VOCAB,
                      tvo.VocosModel(models["tvc"], models["tvp"]))
    audio = (np.random.default_rng(8).standard_normal(8000) * 3000).astype(np.int16)
    a, _ = pipe.synthesize(audio, "abc def.", " ghi", seed=3)
    b, _ = pipe.synthesize(audio, "abc def.", " ghi", seed=3)
    c, _ = pipe.synthesize(audio, "abc def.", " ghi", seed=4)
    np.testing.assert_array_equal(a, b)
    assert len(a) > 0 and not np.array_equal(a, c)
    with pytest.raises(ValueError):
        pipe.synthesize(audio, "abc def.", " ghi", noise=np.zeros((1, 10, 100)))


@pytest.mark.parametrize("text", [
    "Some call me nature, others call me mother nature.word word",
    "Hello.World e-mail 3.5% of x_y; a:b 'q' \"z\"  two  spaces\tTab\r\nline",
    "abc.def..ghi 12.34.56 v1.2 a%b% x--y _under_ 100% 1.5e3",
    "I'm here!? (yes) [no] a/b a=b a*b `c` a|b <x> ~",
    "C++ and C# at AT&T",
    "",
])
def test_ascii_frontend_matches_jieba(text):
    from tts_tpu.frontend.f5_text import convert_char_to_pinyin as ref
    from tts_tpu_torch.frontend.f5_text import convert_char_to_pinyin

    assert convert_char_to_pinyin([text]) == ref([text])
