"""The port's Qwen3-TTS voice clone against tts_tpu on the CPU, fp32 on both
sides: the Mimi prompt encoder (mimi_encode, rvq_encode) at
tests/test_qwen_encoder_loader.py's TINY, its loader on that file's
synthetic state dict (also from bf16 and fp16 copies, and from a
.safetensors file), encode_reference with the Qwen ECAPA variant,
build_prefill_voice_clone and a voice-clone request through
QwenTTSPipeline (tests/test_torch_qwen.py's models).

Tolerances: mimi_encode within 1e-5 of max |ref| (fp32 convs and GEMMs that
sum in another order); the codes equal; the folded trees bit for bit; the
speaker embedding atol/rtol 1e-5; the prefill within 1e-6; the request's
int16 audio within 1 LSB (float waveforms that agree to ~1e-6 can truncate
to neighbouring integers)."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_qwen_encoder_loader import TINY as J_TINY
from tests.test_qwen_encoder_loader import _build_state_dict
from tests.test_torch_qwen import _pipes, models  # noqa: F401  (the fixture)
from tests.test_torch_weights import assert_same_host, ecapa_state_dict
from tts_tpu.models import qwen_encoder as jqe
from tts_tpu.weights import qwen_loader as jql
from tts_tpu_torch.models import qwen_encoder as tqe
from tts_tpu_torch.weights import qwen_loader as tql
from tts_tpu_torch.weights.convert import params_from_jax
from tts_tpu_torch.weights.loaders import place

TINY = tqe.MimiEncoderConfig(**dataclasses.asdict(J_TINY))
# the full Qwen3-TTS strides (1,920 samples a frame: 10 frames a 19,200-
# sample bucket) at small widths, with the test pipeline's 6 groups of 32 codes
CLONE = dict(num_filters=4, upsampling_ratios=(8, 6, 5, 4), hidden_size=16, num_heads=2,
             head_dim=8, ffn_dim=32, num_layers=2, max_seq_len=256, rvq_dim=8,
             codebook_size=32, num_quantizers=6)
EMB_TOL = 1e-5
SPK_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _audio(n, seed, scale=0.1):
    return (np.random.default_rng(seed).standard_normal((1, n)) * scale).astype(np.float32)


# ---------------------------------------------------------------- the encoder

@pytest.mark.parametrize("frames", [8, 13])
def test_mimi_encode_and_rvq_match_jax(frames):
    """The loaded TINY encoder over `frames` frames of audio: embeddings,
    and the codes of tts_tpu's embeddings and of the port's."""
    sd = _build_state_dict(J_TINY, np.random.default_rng(0))
    jp = jql.mimi_encoder_from_state_dict(sd, J_TINY)
    tp = place(tql.mimi_encoder_from_state_dict(sd, TINY), "cpu", torch.float32)
    stride = int(np.prod(J_TINY.upsampling_ratios)) * J_TINY.downsample_stride
    audio = _audio(frames * stride + 5, frames)
    ref = jax.jit(lambda p, a: jqe.mimi_encode(p, a, J_TINY))(jp, jnp.asarray(audio))
    emb = tqe.mimi_encode(tp, _t(audio), TINY)
    assert emb.shape == ref.shape
    np.testing.assert_allclose(emb.numpy(), _np(ref), rtol=0,
                               atol=EMB_TOL * float(jnp.abs(ref).max()))
    jcodes = jax.jit(lambda p, e: jqe.rvq_encode(p, e, J_TINY))(jp, ref)
    for e in (_t(_np(ref)), emb):
        codes = tqe.rvq_encode(tp, e, TINY)
        assert codes.dtype == torch.int32 and codes.shape == jcodes.shape
        np.testing.assert_array_equal(codes.numpy(), _np(jcodes))


def test_nearest_code_keeps_the_first_tie():
    """argmin(||y||^2 - 2<x, y>) over a codebook with a repeated row: the
    first of the two, as jnp.argmin."""
    rng = np.random.default_rng(3)
    cb = rng.standard_normal((16, 8)).astype(np.float32)
    cb[9] = cb[4]
    x = np.stack([cb[4], cb[9] + 1e-3, cb[2]])[None].astype(np.float32)
    got = tqe._nearest_code(_t(x), _t(cb))
    np.testing.assert_array_equal(got.numpy(), _np(jqe._nearest_code(jnp.asarray(x),
                                                                      jnp.asarray(cb))))
    assert got[0, 0] == 4


def test_init_encoder_params_has_tts_tpu_structure():
    """The port's random init against tts_tpu's: the same keys and shapes,
    the RoPE tables fp32 in a bf16 tree, and params_from_jax takes it."""
    jp = jqe.init_encoder_params(J_TINY, jax.random.key(0))
    tp = tqe.init_encoder_params(TINY, torch.Generator().manual_seed(0), torch.bfloat16)
    js = jax.tree.map(lambda a: tuple(a.shape), jp)
    ts = jax.tree.map(lambda a: tuple(a.shape), tp)
    assert js == ts
    assert tp["rope_cos"].dtype == torch.float32
    assert tp["layers"][0]["wqkv"].dtype == torch.bfloat16
    conv = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.bfloat16)
    assert conv["rope_sin"].dtype == torch.float32
    assert conv["ac_codebooks"].dtype == torch.bfloat16
    out = tqe.mimi_encode(conv, _t(_audio(16 * 8, 1)).bfloat16(), TINY)
    assert out.shape == (1, 8, TINY.hidden_size) and torch.isfinite(out.float()).all()


# ---------------------------------------------------------------- the loader

def test_loader_folds_match_jax():
    """Every leaf of the port's fold against tts_tpu's, bit for bit; the
    converted tts_tpu tree equals the placed port tree; a weight-normed conv
    (either spelling) folds alike."""
    rng = np.random.default_rng(5)
    sd = _build_state_dict(J_TINY, rng)
    pre = "speech_tokenizer.model.encoder.encoder.layers.0.conv"
    w = sd.pop(f"{pre}.weight")
    sd[f"{pre}.weight_g"] = np.linalg.norm(w.reshape(w.shape[0], -1), axis=1
                                           ).reshape(-1, 1, 1).astype(np.float32) * 1.3
    sd[f"{pre}.weight_v"] = w
    post = "speech_tokenizer.model.encoder.downsample.conv"
    dw = sd.pop(f"{post}.weight")
    sd[f"{post}.parametrizations.weight.original0"] = np.full((dw.shape[0], 1, 1), 0.7,
                                                              np.float32)
    sd[f"{post}.parametrizations.weight.original1"] = dw
    got = tql.mimi_encoder_from_state_dict(sd, TINY)
    ref = jql.mimi_encoder_from_state_dict(sd, J_TINY)
    assert_same_host(got, ref)
    placed = place(got, "cpu", torch.float32)
    conv = params_from_jax(jax.tree.map(np.asarray, ref), "cpu", torch.float32)
    for (k, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(placed),
                              jax.tree_util.tree_leaves_with_path(conv)):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
def test_loader_upcasts_half_checkpoints(dt, tmp_path):
    """A bf16 or fp16 copy of the state dict, written as .safetensors and
    read by load_qwen_encoder at fp32, folds as tts_tpu folds the same
    values upcast to fp32."""
    from tts_tpu_torch.weights import write_safetensors

    sd = _build_state_dict(J_TINY, np.random.default_rng(6))
    half = {k: torch.from_numpy(v).to(dt) for k, v in sd.items()}
    write_safetensors(str(tmp_path / "speech_tokenizer.safetensors"), half)
    params, cfg = tql.load_qwen_encoder(str(tmp_path), TINY, device="cpu")
    assert cfg == TINY
    up = {k: v.float().numpy() for k, v in half.items()}
    ref = params_from_jax(jax.tree.map(np.asarray, jql.mimi_encoder_from_state_dict(
        up, J_TINY)), "cpu", torch.float32)
    for (k, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                              jax.tree_util.tree_leaves_with_path(ref)):
        assert a.dtype == torch.float32 and torch.equal(a, b), k


def test_loader_defaults_to_the_card(tmp_path):
    from tts_tpu_torch.weights import write_safetensors

    sd = _build_state_dict(J_TINY, np.random.default_rng(7))
    write_safetensors(str(tmp_path / "model.safetensors"),
                      {k: torch.from_numpy(v) for k, v in sd.items()})
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    with pytest.raises((RuntimeError, AssertionError)):
        tql.load_qwen_encoder(str(tmp_path), TINY)


# ---------------------------------------------------------------- the clone

def _encoders():
    """The CLONE Mimi encoder and a Qwen-variant ECAPA (128 mel bands in,
    the test talker's 128 wide out), tts_tpu's and the port's."""
    jcfg = jqe.MimiEncoderConfig(**CLONE)
    tcfg = tqe.MimiEncoderConfig(**CLONE)
    jenc = jax.jit(lambda k: jqe.init_encoder_params(jcfg, k))(jax.random.key(8))
    tenc = params_from_jax(jax.tree.map(np.asarray, jenc), "cpu", torch.float32)
    sd = ecapa_state_dict("speaker_encoder", 16, 128, 4, 8, 8, 128,
                          np.random.default_rng(9), bn=False)
    jspk = jql.qwen_speaker_from_state_dict(sd, res2net_scale=4)
    tspk = place(tql.qwen_speaker_from_state_dict(sd, res2net_scale=4), "cpu",
                 torch.float32, kind="ecapa")
    return jcfg, tcfg, jenc, tenc, jspk, tspk, SimpleNamespace(res2net_scale=4)


@pytest.fixture(scope="module")
def encoders():
    return _encoders()


@pytest.mark.parametrize("kind,n", [("int16", 20000), ("float", 7000), ("float", 40001)])
def test_encode_reference_matches_jax(models, encoders, kind, n):  # noqa: F811
    """int16 and float input at lengths off the 19,200-sample bucket: the
    codes of the whole bucket equal, the speaker embedding within 1e-5."""
    jcfg, tcfg, jenc, tenc, jspk, tspk, scfg = encoders
    jpipe, tpipe = _pipes(models, max_frames=4)
    rng = np.random.default_rng(n)
    audio = (rng.standard_normal(n) * (3000 if kind == "int16" else 0.1))
    audio = audio.astype(np.int16 if kind == "int16" else np.float32)
    jcodes, jspk_out = jpipe.encode_reference(audio, jenc, jcfg, jspk, scfg)
    codes, spk = tpipe.encode_reference(audio, tenc, tcfg, tspk, scfg)
    bucket = -(-n // 19200) * 19200
    assert codes.shape == jcodes.shape == (bucket // 1920, 6)
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    assert spk.shape == jspk_out.shape == (1, 1, 128)
    np.testing.assert_allclose(spk.numpy(), jspk_out, **SPK_TOL)
    assert tpipe.encode_reference(audio, tenc, tcfg)[1] is None


def _clone_inputs(encoders, models, n_audio=30000):  # noqa: F811
    jcfg, tcfg, jenc, tenc, jspk, tspk, scfg = encoders
    jpipe, _ = _pipes(models, max_frames=4)
    audio = (np.random.default_rng(11).standard_normal(n_audio) * 3000).astype(np.int16)
    return jpipe.encode_reference(audio, jenc, jcfg, jspk, scfg)


@pytest.mark.parametrize("text_len", [3, 40], ids=["text_shorter", "text_longer"])
def test_build_prefill_voice_clone_matches_jax(models, encoders, text_len):  # noqa: F811
    """Both branches: the text run shorter than the codec run (padded with
    tts_pad, nothing trails but the pad) and longer (the rest trails)."""
    codes, spk = _clone_inputs(encoders, models)
    jpipe, tpipe = _pipes(models, max_frames=4)
    text = np.arange(text_len, dtype=np.int32)[None] % 90 + 3
    ref_text = np.array([[5, 6, 7]], np.int32)
    pj, trj = jpipe.build_prefill_voice_clone(text, ref_text, 3, codes, spk)
    pt, trt = tpipe.build_prefill_voice_clone(text, ref_text, 3, _t(codes), _t(spk))
    assert pt.dtype == trt.dtype == torch.float32
    assert pt.shape == pj.shape and trt.shape == trj.shape
    assert (trt.shape[1] == 1) == (text_len + 4 < codes.shape[0] + 1)
    np.testing.assert_allclose(pt.numpy(), pj, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(trt.numpy(), trj, atol=1e-6, rtol=1e-6)


def test_voice_clone_request_matches_jax(models, encoders):  # noqa: F811
    """encode_reference -> build_prefill_voice_clone -> synthesize_from_prefill
    through both packages: the same frames, the audio within 1 LSB."""
    jcfg, tcfg, jenc, tenc, jspk, tspk, scfg = encoders
    decode = dict(max_frames=6, repeat_penalty=0.8, penalty_range=3)
    jpipe, tpipe = _pipes(models, **decode)
    audio = (np.random.default_rng(12).standard_normal(25000) * 3000).astype(np.int16)
    text, ref_text = np.array([[5, 9, 13, 2]], np.int32), np.array([[8, 4]], np.int32)
    jc, js = jpipe.encode_reference(audio, jenc, jcfg, jspk, scfg)
    tc, ts = tpipe.encode_reference(audio, tenc, tcfg, tspk, scfg)
    wj, sj = jpipe.synthesize_from_prefill(*jpipe.build_prefill_voice_clone(
        text, ref_text, 3, jc, js))
    wt, st = tpipe.synthesize_from_prefill(*tpipe.build_prefill_voice_clone(
        text, ref_text, 3, tc, ts))
    assert st["frames"] == sj["frames"] == 6
    assert wt.dtype == np.int16 and wt.shape == wj.shape
    assert np.abs(wj.astype(np.int32)).max() > 1000
    assert np.abs(wt.astype(np.int32) - wj.astype(np.int32)).max() <= 1
