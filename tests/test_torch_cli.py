"""The port's command line (tts_tpu_torch/cli.py) against tts_tpu's, on the
CPU (`--device cpu`, fp32 weights, as tts_tpu's CLI takes them off a TPU).

Each command with --ckpt runs on a directory of synthetic upstream-key
checkpoint files from tests/test_torch_weights.py's writers, its tokenizer
a `tokenizers`-built fixture (a hand-built bpe.model for IndexTTS). The
loaders' default configs are set to the writers' small configs in both
packages (`small_defaults`): the command path is the same, its widths cut.

- kani, qwen and indextts decode greedily: their WAVs from tts_tpu.cli.main
  and tts_tpu_torch.cli.main match within the LSB bounds of the existing
  synthesize_ids comparisons (2 for Kani and Qwen, 4 for IndexTTS).
- f5 and voxcpm draw noise (jax.random and torch generators differ): the
  arguments each CLI hands its pipeline (captured by monkeypatching) match,
  and the port's WAV equals its own pipeline's direct call at the same seed.
- A --save-npz / --npz round trip (qwen): the port's bundle gives the same
  WAV bit for bit in the port, and within 2 LSB in tts_tpu's CLI.
- Without --ckpt every command builds tts_tpu's small configs from seeded
  generators: the configs and ids each CLI hands its pipeline match, and the
  port's WAV equals its pipeline's direct call.
- The device rule: --device cuda without a card raises; quantize 4 runs in
  every runtime; the serve command's server builds on the CPU."""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import tts_tpu.cli as jcli
import tts_tpu_torch.cli as tcli
from tests.test_spm import BOS, EOS, UNK, WS, build_model
from tests.test_torch_weights import (F5_SMALL, NEMO_YAML, VOCOS_SMALL, VOX_CFG, _jax_tree,
                                      assert_same_tree, nanocodec_state_dict,
                                      qwen_talker_state_dict, voxcpm_state_dict, write_f5,
                                      write_indextts_dir, write_kani_dir, write_nemo,
                                      write_vocos)
from tts_tpu_torch.audio.wav import read_wav, write_wav
from tts_tpu_torch.weights import loaders as tl
from tts_tpu_torch.weights.convert import params_from_jax

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TEXT = "Hello there. Good day to you!"
# FOLD_TOL of tests/test_torch_weights.py: F5's AdaLN tables, jnp against torch sums
FOLD_TOL = 2.0 ** -20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Stop(Exception):
    """Raised by a stub pipeline once it has the arguments it was handed."""


def _stub(monkeypatch, module, name: str, returns: dict | None = None) -> dict:
    """Replace tts_tpu's pipeline class `name` in `module` by a recorder: the
    constructor's arguments go to rec["init"], a method's to rec[method];
    methods in `returns` give that value, every other one stops the command."""
    rec: dict = {}
    returns = returns or {}

    class Stub:
        def __init__(self, *a, **kw):
            rec["init"] = (a, kw)

        def __getattr__(self, attr):
            def call(*a, **kw):
                rec[attr] = (a, kw)
                if attr in returns:
                    return returns[attr]
                raise _Stop(attr)
            return call

    monkeypatch.setattr(module, name, Stub)
    return rec


def _spy(monkeypatch, cls, name: str) -> list:
    """Wrap cls.name: each call's (self, args, kwargs, result) is kept."""
    calls = []
    real = getattr(cls, name)

    def rec(self, *a, **kw):
        out = real(self, *a, **kw)
        calls.append((self, a, kw, out))
        return out

    monkeypatch.setattr(cls, name, rec)
    return calls


def _cfg(c) -> dict:
    """A config of either package as a plain dict."""
    return {f.name: (_cfg(getattr(c, f.name)) if dataclasses.is_dataclass(getattr(c, f.name))
                     else getattr(c, f.name)) for f in dataclasses.fields(c)}


# tts_tpu config fields the port leaves out: TPU scheduling knobs
TPU_ONLY = {"attn_kv_split"}


def _same_cfg(port, jax_cfg) -> None:
    """A port config against tts_tpu's: every port field equal, and tts_tpu's
    other fields TPU knobs."""
    mine, ref = _cfg(port), _cfg(jax_cfg)
    assert set(ref) - set(mine) <= TPU_ONLY and set(mine) <= set(ref)
    assert mine == {k: ref[k] for k in mine}


def _run_port(*argv) -> None:
    assert tcli.main(["--device", "cpu", *map(str, argv)]) == 0


def _wav(path):
    wav, rate = read_wav(str(path))
    return wav, rate


def _close(got, ref, lsb: int) -> None:
    (g, gr), (r, rr) = got, ref
    assert gr == rr and g.dtype == r.dtype == np.int16 and g.shape == r.shape
    assert np.abs(r.astype(np.int32)).max() > 0
    assert np.abs(g.astype(np.int32) - r.astype(np.int32)).max() <= lsb


def _ref_wav(path, seconds=1.0, rate=24000, seed=0) -> str:
    write_wav(str(path), (np.random.default_rng(seed).standard_normal(int(rate * seconds))
                          * 3000).astype(np.int16), rate)
    return str(path)


def _tokenizer(dirname, fixture: str) -> None:
    shutil.copy(os.path.join(FIXTURES, f"{fixture}.json"), os.path.join(dirname, "tokenizer.json"))


# ------------------------------------------------------------ small defaults

# a Kani LM with a vocabulary past the prompt's head and tail ids (64403,
# 64404), Qwen and VoxCPM text vocabularies past their fixtures' ids
KANI_SMALL = dict(hidden_size=16, num_heads=2, num_kv_heads=1, head_dim=8, ffn_dim=32,
                  vocab_size=64512, layer_types=("conv", "attn"), max_seq_len=256)


def _qwen_small(pkg):
    from tests.test_qwen import TINY

    if pkg == "jax":
        return dataclasses.replace(TINY, text_vocab=256)
    from tts_tpu_torch.models.qwen_tts import Qwen3StackConfig, QwenTTSConfig

    d = dataclasses.asdict(dataclasses.replace(TINY, text_vocab=256))
    return QwenTTSConfig(**{**d, "talker": Qwen3StackConfig(**d["talker"]),
                            "predictor": Qwen3StackConfig(**d["predictor"])})


def _qwen_codec_small(pkg):
    from tests.test_qwen import TINY_CODEC

    if pkg == "jax":
        return TINY_CODEC
    from tts_tpu_torch.models.qwen_codec import QwenCodecDecoderConfig

    return QwenCodecDecoderConfig(**dataclasses.asdict(TINY_CODEC))


VOX_SMALL = dataclasses.replace(VOX_CFG, vocab_size=512)


def _vox_small(pkg):
    if pkg == "port":
        return VOX_SMALL
    from tests.test_torch_weights import _jax_vox_cfg

    return _jax_vox_cfg(VOX_SMALL)


@pytest.fixture
def small_defaults(monkeypatch):
    """The loaders' default configs, in both packages, at the writers' small
    configs."""
    import tts_tpu.weights.f5_loader as jf5
    import tts_tpu.weights.indextts_loader as jidx
    import tts_tpu.weights.qwen_loader as jqw
    import tts_tpu.weights.voxcpm_loader as jvox
    import tts_tpu_torch.weights.f5_loader as tf5
    import tts_tpu_torch.weights.indextts_loader as tidx
    import tts_tpu_torch.weights.qwen_loader as tqw
    import tts_tpu_torch.weights.voxcpm_loader as tvox
    from tests.test_indextts import TINY as INDEX_TINY
    from tts_tpu_torch.models.indextts import IndexTTSConfig

    for pkg, f5, idx, qw, vox, index_cfg in (
            ("jax", jf5, jidx, jqw, jvox, INDEX_TINY),
            ("port", tf5, tidx, tqw, tvox, IndexTTSConfig(**dataclasses.asdict(INDEX_TINY)))):
        f5_cls, vocos_cls = f5.F5Config, f5.VocosConfig
        monkeypatch.setattr(f5, "F5Config", lambda vocab_size, _c=f5_cls: _c(**F5_SMALL))
        monkeypatch.setattr(f5, "VocosConfig", lambda _c=vocos_cls: _c(**VOCOS_SMALL))
        monkeypatch.setattr(idx, "IndexTTSConfig", lambda _c=index_cfg: _c)
        monkeypatch.setattr(qw, "qwen_config_from_json", lambda d, _p=pkg: _qwen_small(_p))
        monkeypatch.setattr(qw, "QwenCodecDecoderConfig", lambda _p=pkg: _qwen_codec_small(_p))
        monkeypatch.setattr(vox, "VoxCPMConfig", lambda _p=pkg: _vox_small(_p))


# ------------------------------------------------------------ the writers

def _kani_dir(tmp_path):
    from tts_tpu_torch.models.kani import KaniConfig
    from tts_tpu_torch.weights.kani_loader import nanocodec_config_from_yaml

    d = str(tmp_path / "kani")
    write_kani_dir(d, KaniConfig(**KANI_SMALL), "sharded", False, np.random.default_rng(6))
    _tokenizer(d, "gpt2_style")
    nemo = str(tmp_path / "codec.nemo")
    sd = nanocodec_state_dict(nanocodec_config_from_yaml(NEMO_YAML), np.random.default_rng(7))
    # half_snake's snake takes half the channels (NeMo's HalfSnake: alpha of
    # C / 2, where the writer gives C)
    for k in [k for k in sd if k.endswith("alpha")]:
        sd[k] = sd[k][:, :sd[k].shape[1] // 2]
    # a louder codec, so the int16 comparison sees a good part of the range
    g = "audio_decoder.post_conv.conv.parametrizations.weight.original0"
    sd[g] = sd[g] * 4000
    write_nemo(nemo, NEMO_YAML, sd)
    return d, nemo


def _qwen_dir(tmp_path):
    from tests.test_qwen_codec_loader import _build_state_dict as qwen_codec_state_dict

    d = str(tmp_path / "qwen")
    os.makedirs(d)
    rng = np.random.default_rng(8)
    tl.write_safetensors(os.path.join(d, "model.safetensors"),
                         qwen_talker_state_dict(_qwen_small("port"), rng))
    tl.write_safetensors(os.path.join(d, "speech_tokenizer.safetensors"),
                         qwen_codec_state_dict(_qwen_codec_small("jax"), rng))
    _tokenizer(d, "qwen2_style")
    return d


# the IndexTTS writer's text table has 32 rows: a bpe.model of 31 pieces
INDEX_PIECES = ([UNK, BOS, EOS, (WS, -10.0, 1)]
                + [(c, -5.0, 1) for c in "ABCDEGHILNORSTUY.!,"]
                + [(WS + "HE", -1.0, 1), ("LL", -1.5, 1), ("LLO", -1.2, 1),
                   (WS + "HELLO", -0.5, 1), (WS + "GOOD", -0.7, 1), (WS + "DAY", -0.9, 1),
                   ("ER", -2.1, 1), ("TH", -2.0, 1)])


def _indextts_dir(tmp_path):
    d = str(tmp_path / "indextts")
    os.makedirs(d)
    write_indextts_dir(d, np.random.default_rng(11))
    with open(os.path.join(d, "bpe.model"), "wb") as f:
        f.write(build_model(INDEX_PIECES, model_type=2))
    return d


# ------------------------------------------------------------ --ckpt, greedy families


def test_kani_ckpt_matches_tts_tpu(tmp_path, small_defaults, monkeypatch):
    d, nemo = _kani_dir(tmp_path)
    from tts_tpu_torch.runtime.kani import KaniPipeline

    calls = _spy(monkeypatch, KaniPipeline, "synthesize_ids")
    args = ["kani", "--ckpt", d, "--codec", nemo, "--text", TEXT, "--max-tokens", 40]
    jcli.main(list(map(str, args)) + ["--out", str(tmp_path / "j.wav")])
    _run_port(*args, "--out", tmp_path / "t.wav")
    _close(_wav(tmp_path / "t.wav"), _wav(tmp_path / "j.wav"), 2)
    # the prompt: head ids, the tokenizer's ids of "jenny: <text>", tail ids
    from tts_tpu_torch.frontend.hf_tokenizer import HFTokenizer

    ids = HFTokenizer.from_pretrained(d)(f"jenny: {TEXT}", return_tensors="np")["input_ids"]
    assert np.array_equal(calls[0][1][0], np.concatenate([[[64403]], ids, [[2, 64404]]], 1))


def test_qwen_ckpt_matches_tts_tpu(tmp_path, small_defaults):
    d = _qwen_dir(tmp_path)
    args = ["qwen", "--ckpt", d, "--text", TEXT, "--max-frames", 6, "--language-id", 3]
    jcli.main(list(map(str, args)) + ["--out", str(tmp_path / "j.wav")])
    _run_port(*args, "--out", tmp_path / "t.wav")
    _close(_wav(tmp_path / "t.wav"), _wav(tmp_path / "j.wav"), 2)


def test_indextts_ckpt_matches_tts_tpu(tmp_path, small_defaults):
    d = _indextts_dir(tmp_path)
    ref = _ref_wav(tmp_path / "ref.wav")
    args = ["indextts", "--ckpt", d, "--ref-audio", ref, "--text", TEXT, "--max-tokens", 20]
    jcli.main(list(map(str, args)) + ["--out", str(tmp_path / "j.wav")])
    _run_port(*args, "--out", tmp_path / "t.wav")
    _close(_wav(tmp_path / "t.wav"), _wav(tmp_path / "j.wav"), 4)


def test_npz_round_trip(tmp_path, small_defaults):
    """The port saves its loaded Qwen tree; the port's --npz run gives the
    --ckpt run's WAV bit for bit, tts_tpu's --npz run of the same bundle
    within 2 LSB of it."""
    d = _qwen_dir(tmp_path)
    bundle = str(tmp_path / "qwen_bundle.npz")
    args = ["qwen", "--ckpt", d, "--text", TEXT, "--max-frames", 6]
    _run_port(*args, "--save-npz", bundle, "--out", tmp_path / "a.wav")
    _run_port(*args, "--npz", bundle, "--out", tmp_path / "b.wav")
    a = _wav(tmp_path / "a.wav")
    assert np.array_equal(a[0], _wav(tmp_path / "b.wav")[0])
    jcli.main(list(map(str, args)) + ["--npz", bundle, "--out", str(tmp_path / "j.wav")])
    _close(a, _wav(tmp_path / "j.wav"), 2)
    cfgs = tcli._load_bundle(bundle, "cpu", torch.float32)[1]
    assert cfgs["cfg"] == _qwen_small("port") and cfgs["ccfg"] == _qwen_codec_small("port")


# ------------------------------------------------------------ --ckpt, noise draws


def test_f5_ckpt_hands_the_same_arguments(tmp_path, small_defaults, monkeypatch):
    import tts_tpu.runtime.f5 as jf5
    from tts_tpu_torch.models.f5 import F5Config
    from tts_tpu_torch.models.vocos import VocosConfig
    from tts_tpu_torch.runtime.f5 import F5Pipeline

    ckpt, vocab = write_f5(tmp_path, F5Config(**F5_SMALL))
    vdir = write_vocos(tmp_path, VocosConfig(**VOCOS_SMALL), loud=True)
    ref = _ref_wav(tmp_path / "ref.wav", seconds=0.5)
    args = ["f5", "--ckpt", ckpt, "--vocab", vocab, "--vocoder", vdir, "--ref-audio", ref,
            "--ref-text", "abc def.", "--gen-text", "hello world, again.", "--seed", 7,
            "--speed", 1.1]
    rec = _stub(monkeypatch, jf5, "F5Pipeline")
    with pytest.raises(_Stop):
        jcli.main(list(map(str, args)))
    calls = _spy(monkeypatch, F5Pipeline, "synthesize")
    _run_port(*args, "--out", tmp_path / "t.wav")
    pipe, a, kw, _ = calls[0]
    (jparams, jcfg, jvocab, jvparams, jvcfg), jkw = rec["init"]
    _same_cfg(pipe.cfg, jcfg)
    _same_cfg(pipe.vcfg, jvcfg)
    assert pipe.vocab == jvocab and pipe.seed == jkw["seed"] == 7 and jkw["quantize"] is None
    assert pipe._qparams is None
    loose = {"ada_table": FOLD_TOL, "norm_out_table": FOLD_TOL}
    assert_same_tree(pipe.f5.params, params_from_jax(_jax_tree(jparams), "cpu", torch.float32),
                     loose)
    assert_same_tree(pipe.vocos.params,
                     params_from_jax(_jax_tree(jvparams), "cpu", torch.float32))
    ja, jk = rec["synthesize"]
    assert np.array_equal(a[0], ja[0]) and a[1:] == ja[1:] and kw == jk == {"speed": 1.1}
    # the command's WAV is the pipeline's own call at the pipeline's seed
    wav, stats = pipe.synthesize(*a, **kw)
    got, rate = _wav(tmp_path / "t.wav")
    assert rate == pipe.cfg.sample_rate and np.array_equal(got, wav) and wav.any()


def test_voxcpm_ckpt_hands_the_same_arguments(tmp_path, small_defaults, monkeypatch):
    import tts_tpu.runtime.voxcpm as jvox
    from tts_tpu_torch.runtime.voxcpm import VoxCPMPipeline

    d = str(tmp_path / "voxcpm")
    os.makedirs(d)
    tl.write_safetensors(os.path.join(d, "model.safetensors"),
                         voxcpm_state_dict(VOX_SMALL, np.random.default_rng(13), True))
    _tokenizer(d, "llama_style")
    args = ["voxcpm", "--ckpt", d, "--text", "Hello 42 times.", "--prompt-text",
            "A prompt.", "--max-latents", 6]
    rec = _stub(monkeypatch, jvox, "VoxCPMPipeline")
    with pytest.raises(_Stop):
        jcli.main(list(map(str, args)))
    calls = _spy(monkeypatch, VoxCPMPipeline, "synthesize_ids")
    _run_port(*args, "--out", tmp_path / "t.wav")
    pipe, a, kw, _ = calls[0]
    (jparams, jcfg, jvae, jdec), jkw = rec["init"]
    _same_cfg(pipe.cfg, jcfg)
    _same_cfg(pipe.dcfg, jdec)
    assert jkw == {"quantize": None}
    assert_same_tree(pipe.params, params_from_jax(_jax_tree(jparams), "cpu", torch.float32))
    assert_same_tree(pipe.vae_params, params_from_jax(_jax_tree(jvae), "cpu", torch.float32))
    ja, jk = rec["synthesize_ids"]
    assert len(a) == len(ja) == 3 and a[2] is None and ja[2] is None and kw == jk == {}
    for got, want in zip(a[:2], ja[:2]):
        assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert a[0].shape[1] > 0 and a[1].shape[1] > 0
    wav, _ = pipe.synthesize_ids(*a, **kw)
    got, rate = _wav(tmp_path / "t.wav")
    assert rate == pipe.output_sample_rate and np.array_equal(got, wav)


# ------------------------------------------------------------ no --ckpt


@pytest.fixture
def small_f5(monkeypatch):
    """F5Config() and VocosConfig() at the small test sizes in both packages
    (tts_tpu's no---ckpt F5 is full width)."""
    import tts_tpu.models.f5 as jm
    import tts_tpu.models.vocos as jv
    import tts_tpu_torch.models.f5 as tm
    import tts_tpu_torch.models.vocos as tv

    for mod, name, kw in ((jm, "F5Config", F5_SMALL), (tm, "F5Config", F5_SMALL),
                          (jv, "VocosConfig", VOCOS_SMALL), (tv, "VocosConfig", VOCOS_SMALL)):
        cls = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda _c=cls, _k=kw: _c(**_k))


RANDOM = {
    # family: (tts_tpu runtime module, pipeline class, the port's, synthesis
    # method, argv, tts_tpu's random-init functions)
    "kani": ("tts_tpu.runtime.kani", "KaniPipeline", "tts_tpu_torch.runtime.kani",
             "synthesize_ids", ["--max-tokens", "20"],
             {"tts_tpu.models.kani": ["init_params"],
              "tts_tpu.models.nanocodec": ["init_params"]}),
    "qwen": ("tts_tpu.runtime.qwen", "QwenTTSPipeline", "tts_tpu_torch.runtime.qwen",
             "synthesize_ids", ["--max-frames", "4"],
             {"tts_tpu.models.qwen_tts": ["init_talker_params", "init_predictor_params"],
              "tts_tpu.models.qwen_codec": ["init_decoder_params"]}),
    "voxcpm": ("tts_tpu.runtime.voxcpm", "VoxCPMPipeline", "tts_tpu_torch.runtime.voxcpm",
               "synthesize_ids", ["--max-latents", "4"],
               {"tts_tpu.models.voxcpm": ["init_params", "init_vae_params"]}),
    "indextts": ("tts_tpu.runtime.indextts", "IndexTTSPipeline",
                 "tts_tpu_torch.runtime.indextts", "synthesize",
                 ["--allow-degraded", "--max-tokens", "6", "--text", "Hi."],
                 {"tts_tpu.models.indextts": ["init_conformer_params", "init_perceiver_params",
                                              "init_ecapa_params", "init_gpt_params"],
                  "tts_tpu.models.bigvgan": ["init_params"]}),
    "f5": ("tts_tpu.runtime.f5", "F5Pipeline", "tts_tpu_torch.runtime.f5", "synthesize",
           ["--ref-text", "abc.", "--gen-text", "hello."],
           {"tts_tpu.models.f5": ["init_params"], "tts_tpu.models.vocos": ["init_params"]}),
}


@pytest.mark.parametrize("family", sorted(RANDOM))
def test_random_weights_hand_the_same_arguments(family, tmp_path, monkeypatch, small_f5):
    """No --ckpt: tts_tpu's small configs (F5's set small in both), ids and
    decode settings reach the pipeline as tts_tpu's CLI hands them, and the
    command writes what its pipeline returned. The random draws of the two
    packages differ, so tts_tpu's init functions are stubbed out and its
    pipeline stops at the synthesis call."""
    import importlib

    jmod, cls, tmod, method, extra, inits = RANDOM[family]
    argv = [family, *extra]
    if family in ("indextts", "f5"):
        argv += ["--ref-audio", _ref_wav(tmp_path / "ref.wav", seconds=0.5)]
    for mod, names in inits.items():
        for name in names:
            monkeypatch.setattr(importlib.import_module(mod), name, lambda *a, **k: {})
    rec = _stub(monkeypatch, importlib.import_module(jmod), cls,
                returns={"encode_reference": "REF"})
    with pytest.raises(_Stop):
        jcli.main(argv)
    calls = _spy(monkeypatch, getattr(importlib.import_module(tmod), cls), method)
    _run_port(*argv, "--out", tmp_path / "t.wav")
    pipe, a, kw, out = calls[0]
    ja, jk = rec[method]
    jinit, jinit_kw = rec["init"]
    cfgs = [c for c in jinit if dataclasses.is_dataclass(c)]
    names = {"kani": ("cfg", "codec_cfg", "dcfg"), "qwen": ("cfg", "codec_cfg", "dcfg"),
             "voxcpm": ("cfg", "dcfg"), "indextts": ("cfg", "vcfg"),
             "f5": ("cfg", "vcfg")}[family]
    assert len(names) == len(cfgs)
    for n, c in zip(names, cfgs):
        _same_cfg(getattr(pipe, n), c)
    assert jinit_kw.get("quantize") is None and jinit_kw.get("tokenizer") is None
    if family == "indextts":
        assert a[0] == ja[0] == "Hi." and kw["max_gen"] == jk["max_gen"] == 6
        assert type(kw["tokenizer"].vocab) is type(jk["tokenizer"].vocab) is dict
        assert kw["tokenizer"].vocab == jk["tokenizer"].vocab
    elif family == "f5":
        assert np.array_equal(a[0], ja[0]) and a[1:] == ja[1:] and pipe.vocab == jinit[2]
        assert pipe.seed == jinit_kw["seed"] and kw == jk
    else:
        assert len(a) == len(ja) and kw == jk
        for got, want in zip(a, ja):
            assert got is want is None or np.array_equal(got, want)
    assert np.array_equal(_wav(tmp_path / "t.wav")[0], out[0]) and len(out[0]) > 0


# ------------------------------------------------------------ the device rule, serving


def test_device_cuda_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["kani"], ["--device", "cuda", "qwen"], ["voxcpm"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tcli.main(argv + ["--out", str(tmp_path / "x.wav")])
    assert not (tmp_path / "x.wav").exists()


@pytest.mark.parametrize("family", ["kani", "qwen", "voxcpm"])
def test_quantize_4_raises_where_the_runtime_does(family, monkeypatch, tmp_path):
    """Every runtime takes quantize=4 now (none raises): the command hands
    it to its pipeline and writes the request's audio; a width the parser
    does not offer exits there."""
    import importlib

    import tts_tpu_torch.quant.weight_only as wo

    _, cls, tmod, method, extra, _ = RANDOM[family]
    calls = _spy(monkeypatch, getattr(importlib.import_module(tmod), cls), method)
    bits, real = [], wo.quantize_pytree
    monkeypatch.setattr(wo, "quantize_pytree",
                        lambda tree, **kw: bits.append(kw.get("bits")) or real(tree, **kw))
    _run_port(family, *extra, "--quantize", 4, "--out", tmp_path / "q.wav")
    wav = calls[0][3][0]
    assert bits == [4]
    assert np.array_equal(_wav(tmp_path / "q.wav")[0], wav) and len(wav) > 0
    with pytest.raises(SystemExit):
        _run_port(family, *extra, "--quantize", 16, "--out", tmp_path / "r.wav")


def test_serve_builds_on_the_cpu(capsys):
    """Admission batching with --warmup over every ladder size, and a
    continuous slot server; --devices past the cards raises."""
    args = tcli._parser().parse_args(["--device", "cpu", "serve", "--max-tokens", "8",
                                      "--max-batch", "2", "--warmup"])
    srv = tcli.build_server(args)
    try:
        assert tcli._ladder(3) == (1, 2, 3) and tcli._ladder(6) == (1, 2, 4, 6)
        assert "warmup batch=2" in capsys.readouterr().out
    finally:
        srv.close()
    args = tcli._parser().parse_args(["--device", "cpu", "serve", "--continuous",
                                      "--max-tokens", "8", "--max-batch", "2"])
    srv = tcli.build_server(args)
    srv.close()
    for extra in ([], ["--continuous"]):
        args = tcli._parser().parse_args(["--device", "cpu", "serve", "--devices", "2", *extra])
        with pytest.raises(SystemExit):
            tcli.build_server(args)


# ------------------------------------------------------------ utils/timing


def test_timing_matches_tts_tpu(tmp_path):
    """SynthesisReport's table and JSON as tts_tpu's, StageTimer's spans;
    trace_profile does nothing without a log_dir and writes one chrome
    trace (torch.profiler) into it."""
    import json

    from tts_tpu.utils.timing import SynthesisReport as JReport
    from tts_tpu_torch.utils import StageTimer, SynthesisReport, trace_profile

    for kw in (dict(family="kani_tts", audio_seconds=1.5, wall_seconds=0.25, tokens=40,
                    stages={"lm": 0.2, "codec": 0.05}),
               dict(family="f5_tts", audio_seconds=0.0, wall_seconds=0.1)):
        got, ref = SynthesisReport(**kw), JReport(**kw)
        assert got.table() == ref.table() and got.json() == ref.json()
        assert (got.rtf, got.tokens_per_second) == (ref.rtf, ref.tokens_per_second)
    timer = StageTimer()
    for _ in range(2):
        with timer.span("talker"):
            torch.ones(8).sum()
    assert timer.counts == {"talker": 2} and list(timer.as_dict()) == ["talker"]
    with trace_profile(None):
        pass
    log_dir = tmp_path / "trace"
    with trace_profile(str(log_dir)):
        torch.ones(64).cumsum(0)
    files = list(log_dir.glob("*.json"))
    assert len(files) == 1 and json.loads(files[0].read_text())["traceEvents"]


# ------------------------------------------------------------ int16 output


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pcm16_saturates_as_tts_tpu(dtype):
    """to_pcm16 against tts_tpu's `.astype(jnp.int16)` of the same scaled
    waveform: in bf16, 1.0 * 32767 rounds to 32768, which XLA saturates to
    32767 and a plain `.to(torch.int16)` wraps to -32768."""
    import jax.numpy as jnp

    from tts_tpu_torch.audio.wav import to_pcm16

    x = np.concatenate([np.linspace(-1.2, 1.2, 4001), [1.0, -1.0, 0.99999, -0.99999, 0.0]])
    jx = jnp.asarray(x, getattr(jnp, dtype))
    ref = np.asarray((jnp.clip(jx, -1.0, 1.0) * 32767.0).astype(jnp.int16))
    raw = np.asarray((jx * 32767.0).astype(jnp.int16))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert np.array_equal(to_pcm16(torch.clamp(tx, -1.0, 1.0) * 32767.0).numpy(), ref)
    assert np.array_equal(to_pcm16(tx * 32767.0).numpy(), raw)
    assert ref.max() == 32767 and ref.min() <= -32767


def test_runtimes_convert_to_int16_through_to_pcm16():
    """Every waveform-to-int16 conversion of the runtimes and slot servers
    goes through audio/wav.to_pcm16."""
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent / "tts_tpu_torch"
    bad = [str(p) for d in ("runtime", "serving") for p in sorted((root / d).glob("*.py"))
           if ".to(torch.int16)" in p.read_text()]
    assert not bad, bad
