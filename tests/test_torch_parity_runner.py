"""The port's ONNX-oracle runner (tts_tpu_torch/parity/run_reference.py)
on the CPU: its skips and their reasons against tts_tpu's, the one
deviation (an exception is an "error" result and `main` exits 1 for it,
where tts_tpu skips and exits 0), `main`'s exit codes and `--json`, the
wav mode through a stubbed port CLI, the graph files' mapping onto driver
keys against tts_tpu's, and the two session-mode families end to end:
`run_f5` and `run_bigvgan` at small sizes on checkpoint files written by
tests/test_torch_weights.py's writers, against stand-in sessions built
from tts_tpu's stage functions (`f5_preprocess`, the DiT step, Vocos;
`bigvgan_apply`), fp32 on both sides, within 1e-4 mel L1."""
import ast
import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_parity_sessions import MockSession
from tts_tpu.parity import run_reference as jrr
from tts_tpu_torch.parity import run_reference as trr

L1_TOL = 1e-4
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _touch(d: Path, *names):
    d.mkdir(parents=True, exist_ok=True)
    for n in names:
        if n.endswith("/"):
            (d / n).mkdir(exist_ok=True)
        else:
            (d / n).write_bytes(b"")


F5_FILES = ("F5_Preprocess.onnx", "F5_Transformer.onnx", "F5_Decode.onnx",
            "model.safetensors", "vocab.txt", "vocos/")
LAYOUTS = {
    "empty": {},
    "bare_dirs": {f: () for f in trr.FAMILIES},
    "bigvgan_partial": {"bigvgan": ("BigVGAN.onnx",), "f5": ("vocab.txt", "vocos/")},
    "no_onnxruntime": {"bigvgan": ("BigVGAN.onnx", "config.json", "bigvgan_generator.pt"),
                       "f5": F5_FILES, "kani": ("KaniTTS_Main.onnx",)},
}


def _summary(results):
    return [(r.family, r.mode, r.detail) for r in results]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_skip_reasons_equal_tts_tpu(tmp_path, layout):
    for fam, names in LAYOUTS[layout].items():
        _touch(tmp_path / fam, *names)
    got = trr.run_all(str(tmp_path), device="cpu")
    assert _summary(got) == _summary(jrr.run_all(str(tmp_path)))
    assert len(got) == len(trr.FAMILIES) and all(r.mode == "skipped" for r in got)
    assert trr.main(["--artifacts", str(tmp_path), "--device", "cpu"]) == 0


def test_f5_missing_ref_wav_skips_as_tts_tpu(tmp_path, monkeypatch):
    """Past the onnxruntime check (patched present in both)."""
    _touch(tmp_path / "f5", *F5_FILES)
    monkeypatch.setattr(trr, "_have_ort", lambda: True)
    monkeypatch.setattr(jrr, "_have_ort", lambda: True)
    got = trr.run_f5(str(tmp_path / "f5"), device="cpu")
    want = jrr.run_f5(str(tmp_path / "f5"))
    assert (got.mode, got.detail) == (want.mode, want.detail) == ("skipped", "missing ref.wav")


def test_an_exception_is_an_error_not_a_skip(tmp_path, monkeypatch, capsys):
    """tts_tpu turns it into a skip and exits 0; the port reports it and
    exits 1, so a kernel that fails to build or launch cannot pass."""
    _touch(tmp_path / "bigvgan", "BigVGAN.onnx", "config.json", "bigvgan_generator.pt")
    for mod in (trr, jrr):
        monkeypatch.setattr(mod, "_have_ort", lambda: True)
    got = trr.run_all(str(tmp_path), families=("bigvgan",), device="cpu")
    want = jrr.run_all(str(tmp_path), families=("bigvgan",))
    assert want[0].mode == "skipped" and got[0].mode == "error"
    assert got[0].detail == want[0].detail and got[0].detail.startswith("error: ")
    assert got[0].line().split()[1] == "ERROR"
    assert jrr.main(["--artifacts", str(tmp_path), "--families", "bigvgan"]) == 0
    out = tmp_path / "r.json"
    assert trr.main(["--artifacts", str(tmp_path), "--families", "bigvgan", "--device",
                     "cpu", "--json", str(out)]) == 1
    assert "ERROR" in capsys.readouterr().out
    rows = json.loads(out.read_text())
    assert [(r["family"], r["mode"]) for r in rows] == [("bigvgan", "error")]


def test_the_card_is_the_default_and_nothing_falls_back(tmp_path, monkeypatch):
    import inspect

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        trr.main(["--artifacts", str(tmp_path)])
    with pytest.raises(RuntimeError):
        trr._device_dtype("cuda", None)
    assert trr._device_dtype("cpu", None) == (torch.device("cpu"), torch.float32)
    assert trr._device_dtype("cpu", torch.bfloat16)[1] == torch.bfloat16
    for fn in (trr.run_bigvgan, trr.run_f5, trr.run_session_family, trr.run_wav_family,
               trr.run_all):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_onnxruntime_only_inside_the_session_helpers():
    """The port imports onnxruntime nowhere but in `_have_ort` / `_session`."""
    for path in sorted((ROOT / "tts_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(encoding="utf-8"))
        allowed = set()
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef) and fn.name in ("_have_ort", "_session"):
                allowed |= {id(n) for n in ast.walk(fn)}
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".")[0] == "onnxruntime" for n in names):
                assert id(node) in allowed, f"{path}:{node.lineno}"


# ---------------------------------------------------------------- wav mode

def _stub_cli(monkeypatch, wav, rate, seen):
    import tts_tpu_torch.cli

    from tts_tpu_torch.audio.wav import write_wav

    def fake_cli(argv):
        seen.append(list(argv))
        write_wav(argv[argv.index("--out") + 1], wav, rate)
        return 0

    monkeypatch.setattr(tts_tpu_torch.cli, "main", fake_cli)


def test_wav_mode_identical_audio_passes(tmp_path, monkeypatch):
    from tts_tpu_torch.audio.wav import write_wav

    art = tmp_path / "kani"
    art.mkdir()
    rng = np.random.default_rng(0)
    wav = (np.sin(np.linspace(0, 400, 22050)) * 12000
           + rng.standard_normal(22050) * 200).astype(np.int16)
    write_wav(str(art / "reference.wav"), wav, 22050)
    (art / "inputs.json").write_text(json.dumps({"text": "hello",
                                                 "cli_args": ["--max-tokens", "8"]}))
    seen = []
    _stub_cli(monkeypatch, wav, 22050, seen)
    res = trr.run_wav_family("kani", str(art), device="cpu")
    assert res.mode == "wav" and res.passed and res.mel_l1 == 0.0
    assert seen == [["--device", "cpu", "kani", "--ckpt", str(art), "--out",
                     str(art / "_ours.wav"), "--text", "hello", "--max-tokens", "8"]]
    # and through run_all and main, which exits 0 for a pass
    assert trr.main(["--artifacts", str(tmp_path), "--families", "kani", "--device",
                     "cpu"]) == 0


def test_wav_mode_different_audio_fails(tmp_path, monkeypatch):
    from tts_tpu_torch.audio.wav import write_wav

    art = tmp_path / "qwen"
    art.mkdir()
    rng = np.random.default_rng(1)
    ref = (rng.standard_normal(22050) * 8000).astype(np.int16)
    other = (np.sin(np.linspace(0, 2000, 22050)) * 20000).astype(np.int16)
    write_wav(str(art / "reference.wav"), ref, 22050)
    _stub_cli(monkeypatch, other, 22050, [])
    res = trr.run_wav_family("qwen", str(art), device="cpu")
    assert res.mode == "wav" and not res.passed and res.mel_l1 > 1e-1
    assert trr.main(["--artifacts", str(tmp_path), "--families", "qwen", "--device",
                     "cpu"]) == 1


# ------------------------------------------------------------ session mode

GRAPHS = ["KaniTTS_Embed.onnx", "KaniTTS_Main.onnx", "KaniTTS_Codec.onnx",
          "IndexTTS_A.onnx", "IndexTTS_B.onnx", "IndexTTS_C.onnx", "IndexTTS_E.onnx",
          "Qwen_TTS_Main.onnx", "Qwen_TTS_Predictor.onnx", "Qwen_TTS_Decoder.onnx",
          "Qwen_LmHead_0.onnx", "Qwen_LmHead_14.onnx", "Qwen_Embed_D_3.onnx",
          "Qwen_LmHead_x.onnx", "VoxCPM_Feat_Encoder.onnx", "VoxCPM_Main.onnx",
          "VoxCPM_Feat_Decoder.onnx", "VoxCPM_VAE_Decoder.onnx", "notes.txt"]


@pytest.mark.parametrize("family", ["kani", "indextts", "qwen", "voxcpm"])
def test_collect_sessions_keys_equal_tts_tpu(tmp_path, monkeypatch, family):
    _touch(tmp_path, *GRAPHS)
    for mod in (trr, jrr):
        monkeypatch.setattr(mod, "_session", os.path.basename)
    got = trr._collect_sessions(family, str(tmp_path))
    assert got == jrr._collect_sessions(family, str(tmp_path)) and got


def test_session_mode_aggregates_stage_diffs(tmp_path, monkeypatch):
    """run_session_family loads the family on the asked device and dtype,
    hands the driver the sessions, and folds its stage diffs into one
    result (tests/test_parity_runner.py's case, through the port)."""
    from tts_tpu_torch.parity.sessions import StageDiff

    art = tmp_path / "kani"
    _touch(art, "KaniTTS_Embed.onnx", "KaniTTS_Main.onnx", "KaniTTS_Codec.onnx")
    monkeypatch.setattr(trr, "_have_ort", lambda: True)
    monkeypatch.setattr(trr, "_session", os.path.basename)
    loads = []
    monkeypatch.setattr("tts_tpu_torch.weights.kani_loader.load_kani_lm",
                        lambda d, dtype, device: loads.append((d, dtype, device)) or ({}, None))
    monkeypatch.setattr(
        "tts_tpu_torch.parity.sessions.kani_session_stages",
        lambda sessions, params, cfg, cparams, ccfg: [
            StageDiff("kani/embed", 1e-6), StageDiff(f"kani/main_step {len(sessions)}", 2e-5)])
    res = trr.run_session_family("kani", str(art), device="cpu")
    assert res.mode == "session" and res.passed and res.mel_l1 == 2e-5
    assert "kani/embed" in res.detail and "kani/main_step 3" in res.detail
    assert loads == [(str(art), torch.float32, torch.device("cpu"))]
    monkeypatch.setattr(trr, "_have_ort", lambda: False)
    assert trr.run_session_family("kani", str(art), device="cpu") is None


# ------------------------------------------------ run_f5 and run_bigvgan

def _opened(monkeypatch, table):
    monkeypatch.setattr(trr, "_have_ort", lambda: True)
    monkeypatch.setattr(trr, "_session", lambda p: table[os.path.basename(p)])


def _i16(wav):
    return (np.clip(np.asarray(wav), -1, 1) * 32767).astype(np.int16)


def _f5_standins(jp, jc, jvp, jvc):
    """F5's three graphs from tts_tpu's stage functions (jitted)."""
    from tts_tpu.models import f5 as jf5
    from tts_tpu.models.vocos import vocos_decode

    pre = jax.jit(lambda a, i, n: jf5.f5_preprocess(jp, a, i, n, jc, jax.random.key(11)),
                  static_argnums=2)

    @jax.jit
    def step(x, cat, drop, idx):
        t = x.shape[1]
        pred, pred1 = jf5.dit_forward(jp, x, cat, drop, jp["time_table"][idx],
                                      jp["rope_cos"][:t], jp["rope_sin"][:t], jc)
        return x + (pred + (pred - pred1) * jc.cfg_strength) * jp["delta_t"][idx]

    def a_fn(feed):
        noise, cat, drop, ref = pre(jnp.asarray(feed["audio"].reshape(1, -1) / 32768.0),
                                    jnp.asarray(feed["text_ids"]),
                                    int(feed["max_duration"][0]))
        return [np.asarray(noise), np.asarray(cat), np.asarray(drop),
                np.array([ref], np.int64)]

    def b_fn(feed):
        idx = int(feed["time_step"][0])
        x = step(*(jnp.asarray(feed[k]) for k in ("noise", "cat_mel_text",
                                                   "cat_mel_text_drop")), idx)
        return [np.asarray(x), np.array([idx + 1], np.int32)]

    def c_fn(feed):
        gen = jnp.asarray(feed["denoised"])[:, int(feed["ref_signal_len"][0]):]
        return [_i16(vocos_decode(jvp, gen, jvc))]

    mel, cat = (1, "T", jc.n_mels), (1, "T", jc.n_mels + jc.text_dim)
    pre_s = MockSession([("audio", (1, 1, "N")), ("text_ids", (1, "L")),
                         ("max_duration", (1,))], a_fn)
    pre_s.get_outputs = lambda: [type("O", (), {"name": n})() for n in
                                 ("noise", "cat_mel_text", "cat_mel_text_drop",
                                  "ref_signal_len")]
    return {"F5_Preprocess.onnx": pre_s,
            "F5_Transformer.onnx": MockSession(
                [("noise", mel), ("cat_mel_text", cat), ("cat_mel_text_drop", cat),
                 ("time_step", (1,))], b_fn),
            "F5_Decode.onnx": MockSession([("denoised", mel), ("ref_signal_len", (1,))],
                                          c_fn)}


def test_run_f5_against_tts_tpu_standins(tmp_path, monkeypatch):
    from tests.test_torch_weights import F5_SMALL, VOCOS_SMALL, write_f5, write_vocos
    from tts_tpu.models.f5 import F5Config as JF5Config
    from tts_tpu.models.vocos import VocosConfig as JVocosConfig
    from tts_tpu.weights.f5_loader import load_f5 as jload_f5
    from tts_tpu.weights.f5_loader import load_vocos as jload_vocos
    from tts_tpu_torch.audio.wav import write_wav
    from tts_tpu_torch.models.f5 import F5Config
    from tts_tpu_torch.models.vocos import VocosConfig
    import tts_tpu_torch.weights.f5_loader as tf5

    art = tmp_path / "f5"
    art.mkdir()
    ckpt, vocab = write_f5(art, F5Config(**F5_SMALL), seed=3)
    vdir = write_vocos(art, VocosConfig(**VOCOS_SMALL), loud=True)
    rng = np.random.default_rng(5)
    write_wav(str(art / "ref.wav"), (rng.standard_normal(9000) * 3000).astype(np.int16), 24000)
    (art / "ref.txt").write_text("some call me nature")
    (art / "gen.txt").write_text("the quick brown fox")
    _touch(art, "F5_Preprocess.onnx", "F5_Transformer.onnx", "F5_Decode.onnx")
    # the loaders' default configs at the writers' small ones
    monkeypatch.setattr(tf5, "F5Config", lambda vocab_size: F5Config(**F5_SMALL))
    monkeypatch.setattr(tf5, "VocosConfig", lambda: VocosConfig(**VOCOS_SMALL))
    jp, jc, _ = jload_f5(ckpt, vocab, JF5Config(**F5_SMALL))
    jvp, jvc = jload_vocos(vdir, JVocosConfig(**VOCOS_SMALL))
    table = _f5_standins(jp, jc, jvp, jvc)
    _opened(monkeypatch, table)
    res = trr.run_f5(str(art), device="cpu")
    assert res.mode == "session" and res.passed and res.mel_l1 <= L1_TOL, res.line()
    assert "wav mel_l1=" in res.detail
    wav_l1 = float(res.detail.split("=")[1])
    assert wav_l1 <= L1_TOL
    # the stand-ins must be the ones that ran: a zeroed noise moves the mel
    real = table["F5_Transformer.onnx"].fn
    table["F5_Transformer.onnx"].fn = lambda feed: [real(feed)[0] * 0.5, real(feed)[1]]
    bad = trr.run_f5(str(art), device="cpu")
    assert bad.mode == "session" and not bad.passed


def test_run_bigvgan_against_tts_tpu_standin(tmp_path, monkeypatch):
    from tests.test_torch_weights import BV_SMALL, _rng, _torch_sd, bigvgan_state_dict
    from tests.test_torch_weights import write_bigvgan_config
    from tts_tpu.models.bigvgan import bigvgan_apply
    from tts_tpu.weights.loaders import load_bigvgan as jload_bigvgan

    art = tmp_path / "bigvgan"
    art.mkdir()
    cfg = dataclasses.replace(BV_SMALL, activation="snakebeta", snake_logscale=True)
    sd = bigvgan_state_dict(cfg, _rng(4))
    # a louder final conv, so the int16 comparison sees the waveform
    for k in [k for k in sd if k.startswith("conv_post.weight")]:
        if not k.endswith("_g"):
            sd[k] = sd[k] * 200.0
    write_bigvgan_config(str(art / "config.json"), cfg)
    torch.save({"generator": _torch_sd(sd)}, str(art / "bigvgan_generator.pt"))
    _touch(art, "BigVGAN.onnx")
    jp, jcfg = jload_bigvgan(str(art))
    gen = jax.jit(lambda m: bigvgan_apply(jp, m, jcfg))
    mock = MockSession([("mel", (1, jcfg.num_mels, "T"))], lambda feed: [
        _i16(gen(jnp.asarray(feed["mel"].transpose(0, 2, 1))))])
    _opened(monkeypatch, {"BigVGAN.onnx": mock})
    res = trr.run_bigvgan(str(art), device="cpu")
    assert res.mode == "session" and res.passed and res.mel_l1 <= L1_TOL, res.line()
    ours = np.asarray(gen(jnp.zeros((1, 8, jcfg.num_mels))))
    assert np.isfinite(ours).all()
    wav = mock.run(None, {"mel": np.random.default_rng(0).standard_normal(
        (1, jcfg.num_mels, 512)).astype(np.float32)})[0]
    assert np.abs(wav.astype(np.int32)).max() > 1000, "the waveform must not sit near zero"


# --------------------- run_session_family on checkpoint files, stand-ins

from tests.test_torch_cli import small_defaults  # noqa: E402,F401  (a fixture)


def _family_dir(fam, tmp_path):
    """A family's checkpoint directory by tests/test_torch_cli.py's writers
    (small_defaults gives the loaders their configs), the Kani codec inside."""
    import shutil

    from tests import test_torch_cli as C

    if fam == "kani":
        d, nemo = C._kani_dir(tmp_path)
        shutil.move(nemo, os.path.join(d, "nano_codec.nemo"))
        return d
    if fam == "qwen":
        return C._qwen_dir(tmp_path)
    if fam == "indextts":
        return C._indextts_dir(tmp_path)
    from tests.test_torch_weights import voxcpm_state_dict
    from tts_tpu_torch.weights import loaders as tl

    d = str(tmp_path / "voxcpm")
    os.makedirs(d)
    tl.write_safetensors(os.path.join(d, "model.safetensors"),
                         voxcpm_state_dict(C.VOX_SMALL, np.random.default_rng(13), True))
    return d


def _port_standins(fam, d):
    """The port's stand-ins over the family's files loaded in fp32 (as
    chip_smoke.py's phase 15 builds them on the card)."""
    from tts_tpu_torch.parity import standins as SI
    from tts_tpu_torch.weights import indextts_loader, kani_loader, qwen_loader, voxcpm_loader

    cpu = dict(device="cpu")
    if fam == "kani":
        p, c = kani_loader.load_kani_lm(d, **cpu)
        cp, cc = kani_loader.load_nanocodec(os.path.join(d, "nano_codec.nemo"), **cpu)
        return SI.kani_standins(p, c, cp, cc)
    if fam == "qwen":
        p, c = qwen_loader.load_qwen_tts(d, **cpu)
        cp, cc = qwen_loader.load_qwen_codec(d, **cpu)
        return SI.qwen_standins(p, c, cp, cc)
    if fam == "indextts":
        p, c, _ = indextts_loader.load_indextts(d, **cpu)
        return SI.indextts_standins(p["gpt"], c)
    p, vae, c = voxcpm_loader.load_voxcpm(d, **cpu)
    return SI.voxcpm_standins(p, c, vae["dec"])


STAGES = {"kani": 3, "indextts": 4, "qwen": 4, "voxcpm": 5}


@pytest.mark.parametrize("fam", sorted(STAGES))
def test_session_family_on_files_against_standins(tmp_path, monkeypatch, small_defaults, fam):
    """run_session_family end to end on a family's checkpoint files, the
    graphs' stand-ins over the same files: the same functions on the same
    inputs, every stage within 1e-5 (IndexTTS's driver gets the GPT
    subtree of the pipeline tree)."""
    if fam == "indextts":
        # the writer's text table has 32 rows (TINY's vocabulary says 50)
        import tts_tpu_torch.weights.indextts_loader as il
        from tests.test_indextts import TINY
        from tts_tpu_torch.models.indextts import IndexTTSConfig

        cfg = IndexTTSConfig(**{**dataclasses.asdict(TINY), "num_text_tokens": 32})
        monkeypatch.setattr(il, "IndexTTSConfig", lambda: cfg)
    d = _family_dir(fam, tmp_path)
    table = _port_standins(fam, d)
    _touch(Path(d), *table)
    _opened(monkeypatch, table)
    res = trr.run_session_family(fam, d, device="cpu")
    assert res.mode == "session" and res.passed and res.mel_l1 <= 1e-5, res.line()
    # every stand-in ran but Qwen's last Embed_D (the frame ends on its head)
    idle = [f for f, s in table.items() if not s.calls]
    assert res.detail.count("PASS") == STAGES[fam]
    assert idle == ([f"Qwen_Embed_D_{(len(table) - 3) // 2 - 1}.onnx"] if fam == "qwen" else [])
