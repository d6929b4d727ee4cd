"""ONNX-oracle parity runner — the acceptance tool for mel-L1 <= 1e-2
(counterpart of tts_tpu/parity/run_reference.py).

Given a directory of reference-exported ONNX graphs + upstream checkpoints,
runs BOTH stacks on the same inputs and reports per-family mel-L1 against
the budget. A family is skipped with a reason when its pieces are missing.

Usage:
    python -m tts_tpu_torch.parity.run_reference --artifacts DIR
        [--families f5,kani,...] [--device cuda|cpu] [--json out.json]

The port runs on the card (`--device cuda`, the default) with bf16 weights,
or on the CPU with `--device cpu` and fp32 weights, as the port's CLI does;
the `run_*` functions take `device` and `dtype` keywords (fp32 on the card,
say). ONNX Runtime's CPU provider runs the reference's graphs.

Artifact layout (everything optional):

    DIR/bigvgan/
        BigVGAN.onnx               # reference export (Export_BigVGAN.py)
        config.json bigvgan_generator.pt   # upstream checkpoint
    DIR/f5/
        F5_Preprocess.onnx F5_Transformer.onnx F5_Decode.onnx
        model.safetensors vocab.txt    # upstream F5 checkpoint + vocab
        vocos/                         # Vocos checkpoint dir
        ref.wav ref.txt gen.txt        # inputs (defaults provided)
    DIR/<family>/                      # kani / indextts / qwen / voxcpm
        reference.wav                  # wav produced by the reference
                                       #   Inference_*.py on the same inputs
        inputs.json                    # {"text": ..., "ref_audio": ...,
                                       #   "cli_args": [...]} extra cli args
        <upstream checkpoint files>    # whatever tts_tpu_torch.cli --ckpt needs
        <exported graphs>              # optional: per-stage session mode

Two comparison modes:
  * session mode (bigvgan, f5; the AR families when their graphs are
    present, `sessions.py`): drive the exported graphs through onnxruntime
    directly with matched inputs — and matched noise for F5 (the
    F5_Preprocess graph emits its noise tensor, which the port's DiT loop
    starts from), so the comparison is deterministic.
  * wav mode (the AR families): the port's synthesis runs through its
    public CLI (`tts_tpu_torch.cli <family> --ckpt ...`, the CLI's device
    and dtype) and the output is compared against `reference.wav` via
    log-mel L1.

One deviation from tts_tpu on purpose: tts_tpu's `run_all` turns an
exception into a skip and `main` then exits 0, so a kernel that fails to
build or launch would pass as a skip. Here an exception is a result of
mode "error" with its text, and `main` exits 1 when any result is one.
Missing artifacts and a missing onnxruntime skip as in tts_tpu.

Reference call stacks these drivers mirror: F5
F5_TTS/F5-TTS-ONNX-Inference.py:221-316 (3-session NFE loop), BigVGAN
Export_BigVGAN.py:37-49,165-177 (single-graph smoke run).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import asdict, dataclass

import numpy as np
import torch

MEL_L1_BUDGET = 1e-2
FAMILIES = ("bigvgan", "f5", "kani", "indextts", "qwen", "voxcpm")


@dataclass
class ParityResult:
    family: str
    mode: str                    # 'session' | 'wav' | 'skipped' | 'error'
    mel_l1: float | None = None
    budget: float = MEL_L1_BUDGET
    passed: bool | None = None
    detail: str = ""

    def line(self) -> str:
        if self.mode == "skipped":
            return f"{self.family:10s} SKIP   {self.detail}"
        if self.mode == "error":
            return f"{self.family:10s} ERROR  {self.detail}"
        status = "PASS" if self.passed else "FAIL"
        return (f"{self.family:10s} {status}   mel_l1={self.mel_l1:.3e} "
                f"(budget {self.budget:g}, {self.mode}) {self.detail}")


def _have_ort():
    try:
        import onnxruntime  # noqa: F401
        return True
    except ImportError:
        return False


def _session(path: str):
    import onnxruntime as ort

    opts = ort.SessionOptions()
    opts.log_severity_level = 3
    return ort.InferenceSession(path, opts, providers=["CPUExecutionProvider"])


def _missing(d: str, *names: str) -> list[str]:
    return [n for n in names
            if not (os.path.exists(os.path.join(d, n)) or
                    glob.glob(os.path.join(d, n)))]


def _device_dtype(device, dtype) -> tuple[torch.device, torch.dtype]:
    """The device and the weights' dtype: the CLI's rule (bf16 on a card,
    fp32 on the CPU) where dtype is None. A CUDA device without a card
    raises: nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available "
                           "(torch.cuda.is_available() is False)")
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return device, dtype


def _pcm16(wav: torch.Tensor) -> np.ndarray:
    from .sessions import _pcm16 as pcm16

    return pcm16(wav).cpu().numpy().reshape(-1)


# ------------------------------------------------------------------ BigVGAN

@torch.no_grad()
def run_bigvgan(art: str, device="cuda", dtype=None) -> ParityResult:
    """Deterministic vocoder parity on the benchmark mel (1, 100, 512)
    (the reference smoke input, Export_BigVGAN.py:165)."""
    miss = _missing(art, "*.onnx", "config.json", "bigvgan_generator.pt")
    if miss:
        return ParityResult("bigvgan", "skipped", detail=f"missing {miss}")
    if not _have_ort():
        return ParityResult("bigvgan", "skipped",
                            detail="onnxruntime not installed")
    from ..models.bigvgan import bigvgan_apply
    from ..weights.loaders import load_bigvgan
    from .compare import wav_mel_l1

    device, dtype = _device_dtype(device, dtype)
    params, cfg = load_bigvgan(art, dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((1, cfg.num_mels, 512)).astype(np.float32)

    sess = _session(glob.glob(os.path.join(art, "*.onnx"))[0])
    ref_wav = sess.run(None, {sess.get_inputs()[0].name: mel})[0].reshape(-1)

    melt = torch.from_numpy(mel.transpose(0, 2, 1).copy()).to(device, dtype)
    ours = _pcm16(bigvgan_apply(params, melt, cfg))
    l1 = wav_mel_l1(ours, ref_wav, sample_rate=cfg.sample_rate, device=device)
    return ParityResult("bigvgan", "session", l1, passed=l1 <= MEL_L1_BUDGET)


# ----------------------------------------------------------------------- F5

def _feed_by_name(sess, pool: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Select the session's inputs out of a name->tensor pool."""
    feed = {}
    for inp in sess.get_inputs():
        if inp.name not in pool:
            raise KeyError(
                f"ONNX input {inp.name!r} not found among {sorted(pool)}")
        feed[inp.name] = pool[inp.name]
    return feed


@torch.no_grad()
def run_f5(art: str, device="cuda", dtype=None) -> ParityResult:
    """Matched-noise deterministic parity: ONNX 3-session pipeline
    (F5-TTS-ONNX-Inference.py:247-311) vs the port's DiT loop + Vocos
    decode fed the SAME noise tensor the preprocess graph drew. Primary
    metric is L1 on the denoised mel (the exact-path acceptance number);
    the decoded waveforms are also compared."""
    need = ("F5_Preprocess.onnx", "F5_Transformer.onnx", "F5_Decode.onnx",
            "*.safetensors", "vocab.txt", "vocos")
    miss = _missing(art, *need)
    if miss:
        return ParityResult("f5", "skipped", detail=f"missing {miss}")
    if not _have_ort():
        return ParityResult("f5", "skipped",
                            detail="onnxruntime not installed")
    import torch.nn.functional as F

    from ..audio.mel import MelSpectrogram
    from ..audio.wav import read_wav
    from ..frontend.f5_text import convert_char_to_pinyin, f5_duration, text_to_ids
    from ..models.f5 import f5_step, text_embedding
    from ..models.vocos import vocos_decode
    from ..weights.f5_loader import load_f5, load_vocos
    from .compare import _fp32_products, mel_l1, wav_mel_l1

    ref_wav_path = os.path.join(art, "ref.wav")
    ref_text = "Some call me nature, others call me mother nature."
    gen_text = "The quick brown fox jumps over the lazy dog."
    if os.path.exists(os.path.join(art, "ref.txt")):
        ref_text = open(os.path.join(art, "ref.txt")).read().strip()
    if os.path.exists(os.path.join(art, "gen.txt")):
        gen_text = open(os.path.join(art, "gen.txt")).read().strip()
    if not os.path.exists(ref_wav_path):
        return ParityResult("f5", "skipped", detail="missing ref.wav")

    device, dtype = _device_dtype(device, dtype)
    params, cfg, vocab = load_f5(
        glob.glob(os.path.join(art, "*.safetensors"))[0],
        os.path.join(art, "vocab.txt"), dtype=dtype, device=device)
    vparams, vcfg = load_vocos(os.path.join(art, "vocos"), dtype=dtype, device=device)

    audio, _ = read_wav(ref_wav_path, target_rate=cfg.sample_rate)
    audio_i16 = audio.astype(np.int16).reshape(1, 1, -1)
    chars = convert_char_to_pinyin([ref_text + gen_text])[0]
    ids = text_to_ids(chars, vocab)
    ref_signal_len, duration = f5_duration(
        audio_i16.shape[-1], ref_text, gen_text, cfg.hop)
    duration = min(duration, cfg.max_signal_len)

    # --- ONNX pipeline ---
    sess_a = _session(os.path.join(art, "F5_Preprocess.onnx"))
    sess_b = _session(os.path.join(art, "F5_Transformer.onnx"))
    sess_c = _session(os.path.join(art, "F5_Decode.onnx"))

    a_in = {i.name: v for i, v in zip(
        sess_a.get_inputs(),
        [audio_i16, ids, np.array([duration], np.int64)])}
    a_out_names = [o.name for o in sess_a.get_outputs()]
    pool = dict(zip(a_out_names, sess_a.run(None, a_in)))
    # the preprocess graph emits the noise it drew; find it by shape
    noise_name = next(
        n for n, v in pool.items()
        if v.ndim == 3 and v.shape[-1] == cfg.n_mels and n != "mel")
    time_name = sess_b.get_inputs()[-1].name
    pool[time_name] = np.array([0], np.int32)

    nfe_noise = pool[noise_name].copy()
    for _ in range(cfg.nfe_steps - 1):
        out = sess_b.run(None, _feed_by_name(sess_b, pool))
        pool[noise_name] = out[0]
        pool[time_name] = out[1]
    ref_denoised = pool[noise_name]

    c_in = {i.name: v for i, v in zip(
        sess_c.get_inputs(),
        [ref_denoised, np.array([ref_signal_len], np.int64)])}
    ref_out = sess_c.run(None, c_in)[0].reshape(-1)

    # --- the port, same noise: the Euler loop over dit_forward with the
    # keys masked at the duration, as tts_tpu's scan ---
    frames = nfe_noise.shape[1]
    with _fp32_products(device):
        melspec = MelSpectrogram(cfg.sample_rate, cfg.n_fft, cfg.hop,
                                 cfg.win_length, cfg.n_mels)
        mel = melspec(torch.from_numpy(audio.reshape(1, -1).astype(np.float32) / 32768.0)
                      .to(device))
    fa = min(mel.shape[1], frames)
    mel = F.pad(mel[:, :fa], (0, 0, 0, frames - fa))
    frame_idx = torch.arange(frames, device=device)[None, :, None]
    mel = torch.where(frame_idx < ref_signal_len, mel, 0.0)
    in_len = (frame_idx < duration).float()
    text, text_drop = text_embedding(params, torch.from_numpy(ids).to(device), frames, cfg)
    cat = torch.cat([mel, text * in_len], dim=-1)
    cat_drop = torch.cat([torch.zeros_like(mel), text_drop * in_len], dim=-1)
    x = torch.from_numpy(nfe_noise).to(device).float()
    for idx in range(cfg.nfe_steps - 1):
        x = f5_step(params, x, cat, cat_drop, cfg, idx, kv_len=duration) * in_len
    wav = vocos_decode(vparams, x[:, ref_signal_len:], vcfg)

    l1_mel = mel_l1(x.cpu().numpy(), ref_denoised)
    l1_wav = wav_mel_l1(_pcm16(wav), ref_out, sample_rate=cfg.sample_rate, device=device)
    return ParityResult(
        "f5", "session", l1_mel, passed=l1_mel <= MEL_L1_BUDGET,
        detail=f"wav mel_l1={l1_wav:.3e}")


# ------------------------------------------------------------- session mode
# (AR families: per-stage graph comparison — localizes a wav-mode failure)

# graph-file glob -> session-dict key, per family (reference export names,
# Export_Kani_TTS.py:19-26 / Export_IndexTTS.py A-F /
# Export_Qwen_TTS_ONNX.py:23-46 / v1.5/Export_VoxCPM_ONNX.py:16-24)
_SESSION_GRAPHS = {
    "kani": {"*Embed*.onnx": "embed", "*Main*.onnx": "main",
             "*Codec*.onnx": "codec"},
    "indextts": {"*_B.onnx": "b", "*_C.onnx": "c", "*_E.onnx": "e"},
    "qwen": {"*Main*.onnx": "main", "*Predictor*.onnx": "predictor",
             "*Decoder*.onnx": "decoder",
             "*LmHead_*.onnx": "lm_head_{}", "*Embed_D_*.onnx":
             "embed_d_{}"},
    "voxcpm": {"*Feat_Encoder*.onnx": "feat_encoder", "*Main*.onnx": "main",
               "*Feat_Decoder*.onnx": "feat_decoder",
               "*VAE_Decode*.onnx": "vae_decoder"},
}


def _collect_sessions(family: str, art: str) -> dict:
    """Map the artifact dir's ONNX graphs onto the session-driver keys.
    Numbered graphs (LmHead_3.onnx) expand their index into the key."""
    import re

    sessions = {}
    for pattern, key in _SESSION_GRAPHS[family].items():
        for path in glob.glob(os.path.join(art, pattern)):
            if "{}" in key:
                m = re.search(r"_(\d+)\.onnx$", path)
                if m:
                    sessions[key.format(m.group(1))] = _session(path)
            else:
                sessions[key] = _session(path)
    return sessions


def run_session_family(family: str, art: str, device="cuda",
                       dtype=None) -> ParityResult | None:
    """Per-stage session parity (parity/sessions.py) when the family's
    exported graphs AND an upstream checkpoint are both present; returns
    None when the artifact set has no graphs (wav mode only)."""
    if not _have_ort():
        return None
    sessions = _collect_sessions(family, art)
    if not sessions:
        return None
    from . import sessions as S

    device, dtype = _device_dtype(device, dtype)
    if family == "kani":
        from ..weights.kani_loader import load_kani_lm, load_nanocodec

        params, cfg = load_kani_lm(art, dtype=dtype, device=device)
        nemo = glob.glob(os.path.join(art, "*.nemo"))
        cparams = ccfg = None
        if nemo:
            cparams, ccfg = load_nanocodec(nemo[0], dtype=dtype, device=device)
        diffs = S.kani_session_stages(sessions, params, cfg, cparams, ccfg)
    elif family == "indextts":
        from ..weights.indextts_loader import load_indextts

        params, cfg, _ = load_indextts(art, dtype=dtype, device=device)
        # the driver's stages are the GPT's (tts_tpu hands it the whole
        # pipeline tree, where its stage functions find no GPT keys)
        diffs = S.indextts_session_stages(sessions, params["gpt"], cfg)
    elif family == "qwen":
        from ..weights.qwen_loader import load_qwen_codec, load_qwen_tts

        params, cfg = load_qwen_tts(art, dtype=dtype, device=device)
        cparams, ccfg = load_qwen_codec(art, dtype=dtype, device=device)
        diffs = S.qwen_session_stages(sessions, params, cfg, cparams, ccfg)
    elif family == "voxcpm":
        from ..weights.voxcpm_loader import load_voxcpm

        params, vae_params, cfg = load_voxcpm(art, dtype=dtype, device=device)
        diffs = S.voxcpm_session_stages(
            sessions, params, cfg,
            vae_params=vae_params.get("dec", vae_params))
    else:
        return None
    worst = max((d.max_abs for d in diffs), default=0.0)
    detail = "; ".join(d.line().strip() for d in diffs)
    return ParityResult(family, "session", worst,
                        passed=all(d.ok for d in diffs), detail=detail)


# ----------------------------------------------------------------- wav mode

def run_wav_family(family: str, art: str, device="cuda") -> ParityResult:
    """Synthesize through the port's CLI (`--device`, its dtype rule) with
    the family checkpoint in `art` and compare to the reference-generated
    waveform."""
    ref_path = os.path.join(art, "reference.wav")
    if not os.path.exists(ref_path):
        return ParityResult(family, "skipped", detail="missing reference.wav")
    inputs_path = os.path.join(art, "inputs.json")
    spec = json.load(open(inputs_path)) if os.path.exists(inputs_path) else {}

    from ..audio.wav import read_wav
    from ..cli import main as cli_main
    from .compare import wav_mel_l1

    device = torch.device(device)
    out_path = os.path.join(art, "_ours.wav")
    argv = ["--device", device.type, family, "--ckpt", art, "--out", out_path]
    if "text" in spec:
        argv += ["--text", spec["text"]]
    if "ref_audio" in spec:
        argv += ["--ref-audio", os.path.join(art, spec["ref_audio"])]
    if "ref_text" in spec:
        argv += ["--ref-text", spec["ref_text"]]
    argv += spec.get("cli_args", [])
    rc = cli_main(argv)
    if rc not in (0, None):
        return ParityResult(family, "skipped", detail=f"cli failed rc={rc}")

    ref_wav, ref_sr = read_wav(ref_path)
    our_wav, our_sr = read_wav(out_path, target_rate=ref_sr)
    l1 = wav_mel_l1(our_wav, ref_wav, sample_rate=ref_sr, device=device)
    return ParityResult(family, "wav", l1, passed=l1 <= MEL_L1_BUDGET)


# --------------------------------------------------------------------- main

def run_all(artifacts: str, families=FAMILIES, device="cuda",
            dtype=None) -> list[ParityResult]:
    """Every family in turn; an exception is a result of mode "error"."""
    results = []
    for fam in families:
        art = os.path.join(artifacts, fam)
        if not os.path.isdir(art):
            results.append(ParityResult(fam, "skipped",
                                        detail=f"no {art}/ directory"))
            continue
        try:
            if fam == "bigvgan":
                results.append(run_bigvgan(art, device, dtype))
            elif fam == "f5":
                results.append(run_f5(art, device, dtype))
            else:
                sess = run_session_family(fam, art, device, dtype)
                if sess is not None:
                    results.append(sess)
                results.append(run_wav_family(fam, art, device))
        except Exception as e:  # reported, and main exits 1 for it
            results.append(ParityResult(fam, "error", detail=f"error: {e!r}"))
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--artifacts", required=True,
                   help="root dir of per-family ONNX graphs + checkpoints")
    p.add_argument("--families", default=",".join(FAMILIES))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the port runs: the card (bf16 weights, the "
                        "default; raises without one) or the CPU (fp32)")
    p.add_argument("--json", help="write results as JSON")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(torch.cuda.is_available() is False); pass --device cpu")

    results = run_all(args.artifacts, tuple(args.families.split(",")), args.device)
    for r in results:
        print(r.line())
    if args.json:
        with open(args.json, "w") as f:
            json.dump([asdict(r) for r in results], f, indent=2)
    ran = [r for r in results if r.mode != "skipped"]
    return 0 if all(r.mode != "error" and r.passed for r in ran) else 1


if __name__ == "__main__":
    raise SystemExit(main())
