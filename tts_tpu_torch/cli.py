"""Command-line synthesis: `python -m tts_tpu_torch.cli <family> ...` (the
`tts-tpu-torch` script); counterpart of tts_tpu/cli.py.

One entry point that loads the upstream checkpoints (weights/*), runs the
family's pipeline and writes a WAV. Without --ckpt it runs random weights
from seeded generators at tts_tpu's small smoke configs: audio is noise.

Device and dtype: every command runs on the card (`--device cuda`, the
default) with bf16 weights, or on the CPU with `--device cpu` and fp32
weights, whatever the weight source (--ckpt, --npz or random). With no
card `--device cuda` raises; nothing falls back to the CPU.

Not ported: tts_tpu's `bench` command (it drives bench.py, a JAX script)
and `--compile-cache` (an XLA compilation cache).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _write(path: str, wav: np.ndarray, sr: int, report=None) -> None:
    from .audio.wav import write_wav

    write_wav(path, wav, sr)
    print(f"wrote {path} ({len(wav) / sr:.2f}s @ {sr} Hz)")
    if report is not None:
        print(report.table())


def _device(args):
    """(torch device, weight dtype) of a command: bf16 on the card, fp32 on
    the CPU. `--device cuda` without a card raises."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(torch.cuda.is_available() is False); pass --device cpu "
                         "to run on the CPU")
    dev = torch.device(args.device)
    return dev, (torch.bfloat16 if dev.type == "cuda" else torch.float32)


def _generator(dev, seed: int):
    import torch

    return torch.Generator(dev).manual_seed(seed)


def _load_tokenizer(ckpt_dir: str):
    """Checkpoint tokenizer, preferring the self-contained reader.

    Order: frontend/hf_tokenizer.py on the checkpoint's tokenizer.json
    (exact ids, zero wheels) -> transformers AutoTokenizer (slow-format
    checkpoints) -> raise."""
    import os

    from .frontend.hf_tokenizer import HFTokenizer

    if os.path.exists(os.path.join(ckpt_dir, "tokenizer.json")):
        try:
            return HFTokenizer.from_pretrained(ckpt_dir)
        except ValueError as e:
            print(f"note: self-contained tokenizer reader declined "
                  f"({e}); trying transformers")
    try:
        from transformers import AutoTokenizer
    except ImportError:
        raise SystemExit(
            f"no readable tokenizer.json under {ckpt_dir} and the "
            "transformers wheel is unavailable: token ids cannot match "
            "the upstream tokenizer")
    return AutoTokenizer.from_pretrained(ckpt_dir)


def _save_bundle(path: str, arrays: dict, configs: dict,
                 extra: dict | None = None) -> None:
    """Persist folded param trees and their configs: arrays -> .npz (the
    layout of weights/save.py, which both packages read), configs and extra
    -> .json. Config classes are named in tts_tpu's form
    ("tts_tpu.models.kani:KaniConfig"), so either package's CLI reads the
    bundle."""
    import json

    from .weights.save import config_to_dict, save_params

    save_params(path, arrays)
    meta = {}
    for k, c in configs.items():
        mod = type(c).__module__.split(".", 1)[1]
        meta[k] = {"cls": f"tts_tpu.{mod}:{type(c).__name__}", "data": config_to_dict(c)}
    if extra:
        meta["__extra__"] = extra
    with open(path + ".json", "w") as f:
        f.write(json.dumps(meta))
    print(f"saved fused params to {path}")


def _to_host(node):
    """A loaded bundle tree with its bf16 leaves as fp32 numpy arrays (the
    host form `weights.place` casts and checks)."""
    import torch

    if isinstance(node, dict):
        return {k: _to_host(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_host(v) for v in node]
    if isinstance(node, torch.Tensor):
        return (node.float() if node.dtype == torch.bfloat16 else node).numpy()
    return node


def _load_bundle(path: str, device, dtype):
    """Returns (arrays, configs, extra): each tree on `device`, its floats
    in `dtype`. Config classes named by either package resolve to this
    package's."""
    import importlib
    import json

    from .weights.loaders import place
    from .weights.save import config_from_dict, load_params

    arrays = {k: place(_to_host(v), device, dtype)
              for k, v in load_params(path, device="cpu").items()}
    with open(path + ".json") as f:
        meta = json.loads(f.read())
    extra = meta.pop("__extra__", {})
    configs = {}
    for k, m in meta.items():
        mod, name = m["cls"].split(":")
        top, rest = mod.split(".", 1)
        if top not in ("tts_tpu", "tts_tpu_torch"):
            raise ValueError(f"{path}.json: config class {m['cls']!r} is not a "
                             f"tts_tpu config")
        cls = getattr(importlib.import_module(f"{__package__}.{rest}"), name)
        configs[k] = config_from_dict(cls, m["data"])
    return arrays, configs, extra


# ------------------------------------------------------------ family models
# Each returns the family's params and configs from --ckpt or random weights
# (tts_tpu's smoke configs); the commands and `serve` share them.

def _f5_models(args, dev, dtype):
    from .models.f5 import F5Config, init_params
    from .models.vocos import VocosConfig, init_params as vocos_init

    if args.ckpt:
        from .weights.f5_loader import load_f5, load_vocos

        params, cfg, vocab = load_f5(args.ckpt, args.vocab, dtype=dtype, device=dev)
        vparams, vcfg = load_vocos(args.vocoder, dtype=dtype, device=dev)
    else:
        cfg, vcfg = F5Config(), VocosConfig()
        params = init_params(cfg, _generator(dev, 0), dtype)
        vparams = vocos_init(vcfg, _generator(dev, 1), dtype)
        vocab = {" ": 0}
        print("note: random weights (no --ckpt) — audio will be noise")
    return params, cfg, vocab, vparams, vcfg


def _f5_pipeline(params, cfg, vocab, vparams, vcfg, **kw):
    from .models.f5 import F5Model
    from .models.vocos import VocosModel
    from .runtime.f5 import F5Pipeline

    return F5Pipeline(F5Model(cfg, params), vocab, VocosModel(vcfg, vparams), **kw)


def _kani_models(args, dev, dtype, max_seq_len: int):
    from .models.kani import KaniConfig, init_params
    from .models.nanocodec import NanoCodecConfig, init_params as codec_init

    if args.ckpt:
        from .weights.kani_loader import load_kani_lm, load_nanocodec

        params, cfg = load_kani_lm(args.ckpt, dtype=dtype, device=dev)
        cparams, ccfg = load_nanocodec(args.codec, dtype=dtype, device=dev)
    else:
        cfg = KaniConfig(hidden_size=64, num_heads=4, num_kv_heads=2,
                         head_dim=16, ffn_dim=128, vocab_size=80538,
                         max_seq_len=max_seq_len)
        ccfg = NanoCodecConfig()
        params = init_params(cfg, _generator(dev, 0), dtype)
        cparams = codec_init(ccfg, _generator(dev, 1), dtype)
        print("note: random weights (no --ckpt) — audio will be noise")
    return params, cfg, cparams, ccfg


def _indextts_models(args, dev, dtype):
    from .models.bigvgan import BigVGANConfig
    from .models.bigvgan import init_params as bigvgan_init
    from .models.indextts import (IndexTTSConfig, init_conformer_params, init_ecapa_params,
                                  init_gpt_params, init_perceiver_params)

    if args.ckpt:
        from .weights.indextts_loader import load_indextts

        return load_indextts(args.ckpt, dtype=dtype, device=dev)
    import torch

    cfg = IndexTTSConfig(enc_layers=2, gpt_layers=2, gpt_dim=512,
                         gpt_heads=8, num_latents=32)
    vcfg = BigVGANConfig(num_mels=cfg.gpt_dim, upsample_initial_channel=256,
                         use_tanh_at_final=True, use_bias_at_final=True)
    c0 = vcfg.upsample_initial_channel

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    params = {
        "conformer": init_conformer_params(cfg, _generator(dev, 0), dtype=dtype),
        "perceiver": init_perceiver_params(cfg, _generator(dev, 1), dtype),
        "ecapa": init_ecapa_params(cfg, _generator(dev, 2), dtype),
        "gpt": init_gpt_params(cfg, _generator(dev, 3), dtype),
        "bigvgan": bigvgan_init(vcfg, _generator(dev, 4), dtype),
        "cond_layer": {"w": zeros(cfg.speaker_embed_dim, c0), "b": zeros(c0)},
        "conds": [{"w": zeros(cfg.speaker_embed_dim, c), "b": zeros(c)}
                  for c in vcfg.stage_channels],
    }
    print("note: random weights (no --ckpt) — audio will be noise")
    return params, cfg, vcfg


def _qwen_models(args, dev, dtype):
    from .models.qwen_codec import QwenCodecDecoderConfig
    from .models.qwen_codec import init_decoder_params as codec_init
    from .models.qwen_tts import (Qwen3StackConfig, QwenTTSConfig, init_predictor_params,
                                  init_talker_params)

    if args.ckpt:
        from .weights.qwen_loader import load_qwen_codec, load_qwen_tts

        params, cfg = load_qwen_tts(args.ckpt, dtype=dtype, device=dev)
        cparams, ccfg = load_qwen_codec(args.ckpt, dtype=dtype, device=dev)
        return params, cfg, cparams, ccfg
    stack = Qwen3StackConfig(hidden_size=64, num_heads=4, num_kv_heads=2,
                             head_dim=16, ffn_dim=128, num_layers=2,
                             max_seq_len=512)
    cfg = QwenTTSConfig(talker=stack, predictor=stack)
    ccfg = QwenCodecDecoderConfig(
        num_quantizers=cfg.num_code_groups, codebook_size=64,
        codebook_dim=16, rvq_dim=8, latent_dim=24, decoder_dim=32,
        upsampling_ratios=(2,), upsample_rates=(4, 2), hidden_size=24,
        num_heads=2, num_kv_heads=2, head_dim=12, ffn_dim=48,
        num_layers=2, max_seq_len=256)
    params = {**init_talker_params(cfg, _generator(dev, 0), dtype),
              **init_predictor_params(cfg, _generator(dev, 1), dtype)}
    cparams = codec_init(ccfg, _generator(dev, 2), dtype)
    print("note: random weights (no --ckpt) — audio will be noise")
    return params, cfg, cparams, ccfg


def _voxcpm_models(args, dev, dtype):
    from .models.voxcpm import (LlamaStackConfig, VaeConfig, VoxCPMConfig, init_params,
                                init_vae_params, voxcpm_v2_config)

    if args.ckpt:
        from .weights.voxcpm_loader import load_voxcpm

        return load_voxcpm(
            args.ckpt, cfg=voxcpm_v2_config() if args.v2 else None, dtype=dtype,
            use_mup=args.v2, scale_emb=12.0 if args.v2 else 1.0,
            scale_depth=1.4 if args.v2 else 1.0, device=dev)
    tiny = LlamaStackConfig(hidden_size=32, num_heads=2, num_kv_heads=1,
                            head_dim=16, ffn_dim=64, num_layers=2,
                            max_seq_len=512)
    cfg = VoxCPMConfig(
        base=tiny, residual=tiny,
        feat_encoder=LlamaStackConfig(
            hidden_size=24, num_heads=2, num_kv_heads=1, head_dim=12,
            ffn_dim=48, num_layers=1, max_seq_len=8),
        estimator=LlamaStackConfig(
            hidden_size=24, num_heads=2, num_kv_heads=1, head_dim=12,
            ffn_dim=48, num_layers=1, max_seq_len=16),
        vae=VaeConfig(d_model=4, latent_dim=8, strides=(2, 4),
                      decoder_channels=16),
        patch_size=4, chunk_size=8, fsq_dim=8, vocab_size=128,
        cfm_steps=4)
    params = init_params(cfg, _generator(dev, 0), dtype)
    vae_params = init_vae_params(cfg.vae, _generator(dev, 1), dtype)
    print("note: random weights (no --ckpt) — audio will be noise")
    return params, vae_params, cfg


# ----------------------------------------------------------------- commands

def cmd_f5(args) -> None:
    from .audio.wav import read_audio
    from .utils.timing import SynthesisReport

    dev, dtype = _device(args)
    if args.npz:
        # the folded-params fast path: skips the checkpoint parsing and folds
        arrays, cfgs, extra = _load_bundle(args.npz, dev, dtype)
        params, vparams = arrays["f5"], arrays["vocos"]
        if "ada_table" not in params:
            # bundles from before the half-split RoPE fold carry interleaved
            # rope tables and unpermuted q/k columns
            raise SystemExit(
                f"{args.npz} was saved by an older layout (no ada_table / "
                "half-split rope fold); re-export it with --ckpt --save-npz")
        cfg, vcfg = cfgs["cfg"], cfgs["vcfg"]
        vocab = extra["vocab"]
    else:
        params, cfg, vocab, vparams, vcfg = _f5_models(args, dev, dtype)
    if args.save_npz:
        _save_bundle(args.save_npz, {"f5": params, "vocos": vparams},
                     {"cfg": cfg, "vcfg": vcfg}, {"vocab": vocab})
    pipe = _f5_pipeline(params, cfg, vocab, vparams, vcfg, seed=args.seed,
                        quantize=args.quantize)
    audio, _ = read_audio(args.ref_audio, target_rate=cfg.sample_rate)
    wav, stats = pipe.synthesize(audio, args.ref_text, args.gen_text, speed=args.speed)
    rep = SynthesisReport("f5_tts", stats.audio_s, stats.wall_s)
    _write(args.out, wav, cfg.sample_rate, rep)


def cmd_kani(args) -> None:
    from .runtime.kani import KaniDecodeConfig, KaniPipeline
    from .utils.timing import SynthesisReport

    dev, dtype = _device(args)
    if args.npz:
        arrays, cfgs, _ = _load_bundle(args.npz, dev, dtype)
        params, cparams = arrays["lm"], arrays["codec"]
        cfg, ccfg = cfgs["cfg"], cfgs["ccfg"]
        tok = None
    else:
        params, cfg, cparams, ccfg = _kani_models(args, dev, dtype, max_seq_len=256)
        tok = _load_tokenizer(args.ckpt) if args.ckpt else None
    if args.save_npz:
        _save_bundle(args.save_npz, {"lm": params, "codec": cparams},
                     {"cfg": cfg, "ccfg": ccfg})
    dcfg = KaniDecodeConfig(
        use_beam=args.beam > 1, beam_size=args.beam,
        repeat_penalty=args.penalty, max_new_tokens=args.max_tokens)
    pipe = KaniPipeline(params, cfg, cparams, ccfg, dcfg, tokenizer=tok,
                        quantize=args.quantize)
    if tok is not None:
        wav, stats = pipe.synthesize(args.text, speaker=args.speaker)
    else:
        ids = np.array([[3, 9, 27, 5]], np.int32)
        wav, stats = pipe.synthesize_ids(ids)
    rep = SynthesisReport("kani_tts", len(wav) / ccfg.sample_rate,
                          stats["wall_s"], tokens=stats["tokens"])
    _write(args.out, wav, ccfg.sample_rate, rep)


def cmd_indextts(args) -> None:
    from .audio.wav import read_audio
    from .frontend.indextts_text import IndexTTSTokenizer
    from .runtime.indextts import IndexTTSPipeline
    from .utils.timing import SynthesisReport

    dev, dtype = _device(args)
    if args.npz:
        arrays, cfgs, _ = _load_bundle(args.npz, dev, dtype)
        params = arrays["params"]
        cfg, vcfg = cfgs["cfg"], cfgs["vcfg"]
        tok_path = None
    else:
        params, cfg, vcfg = _indextts_models(args, dev, dtype)
        tok_path = args.ckpt + "/bpe.model" if args.ckpt else None
    if args.save_npz:
        _save_bundle(args.save_npz, {"params": params}, {"cfg": cfg, "vcfg": vcfg})
    if tok_path is None and not args.allow_degraded:
        raise SystemExit(
            "no checkpoint tokenizer: the char-level fallback produces ids "
            "that do NOT match the upstream tokenizer — pass "
            "--allow-degraded to run the demo anyway")
    pipe = IndexTTSPipeline(params, cfg, vcfg, quantize=args.quantize)
    audio, _ = read_audio(args.ref_audio, target_rate=24000)
    ref = pipe.encode_reference(audio)
    tok = IndexTTSTokenizer(tok_path, allow_degraded=tok_path is None)
    wav, stats = pipe.synthesize(args.text, ref, tokenizer=tok, max_gen=args.max_tokens)
    rep = SynthesisReport("indextts", len(wav) / 24000, sum(s.wall_s for s in stats),
                          tokens=sum(s.tokens for s in stats))
    _write(args.out, wav, 24000, rep)


def cmd_qwen(args) -> None:
    from .runtime.qwen import QwenDecodeConfig, QwenTTSPipeline
    from .utils.timing import SynthesisReport

    dev, dtype = _device(args)
    if args.npz:
        arrays, cfgs, _ = _load_bundle(args.npz, dev, dtype)
        params, cparams = arrays["lm"], arrays["codec"]
        cfg, ccfg = cfgs["cfg"], cfgs["ccfg"]
    else:
        params, cfg, cparams, ccfg = _qwen_models(args, dev, dtype)
    if args.ckpt:
        tok = _load_tokenizer(args.ckpt)
        ids = tok(args.text, return_tensors="np")["input_ids"].astype("int32")
    else:
        ids = np.array([[5, 9, 13, 2]], np.int32)
    if args.save_npz:
        _save_bundle(args.save_npz, {"lm": params, "codec": cparams},
                     {"cfg": cfg, "ccfg": ccfg})
    pipe = QwenTTSPipeline(params, cfg, cparams, ccfg,
                           QwenDecodeConfig(max_frames=args.max_frames,
                                            use_beam=args.beam > 1,
                                            beam_size=max(args.beam, 2),
                                            beam_top_k=args.beam_top_k),
                           quantize=args.quantize)
    if args.language:
        from .runtime.qwen import resolve_voice

        language_id, speaker_id = resolve_voice(args.language, args.speaker)
    else:
        language_id, speaker_id = args.language_id, args.speaker_id
    instruct_ids = None
    if args.instruct:
        if not args.ckpt:
            raise SystemExit("--instruct needs --ckpt (tokenizer)")
        prompt = "<|im_start|>system\n" + args.instruct + "<|im_end|>\n"
        instruct_ids = tok(prompt, return_tensors="np")["input_ids"].astype("int32")
    wav, stats = pipe.synthesize_ids(ids, language_id=language_id, speaker_id=speaker_id,
                                     instruct_ids=instruct_ids)
    sr = pipe.output_sample_rate
    rep = SynthesisReport("qwen_tts", len(wav) / sr, stats["wall_s"])
    _write(args.out, wav, sr, rep)


def cmd_voxcpm(args) -> None:
    from .audio.wav import read_audio
    from .runtime.voxcpm import VoxCPMDecodeConfig, VoxCPMPipeline
    from .utils.timing import SynthesisReport

    dev, dtype = _device(args)
    if args.npz:
        arrays, cfgs, _ = _load_bundle(args.npz, dev, dtype)
        params, vae_params = arrays["lm"], arrays["vae"]
        cfg = cfgs["cfg"]
    else:
        params, vae_params, cfg = _voxcpm_models(args, dev, dtype)
    if args.ckpt:
        from .frontend.voxcpm_text import mask_multichar_chinese_tokens, normalize_voxcpm_text

        ctok = mask_multichar_chinese_tokens(_load_tokenizer(args.ckpt))
        ids = np.asarray([ctok(normalize_voxcpm_text(args.text))], np.int32)
        p_ids = (np.asarray([ctok(normalize_voxcpm_text(args.prompt_text))], np.int32)
                 if args.prompt_text else np.zeros((1, 0), np.int32))
    else:
        ids = np.array([[11, 13, 17, 19]], np.int32)
        p_ids = np.zeros((1, 0), np.int32)
    if args.save_npz:
        _save_bundle(args.save_npz, {"lm": params, "vae": vae_params}, {"cfg": cfg})
    pipe = VoxCPMPipeline(params, cfg, vae_params,
                          VoxCPMDecodeConfig(max_latents=args.max_latents),
                          quantize=args.quantize)
    prompt_audio = None
    if args.prompt_audio:
        prompt_audio, _ = read_audio(args.prompt_audio, target_rate=cfg.sample_rate)
    wav, stats = pipe.synthesize_ids(p_ids, ids, prompt_audio)
    sr = pipe.output_sample_rate
    rep = SynthesisReport("voxcpm", len(wav) / sr, stats["wall_s"])
    _write(args.out, wav, sr, rep)


# ------------------------------------------------------------------ serving

def _serve_kani_pipeline(args):
    from .runtime.kani import KaniDecodeConfig, KaniPipeline

    dev, dtype = _device(args)
    params, cfg, cparams, ccfg = _kani_models(args, dev, dtype, max_seq_len=1024)
    return KaniPipeline(params, cfg, cparams, ccfg,
                        KaniDecodeConfig(max_new_tokens=args.max_tokens),
                        quantize=args.quantize), ccfg


def _noise_reference(rate: int) -> np.ndarray:
    print("note: no --ref-audio — conditioning on noise")
    return np.random.default_rng(0).standard_normal(rate).astype(np.float32) * 0.05


def _serve_continuous(args):
    """A continuous-batching TTSServer for any synthesis family: loads (or
    random-inits) the family pipeline, then delegates the request schema,
    submit and stream wiring to serving.families.continuous_server (request
    formats documented there)."""
    import torch

    from .serving.families import continuous_server

    def _fan(pipe):
        """--devices N: one replicated pipeline a card behind a least-loaded
        router (serving/devices + serving/router)."""
        n = getattr(args, "devices", 1) or 1
        if n <= 1:
            return pipe
        from .serving.devices import pipelines_for_devices

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise SystemExit(f"--devices {n} > {have} CUDA devices")
        return pipelines_for_devices(pipe, [torch.device("cuda", i) for i in range(n)])

    fam = args.family
    if fam == "kani":
        pipe, _ = _serve_kani_pipeline(args)
        return continuous_server("kani", _fan(pipe), slots=args.max_batch)

    dev, dtype = _device(args)
    if fam == "qwen":
        from .runtime.qwen import QwenDecodeConfig, QwenTTSPipeline

        params, cfg, cparams, ccfg = _qwen_models(args, dev, dtype)
        pipe = QwenTTSPipeline(params, cfg, cparams, ccfg,
                               QwenDecodeConfig(max_frames=args.max_tokens),
                               quantize=args.quantize)
        return continuous_server("qwen", _fan(pipe), slots=args.max_batch,
                                 max_tokens=args.max_tokens)

    if fam == "voxcpm":
        from .runtime.voxcpm import VoxCPMDecodeConfig, VoxCPMPipeline

        params, vae_params, cfg = _voxcpm_models(args, dev, dtype)
        pipe = VoxCPMPipeline(params, cfg, vae_params,
                              VoxCPMDecodeConfig(max_latents=args.max_tokens),
                              quantize=args.quantize)
        return continuous_server("voxcpm", _fan(pipe), slots=args.max_batch)

    if fam == "indextts":
        from .audio.wav import read_audio
        from .runtime.indextts import IndexTTSPipeline

        params, cfg, vcfg = _indextts_models(args, dev, dtype)
        pipe = IndexTTSPipeline(params, cfg, vcfg, quantize=args.quantize)
        audio = (read_audio(args.ref_audio, target_rate=24000)[0] if args.ref_audio
                 else _noise_reference(24000))
        ref = pipe.encode_reference(audio)
        return continuous_server("indextts", _fan(pipe), slots=args.max_batch,
                                 max_tokens=args.max_tokens, ref=ref)

    if fam == "f5":
        from .audio.wav import read_audio

        params, cfg, vocab, vparams, vcfg = _f5_models(args, dev, dtype)
        pipe = _f5_pipeline(params, cfg, vocab, vparams, vcfg, quantize=args.quantize)
        ref_audio = (read_audio(args.ref_audio, target_rate=cfg.sample_rate)[0]
                     if args.ref_audio else _noise_reference(cfg.sample_rate))
        return continuous_server("f5", _fan(pipe), slots=args.max_batch,
                                 ref_audio=ref_audio,
                                 ref_text=args.ref_text or "demo reference")

    raise SystemExit(f"unknown family {fam!r}")


def _ladder(max_batch: int) -> tuple[int, ...]:
    """The MicroBatcher's batch sizes: must contain max_batch itself, so
    --max-batch 6 yields (1, 2, 4, 6)."""
    return tuple(sorted({s for s in (1, 2, 4, 8) if s < max_batch} | {max_batch}))


def build_server(args):
    """The TTSServer `serve` binds: admission-time micro-batching (Kani) or,
    with --continuous, a slot server for any family; with --warmup every
    batch size (or the slot batch) runs once before the port is bound."""
    from .serving import TTSServer

    if args.continuous:
        srv = _serve_continuous(args)
    else:
        if getattr(args, "devices", 1) > 1:
            raise SystemExit("--devices needs --continuous (per-device "
                             "slot servers behind the router)")
        if args.family != "kani":
            raise SystemExit("admission-time batching serves kani only; "
                             "use --continuous for other families")
        pipe, ccfg = _serve_kani_pipeline(args)
        pad = np.array([[3, 9, 5]], np.int32)
        srv = TTSServer.for_pipeline(
            pipe, pad, sample_rate=ccfg.sample_rate,
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            batch_sizes=_ladder(args.max_batch))
    if args.warmup:
        # on the MicroBatcher path one request warms the batch-1 bucket only:
        # each ladder size gets that many concurrent requests, which coalesce
        # into one batch
        import time

        from .serving.families import default_request_body

        body = default_request_body(args.family)
        sizes = (1,) if args.continuous else _ladder(args.max_batch)
        t0 = time.perf_counter()
        for size in sizes:
            tw = time.perf_counter()
            futs = [srv.submit(srv.request_from_json(body)) for _ in range(size)]
            for f in futs:
                f.result(timeout=600)
            print(f"warmup batch={size}: {time.perf_counter() - tw:.1f}s")
        print(f"warmup done in {time.perf_counter() - t0:.1f}s")
    return srv


def cmd_serve(args) -> None:
    """HTTP TTS server: admission-time micro-batching (default, Kani) or
    slot-based continuous batching for any family (--continuous --family
    ...). Kani, Qwen and VoxCPM stream over the slot batch via POST
    /stream."""
    import time

    from .serving import serve_http

    srv = build_server(args)
    httpd = serve_http(srv, host=args.host, port=args.port)
    host, port = httpd.server_address
    print(f"serving on http://{host}:{port}  "
          f"(POST /synthesize, POST /stream, GET /stats — "
          f"family={args.family}, request formats in serving/families.py)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        httpd.shutdown()
        srv.close()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tts_tpu_torch",
                                 description="TTS synthesis on an NVIDIA card (PyTorch/CUDA)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every command runs: the card (bf16 weights, the "
                         "default; raises without one) or the CPU (fp32 weights)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    f5 = sub.add_parser("f5", help="F5-TTS voice cloning")
    f5.add_argument("--ref-audio", required=True)
    f5.add_argument("--ref-text", required=True)
    f5.add_argument("--gen-text", required=True)
    f5.add_argument("--ckpt", help="F5 safetensors path")
    f5.add_argument("--vocab", help="vocab.txt path")
    f5.add_argument("--vocoder", help="vocos-mel-24khz dir")
    f5.add_argument("--out", default="generated.wav")
    f5.add_argument("--speed", type=float, default=1.0)
    f5.add_argument("--seed", type=int, default=9527)
    f5.set_defaults(fn=cmd_f5)

    ka = sub.add_parser("kani", help="KaniTTS synthesis")
    ka.add_argument("--text", default="Hello from the card.")
    ka.add_argument("--speaker", default="jenny")
    ka.add_argument("--ckpt", help="kani-tts HF dir")
    ka.add_argument("--codec", help="nemo nano codec .nemo path")
    ka.add_argument("--beam", type=int, default=1)
    ka.add_argument("--penalty", type=float, default=0.8)
    ka.add_argument("--max-tokens", type=int, default=1019)
    ka.add_argument("--out", default="generated.wav")
    ka.set_defaults(fn=cmd_kani)

    it = sub.add_parser("indextts", help="IndexTTS voice cloning")
    it.add_argument("--ref-audio", required=True)
    it.add_argument("--text", default="Hello from the card.")
    it.add_argument("--ckpt", help="IndexTTS-1.5 model dir")
    it.add_argument("--max-tokens", type=int, default=800)
    it.add_argument("--allow-degraded", action="store_true",
                    help="permit the char-level tokenizer fallback (ids "
                         "will not match the upstream tokenizer)")
    it.add_argument("--out", default="generated.wav")
    it.set_defaults(fn=cmd_indextts)

    vc = sub.add_parser("voxcpm", help="VoxCPM synthesis")
    vc.add_argument("--text", default="Hello from the card.")
    vc.add_argument("--prompt-audio")
    vc.add_argument("--prompt-text")
    vc.add_argument("--ckpt", help="VoxCPM model dir")
    vc.add_argument("--v2", action="store_true", help="VoxCPM-2 muP folds")
    vc.add_argument("--max-latents", type=int, default=256)
    vc.add_argument("--out", default="generated.wav")
    vc.set_defaults(fn=cmd_voxcpm)

    qw = sub.add_parser("qwen", help="Qwen3-TTS synthesis")
    qw.add_argument("--text", default="Hello from the card.")
    qw.add_argument("--ckpt", help="Qwen3-TTS HF model dir")
    qw.add_argument("--language", help="language name (english, chinese, ...)")
    qw.add_argument("--speaker", help="speaker name (serena, ryan, ...)")
    qw.add_argument("--language-id", type=int, default=0)
    qw.add_argument("--speaker-id", type=int)
    qw.add_argument("--max-frames", type=int, default=600)
    qw.add_argument("--beam", type=int, default=1,
                    help="predictor beam size (1 = greedy)")
    qw.add_argument("--beam-top-k", type=int, default=3)
    qw.add_argument("--instruct", help="style instruction / voice "
                    "description prepended as a system prompt")
    qw.add_argument("--out", default="generated.wav")
    qw.set_defaults(fn=cmd_qwen)

    sv = sub.add_parser("serve", help="HTTP TTS server (all families)")
    sv.add_argument("--family", default="kani",
                    choices=("kani", "qwen", "voxcpm", "indextts", "f5"),
                    help="which synthesis family to serve (non-kani "
                         "families need --continuous)")
    sv.add_argument("--ckpt", help="family checkpoint dir/path")
    sv.add_argument("--codec", help=".nemo codec path (kani)")
    sv.add_argument("--vocab", help="vocab.txt path (f5)")
    sv.add_argument("--vocoder", help="vocos-mel-24khz dir (f5)")
    sv.add_argument("--ref-audio", help="reference audio fixed at startup "
                                        "(indextts/f5)")
    sv.add_argument("--ref-text", help="reference transcript (f5)")
    sv.add_argument("--v2", action="store_true",
                    help="VoxCPM-2 muP folds (voxcpm)")
    sv.add_argument("--quantize", type=int, choices=(4, 8))
    sv.add_argument("--max-tokens", type=int, default=256)
    sv.add_argument("--max-batch", type=int, default=8)
    sv.add_argument("--max-wait-ms", type=float, default=10.0)
    sv.add_argument("--continuous", action="store_true",
                    help="slot-based continuous batching (mid-decode "
                         "admission) instead of admission-time batching")
    sv.add_argument("--devices", type=int, default=1,
                    help="serve over the first N CUDA devices: one "
                         "replicated pipeline + slot server a card "
                         "behind a least-loaded router (--continuous "
                         "only; zero collectives)")
    sv.add_argument("--warmup", action="store_true",
                    help="run every MicroBatcher ladder size (or the slot "
                         "batch under --continuous) once before binding the "
                         "port, so the first live request pays no first-call "
                         "cost (kernel builds among them)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8700)
    sv.set_defaults(fn=cmd_serve)

    for p in (f5, ka, it, vc, qw):
        p.add_argument("--quantize", type=int, choices=(4, 8),
                       help="weight-only int8/int4 on the model's LM/DiT")
        p.add_argument("--npz", help="load fused params from .npz (fast start)")
        p.add_argument("--save-npz", help="persist fused params to .npz")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
