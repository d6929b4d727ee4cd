#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tts_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (a failed phase ends the run non-zero):
  0. require a CUDA card; print its name and power limit as nvidia-smi
     reports them; turn TF32 off for matmuls and cuDNN;
  1. build the hand-written kernels from tts_tpu_torch/csrc with nvcc;
  2. each kernel against its plain PyTorch twin at the F5 bench shapes in
     bf16, with its error, and its time beside the twin's;
  3. F5Pipeline.synthesize at full F5TTS_v1_Base width (random weights made
     from a seed) on three requests, checking the audio and that every DiT
     block went through the kernels;
  4. F5Pipeline.benchmark: single-request latency and sustained RTF.
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# kernel error tolerance, relative to max |reference|, and on the relative
# L2 error: the reference is the twin in fp32 on the same bf16 inputs, so
# the difference is the kernel's bf16 rounding of its output (2^-9
# relative) and of its intermediates at the TPU kernel's rounding points
# (roped q/k and P; the modulated LN and the hidden layer; each conv
# output). The bf16 twin against the fp32 twin differs by about 2^-8 at
# these shapes (measured on the CPU); 2^-6 leaves 4x headroom, while a
# wrong index or layout gives errors of order one.
TOL = 2.0 ** -6

REF_TEXT = "Some call me nature, others call me mother nature."
# the bench request (6 s ref, 15 words) generates 832 frames; the vocoder's
# ISTFT gives (frames - 1) * hop samples of them, as in tts_tpu
BENCH_SAMPLES = (832 - 1) * 256

KERNELS = {
    "flash_attention_flat": ("tts_tpu_torch/csrc/flash_attention.cu",
                             "tts_tpu/ops/flash_attention.py:316"),
    "conv_pos_embed_fused": ("tts_tpu_torch/csrc/grouped_conv.cu",
                             "tts_tpu/ops/grouped_conv.py:100"),
    "mlp_block_fused": ("tts_tpu_torch/csrc/dit_mlp.cu",
                        "tts_tpu/ops/dit_mlp.py:171"),
}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Median of `iters` single-call CUDA-event timings, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(label: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    torch.cuda.synchronize()
    ref = ref.float()
    err = got.float() - ref
    max_abs = err.abs().max().item()
    scale = ref.abs().max().item()
    rel_l2 = (torch.linalg.vector_norm(err) / torch.linalg.vector_norm(ref)).item()
    ok = (bool(torch.isfinite(got).all()) and max_abs <= TOL * scale
          and rel_l2 <= TOL)
    print(f"  {label}: max_abs_err {max_abs:.6g} (max|ref| {scale:.6g}, "
          f"limit {TOL * scale:.6g}), rel_l2 {rel_l2:.6g} (limit {TOL:.6g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its twin")
    return max_abs


def check_kernels(gen: torch.Generator) -> dict:
    """Phase 2: each kernel against its twin (fp32, same bf16 inputs)."""
    from tts_tpu_torch.models.f5 import f5_rope_tables
    from tts_tpu_torch.ops.dit_mlp import mlp_block_fused, mlp_block_plain
    from tts_tpu_torch.ops.flash_attention import (flash_attention_flat,
                                                   flash_attention_flat_plain)
    from tts_tpu_torch.ops.grouped_conv import (conv_pos_embed_fused,
                                                conv_pos_embed_plain)

    def rn(*shape, scale=1.0):
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        return x.to(torch.bfloat16)

    def f32(*ts):
        return [t.float() for t in ts]

    res = {name: {"max_abs_err": 0.0} for name in KERNELS}

    # as the pipeline passes them: bf16 tables taken to fp32 once
    cos_np, sin_np = f5_rope_tables(4096, 64)
    cos = torch.tensor(cos_np, device="cuda").to(torch.bfloat16).float()
    sin = torch.tensor(sin_np, device="cuda").to(torch.bfloat16).float()
    per_row = torch.tensor([1396, 700], dtype=torch.int32, device="cuda")
    r = res["flash_attention_flat"]
    for t, kv, label in ((1408, 1396, "1396"), (1408, per_row, "(1396, 700)"),
                         (4096, 4000, "4000")):
        qkv = rn(2, t, 3 * 16 * 64, scale=0.5)
        got = flash_attention_flat(qkv, cos, sin, kv, heads=16)
        ref = flash_attention_flat_plain(qkv.float(), cos, sin, kv, heads=16)
        err = check(f"flash_attention_flat B=2 H=16 D=64 T={t} kv_len={label}",
                    got, ref)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if label == "1396":
            # timed with kv_len on the card, as the pipeline passes it
            kv = torch.full((2,), kv, dtype=torch.int32, device="cuda")
            r["ms"] = time_ms(lambda: flash_attention_flat(qkv, cos, sin, kv, heads=16))
            r["plain_ms"] = time_ms(
                lambda: flash_attention_flat_plain(qkv, cos, sin, kv, heads=16))
        del got, ref

    r = res["conv_pos_embed_fused"]
    w1, w2 = rn(31, 64, 1024, scale=0.02), rn(31, 64, 1024, scale=0.02)
    b1, b2 = rn(1024, scale=0.1), rn(1024, scale=0.1)
    for t in (1408, 4096):
        x = rn(2, t, 1024)
        got = conv_pos_embed_fused(x, w1, b1, w2, b2)
        ref = conv_pos_embed_plain(*f32(x, w1, b1, w2, b2))
        r["max_abs_err"] = max(r["max_abs_err"], check(
            f"conv_pos_embed_fused x=(2, {t}, 1024) K=31 groups=16", got, ref))
        if t == 1408:
            r["ms"] = time_ms(lambda: conv_pos_embed_fused(x, w1, b1, w2, b2))
            r["plain_ms"] = time_ms(lambda: conv_pos_embed_plain(x, w1, b1, w2, b2))
        del got, ref

    r = res["mlp_block_fused"]
    x = rn(2, 1408, 1024)
    w1, w2 = rn(1024, 2048, scale=0.02), rn(2048, 1024, scale=0.02)
    b1, b2 = rn(2048, scale=0.1), rn(1024, scale=0.1)
    for mods, label in ((rn(3, 1024, scale=0.5), "shared (3, D)"),
                        (rn(2, 3, 1024, scale=0.5), "per-row (B, 3, D)")):
        got = mlp_block_fused(x, mods, w1, b1, w2, b2)
        ref = mlp_block_plain(*f32(x, mods, w1, b1, w2, b2))
        r["max_abs_err"] = max(r["max_abs_err"], check(
            f"mlp_block_fused x=(2, 1408, 1024) F=2048 mods {label}", got, ref))
        if mods.dim() == 2:
            r["ms"] = time_ms(lambda: mlp_block_fused(x, mods, w1, b1, w2, b2))
            r["plain_ms"] = time_ms(lambda: mlp_block_plain(x, mods, w1, b1, w2, b2))
    for name, r in res.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain twin {r['plain_ms']:.4f} ms "
              f"(bench shape, median of 10)", flush=True)
    return res


def run_pipeline() -> tuple:
    """Phase 3: synthesize at full width through the kernels."""
    from tts_tpu_torch.models.f5 import F5Config, F5Model
    from tts_tpu_torch.models.f5 import init_params as f5_init
    from tts_tpu_torch.models.vocos import VocosConfig, VocosModel
    from tts_tpu_torch.models.vocos import init_params as vocos_init
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.f5 import F5Pipeline

    cfg, vcfg = F5Config(), VocosConfig()
    t0 = time.perf_counter()
    f5 = F5Model(cfg, f5_init(cfg, torch.Generator("cuda").manual_seed(0),
                              torch.bfloat16))
    vocos = VocosModel(vcfg, vocos_init(vcfg, torch.Generator("cuda").manual_seed(1),
                                        torch.bfloat16))
    pipe = F5Pipeline(f5, {" ": 0}, vocos)
    torch.cuda.synchronize()
    print(f"  models: F5 dim {cfg.dim} depth {cfg.depth} heads {cfg.heads}x"
          f"{cfg.head_dim} NFE {cfg.nfe_steps}, Vocos dim {vcfg.dim} x "
          f"{vcfg.num_layers}, bf16, random init in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(int(6.0 * cfg.sample_rate)) * 3000).astype(np.int16)
    per_step = {"flash_attention_flat": cfg.depth, "mlp_block_fused": cfg.depth,
                "conv_pos_embed_fused": 1}
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    for words in (15, 8, 25):
        gen_text = " ".join(["word"] * words)
        *_, buckets, n_keep = pipe._prepare(audio, REF_TEXT, gen_text)
        before = dict(LAUNCHES)
        wav, stats = pipe.synthesize(audio, REF_TEXT, gen_text)
        grew = {k: LAUNCHES[k] - before.get(k, 0) for k in KERNELS}
        print(f"  request {words} words: frame bucket {buckets[2]}, {len(wav)} "
              f"int16 samples ({stats.audio_s:.3f} s of audio), wall "
              f"{stats.wall_s:.4f} s, peak |wav| {stats.peak:.6g}, launches "
              f"{grew}", flush=True)
        expect = min(n_keep, (buckets[3] - 1) * cfg.hop)
        if wav.dtype != np.int16 or len(wav) != expect:
            raise AssertionError(f"expected {expect} int16 samples, got "
                                 f"{len(wav)} {wav.dtype}")
        if words == 15 and expect != BENCH_SAMPLES:
            raise AssertionError(f"bench request gives {expect} samples, "
                                 f"not {BENCH_SAMPLES}")
        if not math.isfinite(stats.peak):
            raise AssertionError("the float waveform was not finite")
        if not wav.any():
            raise AssertionError("the waveform is all zeros")
        for k, n in per_step.items():
            if grew[k] != n * (cfg.nfe_steps - 1):
                raise AssertionError(f"{k} launched {grew[k]} times, expected "
                                     f"{n * (cfg.nfe_steps - 1)}")
    launches = dict(LAUNCHES)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    return pipe, launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    from tts_tpu_torch.ops import _build

    print("phase 0: device", flush=True)
    name_limit = card()
    print(name_limit, flush=True)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("phase 1: build", flush=True)
    path, seconds, log = _build.build()
    _build.library()
    print(f"  built {path.name} in {seconds:.2f} s (0 = already built)", flush=True)
    for line in log.splitlines():     # ptxas -v: registers, smem, spills
        if any(w in line for w in ("entry function", "registers", "spill", "error")):
            print(f"  nvcc: {line.strip()}")

    print("phase 2: kernels against their twins", flush=True)
    res = check_kernels(torch.Generator("cuda").manual_seed(1234))

    print("phase 3: F5Pipeline.synthesize", flush=True)
    pipe, launches = run_pipeline()

    print("phase 4: F5Pipeline.benchmark", flush=True)
    bench = pipe.benchmark(ref_seconds=6.0, gen_words=15, iters=3)
    print(f"  {name_limit}: latency RTF {bench['rtf']:.6f} ({bench['wall_s']:.4f} s"
          f" for {bench['audio_s']:.3f} s of audio), sustained RTF "
          f"{bench['sustained_rtf']:.6f}", flush=True)
    print("  " + json.dumps(bench), flush=True)

    summary = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches.get(name, 0),
                "max_abs_err": res[name]["max_abs_err"],
                "ms": res[name]["ms"], "plain_ms": res[name]["plain_ms"]}
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
