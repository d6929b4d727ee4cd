#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tts_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --kernels-only     # phases 0-2
    python3 chip_smoke.py --profile DIR      # and torch.profiler breakdowns
                                             # of one F5 request (bf16, W8A8,
                                             # fp32, fp32 W8A8),
                                             # one greedy Kani run, one
                                             # Qwen3-TTS request (bf16, int8),
                                             # one BigVGAN call and one
                                             # IndexTTS request
    python3 chip_smoke.py --families bigvgan,indextts   # phases 0-2, 8, 8c, 9

Phases, each raising on failure (a failed phase ends the run non-zero):
  0. require a CUDA card; print its name and power limit as nvidia-smi
     reports them; turn TF32 off for matmuls and cuDNN;
  1. build the hand-written kernels from tts_tpu_torch/csrc with nvcc;
  2. each kernel against its plain PyTorch twin in fp32 on the same inputs,
     at the F5 bench shapes (kernel 1 also at head dim 128; kernel 3 also
     at B 1 T 1088, B 2 T 4608, D 512 F 1536 and rows offset by +100, and
     beside a cuBLAS yardstick of its two GEMMs; kernel 4 in
     bf16 at head dims 64, 128 and 192 and in fp32; kernel 5 at T 8192 in
     bf16 and T 2048 in fp32; kernels 6-8 also on fp32 activations;
     kernels 6 and 7 also at B 2 T 1400 and B 1 T 1088, kernel 7 at D 576
     (a half K step), kernel 6 at D 640 F 1152 (ff1 a cluster of 9), each
     GEMM form at the bench shape, torch._int_mm at their GEMMs' shapes as
     a yardstick), the
     flash core's edges (kernels 1, 4 and 5 at kv_len 0, 1, 63, 64, 65, T
     64, kernels 4 and 5 at D 256, kernel 5 at S 4224; kernel 1 with a row
     below -66, kernel 4 in fp32 with rows at -90 and -70), kernel 13 at
     its cluster slices' edges, head dim 64 and G 1 and 8, one launch a
     call at kv_len 2047, the kani-tts-370m decode shapes (kernel 12 also
     against its bf16 twin, and no further from fp32 than 1.25x that
     twin), the Qwen3-TTS-0.6B talker and predictor shapes (kernel 12 at
     head_dim 128, kernels 13-15, kernel 13 timed at both) and the BigVGAN
     bench stages (kernel 10 in bf16 at
     stages 2 and 5, in fp32 at stages 3 and 5), with its error, its time
     beside the twin's and a library call's where one exists, and its
     bound (and the flash kernels' exp floor);
  3. F5Pipeline.synthesize at full F5TTS_v1_Base width (random weights made
     from a seed) on three requests, checking the audio and that every DiT
     block went through the kernels;
  4. F5Pipeline.benchmark: single-request latency and sustained RTF; one
     bf16 DiT forward at T 4608 through kernel 5 (22 launches) against the
     twins;
  5. F5Pipeline(quantize="w8a8") over the same models: the three requests
     through kernels 6-8 (W8A8), one DiT forward against the twins in bf16
     and fp32, latency and sustained RTF; one quantize=4 request;
  5c. F5Pipeline in fp32 at full F5TTS_v1_Base width: the bench request
     through kernel 4 (682 launches, none of kernel 1), one fp32 DiT
     forward against the twins at the bench bucket and one at T 4608
     through kernel 5 (22 launches), latency and sustained RTF; then with
     quantize="w8a8": the bench request and one DiT forward against the
     twins through kernels 7, 4, 8 and 6 in fp32 (with --profile, one
     request of each under torch.profiler);
  6. KaniPipeline.synthesize_ids at full kani-tts-370m width (random
     weights from a seed, the bench config: 256 new tokens, no stop token):
     greedy bf16 and int8, beam and a batch of 4, checking the audio, that
     every attention layer's decode step went through kernel 12 (greedy)
     or kernel 11 (beam, batch), and one step's logits against the plain
     route; then tokens/s and RTF of greedy bf16 and int8;
  7. QwenTTSPipeline at full Qwen3-TTS-0.6B width (random weights from a
     seed): the bench request (32 text ids, language 3, max_frames 120) in
     bf16 and int8 on the default route, 88 launches of kernel 12 an
     iteration and none of kernels 13-15, frames/s and RTF; beam 3 and a
     batch of 4 (kernel 11); fused_decode="all" at max_frames 128 (kernels
     11, 13, 14 on talker and predictor) and "mlp_q8" (kernels 11, 15);
     one talker step through "step", "all" and "mlp_q8" against fp32;
  8. BigVGANVocoder at full bigvgan_v2_24khz_100band_256x width (random
     weights from a seed, scaled to keep the waveform off zero and off the
     clamp): the bench mel (1, 512, 100) -> 131,072 int16 samples, 12
     launches of kernel 10 a call, the float output against the same
     generator with kernel 10's twin and against fp32, samples/s and RTF;
  8c. the same vocoder in fp32: the bench mel, 9 launches of kernel 10's
     fp32 form a call (stages 3-5), the output against the twin route,
     samples/s and RTF;
  9. IndexTTSPipeline at full IndexTTS-1.5 width (GPT 24 x 1280, 20 heads;
     conformer 6 x 512; ECAPA 512; BigVGAN 1536 channels from 1280 inputs;
     random weights from seeds, no stop token): encode_reference on a 6 s
     reference, requests of 32 text ids x 256 tokens in bf16 and int8 and a
     batch of 4, 24 launches of kernel 11 a decode step, none of kernel 12,
     12 of kernel 10 a vocoder call, one GPT step's logits against fp32,
     tokens/s and RTF.
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
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
# the same for a kernel in fp32 against its fp32 twin: only the order of
# fp32 sums differs (measured on the card: 1e-7 to 3e-6)
TOL32 = 2.0 ** -14
# an fp32 forward through the kernels against the same through the twins
FWD32_TOL = 1e-4
# the same with int8 DiT weights (W8A8): each activation row is quantized to
# int8, and where the kernel's fp32 LayerNorm or attention sums run in
# another order than the twin's, a value on a rounding tie of v / xs moves
# by one int8 step (1/127 of its row's max) on one route only. About 1e-5
# of the values sit that close to a tie; each step moves its output row by
# about 1/(127 sqrt(K)), so a forward's rel L2 stays below 1e-3, while a
# wrong index or layout gives errors of order one
Q8_FWD32_TOL = 2.0 ** -10
# the fused Kani step's logits may be this much further from fp32 than the
# plain route's (check_step): rounding at other points gives either route
# the larger error on a given input
STEP_SLACK = 1.25

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
    "mlp_block_fused_q8": ("tts_tpu_torch/csrc/dit_mlp_q8.cu",
                           "tts_tpu/ops/dit_mlp.py:124"),
    "ln_qkv_q8": ("tts_tpu_torch/csrc/quant_matmul.cu",
                  "tts_tpu/ops/quant_matmul.py:92"),
    "out_proj_residual_q8": ("tts_tpu_torch/csrc/quant_matmul.cu",
                             "tts_tpu/ops/quant_matmul.py:141"),
    "quantized_matmul": ("tts_tpu_torch/csrc/quant_matmul.cu",
                         "tts_tpu/ops/quant_matmul.py:176"),
    "fused_qkv_rope": ("tts_tpu_torch/csrc/decode_qkv.cu",
                       "tts_tpu/ops/decode_qkv.py:259"),
    "fused_qkv_attn": ("tts_tpu_torch/csrc/decode_step.cu",
                       "tts_tpu/ops/decode_step.py:301"),
    "decode_gqa_attention": ("tts_tpu_torch/csrc/decode_attention.cu",
                             "tts_tpu/ops/decode_attention.py:111"),
    "fused_out_mlp": ("tts_tpu_torch/csrc/decode_mlp.cu",
                      "tts_tpu/ops/decode_mlp.py:200"),
    "fused_out_mlp_q8": ("tts_tpu_torch/csrc/decode_mlp_q8.cu",
                         "tts_tpu/ops/decode_mlp.py:341"),
    "amp_block_fused": ("tts_tpu_torch/csrc/amp_block.cu",
                        "tts_tpu/ops/bigvgan_stage.py:202"),
    "flash_attention_onepass": ("tts_tpu_torch/csrc/flash_mha.cu",
                                "tts_tpu/ops/flash_attention.py:141"),
    "flash_attention_online": ("tts_tpu_torch/csrc/flash_mha.cu",
                               "tts_tpu/ops/flash_attention.py:384"),
    "amp_block_fused_f32": ("tts_tpu_torch/csrc/amp_block.cu",
                            "tts_tpu/ops/bigvgan_stage.py:202"),
}
F5_KERNELS = ("flash_attention_flat", "conv_pos_embed_fused", "mlp_block_fused")
Q8_KERNELS = ("mlp_block_fused_q8", "ln_qkv_q8", "out_proj_residual_q8")
QWEN_KERNELS = ("fused_qkv_rope", "fused_qkv_attn", "decode_gqa_attention",
                "fused_out_mlp", "fused_out_mlp_q8")

# the least time the card could take (H100 SXM datasheet: dense tensor-core
# peaks, HBM rate, at the full 700 W)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def set_bound(r: dict, nbytes: float, ops: float, kind: str, ops2: float = 0.0,
              kind2: str = "fp32") -> None:
    """r["bound_ms"]: the larger of the bytes moved (each input read once,
    each output written once) over the memory rate and the operations over
    the peak rate of their type (`ops2` a second kind of operations, as
    kernel 10's fp32 activation work beside its bf16 tensor-core work)."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(ops / PEAK_OPS_S[kind], ops2 / PEAK_OPS_S[kind2])
    r["bound_ms"] = max(t_bytes, t_ops) * 1e3
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)

# the Kani bench request (bench.py:258-264): 5 prompt ids, 256 new tokens
KANI_IDS = [[3, 9, 4, 17, 2]]
KANI_NEW = 256
# the Qwen3-TTS bench request (bench.py:186-191): 32 text ids, language 3,
# max_frames 120
QWEN_IDS = np.arange(5, 37, dtype=np.int32)[None]
QWEN_LANG = 3
QWEN_FRAMES = 120


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


def device_ms(fn, iters: int = 10, only: str | None = None) -> float:
    """Device time of one call: the kernels' time in a torch.profiler trace
    of `iters` calls, over iters. A decode kernel's single-call event time
    is mostly the host's enqueue, the card waiting on it. `only` keeps the
    kernels whose name holds it (a wrapper's own kernels, without the casts
    it issues around them). A trace that holds none of those kernels is
    taken again, up to three in all (on the card a trace has come back
    without them, once in several runs); then CUDA events around the
    `iters` calls give the time (enqueue and every kernel of the call
    included), and the line says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and (only is None or only in e.key)) / 1e3 / iters
        if ms > 0:
            return ms
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    what = "device time" if only is None else f"a {only!r} kernel"
    print(f"  (three profiler traces held no {what}: CUDA events over {iters} calls, "
          f"{ms:.4f} ms a call)", flush=True)
    return ms


def check(label: str, got: torch.Tensor, ref: torch.Tensor, tol: float = TOL,
          max_tol: float | None = None) -> float:
    """got within tol of ref: rel L2 <= tol and max |err| <= max_tol (default
    tol) times max |ref|."""
    torch.cuda.synchronize()
    max_tol = tol if max_tol is None else max_tol
    ref = ref.float()
    err = got.float() - ref
    max_abs = err.abs().max().item()
    scale = ref.abs().max().item()
    rel_l2 = (torch.linalg.vector_norm(err) / torch.linalg.vector_norm(ref)).item()
    ok = (bool(torch.isfinite(got).all()) and max_abs <= max_tol * scale
          and rel_l2 <= tol)
    print(f"  {label}: max_abs_err {max_abs:.6g} (max|ref| {scale:.6g}, "
          f"limit {max_tol * scale:.6g}), rel_l2 {rel_l2:.6g} (limit {tol:.6g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its twin")
    return max_abs


def check_decode_kernels(gen: torch.Generator, res: dict) -> None:
    """Phase 2, kernels 11 and 12 at the kani-tts-370m decode shapes
    against their fp32 twins on the same bf16 inputs."""
    from tts_tpu_torch.ops.decode_qkv import fused_qkv_rope, fused_qkv_rope_plain
    from tts_tpu_torch.ops.decode_step import fused_qkv_attn, fused_qkv_attn_plain
    from tts_tpu_torch.quant.weight_only import QTensor, quantize_int8_jit

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def f32(a):
        return a.float() if isinstance(a, torch.Tensor) else a

    def both(fn, plain, label, x, w, *args, **kw):
        got = fn(x, w, *args, **kw)
        ref = plain(x.float(), w if isinstance(w, QTensor) else w.float(),
                    *map(f32, args), **{k: f32(v) for k, v in kw.items()})
        return max(check(f"{label} {part}", g, r)
                   for part, g, r in zip(("out", "k", "v"), got, ref))

    hs, heads, kvh, hd = 1024, 16, 8, 64
    w = rn(hs, (heads + 2 * kvh) * hd, scale=0.02)
    wq = quantize_int8_jit(w)
    norm_w = torch.full((hd,), hd ** -0.25, device="cuda").to(torch.bfloat16)
    cos, sin = rn(1, hd), rn(1, hd)
    kani = dict(heads=heads, kv_heads=kvh, head_dim=hd, q_norm=norm_w, k_norm=norm_w,
                eps=1e-5)
    r = res["fused_qkv_rope"]
    for b in (1, 5, 8):
        x = rn(b, hs)
        for wt, wl in ((w, "bf16"), (wq, "int8")):
            r["max_abs_err"] = max(r["max_abs_err"], both(
                fused_qkv_rope, fused_qkv_rope_plain,
                f"fused_qkv_rope Kani B={b} {wl}", x, wt, cos, sin, **kani))
    # the other families' variants: Qwen (hd 128), a bias, IndexTTS (LN, no RoPE)
    x = rn(2, hs)
    w128 = rn(hs, (16 + 2 * 8) * 128, scale=0.02)
    n128 = torch.full((128,), 128 ** -0.25, device="cuda").to(torch.bfloat16)
    for label, wt, args, kw in (
            ("hd128 q/k norms", w128, (rn(1, 128), rn(1, 128)),
             dict(heads=16, kv_heads=8, head_dim=128, q_norm=n128, k_norm=n128)),
            ("hd128 bias int8", quantize_int8_jit(w128), (rn(1, 128), rn(1, 128)),
             dict(heads=16, kv_heads=8, head_dim=128, bqkv=rn(4096, scale=0.1))),
            ("LN bias no-RoPE MHA", rn(hs, 3 * 16 * 64, scale=0.02), (None, None),
             dict(heads=16, kv_heads=16, head_dim=64, bqkv=rn(3072, scale=0.1),
                  norm="ln", ln_weight=rn(hs, scale=0.1) + 1, ln_bias=rn(hs, scale=0.1)))):
        r["max_abs_err"] = max(r["max_abs_err"], both(
            fused_qkv_rope, fused_qkv_rope_plain, f"fused_qkv_rope {label}", x, wt,
            *args, **kw))
    x1 = rn(1, hs)
    timed = {"fused_qkv_rope": (lambda: fused_qkv_rope(x1, w, cos, sin, **kani),
                                lambda: fused_qkv_rope_plain(x1, w, cos, sin, **kani))}

    r = res["fused_qkv_attn"]
    kc, vc = rn(6, 1, kvh, 2048, hd), rn(6, 1, kvh, 2048, hd)
    for pos in (5, 700, 2047):
        for wt, wl in ((w, "bf16"), (wq, "int8")):
            r["max_abs_err"] = max(r["max_abs_err"], both(
                fused_qkv_attn, fused_qkv_attn_plain,
                f"fused_qkv_attn L=6 T=2048 pos={pos} {wl}", x1, wt, cos, sin, kc, vc,
                3, pos, **kani))
            # beside it, the bf16 twin (its rounding points in bf16), and both
            # against fp32 as check_step holds a route: the kernel no further
            # from fp32 than STEP_SLACK times the bf16 twin. No new draws, so
            # every later check keeps its inputs
            ref32 = fused_qkv_attn_plain(
                x1.float(), wt if isinstance(wt, QTensor) else wt.float(), cos.float(),
                sin.float(), kc.float(), vc.float(), 3, pos,
                **{k: f32(v) for k, v in kani.items()})
            for part, g, r16, r32 in zip(
                    ("out", "k", "v"),
                    fused_qkv_attn(x1, wt, cos, sin, kc, vc, 3, pos, **kani),
                    fused_qkv_attn_plain(x1, wt, cos, sin, kc, vc, 3, pos, **kani), ref32):
                label = f"fused_qkv_attn L=6 T=2048 pos={pos} {wl} {part}"
                check(f"{label} against the bf16 twin", g, r16)
                e_kernel, e_twin = rel_l2(g, r32), rel_l2(r16, r32)
                ok = e_kernel <= STEP_SLACK * e_twin
                print(f"  {label}: rel L2 against fp32: kernel {e_kernel:.6g}, bf16 twin "
                      f"{e_twin:.6g} (limit {STEP_SLACK} x) {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    raise AssertionError(f"{label}: the kernel is less accurate than its "
                                         f"bf16 twin")
    timed["fused_qkv_attn"] = (
        lambda: fused_qkv_attn(x1, w, cos, sin, kc, vc, 3, 700, **kani),
        lambda: fused_qkv_attn_plain(x1, w, cos, sin, kc, vc, 3, 700, **kani))
    # bounds of the timed calls: the weight, the input row, the outputs
    # (and kernel 12's cache rows 0..pos of its layer, k and v)
    w_ops = 2 * hs * w.shape[1]
    set_bound(res["fused_qkv_rope"], nbytes(w, x1) + 2 * w.shape[1], w_ops, "bf16")
    set_bound(res["fused_qkv_attn"], nbytes(w, x1) + 2 * w.shape[1]
              + 2 * kvh * 701 * hd * 2, w_ops + 4 * heads * 701 * hd, "bf16")
    for name, (kernel, plain) in timed.items():
        r = res[name]
        r["ms"], r["plain_ms"] = device_ms(kernel), device_ms(plain)
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain twin {r['plain_ms']:.4f} ms "
              f"of device time a call (B=1, pos=700, bf16, profiler over 10 calls); "
              f"one call's wall {time_ms(kernel):.4f} / {time_ms(plain):.4f} ms "
              f"(median of 10)", flush=True)


def check_qwen_kernels(gen: torch.Generator, res: dict) -> None:
    """Phase 2 at the Qwen3-TTS-0.6B talker and predictor shapes (hidden
    1024, 16/8 heads x 128, FFN 3072): kernel 12 at head_dim 128 (talker L =
    28, T = 640; predictor L = 4, T = 32), kernel 13 (B = 1, 3, 8; kv_len 7,
    126, 2047 of T = 2048 and 17 of T = 32), kernel 14 (bf16 and int8) and
    kernel 15 (B = 1, 3, 8), each against its fp32 twin on the same bf16
    inputs and int8 weights; then device times (profiler over 10 calls) at
    B = 1 beside the twins', SDPA's for kernel 13, and the bounds."""
    import torch.nn.functional as F

    from tts_tpu_torch.ops.decode_attention import (decode_gqa_attention,
                                                    decode_gqa_attention_plain)
    from tts_tpu_torch.ops.decode_mlp import (fused_out_mlp, fused_out_mlp_plain,
                                              fused_out_mlp_q8, fused_out_mlp_q8_plain)
    from tts_tpu_torch.ops.decode_step import fused_qkv_attn, fused_qkv_attn_plain
    from tts_tpu_torch.quant.weight_only import QTensor, quantize_int8_jit

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def f32(a):
        return a.float() if isinstance(a, torch.Tensor) else a

    hs, heads, kvh, hd, ffn = 1024, 16, 8, 128, 3072
    from tts_tpu_torch.nn.rope import rope_table

    w = rn(hs, (heads + 2 * kvh) * hd, scale=0.02)
    wq = quantize_int8_jit(w)
    norm_w = torch.full((hd,), hd ** -0.25, device="cuda").to(torch.bfloat16)
    # the talker's RoPE rows, as the pipeline passes them (bf16 tables)
    table = [torch.as_tensor(a, device="cuda").to(torch.bfloat16)
             for a in rope_table(2048, hd, 1e6)]
    qwen = dict(heads=heads, kv_heads=kvh, head_dim=hd, q_norm=norm_w, k_norm=norm_w,
                eps=1e-6)
    x1 = rn(1, hs)
    r = res["fused_qkv_attn"]
    for stack, layers, t, positions in (("talker", 28, 640, (6, 126, 639)),
                                        ("predictor", 4, 32, (2, 17))):
        # cached keys at the scale the k norm (weight d^-0.25) gives them
        kc, vc = rn(layers, 1, kvh, t, hd, scale=hd ** -0.25), rn(layers, 1, kvh, t, hd)
        for pos in positions:
            cos, sin = table[0][pos:pos + 1], table[1][pos:pos + 1]
            for wt, wl in ((w, "bf16"), (wq, "int8")):
                got = fused_qkv_attn(x1, wt, cos, sin, kc, vc, layers - 1, pos, **qwen)
                ref = fused_qkv_attn_plain(
                    x1.float(), wt if isinstance(wt, QTensor) else wt.float(), cos.float(),
                    sin.float(), kc.float(), vc.float(), layers - 1, pos,
                    **{k: f32(v) for k, v in qwen.items()})
                r["max_abs_err"] = max(r["max_abs_err"], *(
                    check(f"fused_qkv_attn hd128 {stack} L={layers} T={t} pos={pos} {wl} "
                          f"{part}", g, rf) for part, g, rf in zip(("out", "k", "v"), got, ref)))
        if stack == "talker":
            cos, sin = table[0][126:127], table[1][126:127]
            timed = {"fused_qkv_attn hd128 (talker, pos 126)": (
                lambda kc=kc, vc=vc: fused_qkv_attn(x1, w, cos, sin, kc, vc, 27, 126, **qwen),
                lambda kc=kc, vc=vc: fused_qkv_attn_plain(x1, w, cos, sin, kc, vc, 27, 126,
                                                          **qwen),
                nbytes(w, x1) + 2 * w.shape[1] + 2 * kvh * 127 * hd * 2,
                2 * hs * w.shape[1] + 4 * heads * 127 * hd, "bf16", None)}

    r = res["decode_gqa_attention"]
    for b in (1, 3, 8):
        for t, lens in ((2048, (7, 126, 2047)), (32, (17,))):
            q, k, v = rn(b, heads, hd), rn(b, kvh, t, hd), rn(b, kvh, t, hd)
            for kv_len in lens:
                r["max_abs_err"] = max(r["max_abs_err"], check(
                    f"decode_gqa_attention B={b} T={t} kv_len={kv_len}",
                    decode_gqa_attention(q, k, v, kv_len),
                    decode_gqa_attention_plain(q.float(), k.float(), v.float(), kv_len)))
    # timed where the talker runs it (cache bucket 768 at max_frames 128)
    q, k, v = rn(1, heads, hd), rn(1, kvh, 768, hd), rn(1, kvh, 768, hd)
    q4, k4, v4 = q[:, :, None], k[:, :, :126], v[:, :, :126]
    timed["decode_gqa_attention"] = (
        lambda: decode_gqa_attention(q, k, v, 126),
        lambda: decode_gqa_attention_plain(q, k, v, 126),
        nbytes(q, k4, v4) + q.numel() * 2, 4 * heads * 126 * hd, "bf16",
        lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0, enable_gqa=True))

    wo, wgu, wd = rn(2048, hs, scale=0.02), rn(hs, 2 * ffn, scale=0.02), rn(ffn, hs, scale=0.02)
    wq3 = [quantize_int8_jit(m) for m in (wo, wgu, wd)]
    for b in (1, 3, 8):
        x, att = rn(b, hs), rn(b, 2048)
        for label, kernel, plain, ws, ws32 in (
                ("fused_out_mlp", fused_out_mlp, fused_out_mlp_plain, (wo, wgu, wd),
                 [m.float() for m in (wo, wgu, wd)]),
                ("fused_out_mlp", fused_out_mlp, fused_out_mlp_plain, wq3, wq3),
                ("fused_out_mlp_q8", fused_out_mlp_q8, fused_out_mlp_q8_plain, wq3, wq3)):
            wl = "int8" if isinstance(ws[0], QTensor) else "bf16"
            res[label]["max_abs_err"] = max(res[label]["max_abs_err"], check(
                f"{label} B={b} {wl} weights", kernel(x, att, *ws, eps=1e-6),
                plain(x.float(), att.float(), *ws32, eps=1e-6)))
    x, att = rn(1, hs), rn(1, 2048)
    n_w = wo.numel() + wgu.numel() + wd.numel()
    io = nbytes(x, att) + x.numel() * 2
    scales = sum(m.scale.numel() * 4 for m in wq3)
    timed["fused_out_mlp"] = (lambda: fused_out_mlp(x, att, wo, wgu, wd),
                              lambda: fused_out_mlp_plain(x, att, wo, wgu, wd),
                              2 * n_w + io, 2 * n_w, "bf16", None)
    timed["fused_out_mlp int8 weights"] = (lambda: fused_out_mlp(x, att, *wq3),
                                           lambda: fused_out_mlp_plain(x, att, *wq3),
                                           n_w + scales + io, 2 * n_w, "bf16", None)
    timed["fused_out_mlp_q8"] = (lambda: fused_out_mlp_q8(x, att, *wq3),
                                 lambda: fused_out_mlp_q8_plain(x, att, *wq3),
                                 n_w + scales + io, 2 * n_w, "int8", None)
    name_limit = card()
    for name, (kernel, plain, nb, ops, kind, lib) in timed.items():
        r = res[name] if name in res else {}
        r["ms"], r["plain_ms"] = device_ms(kernel), device_ms(plain)
        set_bound(r, nb, ops, kind)
        lib_txt = "none"
        if lib is not None:
            r["library_ms"] = device_ms(lib)
            lib_txt = f"{r['library_ms']:.4f} ms (SDPA, enable_gqa)"
        print(f"  {name_limit}: {name}: kernel {r['ms']:.4f} ms, plain twin "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{nb / 1e6:.3f} MB, "
              f"{ops / 1e9:.4f} G {kind} ops), library {lib_txt} (Qwen talker shape, "
              f"B=1, device time a call, profiler over 10 calls); one call's wall "
              f"{time_ms(kernel):.4f} / {time_ms(plain):.4f} ms (median of 10)", flush=True)


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

    res = {name: {"max_abs_err": 0.0, "library_ms": None} for name in KERNELS}

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
            # QK^T and PV over the 1396 keys the mask keeps
            set_bound(r, nbytes(qkv, cos[:t], sin[:t], got),
                      4 * 2 * 16 * t * 1396 * 64, "bf16")
            r["library_ms"] = sdpa_ms(qkv, cos, sin, 1396)
            print(f"  flash_attention_flat bench shape: exp floor "
                  f"{exp_floor_ms(2 * 16 * t * 1396):.4f} ms beside the bound "
                  f"{r['bound_ms']:.4f} ms; device time a call (profiler over 10 calls, "
                  f"no host enqueue): kernel "
                  f"{device_ms(lambda: flash_attention_flat(qkv, cos, sin, kv, heads=16)):.4f} "
                  f"ms (pre-pass and core), SDPA {sdpa_ms(qkv, cos, sin, 1396, device=True):.4f} ms",
                  flush=True)
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
            # two grouped convs: 2 * rows * C_out * (K * C_in / groups) each
            set_bound(r, nbytes(x, w1, b1, w2, b2, got),
                      2 * 2 * (2 * t) * 1024 * 31 * 64, "bf16")
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
            time_dit_mlp(r, x, mods, w1, b1, w2, b2)
            set_bound(r, nbytes(x, mods, w1, b1, w2, b2, got),
                      4 * 2816 * 1024 * 2048, "bf16")
    del x, w1, w2, got, ref
    # its own generator: the checks after it keep the inputs they had
    check_dit_mlp_shapes(torch.Generator("cuda").manual_seed(4325))
    check_q8_kernels(gen, res)
    for name in F5_KERNELS + Q8_KERNELS + ("quantized_matmul",):
        lib = res[name]["library_ms"]
        how = ("device time a call of its q8_* kernels (twin: all its "
               "kernels), profiler over 10 calls" if name not in F5_KERNELS
               else "CUDA events, median of 10")
        print(f"  {name}: kernel {res[name]['ms']:.4f} ms, plain twin "
              f"{res[name]['plain_ms']:.4f} ms, bound {res[name]['bound_ms']:.4f} ms "
              f"({res[name]['bound_by']}), library call "
              f"{'none' if lib is None else f'{lib:.4f} ms'} (bench shape, {how})",
              flush=True)
    # their own generators: the checks after them keep the inputs they had
    # before kernels 4 and 5 and the flash core's edge cases were added
    check_attention_kernels(torch.Generator("cuda").manual_seed(4321), res)
    check_flash_edges(torch.Generator("cuda").manual_seed(4322), res)
    check_onepass_edges(torch.Generator("cuda").manual_seed(4323), res)
    check_decode_attention_edges(torch.Generator("cuda").manual_seed(4324), res)
    check_decode_kernels(gen, res)
    check_qwen_kernels(gen, res)
    check_bigvgan_kernel(gen, res)
    check_bigvgan_kernel_f32(gen, res)
    return res


def time_dit_mlp(r: dict, x, mods, w1, b1, w2, b2) -> None:
    """Kernel 3 at the bench shape: CUDA events (r["ms"]) and device time
    from a profiler trace of 10 calls (its row pass and both GEMMs), the
    twin's events, and the cuBLAS yardstick: two bf16 torch.matmul at the
    GEMMs' shapes (no LayerNorm, bias or epilogue), a measure of what the
    tensor cores give here, not a call for the same function (library_ms
    stays None); the port never calls it."""
    from tts_tpu_torch.ops.dit_mlp import gemm_plan, mlp_block_fused, mlp_block_plain

    m, d, f = x.shape[0] * x.shape[1], x.shape[2], w1.shape[1]
    a1, a2 = x.reshape(m, d), torch.empty((m, f), dtype=x.dtype, device=x.device).normal_()

    def kernel():
        return mlp_block_fused(x, mods, w1, b1, w2, b2)

    def yardstick():
        return torch.matmul(a1, w1), torch.matmul(a2, w2)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    r["ms"] = time_ms(kernel)
    r["plain_ms"] = time_ms(lambda: mlp_block_plain(x, mods, w1, b1, w2, b2))
    dev = device_ms(kernel)
    print(f"  {card()}: mlp_block_fused bench shape (M {m}, D {d}, F {f}; plans ff1 "
          f"{gemm_plan(m, f, sms)}, ff2 {gemm_plan(m, d, sms)} on {sms} SMs): kernel "
          f"{r['ms']:.4f} ms by CUDA events (median of 10), device time {dev:.4f} ms a call "
          f"(profiler over 10 calls: row pass and both GEMMs); cuBLAS yardstick, two bf16 "
          f"torch.matmul ({m}x{d} @ {d}x{f}, {m}x{f} @ {f}x{d}): {time_ms(yardstick):.4f} ms "
          f"by events, {device_ms(yardstick):.4f} ms device time", flush=True)


def check_dit_mlp_shapes(gen: torch.Generator) -> None:
    """Phase 2, kernel 3 beyond the bench shape, each against its fp32 twin
    on the same bf16 inputs: B 1, T 1088 (M % 128 = 64: the GEMMs' last row
    tile runs half past the end), B 2, T 4608 (M 9216: the DiT forward past
    T 4096), D 512, F 1536, and the bench shape with every row of x offset
    by +100 (the LayerNorm's statistics on rows far from 0)."""
    from tts_tpu_torch.ops.dit_mlp import gemm_plan, mlp_block_fused, mlp_block_plain

    def rn(*shape, scale=1.0, shift=0.0):
        x = torch.randn(shape, generator=gen, device="cuda") * scale + shift
        return x.to(torch.bfloat16)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, t, d, f, offset in ((1, 1088, 1024, 2048, 0.0), (2, 4608, 1024, 2048, 0.0),
                               (2, 1408, 512, 1536, 0.0), (2, 1408, 1024, 2048, 100.0)):
        x = rn(b, t, d, shift=offset)
        w1, w2 = rn(d, f, scale=0.02), rn(f, d, scale=0.02)
        b1, b2 = rn(f, scale=0.1), rn(d, scale=0.1)
        for mods, label in ((rn(3, d, scale=0.5), "shared"), (rn(b, 3, d, scale=0.5),
                                                               "per-row")):
            got = mlp_block_fused(x, mods, w1, b1, w2, b2)
            ref = mlp_block_plain(*(a.float() for a in (x, mods, w1, b1, w2, b2)))
            p1, p2 = gemm_plan(b * t, f, sms), gemm_plan(b * t, d, sms)
            check(f"mlp_block_fused x=({b}, {t}, {d}) F={f} rows +{offset:g} mods {label} "
                  f"(ff1 bn {p1.bn} x {p1.stages} stages, ff2 bn {p2.bn} x {p2.stages}; "
                  f"masked rows {p1.masked_rows})", got, ref)
        if offset == 0.0:
            ms = device_ms(lambda: mlp_block_fused(x, mods, w1, b1, w2, b2))
            print(f"  mlp_block_fused x=({b}, {t}, {d}) F={f}: device time {ms:.4f} ms a call "
                  f"(profiler over 10 calls), bound {4 * b * t * d * f / PEAK_OPS_S['bf16'] * 1e3:.4f}"
                  f" ms (ops)", flush=True)
        del x, w1, w2, got, ref


def sdpa_mha_ms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv,
                device: bool = False) -> float:
    """Kernels 4 and 5's library yardstick: scaled_dot_product_attention on
    the same (B, H, S, D) q, k, v, keys >= kv masked (an int or a (B,)
    tensor), scale 1, by CUDA events (or device time). The port never
    calls it."""
    import torch.nn.functional as F

    b, s = q.shape[0], q.shape[2]
    kvv = torch.as_tensor(kv, device=q.device).reshape(-1, 1)
    mask = (torch.arange(s, device=q.device)[None, :] < kvv).reshape(-1, 1, 1, s)
    mask = mask.expand(b, 1, 1, s)
    return (device_ms if device else time_ms)(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0))


def check_attention_kernels(gen: torch.Generator, res: dict) -> None:
    """Phase 2, kernel 1 at head dim 128 (B 2, H 8, T 1408) and kernels 4
    and 5 on (B, H, S, D) q, k, v as F5's routes give them (scale folded
    into the weights, so 1): kernel 4 in bf16 at the bench shape (B 2, H
    16, S 1408, D 64) packed and unpacked, kv_len 1396 and (1396, 700), and
    at D 128 and 192 (H 8), and the same in fp32; kernel 5 in bf16 at B 2,
    H 16, S 8192, D 64, kv_len 8000 (tts_tpu's call past T 4096: blocks
    256 / 512) and in fp32 at S 2048, kv_len 2000, and in both dtypes at
    D 128 and 192 (H 8, S 2048). Each
    against its fp32 twin on the same inputs (fp32: within TOL32), then
    CUDA-event times (median of 10) beside the twin's (same dtype) and
    SDPA's, with bounds. The kernels' rows: kernel 4 in fp32 at the bench
    shape (the fp32 F5 path's call), kernel 5 in bf16 at S 8192."""
    from tts_tpu_torch.models.f5 import f5_rope_tables
    from tts_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_flat,
                                                   flash_attention_flat_plain,
                                                   flash_attention_plain)

    bf, f32 = torch.bfloat16, torch.float32
    name_limit = card()

    def rn(*shape, dt=bf, scale=0.5):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

    def report(label, r, how):
        lib = r.get("library_ms")
        print(f"  {name_limit}: {label}: kernel {r['ms']:.4f} ms, twin {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
              f"{'none' if lib is None else f'{lib:.4f} ms (SDPA)'} ({how}, CUDA events, "
              f"median of 10)", flush=True)

    per_row = torch.tensor([1396, 700], dtype=torch.int32, device="cuda")
    kv_pipe = torch.full((2,), 1396, dtype=torch.int32, device="cuda")

    # kernel 1 at head dim 128
    cos, sin = (torch.tensor(a, device="cuda").to(bf).float()
                for a in f5_rope_tables(1408, 128))
    qkv = rn(2, 1408, 3 * 8 * 128)
    r = res["flash_attention_flat"]
    for kv, label in ((1396, "1396"), (per_row, "(1396, 700)")):
        r["max_abs_err"] = max(r["max_abs_err"], check(
            f"flash_attention_flat B=2 H=8 D=128 T=1408 kv_len={label}",
            flash_attention_flat(qkv, cos, sin, kv, heads=8),
            flash_attention_flat_plain(qkv.float(), cos, sin, kv, heads=8)))
    one = {"ms": time_ms(lambda: flash_attention_flat(qkv, cos, sin, kv_pipe, heads=8)),
           "plain_ms": time_ms(lambda: flash_attention_flat_plain(qkv, cos, sin, kv_pipe,
                                                                  heads=8)),
           "library_ms": sdpa_ms(qkv, cos, sin, 1396, heads=8)}
    set_bound(one, nbytes(qkv, cos, sin) + qkv.numel() // 3 * 2,
              4 * 2 * 8 * 1408 * 1396 * 128, "bf16")
    report("flash_attention_flat D=128 (B 2, H 8, T 1408, kv_len 1396)", one, "bf16")
    print(f"  flash_attention_flat D=128: exp floor {exp_floor_ms(2 * 8 * 1408 * 1396):.4f} ms",
          flush=True)
    del qkv

    # kernel 4
    r4 = res["flash_attention_onepass"]
    onepass = dict(block_q=128, block_kv=1408, head_block=2)
    for dt, tol in ((bf, TOL), (f32, TOL32)):
        for h, d in ((16, 64), (8, 128), (8, 192)):
            q, k, v = rn(2, h, 1408, d, dt=dt), rn(2, h, 1408, d, dt=dt), rn(2, h, 1408, d, dt=dt)
            f = [a.float() for a in (q, k, v)]
            cases = ((False, 1396), (True, 1396), (False, per_row), (True, per_row)) \
                if d == 64 else ((True, 1396),)
            for packed, kv in cases:
                lab = "1396" if isinstance(kv, int) else "(1396, 700)"
                r4["max_abs_err"] = max(r4["max_abs_err"], check(
                    f"flash_attention (kernel 4) {str(dt)[6:]} B=2 H={h} S=1408 D={d} "
                    f"kv_len={lab} packed={packed}",
                    flash_attention(q, k, v, kv, packed_out=packed, **onepass),
                    flash_attention_plain(*f, kv, packed_out=packed, **onepass), tol))
            if d == 64:
                one = {"ms": time_ms(lambda: flash_attention(q, k, v, kv_pipe, packed_out=True,
                                                             **onepass)),
                       "plain_ms": time_ms(lambda: flash_attention_plain(
                           q, k, v, kv_pipe, packed_out=True, **onepass)),
                       "library_ms": sdpa_mha_ms(q, k, v, kv_pipe)}
                set_bound(one, 4 * nbytes(q), 4 * 2 * 16 * 1408 * 1396 * 64,
                          "bf16" if dt == bf else "fp32")
                report(f"flash_attention (kernel 4) {str(dt)[6:]} bench shape (B 2, H 16, "
                       f"S 1408, D 64, kv_len 1396, packed)", one, str(dt)[6:])
                dev = device_ms(lambda: flash_attention(q, k, v, kv_pipe, packed_out=True,
                                                        **onepass))
                print(f"  {name_limit}: flash_attention (kernel 4) {str(dt)[6:]} bench shape: "
                      f"device time a call (profiler over 10 calls, no host enqueue): "
                      f"kernel {dev:.4f} ms, SDPA "
                      f"{sdpa_mha_ms(q, k, v, kv_pipe, device=True):.4f} ms", flush=True)
                if dt == f32:
                    r4.update(one)
            del q, k, v, f

    # kernel 5
    r5 = res["flash_attention_online"]
    for dt, s, kv, tol in ((bf, 8192, 8000, TOL), (f32, 2048, 2000, TOL32)):
        q, k, v = rn(2, 16, s, 64, dt=dt), rn(2, 16, s, 64, dt=dt), rn(2, 16, s, 64, dt=dt)
        blocks = dict(block_q=256, block_kv=512)
        r5["max_abs_err"] = max(r5["max_abs_err"], check(
            f"flash_attention (kernel 5) {str(dt)[6:]} B=2 H=16 S={s} D=64 kv_len={kv}",
            flash_attention(q, k, v, kv, **blocks),
            flash_attention_plain(q.float(), k.float(), v.float(), kv, **blocks), tol))
        one = {"ms": time_ms(lambda: flash_attention(q, k, v, kv, **blocks)),
               "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, kv, **blocks),
                                   iters=5, warmup=1),
               "library_ms": sdpa_mha_ms(q, k, v, kv)}
        set_bound(one, 4 * nbytes(q), 4 * 2 * 16 * s * kv * 64, "bf16" if dt == bf else "fp32")
        report(f"flash_attention (kernel 5) {str(dt)[6:]} (B 2, H 16, S {s}, D 64, kv_len {kv})",
               one, f"{str(dt)[6:]}, twin median of 5")
        print(f"  flash_attention (kernel 5) {str(dt)[6:]}: exp floor "
              f"{exp_floor_ms(2 * 16 * s * kv):.4f} ms", flush=True)
        if dt == bf:
            r5.update(one)
        del q, k, v
    for dt, tol in ((bf, TOL), (f32, TOL32)):
        for d in (128, 192):
            q, k, v = rn(2, 8, 2048, d, dt=dt), rn(2, 8, 2048, d, dt=dt), rn(2, 8, 2048, d, dt=dt)
            r5["max_abs_err"] = max(r5["max_abs_err"], check(
                f"flash_attention (kernel 5) {str(dt)[6:]} B=2 H=8 S=2048 D={d} kv_len=2000",
                flash_attention(q, k, v, 2000, **blocks),
                flash_attention_plain(q.float(), k.float(), v.float(), 2000, **blocks), tol))
            del q, k, v


# the card's exp rate: 132 SMs x 16 SFU results a clock at 1.83 GHz (boost)
EXP_S = 132 * 16 * 1.83e9


def exp_floor_ms(n_scores: float) -> float:
    """The least time the SFUs take for one exp2 a score, beside a flash
    kernel's tensor-core bound (not part of bound_ms)."""
    return n_scores / EXP_S * 1e3


def check_flash_edges(gen: torch.Generator, res: dict) -> None:
    """Phase 2, the flash core's edge cases against the fp32 twins: kernel
    1 (D 64, B 2, H 4, T 256) at kv_len 0, 1, 63, 64, 65 and per row (0,
    65); at T 64 (one tile) with kv_len 64 and 33; with identity RoPE and
    one query row whose every logit is below -66 (the exp2 flush: that row
    is 0, not NaN); kernel 5 (D 64, B 2, H 4, S 1024) at kv_len 0 (each row
    the mean of v), 1, 63, 64, 65, at D 256 (H 4, S 1024, kv_len 1000) and
    at S 4224 (the route's 128-key blocks, kv_len 4200)."""
    from tts_tpu_torch.models.f5 import f5_rope_tables
    from tts_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_flat,
                                                   flash_attention_flat_plain,
                                                   flash_attention_plain)

    bf = torch.bfloat16

    def rn(*shape, scale=0.5):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(bf)

    def tables(t, d=64):
        return [torch.tensor(a, device="cuda").to(bf).float() for a in f5_rope_tables(t, d)]

    r1, r5 = res["flash_attention_flat"], res["flash_attention_online"]

    def flat(label, qkv, cos, sin, kv, heads=4):
        got = flash_attention_flat(qkv, cos, sin, kv, heads=heads)
        if isinstance(kv, int) and kv == 0:
            # every key masked: the twin's output is all zeros (no rel L2)
            torch.cuda.synchronize()
            ok = not got.any()
            print(f"  flash_attention_flat {label}: all zeros {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise AssertionError("flash_attention_flat kv_len 0: not all zeros")
            return got
        r1["max_abs_err"] = max(r1["max_abs_err"], check(
            f"flash_attention_flat {label}", got,
            flash_attention_flat_plain(qkv.float(), cos, sin, kv, heads=heads)))
        return got

    cos, sin = tables(256)
    qkv = rn(2, 256, 3 * 4 * 64)
    for kv in (0, 1, 63, 64, 65, torch.tensor([0, 65], dtype=torch.int32, device="cuda")):
        lab = kv if isinstance(kv, int) else "(0, 65)"
        flat(f"B=2 H=4 D=64 T=256 kv_len={lab}", qkv, cos, sin, kv)
    cos64, sin64 = tables(64)
    qkv64 = rn(2, 64, 3 * 4 * 64)
    for kv in (64, 33):
        flat(f"B=2 H=4 D=64 T=64 kv_len={kv}", qkv64, cos64, sin64, kv)
    # identity RoPE; every key leans on dimension 0 and query row 5 of each
    # head points against it, so that row's logits are about -90 (< -66)
    ones, zeros = torch.ones(256, 64, device="cuda"), torch.zeros(256, 64, device="cuda")
    x = qkv.float().reshape(2, 256, 3, 4, 64)
    x[:, :, 1, :, 0] = 3.0 + 0.1 * x[:, :, 1, :, 0]
    x[:, 5, 0, :, :] = 0.0
    x[:, 5, 0, :, 0] = -30.0
    low = x.reshape(2, 256, -1).to(bf)
    got = flat("B=2 H=4 D=64 T=256 kv_len=256, row 5 below -66", low, ones, zeros, 256)
    if got[:, 5].any() or not got[:, 6].any():
        raise AssertionError("flash_attention_flat: the row below -66 is not 0")

    blocks = dict(block_q=256, block_kv=512)
    for h, s, d, kvs in ((4, 1024, 64, (0, 1, 63, 64, 65)), (4, 1024, 256, (1000,)),
                         (4, 4224, 64, (4200,))):
        q, k, v = rn(2, h, s, d), rn(2, h, s, d), rn(2, h, s, d)
        bl = dict(block_q=128, block_kv=128) if s % 512 else blocks
        for kv in kvs:
            got = flash_attention(q, k, v, kv, **bl)
            r5["max_abs_err"] = max(r5["max_abs_err"], check(
                f"flash_attention (kernel 5) bf16 B=2 H={h} S={s} D={d} kv_len={kv}", got,
                flash_attention_plain(q.float(), k.float(), v.float(), kv, **bl)))
            if kv == 0:
                check(f"flash_attention (kernel 5) kv_len=0 against the mean of v", got,
                      v.float().mean(dim=2, keepdim=True).expand_as(got))
        del q, k, v


def check_onepass_edges(gen: torch.Generator, res: dict) -> None:
    """Phase 2, kernel 4 in bf16 (the flash core, FIXED) and in fp32 against
    the fp32 twin at the tile edges: B 2, H 4, S 256, D 64 at kv_len 0 (all
    zeros), 1, 63, 64, 65 and per row (0, 65), packed and not; S 64 (one
    tile) at kv_len 64 and 33; D 256 (S 1024, kv_len 1000), packed and not;
    and in fp32 two query rows whose every logit is below -66: one at about
    -90, where p underflows to 0 in fp32 (the row is 0), and one at about
    -70, where p is denormal and exp2f keeps it, as the twin does (the row
    is not 0)."""
    from tts_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    r4 = res["flash_attention_onepass"]
    onepass = dict(block_q=64, block_kv=4096, head_block=1)

    def rn(*shape, dt, scale=0.5):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

    def one(label, q, k, v, kv, packed, tol):
        got = flash_attention(q, k, v, kv, packed_out=packed, **onepass)
        if isinstance(kv, int) and kv == 0:
            # every key masked: the 1e-37 guard gives zeros
            torch.cuda.synchronize()
            ok = not got.any()
            print(f"  flash_attention (kernel 4) {label}: all zeros {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise AssertionError("flash_attention kernel 4 kv_len 0: not all zeros")
            return got
        r4["max_abs_err"] = max(r4["max_abs_err"], check(
            f"flash_attention (kernel 4) {label}", got,
            flash_attention_plain(q.float(), k.float(), v.float(), kv, packed_out=packed,
                                  **onepass), tol))
        return got

    for dt, tol in ((torch.bfloat16, TOL), (torch.float32, TOL32)):
        name = str(dt)[6:]
        q, k, v = (rn(2, 4, 256, 64, dt=dt) for _ in range(3))
        for i, kv in enumerate((0, 1, 63, 64, 65,
                                torch.tensor([0, 65], dtype=torch.int32, device="cuda"))):
            lab = kv if isinstance(kv, int) else "(0, 65)"
            one(f"{name} B=2 H=4 S=256 D=64 kv_len={lab} packed={bool(i % 2)}", q, k, v, kv,
                bool(i % 2), tol)
        q, k, v = (rn(2, 4, 64, 64, dt=dt) for _ in range(3))
        for kv in (64, 33):
            one(f"{name} B=2 H=4 S=64 D=64 kv_len={kv}", q, k, v, kv, False, tol)
        q, k, v = (rn(2, 4, 1024, 256, dt=dt) for _ in range(3))
        for packed in (False, True):
            one(f"{name} B=2 H=4 S=1024 D=256 kv_len=1000 packed={packed}", q, k, v, 1000,
                packed, tol)
        del q, k, v

    # fp32 rows below -66: every key leans on dimension 0, query rows 5 and 6
    # point against it (logits about -90 and -70 at scale 1)
    q, k, v = (rn(2, 4, 256, 64, dt=torch.float32) for _ in range(3))
    k[..., 0] = 3.0 + 0.01 * k[..., 0]
    q[:, :, 5:7] = 0.0
    q[:, :, 5, 0] = -30.0
    q[:, :, 6, 0] = -70.0 / 3.0
    got = one("fp32 B=2 H=4 S=256 D=64 kv_len=250, rows 5 and 6 below -66", q, k, v, 250,
              False, TOL32)
    ref = flash_attention_plain(q, k, v, 250, **onepass)
    if got[:, :, 5].any() or not got[:, :, 6].any() or not ref[:, :, 6].any():
        raise AssertionError("flash_attention kernel 4 fp32: row 5 is not 0 or row 6 is")
    check("flash_attention (kernel 4) fp32 row 6 (denormal p) alone", got[:, :, 6],
          ref[:, :, 6], TOL32)


def check_decode_attention_edges(gen: torch.Generator, res: dict) -> None:
    """Phase 2, kernel 13 at its cluster plan's slice edges against the
    fp32 twin: head dim 128 (16/8 heads, T 2048) at kv_len 16, 17, 32, 33,
    128, 129, 255, 256, 257, 512, 513 (B 1; some at B 3); head dim 64 (16/2
    heads, G 8, T 512) at kv_len 1, 17, 33, 126, 257, 512 with scale 0.125;
    G 1 (8/8 heads x 128, T 256) at kv_len 200; G 8 at head dim 128 (16/2
    heads, T 256: 64-row rounds, two of them in one CTA) at kv_len 100 and
    256. Then one call at kv_len 2047 is one launch (a profiler trace holds
    one kernel; LAUNCHES grows by one), and the predictor's shape (B 1, T
    32, kv_len 17) is timed beside SDPA."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.ops.decode_attention import (cluster_plan, decode_gqa_attention,
                                                    decode_gqa_attention_plain)

    r = res["decode_gqa_attention"]

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    for b, h, kvh, t, d, lens, scale in (
            (1, 16, 8, 2048, 128, (16, 17, 32, 33, 128, 129, 255, 256, 257, 512, 513), 1.0),
            (3, 16, 8, 2048, 128, (17, 33, 257), 1.0),
            (2, 16, 2, 512, 64, (1, 17, 33, 126, 257, 512), 0.125),
            (1, 8, 8, 256, 128, (200,), 1.0),
            (1, 16, 2, 256, 128, (100, 256), 1.0)):
        q, k, v = rn(b, h, d), rn(b, kvh, t, d), rn(b, kvh, t, d)
        for kv_len in lens:
            r["max_abs_err"] = max(r["max_abs_err"], check(
                f"decode_gqa_attention B={b} {h}/{kvh} heads x {d} T={t} kv_len={kv_len} "
                f"scale={scale} (plan {cluster_plan(kv_len)})",
                decode_gqa_attention(q, k, v, kv_len, scale),
                decode_gqa_attention_plain(q.float(), k.float(), v.float(), kv_len, scale)))

    # one call, one launch, at the longest live length of a 2048-row cache
    q, k, v = rn(1, 16, 128), rn(1, 8, 2048, 128), rn(1, 8, 2048, 128)
    decode_gqa_attention(q, k, v, 2047)
    torch.cuda.synchronize()
    for _ in range(3):
        before = LAUNCHES["decode_gqa_attention"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            decode_gqa_attention(q, k, v, 2047)
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [(e.key, e.count) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        api = sum(e.count for e in events if e.key in (
            "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaMalloc"))
        counted = LAUNCHES["decode_gqa_attention"] - before
        print(f"  decode_gqa_attention kv_len=2047 (plan {cluster_plan(2047)}): device "
              f"kernels {kernels}, launch and malloc calls {api}, wrapper count {counted}",
              flush=True)
        n_dev = sum(c for _, c in kernels)
        if n_dev > 1 or api > 1 or counted != 1:
            raise AssertionError("decode_gqa_attention: one call is not one launch")
        if n_dev == 1:
            break
    else:
        raise AssertionError("decode_gqa_attention: three traces held no kernel")

    # the predictor's shape, beside the talker's (timed in check_qwen_kernels)
    name_limit = card()
    q, k, v = rn(1, 16, 128), rn(1, 8, 32, 128), rn(1, 8, 32, 128)
    q4, k4, v4 = q[:, :, None], k[:, :, :17], v[:, :, :17]
    one = {"ms": device_ms(lambda: decode_gqa_attention(q, k, v, 17)),
           "plain_ms": device_ms(lambda: decode_gqa_attention_plain(q, k, v, 17)),
           "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
               q4, k4, v4, scale=1.0, enable_gqa=True))}
    set_bound(one, nbytes(q, k4, v4) + q.numel() * 2, 4 * 16 * 17 * 128, "bf16")
    print(f"  {name_limit}: decode_gqa_attention (Qwen predictor shape, B=1, T=32, kv_len=17):"
          f" kernel {one['ms']:.4f} ms, plain twin {one['plain_ms']:.4f} ms, bound "
          f"{one['bound_ms']:.4f} ms ({one['bound_by']}), library {one['library_ms']:.4f} ms "
          f"(SDPA, enable_gqa) (device time a call, profiler over 10 calls); one call's wall "
          f"{time_ms(lambda: decode_gqa_attention(q, k, v, 17)):.4f} ms (median of 10)",
          flush=True)


# the BigVGAN bench stages kernel 10 runs (bigvgan_v2_24khz_100band_256x at
# the bench mel of 512 frames): (stage, C, T)
BV_STAGES = ((2, 192, 16384), (3, 96, 32768), (4, 48, 65536), (5, 24, 131072))
BV_KS = (3, 7, 11)
BV_DILS = (1, 3, 5)
# fp32 operations of one anti-aliased act per (t, c): two upsample phases
# of 6 products and 5 sums, the snake (alpha product, sine, square,
# product, sum) on each, 12 decimation products and 11 sums
ACT_OPS = 2 * (6 + 5) + 2 * 5 + 12 + 11


def amp_block_inputs(gen: torch.Generator, b: int, t: int, c: int, k: int,
                     dt=torch.bfloat16) -> tuple:
    """Kernel 10's operands at one shape: x, then w1, b1, w2, b2 at a scale
    that keeps the residual stream O(1), snake alphas 1 + U(0, 1) and
    reciprocals U(0.5, 1.5), all of dtype dt."""
    j = len(BV_DILS)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

    def uni(lo):
        return (lo + torch.rand((j, c), generator=gen, device="cuda")).to(dt)

    ws = (k * c) ** -0.5
    return (rn(b, t, c), rn(j, k, c, c, scale=ws), rn(j, c, scale=0.1),
            rn(j, k, c, c, scale=ws), rn(j, c, scale=0.1), uni(1.0), uni(0.5), uni(1.0),
            uni(0.5))


def amp_block_bound(r: dict, b: int, t: int, c: int, k: int, dt=torch.bfloat16) -> None:
    """Kernel 10's bound at one resblock: x read and written once and the
    weights read once (bytes); 12 k C^2 T flops (two convs a branch, three
    branches: bf16 tensor cores, or fp32); 6 acts of ACT_OPS fp32
    operations per (t, c)."""
    j = len(BV_DILS)
    elt = torch.empty((), dtype=dt).element_size()
    nb = elt * (2 * b * t * c + 2 * j * k * c * c + 6 * j * c)
    set_bound(r, nb, 2 * 2 * j * k * c * c * b * t, "bf16" if dt == torch.bfloat16 else "fp32",
              2 * j * ACT_OPS * b * t * c)


def check_bigvgan_kernel(gen: torch.Generator, res: dict) -> None:
    """Phase 2, kernel 10 at the BigVGAN bench stages 2 (C 192, T 16384) and
    5 (C 24, T 131072) for k = 3, 7, 11 against its fp32 twin on the same
    bf16 inputs, and at both stages' C with 4 batch rows of T / 4 (k = 11);
    then CUDA-event times (median of 10) of the kernel and its
    bf16 twin at all four stages the bench call runs it at, with bounds.
    The kernels' row is stage 2 at k = 11, the heaviest resblock."""
    from tts_tpu_torch.ops.bigvgan_stage import amp_block_fused, amp_block_fused_plain

    r = res["amp_block_fused"]
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    name_limit = card()
    for stage, c, t in BV_STAGES:
        for k in BV_KS:
            args = amp_block_inputs(gen, 1, t, c, k)
            kern = lambda: amp_block_fused(*args, k=k, dils=BV_DILS)
            plain = lambda: amp_block_fused_plain(*args, k=k, dils=BV_DILS)
            if stage in (2, 5):
                got = kern()
                ref = amp_block_fused_plain(*[a.float() for a in args], k=k, dils=BV_DILS)
                r["max_abs_err"] = max(r["max_abs_err"], check(
                    f"amp_block_fused stage {stage} x=(1, {t}, {c}) k={k} dils={BV_DILS}",
                    got, ref))
                del got, ref
            one = {}
            one["ms"], one["plain_ms"] = time_ms(kern), time_ms(plain)
            amp_block_bound(one, 1, t, c, k)
            for key in tot:
                tot[key] += one[key]
            print(f"  {name_limit}: amp_block_fused stage {stage} (C {c}, T {t}) k={k}: "
                  f"kernel {one['ms']:.4f} ms, bf16 twin {one['plain_ms']:.4f} ms, bound "
                  f"{one['bound_ms']:.4f} ms ({one['bound_by']}) (CUDA events, median of 10)",
                  flush=True)
            if (stage, k) == (2, 11):
                r.update(one)
            del args
    for stage, c, t in (BV_STAGES[0], BV_STAGES[-1]):   # batch rows: a grid dimension
        args = amp_block_inputs(gen, 4, t // 4, c, 11)
        got = amp_block_fused(*args, k=11, dils=BV_DILS)
        ref = amp_block_fused_plain(*[a.float() for a in args], k=11, dils=BV_DILS)
        r["max_abs_err"] = max(r["max_abs_err"], check(
            f"amp_block_fused stage {stage} x=(4, {t // 4}, {c}) k=11 dils={BV_DILS}", got, ref))
        del got, ref, args
    print(f"  {name_limit}: amp_block_fused over the 12 resblocks of a bench call: kernel "
          f"{tot['ms']:.4f} ms, bf16 twin {tot['plain_ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f} ms (sum of each resblock's); library call: none",
          flush=True)


def check_bigvgan_kernel_f32(gen: torch.Generator, res: dict) -> None:
    """Phase 2, kernel 10's fp32 form at the BigVGAN bench stages 3 (C 96,
    T 32768) and 5 (C 24, T 131072) for k = 3, 7, 11, and at 4 batch rows of
    T / 4 (k = 11), against its fp32 twin on the same inputs (within TOL32;
    TF32 is off); then CUDA-event times (median of 10) of the kernel and
    the twin at stages 3-5, the ones an fp32 bench call runs it at (C <=
    128), with bounds. The kernels' row is stage 3 at k = 11."""
    from tts_tpu_torch.ops.bigvgan_stage import amp_block_fused, amp_block_fused_plain

    f32 = torch.float32
    r = res["amp_block_fused_f32"]
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    name_limit = card()
    for stage, c, t in BV_STAGES[1:]:
        for k in BV_KS:
            args = amp_block_inputs(gen, 1, t, c, k, f32)
            kern = lambda: amp_block_fused(*args, k=k, dils=BV_DILS)
            plain = lambda: amp_block_fused_plain(*args, k=k, dils=BV_DILS)
            if stage in (3, 5):
                r["max_abs_err"] = max(r["max_abs_err"], check(
                    f"amp_block_fused fp32 stage {stage} x=(1, {t}, {c}) k={k} "
                    f"dils={BV_DILS}", kern(), plain(), TOL32))
            one = {"ms": time_ms(kern), "plain_ms": time_ms(plain)}
            amp_block_bound(one, 1, t, c, k, f32)
            for key in tot:
                tot[key] += one[key]
            print(f"  {name_limit}: amp_block_fused fp32 stage {stage} (C {c}, T {t}) k={k}: "
                  f"kernel {one['ms']:.4f} ms, fp32 twin {one['plain_ms']:.4f} ms, bound "
                  f"{one['bound_ms']:.4f} ms ({one['bound_by']}) (CUDA events, median of 10)",
                  flush=True)
            if (stage, k) == (3, 11):
                r.update(one)
            del args
    for stage, c, t in (BV_STAGES[1], BV_STAGES[-1]):
        args = amp_block_inputs(gen, 4, t // 4, c, 11, f32)
        r["max_abs_err"] = max(r["max_abs_err"], check(
            f"amp_block_fused fp32 stage {stage} x=(4, {t // 4}, {c}) k=11 dils={BV_DILS}",
            amp_block_fused(*args, k=11, dils=BV_DILS),
            amp_block_fused_plain(*args, k=11, dils=BV_DILS), TOL32))
        del args
    print(f"  {name_limit}: amp_block_fused fp32 over the 9 resblocks of an fp32 bench call "
          f"(stages 3-5): kernel {tot['ms']:.4f} ms, fp32 twin {tot['plain_ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f} ms (sum of each resblock's); library call: none", flush=True)


def sdpa_ms(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, kv: int,
            heads: int = 16, device: bool = False) -> float:
    """Kernel 1's library yardstick: scaled_dot_product_attention on q, k
    roped ahead (as the twin ropes them) and v, keys >= kv masked, scale 1
    (F5 folds it into wqkv); CUDA events around one call, or with `device`
    its kernels' device time a call. The port never calls it."""
    import torch.nn.functional as F

    b, t, n3 = qkv.shape
    d = n3 // (3 * heads)
    x = qkv.reshape(b, t, 3, heads, d).float()
    c, s = cos[:t][None, :, None, :], sin[:t][None, :, None, :]

    def rope(u):
        return (u * c + torch.cat([-u[..., d // 2:], u[..., :d // 2]], dim=-1) * s
                ).to(qkv.dtype)

    q, k = rope(x[:, :, 0]).transpose(1, 2), rope(x[:, :, 1]).transpose(1, 2)
    v = x[:, :, 2].to(qkv.dtype).transpose(1, 2)
    mask = (torch.arange(t, device=qkv.device) < kv)[None, None, None, :]
    timer = device_ms if device else time_ms
    return timer(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0))


def check_q8_kernels(gen: torch.Generator, res: dict) -> None:
    """Phase 2, kernels 6-9 at the F5 bench shapes (M = 2 x 1408 rows, D
    1024, qkv 3072, F 2048) against their fp32 twins on the same bf16
    activations and int8 weights; then kernels 6-8 on the same activations
    in fp32 (no new draws) against the twins, rel L2 within TOL32: where
    the kernel's fp32 LayerNorm or gelu rounds otherwise than the twin's,
    a value on a tie of v / xs takes the other int8 step, which moves one
    output by one step of x times one weight, under 2^-10 of max |ref| (so
    max |err| is held to TOL), and the rel L2 by far less. Kernels 7 and 6
    get their weights stored K-major, as the pipeline lays them out; their
    yardstick is torch._int_mm at their GEMMs' shapes; check_q8_shapes
    takes them past the bench shape, time_q8_forms through both forms of
    their GEMMs where the plan picks either."""
    from tts_tpu_torch.ops.dit_mlp import mlp_block_fused_q8, mlp_block_q8_plain
    from tts_tpu_torch.ops.quant_matmul import (ln_qkv_q8, ln_qkv_q8_plain,
                                                out_proj_residual_q8,
                                                out_proj_residual_q8_plain, q8_plan,
                                                quantized_matmul, quantized_matmul_plain,
                                                to_kmajor)
    from tts_tpu_torch.quant.weight_only import quantize_int8_eager

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def qw(*shape):
        w = quantize_int8_eager(rn(*shape, scale=0.02))
        return w.q, w.scale

    m, d, n, f = 2816, 1024, 3072, 2048
    x = rn(2, 1408, d)
    wqkv, wo, w1, w2 = qw(d, n), qw(d, d), qw(d, f), qw(f, d)
    # kernels 7 and 6 read their weights K-major, as quantize_dit lays them
    # out for the pipeline (kernel 9 takes wqkv row-major)
    wqkv7, w1, w2 = (to_kmajor(wqkv[0]), wqkv[1]), (to_kmajor(w1[0]), w1[1]), \
        (to_kmajor(w2[0]), w2[1])

    def run(name, label, kernel, plain, args, ops):
        """Check kernel(*args) against plain on fp32 copies; time both at
        the first call."""
        f32 = [a.float() if a.is_floating_point() else a for a in args]
        got = kernel(*args)
        ref = plain(*f32)
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], check(f"{name} {label}", got, ref))
        if "ms" not in r:
            # device time of the int8 kernels (q8_rows, q8_gemm, q8_wgmma*)
            # alone: the wrapper's host work and its fp32 copies of biases
            # and mods are not the kernel's; the twin's is all its kernels' time
            r["ms"] = device_ms(lambda: kernel(*args), only="q8_")
            r["plain_ms"] = device_ms(lambda: plain(*args))
            print(f"  {name}: one call's wall {time_ms(lambda: kernel(*args)):.4f} ms "
                  f"(median of 10)", flush=True)
            set_bound(r, nbytes(*args, got), ops, "int8")
        del got, ref

    calls = [("ln_qkv_q8", "x=(2, 1408, 1024) N=3072", ln_qkv_q8, ln_qkv_q8_plain,
              (x, rn(2, d, scale=0.5), *wqkv7, rn(n, scale=0.1)), 2 * m * d * n),
             ("out_proj_residual_q8", "o=(2, 1408, 1024) D=1024", out_proj_residual_q8,
              out_proj_residual_q8_plain,
              (rn(2, 1408, d), *wo, rn(d, scale=0.1), rn(d, scale=0.5), x), 2 * m * d * d)]
    for mods, label in ((rn(3, d, scale=0.5), "shared (3, D)"),
                        (rn(2, 3, d, scale=0.5), "per-row (B, 3, D)")):
        calls.append(("mlp_block_fused_q8", f"x=(2, 1408, 1024) F=2048 mods {label}",
                      mlp_block_fused_q8, mlp_block_q8_plain,
                      (x, mods, *w1, rn(f, scale=0.1), *w2, rn(d, scale=0.1)),
                      4 * m * d * f))
    for call in calls:
        run(*call)
    for name, label, kernel, plain, args, _ in calls:
        a32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], check(
            f"{name} {label}, fp32 activations", kernel(*a32), plain(*a32), TOL32, TOL))
    x2 = x.reshape(m, d)
    run("quantized_matmul", "x=(2816, 1024) N=3072", quantized_matmul,
        quantized_matmul_plain, (x2, *wqkv), 2 * m * d * n)
    # torch._int_mm at the GEMMs' shapes, the s8 products alone (no row
    # quantization, no rescale): kernel 9's library call, and a yardstick
    # beside kernels 7 and 6 (no call computes either's function)
    ym = {shape: int_mm_ms(*shape) for shape in ((m, d, n), (m, d, f), (m, f, d))}
    res["quantized_matmul"]["library_ms"] = ym[(m, d, n)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"  {card()}: ln_qkv_q8 bench shape (plan {q8_plan(m, n, d, sms)}): device time "
          f"{res['ln_qkv_q8']['ms']:.4f} ms, bound {res['ln_qkv_q8']['bound_ms']:.4f} ms; "
          f"yardstick torch._int_mm ({m}x{d} @ {d}x{n}) {ym[(m, d, n)]:.4f} ms device time",
          flush=True)
    k6_split = device_split(lambda: mlp_block_fused_q8(*calls[2][4]))
    print(f"  {card()}: mlp_block_fused_q8 bench shape (plans ff1 "
          f"{q8_plan(m, f, d, sms, whole_rows=True)}, ff2 {q8_plan(m, d, f, sms)}): device "
          f"time {res['mlp_block_fused_q8']['ms']:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in k6_split.items()) + "), bound "
          f"{res['mlp_block_fused_q8']['bound_ms']:.4f} ms; yardstick torch._int_mm "
          f"({m}x{d} @ {d}x{f} and {m}x{f} @ {f}x{d}) {ym[(m, d, f)]:.4f} + "
          f"{ym[(m, f, d)]:.4f} = {ym[(m, d, f)] + ym[(m, f, d)]:.4f} ms device time",
          flush=True)
    time_q8_forms(torch.Generator("cuda").manual_seed(4329))
    check_q8_shapes(torch.Generator("cuda").manual_seed(4327), res)


Q8_SPLIT = (("q8_rows", "q8_rows"), ("ff1 (q8_wgmma_hidden_kernel)", "q8_wgmma_hidden"),
            ("GEMM (q8_wgmma_kernel)", "q8_wgmma_kernel"))


def device_split(fn, parts=Q8_SPLIT, iters: int = 10) -> dict:
    """Device time a call of fn() by kernel: {label: ms} over the kernels
    whose names hold each pattern, from a torch.profiler trace of `iters`
    calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / iters) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return {label: sum(ms for k, ms in rows if pat in k) for label, pat in parts}


def time_q8_forms(gen: torch.Generator) -> None:
    """Kernel 7 and kernel 6 (its ff2; ff1 keeps its one cluster form) in
    each form of the bias / residual GEMM, q8_plan's choice swapped for the
    call, at the bench shape (where the plan takes 3 stages, 2 CTAs an SM)
    and at grids that fit one CTA an SM (where it takes 4 stages, 1 CTA an
    SM): kernel 6 at B 2 T 1024 (the bucket-1024 request: ff2 128 CTAs), B
    1 T 1088 (72) and B 2 T 512 (64), kernel 7 at B 2 T 256 (96). Device
    time a call by kernel, and the output bitwise equal to the planned
    form's (a form changes no rounding)."""
    from tts_tpu_torch.ops import dit_mlp, quant_matmul
    from tts_tpu_torch.quant.weight_only import quantize_int8_eager

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def qw(*shape):
        w = quantize_int8_eager(rn(*shape, scale=0.02))
        return quant_matmul.to_kmajor(w.q), w.scale

    d, n, f = 1024, 3072, 2048
    wqkv, w1, w2 = qw(d, n), qw(d, f), qw(f, d)
    cases = []
    for b, t in ((2, 1408), (2, 256)):
        cases.append(("ln_qkv_q8", quant_matmul, quant_matmul.ln_qkv_q8, b, t,
                      (rn(b, t, d), rn(2, d, scale=0.5), *wqkv, rn(n, scale=0.1))))
    for b, t in ((2, 1408), (2, 1024), (1, 1088), (2, 512)):
        cases.append(("mlp_block_fused_q8", dit_mlp, dit_mlp.mlp_block_fused_q8, b, t,
                      (rn(b, t, d), rn(b, 3, d, scale=0.5), *w1, rn(f, scale=0.1), *w2,
                       rn(d, scale=0.1))))
    plan = quant_matmul.q8_plan
    for name, module, kernel, b, t, args in cases:
        want = kernel(*args)
        for stages in (4, 3):
            def forced(rows, n, k, sms, whole_rows=False, _s=stages):
                p = plan(rows, n, k, sms, whole_rows)
                return p if whole_rows else p._replace(stages=_s)

            with swapped(module, {"q8_plan": forced}):
                same = torch.equal(kernel(*args), want)
                split = device_split(lambda: kernel(*args))
            print(f"  {card()}: {name} B {b} T {t}, {'ff2 ' if module is dit_mlp else ''}"
                  f"form ({stages} stages, {1 if stages == 4 else 2} CTA(s) an SM): device "
                  f"time {sum(split.values()):.4f} ms a call (" + ", ".join(
                      f"{k} {v:.4f}" for k, v in split.items() if v) +
                  f"), output {'bitwise equal to' if same else 'DIFFERENT from'} the planned "
                  f"form's", flush=True)
            if not same:
                raise AssertionError(f"{name}: a GEMM form changed the output")


def int_mm_ms(m: int, k: int, n: int) -> float:
    """Device time of one torch._int_mm of random int8 (m, k) @ (k, n), with
    the (k, n) operand row-major or, where that is refused, column-major."""
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda")
    b = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda")
    for w in (b, b.t().contiguous().t()):
        try:
            return device_ms(lambda: torch._int_mm(a, w))
        except RuntimeError as e:
            print(f"  torch._int_mm refused a {tuple(w.stride())}-strided operand: {e}",
                  flush=True)
    raise RuntimeError("torch._int_mm took neither layout")


def check_q8_shapes(gen: torch.Generator, res: dict) -> None:
    """Phase 2, kernels 7 and 6 past the bench shape, in bf16 and fp32
    activations against their fp32 twins (TOL; fp32 TOL32 rel L2 with max
    |err| TOL): a ragged M (B 2, T 1400: the last row tile 16 rows past the
    end), a half-empty last row tile (B 1, T 1088), and D 576 (a last K step
    of 64 values; N 1152) and kernel 6 at D 640, F 1152, whose ff1 takes
    the 128-column cluster form (9 CTAs, past the portable 8). Device time
    by kernel and bound at each, with the plans."""
    from tts_tpu_torch.ops.dit_mlp import mlp_block_fused_q8, mlp_block_q8_plain
    from tts_tpu_torch.ops.quant_matmul import ln_qkv_q8, ln_qkv_q8_plain, q8_plan, to_kmajor
    from tts_tpu_torch.quant.weight_only import quantize_int8_eager

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def qw(*shape):
        w = quantize_int8_eager(rn(*shape, scale=0.02))
        return to_kmajor(w.q), w.scale

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # (B, T, kernel 7's D and N, kernel 6's D and F)
    for b, t, d7, n, d, f in ((2, 1400, 1024, 3072, 1024, 2048),
                              (1, 1088, 1024, 3072, 1024, 2048),
                              (2, 1408, 576, 1152, 640, 1152)):
        m = b * t
        x7, x = rn(b, t, d7), rn(b, t, d)
        wqkv, w1, w2 = qw(d7, n), qw(d, f), qw(f, d)
        k7 = (x7, rn(2, d7, scale=0.5), *wqkv, rn(n, scale=0.1))
        k6 = (x, rn(b, 3, d, scale=0.5), *w1, rn(f, scale=0.1), *w2, rn(d, scale=0.1))
        for name, kernel, plain, args, label, ops in (
                ("ln_qkv_q8", ln_qkv_q8, ln_qkv_q8_plain, k7,
                 f"x=({b}, {t}, {d7}) N={n} (plan {q8_plan(m, n, d7, sms)})", 2 * m * d7 * n),
                ("mlp_block_fused_q8", mlp_block_fused_q8, mlp_block_q8_plain, k6,
                 f"x=({b}, {t}, {d}) F={f} mods per-row (plans ff1 "
                 f"{q8_plan(m, f, d, sms, whole_rows=True)}, ff2 {q8_plan(m, d, f, sms)})",
                 4 * m * d * f)):
            got = kernel(*args)
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], check(
                f"{name} {label}", got, plain(*(a.float() if a.is_floating_point() else a
                                                for a in args))))
            a32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], check(
                f"{name} {label}, fp32 activations", kernel(*a32), plain(*a32), TOL32,
                TOL))
            r = {}
            set_bound(r, nbytes(*args, got), ops, "int8")
            split = device_split(lambda: kernel(*args))
            print(f"  {name} x={tuple(args[0].shape)}: device time {sum(split.values()):.4f} "
                  f"ms a call (profiler over 10 calls: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items() if v) +
                  f"), bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
            del got


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
    per_step = {**dict.fromkeys(KERNELS, 0), "flash_attention_flat": cfg.depth,
                "mlp_block_fused": cfg.depth, "conv_pos_embed_fused": 1}
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


def synth_checked(pipe, audio, words: int, per_step: dict, label: str) -> None:
    """One request through `pipe`: int16 audio of the expected length,
    finite and not all zero, and per_step[k] launches of each kernel k a
    NFE step."""
    from tts_tpu_torch.ops._build import LAUNCHES

    cfg = pipe.cfg
    gen_text = " ".join(["word"] * words)
    *_, buckets, n_keep = pipe._prepare(audio, REF_TEXT, gen_text)
    before = dict(LAUNCHES)
    wav, stats = pipe.synthesize(audio, REF_TEXT, gen_text)
    grew = {k: LAUNCHES[k] - before.get(k, 0) for k in KERNELS}
    print(f"  {label} request {words} words: frame bucket {buckets[2]}, {len(wav)} "
          f"int16 samples, wall {stats.wall_s:.4f} s, peak |wav| {stats.peak:.6g}, "
          f"launches {grew}", flush=True)
    expect = min(n_keep, (buckets[3] - 1) * cfg.hop)
    if wav.dtype != np.int16 or len(wav) != expect:
        raise AssertionError(f"{label}: expected {expect} int16 samples, got "
                             f"{len(wav)} {wav.dtype}")
    if not math.isfinite(stats.peak) or not wav.any():
        raise AssertionError(f"{label}: the waveform is not finite or all zeros")
    for k, n in per_step.items():
        if grew[k] != n * (cfg.nfe_steps - 1):
            raise AssertionError(f"{label}: {k} launched {grew[k]} times, expected "
                                 f"{n * (cfg.nfe_steps - 1)}")
    return len(wav)


@contextlib.contextmanager
def swapped(module, swap: dict):
    """Set module.<name> = swap[name] for the block (a model module's
    kernel wrappers to their plain twins), then restore them."""
    old = {k: getattr(module, k) for k in swap}
    for k, v in swap.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def twins_in_dit():
    """Run models/f5's kernels through their plain twins on the card
    (kernels 1-3, 6-8, and 4 and 5 behind `flash_attention`)."""
    import tts_tpu_torch.models.f5 as mf5
    from tts_tpu_torch.ops import dit_mlp, flash_attention, grouped_conv, quant_matmul

    return swapped(mf5, {
        "ln_qkv_q8": quant_matmul.ln_qkv_q8_plain,
        "out_proj_residual_q8": quant_matmul.out_proj_residual_q8_plain,
        "mlp_block_fused_q8": dit_mlp.mlp_block_q8_plain,
        "mlp_block_fused": dit_mlp.mlp_block_plain,
        "conv_pos_embed_fused": grouped_conv.conv_pos_embed_plain,
        "flash_attention_flat": flash_attention.flash_attention_flat_plain,
        "flash_attention": flash_attention.flash_attention_plain})


def check_bf16_forward(pipe, t: int, kv, label: str) -> dict:
    """One bf16 DiT forward at T frames through the kernels the routes pick
    on the card, and through their twins in bf16 and in fp32, on the same
    weights (int8 where the pipeline quantized them). As check_step for
    Kani: the kernel route's error against fp32 at most STEP_SLACK times
    the bf16 twin route's (22 blocks of bf16 rounding move the output by
    more than 2^-6 on either route). Returns the launches of the kernel
    run. The W8A8 bench bucket (1408 frames, keys masked at 1396) runs
    kernels 1, 2, 6, 7 and 8; bf16 at T 4608 runs kernel 5."""
    from tts_tpu_torch.models.f5 import dit_forward, f5_rope_tables
    from tts_tpu_torch.ops._build import LAUNCHES

    cfg, params = pipe.cfg, pipe.params

    gen = torch.Generator("cuda").manual_seed(5)
    noise = torch.randn((1, t, cfg.n_mels), generator=gen, device="cuda")
    cond = torch.randn((1, t, cfg.n_mels + cfg.text_dim), generator=gen, device="cuda")
    drop = torch.randn((1, t, cfg.n_mels + cfg.text_dim), generator=gen, device="cuda")
    if t <= params["rope_cos"].shape[0]:
        cos, sin = params["rope_cos"][:t].float(), params["rope_sin"][:t].float()
    else:   # past the pipeline's tables: the same tables, as long as T
        cos, sin = (torch.tensor(a, device="cuda").to(params["rope_cos"].dtype).float()
                    for a in f5_rope_tables(t, cfg.head_dim))

    def fwd(p, dt):
        a, b = dit_forward(p, noise.to(dt), cond.to(dt), drop.to(dt), cos, sin, cfg,
                           kv_len=kv, step_idx=3)
        return torch.cat([a, b]).float()

    before = dict(LAUNCHES)
    kern = fwd(params, torch.bfloat16)
    torch.cuda.synchronize()
    grew = {k: LAUNCHES[k] - before.get(k, 0) for k in KERNELS}
    with twins_in_dit():
        plain = fwd(params, torch.bfloat16)
        ref = fwd(cast_tree(params, torch.float32), torch.float32)

    def rel(a, b=ref):
        return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

    e_k, e_p = rel(kern), rel(plain)
    ok = bool(torch.isfinite(kern).all()) and e_k <= STEP_SLACK * e_p
    kv_l = kv if isinstance(kv, int) else "per row"
    print(f"  {label} dit_forward ({t} frames, kv_len {kv_l}, step 3), rel L2 against the "
          f"fp32 twin route: kernels {e_k:.6g}, bf16 twins {e_p:.6g} (limit {STEP_SLACK} "
          f"x); kernels against bf16 twins {rel(kern, plain):.6g}, launches "
          f"{ {k: n for k, n in grew.items() if n} } {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"the {label} kernel route is less accurate than its twins")
    return grew


def run_w8a8(pipe, name_limit: str, bench16: dict) -> tuple:
    """Phase 5: F5Pipeline(quantize="w8a8") over the same F5 and Vocos
    models: three requests through kernels 6-8, one forward against the
    twins, latency and sustained RTF; then one quantize=4 request. Returns
    the W8A8 pipeline and the launch counts of its three requests."""
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.f5 import F5Pipeline

    cfg = pipe.cfg
    t0 = time.perf_counter()
    q8 = F5Pipeline(pipe.f5, pipe.vocab, pipe.vocos, quantize="w8a8")
    torch.cuda.synchronize()
    print(f"  int8 DiT weights (eager quantizer) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    audio = (np.random.default_rng(0).standard_normal(int(6.0 * cfg.sample_rate))
             * 3000).astype(np.int16)
    per_step = {**dict.fromkeys(KERNELS, 0), "flash_attention_flat": cfg.depth,
                "conv_pos_embed_fused": 1, **dict.fromkeys(Q8_KERNELS, cfg.depth)}
    q8.synthesize(audio, REF_TEXT, "word word")      # warm-up
    torch.cuda.synchronize()
    LAUNCHES.clear()
    for words in (15, 8, 25):
        synth_checked(q8, audio, words, per_step, "w8a8")
    launches = dict(LAUNCHES)
    check_bf16_forward(q8, 1408, torch.full((2,), 1396, dtype=torch.int32, device="cuda"),
                       "W8A8")
    bench = q8.benchmark(ref_seconds=6.0, gen_words=15, iters=3)
    print(f"  {name_limit}: W8A8 latency RTF {bench['rtf']:.6f} ({bench['wall_s']:.4f} s "
          f"for {bench['audio_s']:.3f} s of audio), sustained RTF "
          f"{bench['sustained_rtf']:.6f}; bf16 latency RTF {bench16['rtf']:.6f}, "
          f"sustained {bench16['sustained_rtf']:.6f}", flush=True)
    print("  " + json.dumps({"f5": "w8a8", **bench}), flush=True)

    t0 = time.perf_counter()
    q4 = F5Pipeline(pipe.f5, pipe.vocab, pipe.vocos, quantize=4)
    torch.cuda.synchronize()
    print(f"  int4 DiT weights (k_quant search) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    synth_checked(q4, audio, 15, {**dict.fromkeys(KERNELS, 0), "conv_pos_embed_fused": 1,
                                  "flash_attention_flat": cfg.depth}, "int4")
    return q8, launches


def check_f32_forward(pipe, t: int, kv, tol: float = FWD32_TOL,
                      label: str = "fp32") -> dict:
    """One fp32 DiT forward at T frames through the kernels the routes pick
    on the card and through their twins, on the same fp32 weights (int8
    where the pipeline quantized them) and inputs: rel L2 within `tol`
    (FWD32_TOL: only fp32 summation order differs). Returns the launches
    of the kernel run."""
    from tts_tpu_torch.models.f5 import dit_forward, f5_rope_tables
    from tts_tpu_torch.ops._build import LAUNCHES

    cfg, params = pipe.cfg, pipe.params
    gen = torch.Generator("cuda").manual_seed(6)
    noise = torch.randn((1, t, cfg.n_mels), generator=gen, device="cuda")
    cond = torch.randn((1, t, cfg.n_mels + cfg.text_dim), generator=gen, device="cuda")
    drop = torch.randn((1, t, cfg.n_mels + cfg.text_dim), generator=gen, device="cuda")
    cos, sin = (torch.tensor(a, device="cuda") for a in f5_rope_tables(t, cfg.head_dim))

    def fwd():
        a, b = dit_forward(params, noise, cond, drop, cos, sin, cfg, kv_len=kv, step_idx=3)
        return torch.cat([a, b])

    before = dict(LAUNCHES)
    kern = fwd()
    torch.cuda.synchronize()
    grew = {k: LAUNCHES[k] - before.get(k, 0) for k in KERNELS}
    with twins_in_dit():
        ref = fwd()
    e = rel_l2(kern, ref)
    ok = bool(torch.isfinite(kern).all()) and e <= tol
    print(f"  {label} dit_forward ({t} frames, kv_len "
          f"{kv if isinstance(kv, int) else 'per row'}, step 3), kernels against twins: rel "
          f"L2 {e:.6g} (limit {tol}), launches { {k: n for k, n in grew.items() if n} } "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"the {label} kernel route disagrees with its twins")
    return grew


def run_f5_fp32(name_limit: str, profile: bool = False) -> dict:
    """Phase 5c: F5Pipeline in fp32 at full F5TTS_v1_Base width (random
    weights from the bf16 phases' seeds): the bench request through kernel
    4 (22 launches a NFE step, none of kernels 1-3: kernel 1 is bf16 only,
    and fp32 keeps the conv and the MLP on the plain chain), 212,736
    samples; one DiT forward against the twins at the bench bucket, and one
    at T 4608 (past 4096, tts_tpu's route to kernel 5); latency and
    sustained RTF; then F5Pipeline(quantize="w8a8") over the fp32 models:
    the bench request and one DiT forward against the twins (within
    Q8_FWD32_TOL) through kernels 7, 4, 8 and 6 in fp32; with `profile`,
    profile_f5 over one request of each. Returns the launches of the request
    (kernel 4) and of the T 4608 forward (kernel 5)."""
    from tts_tpu_torch.models.f5 import F5Config, F5Model
    from tts_tpu_torch.models.f5 import init_params as f5_init
    from tts_tpu_torch.models.vocos import VocosConfig, VocosModel
    from tts_tpu_torch.models.vocos import init_params as vocos_init
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.f5 import F5Pipeline

    cfg, vcfg = F5Config(), VocosConfig()
    t0 = time.perf_counter()
    f5 = F5Model(cfg, f5_init(cfg, torch.Generator("cuda").manual_seed(0), torch.float32))
    vocos = VocosModel(vcfg, vocos_init(vcfg, torch.Generator("cuda").manual_seed(1),
                                        torch.float32))
    pipe = F5Pipeline(f5, {" ": 0}, vocos)
    torch.cuda.synchronize()
    print(f"  models: F5 dim {cfg.dim} depth {cfg.depth} heads {cfg.heads}x{cfg.head_dim} "
          f"NFE {cfg.nfe_steps}, Vocos; fp32, random init in {time.perf_counter() - t0:.2f} s",
          flush=True)
    audio = (np.random.default_rng(0).standard_normal(int(6.0 * cfg.sample_rate))
             * 3000).astype(np.int16)
    pipe.synthesize(audio, REF_TEXT, "word word")      # warm-up
    torch.cuda.synchronize()
    LAUNCHES.clear()
    n = synth_checked(pipe, audio, 15, {**dict.fromkeys(KERNELS, 0),
                                        "flash_attention_onepass": cfg.depth}, "fp32")
    launches = {"flash_attention_onepass": LAUNCHES["flash_attention_onepass"]}
    if n != BENCH_SAMPLES:
        raise AssertionError(f"fp32 bench request gave {n} samples, not {BENCH_SAMPLES}")
    check_f32_forward(pipe, 1408, torch.full((2,), 1396, dtype=torch.int32, device="cuda"))
    LAUNCHES.clear()
    grew = check_f32_forward(pipe, 4608, 4600)
    launches["flash_attention_online"] = LAUNCHES["flash_attention_online"]
    if grew["flash_attention_online"] != cfg.depth or grew["flash_attention_onepass"]:
        raise AssertionError(f"T 4608: kernel 5 launched {grew['flash_attention_online']} "
                             f"times, expected {cfg.depth}")
    bench = pipe.benchmark(ref_seconds=6.0, gen_words=15, iters=2)
    print(f"  {name_limit}: fp32 latency RTF {bench['rtf']:.6f} ({bench['wall_s']:.4f} s for "
          f"{bench['audio_s']:.3f} s of audio), sustained RTF {bench['sustained_rtf']:.6f}",
          flush=True)
    print("  " + json.dumps({"f5": "fp32", **bench}), flush=True)

    q8 = F5Pipeline(f5, {" ": 0}, vocos, quantize="w8a8")
    per_step = {**dict.fromkeys(KERNELS, 0), "flash_attention_onepass": cfg.depth,
                **dict.fromkeys(Q8_KERNELS, cfg.depth)}
    synth_checked(q8, audio, 15, per_step, "fp32 w8a8")
    grew = check_f32_forward(q8, 1408, torch.full((2,), 1396, dtype=torch.int32,
                                                  device="cuda"),
                             Q8_FWD32_TOL, "fp32 W8A8")
    want = {k: cfg.depth for k in Q8_KERNELS + ("flash_attention_onepass",)}
    if {k: n for k, n in grew.items() if n} != want:
        raise AssertionError(f"fp32 W8A8 forward launched {grew}, expected {want}")
    if profile:
        profile_f5({"fp32": pipe, "fp32 w8a8": q8}, name_limit)
    return launches


def profile_f5(pipes: dict, name_limit: str) -> None:
    """torch.profiler over one bench request of each F5 pipeline: device
    kernel time by kernel, and the device's idle share (1 - kernel time /
    wall)."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    rate = next(iter(pipes.values())).cfg.sample_rate
    audio = (np.random.default_rng(0).standard_normal(int(6.0 * rate)) * 3000).astype(np.int16)
    text = " ".join(["word"] * 15)
    classes = (("kernel 1 (rope_qk_kernel + flash_flat_kernel)", ("rope_qk", "flash_flat")),
               ("kernel 4 bf16 (mha_fixed_kernel)", ("mha_fixed",)),
               ("kernel 5 bf16 (mha_online_kernel)", ("mha_online",)),
               ("kernels 4-5 fp32 (mha_f32_kernel)", ("mha_f32",)),
               ("kernel 2 (conv_mish_kernel)", ("conv_mish",)),
               ("kernel 3 (ln_mod_kernel + dit_gemm_kernel)", ("ln_mod_kernel",
                                                                "dit_gemm_kernel")),
               ("kernels 6-8: q8_rows", ("q8_rows",)),
               ("kernels 6-7: q8_wgmma (s8 wgmma GEMMs)", ("q8_wgmma",)),
               ("kernel 8: q8_gemm (WMMA)", ("q8_gemm",)),
               ("cuBLAS / GEMM", ("nvjet", "gemv", "gemm", "cutlass", "sm90_xmma")))
    for label, pipe in pipes.items():
        pipe.synthesize(audio, REF_TEXT, text)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.synthesize(audio, REF_TEXT, text)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.count, e.device_time_total / 1e3) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(ms for _, _, ms in rows)
        shares = dict.fromkeys([name for name, _ in classes] + ["elementwise / other"], 0.0)
        for key, _, ms in rows:
            cls = next((name for name, pats in classes if any(p in key for p in pats)),
                       "elementwise / other")
            shares[cls] += ms
        print(f"  {name_limit}: profile F5 {label}, bench request: wall {wall:.4f} s "
              f"profiled, device kernel time {busy:.3f} ms, idle "
              f"{100 * (1 - busy / 1e3 / wall):.1f}% of the profiled wall, "
              f"{sum(c for _, c, _ in rows)} kernel launches", flush=True)
        for name, ms in shares.items():
            print(f"    {name}: {ms:.3f} ms ({100 * ms / max(busy, 1e-9):.1f}%)")
        for key, count, ms in sorted(rows, key=lambda r: -r[2])[:12]:
            print(f"    kernel {ms:9.3f} ms {count:6d}x  {key[:110]}")
        del prof, rows
        gc.collect()


def check_step(cfg, params: dict, ids: np.ndarray) -> None:
    """One decode step from the same state: kani_step(fused="step") in bf16
    against fused=False. Both bf16 routes are held against the plain route
    in fp32 on the same (bf16-valued) weights and state: over 16 layers of
    random weights, bf16 rounding alone moves the logits by several percent
    (rel L2, measured on the CPU: 3.9% plain, 4.0% fused, 1.7% between
    them), so 2^-6 cannot hold end to end. The check is that the kernel
    route is as accurate as the plain one: its error against fp32 at most
    STEP_SLACK times the plain route's."""
    from tts_tpu_torch.models.kani import KaniState, init_state, kani_step
    from tts_tpu_torch.runtime.kani import _prefill_loop

    ids_buf = torch.tensor(np.pad(ids, ((0, 0), (0, 64 - ids.shape[1]))), device="cuda")
    state, logits = _prefill_loop(params, ids_buf, ids.shape[1],
                                  init_state(cfg, 1, torch.bfloat16, "cuda"), cfg)
    h = params["embed"][logits.argmax(-1)][:, None]
    fused, _ = kani_step(params, h, state.clone(), cfg, fused="step")
    plain, _ = kani_step(params, h, state.clone(), cfg, fused=False)
    s32 = state.clone()
    s32 = KaniState(type(s32.kv)(s32.kv.k.float(), s32.kv.v.float(), s32.kv.length),
                    s32.conv.float())
    ref, _ = kani_step(cast_tree(params, torch.float32), h.float(), s32, cfg, fused=False)
    if not torch.isfinite(fused).all():
        raise AssertionError("fused step logits not finite")

    def rel(a):
        return (torch.linalg.vector_norm(a.float() - ref) / torch.linalg.vector_norm(ref)).item()

    e_fused, e_plain, e_both = rel(fused), rel(plain), (torch.linalg.vector_norm(
        fused.float() - plain.float()) / torch.linalg.vector_norm(plain.float())).item()
    ok = e_fused <= STEP_SLACK * e_plain
    print(f"  kani_step logits, rel L2 against the fp32 plain route: fused='step' "
          f"{e_fused:.6g}, fused=False {e_plain:.6g} (limit {STEP_SLACK} x); fused "
          f"against plain bf16 {e_both:.6g}; argmax equal "
          f"{bool((fused.argmax(-1) == plain.argmax(-1)).all())} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the fused decode step is less accurate than the plain one")


def run_kani(name_limit: str) -> dict:
    """Phase 5: KaniPipeline.synthesize_ids at full kani-tts-370m width.
    Returns the launch counts of the phase."""
    from tts_tpu_torch.models.kani import KaniConfig, init_params
    from tts_tpu_torch.models.nanocodec import NanoCodecConfig
    from tts_tpu_torch.models.nanocodec import init_params as codec_init
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.kani import KaniDecodeConfig, KaniPipeline

    cfg, ccfg = KaniConfig(max_seq_len=2048, stop_token=-1), NanoCodecConfig()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(2), torch.bfloat16)
    cparams = codec_init(ccfg, torch.Generator("cuda").manual_seed(3), torch.bfloat16)
    torch.cuda.synchronize()
    print(f"  models: Kani hidden {cfg.hidden_size}, {len(cfg.layer_types)} layers "
          f"({cfg.num_attn_layers} attention, {cfg.num_conv_layers} conv), "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}; NanoCodec {ccfg.base_channels} channels, upsample "
          f"{ccfg.total_upsample}; bf16, random init in {time.perf_counter() - t0:.2f} s",
          flush=True)
    ids = np.array(KANI_IDS, np.int32)
    dec = KaniDecodeConfig(max_new_tokens=KANI_NEW, repeat_penalty=1.0)
    pipes = {"greedy bf16": KaniPipeline(params, cfg, cparams, ccfg, dec),
             "greedy int8": KaniPipeline(params, cfg, cparams, ccfg, dec, quantize=8),
             "beam 5": KaniPipeline(params, cfg, cparams, ccfg, KaniDecodeConfig(
                 max_new_tokens=KANI_NEW, repeat_penalty=1.0, use_beam=True,
                 beam_size=5, top_k=5))}
    prompts = [ids, np.array([[3, 9, 4]], np.int32), np.array([[5, 8, 13, 21, 34, 55]],
                                                                np.int32), ids[:, :4]]
    layers = cfg.num_attn_layers

    def expect(label, grew, tokens):
        steps = tokens - 1                          # the first token is the prefill's
        want = ({"fused_qkv_attn": layers * steps, "fused_qkv_rope": 0}
                if label.startswith("greedy") else
                {"fused_qkv_attn": 0, "fused_qkv_rope": layers * steps})
        for k, n in want.items():
            if grew.get(k, 0) != n:
                raise AssertionError(f"{label}: {k} launched {grew.get(k, 0)} times, "
                                     f"expected {n}")

    def audio_ok(label, wav, tokens, peak):
        frames = (tokens - 2) // ccfg.num_groups
        if wav.dtype != np.int16 or len(wav) != frames * ccfg.total_upsample:
            raise AssertionError(f"{label}: {len(wav)} {wav.dtype} samples, expected "
                                 f"{frames * ccfg.total_upsample} int16")
        if not math.isfinite(peak) or not wav.any():
            raise AssertionError(f"{label}: waveform not finite or all zero")

    for pipe in pipes.values():                     # warm-up
        pipe.synthesize_ids(ids)
    pipes["greedy bf16"].synthesize_ids_batch(prompts)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    for label, pipe in pipes.items():
        before = dict(LAUNCHES)
        wav, st = pipe.synthesize_ids(ids)
        grew = {k: LAUNCHES[k] - before.get(k, 0) for k in KERNELS}
        print(f"  {label}: {st['tokens']} tokens, {len(wav)} int16 samples, wall "
              f"{st['wall_s']:.4f} s, peak |wav| {st['peak']:.6g}, launches {grew}",
              flush=True)
        if st["tokens"] != KANI_NEW:
            raise AssertionError(f"{label}: {st['tokens']} tokens, expected {KANI_NEW}")
        audio_ok(label, wav, st["tokens"], st["peak"])
        expect(label, grew, st["tokens"])
    before = dict(LAUNCHES)
    wavs, st = pipes["greedy bf16"].synthesize_ids_batch(prompts)
    grew = {k: LAUNCHES[k] - before.get(k, 0) for k in KERNELS}
    print(f"  batch of {len(prompts)}: {st['tokens']} tokens, {[len(w) for w in wavs]} "
          f"samples, wall {st['wall_s']:.4f} s, launches {grew}", flush=True)
    if st["tokens"] != KANI_NEW * len(prompts):
        raise AssertionError(f"batch: {st['tokens']} tokens")
    for w in wavs:
        audio_ok("batch", w, KANI_NEW, st["peak"])
    expect("batch", grew, KANI_NEW)
    launches = dict(LAUNCHES)

    check_step(cfg, params, ids)

    for label in ("greedy bf16", "greedy int8"):
        b = pipes[label].benchmark(ids, iters=2)
        print(f"  {name_limit}: Kani {label}: {b['tokens_per_s']:.2f} tokens/s, RTF "
              f"{b['rtf']:.6f} ({b['wall_s']:.4f} s for {b['audio_s']:.4f} s of audio)",
              flush=True)
        print("  " + json.dumps({"kani": label, **b}), flush=True)
    return launches


def profile_kani(out_dir: str, name_limit: str) -> None:
    """torch.profiler over one greedy bf16 and one greedy int8 run at the
    bench config: device time by kernel class, and the device's idle share
    (1 - kernel time / wall). The tables go to out_dir."""
    import gc
    import os

    from torch.profiler import ProfilerActivity, profile

    from tts_tpu_torch.models.kani import KaniConfig, init_params
    from tts_tpu_torch.models.nanocodec import NanoCodecConfig
    from tts_tpu_torch.models.nanocodec import init_params as codec_init
    from tts_tpu_torch.runtime.kani import KaniDecodeConfig, KaniPipeline

    os.makedirs(out_dir, exist_ok=True)
    cfg, ccfg = KaniConfig(max_seq_len=2048, stop_token=-1), NanoCodecConfig()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(2), torch.bfloat16)
    cparams = codec_init(ccfg, torch.Generator("cuda").manual_seed(3), torch.bfloat16)
    ids = np.array(KANI_IDS, np.int32)
    dec = KaniDecodeConfig(max_new_tokens=KANI_NEW, repeat_penalty=1.0)
    classes = (("kernel 12 (fused_qkv_attn)", ("attn_kernel",)),
               ("kernel 11 (fused_qkv_rope)", ("qkv_matvec", "qkv_epilogue")),
               ("cuBLAS / GEMM", ("nvjet", "gemv", "gemm", "cutlass", "sm90_xmma", "cublas")),
               ("casts / copies", ("copy", "convert")),
               ("conv (codec)", ("conv", "cudnn", "implicit", "winograd", "fft")))
    for quant in (None, 8):
        pipe = KaniPipeline(params, cfg, cparams, ccfg, dec, quantize=quant)
        pipe.synthesize_ids(ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.synthesize_ids(ids)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, st = pipe.synthesize_ids(ids)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        tag = "int8" if quant else "bf16"
        events = prof.key_averages()
        rows = [(e.key, e.count, e.device_time_total / 1e3) for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(ms for _, _, ms in rows)
        shares = {name: 0.0 for name, _ in classes}
        shares["elementwise / other"] = 0.0
        for key, _, ms in rows:
            low = key.lower()
            cls = next((name for name, pats in classes if any(p in low for p in pats)),
                       "elementwise / other")
            shares[cls] += ms
        host = {e.key: (e.count, e.cpu_time_total / 1e3) for e in events
                if e.key in ("aten::item", "aten::_local_scalar_dense",
                             "cudaStreamSynchronize", "cudaMemcpyAsync",
                             "cudaLaunchKernel", "cuLaunchKernel")}
        n_launch = sum(c for k, (c, _) in host.items() if "Launch" in k)
        print(f"  {name_limit}: profile greedy {tag}: {st['tokens']} tokens, wall "
              f"{wall:.4f} s profiled ({plain_wall:.4f} s unprofiled), device kernel "
              f"time {busy:.3f} ms, idle {100 * (1 - busy / 1e3 / wall):.1f}% of the "
              f"profiled wall, {n_launch} launches ({n_launch / st['tokens']:.1f} a "
              f"token)", flush=True)
        for name, ms in shares.items():
            print(f"    {name}: {ms:.3f} ms ({100 * ms / max(busy, 1e-9):.1f}%)")
        for key, (count, ms) in host.items():
            print(f"    host {key}: {count} calls, {ms:.3f} ms CPU")
        for key, count, ms in sorted(rows, key=lambda r: -r[2])[:16]:
            print(f"    kernel {ms:9.3f} ms {count:6d}x  {key[:110]}")
        with open(os.path.join(out_dir, f"kani_profile_{tag}.txt"), "w") as f:
            f.write(events.table(sort_by="device_time_total", row_limit=60))
        del prof, events       # ~10^5 event objects slow every later gc pass
        gc.collect()


def qwen_models() -> tuple:
    """Qwen3-TTS-0.6B talker + predictor and the 12 Hz codec decoder at full
    width, bf16, random weights from fixed seeds."""
    from tts_tpu_torch.models.qwen_codec import QwenCodecDecoderConfig, init_decoder_params
    from tts_tpu_torch.models.qwen_tts import (QwenTTSConfig, init_predictor_params,
                                               init_talker_params)

    cfg, ccfg = QwenTTSConfig(), QwenCodecDecoderConfig()
    t0 = time.perf_counter()
    params = {**init_talker_params(cfg, torch.Generator("cuda").manual_seed(4), torch.bfloat16),
              **init_predictor_params(cfg, torch.Generator("cuda").manual_seed(5),
                                      torch.bfloat16)}
    cparams = init_decoder_params(ccfg, torch.Generator("cuda").manual_seed(6), torch.bfloat16)
    torch.cuda.synchronize()
    t, p = cfg.talker, cfg.predictor
    print(f"  models: talker {t.num_layers} layers x hidden {t.hidden_size}, "
          f"{t.num_heads}/{t.num_kv_heads} heads x {t.head_dim}, FFN {t.ffn_dim}; predictor "
          f"{p.num_layers} layers, {cfg.num_code_groups} code groups; codec decoder "
          f"{ccfg.decoder_dim} channels, upsample {ccfg.total_upsample}; bf16, random init "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    return cfg, ccfg, params, cparams


def twins_in_qwen():
    """Run models/qwen_tts's kernels through their plain twins on the card."""
    import tts_tpu_torch.models.qwen_tts as mq
    from tts_tpu_torch.ops import decode_attention, decode_mlp, decode_qkv, decode_step

    return swapped(mq, {
        "fused_qkv_attn": decode_step.fused_qkv_attn_plain,
        "fused_qkv_rope": decode_qkv.fused_qkv_rope_plain,
        "decode_gqa_attention": decode_attention.decode_gqa_attention_plain,
        "fused_out_mlp": decode_mlp.fused_out_mlp_plain,
        "fused_out_mlp_q8": decode_mlp.fused_out_mlp_q8_plain})


def check_qwen_step(cfg, params: dict, q8_params: dict) -> None:
    """One talker step at full width from one random state (cache bucket 768,
    126 rows live) through "step", "all" and "mlp_q8" (int8 weights): the
    kernels in bf16, the same route's twins in bf16 and in fp32. As
    check_step for Kani: 28 layers of bf16 rounding move the hidden state by
    more than 2^-6 on any route, so the kernel route's error against the
    fp32 twins must be at most STEP_SLACK times the bf16 twins'."""
    from tts_tpu_torch.kv.cache import KVCache
    from tts_tpu_torch.models.qwen_tts import qwen3_stack_step
    from tts_tpu_torch.ops._build import LAUNCHES

    tc = cfg.talker
    gen = torch.Generator("cuda").manual_seed(8)
    shape = (tc.num_layers, 1, tc.num_kv_heads, 768, tc.head_dim)
    k0 = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v0 = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    x = torch.randn((1, 1, tc.hidden_size), generator=gen, device="cuda").to(torch.bfloat16)
    pos = 126
    rc, rs = params["rope_cos"][pos:pos + 1], params["rope_sin"][pos:pos + 1]

    def step(p, route, dt):
        kv = KVCache(k0.to(dt), v0.to(dt), pos)
        h, _ = qwen3_stack_step(p, x.to(dt), kv, tc, rc.to(dt), rs.to(dt), fused=route)
        return h.float()

    n = tc.num_layers
    want = {"step": {"fused_qkv_attn": n},
            "all": {"fused_qkv_rope": n, "decode_gqa_attention": n, "fused_out_mlp": n},
            "mlp_q8": {"fused_qkv_rope": n, "fused_out_mlp_q8": n}}
    for route, counts in want.items():
        p = (q8_params if route == "mlp_q8" else params)["talker"]
        before = dict(LAUNCHES)
        kern = step(p, route, torch.bfloat16)
        grew = {k: LAUNCHES[k] - before.get(k, 0) for k in QWEN_KERNELS}
        if grew != {k: counts.get(k, 0) for k in QWEN_KERNELS}:
            raise AssertionError(f"talker step {route!r}: launches {grew}, expected {counts}")
        with twins_in_qwen():
            plain = step(p, route, torch.bfloat16)
            ref = step(cast_tree(p, torch.float32), route, torch.float32)

        def rel(a, b=ref):
            return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

        e_k, e_p = rel(kern), rel(plain)
        ok = bool(torch.isfinite(kern).all()) and e_k <= STEP_SLACK * e_p
        print(f"  talker step fused={route!r} ({n} layers, pos {pos}, cache 768), rel L2 "
              f"against its fp32 twins: kernels {e_k:.6g}, bf16 twins {e_p:.6g} (limit "
              f"{STEP_SLACK} x); kernels against bf16 twins {rel(kern, plain):.6g} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"the {route!r} kernel route is less accurate than its twins")


def run_qwen(name_limit: str) -> tuple:
    """Phase 7: QwenTTSPipeline at full Qwen3-TTS-0.6B width. Returns the
    launch counts of the "all" and "mlp_q8" runs (kernels 13-15) and the
    bf16, int8 and bf16 "all" pipelines."""
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.qwen import QwenDecodeConfig, QwenTTSPipeline

    cfg, ccfg, params, cparams = qwen_models()
    up = ccfg.total_upsample
    per_iter = cfg.talker.num_layers + (cfg.num_code_groups - 1) * cfg.predictor.num_layers
    talker = cfg.talker.num_layers
    beam_pred = (cfg.num_code_groups - 2) * cfg.predictor.num_layers

    def dec(**kw):
        return QwenDecodeConfig(**{"max_frames": QWEN_FRAMES, **kw})

    def iters(frames: int, cap: int) -> int:
        """Loop iterations: the EOS frame is computed and dropped."""
        return frames if frames == cap else frames + 1

    def checked(label, fn, cap, per, rows=1):
        """Run fn() -> (list of int16 waveforms, stats); check the audio and
        per[k] launches of each kernel k an iteration. Returns (stats,
        wall, launches)."""
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        wavs, st = fn()
        wall = time.perf_counter() - t0
        grew = {k: LAUNCHES[k] - before.get(k, 0) for k in QWEN_KERNELS}
        frames = [len(w) // up for w in wavs]
        n_it = max(iters(f, cap) for f in frames)
        print(f"  {label}: frames {frames} ({sum(len(w) for w in wavs)} int16 samples), "
              f"{n_it} loop iterations, wall {wall:.4f} s, peak |wav| "
              f"{st.get('peak', float('nan')):.6g}, "
              f"launches {grew}", flush=True)
        for w, f in zip(wavs, frames):
            if w.dtype != np.int16 or len(w) != f * up or not 1 <= f <= cap:
                raise AssertionError(f"{label}: {len(w)} {w.dtype} samples, not frames x {up}")
        if len(wavs) != rows or not math.isfinite(st.get("peak", math.nan)) \
                or not any(w.any() for w in wavs):
            raise AssertionError(f"{label}: waveform not finite or all zeros")
        for k in QWEN_KERNELS:
            if grew[k] != per.get(k, 0) * n_it:
                raise AssertionError(f"{label}: {k} launched {grew[k]} times, expected "
                                     f"{per.get(k, 0)} x {n_it} iterations")
        return st, wall, grew

    def single(pipe):
        def fn():
            wav, st = pipe.synthesize_ids(QWEN_IDS, language_id=QWEN_LANG)
            return [wav], st
        return fn

    pipes = {"bf16": QwenTTSPipeline(params, cfg, cparams, ccfg, dec()),
             "int8": QwenTTSPipeline(params, cfg, cparams, ccfg, dec(), quantize=8)}
    for pipe in pipes.values():                     # warm-up
        pipe.synthesize_ids(QWEN_IDS, language_id=QWEN_LANG)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    for label, pipe in pipes.items():
        st, wall, _ = checked(f"bench request {label}, default route", single(pipe),
                              QWEN_FRAMES, {"fused_qkv_attn": per_iter})
        fps = st["frames"] / wall
        rtf = wall / (st["frames"] / 12.0)
        print(f"  {name_limit}: Qwen {label}: {fps:.2f} frames/s, RTF {rtf:.6f} ({wall:.4f} s "
              f"for {st['frames']} frames = {st['frames'] / 12.0:.4f} s of audio)", flush=True)
        print("  " + json.dumps({"qwen": label, "frames": st["frames"], "wall_s": wall,
                                 "frames_per_s": fps, "rtf": rtf}), flush=True)

    beam = QwenTTSPipeline(params, cfg, cparams, ccfg, dec(
        max_frames=8, use_beam=True, beam_size=3, beam_top_k=3))
    checked("beam 3 / top-k 3, 8 frames", single(beam), 8,
            {"fused_qkv_attn": talker, "fused_qkv_rope": beam_pred})
    small = QwenTTSPipeline(params, cfg, cparams, ccfg, dec(max_frames=8))
    prompts = [QWEN_IDS, np.arange(5, 20, dtype=np.int32)[None],
               np.arange(40, 90, dtype=np.int32)[None], np.array([[7, 1, 4]], np.int32)]
    reqs = [small.build_prefill_embeds(i, QWEN_LANG) for i in prompts]
    checked("batch of 4, 8 frames", lambda: small.synthesize_from_prefill_batch(reqs), 8,
            {"fused_qkv_rope": per_iter}, rows=4)

    launches = {}
    q8 = pipes["int8"].params
    fused_all = QwenTTSPipeline(params, cfg, cparams, ccfg,
                                dec(max_frames=128, fused_decode="all"))
    for label, pipe, cap, per in (
            ('fused_decode="all" bf16, max_frames 128', fused_all,
             128, {"fused_qkv_rope": per_iter, "decode_gqa_attention": per_iter,
                   "fused_out_mlp": per_iter}),
            ('fused_decode="mlp_q8" int8',
             QwenTTSPipeline(q8, cfg, cparams, ccfg, dec(fused_decode="mlp_q8")),
             QWEN_FRAMES, {"fused_qkv_rope": per_iter, "fused_out_mlp_q8": per_iter})):
        st, wall, grew = checked(label, single(pipe), cap, per)
        print(f"  {name_limit}: Qwen {label}: {st['frames'] / wall:.2f} frames/s, RTF "
              f"{wall / (st['frames'] / 12.0):.6f} (first call)", flush=True)
        launches.update({k: grew[k] for k in ("decode_gqa_attention", "fused_out_mlp",
                                               "fused_out_mlp_q8") if grew[k]})
    check_qwen_step(cfg, params, {"talker": q8["talker"]})
    return launches, {**pipes, "bf16 fused_decode=all (max_frames 128)": fused_all}


def profile_qwen(pipes: dict, out_dir: str, name_limit: str) -> None:
    """torch.profiler over one bench request of each pipeline (bf16 and int8
    on the default route, bf16 on "all"): device time by kernel class, the
    device's idle share (1 - kernel time / wall), launches a frame, host
    time by op; tables into out_dir."""
    import gc
    import os

    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    classes = (("kernel 12 attention (attn_kernel)", ("attn_kernel",)),
               ("kernel 11 / 12 qkv head", ("qkv_matvec", "qkv_epilogue")),
               ("kernel 13", ("cluster_kernel",)),
               ("kernels 14 / 15", ("oproj_kernel", "gateup_kernel", "down_kernel")),
               ("cuBLAS / GEMM", ("nvjet", "gemv", "gemm", "cutlass", "sm90_xmma", "cublas")),
               ("casts / copies", ("copy", "convert")),
               ("conv (codec)", ("conv", "cudnn", "implicit", "winograd", "fft")))
    for tag, pipe in pipes.items():
        pipe.synthesize_ids(QWEN_IDS, language_id=QWEN_LANG)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, st = pipe.synthesize_ids(QWEN_IDS, language_id=QWEN_LANG)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        rows = [(e.key, e.count, e.device_time_total / 1e3) for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(ms for _, _, ms in rows)
        shares = dict.fromkeys([name for name, _ in classes] + ["elementwise / other"], 0.0)
        for key, _, ms in rows:
            low = key.lower()
            cls = next((name for name, pats in classes if any(p in low for p in pats)),
                       "elementwise / other")
            shares[cls] += ms
        n_launch = sum(e.count for e in events
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
        frames = st["frames"]
        print(f"  {name_limit}: profile Qwen {tag}, bench request: {frames} frames, wall "
              f"{wall:.4f} s profiled, device kernel time {busy:.3f} ms "
              f"({busy / max(frames, 1):.4f} ms a frame), idle "
              f"{100 * (1 - busy / 1e3 / wall):.1f}% of the profiled wall, {n_launch} launches "
              f"({n_launch / max(frames, 1):.1f} a frame)", flush=True)
        for name, ms in shares.items():
            print(f"    {name}: {ms:.3f} ms ({100 * ms / max(busy, 1e-9):.1f}%)")
        for key, count, ms in sorted(rows, key=lambda r: -r[2])[:12]:
            print(f"    kernel {ms:9.3f} ms {count:6d}x  {key[:110]}")
        host = sorted(((e.key, e.count, e.self_cpu_time_total / 1e3) for e in events
                       if e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda r: -r[2])
        for key, count, ms in host[:8]:
            print(f"    host {ms:9.3f} ms self {count:7d}x  {key[:80]}")
        name = tag.split()[0] + ("_all" if "all" in tag else "")
        with open(os.path.join(out_dir, f"qwen_profile_{name}.txt"), "w") as f:
            f.write(events.table(sort_by="device_time_total", row_limit=60))
            f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
        del prof, events
        gc.collect()


def bigvgan_weights(cfg, seed: int, dt=torch.bfloat16) -> dict:
    """BigVGAN params at full width in dt, random from `seed`, each conv
    rescaled from tts_tpu's N(0, 0.02^2) to gain / sqrt(k C_in): 1 for
    conv_pre, sqrt(rate) for the transposed convs (each output sums k /
    rate taps), 0.5 for the resblock convs (the residual stream grows by a
    quarter of its variance a branch at most) and 0.3 for conv_post, so the
    waveform stays off zero and mostly off the clamp."""
    from tts_tpu_torch.models.bigvgan import init_params

    params = init_params(cfg, torch.Generator("cuda").manual_seed(seed), dt)

    def rescale(conv, gain):
        k, cin, _ = conv["w"].shape
        conv["w"].mul_(gain / (0.02 * math.sqrt(k * cin)))

    rescale(params["conv_pre"], 1.0)
    for up, rate in zip(params["ups"], cfg.upsample_rates):
        rescale(up, math.sqrt(rate))
    for rb in params["resblocks"]:
        for conv in rb["convs1"] + rb["convs2"]:
            rescale(conv, 0.5)
    rescale(params["conv_post"], 0.3)
    return params


def kernel10_per_call(cfg, frames: int, dt=torch.bfloat16) -> int:
    """Resblocks of one vocoder call that the gate sends to kernel 10."""
    from tts_tpu_torch.ops.bigvgan_stage import fusable_stage

    t, n = frames * (4 if cfg.feat_upsample else 1), 0
    for c, rate in zip(cfg.stage_channels, cfg.upsample_rates):
        t *= rate
        n += cfg.num_kernels * fusable_stage(c, t, dt, "cuda")
    return n


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return (torch.linalg.vector_norm(a.float() - b.float())
            / torch.linalg.vector_norm(b.float())).item()


def cast_tree(tree, dt):
    """A params tree with its float tensors cast to dt (QTensors kept)."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dt) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_tree(v, dt) for v in tree]
    return tree.to(dt) if isinstance(tree, torch.Tensor) and tree.is_floating_point() else tree


def run_vocoder(name_limit: str) -> tuple:
    """Phase 8: BigVGANVocoder at full bigvgan_v2_24khz_100band_256x width
    on the bench mel. Returns the launch counts of one call and the
    vocoder."""
    import tts_tpu_torch.ops.bigvgan_stage as k10
    from tts_tpu_torch.models.bigvgan import BigVGANConfig, bigvgan_apply
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.vocoder import BigVGANVocoder

    cfg = BigVGANConfig()
    t0 = time.perf_counter()
    voc = BigVGANVocoder(bigvgan_weights(cfg, 9), cfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"  model: BigVGAN {cfg.num_mels} mels, {cfg.upsample_initial_channel} channels, "
          f"upsample {cfg.total_upsample}, resblocks k {cfg.resblock_kernel_sizes}; bf16, "
          f"random init in {time.perf_counter() - t0:.2f} s", flush=True)
    mel = np.random.default_rng(9).standard_normal((1, 512, cfg.num_mels)).astype(np.float32)
    voc(mel)                                                # warm-up
    torch.cuda.synchronize()
    per_call = kernel10_per_call(cfg, 512)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    wav = voc(mel)
    wall = time.perf_counter() - t0
    launches = {"amp_block_fused": LAUNCHES["amp_block_fused"]}
    melt = torch.as_tensor(mel, device="cuda").to(torch.bfloat16)
    kern = bigvgan_apply(voc.params, melt, cfg).float()
    rms = kern.square().mean().sqrt().item()
    clipped = (kern.abs() >= 1.0).float().mean().item()
    print(f"  bench mel (1, 512, {cfg.num_mels}): {wav.shape[-1]} int16 samples, wall "
          f"{wall:.4f} s (first timed call), waveform RMS {rms:.4f}, {100 * clipped:.2f}% "
          f"at the clamp, kernel-10 launches {launches['amp_block_fused']} (expected "
          f"{per_call})", flush=True)
    if wav.dtype != np.int16 or wav.shape != (1, 512 * cfg.total_upsample):
        raise AssertionError(f"expected (1, {512 * cfg.total_upsample}) int16, got "
                             f"{wav.shape} {wav.dtype}")
    if not math.isfinite(rms) or rms < 1e-3 or clipped > 0.5 or not wav.any():
        raise AssertionError("the waveform is not finite, near zero or mostly clamped")
    if launches["amp_block_fused"] != per_call:
        raise AssertionError(f"kernel 10 launched {launches['amp_block_fused']} times, "
                             f"expected {per_call}")
    with swapped(k10, {"amp_block_fused": k10.amp_block_fused_plain}):
        plain = bigvgan_apply(voc.params, melt, cfg).float()
        # fp32 through the twin too: kernel 10 takes fp32 at C <= 128
        ref = bigvgan_apply(cast_tree(voc.params, torch.float32), melt.float(), cfg).float()
    e_k, e_p = rel_l2(kern, ref), rel_l2(plain, ref)
    ok = bool(torch.isfinite(kern).all()) and e_k <= STEP_SLACK * e_p
    print(f"  generator output, rel L2 against the fp32 generator: kernel 10 {e_k:.6g}, its "
          f"bf16 twin {e_p:.6g} (limit {STEP_SLACK} x); kernel against twin "
          f"{rel_l2(kern, plain):.6g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("kernel 10's generator is less accurate than its twin's")
    del kern, plain, ref
    bench = voc.benchmark(mel_frames=512, iters=10)
    plain_ms = time_ms(lambda: bigvgan_apply(voc.params, melt, cfg, fused=False), iters=5,
                       warmup=1)
    print(f"  {name_limit}: BigVGAN bench mel (1, 512, 100): {bench['samples_per_sec']:.0f} "
          f"samples/s, RTF {bench['rtf']:.6f} ({1e3 * bench['wall_s']:.3f} ms a call, "
          f"{bench['samples']} samples, 10 calls); plain chain (fused=False) "
          f"{plain_ms:.3f} ms a call (CUDA events, median of 5)", flush=True)
    print("  " + json.dumps({"bigvgan": "bf16", **bench, "plain_ms": plain_ms}), flush=True)
    return launches, voc


def run_vocoder_fp32(name_limit: str) -> dict:
    """Phase 8c: BigVGANVocoder in fp32 at full width (the same weights'
    seed as phase 8) on the bench mel: 9 launches of kernel 10's fp32 form
    a call (stages 3-5, C 96, 48, 24; stages 0-2 exceed tts_tpu's fp32
    gate of C <= 128), none of the bf16 form; the generator output against
    the same through kernel 10's twin; samples/s and RTF. Returns the
    launches of one call."""
    import tts_tpu_torch.ops.bigvgan_stage as k10
    from tts_tpu_torch.models.bigvgan import BigVGANConfig, bigvgan_apply
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.vocoder import BigVGANVocoder

    cfg, f32 = BigVGANConfig(), torch.float32
    voc = BigVGANVocoder(bigvgan_weights(cfg, 9, f32), cfg, dtype=f32)
    mel = np.random.default_rng(9).standard_normal((1, 512, cfg.num_mels)).astype(np.float32)
    voc(mel)                                                # warm-up
    torch.cuda.synchronize()
    per_call = kernel10_per_call(cfg, 512, f32)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    wav = voc(mel)
    wall = time.perf_counter() - t0
    launches = {"amp_block_fused_f32": LAUNCHES["amp_block_fused_f32"]}
    melt = torch.as_tensor(mel, device="cuda")
    kern = bigvgan_apply(voc.params, melt, cfg)
    rms = kern.square().mean().sqrt().item()
    clipped = (kern.abs() >= 1.0).float().mean().item()
    print(f"  bench mel (1, 512, {cfg.num_mels}) in fp32: {wav.shape[-1]} int16 samples, wall "
          f"{wall:.4f} s (first timed call), waveform RMS {rms:.4f}, {100 * clipped:.2f}% at "
          f"the clamp, launches {launches['amp_block_fused_f32']} of the fp32 form (expected "
          f"{per_call}), {LAUNCHES['amp_block_fused']} of the bf16 form", flush=True)
    if wav.dtype != np.int16 or wav.shape != (1, 512 * cfg.total_upsample):
        raise AssertionError(f"expected (1, {512 * cfg.total_upsample}) int16, got "
                             f"{wav.shape} {wav.dtype}")
    if not math.isfinite(rms) or rms < 1e-3 or clipped > 0.5 or not wav.any():
        raise AssertionError("the waveform is not finite, near zero or mostly clamped")
    if launches["amp_block_fused_f32"] != per_call or per_call != 9 \
            or LAUNCHES["amp_block_fused"]:
        raise AssertionError(f"kernel 10 fp32 launched {launches['amp_block_fused_f32']} "
                             f"times (expected 9), bf16 {LAUNCHES['amp_block_fused']}")
    with swapped(k10, {"amp_block_fused": k10.amp_block_fused_plain}):
        ref = bigvgan_apply(voc.params, melt, cfg)
    e = rel_l2(kern, ref)
    ok = bool(torch.isfinite(kern).all()) and e <= FWD32_TOL
    print(f"  fp32 generator output, kernel 10 against its twin: rel L2 {e:.6g} (limit "
          f"{FWD32_TOL}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the fp32 kernel-10 generator disagrees with its twin's")
    del kern, ref
    bench = voc.benchmark(mel_frames=512, iters=5)
    print(f"  {name_limit}: BigVGAN fp32 bench mel (1, 512, 100): "
          f"{bench['samples_per_sec']:.0f} samples/s, RTF {bench['rtf']:.6f} "
          f"({1e3 * bench['wall_s']:.3f} ms a call, {bench['samples']} samples, 5 calls)",
          flush=True)
    print("  " + json.dumps({"bigvgan": "fp32", **bench}), flush=True)
    return launches


INDEX_IDS = np.arange(5, 37, dtype=np.int32)[None]     # 32 text ids
INDEX_GEN = 256


def indextts_models() -> tuple:
    """IndexTTS-1.5 at full width (GPT 24 x 1280, 20 heads; conformer 6 x
    512; ECAPA 512; the IndexTTS-1.5 BigVGAN: 1536 channels from 1280
    inputs, tanh and bias at the end), bf16, random weights from fixed
    seeds. No stop token: random weights would stop at a random step.

    The vocoder upsamples 1024x, one GPT latent per mel code: the index-tts
    release's checkpoints/config.yaml `bigvgan:` section (upsample_rates
    [4,4,4,4,2,2], upsample_kernel_sizes [8,8,4,4,4,4], feat_upsample
    false), as recalled; no such file is in the repository to check it
    against. tts_tpu's loader falls back to 256x when the file is absent."""
    from tts_tpu_torch.models.bigvgan import BigVGANConfig
    from tts_tpu_torch.models.indextts import (IndexTTSConfig, init_conformer_params,
                                               init_ecapa_params, init_gpt_params,
                                               init_perceiver_params)

    cfg = IndexTTSConfig(stop_token=-1)
    vcfg = BigVGANConfig(num_mels=cfg.gpt_dim, upsample_rates=(4, 4, 4, 4, 2, 2),
                         upsample_kernel_sizes=(8, 8, 4, 4, 4, 4),
                         use_tanh_at_final=True, use_bias_at_final=True)
    bf = torch.bfloat16
    t0 = time.perf_counter()

    def g(seed):
        return torch.Generator("cuda").manual_seed(seed)

    def lin(cin, cout, seed):
        w = torch.randn((cin, cout), generator=g(seed), device="cuda") * cin ** -0.5
        return {"w": w.to(bf), "b": torch.zeros((cout,), dtype=bf, device="cuda")}

    c0 = vcfg.upsample_initial_channel
    params = {
        "conformer": init_conformer_params(cfg, g(20), dtype=bf),
        "perceiver": init_perceiver_params(cfg, g(21), bf),
        "ecapa": init_ecapa_params(cfg, g(22), bf),
        "gpt": init_gpt_params(cfg, g(23), bf),
        "bigvgan": bigvgan_weights(vcfg, 24),
        "cond_layer": lin(cfg.speaker_embed_dim, c0, 25),
        "conds": [lin(cfg.speaker_embed_dim, c, 26 + i)
                  for i, c in enumerate(vcfg.stage_channels)],
    }
    torch.cuda.synchronize()
    print(f"  models: GPT {cfg.gpt_layers} x {cfg.gpt_dim}, {cfg.gpt_heads} heads x "
          f"{cfg.gpt_head_dim}, {cfg.num_mel_codes} codes; conformer {cfg.enc_layers} x "
          f"{cfg.enc_dim}; ECAPA {cfg.ecapa_channels}; BigVGAN {c0} channels from "
          f"{vcfg.num_mels} inputs, upsample {vcfg.total_upsample}; bf16, random init in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return cfg, vcfg, params


def check_index_step(pipe, ref) -> None:
    """One GPT decode step after the bench request's prefill, through
    kernel 11 (the route every decode step takes) in bf16, against the
    plain route in bf16 and in fp32 (params and cache cast): as check_step
    for Kani, the kernel route's error at most STEP_SLACK times the plain
    route's."""
    from tts_tpu_torch.kv.cache import KVCache
    from tts_tpu_torch.models.indextts import gpt_step

    cfg, gpt = pipe.cfg, pipe.params["gpt"]
    ids = np.zeros((1, 32), np.int32)
    ids[0] = INDEX_IDS[0]
    logits, _, kv, kv_valid, vec = pipe._prefill(ref[0], ids, np.array([32]), INDEX_GEN)
    tok = logits.argmax(-1)
    h = (gpt["mel_embed"][tok] + gpt["mel_pos"][1][None])[:, None]

    def step(p, dt, route):
        c = KVCache(kv.k.to(dt).clone(), kv.v.to(dt).clone(), kv.length)
        out, _, _ = gpt_step(p, h.to(dt), c, vec, cfg, kv_valid[0], fused=route)
        return out.float()

    kern, plain = step(gpt, torch.bfloat16, True), step(gpt, torch.bfloat16, False)
    ref32 = step(cast_tree(gpt, torch.float32), torch.float32, False)
    e_k, e_p = rel_l2(kern, ref32), rel_l2(plain, ref32)
    ok = bool(torch.isfinite(kern).all()) and e_k <= STEP_SLACK * e_p
    print(f"  GPT step logits ({cfg.gpt_layers} layers, pos {kv.length}), rel L2 against the fp32 plain "
          f"route: kernel 11 {e_k:.6g}, plain {e_p:.6g} (limit {STEP_SLACK} x); kernel against "
          f"plain bf16 {rel_l2(kern, plain):.6g}, argmax equal "
          f"{bool((kern.argmax(-1) == plain.argmax(-1)).all())} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("the kernel-11 GPT step is less accurate than the plain one")


def check_index_vocode(pipe, args: tuple, label: str) -> None:
    """Kernel 10 in IndexTTS's vocoder at the shapes a request gave it:
    the arguments `_vocode` was called with run again through kernel 10,
    through its bf16 twin, and in fp32 (params and inputs cast, through the
    twin). As in phase 8, kernel 10's rel L2 against fp32 is at most
    STEP_SLACK x the twin's."""
    import tts_tpu_torch.ops.bigvgan_stage as k10
    from tts_tpu_torch.models.bigvgan import bigvgan_apply
    from tts_tpu_torch.models.indextts import gpt_final_norm

    hiddens, frames, fb, cond_embed, conds = args
    dev = hiddens.device
    keep = torch.arange(fb, device=dev)[None] < torch.tensor(frames, device=dev)[:, None]
    h = hiddens[:, :fb] * keep[..., None]

    def wav(dt):
        p = {"final_norm": pipe.params["gpt"]["final_norm"], "bigvgan": pipe.params["bigvgan"]}
        p = cast_tree(p, dt)
        return bigvgan_apply(p["bigvgan"], gpt_final_norm(p, h.to(dt)), pipe.vcfg,
                             conds=[c.to(dt) for c in conds],
                             cond_embed=cond_embed.to(dt)).float()

    kern = wav(torch.bfloat16)
    with swapped(k10, {"amp_block_fused": k10.amp_block_fused_plain}):
        plain = wav(torch.bfloat16)
        ref = wav(torch.float32)
    e_k, e_p = rel_l2(kern, ref), rel_l2(plain, ref)
    ok = bool(torch.isfinite(kern).all()) and e_k <= STEP_SLACK * e_p
    print(f"  {label} vocoder ({tuple(kern.shape)}), rel L2 against the fp32 generator: "
          f"kernel 10 {e_k:.6g}, its bf16 twin {e_p:.6g} (limit {STEP_SLACK} x); kernel "
          f"against twin {rel_l2(kern, plain):.6g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel 10's vocoder is less accurate than its twin's")


def run_indextts(name_limit: str) -> tuple:
    """Phase 9: IndexTTSPipeline at full IndexTTS-1.5 width. Returns the
    launch counts of the bf16 request and the bf16 pipeline and reference."""
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.indextts import IndexTTSPipeline

    cfg, vcfg, params = indextts_models()
    rate = vcfg.sample_rate
    tt = np.arange(6 * rate) / rate
    rng = np.random.default_rng(12)
    sig = (0.3 * np.sin(2 * np.pi * 220 * tt) * (1 + np.sin(2 * np.pi * 3 * tt))
           + 0.1 * np.sin(2 * np.pi * 330 * tt) + 0.05 * rng.standard_normal(tt.size))
    audio = (sig * 12000).astype(np.int16)
    pipes = {"bf16": IndexTTSPipeline(params, cfg, vcfg),
             "int8": IndexTTSPipeline(params, cfg, vcfg, quantize=8)}
    t0 = time.perf_counter()
    ref = pipes["bf16"].encode_reference(audio)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    ref = pipes["bf16"].encode_reference(audio)
    torch.cuda.synchronize()
    print(f"  encode_reference (6 s at {rate} Hz): conds_latent {tuple(ref[0].shape)}, "
          f"cond_embed {tuple(ref[1].shape)}, {len(ref[2])} stage conds, first call "
          f"{t_enc:.3f} s, second {time.perf_counter() - t0 - t_enc:.3f} s", flush=True)
    if not all(bool(torch.isfinite(t).all()) for t in (ref[0], ref[1], *ref[2])):
        raise AssertionError("encode_reference gave non-finite conditioning")
    k10 = kernel10_per_call(vcfg, INDEX_GEN)
    names = ("fused_qkv_rope", "fused_qkv_attn", "amp_block_fused")

    def checked(label, fn, rows):
        before = dict(LAUNCHES)
        wavs, tokens, wall = fn()
        grew = {k: LAUNCHES[k] - before.get(k, 0) for k in names}
        steps = INDEX_GEN - 1                  # the first token is the prefill's
        audio_s = sum(len(w) for w in wavs) / rate
        print(f"  {name_limit}: IndexTTS {label}: {tokens} tokens, "
              f"{[len(w) for w in wavs]} int16 samples, wall {wall:.4f} s, "
              f"{tokens / wall:.2f} tokens/s, RTF {wall / audio_s:.6f}, launches {grew}",
              flush=True)
        want = {"fused_qkv_rope": cfg.gpt_layers * steps, "fused_qkv_attn": 0,
                "amp_block_fused": k10}
        if grew != want:
            raise AssertionError(f"{label}: launches {grew}, expected {want}")
        if tokens != INDEX_GEN * rows or len(wavs) != rows:
            raise AssertionError(f"{label}: {tokens} tokens, expected {INDEX_GEN * rows}")
        for w in wavs:
            if w.dtype != np.int16 or len(w) != (INDEX_GEN - 2) * vcfg.total_upsample \
                    or not w.any():
                raise AssertionError(f"{label}: {len(w)} {w.dtype} samples, expected "
                                     f"{(INDEX_GEN - 2) * vcfg.total_upsample} int16")
        print("  " + json.dumps({"indextts": label, "tokens": tokens, "wall_s": wall,
                                 "tokens_per_s": tokens / wall, "rtf": wall / audio_s}),
              flush=True)
        return grew

    def single(pipe):
        def fn():
            wav, st = pipe.synthesize_ids(INDEX_IDS, ref, max_gen=INDEX_GEN)
            return [wav], st.tokens, st.wall_s
        return fn

    for pipe in pipes.values():                     # warm-up
        pipe.synthesize_ids(INDEX_IDS, ref, max_gen=INDEX_GEN)
    torch.cuda.synchronize()
    vocoded = []                                    # _vocode's arguments, by call
    real_vocode = pipes["bf16"]._vocode
    pipes["bf16"]._vocode = lambda *a: vocoded.append(a) or real_vocode(*a)
    LAUNCHES.clear()
    launches = checked("bf16 request", single(pipes["bf16"]), 1)
    checked("int8 request", single(pipes["int8"]), 1)
    prompts = [INDEX_IDS, np.arange(5, 20, dtype=np.int32)[None],
               np.arange(40, 90, dtype=np.int32)[None], np.array([[7, 1, 4]], np.int32)]

    def batch():
        wavs, st = pipes["bf16"].synthesize_ids_batch([(p, ref) for p in prompts],
                                                      max_gen=INDEX_GEN)
        return wavs, st["tokens"], st["wall_s"]

    checked("batch of 4 (bf16)", batch, 4)
    del pipes["bf16"]._vocode
    for args, label in zip(vocoded, ("bf16 request", "batch of 4")):
        check_index_vocode(pipes["bf16"], args, label)
    check_index_step(pipes["bf16"], ref)
    return launches, pipes["bf16"], ref


def profile_one(label: str, fn, classes, name_limit: str, per: tuple | None = None,
                out_path: str | None = None) -> None:
    """torch.profiler over one fn() after a warm-up: device kernel time by
    class, the device's idle share (1 - kernel time / wall), launches (per
    (count, unit) where given); the table into out_path."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    rows = [(e.key, e.count, e.device_time_total / 1e3) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ms for _, _, ms in rows)
    shares = dict.fromkeys([name for name, _ in classes] + ["elementwise / other"], 0.0)
    for key, _, ms in rows:
        low = key.lower()
        cls = next((name for name, pats in classes if any(p in low for p in pats)),
                   "elementwise / other")
        shares[cls] += ms
    n_launch = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    unit = f" ({n_launch / per[0]:.1f} a {per[1]})" if per else ""
    print(f"  {name_limit}: profile {label}: wall {wall:.4f} s profiled, device kernel time "
          f"{busy:.3f} ms, idle {100 * (1 - busy / 1e3 / wall):.1f}% of the profiled wall, "
          f"{n_launch} launches{unit}", flush=True)
    for name, ms in shares.items():
        print(f"    {name}: {ms:.3f} ms ({100 * ms / max(busy, 1e-9):.1f}%)")
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:10]:
        print(f"    kernel {ms:9.3f} ms {count:6d}x  {key[:110]}")
    if out_path:
        with open(out_path, "w") as f:
            f.write(events.table(sort_by="device_time_total", row_limit=60))
    del prof, events
    gc.collect()


K10_CLASS = ("kernel 10 (amp_branch_kernel)", ("amp_branch",))
CONV_CLASS = ("conv (cuDNN)", ("fprop", "dgrad", "conv", "cudnn", "implicit", "winograd",
                               "fft"))
GEMM_CLASS = ("cuBLAS / GEMM", ("nvjet", "gemv", "gemm", "cutlass", "xmma", "cublas"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build and kernels against twins)")
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one F5 request (bf16 and W8A8), one "
                         "greedy Kani run, one Qwen3-TTS request (bf16 and "
                         "int8), one BigVGAN call and one IndexTTS request, "
                         "the Kani, Qwen, BigVGAN and IndexTTS tables into DIR")
    ap.add_argument("--families", default="f5,kani,qwen,bigvgan,indextts",
                    help="the pipeline phases to run after phase 2, by family: "
                         "f5 (3-5c), kani (6), qwen (7), bigvgan (8, 8c), indextts (9); "
                         "default all (the smoke run's contract)")
    args = ap.parse_args()
    fams = set(args.families.split(","))
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    from tts_tpu_torch.ops import _build

    t_start = time.perf_counter()

    def phase(title: str) -> None:
        print(f"{title} (at {time.perf_counter() - t_start:.1f} s)", flush=True)

    phase("phase 0: device")
    name_limit = card()
    print(name_limit, flush=True)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("phase 1: build")
    path, seconds, log = _build.build()
    _build.library()
    print(f"  built {path.name} in {seconds:.2f} s (0 = already built)", flush=True)
    for line in log.splitlines():     # ptxas -v: registers, smem, spills
        if any(w in line for w in ("entry function", "registers", "spill", "error")):
            print(f"  nvcc: {line.strip()}")

    phase("phase 2: kernels against their twins")
    res = check_kernels(torch.Generator("cuda").manual_seed(1234))
    if args.kernels_only:
        return

    launches: dict = {}
    if "f5" in fams:
        phase("phase 3: F5Pipeline.synthesize")
        pipe, launches = run_pipeline()

        phase("phase 4: F5Pipeline.benchmark")
        bench = pipe.benchmark(ref_seconds=6.0, gen_words=15, iters=3)
        print(f"  {name_limit}: latency RTF {bench['rtf']:.6f} ({bench['wall_s']:.4f} s"
              f" for {bench['audio_s']:.3f} s of audio), sustained RTF "
              f"{bench['sustained_rtf']:.6f}", flush=True)
        print("  " + json.dumps(bench), flush=True)
        # past T 4096 the bf16 route is kernel 5 (the flash core, ONLINE)
        k5 = check_bf16_forward(pipe, 4608, 4600, "bf16")["flash_attention_online"]
        if k5 != pipe.cfg.depth:
            raise AssertionError(f"bf16 T 4608: kernel 5 launched {k5} times, expected "
                                 f"{pipe.cfg.depth}")

        phase('phase 5: F5Pipeline(quantize="w8a8") and quantize=4')
        q8_pipe, q8 = run_w8a8(pipe, name_limit, bench)
        # kernel 9 is on no pipeline's path (as in tts_tpu): phase 2 checks it
        launches.update({k: q8.get(k, 0) for k in Q8_KERNELS + ("quantized_matmul",)})
        if args.profile:
            phase("phase 5b: torch.profiler over one F5 request, bf16 and W8A8")
            profile_f5({"bf16": pipe, "w8a8": q8_pipe}, name_limit)
        del q8_pipe, pipe

        phase("phase 5c: F5Pipeline in fp32")
        launches.update(run_f5_fp32(name_limit, profile=bool(args.profile)))
        launches["flash_attention_online"] += k5

    if "kani" in fams:
        phase("phase 6: KaniPipeline.synthesize_ids")
        kani = run_kani(name_limit)
        launches.update({k: kani[k] for k in ("fused_qkv_rope", "fused_qkv_attn")})
        if args.profile:
            phase("phase 6b: torch.profiler over one greedy Kani run")
            profile_kani(args.profile, name_limit)

    if "qwen" in fams:
        phase("phase 7: QwenTTSPipeline")
        qwen, qwen_pipes = run_qwen(name_limit)
        launches.update(qwen)
        if args.profile:
            phase("phase 7b: torch.profiler over one Qwen3-TTS request")
            profile_qwen(qwen_pipes, args.profile, name_limit)
        del qwen_pipes

    if "bigvgan" in fams:
        phase("phase 8: BigVGANVocoder")
        voc_launches, voc = run_vocoder(name_limit)
        launches.update(voc_launches)
        if args.profile:
            phase("phase 8b: torch.profiler over one BigVGAN call")
            mel = np.random.default_rng(9).standard_normal((1, 512, 100)).astype(np.float32)
            profile_one("BigVGAN bench mel (1, 512, 100)", lambda: voc(mel),
                        (K10_CLASS, CONV_CLASS, GEMM_CLASS), name_limit,
                        out_path=os.path.join(args.profile, "bigvgan_profile.txt"))
        del voc

        phase("phase 8c: BigVGANVocoder in fp32")
        launches.update(run_vocoder_fp32(name_limit))

    if "indextts" in fams:
        phase("phase 9: IndexTTSPipeline")
        _, index_pipe, index_ref = run_indextts(name_limit)
        if args.profile:
            phase("phase 9b: torch.profiler over one IndexTTS request (bf16)")
            profile_one(
                "IndexTTS bf16 request (32 ids, 256 tokens)",
                lambda: index_pipe.synthesize_ids(INDEX_IDS, index_ref, max_gen=INDEX_GEN),
                (("kernel 11 (qkv_matvec / qkv_epilogue)", ("qkv_matvec", "qkv_epilogue")),
                 K10_CLASS, CONV_CLASS, GEMM_CLASS, ("casts / copies", ("copy", "convert"))),
                name_limit, per=(INDEX_GEN, "token"),
                out_path=os.path.join(args.profile, "indextts_profile.txt"))
        del index_pipe

    phase("done")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    summary = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches.get(name, 0), **{k: res[name][k] for k in keys}}
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
