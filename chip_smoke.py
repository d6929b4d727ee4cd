#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tts_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --kernels-only     # phases 0-2
    python3 chip_smoke.py --profile DIR      # and torch.profiler breakdowns
                                             # of one F5 request (bf16, W8A8,
                                             # fp32, fp32 W8A8),
                                             # one greedy Kani run, one
                                             # Qwen3-TTS request (bf16, int8),
                                             # one BigVGAN call, one
                                             # IndexTTS request and its
                                             # vocoder call alone, one
                                             # VoxCPM-2 request
    python3 chip_smoke.py --families bigvgan,indextts   # phases 0-2, 8, 8c, 9
    python3 chip_smoke.py --families voxcpm             # phases 0-2, 10
    python3 chip_smoke.py --families serving            # phases 0-2, 11
    python3 chip_smoke.py --families serving --servers f5   # phase 11's F5 only

Phases, each raising on failure (a failed phase ends the run non-zero):
  0. require a CUDA card; print its name and power limit as nvidia-smi
     reports them; turn TF32 off for matmuls and cuDNN;
  1. build the hand-written kernels from tts_tpu_torch/csrc with nvcc;
  2. each kernel against its plain PyTorch twin in fp32 on the same inputs,
     at the F5 bench shapes (kernel 1 also at head dim 128; kernel 2 also
     at B 2 T 4096, B 1 T 1088 and B 2 T 192 at K 7 and K 33, beside a
     cuDNN yardstick of its two convs; kernel 3 also
     at B 1 T 1088, B 2 T 4608, D 512 F 1536 and rows offset by +100, and
     beside a cuBLAS yardstick of its two GEMMs; kernel 4 in
     bf16 at head dims 64, 128 and 192 and in fp32; kernel 5 at T 8192 in
     bf16 and T 2048 in fp32; kernels 6-9 also on fp32 activations
     (kernel 9 on a K-major weight, as 6-8), kernels 6-8 at
     B 2 T 1400 and B 1 T 1088, kernel 8 at B 2 T 1024 (its 4-stage form),
     kernel 7 at D 576
     (a half K step), kernel 6 at D 640 F 1152 (ff1 a cluster of 9), each
     GEMM form at the bench shape, torch._int_mm at their GEMMs' shapes as
     a yardstick), the
     flash core's edges (kernels 1, 4 and 5 at kv_len 0, 1, 63, 64, 65, T
     64, kernels 4 and 5 at D 256, kernel 5 at S 4224; kernel 1 with a row
     below -66, kernel 4 in fp32 with rows at -90 and -70), kernel 13 at
     its cluster slices' edges, head dim 64 and G 1 and 8, one launch a
     call at kv_len 2047, the kani-tts-370m decode shapes (kernels 11 and
     12 also against their bf16 twins, and no further from fp32 than 1.25x
     those; kernel 11 also at the Qwen3-TTS and IndexTTS-1.5 shapes, B 1, 4
     and 8, in every form of its plan, with programmatic dependent launch
     and without, timed as CUDA events over a chain of 10 calls beside the
     device time a launch and the bound; kernel 12 with its qkv launch's
     PDL on and off, split by launch), the Qwen3-TTS-0.6B talker and
     predictor shapes (kernel 12 at
     head_dim 128, kernels 13-15, kernel 13 timed at both; kernel 14 in
     each of its plan's forms, with programmatic dependent launch and
     without, at B 1, 3 and 8, timed as CUDA events over a chain of 10
     calls beside the profiler's split) and the BigVGAN bench stages
     (kernel 10 in bf16 at stages 2-5, in fp32 at stages 3-5, k 3, 7, 11,
     at 4 batch rows and at T 16484, a ragged last row tile; the row tiles
     its plan does not pick), with its error, its time beside the twin's
     and a library call's where one exists, and its bound (and the flash
     kernels' exp floor); last, kernels 1, 2, 3 and 6 at F5's many-request
     shape, 8 rows of T 1408 (M 11,264): kernel 1 with a kv_len a row, one
     of them 0 (its rows all zeros), kernels 3 and 6 with a mod vector a
     row, kernels 7 and 8 with a shared one, kernel 3 beside its cuBLAS
     yardstick, kernels 6-8 beside torch._int_mm (`check_batch_rows`);
     then kernels 16 and 17, the ablation sets, at their scripts' shapes:
     kernel 16's four epilogue variants and its base over clusters of 2 and
     4 CTAs, kernel 17's twelve variants, each against its fp32 twin, base
     at scale 1 bitwise kernel 1, kvsplit1 bitwise base, the splits
     bitwise over two calls, full bitwise kernel 6, each timed beside its
     twin, its bound and SDPA or torch._int_mm (no later phase may launch
     either);
  3. F5Pipeline.synthesize at full F5TTS_v1_Base width (random weights made
     from a seed) on three requests, checking the audio and that every DiT
     block went through the kernels;
  4. F5Pipeline.benchmark: single-request latency and sustained RTF; one
     bf16 DiT forward at T 4608 through kernel 5 (22 launches) against the
     twins;
  5. F5Pipeline(quantize="w8a8") over the same models: the three requests
     through kernels 6-8 (W8A8), one DiT forward against the twins in bf16
     and fp32, latency and sustained RTF; one quantize=4 request (with
     --profile, one bf16 and one W8A8 request under torch.profiler, the s8
     GEMMs split by kernel in launch order, no launch of kernel 9);
  5c. F5Pipeline in fp32 at full F5TTS_v1_Base width: the bench request
     through kernel 4 (682 launches, none of kernel 1), one fp32 DiT
     forward against the twins at the bench bucket and one at T 4608
     through kernel 5 (22 launches), latency and sustained RTF; then with
     quantize="w8a8": the bench request and one DiT forward against the
     twins through kernels 7, 4, 8 and 6 in fp32 (with --profile, one
     request of each under torch.profiler);
  5d. F5's many-request paths over the bf16 and W8A8 pipelines of phases
     3 and 5: synthesize_batch of 4 requests (a CFG batch of 8 rows) with
     682 launches each of kernels 1 and 3 (W8A8: 1, 6, 7, 8) and 31 of
     kernel 2, each row against its solo run on the row's draw, no further
     than ROW_SLACK times the twins' rows, aggregate RTF beside the solo
     runs'; DiT forwards of the 4 requests with a step vector (bf16:
     kernels 1-3; W8A8: 1, 2, 6, none of 7 and 8) and at one step (W8A8:
     7, 1, 8, 6) against the fp32 twins; the bench request at
     layer_cache_interval=2 (352 launches of kernel 1, none of kernel 3),
     device time beside the exact request's;
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
     tokens/s and RTF;
  10. VoxCPMPipeline at full VoxCPM-2 width (voxcpm_v2_config(): base 24 x
     1024 and residual 4 layers, 16/2 heads x 64; feature encoder 3 x 512;
     estimator 6 x 512; VAE decoder 2048 channels, 48 kHz; random weights
     from seeds): the bench request (16 prompt ids, 32 target ids, 48
     latents) in bf16 and int8 and synthesize_v2("continuation") on a 6 s
     prompt at 16 kHz, each 368,640 int16 samples and 1,344 launches of
     kernel 12 (28 a latent), none of kernel 11; VoxCPM-1.5 (1536 decoder
     channels) synthesize_ids_batch over 8 requests, 1,344 launches of
     kernel 11 and none of kernel 12; one dual-LM step against the fp32
     twins; latents/s and RTF;
  11. the serving layer (tts_tpu_torch/serving) at the full widths of
     phases 6, 7, 9 and 10, every chunk under torch's sync debug mode
     "error" (a chunk reads nothing from the card): KaniSlotServer(slots=4,
     chunk=32) over 6 requests of 48-160 tokens, two admitted mid-decode,
     the short one finishing before an earlier long one, 6 kernel-11
     launches a step and none of kernel 12; TTSServer.continuous +
     serve_http on 127.0.0.1 (3 POSTs, a stream, /stats); a SlotRouter
     over two Kani slot servers on the card (two worker threads launching
     at once, counts exact); QwenSlotServer
     over 4 requests of 24-40 frames on the default route (kernel 11), on
     "all" (11, 13 in the predictor, 14) and int8 "mlp_q8" (11, 15);
     IndexTTSSlotServer over 4 requests of 48-96 tokens (kernel 11 a layer
     step, kernel 10 a vocoder call; a cap past the mel positions refused);
     VoxCPMSlotServer (VoxCPM-2) over 3 requests of 12-20 latents (kernel
     11); for each, one decode step of a spliced, masked batch against the
     twins, the aggregate rate with all 4 rows busy beside the solo
     pipeline's, and p50/p99 latency; F5SlotServer(slots=4,
     chunk_steps=4) over 6 requests, two admitted mid-flight, 22 launches
     of kernels 1 and 3 and one of 2 a step, each request against its
     solo run (within ROW_SLACK of a twin server's rows), a W8A8 server
     (kernel 6, none of 7 and 8), one request over HTTP.
Phase 2 also runs kernels 11 and 12 at the VoxCPM base-LM shape (B 1, 4, 8;
pos 49, 64, 96 of a 128-row cache and 1000 of 2048; bf16 and int8; timed
beside their bounds), and the Kani and VoxCPM checks over four seeds, each
seed's errors printed beside the bf16 twin's.
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
import sys
import time

import numpy as np
import torch

# the card's yardstick (peak rates, bounds, timers), shared with the
# ablation entry points
from tts_tpu_torch.ablations import (PEAK_OPS_S, card, chain_ms, device_ms, exp_floor_ms,
                                     nbytes, set_bound)

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
    "flash_variant": ("tts_tpu_torch/csrc/flash_variants.cu",
                      "benchmarks/flash_ablation.py:159"),
    "mlp_block_q8_variant": ("tts_tpu_torch/csrc/dit_mlp_q8_variants.cu",
                             "benchmarks/q8_kernel_profile.py:56"),
}
F5_KERNELS = ("flash_attention_flat", "conv_pos_embed_fused", "mlp_block_fused")
Q8_KERNELS = ("mlp_block_fused_q8", "ln_qkv_q8", "out_proj_residual_q8")
QWEN_KERNELS = ("fused_qkv_rope", "fused_qkv_attn", "decode_gqa_attention",
                "fused_out_mlp", "fused_out_mlp_q8")
# kernels 16 and 17, the ablation sets: on no pipeline's path
ABLATION_KERNELS = ("flash_variant", "mlp_block_q8_variant")

# the Kani bench request (bench.py:258-264): 5 prompt ids, 256 new tokens
KANI_IDS = [[3, 9, 4, 17, 2]]
KANI_NEW = 256
# the Qwen3-TTS bench request (bench.py:186-191): 32 text ids, language 3,
# max_frames 120
QWEN_IDS = np.arange(5, 37, dtype=np.int32)[None]
QWEN_LANG = 3
QWEN_FRAMES = 120


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
    """Phase 2, kernels 11 and 12 at the kani-tts-370m decode shapes (and
    kernel 11 at the Qwen3-TTS and IndexTTS-1.5 ones) against their fp32
    twins on the same bf16 inputs, each output also no further from fp32
    than STEP_SLACK times the bf16 twin (check_slack); their time as CUDA
    events over a chain of 10 calls (chain_ms: with programmatic dependent
    launch a profiler's sum counts the launches' overlap twice) beside the
    profiler's device time by launch; then every form of kernel 11's plan
    (time_qkv_forms)."""
    from tts_tpu_torch.ops.decode_qkv import fused_qkv_rope, fused_qkv_rope_plain
    from tts_tpu_torch.ops.decode_step import fused_qkv_attn, fused_qkv_attn_plain
    from tts_tpu_torch.quant.weight_only import quantize_int8_jit

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def both(fn, plain, label, *args, **kw):
        return check_slack(label, fn, plain, args, kw)

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
    # IndexTTS-1.5's GPT head: H 1280, 20 x 64 heads, LayerNorm and bias, no
    # RoPE, at one row and at the batch of 4 (inputs from a generator of
    # their own: the checks after these keep their inputs)
    gi = torch.Generator(device="cuda")
    gi.manual_seed(1512)

    def ri(*shape, scale=1.0):
        return (torch.randn(shape, generator=gi, device="cuda") * scale).to(torch.bfloat16)

    wi = ri(1280, 60 * 64, scale=0.02)
    index = dict(heads=20, kv_heads=20, head_dim=64, bqkv=ri(3840, scale=0.1), norm="ln",
                 ln_weight=ri(1280, scale=0.1) + 1, ln_bias=ri(1280, scale=0.1), eps=1e-5)
    for b in (1, 4):
        xi = ri(b, 1280)
        for wt, wl in ((wi, "bf16"), (quantize_int8_jit(wi), "int8")):
            r["max_abs_err"] = max(r["max_abs_err"], both(
                fused_qkv_rope, fused_qkv_rope_plain, f"fused_qkv_rope IndexTTS B={b} {wl}",
                xi, wt, None, None, **index))
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
    # a slice of more than one round of rows (256 at head_dim 64) a CTA
    kc4, vc4 = rn(1, 1, kvh, 4608, hd), rn(1, 1, kvh, 4608, hd)
    for wt, wl in ((w, "bf16"), (wq, "int8")):
        r["max_abs_err"] = max(r["max_abs_err"], both(
            fused_qkv_attn, fused_qkv_attn_plain, f"fused_qkv_attn L=1 T=4608 pos=4500 {wl}",
            x1, wt, cos, sin, kc4, vc4, 0, 4500, **kani))
    del kc4, vc4
    timed["fused_qkv_attn"] = (
        lambda: fused_qkv_attn(x1, w, cos, sin, kc, vc, 3, 700, **kani),
        lambda: fused_qkv_attn_plain(x1, w, cos, sin, kc, vc, 3, 700, **kani))
    # bounds of the timed calls: the weight, the input row, the outputs
    # (and kernel 12's cache rows 0..pos of its layer, k and v)
    w_ops = 2 * hs * w.shape[1]
    set_bound(res["fused_qkv_rope"], nbytes(w, x1) + 2 * w.shape[1], w_ops, "bf16")
    set_bound(res["fused_qkv_attn"], nbytes(w, x1) + 2 * w.shape[1]
              + 2 * kvh * 701 * hd * 2, w_ops + 4 * heads * 701 * hd, "bf16")
    name_limit = card()
    for name, (kernel, plain) in timed.items():
        r = res[name]
        r["ms"], r["plain_ms"] = chain_ms(kernel), device_ms(plain)
        print(f"  {name_limit}: {name}: kernel {r['ms']:.4f} ms a call (CUDA events over a "
              f"chain of 10), profiler sum {device_ms(kernel):.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain twin {r['plain_ms']:.4f} ms "
              f"of device time a call (B=1, pos=700, bf16, profiler over 10 calls); one call's "
              f"wall {time_ms(kernel):.4f} / {time_ms(plain):.4f} ms (median of 10)",
              flush=True)
        print_split(f"{name} (Kani, pos 700)", kernel)
    time_qkv_forms()


def check_slack(label: str, kernel, plain, args: tuple, kw: dict) -> float:
    """kernel(*args, **kw) (kernel 11 or 12) against its fp32 twin within TOL,
    and beside its bf16 twin (the twin's rounding points in bf16): each
    output no further from fp32 than STEP_SLACK times the bf16 twin, as
    check_step holds a route. Draws nothing, so later checks keep their
    inputs. Returns the largest max |err| against fp32."""
    from tts_tpu_torch.quant.weight_only import QTensor

    def f32(a):
        return a.float() if isinstance(a, torch.Tensor) and not isinstance(a, QTensor) else a

    ref32 = plain(*map(f32, args), **{k: f32(v) for k, v in kw.items()})
    worst = 0.0
    for part, g, r16, r32 in zip(("out", "k", "v"), kernel(*args, **kw), plain(*args, **kw),
                                 ref32):
        print(f"  {label} {part}: the bf16 twin's max |err| against fp32 "
              f"{(r16.float() - r32.float()).abs().max().item():.6g}", flush=True)
        worst = max(worst, check(f"{label} {part}", g, r32))
        e_kernel, e_twin = rel_l2(g, r32), rel_l2(r16, r32)
        ok = e_kernel <= STEP_SLACK * e_twin
        print(f"  {label} {part}: rel L2 against fp32: kernel {e_kernel:.6g}, bf16 twin "
              f"{e_twin:.6g} (limit {STEP_SLACK} x) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{label} {part}: the kernel is less accurate than its "
                                 f"bf16 twin")
    return worst


# VoxCPM's base-LM decode shape (tts_tpu/models/voxcpm.py:112-117): hidden
# 1024, 16 q heads over 2 kv heads of 64 (8 a kv head), RMSNorm folded into
# wqkv, RoPE, no q/k norms; kernel 12 at the positions of the bench
# request's 128-row cache (its 49-row prompt, then 48 latents) and at pos
# 1000 of a 2048-row cache, 24 layers
VOX_QKV = dict(heads=16, kv_heads=2, head_dim=64, eps=1e-5)
VOX_STEP_POS = ((128, 49), (128, 64), (128, 96), (2048, 1000))
# the seeds of phase 2's sweep of kernels 11 and 12 (check_decode_seeds)
DECODE_SEEDS = (1601, 1602, 1603, 1604)


def decode_cases(gen: torch.Generator, shape: str) -> list:
    """Phase 2's kernel-11 and kernel-12 cases at the kani-tts-370m (B 1, 5,
    8; pos 5, 700 and 2047 of a 6-layer 2048-row cache, q/k norms, random
    RoPE rows) or the VoxCPM base-LM decode shape (B 1, 4, 8; VOX_STEP_POS
    in 24-layer caches, the RoPE rows of position 49 and of each pos; the
    q and k columns and the cache rows at the model's scales), bf16 and
    int8 weights, inputs drawn from gen in a fixed order:
    [(label, kernel, plain twin, args, kw)]."""
    from tts_tpu_torch.nn.rope import rope_table
    from tts_tpu_torch.ops.decode_qkv import fused_qkv_rope, fused_qkv_rope_plain
    from tts_tpu_torch.ops.decode_step import fused_qkv_attn, fused_qkv_attn_plain
    from tts_tpu_torch.quant.weight_only import quantize_int8_jit

    def rn(*shape_, scale=1.0):
        return (torch.randn(shape_, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    hs = 1024
    if shape == "Kani":
        kvh, hd, layers, rows, steps = 8, 64, 6, (1, 5, 8), ((2048, 5), (2048, 700),
                                                          (2048, 2047))
        w = rn(hs, 32 * hd, scale=0.02)
        norm_w = torch.full((hd,), hd ** -0.25, device="cuda").to(torch.bfloat16)
        kw = dict(heads=16, kv_heads=kvh, head_dim=hd, q_norm=norm_w, k_norm=norm_w,
                  eps=1e-5)
        cos, sin = rn(1, hd), rn(1, hd)
        rope = lambda pos: (cos, sin)              # noqa: E731
    else:
        # tts_tpu's init and loader fold d^-0.25 into the q and k columns;
        # the cache rows at the scale of the step's own k and v rows
        kvh, hd, layers, rows, steps = 2, 64, 24, (1, 4, 8), VOX_STEP_POS
        fold = torch.ones(20 * hd, device="cuda")
        fold[:18 * hd] = hd ** -0.25
        w = (rn(hs, 20 * hd, scale=0.02) * fold).to(torch.bfloat16)
        kw = VOX_QKV
        tab = [torch.as_tensor(a, device="cuda").to(torch.bfloat16)
               for a in rope_table(2048, hd, 10000.0)]
        rope = lambda pos: (tab[0][pos:pos + 1], tab[1][pos:pos + 1])   # noqa: E731
    weights = ((w, "bf16"), (quantize_int8_jit(w), "int8"))
    cases = []
    for b in rows:
        x = rn(b, hs)
        for wt, wl in weights:
            cases.append((f"fused_qkv_rope {shape} B={b} {wl}", fused_qkv_rope,
                          fused_qkv_rope_plain, (x, wt, *rope(49)), kw))
    k_scale, v_scale = (1.0, 1.0) if shape == "Kani" else (0.64 * hd ** -0.25, 0.64)
    for t, pos in steps:
        kc, vc = rn(layers, 1, kvh, t, hd, scale=k_scale), rn(layers, 1, kvh, t, hd,
                                                               scale=v_scale)
        x1 = rn(1, hs)
        for wt, wl in weights:
            cases.append((f"fused_qkv_attn {shape} L={layers} T={t} pos={pos} {wl}",
                          fused_qkv_attn, fused_qkv_attn_plain,
                          (x1, wt, *rope(pos), kc, vc, layers // 2, pos), kw))
    return cases


def check_voxcpm_kernels(res: dict) -> None:
    """Phase 2 at the VoxCPM base-LM decode shape (decode_cases, inputs from
    a generator of their own): kernels 11 and 12 against their fp32 twins
    within TOL and no further from fp32 than STEP_SLACK times their bf16
    twins (check_slack); then each case's time a call as CUDA events over a
    chain of 10 calls, its device time a call (profiler over 10 calls), the
    twin's, and the bound: the weight (bf16 2.62 MB, int8 1.31 MB and its
    scales), the input rows and the outputs at 3.35 TB/s, and kernel 12's
    cache rows 0..pos of its layer, k and v."""
    from tts_tpu_torch.quant.weight_only import QTensor

    name_limit = card()
    for label, kernel, plain, args, kw in decode_cases(
            torch.Generator("cuda").manual_seed(1616), "VoxCPM"):
        name = "fused_qkv_attn" if "attn" in label else "fused_qkv_rope"
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], check_slack(label, kernel, plain, args, kw))
        x, wt = args[0], args[1]
        w = wt.q if isinstance(wt, QTensor) else wt
        n = w.shape[1]
        nb = nbytes(w, x) + 2 * x.shape[0] * n + (4 * n if isinstance(wt, QTensor) else 0)
        ops = 2 * x.shape[0] * x.shape[1] * n
        if name == "fused_qkv_attn":
            pos = args[7]
            nb += 2 * VOX_QKV["kv_heads"] * pos * 64 * 2 + 2 * 16 * 64
            ops += 4 * 16 * (pos + 1) * 64
        bound = {}
        set_bound(bound, nb, ops, "bf16")
        call = lambda: kernel(*args, **kw)          # noqa: E731
        print(f"  {name_limit}: {label}: {chain_ms(call):.4f} ms a call (CUDA events over a "
              f"chain of 10), device time {device_ms(call):.4f} ms a call, plain twin "
              f"{device_ms(lambda: plain(*args, **kw)):.4f} ms (profiler over 10 calls), "
              f"bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}, {nb / 1e6:.3f} MB)",
              flush=True)
        if name == "fused_qkv_attn" and label.endswith("bf16"):
            print_split(f"{name_limit}: {label}", call)


def check_decode_seeds() -> None:
    """Kernels 11 and 12 at the Kani and VoxCPM decode shapes (decode_cases)
    over each of DECODE_SEEDS, every seed's inputs from a generator of its
    own. For each output: the kernel's and the bf16 twin's max |err| (over
    max |ref|) and rel L2 against the fp32 twin. The kernel passes where it
    is within TOL on both, as check() holds it. Where it is not, the seed
    fails unless the bf16 twin misses TOL on that output too: the contract's
    own bf16 rounding then exceeds the limit (counted, and printed at the
    end). Every output is held, on every seed, to rel L2 at most STEP_SLACK
    times the twin's."""
    from tts_tpu_torch.quant.weight_only import QTensor

    def f32(a):
        return a.float() if isinstance(a, torch.Tensor) and not isinstance(a, QTensor) else a

    def errs(got, ref):
        err = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        return err, rel_l2(got, ref), bool(torch.isfinite(got).all())

    twin_misses, n = [], 0
    for seed in DECODE_SEEDS:
        gen = torch.Generator("cuda").manual_seed(seed)
        for label, kernel, plain, args, kw in (decode_cases(gen, "Kani")
                                               + decode_cases(gen, "VoxCPM")):
            ref32 = plain(*map(f32, args), **{k: f32(v) for k, v in kw.items()})
            parts = ("out", "k", "v") if "attn" in label else ("q", "k", "v")
            for part, g, t, r in zip(parts, kernel(*args, **kw), plain(*args, **kw), ref32):
                n += 1
                (km, kr, kf), (tm, tr, _) = errs(g, r), errs(t, r)
                k_ok, t_ok = kf and km <= TOL and kr <= TOL, tm <= TOL and tr <= TOL
                slack = kr <= STEP_SLACK * tr
                verdict = ("ok" if k_ok and slack else
                           "ok (the bf16 twin misses the limit too)" if not t_ok and kf
                           and slack else "FAIL")
                print(f"  seed {seed} {label} {part}: kernel max|err| {km:.6g} rel L2 "
                      f"{kr:.6g}; bf16 twin max|err| {tm:.6g} rel L2 {tr:.6g} (of max|ref|; limit "
                      f"{TOL:.6g}, rel L2 at most {STEP_SLACK} x the twin's) {verdict}",
                      flush=True)
                if verdict == "FAIL":
                    raise AssertionError(f"seed {seed} {label} {part}: the kernel misses a "
                                         f"limit its bf16 twin meets")
                if not k_ok:
                    twin_misses.append(f"seed {seed} {label} {part}")
    listed = ": " + "; ".join(twin_misses) if twin_misses else ""
    print(f"  kernels 11 and 12 over seeds {DECODE_SEEDS}: {n} outputs, the kernel within "
          f"{TOL:.6g} of the fp32 twin on {n - len(twin_misses)}; on {len(twin_misses)} "
          f"the bf16 twin misses it as well{listed}", flush=True)


def time_qkv_forms() -> None:
    """Kernel 11 at the Kani (H 1024, 16/8 x 64, RMSNorm, q/k norms, RoPE),
    Qwen3-TTS (16/8 x 128) and IndexTTS-1.5 (H 1280, 20 x 64, LayerNorm,
    bias, no RoPE) shapes, B 1, 4 and 8, bf16 and int8 weights, in each
    form of its plan, the plan swapped for the call: the plan's with and
    without programmatic dependent launch, and every other cut of the
    input dim (1 to 8 CTAs a tile), with the plan's PDL: the sweep the
    plan's rule was read from. Each within TOL of the fp32 twin, at most
    STEP_SLACK times the bf16 twin's rel L2 against fp32 and bitwise equal
    over two calls; its time a call as CUDA events over a chain of 10
    calls and as the profiler's device time a launch, beside the bound of
    the shape (the weight, the input rows and the outputs). Then kernel 12
    at the Qwen talker (pos 126) and Kani (pos 700) shapes with its qkv
    launch's PDL on and off, split by launch. Inputs from a generator of
    their own."""
    from tts_tpu_torch.nn.rope import rope_table
    from tts_tpu_torch.ops import _build, decode_qkv, decode_step
    from tts_tpu_torch.quant.weight_only import quantize_int8_jit

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1511)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def f32(a):
        return a.float() if isinstance(a, torch.Tensor) else a

    name_limit = card()
    sms = _build.sm_count(torch.device("cuda", torch.cuda.current_device()))
    for shape, hs, heads, kvh, hd in (("Kani", 1024, 16, 8, 64), ("Qwen", 1024, 16, 8, 128),
                                      ("IndexTTS", 1280, 20, 20, 64)):
        n = (heads + 2 * kvh) * hd
        wb = rn(hs, n, scale=0.02)
        if shape == "IndexTTS":
            args = (None, None)
            kw = dict(heads=heads, kv_heads=kvh, head_dim=hd, bqkv=rn(n, scale=0.1), norm="ln",
                      ln_weight=rn(hs, scale=0.1) + 1, ln_bias=rn(hs, scale=0.1), eps=1e-5)
        else:
            nw = torch.full((hd,), hd ** -0.25, device="cuda").to(torch.bfloat16)
            args = tuple(torch.as_tensor(a[126:127], device="cuda").to(torch.bfloat16)
                         for a in rope_table(2048, hd, 1e6))
            kw = dict(heads=heads, kv_heads=kvh, head_dim=hd, q_norm=nw, k_norm=nw, eps=1e-6)
        kw32 = {k: f32(v) for k, v in kw.items()}
        for wl, wt in (("bf16", wb), ("int8", quantize_int8_jit(wb))):
            w_bytes = 2 if wl == "bf16" else 1
            tiles = -(-(heads + 2 * kvh) // decode_qkv.heads_a_tile(hd, w_bytes))
            w32 = wt if wl == "int8" else wt.float()
            for b in (1, 4, 8):
                x = rn(b, hs)
                plan = decode_qkv.qkv_plan(hs, heads + 2 * kvh, hd, w_bytes, sms, b)
                forms = {"the plan's": plan,
                         "with PDL" if not plan.pdl else "without PDL": plan._replace(
                             pdl=not plan.pdl)}
                for ctas in range(1, 9):      # every cut of the input dim
                    k = -(-(-(-hs // ctas)) // 8) * 8
                    form = decode_qkv.QkvPlan(-(-hs // k), k, plan.pdl)
                    if form.ctas == ctas and form != plan:
                        forms[f"{ctas} x {tiles} CTAs"] = form
                ref = decode_qkv.fused_qkv_rope_plain(x.float(), w32, *map(f32, args), **kw32)
                twin = decode_qkv.fused_qkv_rope_plain(x, wt, *args, **kw)
                twin_rel = [rel_l2(t, r) for t, r in zip(twin, ref)]
                nb = nbytes(wt.q if wl == "int8" else wt, x) + 2 * b * n \
                    + (4 * n if wl == "int8" else 0)
                bound = {}
                set_bound(bound, nb, 2 * b * hs * n, "bf16")
                for label, form in forms.items():
                    def call(_f=form):
                        with swapped(decode_qkv, {"qkv_plan": lambda *a, **k: _f}):
                            return decode_qkv.fused_qkv_rope(x, wt, *args, **kw)

                    got = call()
                    tag = f"fused_qkv_rope {shape} B {b} {wl} weights, {label} form {tuple(form)}"
                    for part, g, r in zip(("q", "k", "v"), got, ref):
                        check(f"{tag} {part}", g, r)
                    rels = [rel_l2(g, r) for g, r in zip(got, ref)]
                    same = all(torch.equal(u, v) for u, v in zip(call(), got))
                    ratio = max(e / t for e, t in zip(rels, twin_rel))
                    print(f"  {tag}: rel L2 against fp32 at most {ratio:.4f} x the bf16 "
                          f"twin's (limit {STEP_SLACK}), a second call "
                          f"{'bitwise equal' if same else 'DIFFERENT'}", flush=True)
                    if ratio > STEP_SLACK or not same:
                        raise AssertionError(f"{tag}: error {ratio} x the bf16 twin's, "
                                             f"repeatable {same}")
                    print(f"  {name_limit}: {tag}: {chain_ms(call):.4f} ms a call (CUDA "
                          f"events over a chain of 10), device time a launch "
                          f"{device_ms(call):.4f} ms (profiler over 10 calls), bound "
                          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
                          f"{nb / 1e6:.3f} MB)", flush=True)

    for shape, hd, eps, t, pos in (("Qwen talker", 128, 1e-6, 640, 126),
                                   ("Kani", 64, 1e-5, 2048, 700)):
        w = rn(1024, 32 * hd, scale=0.02)
        nw = torch.full((hd,), hd ** -0.25, device="cuda").to(torch.bfloat16)
        cos, sin = (torch.as_tensor(a[pos:pos + 1], device="cuda").to(torch.bfloat16)
                    for a in rope_table(2048, hd, 1e6))
        kc, vc = rn(2, 1, 8, t, hd, scale=hd ** -0.25), rn(2, 1, 8, t, hd)
        x1 = rn(1, 1024)
        kw = dict(heads=16, kv_heads=8, head_dim=hd, q_norm=nw, k_norm=nw, eps=eps)
        plan = decode_qkv.qkv_plan(1024, 32, hd, 2, sms)
        for pdl in (plan.pdl, not plan.pdl):
            def call(_p=plan._replace(pdl=pdl)):
                with swapped(decode_qkv, {"qkv_plan": lambda *a, **k: _p}):
                    return decode_step.fused_qkv_attn(x1, w, cos, sin, kc, vc, 1, pos, **kw)

            label = (f"fused_qkv_attn {shape} pos {pos} bf16, the qkv launch "
                     f"{'with' if pdl else 'without'} PDL")
            print(f"  {name_limit}: {label}: {chain_ms(call):.4f} ms a call (CUDA events over "
                  f"a chain of 10)", flush=True)
            print_split(f"{name_limit}: {label}", call)


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
    for stack, layers, t, positions in (("talker", 28, 640, (6, 33, 126, 639)),
                                        ("predictor", 4, 32, (0, 2, 17))):
        # cached keys at the scale the k norm (weight d^-0.25) gives them
        kc, vc = rn(layers, 1, kvh, t, hd, scale=hd ** -0.25), rn(layers, 1, kvh, t, hd)
        for pos in positions:
            cos, sin = table[0][pos:pos + 1], table[1][pos:pos + 1]
            for wt, wl in ((w, "bf16"), (wq, "int8")):
                r["max_abs_err"] = max(r["max_abs_err"], check_slack(
                    f"fused_qkv_attn hd128 {stack} L={layers} T={t} pos={pos} {wl}",
                    fused_qkv_attn, fused_qkv_attn_plain,
                    (x1, wt, cos, sin, kc, vc, layers - 1, pos), qwen))
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
        chained = name.startswith(("fused_out_mlp", "fused_qkv")) and "q8" not in name
        if chained:
            # kernels 14's and 12's launches overlap (programmatic dependent
            # launch): the profiler's sum counts the overlap twice
            summed, r["ms"] = r["ms"], chain_ms(kernel)
            print(f"  {name_limit}: {name}: profiler sum {summed:.4f} ms a call, CUDA events "
                  f"over a chain of 10 calls {r['ms']:.4f} ms a call, trace span "
                  f"{trace_span_ms(kernel):.4f} ms a call", flush=True)
        set_bound(r, nb, ops, kind)
        lib_txt = "none"
        if lib is not None:
            r["library_ms"] = device_ms(lib)
            lib_txt = f"{r['library_ms']:.4f} ms (SDPA, enable_gqa)"
        how = "CUDA events over a chain of 10 calls" if chained else "profiler over 10 calls"
        print(f"  {name_limit}: {name}: kernel {r['ms']:.4f} ms, plain twin "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{nb / 1e6:.3f} MB, "
              f"{ops / 1e9:.4f} G {kind} ops), library {lib_txt} (Qwen talker shape, "
              f"B=1, device time a call, {how}; twin: profiler); one call's wall "
              f"{time_ms(kernel):.4f} / {time_ms(plain):.4f} ms (median of 10)", flush=True)
        print_split(name, kernel)
    time_decode_forms(gen)


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
            time_conv(r, x, w1, b1, w2, b2, got)
        del got, ref
    check_conv_shapes(torch.Generator("cuda").manual_seed(4331), res)

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
               else "device time a call, profiler over 10 calls"
               if name == "conv_pos_embed_fused" else "CUDA events, median of 10")
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
    check_voxcpm_kernels(res)
    check_decode_seeds()
    check_bigvgan_kernel(gen, res)
    check_bigvgan_kernel(gen, res, f32=True)
    time_amp_forms()
    check_batch_rows(torch.Generator("cuda").manual_seed(4333), res)
    check_flash_variants(torch.Generator("cuda").manual_seed(4335), res)
    check_mlp_variants(torch.Generator("cuda").manual_seed(4337), res)
    return res


def bitwise(label: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    """got equal to ref bit for bit."""
    torch.cuda.synchronize()
    ok = torch.equal(got, ref)
    print(f"  {label}: {'bitwise equal' if ok else 'DIFFERS'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: not bitwise equal")


def check_flash_variants(gen: torch.Generator, res: dict) -> None:
    """Phase 2, kernel 16 at benchmarks/flash_ablation.py's shape (B 2, T
    1408, H 16, D 64, scale 1/8, every key kept; qkv ~ N(0, 0.25), its
    RoPE tables): each epilogue variant and base over 2 and 4 CTAs against
    its fp32 twin on the same bf16 inputs (TOL); base at scale 1 bitwise
    kernel 1 with kv_len T, kvsplit1 bitwise base, kvsplit2 and 4 bitwise
    the same over two calls; device time a call (profiler over 10 calls,
    its two launches, the RoPE pre-pass and the core, as the entry point
    times them) beside the twin's, CUDA events over a chain of 10, the
    bound and the exp floor, and SDPA's device time with the same scale."""
    from tts_tpu_torch.ops.flash_attention import flash_attention_flat
    from tts_tpu_torch.ops.flash_variants import VARIANTS, flash_variant, flash_variant_plain

    name_limit = card()
    b, t, h, d, scale = 2, 1408, 16, 64, 0.125
    qkv = (torch.randn((b, t, 3 * h * d), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    ang = torch.arange(t, device="cuda")[:, None] \
        * torch.exp(-torch.arange(d, device="cuda")[None, :] / 10.0)
    cos, sin = torch.cos(ang), torch.sin(ang)
    r = res["flash_variant"]
    one = {}
    # qkv, the tables and the (B, T, H*D) bf16 output; QK^T and PV over every key
    set_bound(one, nbytes(qkv, cos, sin) + b * t * h * d * 2, 4 * b * h * t * t * d, "bf16")

    def call(variant, split=1, s=scale):
        return flash_variant(qkv, cos, sin, heads=h, scale=s, variant=variant, kv_split=split)

    for variant, split in [(v, 1) for v in VARIANTS] + [("base", 2), ("base", 4)]:
        label = f"flash_variant {variant} kv_split {split} B={b} T={t} H={h} D={d}"
        got = call(variant, split)
        r["max_abs_err"] = max(r["max_abs_err"], check(label, got, flash_variant_plain(
            qkv.float(), cos, sin, heads=h, scale=scale, variant=variant)))
        if split > 1:
            bitwise(f"{label}, two calls", got, call(variant, split))
        ms = device_ms(lambda: call(variant, split), only=("rope_qk", "flash_variant"))
        plain = device_ms(lambda: flash_variant_plain(qkv, cos, sin, heads=h, scale=scale,
                                                      variant=variant))
        print(f"  {name_limit}: {label}: device time {ms:.4f} ms a call (profiler over 10 "
              f"calls, both launches), chained {chain_ms(lambda: call(variant, split)):.4f} ms "
              f"(CUDA events over a chain of 10), twin {plain:.4f} ms, bound "
              f"{one['bound_ms']:.4f} ms ({one['bound_by']}), exp floor "
              f"{exp_floor_ms(b * h * t * t):.4f} ms", flush=True)
        if (variant, split) == ("base", 1):
            r.update(ms=ms, plain_ms=plain, **one)
            r["library_ms"] = sdpa_ms(qkv, cos, sin, t, device=True, scale=scale)
            print(f"  {name_limit}: flash_variant library call, SDPA at scale {scale}: device "
                  f"time {r['library_ms']:.4f} ms", flush=True)
            bitwise("flash_variant kvsplit1 against base", call("base", 1), got)
            bitwise("flash_variant base at scale 1 against flash_attention_flat, kv_len T",
                    call("base", 1, 1.0), flash_attention_flat(qkv, cos, sin, heads=h))
        del got


# kernel 17's variants by the function they compute: within a class only
# fp32 rounding differs (a one-pass LN, tanh through exp2, sigmoid through
# exp2), across classes the function itself
MLP_CLASSES = (("full", "ln_one_pass", "gelu_tanh_exp2"), ("no_ln",), ("fixed_scale",),
               ("gelu_bf16", "lean"), ("gelu_relu",), ("no_gelu",),
               ("gelu_sig", "gelu_sig_exp2"))
# the pairs of one class whose kernels must still differ in at least one
# bit of their output (their row pass or tanh rounds otherwise); gelu_sig's
# expf and gelu_sig_exp2's exp2f may round alike, and are only printed
MLP_ROUNDING_PAIRS = (("ln_one_pass", "full"), ("gelu_tanh_exp2", "full"),
                      ("lean", "gelu_bf16"))
# a variant's MLP term (out - x) against the twins on the same bf16
# arguments, which round where the kernels do: of what separates its own
# twin's term V from the twin's term U of each variant of another class,
# the kernel must reproduce at least this share, <g - U, V - U> / |V - U|^2
# (1 for its own twin, 0 for U's; above 1/2 is nearer V than U). A kernel
# that ran another class's hooks scores about 0 against that class; the
# right ones score 0.79 (gelu_bf16 and lean, whose tanh.approx.bf16x2 is
# not the twin's correctly rounded bf16 tanh) to 1.0 on the card.
MLP_DISPATCH_SHARE = 0.5


def check_mlp_variants(gen: torch.Generator, res: dict) -> None:
    """Phase 2, kernel 17 at benchmarks/q8_kernel_profile.py's shape (B 2, T
    1408, D 1024, F 2048) and inputs (x ~ N(0, 1) and mods ~ N(0, 0.01) in
    bf16, int8 weights uniform in [-127, 127] stored K-major, scales 1e-3,
    zero biases): each variant but dots_only against its fp32 twin on the
    same inputs, out and out - x (the MLP term) within TOL, and told apart
    from the other variants (MLP_DISPATCH_SHARE, MLP_ROUNDING_PAIRS);
    dots_only, integer work, bitwise its twin rounded to bf16, on x spread
    x20 so that ff1's acc >> 8 wraps (a share of its values, printed);
    full bitwise kernel 6; device time a
    call of its int8 kernels (profiler over 10 calls) beside the twin's,
    full's less it (the marginal), the bound, and torch._int_mm at the two
    GEMMs' shapes. max_abs_err leaves dots_only out."""
    from tts_tpu_torch.ops.dit_mlp import mlp_block_fused_q8
    from tts_tpu_torch.ops.dit_mlp_q8_variants import (VARIANTS, mlp_block_q8_variant,
                                                       mlp_block_q8_variant_plain)
    from tts_tpu_torch.ops.quant_matmul import to_kmajor

    name_limit = card()
    b, t, d, f = 2, 1408, 1024, 2048
    m = b * t
    x = torch.randn((b, t, d), generator=gen, device="cuda").to(torch.bfloat16)
    mods = (torch.randn((1, 3, d), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    w1, w2 = (to_kmajor(torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                      dtype=torch.int8)) for shape in ((d, f), (f, d)))
    s1, s2 = torch.full((f,), 1e-3, device="cuda"), torch.full((d,), 1e-3, device="cuda")
    args = (x, mods, w1, s1, torch.zeros_like(s1), w2, s2, torch.zeros_like(s2))
    a32 = [a.float() if a.is_floating_point() else a for a in args]
    r = res["mlp_block_q8_variant"]
    one = {}
    set_bound(one, nbytes(*args, x), 4 * m * d * f, "int8")
    full_ms = None
    outs, twins = {}, {}
    for variant in VARIANTS:
        label = f"mlp_block_q8_variant {variant} x=({b}, {t}, {d}) F={f}"
        if VARIANTS[variant] is None:
            xd = (x.float() * 20.0).to(torch.bfloat16)
            targs = (xd, *args[1:])
            got = mlp_block_q8_variant(*targs, variant=variant)
            acc = torch.trunc(xd.float()).clamp(-128, 127).reshape(m, d).double() @ w1.double()
            wraps = ((acc.long() >> 8).abs() > 127).float().mean().item()
            print(f"  {label}, x spread x20: {wraps:.3f} of ff1's acc >> 8 wrap", flush=True)
            if wraps == 0:
                raise AssertionError(f"{label}: no acc >> 8 wraps; the check cannot see it")
            bitwise(f"{label}, x spread x20, against its twin in bf16", got,
                    mlp_block_q8_variant_plain(*targs, variant=variant))
            del acc
        else:
            targs = args
            got = mlp_block_q8_variant(*args, variant=variant)
            ref = mlp_block_q8_variant_plain(*a32, variant=variant)
            r["max_abs_err"] = max(r["max_abs_err"], check(label, got, ref))
            check(f"{label}, out - x", got.float() - x.float(), ref - x.float())
            outs[variant] = got
            twins[variant] = mlp_block_q8_variant_plain(*args, variant=variant)
            del ref
        call = lambda v=variant, a=targs: mlp_block_q8_variant(*a, variant=v)  # noqa: E731
        ms, plain = device_ms(call, only="q8_"), device_ms(lambda: mlp_block_q8_variant_plain(
            *targs, variant=variant))
        if variant == "full":
            full_ms = ms
            r.update(ms=ms, plain_ms=plain, **one)
            bitwise("mlp_block_q8_variant full against mlp_block_fused_q8", got,
                    mlp_block_fused_q8(*args))
        split = device_split(call, parts=Q8_SPLIT + (("dots_only's conversion", "q8_trunc"),
                                                     ("dots_only's GEMMs", "q8_dots")))
        print(f"  {name_limit}: {label}: device time {ms:.4f} ms a call (profiler over 10 "
              f"calls: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items() if v) +
              f"), full less it {full_ms - ms:+.4f} ms, twin {plain:.4f} ms, bound "
              f"{one['bound_ms']:.4f} ms ({one['bound_by']})", flush=True)
        del got
    check_mlp_dispatch(x, outs, twins)
    print(f"  {name_limit}: mlp_block_q8_variant yardstick, torch._int_mm ({m}x{d} @ {d}x{f} "
          f"and {m}x{f} @ {f}x{d}): {int_mm_ms(m, d, f):.4f} + {int_mm_ms(m, f, d):.4f} ms "
          f"device time", flush=True)


def check_mlp_dispatch(x: torch.Tensor, outs: dict, twins: dict) -> None:
    """Each kernel-17 variant ran its own hooks: against every variant of
    another class its MLP term reproduces MLP_DISPATCH_SHARE or more of
    what separates the two bf16 twins, and the rounding pairs are not
    bitwise equal."""
    cls = {v: c for c in MLP_CLASSES for v in c}
    xf = x.float()
    terms = {v: (twin.float() - xf).flatten().double() for v, twin in twins.items()}
    for v, got in outs.items():
        g, own = (got.float() - xf).flatten().double(), terms[v]
        share = {}
        for u, other in terms.items():
            if u not in cls[v]:
                sep = own - other
                share[u] = (torch.dot(g - other, sep) / torch.dot(sep, sep)).item()
        low = min(share, key=share.get)
        ok = share[low] >= MLP_DISPATCH_SHARE
        print(f"  mlp_block_q8_variant {v}: out - x against its bf16 twin rel_l2 "
              f"{rel_l2(g, own):.6g}; share of its separation from each other class's "
              f"twin reproduced: least {share[low]:.4f} ({low}; limit {MLP_DISPATCH_SHARE}), "
              f"most {max(share.values()):.4f} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"mlp_block_q8_variant {v}: not told apart from {low}")
    for v, u in MLP_ROUNDING_PAIRS:
        same = torch.equal(outs[v], outs[u])
        print(f"  mlp_block_q8_variant {v} against {u}: "
              f"{'bitwise EQUAL' if same else 'differs'}", flush=True)
        if same:
            raise AssertionError(f"mlp_block_q8_variant {v}: bitwise {u}'s output")
    same = torch.equal(outs["gelu_sig_exp2"], outs["gelu_sig"])
    print(f"  mlp_block_q8_variant gelu_sig_exp2 against gelu_sig: "
          f"{'bitwise equal' if same else 'differs'} (one function, not checked)", flush=True)


def check_batch_rows(gen: torch.Generator, res: dict) -> None:
    """Phase 2, kernels 1, 2, 3 and 6-8 at the shapes of F5's many-request
    paths: 4 requests' CFG batch of 8 rows at the bench bucket (T 1408, M
    11,264), as synthesize_batch and a 4-slot F5SlotServer give them.
    Kernel 1 with a kv_len a row, one of them 0 (an idle slot: its rows
    all zeros), kernels 3 and 6 with a mod vector a row (8, 3, D), each
    against its fp32 twin on the same bf16 inputs (kernel 6 also on fp32
    activations); device time a call (profiler over 10 calls) beside the
    twin's and the bound over this run's work (kernel 1: the keys each row
    keeps); kernel 3 beside its cuBLAS yardstick, kernels 6-8 beside
    torch._int_mm at their GEMMs' shapes (7 and 8 with one shared mod
    vector, as a synthesize_batch step gives them)."""
    from tts_tpu_torch.models.f5 import f5_rope_tables
    from tts_tpu_torch.ops.dit_mlp import (gemm_plan, mlp_block_fused, mlp_block_fused_q8,
                                           mlp_block_plain, mlp_block_q8_plain)
    from tts_tpu_torch.ops.flash_attention import (flash_attention_flat,
                                                   flash_attention_flat_plain)
    from tts_tpu_torch.ops.grouped_conv import conv_pos_embed_fused, conv_pos_embed_plain
    from tts_tpu_torch.ops.quant_matmul import (ln_qkv_q8, ln_qkv_q8_plain,
                                                out_proj_residual_q8,
                                                out_proj_residual_q8_plain, q8_plan,
                                                to_kmajor)
    from tts_tpu_torch.quant.weight_only import quantize_int8_eager

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    name_limit = card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b, t, d, f, h = 8, 1408, 1024, 2048, 16
    m = b * t

    # kernel 1: a kv_len a row, one idle row at 0
    cos, sin = (torch.tensor(a, device="cuda").to(torch.bfloat16).float()
                for a in f5_rope_tables(t, 64))
    lens = [1396, 700, 0, 1408, 1200, 64, 1, 1000]
    kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
    qkv = rn(b, t, 3 * h * 64, scale=0.5)
    got = flash_attention_flat(qkv, cos, sin, kv, heads=h)
    r = res["flash_attention_flat"]
    r["max_abs_err"] = max(r["max_abs_err"], check(
        f"flash_attention_flat B=8 H=16 D=64 T={t} kv_len per row {tuple(lens)}", got,
        flash_attention_flat_plain(qkv.float(), cos, sin, kv, heads=h)))
    torch.cuda.synchronize()
    if got[2].any():
        raise AssertionError("flash_attention_flat B=8: the kv_len 0 row is not all zeros")
    one = {}
    set_bound(one, nbytes(qkv, cos, sin, got), 4 * h * t * sum(lens) * 64, "bf16")
    print(f"  {name_limit}: flash_attention_flat B 8 (kv_len per row, row 2 at 0: all zeros "
          f"ok): device time "
          f"{device_ms(lambda: flash_attention_flat(qkv, cos, sin, kv, heads=h)):.4f} ms a "
          f"call (profiler over 10 calls, pre-pass and core), twin "
          f"{device_ms(lambda: flash_attention_flat_plain(qkv, cos, sin, kv, heads=h)):.4f} "
          f"ms, bound {one['bound_ms']:.4f} ms ({one['bound_by']}, the {sum(lens)} keys kept), "
          f"exp floor {exp_floor_ms(h * t * sum(lens)):.4f} ms; library call, SDPA with the "
          f"rows' key masks: device time {sdpa_ms(qkv, cos, sin, kv, device=True):.4f} ms",
          flush=True)
    del qkv, got

    # kernel 2
    x = rn(b, t, d)
    w1, w2 = rn(31, 64, d, scale=0.02), rn(31, 64, d, scale=0.02)
    b1, b2 = rn(d, scale=0.1), rn(d, scale=0.1)
    got = conv_pos_embed_fused(x, w1, b1, w2, b2)
    r = res["conv_pos_embed_fused"]
    r["max_abs_err"] = max(r["max_abs_err"], check(
        f"conv_pos_embed_fused x=(8, {t}, {d}) K=31 groups=16", got,
        conv_pos_embed_plain(*(a.float() for a in (x, w1, b1, w2, b2)))))
    one = {}
    set_bound(one, nbytes(x, w1, b1, w2, b2, got), conv_ops(b, t, d, 31), "bf16")
    print(f"  {name_limit}: conv_pos_embed_fused B 8 T {t}: device time "
          f"{device_ms(lambda: conv_pos_embed_fused(x, w1, b1, w2, b2)):.4f} ms a call "
          f"(profiler over 10 calls, both launches), twin "
          f"{device_ms(lambda: conv_pos_embed_plain(x, w1, b1, w2, b2)):.4f} ms, bound "
          f"{one['bound_ms']:.4f} ms ({one['bound_by']})", flush=True)
    del got

    # kernel 3: a mod vector a row
    w1, w2 = rn(d, f, scale=0.02), rn(f, d, scale=0.02)
    b1, b2 = rn(f, scale=0.1), rn(d, scale=0.1)
    mods = rn(b, 3, d, scale=0.5)
    args = (x, mods, w1, b1, w2, b2)
    p1, p2 = gemm_plan(m, f, sms), gemm_plan(m, d, sms)
    got = mlp_block_fused(*args)
    r = res["mlp_block_fused"]
    r["max_abs_err"] = max(r["max_abs_err"], check(
        f"mlp_block_fused x=(8, {t}, {d}) F={f} mods per-row (8, 3, D) (ff1 bn {p1.bn} x "
        f"{p1.stages} stages, ff2 bn {p2.bn} x {p2.stages})", got,
        mlp_block_plain(*(a.float() for a in args))))
    a1 = x.reshape(m, d)
    a2 = torch.empty((m, f), dtype=x.dtype, device="cuda").normal_()
    one = {}
    set_bound(one, nbytes(*args, got), 4 * m * d * f, "bf16")

    def yardstick():
        return torch.matmul(a1, w1), torch.matmul(a2, w2)

    print(f"  {name_limit}: mlp_block_fused x=(8, {t}, {d}) per-row mods (M {m}; plans ff1 "
          f"{p1}, ff2 {p2}): {time_ms(lambda: mlp_block_fused(*args)):.4f} ms by CUDA events "
          f"(median of 10), device time {device_ms(lambda: mlp_block_fused(*args)):.4f} ms a "
          f"call (profiler over 10 calls); twin {time_ms(lambda: mlp_block_plain(*args)):.4f} "
          f"ms by events; bound {one['bound_ms']:.4f} ms ({one['bound_by']}); cuBLAS "
          f"yardstick, two bf16 torch.matmul at its GEMMs' shapes: "
          f"{time_ms(yardstick):.4f} ms by events, {device_ms(yardstick):.4f} ms device time",
          flush=True)
    del got, a2

    # kernel 6: a mod vector a row, int8 weights K-major
    q1, q2 = quantize_int8_eager(rn(d, f, scale=0.02)), quantize_int8_eager(rn(f, d, scale=0.02))
    args = (x, mods, to_kmajor(q1.q), q1.scale, b1, to_kmajor(q2.q), q2.scale, b2)
    check_q8_call(res, "mlp_block_fused_q8", mlp_block_fused_q8, mlp_block_q8_plain, args,
                  f"x=(8, {t}, {d}) F={f} mods per-row (8, 3, D) (plans ff1 "
                  f"{q8_plan(m, f, d, sms, whole_rows=True)}, ff2 {q8_plan(m, d, f, sms)})",
                  4 * m * d * f)
    print(f"  {name_limit}: mlp_block_fused_q8 x=(8, {t}, {d}): twin "
          f"{device_ms(lambda: mlp_block_q8_plain(*args)):.4f} ms device time; yardstick "
          f"torch._int_mm ({m}x{d} @ {d}x{f} and {m}x{f} @ {f}x{d}) "
          f"{int_mm_ms(m, d, f):.4f} + {int_mm_ms(m, f, d):.4f} ms device time", flush=True)

    # kernels 7 and 8 at the batch's 8 rows (one shared mod vector: a
    # synthesize_batch step; a slot server's per-row mods keep them off)
    n = 3 * d
    qkv_w, wo = quantize_int8_eager(rn(d, n, scale=0.02)), quantize_int8_eager(rn(d, d, scale=0.02))
    for name, kernel, plain, args, label, ops, shape in (
            ("ln_qkv_q8", ln_qkv_q8, ln_qkv_q8_plain,
             (x, rn(2, d, scale=0.5), to_kmajor(qkv_w.q), qkv_w.scale, rn(n, scale=0.1)),
             f"x=(8, {t}, {d}) N={n} (plan {q8_plan(m, n, d, sms)})", 2 * m * d * n, (m, d, n)),
            ("out_proj_residual_q8", out_proj_residual_q8, out_proj_residual_q8_plain,
             (rn(b, t, d), to_kmajor(wo.q), wo.scale, rn(d, scale=0.1), rn(d, scale=0.5), x),
             f"o=(8, {t}, {d}) D={d} (plan {q8_plan(m, d, d, sms)})", 2 * m * d * d,
             (m, d, d))):
        check_q8_call(res, name, kernel, plain, args, label, ops)
        print(f"  {name_limit}: {name} 8 rows: twin "
              f"{device_ms(lambda: plain(*args)):.4f} ms device time; yardstick "
              f"torch._int_mm ({shape[0]}x{shape[1]} @ {shape[1]}x{shape[2]}) "
              f"{int_mm_ms(*shape):.4f} ms device time", flush=True)


def conv_ops(b: int, t: int, c: int, k: int) -> int:
    """Kernel 2's operations: two grouped convs, 2 * rows * C_out * (K *
    64) each."""
    return 2 * 2 * (b * t) * c * k * 64


def time_conv(r: dict, x, w1, b1, w2, b2, got) -> None:
    """Kernel 2 at the bench shape: device time a call from a profiler
    trace of 10 calls (r["ms"]; its two launches) and by CUDA events, the
    twin's device time, the bound, and the cuDNN yardstick: the two grouped
    convs alone as bf16 F.conv1d(groups=16) on (B, C, T) copies (no bias
    rounding, mish or residual; TF32 is off), a measure of what a library
    conv gives here, not a call for the same function (library_ms stays
    None); the port never calls it. Then device time a call at B 2 T 4096
    and B 1 T 1088."""
    import torch.nn.functional as F

    from tts_tpu_torch.ops import grouped_conv

    b, t, c = x.shape
    k = w1.shape[0]

    def kernel():
        return grouped_conv.conv_pos_embed_fused(x, w1, b1, w2, b2)

    r["ms"] = device_ms(kernel)
    r["plain_ms"] = device_ms(lambda: grouped_conv.conv_pos_embed_plain(x, w1, b1, w2, b2))
    set_bound(r, nbytes(x, w1, b1, w2, b2, got), conv_ops(b, t, c, k), "bf16")
    xt = x.transpose(1, 2).contiguous()
    # (K, 64, C) WIO -> (C_out, 64, K) as F.conv1d takes it
    wt1, wt2 = (w.permute(2, 1, 0).contiguous() for w in (w1, w2))

    def yardstick():
        return (F.conv1d(xt, wt1, padding=k // 2, groups=c // 64),
                F.conv1d(xt, wt2, padding=k // 2, groups=c // 64))

    yard = device_ms(yardstick)
    print(f"  {card()}: conv_pos_embed_fused bench shape (B {b}, T {t}, C {c}, K {k}): "
          f"device time {r['ms']:.4f} ms a call (profiler over 10 calls, both launches), "
          f"{time_ms(kernel):.4f} ms by CUDA events (median of 10); bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}); twin {r['plain_ms']:.4f} ms device "
          f"time; cuDNN yardstick, two bf16 F.conv1d(groups={c // 64}) at its shapes: "
          f"{yard:.4f} ms device time", flush=True)
    gen = torch.Generator("cuda").manual_seed(4332)
    for bb, tt in ((2, 4096), (1, 1088)):
        xx = torch.randn((bb, tt, c), generator=gen, device="cuda").to(torch.bfloat16)
        ms = device_ms(lambda: grouped_conv.conv_pos_embed_fused(xx, w1, b1, w2, b2))
        print(f"  {card()}: conv_pos_embed_fused B {bb} T {tt}: device time {ms:.4f} ms a "
              f"call, bound {conv_ops(bb, tt, c, k) / PEAK_OPS_S['bf16'] * 1e3:.4f} ms (ops)",
              flush=True)
        del xx


def check_conv_shapes(gen: torch.Generator, res: dict) -> None:
    """Phase 2, kernel 2 past the bench shape against its fp32 twin on the
    same bf16 inputs: B 1 T 1088 (the last 128-row tile half past T), and B
    2 T 192 (a ragged last tile) at K 7 (a short halo) and K 33 (the widest
    the halo buffer takes)."""
    from tts_tpu_torch.ops.grouped_conv import conv_pos_embed_fused, conv_pos_embed_plain

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    r = res["conv_pos_embed_fused"]
    for b, t, k in ((1, 1088, 31), (2, 192, 7), (2, 192, 33)):
        x = rn(b, t, 1024)
        args = (x, rn(k, 64, 1024, scale=0.02), rn(1024, scale=0.1),
                rn(k, 64, 1024, scale=0.02), rn(1024, scale=0.1))
        r["max_abs_err"] = max(r["max_abs_err"], check(
            f"conv_pos_embed_fused x=({b}, {t}, 1024) K={k} groups=16",
            conv_pos_embed_fused(*args), conv_pos_embed_plain(*(a.float() for a in args))))


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


def check_bigvgan_kernel(gen: torch.Generator, res: dict, f32: bool = False) -> None:
    """Phase 2, kernel 10 against its fp32 twin on the same inputs at the
    BigVGAN bench stages it runs (bf16: stages 2-5, C 192, 96, 48, 24;
    fp32 (`f32`, TF32 off): stages 3-5, C <= 128) for k = 3, 7, 11, within
    TOL (bf16) or TOL32 (fp32); with 4 batch rows of T / 4 at its first and
    last stage (k 11) and, on inputs of their own, at T = 16384 + 100 (a
    ragged last row tile) at every stage (k 11) and with x scaled by 8192
    at the last stage (the act's sine arguments past its fast path's
    range: the sinf path). CUDA-event times (median of
    10) of the kernel and of its twin at each stage and k, the kernel's
    device time by launch (a profiler trace of 10 calls), the bounds, and
    the sums over the resblocks of a bench call (12 in bf16, 9 in fp32).
    The kernels' row is stage 2 at k 11 (bf16), stage 3 at k 11 (fp32)."""
    from tts_tpu_torch.ops.bigvgan_stage import amp_block_fused, amp_block_fused_plain

    dt, tol = (torch.float32, TOL32) if f32 else (torch.bfloat16, TOL)
    name = "amp_block_fused_f32" if f32 else "amp_block_fused"
    label = "amp_block_fused fp32" if f32 else "amp_block_fused"
    stages = BV_STAGES[1:] if f32 else BV_STAGES
    r = res[name]
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    name_limit = card()
    for stage, c, t in stages:
        for k in BV_KS:
            args = amp_block_inputs(gen, 1, t, c, k, dt)
            kern = lambda: amp_block_fused(*args, k=k, dils=BV_DILS)
            plain = lambda: amp_block_fused_plain(*args, k=k, dils=BV_DILS)
            got = kern()
            ref = amp_block_fused_plain(*[a.float() for a in args], k=k, dils=BV_DILS)
            r["max_abs_err"] = max(r["max_abs_err"], check(
                f"{label} stage {stage} x=(1, {t}, {c}) k={k} dils={BV_DILS}", got, ref, tol))
            del got, ref
            one = {"ms": time_ms(kern), "plain_ms": time_ms(plain)}
            amp_block_bound(one, 1, t, c, k, dt)
            for key in tot:
                tot[key] += one[key]
            print(f"  {name_limit}: {label} stage {stage} (C {c}, T {t}) k={k}: kernel "
                  f"{one['ms']:.4f} ms, {'fp32' if f32 else 'bf16'} twin {one['plain_ms']:.4f} "
                  f"ms, bound {one['bound_ms']:.4f} ms ({one['bound_by']}) (CUDA events, median "
                  f"of 10)", flush=True)
            print_split(f"  {label} stage {stage} k={k}", kern)
            if (stage, k) == ((3, 11) if f32 else (2, 11)):
                r.update(one)
            del args
    for stage, c, t in (stages[0], stages[-1]):   # batch rows: a grid dimension
        args = amp_block_inputs(gen, 4, t // 4, c, 11, dt)
        r["max_abs_err"] = max(r["max_abs_err"], check(
            f"{label} stage {stage} x=(4, {t // 4}, {c}) k=11 dils={BV_DILS}",
            amp_block_fused(*args, k=11, dils=BV_DILS),
            amp_block_fused_plain(*[a.float() for a in args], k=11, dils=BV_DILS), tol))
        del args
    # its own generator: the checks above keep the inputs they had
    ragged = torch.Generator("cuda").manual_seed(1010 + f32)
    for stage, c, _ in stages:
        args = amp_block_inputs(ragged, 1, 16384 + 100, c, 11, dt)
        r["max_abs_err"] = max(r["max_abs_err"], check(
            f"{label} stage {stage} x=(1, {16384 + 100}, {c}) k=11 dils={BV_DILS} (ragged last "
            f"tile)", amp_block_fused(*args, k=11, dils=BV_DILS),
            amp_block_fused_plain(*[a.float() for a in args], k=11, dils=BV_DILS), tol))
        del args
    # x scaled so that the act's sine arguments pass SIN_MAX (8192): the
    # strips fall back to sinf
    big = torch.Generator("cuda").manual_seed(1012 + f32)
    stage, c, _ = stages[-1]
    args = amp_block_inputs(big, 1, 4096, c, 11, dt)
    args = ((args[0].float() * 8192).to(dt),) + args[1:]
    # (its absolute error scales with x: held to the same relative limits,
    # and left out of the kernel's max_abs_err)
    check(f"{label} stage {stage} x=(1, 4096, {c}) * 8192 k=11 dils={BV_DILS} (the act's sinf "
          f"path)", amp_block_fused(*args, k=11, dils=BV_DILS),
          amp_block_fused_plain(*[a.float() for a in args], k=11, dils=BV_DILS), tol)
    del args
    print(f"  {name_limit}: {label} over the {len(stages) * 3} resblocks of "
          f"{'an fp32' if f32 else 'a'} bench call: kernel {tot['ms']:.4f} ms, twin "
          f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms (sum of each "
          f"resblock's); library call: none", flush=True)


def time_amp_forms() -> None:
    """Kernel 10 in the row tiles its plan does not pick (every other one
    the C entry takes), the plan swapped for the call, at bf16 stage 2 (C
    192) and stage 5 (C 24) and fp32 stages 3 (C 96) and 5, k 11 and (stage
    5) k 3: each within TOL (bf16) or TOL32 (fp32) of the fp32 twin, CUDA
    events (median of 10) beside the plan's tile. Inputs from a generator of
    its own."""
    from tts_tpu_torch.ops import bigvgan_stage as k10

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1011)
    name_limit = card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dt, (stage, c, t), k in ((torch.bfloat16, BV_STAGES[0], 11),
                                 (torch.bfloat16, BV_STAGES[3], 11),
                                 (torch.bfloat16, BV_STAGES[3], 3),
                                 (torch.float32, BV_STAGES[1], 11),
                                 (torch.float32, BV_STAGES[3], 11)):
        tol = TOL32 if dt == torch.float32 else TOL
        args = amp_block_inputs(gen, 1, t, c, k, dt)
        ref = k10.amp_block_fused_plain(*[a.float() for a in args], k=k, dils=BV_DILS)
        plan = k10.amp_plan(c, k, BV_DILS, dt, t, 1, sms)
        times = []
        for tb in range(64, k10._MAX_TB + 1, 64):
            if not all(k10.amp_geometry(c, k, d, tb, dt).ok for d in BV_DILS):
                continue
            form = plan._replace(tb=tb)
            with swapped(k10, {"amp_plan": lambda *a, _f=form: _f}):
                check(f"amp_block_fused {dt} stage {stage} k={k}, row tile {tb}",
                      k10.amp_block_fused(*args, k=k, dils=BV_DILS), ref, tol)
                ms = time_ms(lambda: k10.amp_block_fused(*args, k=k, dils=BV_DILS))
                times.append(f"{tb}{' (plan)' if tb == plan.tb else ''} {ms:.4f}")
        print(f"  {name_limit}: amp_block_fused {dt} stage {stage} (C {c}, T {t}) k={k} by row "
              f"tile: " + ", ".join(times) + " ms (CUDA events, median of 10)", flush=True)
        del args, ref


def sdpa_ms(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, kv,
            heads: int = 16, device: bool = False, scale: float = 1.0) -> float:
    """Kernel 1's library yardstick: scaled_dot_product_attention on q, k
    roped ahead (as the twin ropes them) and v, keys >= kv masked (an int,
    or a (B,) tensor: a length a batch row), scale 1 (F5 folds it into
    wqkv) unless given; CUDA events around one call, or with `device` its
    kernels' device time a call. The port never calls it."""
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
    lens = torch.as_tensor(kv, device=qkv.device).reshape(-1, 1)
    mask = (torch.arange(t, device=qkv.device)[None, :] < lens)[:, None, None, :]
    timer = device_ms if device else time_ms
    return timer(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale))


def check_q8_kernels(gen: torch.Generator, res: dict) -> None:
    """Phase 2, kernels 6-9 at the F5 bench shapes (M = 2 x 1408 rows, D
    1024, qkv 3072, F 2048) against their fp32 twins on the same bf16
    activations and int8 weights; then kernels 6-9 on the same activations
    in fp32 (no new draws) against the twins, rel L2 within TOL32: where
    the kernel's fp32 LayerNorm or gelu rounds otherwise than the twin's,
    a value on a tie of v / xs takes the other int8 step, which moves one
    output by one step of x times one weight, under 2^-10 of max |ref| (so
    max |err| is held to TOL), and the rel L2 by far less. Kernels 6-9 get
    their weights stored K-major, as the pipeline lays them out; their
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
    # kernels 6-9 read their weights K-major, as quantize_dit lays them out
    # for the pipeline
    wqkv7, wo, w1, w2 = ((to_kmajor(q), s) for q, s in (wqkv, wo, w1, w2))

    def run(name, label, kernel, plain, args, ops):
        """Check kernel(*args) against plain on fp32 copies; time both at
        the first call."""
        f32 = [a.float() if a.is_floating_point() else a for a in args]
        got = kernel(*args)
        ref = plain(*f32)
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], check(f"{name} {label}", got, ref))
        if "ms" not in r:
            # device time of the int8 kernels (q8_rows, q8_wgmma*)
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
        quantized_matmul_plain, (x2, *wqkv7), 2 * m * d * n)
    res["quantized_matmul"]["max_abs_err"] = max(res["quantized_matmul"]["max_abs_err"], check(
        "quantized_matmul x=(2816, 1024) N=3072, fp32 activations",
        quantized_matmul(x2.float(), *wqkv7), quantized_matmul_plain(x2.float(), *wqkv7),
        TOL32, TOL))
    # torch._int_mm at the GEMMs' shapes, the s8 products alone (no row
    # quantization, no rescale): kernel 9's library call, and a yardstick
    # beside kernels 7 and 6 (no call computes either's function)
    ym = {shape: int_mm_ms(*shape) for shape in ((m, d, n), (m, d, d), (m, d, f), (m, f, d))}
    res["quantized_matmul"]["library_ms"] = ym[(m, d, n)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"  {card()}: ln_qkv_q8 bench shape (plan {q8_plan(m, n, d, sms)}): device time "
          f"{res['ln_qkv_q8']['ms']:.4f} ms, bound {res['ln_qkv_q8']['bound_ms']:.4f} ms; "
          f"yardstick torch._int_mm ({m}x{d} @ {d}x{n}) {ym[(m, d, n)]:.4f} ms device time",
          flush=True)
    k8_split = device_split(lambda: out_proj_residual_q8(*calls[1][4]))
    print(f"  {card()}: out_proj_residual_q8 bench shape (plan {q8_plan(m, d, d, sms)}): "
          f"device time {res['out_proj_residual_q8']['ms']:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in k8_split.items() if v) + "), bound "
          f"{res['out_proj_residual_q8']['bound_ms']:.4f} ms "
          f"({res['out_proj_residual_q8']['bound_by']}); yardstick torch._int_mm "
          f"({m}x{d} @ {d}x{d}) {ym[(m, d, d)]:.4f} ms device time", flush=True)
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


def kernel_split(fn, iters: int = 10) -> list:
    """Device time a call of fn() by CUDA kernel, from a torch.profiler trace
    of `iters` calls: [(kernel name without namespace, template arguments
    and parameters, launches a call, ms a call)]."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].split("::")[-1].split(" ")[-1] or e.key
        n, ms = split.get(name, (0, 0.0))
        split[name] = (n + e.count, ms + e.device_time_total / 1e3)
    return [(name, n / iters, ms / iters) for name, (n, ms) in split.items()]


def print_split(label: str, fn) -> None:
    """One line: fn()'s device time a call, by CUDA kernel, beside the sum (a
    trace that holds no kernel is taken again, up to three in all, as in
    device_ms)."""
    for _ in range(3):
        split = kernel_split(fn)
        if split:
            break
    parts = ", ".join(f"{name} {ms:.4f}" + (f" ({n:g}x)" if n != 1 else "")
                      for name, n, ms in split)
    print(f"  {label}: by launch {parts}; sum {sum(ms for _, _, ms in split):.4f} ms "
          f"(device time a call, profiler over 10 calls)", flush=True)


def trace_span_ms(fn, calls: int = 10) -> float:
    """Device time a call as a trace's span: from the first kernel's start
    to the last one's end over a chain of `calls` calls of fn() (behind a
    spinning kernel, as in chain_ms), over `calls`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(40_000_000)     # the profiler slows the host's enqueue
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and "spin" not in e.name]
    if not evs:
        return float("nan")
    return (max(e.time_range.end for e in evs) - min(e.time_range.start for e in evs)) \
        / 1e3 / calls


def time_q8_forms(gen: torch.Generator) -> None:
    """Kernels 7, 8 and 6 (its ff2; ff1 keeps its one cluster form) in
    each form of the bias / residual GEMM, q8_plan's choice swapped for the
    call, at the bench shape (where the plan takes 3 stages, 2 CTAs an SM)
    and at grids that fit one CTA an SM (where it takes 4 stages, 1 CTA an
    SM): kernels 6 and 8 at B 2 T 1024 (the bucket-1024 request: 128
    CTAs), kernel 6 at B 1 T 1088 (72) and B 2 T 512 (64), kernel 7 at B 2
    T 256 (96). Device time a call by kernel, and the output bitwise equal
    to the planned form's (a form changes no rounding)."""
    from tts_tpu_torch.ops import dit_mlp, quant_matmul
    from tts_tpu_torch.quant.weight_only import quantize_int8_eager

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def qw(*shape):
        w = quantize_int8_eager(rn(*shape, scale=0.02))
        return quant_matmul.to_kmajor(w.q), w.scale

    d, n, f = 1024, 3072, 2048
    wqkv, w1, w2, wo = qw(d, n), qw(d, f), qw(f, d), qw(d, d)
    cases = []
    for b, t in ((2, 1408), (2, 256)):
        cases.append(("ln_qkv_q8", quant_matmul, quant_matmul.ln_qkv_q8, b, t,
                      (rn(b, t, d), rn(2, d, scale=0.5), *wqkv, rn(n, scale=0.1))))
    for b, t in ((2, 1408), (2, 1024)):
        cases.append(("out_proj_residual_q8", quant_matmul, quant_matmul.out_proj_residual_q8,
                      b, t, (rn(b, t, d), *wo, rn(d, scale=0.1), rn(d, scale=0.5),
                             rn(b, t, d))))
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


def time_decode_forms(gen: torch.Generator) -> None:
    """Kernels 15 and 12 in other forms than their plans', the plan swapped
    for the call: kernel 15 at the Qwen talker shape (B 1 and 8) with its
    clusters (c1, c2, c3) at two CTAs an SM where 16 a cluster allow (16,
    6, 12) and at slices of 256 rows (8, 4, 6), where the plan's are 512
    (4, 2, 6), each output bitwise equal to the planned form's (a form
    changes no rounding); kernel 12 at the Qwen talker
    (pos 126) and Kani (pos 700) shapes at 1, 2, 4 and 8 CTAs a kv head,
    each within TOL of the fp32 twin. Device time a call by launch."""
    from tts_tpu_torch.nn.rope import rope_table
    from tts_tpu_torch.ops import decode_mlp, decode_step
    from tts_tpu_torch.ops.decode_mlp import Q8TailPlan
    from tts_tpu_torch.quant.weight_only import quantize_int8_jit

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    name_limit = card()
    wq = [quantize_int8_jit(rn(*s, scale=0.02)) for s in ((2048, 1024), (1024, 6144),
                                                          (3072, 1024))]
    forms = {"two CTAs an SM where 16 a cluster allow": Q8TailPlan(16, 128, 6, 176, 12, 256),
             "slices of 256 rows": Q8TailPlan(8, 256, 4, 256, 6, 512)}
    for b in (1, 8):
        x, att = rn(b, 1024), rn(b, 2048)
        want = decode_mlp.fused_out_mlp_q8(x, att, *wq)
        for label, form in forms.items():
            with swapped(decode_mlp, {"q8_tail_plan": lambda *a, _f=form: _f}):
                same = torch.equal(decode_mlp.fused_out_mlp_q8(x, att, *wq), want)
                print_split(f"{name_limit}: fused_out_mlp_q8 B {b}, {label} {tuple(form)}, "
                            f"output {'bitwise equal to' if same else 'DIFFERENT from'} the "
                            f"planned form's", lambda: decode_mlp.fused_out_mlp_q8(x, att, *wq))
            if not same:
                raise AssertionError("fused_out_mlp_q8: a form changed the output")

    for shape, hd, eps, t, pos in (("Qwen talker", 128, 1e-6, 640, 126),
                                   ("Kani", 64, 1e-5, 2048, 700)):
        w = rn(1024, 32 * hd, scale=0.02)
        nw = torch.full((hd,), hd ** -0.25, device="cuda").to(torch.bfloat16)
        cos, sin = (torch.as_tensor(a[pos:pos + 1], device="cuda").to(torch.bfloat16)
                    for a in rope_table(2048, hd, 1e6))
        kc, vc = rn(2, 1, 8, t, hd, scale=hd ** -0.25), rn(2, 1, 8, t, hd)
        x1 = rn(1, 1024)
        kw = dict(heads=16, kv_heads=8, head_dim=hd, q_norm=nw, k_norm=nw, eps=eps)
        ref = decode_step.fused_qkv_attn_plain(
            x1.float(), w.float(), cos.float(), sin.float(), kc.float(), vc.float(), 1, pos,
            **{k: v.float() if isinstance(v, torch.Tensor) else v for k, v in kw.items()})[0]
        for ctas in (1, 2, 4, 8):
            rows = -(-pos // ctas)
            with swapped(decode_step, {"step_plan": lambda p, d, _c=ctas, _r=rows: (_c, _r)}):
                check(f"fused_qkv_attn {shape} pos {pos}, {ctas} CTA(s) a kv head",
                      decode_step.fused_qkv_attn(x1, w, cos, sin, kc, vc, 1, pos, **kw)[0], ref)
                print_split(f"{name_limit}: fused_qkv_attn {shape} pos {pos}, {ctas} CTA(s) a "
                            f"kv head", lambda: decode_step.fused_qkv_attn(
                                x1, w, cos, sin, kc, vc, 1, pos, **kw))
    time_out_mlp_forms()


def time_out_mlp_forms() -> None:
    """Kernel 14 at the Qwen3-TTS talker shape (A 2048, H 1024, F 3072), B 1,
    3 and 8, bf16 and int8 weights, in its plan's form and in forms the
    plan does not pick, the plan swapped for the call: with programmatic
    dependent launch where the plan goes without and the other way round,
    and with slices short enough to give every SM a CTA (at least 64 rows),
    with and without it. Each within TOL of the
    fp32 twin, at most STEP_SLACK times the bf16 twin's rel L2 against fp32
    and bitwise equal over two calls; device time a call as CUDA events over
    a chain of 10 calls, as a trace's span, and by launch (the profiler's
    sum counts the launches' overlap twice). Inputs from a generator of its
    own."""
    from tts_tpu_torch.ops import _build, decode_mlp
    from tts_tpu_torch.ops.decode_mlp import OutMlpPlan
    from tts_tpu_torch.quant.weight_only import quantize_int8_jit

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1414)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    name_limit = card()
    a_dim, hs, ffn = 2048, 1024, 3072
    wb = (rn(a_dim, hs, scale=0.02), rn(hs, 2 * ffn, scale=0.02), rn(ffn, hs, scale=0.02))
    weights = {"bf16": wb, "int8": [quantize_int8_jit(m) for m in wb]}
    sms = _build.sm_count(torch.device("cuda", torch.cuda.current_device()))
    for wl, ws in weights.items():
        cols = 64 if wl == "bf16" else 128
        fill = [decode_mlp._fill(dim, tiles, sms, 64) for dim, tiles in (
            (a_dim, hs // cols), (hs, ffn // (cols // 2)), (ffn, hs // cols))]
        ws32 = ws if wl == "int8" else [m.float() for m in ws]
        for b in (1, 3, 8):
            plan = decode_mlp.out_mlp_plan(a_dim, hs, ffn, 1 if wl == "int8" else 2, sms, b)
            forms = {"the plan's": plan,
                     "with PDL" if not plan.pdl else "without PDL": plan._replace(
                         pdl=not plan.pdl),
                     "a CTA on every SM": OutMlpPlan(*fill[0], *fill[1], *fill[2], True),
                     "a CTA on every SM without PDL": OutMlpPlan(*fill[0], *fill[1],
                                                                 *fill[2], False)}
            x, att = rn(b, hs), rn(b, a_dim)
            ref = decode_mlp.fused_out_mlp_plain(x.float(), att.float(), *ws32, eps=1e-6)
            twin = decode_mlp.fused_out_mlp_plain(x, att, *ws, eps=1e-6)
            twin_rel = rel_l2(twin, ref)
            for label, form in forms.items():
                def call(_f=form):
                    with swapped(decode_mlp, {"out_mlp_plan": lambda *a, **k: _f}):
                        return decode_mlp.fused_out_mlp(x, att, *ws, eps=1e-6)

                got = call()
                check(f"fused_out_mlp B {b} {wl} weights, {label} form {tuple(form)}", got, ref)
                rel = rel_l2(got, ref)
                same = torch.equal(call(), got)
                print(f"  fused_out_mlp B {b} {wl}, {label}: rel L2 against fp32 {rel:.6g}, "
                      f"the bf16 twin's {twin_rel:.6g} (ratio {rel / twin_rel:.4f}, limit "
                      f"{STEP_SLACK}), a second call {'bitwise equal' if same else 'DIFFERENT'}",
                      flush=True)
                if rel > STEP_SLACK * twin_rel or not same:
                    raise AssertionError(f"fused_out_mlp {label}: error {rel} against the bf16 "
                                         f"twin's {twin_rel}, repeatable {same}")
                print(f"  {name_limit}: fused_out_mlp B {b} {wl} weights, {label} form: "
                      f"{chain_ms(call):.4f} ms a call (CUDA events over a chain of 10), trace "
                      f"span {trace_span_ms(call):.4f} ms a call", flush=True)
                print_split(f"  fused_out_mlp B {b} {wl}, {label}", call)


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
    """Phase 2, kernels 7, 8 and 6 past the bench shape, in bf16 and fp32
    activations against their fp32 twins (TOL; fp32 TOL32 rel L2 with max
    |err| TOL): a ragged M (B 2, T 1400: the last row tile 16 rows past the
    end), a half-empty last row tile (B 1, T 1088), kernel 8 at B 2 T 1024
    (128 CTAs: the 4-stage form), kernel 7 at D 576 (a last K step of 64
    values; N 1152) and kernel 6 at D 640, F 1152, whose ff1 takes the
    128-column cluster form (9 CTAs, past the portable 8). Device time by
    kernel and bound at each, with the plans."""
    from tts_tpu_torch.ops.dit_mlp import mlp_block_fused_q8, mlp_block_q8_plain
    from tts_tpu_torch.ops.quant_matmul import (ln_qkv_q8, ln_qkv_q8_plain,
                                                out_proj_residual_q8,
                                                out_proj_residual_q8_plain, q8_plan,
                                                to_kmajor)
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
            check_q8_call(res, name, kernel, plain, args, label, ops)
    # kernel 8: (B, T), HD = D = 1024
    for b, t in ((2, 1400), (1, 1088), (2, 1024)):
        m, d = b * t, 1024
        args = (rn(b, t, d), *qw(d, d), rn(d, scale=0.1), rn(d, scale=0.5), rn(b, t, d))
        check_q8_call(res, "out_proj_residual_q8", out_proj_residual_q8,
                      out_proj_residual_q8_plain, args,
                      f"o=({b}, {t}, {d}) D={d} (plan {q8_plan(m, d, d, sms)})", 2 * m * d * d)


def check_q8_call(res: dict, name: str, kernel, plain, args: tuple, label: str,
                  ops: int) -> None:
    """One W8A8 kernel call against its fp32 twin in bf16 and in fp32
    activations (TOL; fp32 TOL32 rel L2 with max |err| TOL); device time by
    kernel and the bound."""
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
    print(f"  {name} {label}: device time {sum(split.values()):.4f} "
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


def check_bf16_forward(pipe, t: int, kv, label: str, rows: int = 1, step=3) -> dict:
    """One bf16 DiT forward at T frames through the kernels the routes pick
    on the card, and through their twins in bf16 and in fp32, on the same
    weights (int8 where the pipeline quantized them). As check_step for
    Kani: the kernel route's error against fp32 at most STEP_SLACK times
    the bf16 twin route's (22 blocks of bf16 rounding move the output by
    more than 2^-6 on either route). Returns the launches of the kernel
    run. The W8A8 bench bucket (1408 frames, keys masked at 1396) runs
    kernels 1, 2, 6, 7 and 8; bf16 at T 4608 runs kernel 5. `rows`
    requests make a CFG batch of 2 x rows (kv a (2 x rows,) tensor);
    `step` an int or a (rows,) step vector on the card."""
    from tts_tpu_torch.models.f5 import dit_forward, f5_rope_tables
    from tts_tpu_torch.ops._build import LAUNCHES

    cfg, params = pipe.cfg, pipe.params

    gen = torch.Generator("cuda").manual_seed(5)
    noise = torch.randn((rows, t, cfg.n_mels), generator=gen, device="cuda")
    cond = torch.randn((rows, t, cfg.n_mels + cfg.text_dim), generator=gen, device="cuda")
    drop = torch.randn((rows, t, cfg.n_mels + cfg.text_dim), generator=gen, device="cuda")
    if t <= params["rope_cos"].shape[0]:
        cos, sin = params["rope_cos"][:t].float(), params["rope_sin"][:t].float()
    else:   # past the pipeline's tables: the same tables, as long as T
        cos, sin = (torch.tensor(a, device="cuda").to(params["rope_cos"].dtype).float()
                    for a in f5_rope_tables(t, cfg.head_dim))

    def fwd(p, dt):
        a, b = dit_forward(p, noise.to(dt), cond.to(dt), drop.to(dt), cos, sin, cfg,
                           kv_len=kv, step_idx=step)
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
    step_l = step if isinstance(step, int) else tuple(step.tolist())
    print(f"  {label} dit_forward ({rows} x {t} frames, kv_len {kv_l}, step {step_l}), rel "
          f"L2 against the fp32 twin route: kernels {e_k:.6g}, bf16 twins {e_p:.6g} (limit "
          f"{STEP_SLACK} x); kernels against bf16 twins {rel(kern, plain):.6g}, launches "
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


# phase 5d's requests and the F5 slot server's: the bench reference (6 s,
# REF_TEXT) with generated texts of 69-74 bytes, each in the bench request's
# frame bucket (1408), text bucket (128) and generated-span bucket (832), so
# a request's solo run takes the buckets of its batch row or slot
F5_TEXTS = ("word " * 13 + "word", "word " * 13 + "words", "word " * 14 + "wo",
            " ".join(["word"] * 15), "word " * 14 + "w", "word " * 13 + "wordiest")
F5_SEED = 17
# the generated-span bucket of every F5_TEXTS request
F5_GEN = 832


def bench_audio(rate: int) -> np.ndarray:
    """The bench request's reference: 6 s of noise as int16 PCM."""
    return (np.random.default_rng(0).standard_normal(int(6.0 * rate)) * 3000).astype(np.int16)


def wav_diff(got: np.ndarray, ref: np.ndarray) -> tuple:
    """(rel L2 of got - ref over ref, max |got - ref| in int16 LSB) of two
    waveforms of one length."""
    if got.shape != ref.shape:
        raise AssertionError(f"waveforms of {got.shape} and {ref.shape} samples")
    a, b = got.astype(np.float64), ref.astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b)), int(np.abs(a - b).max())


def rows_against_solo(pipe, reqs: list, outs: list, noise: np.ndarray) -> tuple:
    """Each request's solo synthesize with its row of `noise` (the draw its
    batch row or slot took), against that row's output `outs[b]`. Returns
    ([(rel L2, max LSB)], solo walls s, solo samples)."""
    diffs, walls, n = [], [], 0
    for b, r in enumerate(reqs):
        torch.cuda.synchronize()
        solo, st = pipe.synthesize(*r, noise=noise[b:b + 1])
        diffs.append(wav_diff(outs[b], solo))
        walls.append(st.wall_s)
        n += len(solo)
    return diffs, walls, n


def f5_draw(seed: int, rows: int, frames: int, n_mels: int) -> np.ndarray:
    """The pipeline's start noise for `seed`: one (rows, frames, n_mels)
    draw from a generator on the card."""
    gen = torch.Generator("cuda").manual_seed(seed)
    return torch.randn((rows, frames, n_mels), generator=gen, device="cuda").cpu().numpy()


# a row's difference from its solo run (rel L2 of the int16 waveforms)
# through the kernels may be this much larger than through the twins on the
# same requests: bf16 rounding at other points, as STEP_SLACK
ROW_SLACK = STEP_SLACK


def check_rows(label: str, diffs: list, twin: list) -> None:
    """The kernels' row-vs-solo differences against the twins' on the same
    requests: the largest at most ROW_SLACK times the twins' largest."""
    worst, bound = max(d[0] for d in diffs), ROW_SLACK * max(d[0] for d in twin)
    ok = worst <= bound
    print(f"  {label}: each row against its solo run (rel L2, max LSB): kernels "
          f"{[(round(r, 6), n) for r, n in diffs]}, twins "
          f"{[(round(r, 6), n) for r, n in twin]}; bound {ROW_SLACK} x the twins' largest "
          f"= {bound:.6g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: a row differs from its solo run by more than the "
                             f"twins' rows do")


@torch.no_grad()
def run_f5_many(pipe, q8, name_limit: str) -> dict:
    """Phase 5d: F5's many-request paths at full F5TTS_v1_Base width over
    phase 3's bf16 and phase 5's W8A8 pipelines. synthesize_batch of 4
    requests (a CFG batch of 8 rows, M 11,264) in bf16 (682 launches each of
    kernels 1 and 3, 31 of kernel 2) and W8A8 (682 each of kernels 1, 6, 7,
    8; 31 of 2); each row against its solo synthesize with the row's draw,
    beside the same through the twins (`check_rows`); aggregate RTF beside
    the solo runs'. One DiT forward of the 4 requests with a step vector
    (bf16: kernels 1, 2, 3; W8A8: 1, 2, 6, none of 7 and 8) and one W8A8
    forward at one step (7, 1, 8, 6) against the fp32 twins. The bench
    request at layer_cache_interval=2 (352 launches of kernel 1, 31 of 2,
    none of 3), device time beside the exact request's. Returns the
    launches."""
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.f5 import F5Pipeline

    cfg = pipe.cfg
    depth, steps = cfg.depth, cfg.nfe_steps - 1
    audio = bench_audio(cfg.sample_rate)
    reqs = [(audio, REF_TEXT, t) for t in F5_TEXTS[:4]]
    launches: dict = {}

    def count(grew):
        for k, n in grew.items():
            launches[k] = launches.get(k, 0) + n

    frames = pipe._prepare_batch(reqs)[5]
    noise = f5_draw(F5_SEED, len(reqs), frames, cfg.n_mels)
    for label, p, want in (
            ("bf16", pipe, {"flash_attention_flat": depth * steps, "conv_pos_embed_fused": steps,
                            "mlp_block_fused": depth * steps}),
            ("W8A8", q8, {"flash_attention_flat": depth * steps, "conv_pos_embed_fused": steps,
                          **dict.fromkeys(Q8_KERNELS, depth * steps)})):
        p.synthesize_batch(reqs, seed=1)                  # warm-up
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        outs, st = p.synthesize_batch(reqs, seed=F5_SEED)
        grew = serve_grew(before, KERNELS)
        serve_expect(f"{label} synthesize_batch of 4", grew, want)
        count(grew)
        lens = [min(g, F5_GEN - 1) * cfg.hop for g in p._prepare_batch(reqs)[4]]
        if [len(o) for o in outs] != lens or not math.isfinite(st.peak) or \
                not all(o.any() for o in outs):
            raise AssertionError(f"{label} batch: {[len(o) for o in outs]} samples (expected "
                                 f"{lens}), peak {st.peak}")
        diffs, walls, n_solo = rows_against_solo(p, reqs, outs, noise)
        with twins_in_dit():
            touts, _ = p.synthesize_batch(reqs, seed=F5_SEED)
            tdiffs = rows_against_solo(p, reqs, touts, noise)[0]
        check_rows(f"{label} synthesize_batch of 4", diffs, tdiffs)
        rtf_b, rtf_s = st.wall_s / st.audio_s, sum(walls) / (n_solo / cfg.sample_rate)
        print(f"  {name_limit}: {label} synthesize_batch of 4 (M {2 * len(reqs) * frames}): "
              f"wall {st.wall_s:.4f} s for {st.audio_s:.3f} s of audio, aggregate RTF "
              f"{rtf_b:.6f}; the 4 solo runs {sum(walls):.4f} s in all, RTF {rtf_s:.6f}; "
              f"{rtf_s / rtf_b:.2f}x the solo rate; each row's wait {st.wall_s:.4f} s "
              f"against a solo run's {statistics.mean(walls):.4f} s "
              f"({st.wall_s / statistics.mean(walls):.2f}x); peak |wav| {st.peak:.6g}; "
              f"launches {grew}", flush=True)
        print("  " + json.dumps({"f5_batch": label, "card": name_limit, "rows": len(reqs),
                                 "wall_s": st.wall_s, "audio_s": st.audio_s,
                                 "rtf": rtf_b, "solo_rtf": rtf_s,
                                 "solo_wall_s": walls, "row_vs_solo": diffs,
                                 "twin_row_vs_solo": tdiffs}), flush=True)

    durs = pipe._prepare_batch(reqs)[3]
    kv = torch.tensor(durs * 2, dtype=torch.int32, device="cuda")
    # the 4 requests at steps 0, 10, 20, 30 (each at its own)
    tvec = torch.tensor([i * (steps - 1) // 3 for i in range(4)], dtype=torch.int32,
                        device="cuda")
    for label, p, step, want in (
            ("bf16 step vector", pipe, tvec, ("flash_attention_flat", "mlp_block_fused")),
            ("W8A8 step vector", q8, tvec, ("flash_attention_flat", "mlp_block_fused_q8")),
            ("W8A8 batch", q8, 3, ("flash_attention_flat",) + Q8_KERNELS)):
        grew = check_bf16_forward(p, frames, kv, label, rows=len(reqs), step=step)
        serve_expect(f"{label} dit_forward", grew,
                     {**dict.fromkeys(want, depth), "conv_pos_embed_fused": 1})
        count(grew)

    fora = F5Pipeline(pipe.f5, pipe.vocab, pipe.vocos, layer_cache_interval=2)
    fora.synthesize(audio, REF_TEXT, "word word")         # warm-up
    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    wav, st = fora.synthesize(audio, REF_TEXT, F5_TEXTS[3])
    grew = serve_grew(before, KERNELS)
    full = len(range(0, steps, 2))
    serve_expect("layer_cache_interval=2 bench request", grew,
                 {"flash_attention_flat": depth * full, "conv_pos_embed_fused": steps})
    count(grew)
    if len(wav) != BENCH_SAMPLES or not math.isfinite(st.peak) or not wav.any():
        raise AssertionError(f"layer_cache_interval=2: {len(wav)} samples, peak {st.peak}")
    exact, st_e = pipe.synthesize(audio, REF_TEXT, F5_TEXTS[3])
    rel, lsb = wav_diff(wav, exact)
    print(f"  {name_limit}: layer_cache_interval=2 bench request: {full} full steps of "
          f"{steps}, launches {grew}; wall {st.wall_s:.4f} s (RTF {st.rtf:.6f}) against the "
          f"exact request's {st_e.wall_s:.4f} s (RTF {st_e.rtf:.6f}); its audio against the "
          f"exact request's: rel L2 {rel:.6g}, max {lsb} LSB (the cache's approximation, "
          f"reported)", flush=True)
    for label, p in (("exact", pipe), ("layer_cache_interval=2", fora)):
        profile_one(f"F5 bf16 bench request, {label}",
                    lambda p=p: p.synthesize(audio, REF_TEXT, F5_TEXTS[3]), F5_CLASSES,
                    name_limit)
    return launches


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


# the F5 kernels' device-time classes (kernel name patterns)
F5_CLASSES = (("kernel 1 (rope_qk_kernel + flash_flat_kernel)", ("rope_qk", "flash_flat")),
              ("kernel 4 bf16 (mha_fixed_kernel)", ("mha_fixed",)),
              ("kernel 5 bf16 (mha_online_kernel)", ("mha_online",)),
              ("kernels 4-5 fp32 (mha_f32_kernel)", ("mha_f32",)),
              ("kernel 2 (pos_embed_mish_kernel)", ("pos_embed_mish",)),
              ("kernel 3 (ln_mod_kernel + dit_gemm_kernel)", ("ln_mod_kernel",
                                                               "dit_gemm_kernel")),
              ("kernels 6-8: q8_rows", ("q8_rows",)),
              ("kernels 6-8: q8_wgmma (s8 wgmma GEMMs)", ("q8_wgmma",)),
              ("cuBLAS / GEMM", ("nvjet", "gemv", "gemm", "cutlass", "sm90_xmma")))


def profile_f5(pipes: dict, name_limit: str) -> None:
    """torch.profiler over one bench request of each F5 pipeline: device
    kernel time by kernel, and the device's idle share (1 - kernel time /
    wall); in a W8A8 request the s8 wgmma GEMMs split by kernel
    (`q8_gemm_split`). No request may launch kernel 9 (`quantized_matmul`,
    whose GEMM is the same q8_wgmma_kernel as kernels 7's and 8's: its
    wrapper's count in _build.LAUNCHES must not move over the request)."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from tts_tpu_torch.ops import _build

    rate = next(iter(pipes.values())).cfg.sample_rate
    audio = (np.random.default_rng(0).standard_normal(int(6.0 * rate)) * 3000).astype(np.int16)
    text = " ".join(["word"] * 15)
    classes = F5_CLASSES
    for label, pipe in pipes.items():
        pipe.synthesize(audio, REF_TEXT, text)
        torch.cuda.synchronize()
        k9 = _build.LAUNCHES["quantized_matmul"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.synthesize(audio, REF_TEXT, text)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        k9 = _build.LAUNCHES["quantized_matmul"] - k9
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
        split = q8_gemm_split(prof)
        if split:
            print("    s8 wgmma GEMMs by kernel (launch order): " + ", ".join(
                f"{k} {ms:.3f} ms" for k, ms in split.items()))
        for key, count, ms in sorted(rows, key=lambda r: -r[2])[:12]:
            print(f"    kernel {ms:9.3f} ms {count:6d}x  {key[:110]}")
        if k9:
            raise AssertionError(f"F5 {label}: the request launched kernel 9 {k9} times")
        del prof, rows
        gc.collect()


def q8_gemm_split(prof) -> dict:
    """The device time of a W8A8 request's s8 wgmma GEMMs by kernel, from
    their launch order in the trace: every DiT block launches
    q8_wgmma_kernel for kernel 7, q8_wgmma_kernel for kernel 8, then
    q8_wgmma_hidden_kernel (kernel 6's ff1) and q8_wgmma_kernel (kernel 6's
    ff2), one template for three GEMMs. {} where the trace holds no such
    launches; AssertionError where they break that order."""
    parts = ("kernel 7", "kernel 8", "kernel 6 ff1", "kernel 6 ff2")
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "q8_wgmma" in e.name),
                 key=lambda e: e.time_range.start)
    if not evs:
        return {}
    if len(evs) % 4 or any(("hidden" in e.name) != (i % 4 == 2) for i, e in enumerate(evs)):
        raise AssertionError("the s8 wgmma GEMMs ran out of the block's order")
    split = dict.fromkeys(parts, 0.0)
    for i, e in enumerate(evs):
        split[parts[i % 4]] += e.device_time_total / 1e3
    return split


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
    classes = (("kernel 12 attention (step_attn_kernel)", ("attn_kernel",)),
               ("qkv head (kernel 11; kernel 12's first launch)", ("qkv_head",)),
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
    bf16, int8, bf16 "all" and int8 "mlp_q8" pipelines."""
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
    mlp_q8 = QwenTTSPipeline(q8, cfg, cparams, ccfg, dec(fused_decode="mlp_q8"))
    for label, pipe, cap, per in (
            ('fused_decode="all" bf16, max_frames 128', fused_all,
             128, {"fused_qkv_rope": per_iter, "decode_gqa_attention": per_iter,
                   "fused_out_mlp": per_iter}),
            ('fused_decode="mlp_q8" int8', mlp_q8,
             QWEN_FRAMES, {"fused_qkv_rope": per_iter, "fused_out_mlp_q8": per_iter})):
        st, wall, grew = checked(label, single(pipe), cap, per)
        print(f"  {name_limit}: Qwen {label}: {st['frames'] / wall:.2f} frames/s, RTF "
              f"{wall / (st['frames'] / 12.0):.6f} (first call)", flush=True)
        launches.update({k: grew[k] for k in ("decode_gqa_attention", "fused_out_mlp",
                                               "fused_out_mlp_q8") if grew[k]})
    check_qwen_step(cfg, params, {"talker": q8["talker"]})
    return launches, {**pipes, "bf16 fused_decode=all (max_frames 128)": fused_all,
                      "int8 fused_decode=mlp_q8": mlp_q8}


def profile_qwen(pipes: dict, out_dir: str, name_limit: str) -> None:
    """torch.profiler over one bench request of each pipeline (bf16 and int8
    on the default route, bf16 on "all", int8 on "mlp_q8"): device time by
    kernel class, the
    device's idle share (1 - kernel time / wall), launches a frame, host
    time by op; tables into out_dir."""
    import gc
    import os

    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    classes = (("kernel 12 attention (step_attn_kernel)", ("attn_kernel",)),
               ("qkv head (kernel 11; kernel 12's first launch)", ("qkv_head",)),
               ("kernel 13", ("cluster_kernel",)),
               ("kernel 15 (q8_oproj / q8_gateup / q8_down)", ("q8_",)),
               ("kernel 14", ("oproj_kernel", "gateup_kernel", "down_kernel")),
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
        name = tag.split()[0] + ("_all" if "=all" in tag else "_mlp_q8" if "mlp_q8" in tag
                                 else "")
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
    launch counts of the bf16 request, the bf16 pipeline and reference, and
    the arguments the bf16 request's vocoder call took."""
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
    return launches, pipes["bf16"], ref, vocoded[0]


# the JAX benchmark's VoxCPM request (benchmarks/families.py:264-291): 16
# prompt ids, 32 target ids, 48 latents (min_latents = max_latents, so a
# random stop head cannot end it early)
VOX_PROMPT = np.arange(5, 21, dtype=np.int32)[None]
VOX_TARGET = np.arange(21, 53, dtype=np.int32)[None]
VOX_LATENTS = 48


def voxcpm_models(cfg, seed: int) -> tuple:
    """VoxCPM params and VAE at full width in bf16, random from `seed` (the
    LM, feature encoder and estimator at tts_tpu's init scales), each VAE
    conv rescaled from N(0, 0.1^2) to gain / sqrt(k C_in) as bigvgan_weights
    does: 1 (sqrt(rate) for the transposed convs), 0.5 in the residual
    units, 0.3 for the last, so the waveform stays off zero and mostly off
    tanh's rails."""
    from tts_tpu_torch.models.voxcpm import init_params, init_vae_params

    bf = torch.bfloat16
    params = init_params(cfg, torch.Generator("cuda").manual_seed(seed), bf)
    vae = init_vae_params(cfg.vae, torch.Generator("cuda").manual_seed(seed + 1), bf)

    def rescale(conv, gain):
        k, cin, _ = conv["w"].shape
        conv["w"].mul_(gain / (0.1 * math.sqrt(k * cin)))

    def units(blk):
        for u in blk["units"]:
            rescale(u["c1"], 0.5)
            rescale(u["c2"], 0.5)

    for key in ("pre", "fc_mu"):
        rescale(vae[key], 1.0)
    for blk in vae["enc_blocks"]:
        units(blk)
        rescale(blk["down"], 1.0)
    dec = vae["dec"]
    for key in ("pre_dw", "pre"):
        if key in dec:
            rescale(dec[key], 1.0)
    rates = cfg.vae.decoder_rates or tuple(reversed(cfg.vae.strides))
    for blk, rate in zip(dec["dec_blocks"], rates):
        rescale(blk["up"], math.sqrt(rate))
        units(blk)
    rescale(dec["post"], 0.3)
    return params, vae


def check_voxcpm_step(pipe) -> None:
    """One dual-LM decode step (24 base and 4 residual layers) after the
    bench request's prefill, at full width in bf16: the "step" route
    through kernel 12 (28 launches) against the same route through the
    kernels' twins in bf16 and in fp32 (params and caches cast). The
    kernel's dit_hidden is no further from the fp32 twins' than
    STEP_SLACK times the bf16 twins', as check_index_step holds IndexTTS's;
    the plain route's error is printed beside them."""
    import tts_tpu_torch.models.voxcpm as vm
    from tts_tpu_torch.kv.cache import KVCache
    from tts_tpu_torch.ops import _build
    from tts_tpu_torch.ops.decode_qkv import fused_qkv_rope_plain
    from tts_tpu_torch.ops.decode_step import fused_qkv_attn_plain

    cfg, p = pipe.cfg, pipe.params
    ids = np.concatenate([VOX_PROMPT[0], VOX_TARGET[0], [cfg.audio_start_id]])
    n = len(ids)
    text = torch.zeros((1, 64), dtype=torch.long, device="cuda")
    text[0, :n] = torch.as_tensor(ids, device="cuda")
    is_audio = torch.zeros((64,), dtype=torch.bool, device="cuda")
    fe = torch.zeros((1, 64, cfg.base.hidden_size), dtype=torch.bfloat16, device="cuda")
    bk, rk = pipe._caches(1, 128)
    dit, _, bk, rk = vm.voxcpm_main_step(p, p["embed"][text], fe, is_audio, bk, rk, cfg,
                                         valid_len=n)
    bk, rk = bk.rewind(n), rk.rewind(n)
    noise = torch.randn((1, cfg.patch_size, cfg.vae.latent_dim),
                        generator=torch.Generator("cuda").manual_seed(7), device="cuda")
    latent = vm.cfm_feat_decoder(p, noise, dit, pipe._zero_cond(), cfg)
    h = vm.feat_encoder_cond(p, latent.to(torch.bfloat16), cfg)[0]

    def step(params, dt, route):
        def c(kv):
            return KVCache(kv.k.to(dt).clone(), kv.v.to(dt).clone(), kv.length)
        return vm.voxcpm_main_step(params, h.to(dt), h.to(dt), 0, c(bk), c(rk), cfg,
                                   fused=route)[0].float()

    before = _build.LAUNCHES["fused_qkv_attn"]
    kern = step(p, torch.bfloat16, "step")
    k12 = _build.LAUNCHES["fused_qkv_attn"] - before
    twins = {"fused_qkv_attn": fused_qkv_attn_plain, "fused_qkv_rope": fused_qkv_rope_plain}
    with swapped(vm, twins):
        twin = step(p, torch.bfloat16, "step")
        ref = step(cast_tree(p, torch.float32), torch.float32, "step")
    plain = step(p, torch.bfloat16, False)
    e_k, e_t, e_p = rel_l2(kern, ref), rel_l2(twin, ref), rel_l2(plain, ref)
    layers = cfg.base.num_layers + cfg.residual.num_layers
    ok = bool(torch.isfinite(kern).all()) and e_k <= STEP_SLACK * e_t and k12 == layers
    print(f"  VoxCPM dual-LM step dit_hidden ({layers} layers, pos {n}), rel L2 against the "
          f"fp32 twins: kernel 12 {e_k:.6g} ({k12} launches), the bf16 twins {e_t:.6g} (limit "
          f"{STEP_SLACK} x), the plain route {e_p:.6g}; kernel against bf16 twins "
          f"{rel_l2(kern, twin):.6g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the kernel-12 VoxCPM step is less accurate than its twins' "
                             "or did not run through kernel 12")


def run_voxcpm(name_limit: str) -> tuple:
    """Phase 10: VoxCPMPipeline at full width. VoxCPM-2 (voxcpm_v2_config():
    LM 24 + 4 layers x 1024, 16/2 heads x 64; feature encoder 3 x 512;
    estimator 6 x 512; VAE decoder 2048 channels at rates (8, 8, 6, 5), 48
    kHz) bf16 and int8 on the bench request, and synthesize_v2
    "continuation" on a 6 s synthetic prompt at 16 kHz: 1,344 launches of
    kernel 12 a request, none of kernel 11; VoxCPM-1.5 (VoxCPMConfig(),
    1536 decoder channels, 44.1 kHz) synthesize_ids_batch over 8 requests:
    1,344 of kernel 11, none of kernel 12; one decode step against fp32.
    Returns (the launch counts of the phase, the bf16 VoxCPM-2 pipeline)."""
    from tts_tpu_torch.models.voxcpm import VoxCPMConfig, voxcpm_v2_config
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.voxcpm import VoxCPMDecodeConfig, VoxCPMPipeline

    cfg2, cfg15 = voxcpm_v2_config(), VoxCPMConfig()
    dec = VoxCPMDecodeConfig(max_latents=VOX_LATENTS, min_latents=VOX_LATENTS)
    t0 = time.perf_counter()
    params2, vae2 = voxcpm_models(cfg2, 30)
    params15, vae15 = voxcpm_models(cfg15, 40)
    torch.cuda.synchronize()
    b, est = cfg2.base, cfg2.estimator
    print(f"  models: base {b.num_layers} x {b.hidden_size}, residual "
          f"{cfg2.residual.num_layers}, {b.num_heads}/{b.num_kv_heads} heads x {b.head_dim}, "
          f"ffn {b.ffn_dim}; feature encoder {cfg2.feat_encoder.num_layers} x "
          f"{cfg2.feat_encoder.hidden_size}; estimator {est.num_layers} x {est.hidden_size}, "
          f"{cfg2.cfm_steps} CFM steps; VAE decoder {cfg2.vae.decoder_channels} (v2, "
          f"{cfg2.output_sample_rate} Hz) and {cfg15.vae.decoder_channels} (1.5, "
          f"{cfg15.output_sample_rate} Hz) channels; bf16, random init in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    pipes = {"VoxCPM-2 bf16": VoxCPMPipeline(params2, cfg2, vae2, dec),
             "VoxCPM-2 int8": VoxCPMPipeline(params2, cfg2, vae2, dec, quantize=8)}
    pipe15 = VoxCPMPipeline(params15, cfg15, vae15, dec)
    rate = cfg2.sample_rate
    tt = np.arange(6 * rate) / rate
    rng = np.random.default_rng(16)
    sig = (0.3 * np.sin(2 * np.pi * 220 * tt) * (1 + np.sin(2 * np.pi * 3 * tt))
           + 0.1 * np.sin(2 * np.pi * 330 * tt) + 0.05 * rng.standard_normal(tt.size))
    prompt_audio = (sig * 12000).astype(np.int16)
    layers = b.num_layers + cfg2.residual.num_layers
    names = ("fused_qkv_rope", "fused_qkv_attn")
    batch = [(VOX_PROMPT, np.arange(21, 53 + 2 * i, dtype=np.int32)[None]) for i in range(8)]

    def checked(label, fn, cfg, rows, kernel):
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        wavs = fn()
        wall = time.perf_counter() - t
        grew = {k: LAUNCHES[k] - before.get(k, 0) for k in names}
        spl = cfg.samples_per_latent
        audio_s = sum(len(w) for w in wavs) / cfg.output_sample_rate
        latents = VOX_LATENTS * rows
        print(f"  {name_limit}: {label}: {latents} latents, {[len(w) for w in wavs]} int16 "
              f"samples, wall {wall:.4f} s, {latents / wall:.2f} latents/s, RTF "
              f"{wall / audio_s:.6f}, launches {grew}", flush=True)
        print("  " + json.dumps({"voxcpm": label, "latents": latents, "wall_s": wall,
                                 "latents_per_s": latents / wall, "rtf": wall / audio_s}),
              flush=True)
        want = {k: layers * VOX_LATENTS if k == kernel else 0 for k in names}
        if grew != want:
            raise AssertionError(f"{label}: launches {grew}, expected {want}")
        for w in wavs:
            if w.dtype != np.int16 or len(w) != VOX_LATENTS * spl or not w.any():
                raise AssertionError(f"{label}: {len(w)} {w.dtype} samples, expected "
                                     f"{VOX_LATENTS * spl} int16, not all zero")
        return grew

    def single(pipe):
        return lambda: [pipe.synthesize_ids(VOX_PROMPT, VOX_TARGET)[0]]

    def continuation():
        return [pipes["VoxCPM-2 bf16"].synthesize_v2(
            "continuation", VOX_TARGET, prompt_audio=prompt_audio, prompt_ids=VOX_PROMPT)[0]]

    for pipe in pipes.values():                     # warm-up
        pipe.synthesize_ids(VOX_PROMPT, VOX_TARGET)
    pipe15.synthesize_ids_batch(batch)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    launches = dict.fromkeys(names, 0)
    runs = [("VoxCPM-2 bf16 request", single(pipes["VoxCPM-2 bf16"]), cfg2, 1,
             "fused_qkv_attn"),
            ("VoxCPM-2 int8 request", single(pipes["VoxCPM-2 int8"]), cfg2, 1,
             "fused_qkv_attn"),
            ('VoxCPM-2 synthesize_v2("continuation"), 6 s prompt at 16 kHz', continuation,
             cfg2, 1, "fused_qkv_attn"),
            ("VoxCPM-1.5 batch of 8 (bf16)", lambda: pipe15.synthesize_ids_batch(batch)[0],
             cfg15, 8, "fused_qkv_rope")]
    for run in runs:
        for k, v in checked(*run).items():
            launches[k] += v
    del pipe15, params15, vae15
    check_voxcpm_step(pipes["VoxCPM-2 bf16"])
    return launches, pipes["VoxCPM-2 bf16"]


# ----------------------------------------------------------------------------
# Phase 11: the serving layer (tts_tpu_torch/serving), continuous batching

SERVE_SLOTS = 4
SERVE_WAIT_S = 600        # every Future.result bound of phase 11


def sync_free(srv) -> None:
    """Run every chunk of `srv` under torch's sync debug mode "error": a
    host read of the card inside a chunk (an .item(), a host copy, a
    blocking copy to the card) raises on the worker thread, which fails the
    server's requests and so the phase."""
    real = srv._step_chunk

    def chunk(s):
        torch.cuda.set_sync_debug_mode("error")
        try:
            real(s)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    srv._step_chunk = chunk


def time_parts(srv) -> dict:
    """Host seconds the worker spends in each part, summed into the dict
    returned: "chunk" (enqueueing a chunk's steps), "wait" (the boundary's
    read of the flags: the card finishing the chunk), "admit" (a row's
    prefill and splice), "finalize" (a row's vocoder call and copy)."""
    parts: dict = {}
    for name, attr in (("chunk", "_step_chunk"), ("wait", "_fin_done"),
                       ("admit", "_admit_row"), ("finalize", "_finalize")):
        real = getattr(srv, attr)

        def timed(*a, real=real, name=name):
            t0 = time.perf_counter()
            try:
                return real(*a)
            finally:
                parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
                parts[name + "_n"] = parts.get(name + "_n", 0) + 1

        setattr(srv, attr, timed)
    return parts


def parts_line(parts: dict, wall: float) -> str:
    return ", ".join(f"{k} {parts.get(k, 0.0):.3f} s ({parts.get(k + '_n', 0)}x)"
                     for k in ("chunk", "wait", "admit", "finalize")) + \
        f" of {wall:.3f} s"


def codes_by_future(srv, key: str) -> dict:
    """Record each finished row's codes (s[key][row, :n], on the host) by
    its future."""
    got = {}
    real = srv._finalize

    def finalize(s, b, n):
        got[s["reqs"][b].fut] = s[key][b, :n].cpu()
        return real(s, b, n)

    srv._finalize = finalize
    return got


def serve_staggered(srv, first: list, later: list) -> tuple:
    """Submit `first` (callables returning futures), wait for the first
    chunk, submit `later`: they queue behind busy rows and are admitted
    mid-decode. Returns (futures, completion times, results)."""
    futs, done = [], {}

    def track(f):
        i = len(futs)
        f.add_done_callback(lambda _f: done.__setitem__(i, time.perf_counter()))
        futs.append(f)

    for sub in first:
        track(sub())
    t0 = time.perf_counter()
    while srv.stats.chunks < 1:
        if futs[0].done() or time.perf_counter() - t0 > SERVE_WAIT_S:
            futs[0].result(timeout=0)
            raise AssertionError("the slot server never finished a chunk")
        time.sleep(0.002)
    for sub in later:
        track(sub())
    return futs, done, [f.result(timeout=SERVE_WAIT_S) for f in futs]


def serve_rate(subs: list, parts: dict) -> tuple:
    """Submit every request at once (all rows busy). Returns (results, wall
    s, the worker's time by part in this run)."""
    torch.cuda.synchronize()
    parts.clear()
    t0 = time.perf_counter()
    futs = [sub() for sub in subs]
    out = [f.result(timeout=SERVE_WAIT_S) for f in futs]
    return out, time.perf_counter() - t0, dict(parts)


def serve_grew(before: dict, names) -> dict:
    from tts_tpu_torch.ops._build import LAUNCHES

    return {k: LAUNCHES[k] - before.get(k, 0) for k in names}


def serve_expect(label: str, grew: dict, want: dict) -> None:
    full = {k: want.get(k, 0) for k in grew}
    if grew != full:
        raise AssertionError(f"{label}: launches {grew}, expected {full}")


def serve_step_check(label: str, step, module, swap: dict, params, rows: int) -> None:
    """One decode step of a spliced, masked batch (rows admitted at
    different shared positions): `step(p, dt)` through the kernels in bf16,
    through their twins in bf16 and in fp32 (params and state cast). The
    kernels' rel L2 against the fp32 twins is at most STEP_SLACK times the
    bf16 twins' (check_step's rule)."""
    kern = step(params, torch.bfloat16)[:rows].float()
    with swapped(module, swap):
        twin = step(params, torch.bfloat16)[:rows].float()
        ref = step(cast_tree(params, torch.float32), torch.float32)[:rows].float()
    e_k, e_t = rel_l2(kern, ref), rel_l2(twin, ref)
    ok = bool(torch.isfinite(kern).all()) and e_k <= STEP_SLACK * e_t
    print(f"  {label}: spliced masked batch of {rows} live rows, rel L2 against the fp32 "
          f"twins: kernels {e_k:.6g}, bf16 twins {e_t:.6g} (limit {STEP_SLACK} x); kernels "
          f"against bf16 twins {rel_l2(kern, twin):.6g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the kernels are less accurate than their twins")


@contextlib.contextmanager
def short_chunks(srv, steps: int = 4):
    """Run `srv`'s chunks `steps` steps long for the block (its worker is
    closed: the caller's own steps)."""
    chunk, srv.chunk = srv.chunk, steps
    try:
        yield
    finally:
        srv.chunk = chunk


def spliced_state(srv, payloads: list, caps: list) -> dict:
    """A batch state built on the calling thread with the server's own
    steps: payload i admitted into row i after i chunks of 4 steps (so each
    row sits at another shared position, spliced in while the others
    decode)."""
    s = srv._fresh_base()
    with short_chunks(srv):
        for b, (payload, cap) in enumerate(zip(payloads, caps)):
            if b:
                srv._step_chunk(s)
                s["pos"] += srv.chunk
            srv._admit_row(s, b, payload, cap)
    return s


def serve_report(name_limit: str, family: str, unit: str, agg: tuple, solo: tuple,
                 srv, grew: dict, extra: dict, parts: dict | None = None) -> None:
    snap = srv.stats.snapshot()
    if parts is not None:
        print(f"  {family}, all rows busy: worker time in {parts_line(parts, agg[1])}",
              flush=True)
        extra = {**extra, "worker_s": {k: v for k, v in parts.items()}}
    chunks = max(snap["chunks"], 1)
    agg_rate, solo_rate = agg[0] / agg[1], solo[0] / solo[1]
    per_chunk = {k: round(v / chunks, 2) for k, v in grew.items() if v}
    print(f"  {name_limit}: {family} slot server, {SERVE_SLOTS} slots all busy: "
          f"{agg_rate:.2f} {unit}/s ({agg[0]} {unit} in {agg[1]:.4f} s); solo pipeline "
          f"{solo_rate:.2f} {unit}/s ({solo[0]} in {solo[1]:.4f} s), "
          f"{agg_rate / solo_rate:.2f}x; latency p50 {snap['p50_ms']} ms p99 "
          f"{snap['p99_ms']} ms over {snap['completed']} requests; {snap['chunks']} chunks "
          f"of {srv.chunk} steps; launches a chunk {per_chunk}", flush=True)
    print("  " + json.dumps({"serving": family, "card": name_limit, "slots": SERVE_SLOTS,
                             f"{unit}_per_s": agg_rate, f"solo_{unit}_per_s": solo_rate,
                             "p50_ms": snap["p50_ms"], "p99_ms": snap["p99_ms"],
                             "requests": snap["completed"], "chunks": snap["chunks"],
                             "chunk": srv.chunk, "admissions_mid_decode":
                                 snap["admissions_mid_decode"], "launches": grew,
                             "launches_per_chunk": per_chunk, **extra}), flush=True)


def profile_chunk(label: str, srv, s: dict, name_limit: str,
                  classes: tuple | None = None) -> None:
    """torch.profiler over one chunk of 4 steps of `s` (after one more as
    warm-up): launches and device time a step of 4 busy rows by `classes`,
    the card's idle share."""
    with short_chunks(srv):
        profile_one(f"{label} slot-server chunk ({srv.chunk} steps, {SERVE_SLOTS} rows)",
                    lambda: type(srv)._step_chunk(srv, s), classes or (GEMM_CLASS,),
                    name_limit, per=(srv.chunk, "step"))


def http_post(url: str, body: dict, timeout: float = SERVE_WAIT_S) -> tuple:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read()


@torch.no_grad()
def serve_kani(name_limit: str, launches: dict) -> None:
    """Kani (kani-tts-370m + NanoCodec, the models of phase 6; the default
    repetition penalty): KaniSlotServer(slots=4, chunk=32, prompt_bucket=64)
    over 6 requests of 48-160 tokens, the last two admitted mid-decode;
    then all rows busy against the solo pipeline; then TTSServer.continuous
    + serve_http on 127.0.0.1:0 (3 POSTs and a stream)."""
    import io
    import threading
    import wave

    import tts_tpu_torch.models.kani as mk
    from tts_tpu_torch.models.kani import KaniConfig, KaniState, embed_tokens, init_params
    from tts_tpu_torch.models.kani import kani_step
    from tts_tpu_torch.models.nanocodec import NanoCodecConfig
    from tts_tpu_torch.models.nanocodec import init_params as codec_init
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.ops.decode_qkv import fused_qkv_rope_plain
    from tts_tpu_torch.runtime.kani import KaniDecodeConfig, KaniPipeline
    from tts_tpu_torch.serving.continuous import KaniSlotServer
    from tts_tpu_torch.serving.devices import pipelines_for_devices
    from tts_tpu_torch.serving.families import continuous_server
    from tts_tpu_torch.serving.server import serve_http

    cfg, ccfg = KaniConfig(max_seq_len=2048, stop_token=-1), NanoCodecConfig()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(2), torch.bfloat16)
    cparams = codec_init(ccfg, torch.Generator("cuda").manual_seed(3), torch.bfloat16)
    pipe = KaniPipeline(params, cfg, cparams, ccfg, KaniDecodeConfig(max_new_tokens=160))
    prompts = [np.array(p, np.int32) for p in (KANI_IDS, [[3, 9, 4]], [[5, 8, 13, 21, 34, 55]],
                                               [[7, 1, 4, 2]], [[11, 12]], [[6, 6, 6, 9]])]
    caps = [160, 160, 144, 64, 48, 56]
    names = ("fused_qkv_rope", "fused_qkv_attn")
    layers, up = cfg.num_attn_layers, ccfg.total_upsample

    def solo_tokens(ids, cap, p=pipe):
        c, buf, _ = p._buf_for(cap)
        ids_buf = np.zeros((1, p._bucket(ids.shape[1])), np.int64)
        ids_buf[0, :ids.shape[1]] = ids[0]
        save, n = p._greedy_run(torch.from_numpy(ids_buf).cuda(), ids.shape[1],
                                min(c, buf), buf)
        return save[0, :n].cpu()

    def same(a, b):
        return round(float((a[:len(b)] == b[:len(a)]).float().mean()), 3)

    pipe.synthesize_ids(prompts[0], max_new_tokens=16)              # warm-up
    torch.cuda.synchronize()
    srv = KaniSlotServer(pipe, slots=SERVE_SLOTS, chunk=32, prompt_bucket=64)
    sync_free(srv)
    codes = codes_by_future(srv, "save")
    parts = time_parts(srv)
    LAUNCHES.clear()
    try:
        futs, done, outs = serve_staggered(
            srv, [lambda i=i: srv.submit(prompts[i], max_new_tokens=caps[i]) for i in range(4)],
            [lambda i=i: srv.submit(prompts[i], max_new_tokens=caps[i]) for i in (4, 5)])
        chunks1 = srv.stats.chunks
        agg_out, agg_wall, parts = serve_rate(
            [lambda i=i: srv.submit(prompts[i], max_new_tokens=160) for i in range(SERVE_SLOTS)],
            parts)
    finally:
        srv.close()
    grew = serve_grew({}, names)
    for i, ((wav, n), cap) in enumerate(zip(outs + agg_out, caps + [160] * SERVE_SLOTS)):
        frames = (n - 2) // ccfg.num_groups
        if n != cap or wav.dtype != np.int16 or len(wav) != frames * up or not wav.any():
            raise AssertionError(f"Kani request {i}: {n} tokens, {len(wav)} {wav.dtype} samples; "
                                 f"expected {cap} tokens, {frames * up} int16 samples")
    snap = srv.stats.snapshot()
    if snap["admissions_mid_decode"] < 1:
        raise AssertionError("Kani: no request was admitted mid-decode")
    if not done[4] < done[0]:
        raise AssertionError("Kani: the short request admitted mid-decode did not finish "
                             "before the earlier long one")
    steps = srv.stats.chunks * srv.chunk
    serve_expect("Kani slot server", grew, {"fused_qkv_rope": layers * steps})
    # the share of a request's tokens equal to the solo pipeline's (kernel
    # 12's route), beside the same share between two solo routes (kernel 12
    # against kernel 11): bf16 rounding on random weights, not required
    kv11 = KaniPipeline(params, cfg, cparams, ccfg,
                        KaniDecodeConfig(max_new_tokens=160, fused_decode=True))
    agree, routes = [], []
    for i in (0, 4):                     # a long request, one admitted mid-decode
        solo12 = solo_tokens(prompts[i], caps[i])
        agree.append(same(codes[futs[i]], solo12))
        routes.append(same(solo_tokens(prompts[i], caps[i], kv11), solo12))
    print(f"  Kani staggered run: {len(futs)} requests (caps {caps}), {chunks1} chunks, "
          f"{snap['admissions_mid_decode']} admitted mid-decode, the cap-{caps[4]} request "
          f"done {done[0] - done[4]:.3f} s before the cap-{caps[0]} one; requests 0 and 4: "
          f"share of tokens equal to solo synthesize_ids (bf16, reported, not required) "
          f"{agree}; solo kernel-11 route against solo kernel-12 route {routes}", flush=True)

    # one step of a spliced, masked batch through kernel 11 against the twins
    s = spliced_state(srv, [(p, None) for p in prompts[:SERVE_SLOTS]], [160] * SERVE_SLOTS)

    def step(p, dt):
        st = s["state"]
        state = KaniState(type(st.kv)(st.kv.k.to(dt).clone(), st.kv.v.to(dt).clone(),
                                      st.kv.length), st.conv.to(dt).clone())
        h = embed_tokens(p, s["last"][:, None])
        return kani_step(p, h, state, cfg, key_valid_from=s["kvf"], fused="step")[0]

    before = dict(LAUNCHES)
    serve_step_check("Kani step", step, mk, {"fused_qkv_rope": fused_qkv_rope_plain},
                     params, SERVE_SLOTS)
    serve_expect("Kani step check", serve_grew(before, names), {"fused_qkv_rope": layers})
    profile_chunk("Kani", srv, s, name_limit)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st = pipe.synthesize_ids(prompts[0], max_new_tokens=160)
    solo = (st["tokens"], time.perf_counter() - t0)
    serve_report(name_limit, "kani", "tokens", (sum(n for _, n in agg_out), agg_wall), solo,
                 srv, grew, {"tokens_equal_to_solo": agree, "solo_routes_equal": routes},
                 parts)
    for k, n in grew.items():
        launches[k] = launches.get(k, 0) + n

    # the HTTP front-end over a continuous server
    tts = continuous_server("kani", pipe, slots=SERVE_SLOTS, max_tokens=96, chunk=32,
                            prompt_bucket=64, stream_kw={"window": 96})
    sync_free(tts.batcher)
    tts.batcher._receptive_frames()     # the stream's probe decode, before traffic
    httpd = serve_http(tts, "127.0.0.1", 0)
    url = "http://%s:%d" % httpd.server_address
    frames = (96 - 2) // ccfg.num_groups
    try:
        before = dict(LAUNCHES)
        res = [None] * 3
        threads = [threading.Thread(target=lambda i=i: res.__setitem__(
            i, http_post(f"{url}/synthesize", {"ids": prompts[i].tolist()}))) for i in range(3)]
        for th in threads:
            th.start()
        status, headers, body = http_post(f"{url}/stream", {"ids": prompts[0].tolist()})
        for th in threads:
            th.join(SERVE_WAIT_S)
        if status != 200 or "X-TTFA-MS" not in headers:
            raise AssertionError(f"HTTP /stream: status {status}, headers {headers}")
        stream = np.frombuffer(body, np.int16)
        wavs = []
        for r in res:
            if r is None or r[0] != 200 or r[1].get("Content-Type") != "audio/wav":
                raise AssertionError(f"HTTP /synthesize failed: {r and r[:2]}")
            with wave.open(io.BytesIO(r[2])) as w:
                if (w.getframerate(), w.getsampwidth(), w.getnchannels()) != \
                        (ccfg.sample_rate, 2, 1) or r[2][:4] != b"RIFF":
                    raise AssertionError("HTTP /synthesize: not a 16-bit mono WAV at the "
                                         "codec's rate")
                wavs.append(np.frombuffer(w.readframes(w.getnframes()), np.int16))
        if any(len(w) != frames * up for w in wavs) or len(stream) != frames * up:
            raise AssertionError(f"HTTP: {[len(w) for w in wavs]} and stream {len(stream)} "
                                 f"samples, expected {frames * up}")
        with urllib_open(f"{url}/stats") as resp:
            stats = json.loads(resp.read())
        if stats.get("completed") != 4 or stats.get("streams") != 1:
            raise AssertionError(f"HTTP /stats: {stats}")
        grew_http = serve_grew(before, names)
        serve_expect("Kani HTTP", grew_http, {
            "fused_qkv_rope": layers * tts.batcher.stats.chunks * tts.batcher.chunk})
        diff = int(np.abs(stream.astype(np.int32) - wavs[0].astype(np.int32)).max())
        print(f"  Kani over HTTP (127.0.0.1): 3 concurrent POST /synthesize of {len(wavs[0])} "
              f"samples (16-bit mono WAV at {ccfg.sample_rate} Hz) and one /stream "
              f"(TTFA {headers['X-TTFA-MS']} ms, {len(stream)} samples, max |stream - "
              f"WAV| {diff} LSB); /stats {stats}", flush=True)
        for k, n in grew_http.items():
            launches[k] = launches.get(k, 0) + n
    finally:
        httpd.shutdown()
        httpd.server_close()
        tts.close()

    # two slot servers in one process behind a SlotRouter (one card here):
    # two worker threads launching kernels at once, their counts exact.
    # The sync debug mode is process-wide, so this run goes without it.
    router = continuous_server("kani", pipelines_for_devices(pipe, ["cuda:0", "cuda:0"]),
                               slots=SERVE_SLOTS, max_tokens=64, chunk=32, prompt_bucket=64)
    try:
        before = dict(LAUNCHES)
        futs = [router.submit(prompts[i % len(prompts)], deadline_s=SERVE_WAIT_S)
                for i in range(2 * SERVE_SLOTS)]
        outs = [f.result(timeout=SERVE_WAIT_S) for f in futs]
        st = router.stats()
        grew_r = serve_grew(before, names)
        chunks = [p["chunks"] for p in st["per_server"]]
        if any(n != 64 for _, n in outs) or min(chunks) < 1 or st["completed"] != len(futs):
            raise AssertionError(f"router: counts {[n for _, n in outs]}, stats {st}")
        serve_expect("Kani router", grew_r, {"fused_qkv_rope": layers * 32 * sum(chunks)})
        print(f"  Kani SlotRouter over two slot servers on one card: {len(futs)} requests of "
              f"64 tokens, chunks by server {chunks}, launches {grew_r} (exact across two "
              f"worker threads)", flush=True)
        for k, n in grew_r.items():
            launches[k] = launches.get(k, 0) + n
    finally:
        router.close()


def urllib_open(url: str):
    import urllib.request

    return urllib.request.urlopen(url, timeout=SERVE_WAIT_S)


@torch.no_grad()
def serve_qwen(name_limit: str, launches: dict) -> None:
    """Qwen3-TTS-0.6B (phase 7's models): QwenSlotServer(slots=4) over 4
    requests of 24-40 frames, two admitted mid-decode, on the default route
    (kernel 11), on "all" (kernels 11, 13 in the predictor, 14) and int8
    "mlp_q8" (11, 15); all rows busy against the solo pipeline; one talker
    step of a spliced masked batch per route against the twins."""
    import tts_tpu_torch.models.qwen_tts as mq
    from tts_tpu_torch.models.qwen_tts import qwen3_stack_step
    from tts_tpu_torch.ops import decode_mlp, decode_qkv
    from tts_tpu_torch.runtime.qwen import QwenDecodeConfig, QwenTTSPipeline
    from tts_tpu_torch.serving.continuous_qwen import QwenSlotServer

    cfg, ccfg, params, cparams = qwen_models()
    t = cfg.talker
    talker, pred = t.num_layers, (cfg.num_code_groups - 1) * cfg.predictor.num_layers
    prompts = [QWEN_IDS, np.arange(5, 20, dtype=np.int32)[None],
               np.arange(40, 90, dtype=np.int32)[None], np.array([[7, 1, 4]], np.int32)]
    caps = [40, 32, 24, 36]

    def pipe_for(route, quantize=None, frames=48):
        return QwenTTSPipeline(params, cfg, cparams, ccfg,
                               QwenDecodeConfig(max_frames=frames, fused_decode=route),
                               quantize=quantize)

    base = pipe_for(None)
    reqs = [base.build_prefill_embeds(p, QWEN_LANG) for p in prompts]
    per_step = {
        "default": {"fused_qkv_rope": talker + pred},
        "all": {"fused_qkv_rope": talker + pred, "decode_gqa_attention": pred,
                "fused_out_mlp": talker + pred},
        "mlp_q8": {"fused_qkv_rope": talker + pred, "fused_out_mlp_q8": talker + pred}}
    base.synthesize_from_prefill(*reqs[3])                          # warm-up
    from tts_tpu_torch.ops._build import LAUNCHES

    for route, pipe in (("default", base), ("all", pipe_for("all")),
                        ("mlp_q8", pipe_for("mlp_q8", quantize=8, frames=16))):
        # int8 "mlp_q8": shorter requests in chunks of 4 steps
        rcaps = caps if route != "mlp_q8" else [16, 12, 16, 12]
        srv = QwenSlotServer(pipe, slots=SERVE_SLOTS, chunk=16 if route != "mlp_q8" else 4)
        sync_free(srv)
        parts = time_parts(srv)
        LAUNCHES.clear()
        try:
            futs, done, outs = serve_staggered(
                srv, [lambda i=i: srv.submit(*reqs[i], max_frames=rcaps[i]) for i in (0, 1)],
                [lambda i=i: srv.submit(*reqs[i], max_frames=rcaps[i]) for i in (2, 3)])
            agg_out, agg_wall = ([], 1.0)
            if route == "default":
                # 48 frames: 3 whole chunks (a request's frames are its steps)
                agg_out, agg_wall, parts = serve_rate(
                    [lambda i=i: srv.submit(*reqs[i], max_frames=48) for i in range(SERVE_SLOTS)],
                    parts)
        finally:
            srv.close()
        grew = serve_grew({}, QWEN_KERNELS)
        for i, ((wav, n), cap) in enumerate(zip(outs + agg_out, rcaps + [48] * len(agg_out))):
            if n != cap or wav.dtype != np.int16 or len(wav) != n * ccfg.total_upsample \
                    or not wav.any():
                raise AssertionError(f"Qwen {route} request {i}: {n} frames, {len(wav)} "
                                     f"{wav.dtype} samples; expected {cap} frames")
        if srv.stats.admissions_mid_decode < 1:
            raise AssertionError(f"Qwen {route}: no request was admitted mid-decode")
        steps = srv.stats.chunks * srv.chunk
        serve_expect(f"Qwen slot server {route!r}", grew,
                     {k: v * steps for k, v in per_step[route].items()})
        print(f"  Qwen {route!r}: {len(outs)} requests (caps {rcaps}), "
              f"{srv.stats.admissions_mid_decode} admitted mid-decode, {srv.stats.chunks} "
              f"chunks, launches {grew}", flush=True)
        for k, n in grew.items():
            launches[k] = launches.get(k, 0) + n
        if route == "default":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, st = base.synthesize_from_prefill(*reqs[0])
            serve_report(name_limit, "qwen", "frames", (sum(n for _, n in agg_out), agg_wall),
                         (st["frames"], time.perf_counter() - t0), srv, grew, {"route": route},
                         parts)
        if route in ("default", "all"):
            s = spliced_state(srv, [(*reqs[i], None) for i in range(SERVE_SLOTS)],
                              [48] * SERVE_SLOTS)
            kv_valid = torch.arange(srv.kv_max, device="cuda")[None, :] >= s["kvf"][:, None]
            x = params["talker_codec_embed"][torch.tensor([5, 9, 17, 3], device="cuda")][:, None]
            pos = s["kv"].length

            def step(p, dt, route=route, s=s, kv_valid=kv_valid, x=x, pos=pos):
                kv = type(s["kv"])(s["kv"].k.to(dt).clone(), s["kv"].v.to(dt).clone(), pos)
                return qwen3_stack_step(p["talker"], x.to(dt), kv, t,
                                        p["rope_cos"][pos:pos + 1].to(dt),
                                        p["rope_sin"][pos:pos + 1].to(dt), kv_valid=kv_valid,
                                        fused="step" if route == "default" else route)[0]

            serve_step_check(f"Qwen talker step {route!r}", step, mq, {
                "fused_qkv_rope": decode_qkv.fused_qkv_rope_plain,
                "fused_out_mlp": decode_mlp.fused_out_mlp_plain}, params, SERVE_SLOTS)
            if route == "default":
                profile_chunk("Qwen", srv, s, name_limit)
        del pipe


@torch.no_grad()
def serve_indextts(name_limit: str, launches: dict) -> None:
    """IndexTTS-1.5 (phase 9's models and reference): IndexTTSSlotServer(
    slots=4) over 4 requests of 48-96 tokens, two admitted mid-decode, each
    finished row vocoded through kernel 10; one refused submit past the mel
    positions; all rows busy against the solo pipeline; one GPT step of a
    spliced masked batch against the twins."""
    import tts_tpu_torch.models.indextts as mi
    from tts_tpu_torch.models.indextts import gpt_step
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.ops.decode_qkv import fused_qkv_rope_plain
    from tts_tpu_torch.runtime.indextts import IndexTTSPipeline
    from tts_tpu_torch.serving.continuous_indextts import IndexTTSSlotServer

    cfg, vcfg, params = indextts_models()
    pipe = IndexTTSPipeline(params, cfg, vcfg)
    rate = vcfg.sample_rate
    tt = np.arange(6 * rate) / rate
    sig = (0.3 * np.sin(2 * np.pi * 220 * tt) * (1 + np.sin(2 * np.pi * 3 * tt))
           + 0.05 * np.random.default_rng(12).standard_normal(tt.size))
    ref = pipe.encode_reference((sig * 12000).astype(np.int16))
    prompts = [INDEX_IDS, np.arange(5, 20, dtype=np.int32)[None],
               np.arange(40, 60, dtype=np.int32)[None], np.array([[7, 1, 4]], np.int32)]
    caps = [96, 80, 48, 64]
    names = ("fused_qkv_rope", "fused_qkv_attn", "amp_block_fused")
    pipe.synthesize_ids(prompts[3], ref, max_gen=16)                 # warm-up
    torch.cuda.synchronize()
    srv = IndexTTSSlotServer(pipe, slots=SERVE_SLOTS, max_gen=96, ref=ref)
    sync_free(srv)
    parts = time_parts(srv)
    table = int(params["gpt"]["mel_pos"].shape[0])
    try:
        srv.submit(prompts[0], max_gen=table + 1)
        raise AssertionError("IndexTTS: a cap past the mel positions was admitted")
    except ValueError as e:
        print(f"  IndexTTS: max_gen {table + 1} refused: {e}", flush=True)
    LAUNCHES.clear()
    try:
        futs, done, outs = serve_staggered(
            srv, [lambda i=i: srv.submit(prompts[i], max_gen=caps[i]) for i in (0, 1)],
            [lambda i=i: srv.submit(prompts[i], max_gen=caps[i]) for i in (2, 3)])
        agg_out, agg_wall, parts = serve_rate(
            [lambda i=i: srv.submit(prompts[i], max_gen=96) for i in range(SERVE_SLOTS)], parts)
    finally:
        srv.close()
    grew = serve_grew({}, names)
    all_caps = caps + [96] * SERVE_SLOTS
    k10 = 0
    for i, ((wav, n), cap) in enumerate(zip(outs + agg_out, all_caps)):
        nf = cap - 2
        k10 += kernel10_per_call(vcfg, min(max(8, -(-nf // 8) * 8), srv.gbuf))
        if n != cap or wav.dtype != np.int16 or len(wav) != nf * vcfg.total_upsample \
                or not wav.any():
            raise AssertionError(f"IndexTTS request {i}: {n} tokens, {len(wav)} {wav.dtype} "
                                 f"samples; expected {cap} tokens")
    if srv.stats.admissions_mid_decode < 1:
        raise AssertionError("IndexTTS: no request was admitted mid-decode")
    steps = srv.stats.chunks * srv.chunk
    serve_expect("IndexTTS slot server", grew, {"fused_qkv_rope": cfg.gpt_layers * steps,
                                                "amp_block_fused": k10})
    for k, n in grew.items():
        launches[k] = launches.get(k, 0) + n

    s = spliced_state(srv, [(prompts[i], ref) for i in range(SERVE_SLOTS)], [96] * SERVE_SLOTS)
    kv_valid = srv._row_valid(s["kvf"], s["tlen"])

    def step(p, dt):
        gpt = p["gpt"]
        kv = type(s["kv"])(s["kv"].k.to(dt).clone(), s["kv"].v.to(dt).clone(), s["kv"].length)
        h = (gpt["mel_embed"][s["tok"]] + gpt["mel_pos"][s["cnt"]])[:, None]
        return gpt_step(gpt, h, kv, s["vec"], cfg, kv_valid, fused=True)[0]

    serve_step_check("IndexTTS GPT step", step, mi, {"fused_qkv_rope": fused_qkv_rope_plain},
                     {"gpt": params["gpt"]}, SERVE_SLOTS)
    profile_chunk("IndexTTS", srv, s, name_limit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st = pipe.synthesize_ids(prompts[0], ref, max_gen=96)
    serve_report(name_limit, "indextts", "tokens", (sum(n for _, n in agg_out), agg_wall),
                 (st.tokens, time.perf_counter() - t0), srv, grew,
                 {"kernel10_per_vocoder_call": k10 / len(all_caps)}, parts)


@torch.no_grad()
def serve_voxcpm(name_limit: str, launches: dict) -> None:
    """VoxCPM-2 (phase 10's models): VoxCPMSlotServer(slots=4) over 3
    requests of 12-20 latents (min_latents = max_latents: the random stop
    head cannot end a row), one admitted mid-decode, each row's noise from
    its own generator; all rows busy against the solo pipeline; one dual-LM
    step of a spliced masked batch against the twins."""
    import tts_tpu_torch.models.voxcpm as vm
    from tts_tpu_torch.models.voxcpm import voxcpm_main_step, voxcpm_v2_config
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.ops.decode_qkv import fused_qkv_rope_plain
    from tts_tpu_torch.runtime.voxcpm import VoxCPMDecodeConfig, VoxCPMPipeline
    from tts_tpu_torch.serving.continuous_voxcpm import VoxCPMSlotServer

    cfg = voxcpm_v2_config()
    params, vae = voxcpm_models(cfg, 30)
    pipe = VoxCPMPipeline(params, cfg, vae, VoxCPMDecodeConfig(max_latents=VOX_LATENTS,
                                                               min_latents=VOX_LATENTS))
    layers = cfg.base.num_layers + cfg.residual.num_layers

    def seg(i):
        flat = np.concatenate([VOX_PROMPT[0], VOX_TARGET[0][:24 + i], [cfg.audio_start_id]])
        return [("text", flat.astype(np.int32))]

    caps = [20, 16, 12]
    names = ("fused_qkv_rope", "fused_qkv_attn")
    pipe.synthesize_ids(VOX_PROMPT, VOX_TARGET[:, :2])              # warm-up
    torch.cuda.synchronize()
    srv = VoxCPMSlotServer(pipe, slots=SERVE_SLOTS)
    sync_free(srv)
    parts = time_parts(srv)
    LAUNCHES.clear()
    try:
        futs, done, outs = serve_staggered(
            srv, [lambda i=i: srv.submit_segments(seg(i), None, caps[i], seed=i) for i in (0, 1)],
            [lambda: srv.submit_segments(seg(2), None, caps[2], seed=2)])
        agg_out, agg_wall, parts = serve_rate(
            [lambda i=i: srv.submit_segments(seg(i), None, 16, seed=i)
             for i in range(SERVE_SLOTS)], parts)
    finally:
        srv.close()
    grew = serve_grew({}, names)
    spl = cfg.samples_per_latent
    for i, ((wav, n), cap) in enumerate(zip(outs + agg_out, caps + [16] * SERVE_SLOTS)):
        if n != cap or wav.dtype != np.int16 or len(wav) != n * spl or not wav.any():
            raise AssertionError(f"VoxCPM request {i}: {n} latents, {len(wav)} {wav.dtype} "
                                 f"samples; expected {cap} latents")
    if srv.stats.admissions_mid_decode < 1:
        raise AssertionError("VoxCPM: no request was admitted mid-decode")
    steps = srv.stats.chunks * srv.chunk
    serve_expect("VoxCPM slot server", grew, {"fused_qkv_rope": layers * steps})
    for k, n in grew.items():
        launches[k] = launches.get(k, 0) + n

    payloads = [(srv._payload(seg(i), seed=i), None) for i in range(SERVE_SLOTS)]
    s = spliced_state(srv, payloads, [40] * SERVE_SLOTS)
    kv_valid = torch.arange(srv.kv_max, device="cuda")[None, :] >= s["kvf"][:, None]
    ids = torch.tensor([5, 9, 17, 3], device="cuda")

    def step(p, dt):
        def c(kv):
            return type(kv)(kv.k.to(dt).clone(), kv.v.to(dt).clone(), kv.length)
        h = p["embed"][ids][:, None].to(dt)
        return voxcpm_main_step(p, h, h, 0, c(s["base_kv"]), c(s["res_kv"]), cfg,
                                kv_valid=kv_valid, fused="step")[0]

    serve_step_check("VoxCPM dual-LM step", step, vm, {"fused_qkv_rope": fused_qkv_rope_plain},
                     params, SERVE_SLOTS)
    profile_chunk("VoxCPM-2", srv, s, name_limit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st = pipe.synthesize_ids(VOX_PROMPT, VOX_TARGET)
    serve_report(name_limit, "voxcpm", "latents", (sum(n for _, n in agg_out), agg_wall),
                 (st["latents"], time.perf_counter() - t0), srv, grew, {}, parts)


@torch.no_grad()
def serve_f5(name_limit: str, launches: dict) -> None:
    """F5TTS_v1_Base + Vocos (phase 3's models: bf16, and their W8A8 form):
    F5SlotServer(slots=4, chunk_steps=4, gen_frames=832) over the six
    F5_TEXTS requests on the bench reference, the last two admitted
    mid-flight; each request against its solo synthesize at its seed (the
    same draw and buckets), beside four requests through a twin server
    against their twin solo runs (`check_rows`); 22 launches of kernels 1
    and 3 and one of kernel 2 a step; every chunk under the sync debug mode
    "error"; each finished row's latent finite; all 4 rows busy against the
    solo pipeline, p50/p99; one chunk profiled. Then a W8A8 server over 4
    requests (22 launches of kernels 1 and 6 and one of 2 a step, none of 7
    and 8: per-row mods) and one request over HTTP through
    continuous_server("f5")."""
    import io
    import wave

    from tts_tpu_torch.models.f5 import F5Config, F5Model
    from tts_tpu_torch.models.f5 import init_params as f5_init
    from tts_tpu_torch.models.vocos import VocosConfig, VocosModel
    from tts_tpu_torch.models.vocos import init_params as vocos_init
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.f5 import F5Pipeline
    from tts_tpu_torch.serving.continuous_f5 import F5SlotServer
    from tts_tpu_torch.serving.families import continuous_server
    from tts_tpu_torch.serving.server import serve_http

    cfg, vcfg = F5Config(), VocosConfig()
    f5 = F5Model(cfg, f5_init(cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16))
    vocos = VocosModel(vcfg, vocos_init(vcfg, torch.Generator("cuda").manual_seed(1),
                                        torch.bfloat16))
    pipe = F5Pipeline(f5, {" ": 0}, vocos)
    audio = bench_audio(cfg.sample_rate)
    names = ("flash_attention_flat", "conv_pos_embed_fused", "mlp_block_fused") + Q8_KERNELS
    depth = cfg.depth
    seeds = [F5_SEED + i for i in range(len(F5_TEXTS))]
    reqs = [(audio, REF_TEXT, t) for t in F5_TEXTS]
    noise = np.concatenate([f5_draw(sd, 1, 1408, cfg.n_mels) for sd in seeds])
    lens = [min(g, F5_GEN - 1) * cfg.hop for g in pipe._prepare_batch(reqs)[4]]
    pipe.synthesize(audio, REF_TEXT, "word word")                    # warm-up
    torch.cuda.synchronize()

    def server(p, checked=True):
        srv = F5SlotServer(p, slots=SERVE_SLOTS, chunk_steps=4, gen_frames=F5_GEN)
        if checked:
            sync_free(srv)
            real = srv._finalize

            def finalize(s, b, n):
                # at the boundary, outside a chunk: the row's latent finite
                if not bool(torch.isfinite(s["x"][b]).all()):
                    raise AssertionError(f"F5 slot row {b}: its latent is not finite")
                return real(s, b, n)

            srv._finalize = finalize
        return srv

    def sub(srv, i):
        return lambda: srv.submit(audio, REF_TEXT, F5_TEXTS[i], seed=seeds[i])

    def expect_lens(label, outs, idx):
        got = [(n, len(w)) for w, n in outs]
        if got != [(lens[i], lens[i]) for i in idx] or not all(w.any() for w, _ in outs):
            raise AssertionError(f"{label}: (n, samples) {got}, expected "
                                 f"{[lens[i] for i in idx]}")

    srv = server(pipe)
    parts = time_parts(srv)
    before = dict(LAUNCHES)
    try:
        futs, done, outs = serve_staggered(srv, [sub(srv, i) for i in range(4)],
                                           [sub(srv, 4), sub(srv, 5)])
        chunks1, mid1 = srv.stats.chunks, srv.stats.admissions_mid_decode
        agg_out, agg_wall, parts = serve_rate([sub(srv, i) for i in range(SERVE_SLOTS)],
                                              parts)
    finally:
        srv.close()
    grew = serve_grew(before, names)
    steps = srv.stats.chunks * srv.chunk
    serve_expect("F5 slot server", grew, {"flash_attention_flat": depth * steps,
                                          "conv_pos_embed_fused": steps,
                                          "mlp_block_fused": depth * steps})
    expect_lens("F5 slot server", outs, range(6))
    expect_lens("F5 slot server, all rows busy", agg_out, range(SERVE_SLOTS))
    if mid1 < 1:
        raise AssertionError("F5: no request was admitted mid-flight")
    diffs, walls, _ = rows_against_solo(pipe, reqs, [w for w, _ in outs], noise)
    with twins_in_dit():
        tsrv = server(pipe, checked=False)
        try:
            tfuts = [sub(tsrv, i)() for i in range(SERVE_SLOTS)]
            touts = [f.result(timeout=SERVE_WAIT_S)[0] for f in tfuts]
        finally:
            tsrv.close()
        tdiffs = rows_against_solo(pipe, reqs[:SERVE_SLOTS], touts, noise)[0]
    print(f"  F5 staggered run: {len(futs)} requests, {chunks1} chunks, {mid1} admitted "
          f"mid-flight, done {[round(done[i] - min(done.values()), 3) for i in range(6)]} s",
          flush=True)
    check_rows("F5 slot server (bf16)", diffs, tdiffs)

    s = spliced_state(srv, [srv._payload(audio, REF_TEXT, F5_TEXTS[i], seed=seeds[i])
                            for i in range(SERVE_SLOTS)], [cfg.nfe_steps] * SERVE_SLOTS)
    profile_chunk("F5", srv, s, name_limit, F5_CLASSES)
    del s

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav, _ = pipe.synthesize(audio, REF_TEXT, F5_TEXTS[3])
    solo = (len(wav) / cfg.sample_rate, time.perf_counter() - t0)
    agg_audio = sum(len(w) for w, _ in agg_out) / cfg.sample_rate
    serve_report(name_limit, "f5", "audio_s", (agg_audio, agg_wall), solo, srv, grew,
                 {"row_vs_solo": diffs, "twin_row_vs_solo": tdiffs,
                  "solo_wall_s": walls}, parts)
    for k, n in grew.items():
        launches[k] = launches.get(k, 0) + n

    # W8A8: the per-row mods keep kernels 7 and 8 off; kernel 6 takes them
    q8 = F5Pipeline(f5, {" ": 0}, vocos, quantize="w8a8")
    srv = server(q8)
    before = dict(LAUNCHES)
    try:
        outs = [f.result(timeout=SERVE_WAIT_S)
                for f in [sub(srv, i)() for i in range(SERVE_SLOTS)]]
    finally:
        srv.close()
    grew = serve_grew(before, names)
    steps = srv.stats.chunks * srv.chunk
    serve_expect("F5 W8A8 slot server", grew, {"flash_attention_flat": depth * steps,
                                               "conv_pos_embed_fused": steps,
                                               "mlp_block_fused_q8": depth * steps})
    expect_lens("F5 W8A8 slot server", outs, range(SERVE_SLOTS))
    qdiffs = rows_against_solo(q8, reqs[:SERVE_SLOTS], [w for w, _ in outs], noise)[0]
    print(f"  F5 W8A8 slot server: {SERVE_SLOTS} requests, {srv.stats.chunks} chunks, "
          f"launches {grew}; each row against its solo W8A8 run (rel L2, max LSB; the solo "
          f"route quantizes the attention input through kernels 7 and 8, the slot rows "
          f"take the int8-weight projections: reported, not bounded) "
          f"{[(round(r, 6), n) for r, n in qdiffs]}", flush=True)
    for k, n in grew.items():
        launches[k] = launches.get(k, 0) + n
    del q8

    # the HTTP front-end over an F5 slot server
    tts = continuous_server("f5", pipe, ref_audio=audio, ref_text=REF_TEXT,
                            slots=SERVE_SLOTS, chunk_steps=4, gen_frames=F5_GEN)
    sync_free(tts.batcher)
    httpd = serve_http(tts, "127.0.0.1", 0)
    url = "http://%s:%d" % httpd.server_address
    try:
        before = dict(LAUNCHES)
        status, headers, body = http_post(f"{url}/synthesize", {"gen_text": F5_TEXTS[3]})
        if status != 200 or headers.get("Content-Type") != "audio/wav" or body[:4] != b"RIFF":
            raise AssertionError(f"F5 HTTP /synthesize: status {status}, headers {headers}")
        with wave.open(io.BytesIO(body)) as w:
            if (w.getframerate(), w.getsampwidth(), w.getnchannels()) != \
                    (cfg.sample_rate, 2, 1):
                raise AssertionError("F5 HTTP: not a 16-bit mono WAV at 24 kHz")
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        with urllib_open(f"{url}/stats") as resp:
            stats = json.loads(resp.read())
        if len(pcm) != BENCH_SAMPLES or stats.get("completed") != 1:
            raise AssertionError(f"F5 HTTP: {len(pcm)} samples, /stats {stats}")
        grew = serve_grew(before, names)
        steps = tts.batcher.stats.chunks * tts.batcher.chunk
        serve_expect("F5 HTTP", grew, {"flash_attention_flat": depth * steps,
                                       "conv_pos_embed_fused": steps,
                                       "mlp_block_fused": depth * steps})
        rel, lsb = wav_diff(pcm, pipe.synthesize(audio, REF_TEXT, F5_TEXTS[3])[0])
        print(f"  F5 over HTTP (127.0.0.1): POST /synthesize {{\"gen_text\": ...}} gave "
              f"{len(pcm)} samples (16-bit mono WAV at {cfg.sample_rate} Hz); against the "
              f"solo request at the pipeline's seed: rel L2 {rel:.6g}, max {lsb} LSB; /stats "
              f"{stats}", flush=True)
        for k, n in grew.items():
            launches[k] = launches.get(k, 0) + n
    finally:
        httpd.shutdown()
        httpd.server_close()
        tts.close()


SERVERS = {"kani": serve_kani, "qwen": serve_qwen, "indextts": serve_indextts,
           "voxcpm": serve_voxcpm, "f5": serve_f5}


def run_serving(name_limit: str, servers) -> dict:
    """Phase 11: the five slot servers at full width (`servers`: the names
    of SERVERS to run), and the HTTP front-end over Kani's and F5's.
    Returns the launch counts of their serving runs."""
    launches: dict = {}
    for fn in (SERVERS[k] for k in SERVERS if k in servers):
        t0 = time.perf_counter()
        fn(name_limit, launches)
        torch.cuda.synchronize()
        print(f"  ({fn.__name__} {time.perf_counter() - t0:.1f} s)", flush=True)
    return launches


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
    busy_unit = f" ({busy / per[0]:.4f} ms a {per[1]})" if per else ""
    print(f"  {name_limit}: profile {label}: wall {wall:.4f} s profiled, device kernel time "
          f"{busy:.3f} ms{busy_unit}, idle {100 * (1 - busy / 1e3 / wall):.1f}% of the "
          f"profiled wall, "
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
                         "int8), one BigVGAN call, one IndexTTS request and one "
                         "VoxCPM-2 request, the Kani, Qwen, BigVGAN, IndexTTS "
                         "and VoxCPM tables into DIR")
    ap.add_argument("--families", default="f5,kani,qwen,bigvgan,indextts,voxcpm,serving",
                    help="the pipeline phases to run after phase 2, by family: "
                         "f5 (3-5d), kani (6), qwen (7), bigvgan (8, 8c), indextts (9), "
                         "voxcpm (10), serving (11); default all (the smoke run's "
                         "contract)")
    ap.add_argument("--servers", default=",".join(SERVERS),
                    help="the slot servers phase 11 runs: " + ", ".join(SERVERS) +
                         "; default all")
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
    # kernels 16 and 17 are on no pipeline's path: from here on a launch of
    # either fails the run (the phases clear LAUNCHES, so the check is at the
    # count itself)
    count_launch = _build.count_launch

    def no_ablation(name: str) -> None:
        if name in ABLATION_KERNELS:
            raise AssertionError(f"a pipeline launched {name}")
        count_launch(name)

    _build.count_launch = no_ablation

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

        phase("phase 5c: F5Pipeline in fp32")
        launches.update(run_f5_fp32(name_limit, profile=bool(args.profile)))
        launches["flash_attention_online"] += k5

        phase("phase 5d: F5's many requests: synthesize_batch, step vectors, the layer cache")
        for k, n in run_f5_many(pipe, q8_pipe, name_limit).items():
            launches[k] = launches.get(k, 0) + n
        del q8_pipe, pipe

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
        _, index_pipe, index_ref, index_voc = run_indextts(name_limit)
        if args.profile:
            phase("phase 9b: torch.profiler over one IndexTTS request (bf16)")
            profile_one(
                "IndexTTS bf16 request (32 ids, 256 tokens)",
                lambda: index_pipe.synthesize_ids(INDEX_IDS, index_ref, max_gen=INDEX_GEN),
                (("kernel 11 (qkv_head_kernel)", ("qkv_head",)),
                 K10_CLASS, CONV_CLASS, GEMM_CLASS, ("casts / copies", ("copy", "convert"))),
                name_limit, per=(INDEX_GEN, "token"),
                out_path=os.path.join(args.profile, "indextts_profile.txt"))
            # the request's vocoder call alone: its arguments as the request
            # gave them, so its device time, wall and kernel 10's part show
            # apart from the decode's
            profile_one(
                "IndexTTS bf16 request's vocoder call (BigVGAN, 1,024x)",
                lambda: index_pipe._vocode(*index_voc),
                (K10_CLASS, CONV_CLASS, GEMM_CLASS, ("casts / copies", ("copy", "convert"))),
                name_limit, out_path=os.path.join(args.profile, "indextts_vocoder_profile.txt"))
        del index_pipe, index_voc

    if "voxcpm" in fams:
        phase("phase 10: VoxCPMPipeline")
        vox, vox_pipe = run_voxcpm(name_limit)
        for k, n in vox.items():
            launches[k] = launches.get(k, 0) + n
        if args.profile:
            phase("phase 10b: torch.profiler over one VoxCPM-2 request (bf16)")
            profile_one(
                f"VoxCPM-2 bf16 request ({VOX_LATENTS} latents)",
                lambda: vox_pipe.synthesize_ids(VOX_PROMPT, VOX_TARGET),
                (("kernel 12 (qkv_head_kernel + step_attn_kernel)", ("qkv_head", "step_attn")),
                 GEMM_CLASS, ("casts / copies", ("copy", "convert")), CONV_CLASS),
                name_limit, per=(VOX_LATENTS, "latent"),
                out_path=os.path.join(args.profile, "voxcpm_profile.txt"))
        del vox_pipe

    if "serving" in fams:
        phase("phase 11: serving (continuous-batching slot servers, HTTP)")
        for k, n in run_serving(name_limit, set(args.servers.split(","))).items():
            launches[k] = launches.get(k, 0) + n

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
