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
    python3 chip_smoke.py --families checkpoints        # phases 0-2, 12
    python3 chip_smoke.py --families cli                # phases 0-2, 13
    python3 chip_smoke.py --families clone              # phases 0-2, 14
    python3 chip_smoke.py --families parity             # phases 0-2, 15
    python3 chip_smoke.py --families graphs             # phases 0-2, 16
    python3 chip_smoke.py --families qwen,clone,graphs  # phases 0-2, 7, 14, 16
    python3 chip_smoke.py --families voxcpm,clone,graphs  # phases 0-2, 10, 14, 16

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
     PDL on and off, split by launch; kernel 12's device-position form, the
     Kani decode programs', at every position of these sweeps, bitwise its
     host-position form and against its device-form twin, timed beside it
     at pos 5 and 700; kernel 13's device-length form, the Qwen3-TTS
     talker programs' "all" route, at every kv_len of its sweep (talker T
     768 and 640, predictor T 32; B 1 and 3), bitwise its host form and
     against its device-form twin, timed beside it), the Qwen3-TTS-0.6B
     talker and
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
     weights from a seed, the bench config: 256 new tokens, no stop token)
     on its decode programs (a CUDA graph each for the prefill, STEPS decode
     steps and the codec): greedy bf16 and int8, beam and a batch of 4,
     each first request's warm-up and capture seconds and the pool's MiB,
     checking the audio, that every attention layer's decode step went
     through kernel 12 (greedy) or kernel 11 (beam, batch), 6 launches a
     decode step in whole replays (kani_steps), the greedy tokens equal to
     a host-driven loop's (kernel 12 at host positions), and one step's
     logits against the plain route; then tokens/s and RTF of greedy bf16
     and int8;
  7. QwenTTSPipeline at full Qwen3-TTS-0.6B width (random weights from a
     seed) on its decode programs (a CUDA graph each for the prefill,
     one frame step and the codec; each route's first request's
     warm-up and capture seconds and the pool's MiB): the bench request (32
     text ids, language 3, max_frames 120) in bf16 and int8 on the default
     route, 88 launches of kernel 12 a frame step the programs ran
     (qwen_frames_run) and none of kernels 13-15, frames/s and RTF; beam 3
     and a batch of 4 (kernel 11); fused_decode="all" at max_frames 128
     (kernels 11, 13, 14 on talker and predictor; kernel 13's device form
     on the talker) and "mlp_q8" (kernels 11, 15); one talker step through
     "step", "all" and "mlp_q8" against fp32;
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
     random weights from seeds, no stop token), on its encode, prefill,
     step and vocode programs: encode_reference on a 6 s reference,
     requests of 32 text ids x 256 tokens in bf16 and int8 and a batch of
     4, 24 launches of kernel 11 a decode step, none of kernel 12, 12 of
     kernel 10 a vocoder call, one GPT step's logits against fp32, tokens/s
     and RTF, each pipeline's first request (warm-up and capture seconds)
     and its pool's MiB;
  10. VoxCPMPipeline at full VoxCPM-2 width (voxcpm_v2_config(): base 24 x
     1024 and residual 4 layers, 16/2 heads x 64; feature encoder 3 x 512;
     estimator 6 x 512; VAE decoder 2048 channels, 48 kHz; random weights
     from seeds), on its programs (the encode, a prefill, a step of one
     latent step and the VAE, each a CUDA graph; each pipeline's and
     key's first request prints its warm-up and capture seconds and the
     pool's MiB): the bench request (16 prompt ids, 32 target ids, 48
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
     (kernel 6, none of 7 and 8), one request over HTTP;
  12. the README's F5 usage from checkpoint files: an upstream-key
     F5TTS_v1_Base checkpoint (fp32 .safetensors, full width and depth,
     ~1.35 GB, written from a seed with numpy and the port's writer), its
     vocab.txt and a Vocos pytorch_model.bin; a 6 s 16-bit stereo reference
     at 44.1 kHz read back with read_wav(target_rate=24000) (downmix and the
     kaiser resample; the native helpers against their numpy twins);
     load_f5 and load_vocos straight to the card in bf16 (seconds, peak
     device memory, every leaf bf16 but delta_t, bitwise the CPU load cast
     and moved); the bench request from the loaded weights (212,736
     samples, 682 launches of kernels 1 and 3, 31 of kernel 2), its audio
     through write_wav and read_wav bit for bit, one DiT forward against the
     twins; a W8A8 request (682 each of kernels 1, 6, 7 and 8);
  13. text in, speech out through the CLI: upstream-key checkpoints at full
     width written from seeds in bf16 (kani-tts-370m with a NanoCodec
     .nemo, Qwen3-TTS-0.6B with its codec, IndexTTS-1.5 with a config.yaml
     at phase 9's rates and a hand-built bpe.model, VoxCPM-2), the
     tokenizer.json files from tests/fixtures, phase 12's F5 files; then
     tts_tpu_torch.cli.main in process for f5, kani, qwen, indextts and
     voxcpm --v2 with an English --text, each checked for its WAV's rate
     and length, each kernel's launches per token, frame or latent it
     generated (f5 682 each of kernels 1 and 3; kani 6 of kernel 12 a
     decode step; qwen 88 of kernel 12 a frame; indextts 24 of kernel 11
     a decode step and 12 of kernel 10 a vocoder call; voxcpm 28 of kernel
     12 a latent), the WAV bit for bit the loaded pipeline's direct call,
     and the tokenizer's ids with `regex` importable and blocked; the load
     seconds, the tokenize ms and the synthesis wall of each, beside the
     card's name and power limit;
  14. voice clone, streaming, int4 and VoxCPM's output rate: a Qwen3-TTS-0.6B
     checkpoint written from seeds (bf16) with its Mimi prompt encoder and
     speaker encoder; load_qwen_encoder and the speaker encoder to the card
     in fp32 (the talker and codec phase 7's, from seeds); encode_reference on
     phase 5d's 6 s bench reference on the card and on the CPU (codes equal
     but at near ties, the speaker embedding within 1e-4 rel L2); a
     voice-clone request from build_prefill_voice_clone (16 frames, 88
     kernel-12 launches a frame) and one talker step of its prefill against the
     twins; the Qwen bench request streamed (chunk 24, window 72, left 24)
     on its decode programs and window codec program (each a CUDA graph)
     and VoxCPM-2's on its programs (chunk 4, draws injected), each bitwise
     the window assembly over the non-streaming decode, first-chunk time and wall
     beside the non-streaming request's; VoxCPM-2 at output_sample_rate
     24000 bitwise resample_linear of the native request; kani-tts-370m,
     Qwen3-TTS-0.6B and VoxCPM-2 at quantize=4 (no launch of kernel 11 or
     12: every wqkv is int4), device time a token, frame or latent of a
     request after a warm-up one;
  15. the parity harness (tts_tpu_torch/parity): stft_diff_report on the
     card (tests/test_parity.py's signal under its limits; the 6 s bench
     reference at n_fft 1024, its errors printed); run_reference's session
     mode for all six families on phases 12-13's files (phase 8's BigVGAN
     weights in the upstream keys), against stand-in sessions that run the
     port's stage functions in fp32 through the twins: "ours" in bf16
     through the kernels, then through the bf16 twins, each stage's max|Δ|
     (F5's and BigVGAN's mel L1) on the kernels no more than STEP_SLACK
     times the twins'; F5 and BigVGAN in fp32 within the harness's 1e-2;
     each pass's launches as the routes predict (F5 682 of kernels 1 and
     3, 31 of 2 in bf16, 682 of 4 in fp32; BigVGAN 12 of kernel 10, 9 of
     its fp32 form; Qwen's predictor frame 60 of kernel 12); Kani's wav
     mode through the CLI against phase 13's WAV of the same command, mel
     L1 exactly 0; an "error" result fails the phase;
  16. the per-bucket programs (runtime/program.py: one CUDA graph per shape
     bucket, captured at the bucket's first request and replayed), each
     call against its body run eagerly on the same inputs, bitwise, with
     the eager run's launches: F5TTS_v1_Base + Vocos at the bench request
     (bucket 1408) in bf16 (kernels 1-3), W8A8 (1, 2, 6-8), int4 (1, 2),
     layer_cache_interval=2 (352 of kernel 1), fp32 (4) and fp32 W8A8 (7,
     4, 8, 6); in bf16 a second request of the bucket with its own
     ref_signal_len and duration on the same graph, a second bucket (1024
     frames), the orders A, B, A and B, A, B queued back to back on the
     shared pool, F5Pipeline.benchmark (its three queued outputs each
     bitwise the latency output, in buffers of their own) and the
     synthesize_batch program of 4 requests; BigVGAN's bench mel in bf16
     (12 of kernel 10) and fp32 (9), samples/s of replays against the
     eager body; each graph's warm-up and capture seconds and its pool's
     bytes; then the Kani decode programs at full kani-tts-370m width
     (greedy bf16 and int8, beam 5, a batch of 4; two requests each),
     every prefill, step and codec call, the first ones included, bitwise
     its eager body from the same state (outputs and state) with its
     launches (6 of kernel 12 or 11 a step); the greedy step graph's edges
     read through the driver (no programmatic edge reaches kernel 12's
     attention from a cache append); kernel 12 against its twin in a
     replayed step; then the Qwen3-TTS-0.6B decode programs (phase 7's
     seeds) on every route (default bf16 and int8, beam 3, a batch of 4 at
     max_frames 15, "all" at 128, "mlp_q8"; two requests each), every
     prefill, step and codec call, the first ones included, bitwise its
     eager body from the same state with its launches (a step: one frame
     step); the default step graph's edges read for kernel 12's
     premise (the predictor's host-position appends, copy kernels, counted
     as cache writers); kernels 12 and 13 against their twins in a
     replayed step; then the IndexTTS-1.5 programs (phase 9's seeds) at
     max_gen 24: the encode program, bf16 and int8 requests and a batch of
     4 (two each), every prefill, step, and vocode call, the first ones
     included, bitwise its eager body from the same state with its
     launches (24 of kernel 11 a step); kernel 11 against its twin in a
     replayed step and kernel 10 in a replayed vocode call; then the
     VoxCPM programs (phase 10's seeds) at 12 latents: VoxCPM-2 bf16 and
     int8 requests, a "continuation" request with its encode program, a
     stream (its decode and every window VAE call, the assembly bitwise
     synthesize_streaming) and a VoxCPM-1.5 batch of 4 (two each), every
     encode, prefill, step, VAE and window call, the first ones included,
     bitwise its eager body from the same state with its launches (28 of
     kernel 12 a solo step, 28 of kernel 11 a batch step); the bf16 step
     graph's edges read for kernel 12's premise; kernel 12 against its
     twin in a replayed step and kernel 11 in a replayed batch step.
Phases 3-15 run F5Pipeline and BigVGANVocoder on their graphs: a request's
launches are the replay's, which the capture recorded; where a phase
compares with the twins swapped in, it runs the program's body eagerly.
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
import io
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


def step_pos_cases() -> list:
    """Kernel 12's positions in phase 2's sweeps, each case's inputs from a
    generator of its own: the Kani and VoxCPM decode shapes (decode_cases:
    pos 5, 700, 2047 of 2048 rows; VOX_STEP_POS), pos 4500 of 4608 rows at
    Kani's, the Qwen3-TTS talker (pos 6, 33, 126, 639 of 640, head_dim 128)
    and predictor (pos 0, 2, 17 of 32), bf16 and int8 weights:
    [(label, args, kw)] with the host position at args[7]."""
    from tts_tpu_torch.ops.decode_step import fused_qkv_attn
    from tts_tpu_torch.quant.weight_only import quantize_int8_jit

    gen = torch.Generator("cuda").manual_seed(2601)
    cases = [(label, args, kw) for shape in ("Kani", "VoxCPM")
             for label, kernel, _, args, kw in decode_cases(gen, shape)
             if kernel is fused_qkv_attn]

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    kani = dict(heads=16, kv_heads=8, head_dim=64, eps=1e-5,
                q_norm=torch.full((64,), 64 ** -0.25, device="cuda").to(torch.bfloat16),
                k_norm=torch.full((64,), 64 ** -0.25, device="cuda").to(torch.bfloat16))
    w = rn(1024, 32 * 64, scale=0.02)
    kc, vc = rn(1, 1, 8, 4608, 64), rn(1, 1, 8, 4608, 64)
    for wt, wl in ((w, "bf16"), (quantize_int8_jit(w), "int8")):
        cases.append((f"fused_qkv_attn Kani L=1 T=4608 pos=4500 {wl}",
                      (rn(1, 1024), wt, rn(1, 64), rn(1, 64), kc, vc, 0, 4500), kani))
    n128 = torch.full((128,), 128 ** -0.25, device="cuda").to(torch.bfloat16)
    qwen = dict(heads=16, kv_heads=8, head_dim=128, q_norm=n128, k_norm=n128, eps=1e-6)
    w = rn(1024, 32 * 128, scale=0.02)
    for stack, layers, t, positions in (("talker", 28, 640, (6, 33, 126, 639)),
                                        ("predictor", 4, 32, (0, 2, 17))):
        kc, vc = rn(layers, 1, 8, t, 128, scale=128 ** -0.25), rn(layers, 1, 8, t, 128)
        for pos in positions:
            for wt, wl in ((w, "bf16"), (quantize_int8_jit(w), "int8")):
                cases.append((f"fused_qkv_attn hd128 {stack} L={layers} T={t} pos={pos} {wl}",
                              (rn(1, 1024), wt, rn(1, 128), rn(1, 128), kc, vc, layers - 1,
                               pos), qwen))
    return cases


def check_step_device_pos(res: dict) -> None:
    """Phase 2: kernel 12's device form (pos read from a device int32; the
    Kani decode programs' form) at every position of step_pos_cases: its
    three outputs bitwise the host form's at the same pos, launched for
    the largest bucket (top = T - 1) and for the tightest (top = pos); and
    against its device-form twin (every cache row, those >= pos masked) in
    fp32 within TOL, no further from fp32 than STEP_SLACK times the bf16
    device twin (check_slack). Then both forms' time a call at Kani's pos
    5 and 700 (CUDA events over a chain of 10 calls; top 2047 and pos)."""
    from tts_tpu_torch.ops.decode_step import (fused_qkv_attn, fused_qkv_attn_plain,
                                               step_bound, step_plan)

    r = res["fused_qkv_attn"]
    n = 0
    for label, args, kw in step_pos_cases():
        pos, t = args[7], args[4].shape[3]
        dev = torch.tensor(pos, dtype=torch.int32, device="cuda")
        host = fused_qkv_attn(*args, **kw)
        for top in sorted({t - 1, pos}):
            got = fused_qkv_attn(*args[:7], dev, top=top, **kw)
            same = all(torch.equal(g, h) for g, h in zip(got, host))
            print(f"  {label}: device pos, top {top}: attn, k, v "
                  f"{'bitwise the host form' if same else 'DIFFER from the host form'}",
                  flush=True)
            if not same:
                raise AssertionError(f"{label}: the device form differs from the host form")
            n += 1
        # the position rides in the closures: check_slack takes every
        # tensor argument to fp32
        r["max_abs_err"] = max(r["max_abs_err"], check_slack(
            f"{label} device pos against the device twin",
            lambda *a, dev=dev, **k: fused_qkv_attn(*a, dev, **k),
            lambda *a, dev=dev, **k: fused_qkv_attn_plain(*a, dev, **k), args[:7],
            dict(kw, top=t - 1)))
    print(f"  kernel 12's device form: {n} launches bitwise the host form's", flush=True)
    gen = torch.Generator("cuda").manual_seed(2602)
    rn = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen, device="cuda")  # noqa
                                    * scale).to(torch.bfloat16)
    nw = torch.full((64,), 64 ** -0.25, device="cuda").to(torch.bfloat16)
    kani = dict(heads=16, kv_heads=8, head_dim=64, eps=1e-5, q_norm=nw, k_norm=nw)
    x, w, cos, sin = rn(1, 1024), rn(1024, 32 * 64, scale=0.02), rn(1, 64), rn(1, 64)
    kc, vc = rn(6, 1, 8, 2048, 64), rn(6, 1, 8, 2048, 64)
    for pos in (5, 700):
        dev = torch.tensor(pos, dtype=torch.int32, device="cuda")
        host_ms = chain_ms(lambda: fused_qkv_attn(x, w, cos, sin, kc, vc, 3, pos, **kani))
        dev_ms = chain_ms(lambda: fused_qkv_attn(x, w, cos, sin, kc, vc, 3, dev, top=2047,
                                                 **kani))
        tight_ms = chain_ms(lambda: fused_qkv_attn(x, w, cos, sin, kc, vc, 3, dev, top=pos,
                                                   **kani))
        if pos == 700:
            r["dev_ms"] = dev_ms
        print(f"  {card()}: fused_qkv_attn Kani pos {pos} (CUDA events over a chain of 10): "
              f"host form {host_ms:.4f} ms a call ({step_plan(pos, 64)[0]} CTAs a kv head), "
              f"device form {dev_ms:.4f} ms at top 2047 ({step_bound(2047, 64)[0]} CTAs) and "
              f"{tight_ms:.4f} ms at top {pos}", flush=True)


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


def check_attention_device_len(res: dict) -> None:
    """Phase 2: kernel 13's device form (kv_len read from a device int32;
    the Qwen3-TTS talker programs' "all" route) at every kv_len of its
    sweep: the talker's buckets (T 768, 16/8 heads x 128: kv_len 1, 2, 17,
    64, 126, 128-130, 200, 256, 257, 384, 511-513, 640, 700, 767, 768;
    B 1 and 3) and T 640 (the bench bucket, block 128: kv_len 1, 126, 129,
    639, 640), the predictor's (T 32: kv_len 1-17); its output bitwise the
    host form's, launched for the bucket (top = T) and for the tightest
    (top = kv_len), and against its device-form twin (every row, those >=
    kv_len masked) in fp32 within TOL. Then both forms' device time a call
    at the talker's kv_len 126 and 700 (top 768 and kv_len) and the
    predictor's 17 (top 32), profiler over 10 calls."""
    from tts_tpu_torch.ops.decode_attention import (cluster_bound, cluster_plan,
                                                    decode_gqa_attention,
                                                    decode_gqa_attention_plain)

    r = res["decode_gqa_attention"]
    gen = torch.Generator("cuda").manual_seed(2701)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    talker = (1, 2, 17, 64, 126, 128, 129, 130, 200, 256, 257, 384, 511, 512, 513, 640, 700,
              767, 768)
    n = 0
    for label, b, t, lens, block in (("talker", 1, 768, talker, 256),
                                     ("talker", 3, 768, (17, 129, 513, 768), 256),
                                     ("talker bench bucket", 1, 640, (1, 126, 129, 639, 640),
                                      128),
                                     ("predictor", 1, 32, tuple(range(1, 18)), 256)):
        q, k, v = rn(b, 16, 128), rn(b, 8, t, 128), rn(b, 8, t, 128)
        for kv_len in lens:
            dev = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
            host = decode_gqa_attention(q, k, v, kv_len, block_kv=block)
            for top in sorted({t, kv_len}):
                got = decode_gqa_attention(q, k, v, dev, block_kv=block, top=top)
                if not torch.equal(got, host):
                    raise AssertionError(f"decode_gqa_attention {label} B={b} T={t} kv_len="
                                         f"{kv_len} top {top}: the device form differs from "
                                         f"the host form")
                n += 1
            r["max_abs_err"] = max(r["max_abs_err"], check(
                f"decode_gqa_attention device kv_len {label} B={b} T={t} kv_len={kv_len} "
                f"(plan {cluster_plan(kv_len)}, launched {cluster_bound(t)}) against the "
                f"device twin", decode_gqa_attention(q, k, v, dev, block_kv=block, top=t),
                decode_gqa_attention_plain(q.float(), k.float(), v.float(), dev,
                                           block_kv=block, top=t)))
    print(f"  kernel 13's device form: {n} launches bitwise the host form's", flush=True)
    name_limit = card()
    for label, t, kv_len in (("talker", 768, 126), ("talker", 768, 700), ("predictor", 32, 17)):
        q, k, v = rn(1, 16, 128), rn(1, 8, t, 128), rn(1, 8, t, 128)
        dev = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        host_ms = device_ms(lambda: decode_gqa_attention(q, k, v, kv_len))
        dev_ms = device_ms(lambda: decode_gqa_attention(q, k, v, dev, top=t))
        tight_ms = device_ms(lambda: decode_gqa_attention(q, k, v, dev, top=kv_len))
        if (label, kv_len) == ("talker", 126):
            r["dev_ms"] = dev_ms
        print(f"  {name_limit}: decode_gqa_attention {label} kv_len {kv_len} (device time a "
              f"call, profiler over 10 calls): host form {host_ms:.4f} ms "
              f"({cluster_plan(kv_len)[0]} CTAs a kv head), device form {dev_ms:.4f} ms at top "
              f"{t} ({cluster_bound(t)[0]} CTAs) and {tight_ms:.4f} ms at top {kv_len}", flush=True)


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
    check_step_device_pos(res)
    check_attention_device_len(res)
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


def eager_synthesize(pipe, ref_audio, ref_text: str, gen_text: str, noise) -> np.ndarray:
    """pipe.synthesize with its bucket's program body run eagerly
    (`Program._eager`): the twins swapped into models/f5 reach it, where a
    replay runs the kernels its capture recorded."""
    audio_p, ids_p, ref, dur, buckets, n_keep = pipe._prepare(ref_audio, ref_text, gen_text)
    pcm, _ = pipe._get_fn(*buckets)._eager(
        *pipe._inputs(audio_p, ids_p, [ref], [dur], buckets[2], None, noise))
    return pcm.cpu().numpy().reshape(-1)[:n_keep]


def eager_batch(pipe, reqs: list, seed: int) -> list:
    """pipe.synthesize_batch's outputs with the batch program's body run
    eagerly (as `eager_synthesize`)."""
    audio_p, ids_p, refs, durs, gens, frames, gen_frames = pipe._prepare_batch(reqs)
    fn = pipe._get_batch_fn(len(reqs), audio_p.shape[1], ids_p.shape[1], frames, gen_frames)
    pcm, _ = fn._eager(*pipe._inputs(audio_p, ids_p, refs, durs, frames, seed, None))
    wav = pcm.cpu().numpy()
    return [wav[b, :g * pipe.cfg.hop] for b, g in enumerate(gens)]


def rows_against_solo(pipe, reqs: list, outs: list, noise: np.ndarray,
                      eager: bool = False) -> tuple:
    """Each request's solo synthesize with its row of `noise` (the draw its
    batch row or slot took), against that row's output `outs[b]`; with
    `eager`, the solo runs through the program's eager body (twins swapped
    in). Returns ([(rel L2, max LSB)], solo walls s (eager: none), solo
    samples)."""
    diffs, walls, n = [], [], 0
    for b, r in enumerate(reqs):
        torch.cuda.synchronize()
        if eager:
            solo = eager_synthesize(pipe, *r, noise[b:b + 1])
        else:
            solo, st = pipe.synthesize(*r, noise=noise[b:b + 1])
            walls.append(st.wall_s)
        diffs.append(wav_diff(outs[b], solo))
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
        with twins_in_dit():      # eager bodies: a replay would run the kernels
            touts = eager_batch(p, reqs, F5_SEED)
            tdiffs = rows_against_solo(p, reqs, touts, noise, eager=True)[0]
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
    fora.synthesize(audio, REF_TEXT, F5_TEXTS[3])        # warm-up: the bucket's capture
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


def kani_steps(tokens: int, limit: int) -> int:
    """The decode steps a Kani request of `tokens` tokens runs on its
    programs under the limit min(cap, buf): whole replays of STEPS steps.
    At the limit, the replays that limit - 1 steps need; on a stop (tokens <
    limit: the tokens kept, then the stop token's step) the replays that
    reach it and one more, queued before the host read the flag, capped at
    the former. Steps past the stop or the limit are frozen and launch
    their kernels all the same."""
    from tts_tpu_torch.runtime.kani import STEPS

    most = -(-(limit - 1) // STEPS)
    return STEPS * (most if tokens >= limit else min(most, -(-tokens // STEPS) + 1))


def kani_programs(pipe) -> list:
    """The pipeline's decode programs: (label, Program) of each bucket's
    prefill, step and codec programs built so far."""
    out = []
    for key, dec in list(pipe._decode_cache.items()) + list(pipe._batch_fns.items()):
        out += [(f"{key} prefill {b}", p) for b, p in dec._prefill.items()]
        out += [(f"{key} step", dec.step), (f"{key} codec", dec.codec)]
    return out


def host_loop_tokens(pipe, ids: np.ndarray, n: int) -> torch.Tensor:
    """Greedy tokens of a host-driven loop on pipe's weights (the port's
    form before the decode programs: kani_step at host positions, kernel 12
    at a host pos, no penalty): (1, n) int32 on the host."""
    from tts_tpu_torch.decoding.sampling import greedy
    from tts_tpu_torch.models.kani import embed_tokens, init_state, kani_step
    from tts_tpu_torch.runtime.kani import _prefill_loop

    ids_buf = torch.zeros((1, pipe._bucket(ids.shape[1])), dtype=torch.int32, device="cuda")
    ids_buf[0, :ids.shape[1]] = torch.from_numpy(ids[0]).cuda()
    state, logits = _prefill_loop(pipe.params, ids_buf, ids.shape[1],
                                  init_state(pipe.cfg, 1, pipe.dtype, "cuda"), pipe.cfg)
    toks = [greedy(logits)]
    for _ in range(n - 1):
        logits, state = kani_step(pipe.params, embed_tokens(pipe.params, toks[-1][:, None]),
                                  state, pipe.cfg, fused=pipe._fused)
        toks.append(greedy(logits))
    return torch.stack(toks, 1).cpu()


def run_kani(name_limit: str) -> dict:
    """Phase 6: KaniPipeline.synthesize_ids at full kani-tts-370m width, on
    its decode programs. Returns the launch counts of the phase."""
    from tts_tpu_torch.models.kani import KaniConfig, init_params
    from tts_tpu_torch.models.nanocodec import NanoCodecConfig
    from tts_tpu_torch.models.nanocodec import init_params as codec_init
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.kani import STEPS, KaniDecodeConfig, KaniPipeline

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
        steps = kani_steps(tokens, KANI_NEW)
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

    for label, pipe in pipes.items():               # warm-up: each bucket's capture
        t0 = time.perf_counter()
        pipe.synthesize_ids(ids)
        first = time.perf_counter() - t0
        print(f"  {name_limit}: {label}: first request {first:.4f} s; " + "; ".join(
            f"{k} warm-up {p.warmup_s:.4f} s, capture {p.capture_s:.4f} s"
            for k, p in kani_programs(pipe)) + f"; pool {pipe._pool.nbytes() / 2**20:.1f} MiB",
              flush=True)
    t0 = time.perf_counter()
    pipes["greedy bf16"].synthesize_ids_batch(prompts)
    print(f"  {name_limit}: batch of {len(prompts)}: first request "
          f"{time.perf_counter() - t0:.4f} s; " + "; ".join(
              f"{k} warm-up {p.warmup_s:.4f} s, capture {p.capture_s:.4f} s"
              for k, p in kani_programs(pipes["greedy bf16"]) if "batch" in k)
          + f"; pool {pipes['greedy bf16']._pool.nbytes() / 2**20:.1f} MiB", flush=True)
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
        if label.startswith("greedy"):
            # the programs' tokens against the host-driven loop's: kernel
            # 12's device form is bitwise its host form, so they are equal
            got = pipe._decode_cache[pipe._buf_for(None)[2]].save[:1, :KANI_NEW].cpu()
            ref = host_loop_tokens(pipe, ids, KANI_NEW)
            same = torch.equal(got, ref)
            print(f"  {label}: {KANI_NEW} tokens of the programs against a host-driven loop "
                  f"(kernel 12 at host positions): "
                  f"{'equal' if same else f'{int((got != ref).sum())} differ'}", flush=True)
            if not same:
                raise AssertionError(f"{label}: the programs' tokens differ from the "
                                     f"host-driven loop's")
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
    print(f"  launches a request: {layers} attention layers x {kani_steps(KANI_NEW, KANI_NEW)} decode "
          f"steps ({KANI_NEW - 1} live, the rest frozen steps of the last replay of "
          f"{STEPS})", flush=True)
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


def qwen_frames_run(frames: int, cap: int) -> int:
    """The frame steps a Qwen request of `frames` kept frames (a batch: its
    longest row's) runs on its programs under the max_frames cap, one a
    replay of the step program: at the cap, cap of them; on an EOS (frames
    < cap: the kept frames, then the EOS frame) those and one more, queued
    before the host read the stop flag, at most cap. That frame is frozen
    and launches its kernels all the same."""
    return cap if frames >= cap else min(cap, frames + 2)


def qwen_programs(pipe) -> list:
    """The pipeline's programs built so far: (label, Program) of each decode
    bucket's prefill and step programs (the streams' too) and each codec
    program."""
    out = []
    decs = list(pipe._decode_fn.items()) + list(pipe._batch_fns.items()) + [
        (k, v) for k, v in pipe._codec_cache.items() if isinstance(v, list)]
    for key, held in decs:
        for i, dec in enumerate(held):
            out += [(f"{key}.{i} prefill", dec.prefill), (f"{key}.{i} step", dec.step)]
    out += [(f"codec {key}", v) for key, v in pipe._codec_cache.items()
            if not isinstance(v, list)]
    return out


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

    def checked(label, fn, cap, per, rows=1, pipe=None):
        """Run fn() -> (list of int16 waveforms, stats) on the pipeline's
        programs; check the audio and per[k] launches of each kernel k a
        frame step the programs ran (qwen_frames_run). Returns (stats, wall,
        launches)."""
        before = dict(LAUNCHES)
        first = pipe is not None and not qwen_programs(pipe)
        t0 = time.perf_counter()
        wavs, st = fn()
        wall = time.perf_counter() - t0
        grew = {k: LAUNCHES[k] - before.get(k, 0) for k in QWEN_KERNELS}
        frames = [len(w) // up for w in wavs]
        n_it = qwen_frames_run(max(frames), cap)
        progs = qwen_programs(pipe) if pipe is not None else []
        if pipe is not None and (not progs or any(pr._graph is None for _, pr in progs)):
            raise AssertionError(f"{label}: a program of the request is not a CUDA graph")
        how = ("; the first request: warm-up " + ", ".join(
            f"{k} {pr.warmup_s:.3f} s + capture {pr.capture_s:.3f} s" for k, pr in progs) +
            f", pool {pipe._pool.nbytes() / 2**20:.1f} MiB") if first else ""
        print(f"  {label}: frames {frames} ({sum(len(w) for w in wavs)} int16 samples), "
              f"{n_it} frame steps on the programs, wall {wall:.4f} s, peak |wav| "
              f"{st.get('peak', float('nan')):.6g}, "
              f"launches {grew}{how}", flush=True)
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
    for label, pipe in pipes.items():               # warm-up: the first request
        checked(f"bench request {label}, default route, the first", single(pipe),
                QWEN_FRAMES, {"fused_qkv_attn": per_iter}, pipe=pipe)
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
            {"fused_qkv_attn": talker, "fused_qkv_rope": beam_pred}, pipe=beam)
    small = QwenTTSPipeline(params, cfg, cparams, ccfg, dec(max_frames=8))
    prompts = [QWEN_IDS, np.arange(5, 20, dtype=np.int32)[None],
               np.arange(40, 90, dtype=np.int32)[None], np.array([[7, 1, 4]], np.int32)]
    reqs = [small.build_prefill_embeds(i, QWEN_LANG) for i in prompts]
    checked("batch of 4, 8 frames", lambda: small.synthesize_from_prefill_batch(reqs), 8,
            {"fused_qkv_rope": per_iter}, rows=4, pipe=small)

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
        st, wall, grew = checked(label, single(pipe), cap, per, pipe=pipe)
        print(f"  {name_limit}: Qwen {label}: {st['frames'] / wall:.2f} frames/s, RTF "
              f"{wall / (st['frames'] / 12.0):.6f} (first call: warm-up and capture "
              f"included)", flush=True)
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
    """One GPT decode step from the state the bench request's prefill
    program left, through kernel 11 (the route every decode step takes) in
    bf16, against the plain route in bf16 and in fp32 (params and cache
    cast): as check_step for Kani, the kernel route's error at most
    STEP_SLACK times the plain route's."""
    from tts_tpu_torch.kv.cache import KVCache
    from tts_tpu_torch.models.indextts import gpt_step

    cfg, gpt = pipe.cfg, pipe.params["gpt"]
    with pipe._held(1, INDEX_IDS.shape[1], INDEX_GEN, ref[0].dtype) as dec:
        dec.prefill(ref[0], INDEX_IDS, np.array([INDEX_IDS.shape[1]], np.int32))
        kv = KVCache(dec.k.clone(), dec.v.clone(), dec.p_len)
        kv_valid, vec = dec.kv_valid.clone(), dec.vec.clone()
        h = (gpt["mel_embed"][dec.tok] + gpt["mel_pos"][1][None])[:, None]

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


def index_audio(rate: int) -> np.ndarray:
    """The 6 s synthetic IndexTTS reference (int16) of phases 9 and 16."""
    tt = np.arange(6 * rate) / rate
    rng = np.random.default_rng(12)
    sig = (0.3 * np.sin(2 * np.pi * 220 * tt) * (1 + np.sin(2 * np.pi * 3 * tt))
           + 0.1 * np.sin(2 * np.pi * 330 * tt) + 0.05 * rng.standard_normal(tt.size))
    return (sig * 12000).astype(np.int16)


def index_programs(pipe) -> list:
    """The IndexTTS pipeline's programs built so far: (label, Program) of
    each encode bucket, each decode key's prefill and step programs and
    each vocode bucket."""
    out = [(f"encode {k}", v) for k, v in pipe._enc_cache.items()]
    for key, held in pipe._dec_cache.items():
        for i, dec in enumerate(held):
            out += [(f"{key}.{i} prefill", dec.prefill), (f"{key}.{i} step", dec.step)]
    return out + [(f"vocode {k}", v) for k, v in pipe._voc_cache.items()]


def run_indextts(name_limit: str) -> tuple:
    """Phase 9: IndexTTSPipeline at full IndexTTS-1.5 width, on its
    programs (encode, prefill, step and vocode; the first request of each
    pipeline captures them). Returns the launch counts of the bf16 request,
    the bf16 pipeline and reference, and the arguments the bf16 request's
    vocode program took."""
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.indextts import STEPS, IndexTTSPipeline

    cfg, vcfg, params = indextts_models()
    rate = vcfg.sample_rate
    audio = index_audio(rate)
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
    # decode steps a request at the cap runs: whole replays of STEPS
    steps = STEPS * -(-(INDEX_GEN - 1) // STEPS)

    def checked(label, fn, rows):
        before = dict(LAUNCHES)
        wavs, tokens, wall = fn()
        grew = {k: LAUNCHES[k] - before.get(k, 0) for k in names}
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

    for label, pipe in pipes.items():               # warm-up: the programs' captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.synthesize_ids(INDEX_IDS, ref, max_gen=INDEX_GEN)
        torch.cuda.synchronize()
        progs = index_programs(pipe)
        print(f"  {name_limit}: IndexTTS {label} first request {time.perf_counter() - t0:.3f} "
              f"s: {len(progs)} programs, warm-up "
              f"{sum(p.warmup_s for _, p in progs):.3f} s, capture "
              f"{sum(p.capture_s for _, p in progs):.3f} s, pool "
              f"{pipe._pool.nbytes() / 2**20:.1f} MiB", flush=True)
    vocoded = []                  # the vocode programs' arguments, by call
    real_vocoder = pipes["bf16"]._vocoder

    def vocoder(*a):
        prog = real_vocoder(*a)

        def call(h, n, cond_embed, *conds):
            vocoded.append((h.clone(), [int(f) for f in n], h.shape[1], cond_embed.clone(),
                            [c.clone() for c in conds]))
            return prog(h, n, cond_embed, *conds)
        return call

    pipes["bf16"]._vocoder = vocoder
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
    print(f"  IndexTTS bf16 pipeline: programs {[k for k, _ in index_programs(pipes['bf16'])]}, "
          f"one pool of {pipes['bf16']._pool.nbytes() / 2**20:.1f} MiB", flush=True)
    del pipes["bf16"]._vocoder
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


def vox_audio(rate: int) -> np.ndarray:
    """The 6 s synthetic VoxCPM prompt (int16) of phases 10 and 16."""
    tt = np.arange(6 * rate) / rate
    rng = np.random.default_rng(16)
    sig = (0.3 * np.sin(2 * np.pi * 220 * tt) * (1 + np.sin(2 * np.pi * 3 * tt))
           + 0.1 * np.sin(2 * np.pi * 330 * tt) + 0.05 * rng.standard_normal(tt.size))
    return (sig * 12000).astype(np.int16)


def vox_programs(pipe) -> list:
    """The VoxCPM pipeline's programs built so far: (label, Program) of each
    encode bucket, each decode key's prefill and step programs (a request's
    and a batch's) and each VAE bucket (the whole buffer's, a stream
    window's)."""
    out = [(f"encode {k}", v) for k, v in pipe._enc_cache.items()]
    for table in (pipe._dec_cache, pipe._batch_fns):
        for key, held in table.items():
            for i, dec in enumerate(held):
                out += [(f"{key}.{i} prefill", dec.prefill), (f"{key}.{i} step", dec.step)]
    return out + [(f"VAE {k}", v) for k, v in pipe._voc_cache.items()] + [
        (f"window VAE {k}", v) for k, v in pipe._vae_dec_cache.items()]


def run_voxcpm(name_limit: str) -> tuple:
    """Phase 10: VoxCPMPipeline at full width, on its programs (encode,
    prefill, step and VAE; the first request of each pipeline and key
    captures them). VoxCPM-2 (voxcpm_v2_config():
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
    prompt_audio = vox_audio(cfg2.sample_rate)
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

    warm = [(label, pipe, single(pipe)) for label, pipe in pipes.items()] + [
        ("VoxCPM-2 bf16 continuation", pipes["VoxCPM-2 bf16"], continuation),
        ("VoxCPM-1.5 batch of 8", pipe15, lambda: pipe15.synthesize_ids_batch(batch))]
    for label, pipe, fn in warm:                    # warm-up: the programs' captures
        before = {id(p) for _, p in vox_programs(pipe)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        progs = [(k, p) for k, p in vox_programs(pipe) if id(p) not in before]
        print(f"  {name_limit}: {label} first request {time.perf_counter() - t0:.3f} s: "
              f"{len(progs)} programs {[k for k, _ in progs]}, warm-up "
              f"{sum(p.warmup_s for _, p in progs):.3f} s, capture "
              f"{sum(p.capture_s for _, p in progs):.3f} s, pool "
              f"{pipe._pool.nbytes() / 2**20:.1f} MiB", flush=True)
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
        tdiffs = rows_against_solo(pipe, reqs[:SERVE_SLOTS], touts, noise, eager=True)[0]
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


# --------------------------------------------------------------------------
# Phase 12: the README's F5 usage from checkpoint files

# F5TTS_v1_Base's vocab.txt has 2,545 lines (F5Config's vocab_size)
F5_VOCAB_LINES = 2545
REF_RATE = 44100


def _f5_upstream_keys(cfg) -> list:
    """(key, shape, init) of an upstream F5TTS_v1_Base DiT under
    ema_model.transformer.*: "w" a N(0, 0.02) weight, "0" zeros, "1" ones."""
    d, td, tm, inner = cfg.dim, cfg.text_dim, cfg.text_dim * cfg.conv_mult, cfg.inner_dim
    t = "transformer"
    keys = [(f"{t}.text_embed.text_embed.weight", (cfg.vocab_size + 1, td), "w")]
    for i in range(cfg.conv_layers):
        p = f"{t}.text_embed.text_blocks.{i}"
        keys += [(f"{p}.dwconv.weight", (td, 1, 7), "w"), (f"{p}.dwconv.bias", (td,), "0"),
                 (f"{p}.norm.weight", (td,), "1"), (f"{p}.norm.bias", (td,), "0"),
                 (f"{p}.pwconv1.weight", (tm, td), "w"), (f"{p}.pwconv1.bias", (tm,), "0"),
                 (f"{p}.grn.gamma", (1, 1, tm), "0"), (f"{p}.grn.beta", (1, 1, tm), "0"),
                 (f"{p}.pwconv2.weight", (td, tm), "w"), (f"{p}.pwconv2.bias", (td,), "0")]
    keys += [(f"{t}.input_embed.proj.weight", (d, 2 * cfg.n_mels + td), "w"),
             (f"{t}.input_embed.proj.bias", (d,), "0")]
    for j in (0, 2):
        keys += [(f"{t}.input_embed.conv_pos_embed.conv1d.{j}.weight", (d, d // 16, 31), "w"),
                 (f"{t}.input_embed.conv_pos_embed.conv1d.{j}.bias", (d,), "0")]
    for i in range(cfg.depth):
        p = f"{t}.transformer_blocks.{i}"
        keys += [(f"{p}.attn_norm.linear.weight", (6 * d, d), "w"),
                 (f"{p}.attn_norm.linear.bias", (6 * d,), "0")]
        for nm in ("to_q", "to_k", "to_v"):
            keys += [(f"{p}.attn.{nm}.weight", (inner, d), "w"),
                     (f"{p}.attn.{nm}.bias", (inner,), "0")]
        keys += [(f"{p}.attn.to_out.0.weight", (d, inner), "w"),
                 (f"{p}.attn.to_out.0.bias", (d,), "0"),
                 (f"{p}.ff.ff.0.0.weight", (cfg.ff_mult * d, d), "w"),
                 (f"{p}.ff.ff.0.0.bias", (cfg.ff_mult * d,), "0"),
                 (f"{p}.ff.ff.2.weight", (d, cfg.ff_mult * d), "w"),
                 (f"{p}.ff.ff.2.bias", (d,), "0")]
    keys += [(f"{t}.norm_out.linear.weight", (2 * d, d), "w"),
             (f"{t}.norm_out.linear.bias", (2 * d,), "0"),
             (f"{t}.proj_out.weight", (cfg.n_mels, d), "w"), (f"{t}.proj_out.bias", (cfg.n_mels,), "0"),
             (f"{t}.time_embed.time_mlp.0.weight", (d, cfg.freq_embed_dim), "w"),
             (f"{t}.time_embed.time_mlp.0.bias", (d,), "0"),
             (f"{t}.time_embed.time_mlp.2.weight", (d, d), "w"),
             (f"{t}.time_embed.time_mlp.2.bias", (d,), "0")]
    return keys


def _init(rng, shape, kind) -> np.ndarray:
    if kind == "w":
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(0.02)
        return a
    return (np.zeros if kind == "0" else np.ones)(shape, np.float32)


def write_f5_checkpoint(dirname: str, cfg, seed: int) -> tuple:
    """An upstream-key F5TTS_v1_Base checkpoint from a seed, numpy only:
    `model_1250000.safetensors` (fp32 ema_model.transformer.* with
    ema_model.initted / step and the mel_spec buffers, through the port's
    writer) and a vocab.txt of cfg.vocab_size lines (" ", printable ASCII,
    then filler tokens). Returns (checkpoint, vocab, bytes)."""
    from tts_tpu_torch.weights import write_safetensors

    rng = np.random.default_rng(seed)
    sd = {f"ema_model.{k}": _init(rng, shape, kind) for k, shape, kind in _f5_upstream_keys(cfg)}
    sd["ema_model.initted"] = np.asarray(True)
    sd["ema_model.step"] = np.asarray(1250000, np.int64)
    sd["ema_model.mel_spec.mel_stft.mel_scale.fb"] = np.zeros((cfg.n_fft // 2 + 1, cfg.n_mels),
                                                             np.float32)
    sd["ema_model.mel_spec.mel_stft.spectrogram.window"] = np.hanning(cfg.win_length).astype(
        np.float32)
    ckpt = os.path.join(dirname, "model_1250000.safetensors")
    write_safetensors(ckpt, sd)
    chars = [" "] + [chr(c) for c in range(33, 127)]
    chars += [f"<f{i}>" for i in range(cfg.vocab_size - len(chars))]
    vocab = os.path.join(dirname, "vocab.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("".join(c + "\n" for c in chars))
    return ckpt, vocab, os.path.getsize(ckpt)


def write_vocos_checkpoint(dirname: str, vcfg, seed: int) -> str:
    """A charactr/vocos-mel-24khz style dir from a seed: pytorch_model.bin
    (torch.save) in the upstream keys, layer-scale gammas and the
    feature_extractor buffers included."""
    rng = np.random.default_rng(seed)
    d, inter = vcfg.dim, vcfg.intermediate_dim
    keys = [("backbone.embed.weight", (d, vcfg.input_channels, 7), "w"),
            ("backbone.embed.bias", (d,), "0"), ("backbone.norm.weight", (d,), "1"),
            ("backbone.norm.bias", (d,), "0")]
    for i in range(vcfg.num_layers):
        p = f"backbone.convnext.{i}"
        keys += [(f"{p}.dwconv.weight", (d, 1, 7), "w"), (f"{p}.dwconv.bias", (d,), "0"),
                 (f"{p}.norm.weight", (d,), "1"), (f"{p}.norm.bias", (d,), "0"),
                 (f"{p}.pwconv1.weight", (inter, d), "w"), (f"{p}.pwconv1.bias", (inter,), "0"),
                 (f"{p}.pwconv2.weight", (d, inter), "w"), (f"{p}.pwconv2.bias", (d,), "0")]
    keys += [("backbone.final_layer_norm.weight", (d,), "1"),
             ("backbone.final_layer_norm.bias", (d,), "0"),
             ("head.out.weight", (vcfg.n_fft + 2, d), "w"), ("head.out.bias", (vcfg.n_fft + 2,), "0"),
             ("feature_extractor.mel_spec.spectrogram.window", (vcfg.n_fft,), "1"),
             ("feature_extractor.mel_spec.mel_scale.fb", (vcfg.n_fft // 2 + 1, vcfg.input_channels),
              "0")]
    sd = {k: torch.from_numpy(_init(rng, shape, kind)) for k, shape, kind in keys}
    for i in range(vcfg.num_layers):
        sd[f"backbone.convnext.{i}.gamma"] = torch.from_numpy(
            (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    path = os.path.join(dirname, "vocos")
    os.makedirs(path, exist_ok=True)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    return path


def write_stereo_reference(path: str, seconds: float, seed: int) -> np.ndarray:
    """A 16-bit stereo WAV at 44.1 kHz of noise (each channel its own).
    Returns its (frames, 2) samples."""
    import wave

    frames = (np.random.default_rng(seed).standard_normal((int(seconds * REF_RATE), 2))
              * 3000).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(REF_RATE)
        f.writeframes(frames.tobytes())
    return frames


def check_native(frames: np.ndarray, audio: np.ndarray) -> None:
    """The native host helpers against their numpy twins on the reference's
    samples, and read_wav's 24 kHz audio against the twins' composition."""
    from tts_tpu_torch import native
    from tts_tpu_torch.audio.wav import resample_kaiser

    if not native.native_available():
        raise AssertionError("the native audio helpers did not build (cc)")
    mono = native.downmix_to_mono(frames)
    if not np.array_equal(mono, native.downmix_to_mono_plain(frames)):
        raise AssertionError("native downmix differs from its twin")
    if not np.array_equal(audio, resample_kaiser(native.downmix_to_mono_plain(frames),
                                                 REF_RATE, 24000)):
        raise AssertionError("read_wav(target_rate=24000) differs from the twins' composition")
    x = native.pcm16_to_f32(mono)
    errs = {
        "pcm16_to_f32": float(np.abs(x - native.pcm16_to_f32_plain(mono)).max()),
        "f32_to_pcm16": int(np.abs(native.f32_to_pcm16(x).astype(np.int32)
                                   - native.f32_to_pcm16_plain(x)).max()),
        "resample_linear": float(np.abs(native.resample_linear(x, REF_RATE, 24000)
                                        - native.resample_linear_plain(x, REF_RATE, 24000)).max()),
        "rms_normalize": float(np.abs(native.rms_normalize(x) - native.rms_normalize_plain(x)).max()),
    }
    # conversions and downmix bit for bit; the resample interpolates in
    # float64 (C) or from linspace positions (numpy), the RMS sums in float64
    # or fp32: a few fp32 ulps of |x| < 1
    limits = {"pcm16_to_f32": 0.0, "f32_to_pcm16": 0, "resample_linear": 1e-6,
              "rms_normalize": 1e-6}
    print(f"  native helpers against their numpy twins (max |diff|): {errs}, downmix and "
          f"read_wav's kaiser resample bitwise", flush=True)
    bad = {k: v for k, v in errs.items() if v > limits[k]}
    if bad:
        raise AssertionError(f"native helpers off their twins: {bad}")
    # host ms of each helper and its twin on the reference's samples (best of 7)
    calls = {"downmix_to_mono": (frames,), "pcm16_to_f32": (mono,), "f32_to_pcm16": (x,),
             "resample_linear": (x, REF_RATE, 24000), "rms_normalize": (x,)}
    times = {}
    for name, a in calls.items():
        pair = (getattr(native, name), getattr(native, name + "_plain"))
        times[name] = [round(min(_host_ms(fn, *a) for _ in range(7)), 4) for fn in pair]
    print(f"  native helpers' host ms against their twins' ([native, numpy], best of 7, "
          f"{len(frames)} stereo frames): {times}", flush=True)


def _host_ms(fn, *args) -> float:
    t0 = time.perf_counter()
    fn(*args)
    return (time.perf_counter() - t0) * 1e3


def check_loaded(label: str, tree: dict, ref: dict, keep_fp32=()) -> int:
    """Every leaf of a loaded tree on the card, bf16 but the keep_fp32 keys,
    and bitwise the same as `ref`. Returns the tree's bytes."""
    from tts_tpu_torch.models._params import tree_map

    leaves = {}
    tree_map(lambda path, t: leaves.setdefault("/".join(path), t), tree)
    refs = {}
    tree_map(lambda path, t: refs.setdefault("/".join(path), t), ref)
    if set(leaves) != set(refs):
        raise AssertionError(f"{label}: the trees' keys differ")
    for k, t in leaves.items():
        want = torch.float32 if k.split("/")[-1] in keep_fp32 else torch.bfloat16
        if t.device.type != "cuda" or t.dtype != want:
            raise AssertionError(f"{label}: {k} is {t.dtype} on {t.device}")
        if not torch.equal(t, refs[k]):
            raise AssertionError(f"{label}: {k} differs from the CPU load moved")
    return sum(nbytes(t) for t in leaves.values())


def run_checkpoints(name_limit: str, tmp: str) -> tuple:
    """Phase 12: write an upstream F5TTS_v1_Base checkpoint, a Vocos one and
    a stereo 44.1 kHz reference into `tmp`; read the reference at 24 kHz;
    load both checkpoints straight to the card in bf16; run the bench
    request and a W8A8 request from the loaded weights; write the audio and
    read it back. Returns the launches of the two requests and the files
    (phase 13 reads them)."""
    from tts_tpu_torch.audio.wav import read_wav, write_wav
    from tts_tpu_torch.models.f5 import F5Config, F5Model
    from tts_tpu_torch.models.vocos import VocosConfig, VocosModel
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.f5 import F5Pipeline
    from tts_tpu_torch.weights import load_f5, load_vocos

    cfg, vcfg = F5Config(vocab_size=F5_VOCAB_LINES), VocosConfig()
    t0 = time.perf_counter()
    ckpt, vocab_path, size = write_f5_checkpoint(tmp, cfg, seed=20)
    vdir = write_vocos_checkpoint(tmp, vcfg, seed=21)
    ref_path = os.path.join(tmp, "ref.wav")
    frames = write_stereo_reference(ref_path, 6.0, seed=22)
    print(f"  wrote {ckpt.split(os.sep)[-1]} ({size / 2**30:.3f} GiB fp32, F5 dim "
          f"{cfg.dim} depth {cfg.depth} heads {cfg.heads}x{cfg.head_dim}), vocab.txt "
          f"({cfg.vocab_size} lines), vocos/pytorch_model.bin and a 6 s stereo "
          f"{REF_RATE} Hz reference in {time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    audio, rate = read_wav(ref_path, target_rate=24000)
    print(f"  read_wav(target_rate=24000): {len(audio)} int16 samples at {rate} Hz in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if rate != 24000 or audio.dtype != np.int16 or len(audio) != 6 * 24000:
        raise AssertionError(f"read_wav gave {len(audio)} {audio.dtype} samples at {rate}")
    check_native(frames, audio)

    loads = {}
    for name, fn in (("load_f5", lambda: load_f5(ckpt, vocab_path, dtype=torch.bfloat16,
                                                 device="cuda")),
                     ("load_vocos", lambda: load_vocos(vdir, dtype=torch.bfloat16,
                                                       device="cuda"))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        loads[name] = (out, seconds, torch.cuda.max_memory_allocated() - base)
    (params, lcfg, vocab), f5_s, f5_peak = loads["load_f5"]
    (vparams, lvcfg), vocos_s, vocos_peak = loads["load_vocos"]
    if lcfg != cfg or len(vocab) != cfg.vocab_size:
        raise AssertionError(f"load_f5 gave {lcfg} and {len(vocab)} vocab entries")

    # the same files loaded on the CPU in bf16 (delta_t kept fp32) and moved
    t0 = time.perf_counter()
    cpu, _, _ = load_f5(ckpt, vocab_path, dtype=torch.bfloat16, device="cpu")
    cpu_s = time.perf_counter() - t0
    f5_bytes = check_loaded("load_f5", params, F5Model(cfg, cpu).to("cuda").params,
                            keep_fp32=F5Model.keep_fp32)
    vcpu, _ = load_vocos(vdir, dtype=torch.bfloat16, device="cpu")
    vocos_bytes = check_loaded("load_vocos", vparams, VocosModel(vcfg, vcpu).to("cuda").params)
    del cpu, vcpu
    print(f"  {name_limit}: load_f5 to the card in bf16 {f5_s:.3f} s (bf16 to the CPU "
          f"{cpu_s:.3f} s), peak device memory during the load {f5_peak / 2**20:.1f} MiB "
          f"for a {f5_bytes / 2**20:.1f} MiB tree; load_vocos {vocos_s:.3f} s, peak "
          f"{vocos_peak / 2**20:.1f} MiB for {vocos_bytes / 2**20:.1f} MiB; every leaf on "
          f"the card in bf16 (delta_t fp32), bitwise the CPU load moved", flush=True)
    # an fp32 copy on the card would double the peak
    for name, peak, tree in (("load_f5", f5_peak, f5_bytes),
                             ("load_vocos", vocos_peak, vocos_bytes)):
        if peak > 1.25 * tree:
            raise AssertionError(f"{name}: peak {peak} bytes for a {tree}-byte tree")

    pipe = F5Pipeline(F5Model(cfg, params), vocab, VocosModel(lvcfg, vparams))
    out_path = os.path.join(tmp, "out.wav")
    gen_text = " ".join(["word"] * 15)
    launches: dict = {}
    for label, p, per_step in (
            ("bf16", pipe, {"flash_attention_flat": cfg.depth, "mlp_block_fused": cfg.depth,
                            "conv_pos_embed_fused": 1}),
            ("w8a8", F5Pipeline(pipe.f5, vocab, pipe.vocos, quantize="w8a8"),
             {"flash_attention_flat": cfg.depth, "conv_pos_embed_fused": 1,
              **dict.fromkeys(Q8_KERNELS, cfg.depth)})):
        p.synthesize(audio, REF_TEXT, "word word")              # warm-up
        torch.cuda.synchronize()
        LAUNCHES.clear()
        wav, stats = p.synthesize(audio, REF_TEXT, gen_text)
        grew = {k: LAUNCHES.get(k, 0) for k in KERNELS}
        print(f"  {name_limit}: {label} bench request (15 words) from the loaded weights: "
              f"{len(wav)} int16 samples, wall {stats.wall_s:.4f} s, RTF {stats.rtf:.6f}, "
              f"peak |wav| {stats.peak:.6g}, launches "
              f"{ {k: n for k, n in grew.items() if n} }", flush=True)
        if wav.dtype != np.int16 or len(wav) != BENCH_SAMPLES:
            raise AssertionError(f"{label}: {len(wav)} {wav.dtype} samples, expected "
                                 f"{BENCH_SAMPLES} int16")
        if not math.isfinite(stats.peak) or not wav.any():
            raise AssertionError(f"{label}: the waveform is not finite or all zeros")
        for k in KERNELS:
            want = per_step.get(k, 0) * (cfg.nfe_steps - 1)
            if grew[k] != want:
                raise AssertionError(f"{label}: {k} launched {grew[k]} times, expected "
                                     f"{want}")
        for k, n in grew.items():
            launches[k] = launches.get(k, 0) + n
        bench = p.benchmark(ref_seconds=6.0, gen_words=15, iters=3)
        print(f"  {name_limit}: {label} from the loaded weights, F5Pipeline.benchmark: "
              f"latency RTF {bench['rtf']:.6f} ({bench['wall_s']:.4f} s for "
              f"{bench['audio_s']:.3f} s of audio), sustained RTF "
              f"{bench['sustained_rtf']:.6f}", flush=True)
        if label == "bf16":
            write_wav(out_path, wav, cfg.sample_rate)
            back, rate = read_wav(out_path)
            if rate != cfg.sample_rate or not np.array_equal(back, wav):
                raise AssertionError("write_wav -> read_wav did not give the audio back")
            print("  write_wav -> read_wav: the bench request's audio back bit for bit",
                  flush=True)
            check_bf16_forward(pipe, 1408, 1396, "loaded bf16")
    return launches, {"ckpt": ckpt, "vocab": vocab_path, "vocoder": vdir, "ref": ref_path}


# --------------------------------------------------------------------------
# Phase 13: text in, speech out through the CLI

CLI_TEXT = "Hello from the card. The port turns text into speech."
# the caps each command gets (random weights may stop earlier)
CLI_CAPS = {"kani": 96, "qwen": 16, "indextts": 48, "voxcpm": 16}
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")


class CkptWriter:
    """An upstream-key state dict drawn on the card from one seeded
    generator, each tensor kept on the host in bf16 (the loaders upcast bf16
    exactly to fp32). `w` is N(0, (gain / sqrt(fan))^2), fan the product of
    the dims past the first unless given; `one` 1 + N(0, 0.05^2); `zero`
    N(0, 0.02^2); `pos` 0.5 + |N(0, 0.1^2)|."""

    def __init__(self, seed: int):
        self.g = torch.Generator("cuda").manual_seed(seed)
        self.sd: dict = {}

    def _randn(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.g, device="cuda")

    def _put(self, key: str, t: torch.Tensor) -> None:
        self.sd[key] = t.to(torch.bfloat16).cpu()

    def w(self, key, *shape, gain=1.0, fan=None) -> None:
        fan = fan or math.prod(shape[1:]) or 1
        self._put(key, self._randn(shape) * (gain / math.sqrt(fan)))

    def one(self, key, *shape) -> None:
        self._put(key, 1.0 + 0.05 * self._randn(shape))

    def zero(self, key, *shape) -> None:
        self._put(key, 0.02 * self._randn(shape))

    def pos(self, key, *shape) -> None:
        self._put(key, 0.5 + 0.1 * self._randn(shape).abs())

    def lin(self, pre, cout, cin, bias=True, gain=1.0) -> None:
        self.w(f"{pre}.weight", cout, cin, gain=gain)
        if bias:
            self.zero(f"{pre}.bias", cout)

    def conv(self, pre, cin, cout, k, transposed=False, stride=1, gain=1.0, bias=True) -> None:
        """A Conv1d (out, in, k) or ConvTranspose1d (in, out, k) plain weight;
        a transposed output sums cin * k / stride taps."""
        shape = (cin, cout, k) if transposed else (cout, cin, k)
        self.w(f"{pre}.weight", *shape, gain=gain, fan=max(1, cin * k // stride))
        if bias:
            self.zero(f"{pre}.bias", cout)

    def ln(self, pre, n) -> None:
        self.one(f"{pre}.weight", n)
        self.zero(f"{pre}.bias", n)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.sd.values())


def _spm_model(pieces: list) -> bytes:
    """A SentencePiece ModelProto (BPE, identity normalizer, dummy prefix)
    from (piece, score, type) triples, in the protobuf wire format."""
    import struct

    def varint(v):
        out = bytearray()
        while True:
            b, v = v & 0x7F, v >> 7
            out.append(b | 0x80 if v else b)
            if not v:
                return bytes(out)

    def field(num, wire, body):
        return varint((num << 3) | wire) + body

    def length(num, raw):
        return field(num, 2, varint(len(raw)) + raw)

    data = b""
    for piece, score, typ in pieces:
        body = length(1, piece.encode()) + field(2, 5, struct.pack("<f", score))
        if typ != 1:
            body += field(3, 0, varint(typ))
        data += length(1, body)
    data += length(2, field(3, 0, varint(2)) + field(40, 0, varint(0)))
    data += length(3, length(1, b"identity") + field(3, 0, varint(1)))
    return data


def write_kani_checkpoint(dirname: str, cfg, ccfg, seed: int) -> tuple:
    """kani-tts-370m in the LFM2 keys (tied embeddings, config.json,
    `bf16 model.safetensors`), tests/fixtures/gpt2_style.json as its
    tokenizer.json, and nemo-nano-codec-22khz-0.6kbps-12.5fps as a `.nemo`
    tar (model_config.yaml + model_weights.ckpt; HalfSnake alphas of C / 2).
    Returns (the LM dir, the .nemo path, bytes written)."""
    import shutil
    import tarfile

    import yaml

    from tts_tpu_torch.weights import write_safetensors

    os.makedirs(dirname, exist_ok=True)
    w = CkptWriter(seed)
    hs, hd, ff = cfg.hidden_size, cfg.head_dim, cfg.ffn_dim
    w.w("model.embed_tokens.weight", cfg.vocab_size, hs, fan=1)
    w.one("model.embedding_norm.weight", hs)
    for i, lt in enumerate(cfg.layer_types):
        p = f"model.layers.{i}"
        w.one(f"{p}.operator_norm.weight", hs)
        w.one(f"{p}.ffn_norm.weight", hs)
        w.lin(f"{p}.feed_forward.w1", ff, hs, bias=False)
        w.lin(f"{p}.feed_forward.w3", ff, hs, bias=False)
        w.lin(f"{p}.feed_forward.w2", hs, ff, bias=False, gain=0.5)
        if lt == "attn":
            a = f"{p}.self_attn"
            w.lin(f"{a}.q_proj", cfg.num_heads * hd, hs, bias=False)
            w.lin(f"{a}.k_proj", cfg.num_kv_heads * hd, hs, bias=False)
            w.lin(f"{a}.v_proj", cfg.num_kv_heads * hd, hs, bias=False)
            w.lin(f"{a}.out_proj", hs, cfg.num_heads * hd, bias=False, gain=0.5)
            w.one(f"{a}.q_layernorm.weight", hd)
            w.one(f"{a}.k_layernorm.weight", hd)
        else:
            w.lin(f"{p}.conv.in_proj", 3 * hs, hs, bias=False)
            w.w(f"{p}.conv.conv.weight", hs, 1, cfg.conv_kernel)
            w.lin(f"{p}.conv.out_proj", hs, hs, bias=False, gain=0.5)
    write_safetensors(os.path.join(dirname, "model.safetensors"), w.sd)
    config = {"layer_types": ["full_attention" if t == "attn" else "conv"
                              for t in cfg.layer_types],
              "hidden_size": hs, "num_attention_heads": cfg.num_heads,
              "num_key_value_heads": cfg.num_kv_heads, "head_dim": hd, "block_ff_dim": ff,
              "vocab_size": cfg.vocab_size, "conv_L_cache": cfg.conv_kernel,
              "rope_theta": cfg.rope_base, "norm_eps": cfg.rms_eps}
    with open(os.path.join(dirname, "config.json"), "w") as f:
        json.dump(config, f)
    shutil.copy(os.path.join(FIXTURES, "gpt2_style.json"), os.path.join(dirname, "tokenizer.json"))

    c = CkptWriter(seed + 1)
    d = "audio_decoder"
    rates = ccfg.up_sample_rates
    ch = [ccfg.base_channels // 2 ** i for i in range(len(rates) + 1)]

    def act(pre, n):
        c.pos(f"{pre}.snake_act.alpha", 1, n // 2, 1)

    c.conv(f"{d}.pre_conv.conv", ccfg.input_dim, ch[0], ccfg.pre_kernel)
    for i, r in enumerate(rates):
        act(f"{d}.activations.{i}", ch[i])
        c.conv(f"{d}.up_sample_conv_layers.{i}.conv", ch[i], ch[i + 1], 2 * r,
               transposed=True, stride=r)
        for j, k in enumerate(ccfg.kernel_sizes):
            rb = f"{d}.res_layers.{i}.res_blocks.{j}.res_blocks"
            for m, _ in enumerate(ccfg.dilations):
                act(f"{rb}.{m}.input_activation", ch[i + 1])
                c.conv(f"{rb}.{m}.input_conv.conv", ch[i + 1], ch[i + 1], k, gain=0.5)
                act(f"{rb}.{m}.skip_activation", ch[i + 1])
                c.conv(f"{rb}.{m}.skip_conv.conv", ch[i + 1], ch[i + 1], k, gain=0.5)
    act(f"{d}.post_activation", ch[-1])
    c.conv(f"{d}.post_conv.conv", ch[-1], 1, ccfg.post_kernel, gain=0.3)
    ycfg = {"sample_rate": ccfg.sample_rate,
            "audio_decoder": {"base_channels": ccfg.base_channels,
                              "up_sample_rates": list(rates), "activation": ccfg.activation},
            "vector_quantizer": {"num_groups": ccfg.num_groups,
                                 "num_levels": list(ccfg.levels)}}
    nemo = os.path.join(dirname, "nano_codec.nemo")
    buf = io.BytesIO()
    torch.save(c.sd, buf)
    with tarfile.open(nemo, "w") as tar:
        for name, blob in (("./model_config.yaml", yaml.safe_dump(ycfg).encode()),
                           ("./model_weights.ckpt", buf.getvalue())):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    return dirname, nemo, w.nbytes + c.nbytes


def write_qwen_checkpoint(dirname: str, cfg, ccfg, seed: int, ecfg=None) -> tuple:
    """Qwen3-TTS-0.6B: the talker and code predictor (model.safetensors,
    config.json) and the tokenizer-v2 decoder (speech_tokenizer.safetensors)
    in the upstream keys, bf16; tests/fixtures/qwen2_style.json as its
    tokenizer.json. With a MimiEncoderConfig `ecfg`, also the voice-clone
    encoders: the Mimi encoder (speech_tokenizer.model.encoder.*) beside the
    decoder and the speaker encoder (speaker_encoder.*, the BatchNorm-free
    ECAPA: 128 mel bands, 512 channels, scale 8, out at the talker's width)
    beside the talker. Returns (dir, bytes written)."""
    import shutil

    from tts_tpu_torch.weights import write_safetensors

    os.makedirs(dirname, exist_ok=True)
    w = CkptWriter(seed)

    def stack(prefix, s):
        for i in range(s.num_layers):
            p = f"{prefix}.layers.{i}"
            w.one(f"{p}.input_layernorm.weight", s.hidden_size)
            w.one(f"{p}.post_attention_layernorm.weight", s.hidden_size)
            for n, rows in (("q", s.num_heads), ("k", s.num_kv_heads), ("v", s.num_kv_heads)):
                w.lin(f"{p}.self_attn.{n}_proj", rows * s.head_dim, s.hidden_size, bias=False)
            w.lin(f"{p}.self_attn.o_proj", s.hidden_size, s.num_heads * s.head_dim, bias=False,
                  gain=0.5)
            w.one(f"{p}.self_attn.q_norm.weight", s.head_dim)
            w.one(f"{p}.self_attn.k_norm.weight", s.head_dim)
            w.lin(f"{p}.mlp.gate_proj", s.ffn_dim, s.hidden_size, bias=False)
            w.lin(f"{p}.mlp.up_proj", s.ffn_dim, s.hidden_size, bias=False)
            w.lin(f"{p}.mlp.down_proj", s.hidden_size, s.ffn_dim, bias=False, gain=0.5)

    t, p = cfg.talker, cfg.predictor
    stack("talker.model", t)
    stack("talker.code_predictor.model", p)
    w.one("talker.model.norm.weight", t.hidden_size)
    w.one("talker.code_predictor.model.norm.weight", p.hidden_size)
    for g in range(cfg.num_code_groups - 1):
        w.lin(f"talker.code_predictor.lm_head.{g}", cfg.group_vocab, p.hidden_size, bias=False)
        w.w(f"talker.code_predictor.model.codec_embedding.{g}.weight", cfg.group_vocab,
            t.hidden_size, fan=1)
    w.lin("talker.codec_head", cfg.codec_vocab, t.hidden_size, bias=False)
    w.w("talker.model.codec_embedding.weight", cfg.codec_vocab, t.hidden_size, fan=1)
    w.w("talker.model.text_embedding.weight", cfg.text_vocab, cfg.text_hidden, fan=1)
    w.lin("talker.text_projection", t.hidden_size, cfg.text_hidden)
    w.lin("talker.code_predictor.small_to_mtp_projection", p.hidden_size, t.hidden_size,
          bias=False)
    if ecfg is not None:
        write_qwen_speaker_keys(w, t.hidden_size)
    write_safetensors(os.path.join(dirname, "model.safetensors"), w.sd)

    def stack_cfg(s):
        return {"hidden_size": s.hidden_size, "num_attention_heads": s.num_heads,
                "num_key_value_heads": s.num_kv_heads, "head_dim": s.head_dim,
                "intermediate_size": s.ffn_dim, "num_hidden_layers": s.num_layers,
                "rms_norm_eps": s.rms_eps, "rope_theta": s.rope_base}

    config = {"tts_bos_token_id": cfg.tts_bos_token_id, "tts_eos_token_id": cfg.tts_eos_token_id,
              "tts_pad_token_id": cfg.tts_pad_token_id, "text_vocab_size": cfg.text_vocab,
              "text_hidden_size": cfg.text_hidden,
              "talker_config": {**stack_cfg(t), "vocab_size": cfg.codec_vocab,
                                "codec_eos_token_id": cfg.codec_eos_token_id,
                                "codec_bos_id": cfg.codec_bos_id,
                                "codec_pad_id": cfg.codec_pad_id,
                                "codec_think_id": cfg.codec_think_id,
                                "codec_think_bos_id": cfg.codec_think_bos_id,
                                "codec_think_eos_id": cfg.codec_think_eos_id,
                                "code_predictor_config": {
                                    **stack_cfg(p), "vocab_size": cfg.group_vocab,
                                    "num_code_groups": cfg.num_code_groups}}}
    with open(os.path.join(dirname, "config.json"), "w") as f:
        json.dump(config, f)

    c = CkptWriter(seed + 1)
    pre = "speech_tokenizer.model.decoder"

    def snake(key, n):                   # SnakeBeta, log scale
        c.zero(f"{key}.alpha", n)
        c.zero(f"{key}.beta", n)

    firsts = [f"{pre}.quantizer.rvq_first.vq.layers.0"]
    rests = [f"{pre}.quantizer.rvq_rest.vq.layers.{g}" for g in range(ccfg.num_quantizers - 1)]
    for base in firsts + rests:
        c.w(f"{base}._codebook.embedding_sum", ccfg.codebook_size, ccfg.rvq_dim, fan=1)
        c.pos(f"{base}._codebook.cluster_usage", ccfg.codebook_size)
    for part in ("rvq_first", "rvq_rest"):
        c.w(f"{pre}.quantizer.{part}.output_proj.weight", ccfg.codebook_dim, ccfg.rvq_dim, 1)
    c.conv(f"{pre}.pre_conv.conv", ccfg.codebook_dim, ccfg.latent_dim, 3)
    tp = f"{pre}.pre_transformer"
    hs, hd = ccfg.hidden_size, ccfg.head_dim
    c.lin(f"{tp}.input_proj", hs, ccfg.latent_dim)
    for i in range(ccfg.num_layers):
        lp = f"{tp}.layers.{i}"
        c.lin(f"{lp}.self_attn.q_proj", ccfg.num_heads * hd, hs, bias=False)
        c.lin(f"{lp}.self_attn.k_proj", ccfg.num_kv_heads * hd, hs, bias=False)
        c.lin(f"{lp}.self_attn.v_proj", ccfg.num_kv_heads * hd, hs, bias=False)
        c.lin(f"{lp}.self_attn.o_proj", hs, ccfg.num_heads * hd, bias=False)
        c.lin(f"{lp}.mlp.gate_proj", ccfg.ffn_dim, hs, bias=False)
        c.lin(f"{lp}.mlp.up_proj", ccfg.ffn_dim, hs, bias=False)
        c.lin(f"{lp}.mlp.down_proj", hs, ccfg.ffn_dim, bias=False)
        c.one(f"{lp}.input_layernorm.weight", hs)
        c.one(f"{lp}.post_attention_layernorm.weight", hs)
        c.zero(f"{lp}.self_attn_layer_scale.scale", hs)
        c.zero(f"{lp}.mlp_layer_scale.scale", hs)
    c.one(f"{tp}.norm.weight", hs)
    c.lin(f"{tp}.output_proj", ccfg.latent_dim, hs)
    lat = ccfg.latent_dim
    for i, r in enumerate(ccfg.upsampling_ratios):
        c.conv(f"{pre}.upsample.{i}.0.conv", lat, lat, r, transposed=True, stride=r)
        cn = f"{pre}.upsample.{i}.1"
        c.conv(f"{cn}.dwconv.conv", 1, lat, 7)
        c.ln(f"{cn}.norm", lat)
        c.lin(f"{cn}.pwconv1", 4 * lat, lat)
        c.lin(f"{cn}.pwconv2", lat, 4 * lat)
        c.zero(f"{cn}.gamma", lat)
    c.conv(f"{pre}.decoder.0.conv", lat, ccfg.decoder_dim, 7)
    for i, r in enumerate(ccfg.upsample_rates):
        cin, cout = ccfg.decoder_dim // 2 ** i, ccfg.decoder_dim // 2 ** (i + 1)
        b = f"{pre}.decoder.{i + 1}.block"
        snake(f"{b}.0", cin)
        c.conv(f"{b}.1.conv", cin, cout, 2 * r, transposed=True, stride=r)
        for j in range(3):
            snake(f"{b}.{2 + j}.act1", cout)
            c.conv(f"{b}.{2 + j}.conv1.conv", cout, cout, 7, gain=0.5)
            snake(f"{b}.{2 + j}.act2", cout)
            c.conv(f"{b}.{2 + j}.conv2.conv", cout, cout, 1, gain=0.5)
    n = len(ccfg.upsample_rates)
    out = ccfg.decoder_dim // 2 ** n
    snake(f"{pre}.decoder.{n + 1}", out)
    c.conv(f"{pre}.decoder.{n + 2}.conv", out, 1, 7, gain=0.3)
    if ecfg is not None:
        write_mimi_encoder_keys(c, ecfg)
    write_safetensors(os.path.join(dirname, "speech_tokenizer.safetensors"), c.sd)
    shutil.copy(os.path.join(FIXTURES, "qwen2_style.json"), os.path.join(dirname, "tokenizer.json"))
    return dirname, w.nbytes + c.nbytes


def write_mimi_encoder_keys(c: CkptWriter, ecfg) -> None:
    """The Mimi encoder in the upstream keys: the SEANet convs at their
    constructor's layer indices (the ELUs hold slots), the transformer with
    its LayerNorms and layer scales, the downsample conv and the split RVQ
    (input projections, codebooks as embed_sum / cluster_usage)."""
    e = "speech_tokenizer.model.encoder"
    idx, ch = 0, ecfg.num_filters
    c.conv(f"{e}.encoder.layers.{idx}.conv", 1, ch, ecfg.kernel_size)
    idx += 1
    for ratio in reversed(ecfg.upsampling_ratios):
        hidden = ch // ecfg.compress
        for _ in range(ecfg.num_residual_layers):
            c.conv(f"{e}.encoder.layers.{idx}.block.1.conv", ch, hidden,
                   ecfg.residual_kernel_size, gain=0.5)
            c.conv(f"{e}.encoder.layers.{idx}.block.3.conv", hidden, ch, 1, gain=0.5)
            idx += 1
        idx += 1                                   # the ELU
        c.conv(f"{e}.encoder.layers.{idx}.conv", ch, 2 * ch, 2 * ratio)
        idx += 1
        ch *= 2
    idx += 1
    c.conv(f"{e}.encoder.layers.{idx}.conv", ch, ecfg.hidden_size, ecfg.last_kernel_size)
    hs, inner = ecfg.hidden_size, ecfg.num_heads * ecfg.head_dim
    for i in range(ecfg.num_layers):
        lp = f"{e}.encoder_transformer.layers.{i}"
        for n in ("q", "k", "v"):
            c.lin(f"{lp}.self_attn.{n}_proj", inner, hs, bias=False)
        c.lin(f"{lp}.self_attn.o_proj", hs, inner, bias=False)
        c.lin(f"{lp}.mlp.fc1", ecfg.ffn_dim, hs, bias=False)
        c.lin(f"{lp}.mlp.fc2", hs, ecfg.ffn_dim, bias=False)
        c.ln(f"{lp}.input_layernorm", hs)
        c.ln(f"{lp}.post_attention_layernorm", hs)
        c.zero(f"{lp}.self_attn_layer_scale.scale", hs)
        c.zero(f"{lp}.mlp_layer_scale.scale", hs)
    c.conv(f"{e}.downsample.conv", hs, hs, 2 * ecfg.downsample_stride, bias=False)
    q = f"{e}.quantizer"
    for base, n in ((f"{q}.semantic_residual_vector_quantizer", 1),
                    (f"{q}.acoustic_residual_vector_quantizer", ecfg.num_quantizers - 1)):
        c.w(f"{base}.input_proj.weight", ecfg.rvq_dim, hs, 1)
        for g in range(n):
            c.w(f"{base}.layers.{g}.codebook.embed_sum", ecfg.codebook_size, ecfg.rvq_dim,
                fan=1)
            c.pos(f"{base}.layers.{g}.codebook.cluster_usage", ecfg.codebook_size)


def write_qwen_speaker_keys(w: CkptWriter, spk: int, n_mels: int = 128, ch: int = 512,
                            scale: int = 8, se: int = 128, attn: int = 128) -> None:
    """Qwen3-TTS's speaker encoder (speaker_encoder.*) in the upstream keys:
    TDNN convs, three SE-Res2Net blocks, MFA, attentive statistics pooling
    and the fc to the talker's width."""
    pre = "speaker_encoder"
    sub = ch // scale
    w.conv(f"{pre}.blocks.0.conv", n_mels, ch, 5)
    for i in (1, 2, 3):
        b = f"{pre}.blocks.{i}"
        w.conv(f"{b}.tdnn1.conv", ch, ch, 1)
        for j in range(scale - 1):
            w.conv(f"{b}.res2net_block.blocks.{j}.conv", sub, sub, 3)
        w.conv(f"{b}.tdnn2.conv", ch, ch, 1)
        w.conv(f"{b}.se_block.conv1", ch, se, 1)
        w.conv(f"{b}.se_block.conv2", se, ch, 1)
    w.conv(f"{pre}.mfa.conv", 3 * ch, 3 * ch, 1)
    w.conv(f"{pre}.asp.tdnn.conv", 9 * ch, attn, 1)
    w.conv(f"{pre}.asp.conv", attn, 3 * ch, 1)
    w.conv(f"{pre}.fc", 6 * ch, spk, 1)


# the IndexTTS bpe.model: upper-case letters and punctuation, a few merges
INDEX_PIECES = ([("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3), ("▁", -10.0, 1)]
                + [(ch, -5.0, 1) for ch in "ABCDEFGHIJKLMNOPQRSTUVWXYZ.,!?'"]
                + [("▁" + m, -1.0 - 0.1 * i, 1) for i, m in enumerate(
                    ("THE", "HELLO", "FROM", "CARD", "PORT", "TEXT", "INTO", "SPEECH",
                     "TURNS", "TH", "S", "T", "C", "P"))]
                + [("ER", -2.0, 1), ("RO", -2.1, 1), ("AR", -2.2, 1), ("EE", -2.3, 1)])


def write_indextts_checkpoint(dirname: str, cfg, vcfg, seed: int) -> tuple:
    """IndexTTS-1.5: gpt.pth (UnifiedVoice: GPT-2 layers, embeddings, the
    conformer and the perceiver) and bigvgan.pth (the generator, the ECAPA
    speaker encoder with BatchNorm statistics, cond_layer and conds), both
    torch.save'd in bf16; config.yaml with vcfg's rates (phase 9's); a
    hand-built bpe.model. Returns (dir, bytes written)."""
    import yaml

    os.makedirs(dirname, exist_ok=True)
    w = CkptWriter(seed)
    d = cfg.gpt_dim
    for i in range(cfg.gpt_layers):
        p = f"gpt.h.{i}"
        w.w(f"{p}.attn.c_attn.weight", d, 3 * d, fan=d)        # GPT-2 Conv1D (in, out)
        w.zero(f"{p}.attn.c_attn.bias", 3 * d)
        w.w(f"{p}.attn.c_proj.weight", d, d, fan=d, gain=0.5)
        w.zero(f"{p}.attn.c_proj.bias", d)
        w.w(f"{p}.mlp.c_fc.weight", d, 4 * d, fan=d)
        w.zero(f"{p}.mlp.c_fc.bias", 4 * d)
        w.w(f"{p}.mlp.c_proj.weight", 4 * d, d, fan=4 * d, gain=0.5)
        w.zero(f"{p}.mlp.c_proj.bias", d)
        w.ln(f"{p}.ln_1", d)
        w.ln(f"{p}.ln_2", d)
    w.ln("gpt.ln_f", d)
    w.ln("final_norm", d)
    for key, rows in (("text_embedding.weight", cfg.num_text_tokens + 2),
                      ("text_pos_embedding.emb.weight", cfg.max_text_tokens + 2),
                      ("mel_embedding.weight", cfg.num_mel_codes),
                      ("mel_pos_embedding.emb.weight", cfg.max_mel_tokens + 2)):
        w.w(key, rows, d, fan=1, gain=0.02)
    w.lin("mel_head", cfg.num_mel_codes, d)
    # the conditioning encoder (ESPnet conformer) and the perceiver
    e, h = cfg.enc_dim, cfg.enc_heads
    f_out = ((cfg.n_mels - 1) // 2 - 1) // 2
    ce = "conditioning_encoder"
    w.w(f"{ce}.embed.conv.0.weight", e, 1, 3, 3)
    w.zero(f"{ce}.embed.conv.0.bias", e)
    w.w(f"{ce}.embed.conv.2.weight", e, e, 3, 3)
    w.zero(f"{ce}.embed.conv.2.bias", e)
    w.lin(f"{ce}.embed.out.0", e, e * f_out)
    for i in range(cfg.enc_layers):
        p = f"{ce}.encoders.{i}"
        a, cm = f"{p}.self_attn", f"{p}.conv_module"
        for n in ("q", "k", "v"):
            w.lin(f"{a}.linear_{n}", e, e)
        w.lin(f"{a}.linear_pos", e, e, bias=False)
        w.zero(f"{a}.pos_bias_u", h, e // h)
        w.zero(f"{a}.pos_bias_v", h, e // h)
        w.lin(f"{a}.linear_out", e, e, gain=0.5)
        w.conv(f"{cm}.pointwise_conv1", e, 2 * e, 1)
        w.conv(f"{cm}.depthwise_conv", 1, e, cfg.enc_conv_kernel)
        w.conv(f"{cm}.pointwise_conv2", e, e, 1, gain=0.5)
        w.lin(f"{p}.feed_forward.w_1", cfg.enc_ff_dim, e)
        w.lin(f"{p}.feed_forward.w_2", e, cfg.enc_ff_dim, gain=0.5)
        for n in ("norm_mha", "norm_conv", "conv_module.norm", "norm_ff", "norm_final"):
            w.ln(f"{p}.{n}", e)
    w.ln(f"{ce}.after_norm", e)
    q = "perceiver_encoder"
    inner = cfg.perceiver_heads * cfg.perceiver_dim_head
    ff = d * cfg.perceiver_ff_mult
    w.lin(f"{q}.proj_context", d, e)
    w.w(f"{q}.latents", cfg.num_latents, d, fan=1)
    for i in range(2):
        p = f"{q}.layers.{i}"
        w.lin(f"{p}.0.to_q", inner, d, bias=False)
        w.lin(f"{p}.0.to_kv", 2 * inner, d, bias=False)
        w.lin(f"{p}.0.to_out", d, inner, bias=False, gain=0.5)
        w.ln(f"{p}.1.0", d)
        w.lin(f"{p}.1.1", ff, d)
        w.lin(f"{p}.1.3", d, ff, gain=0.5)
    w.ln(f"{q}.norm", d)
    torch.save(w.sd, os.path.join(dirname, "gpt.pth"))

    b = CkptWriter(seed + 1)
    c0 = vcfg.upsample_initial_channel
    b.conv("conv_pre", vcfg.num_mels, c0, 7)
    cin = c0
    for i, (r, k) in enumerate(zip(vcfg.upsample_rates, vcfg.upsample_kernel_sizes)):
        cout = vcfg.stage_channels[i]
        b.conv(f"ups.{i}.0", cin, cout, k, transposed=True, stride=r)
        for j, (ks, dil) in enumerate(zip(vcfg.resblock_kernel_sizes,
                                          vcfg.resblock_dilation_sizes)):
            n = i * vcfg.num_kernels + j
            for m in range(len(dil)):
                b.conv(f"resblocks.{n}.convs1.{m}", cout, cout, ks, gain=0.5)
                b.conv(f"resblocks.{n}.convs2.{m}", cout, cout, ks, gain=0.5)
            for m in range(2 * len(dil)):          # SnakeBeta, log scale
                b.zero(f"resblocks.{n}.activations.{m}.act.alpha", cout)
                b.zero(f"resblocks.{n}.activations.{m}.act.beta", cout)
        cin = cout
    b.zero("activation_post.act.alpha", cin)
    b.zero("activation_post.act.beta", cin)
    b.conv("conv_post", cin, 1, 7, gain=0.3)
    ec, spk = cfg.ecapa_channels, cfg.speaker_embed_dim

    def tdnn(pre, ci, co, k):
        b.conv(f"{pre}.conv", ci, co, k)
        b.one(f"{pre}.norm.norm.weight", co)
        b.zero(f"{pre}.norm.norm.bias", co)
        b.zero(f"{pre}.norm.norm.running_mean", co)
        b.pos(f"{pre}.norm.norm.running_var", co)

    se = "speaker_encoder"
    sub = ec // cfg.res2net_scale
    tdnn(f"{se}.blocks.0", cfg.n_mels, ec, 5)
    for i in (1, 2, 3):
        p = f"{se}.blocks.{i}"
        tdnn(f"{p}.tdnn1", ec, ec, 1)
        for j in range(cfg.res2net_scale - 1):
            tdnn(f"{p}.res2net_block.blocks.{j}", sub, sub, 3)
        tdnn(f"{p}.tdnn2", ec, ec, 1)
        b.conv(f"{p}.se_block.conv1", ec, cfg.se_channels, 1)
        b.conv(f"{p}.se_block.conv2", cfg.se_channels, ec, 1)
    tdnn(f"{se}.mfa", 3 * ec, 3 * ec, 1)
    tdnn(f"{se}.asp.tdnn", 9 * ec, cfg.ecapa_attn_channels, 1)
    b.conv(f"{se}.asp.conv", cfg.ecapa_attn_channels, 3 * ec, 1)
    b.one(f"{se}.asp_bn.weight", 6 * ec)
    b.zero(f"{se}.asp_bn.bias", 6 * ec)
    b.zero(f"{se}.asp_bn.running_mean", 6 * ec)
    b.pos(f"{se}.asp_bn.running_var", 6 * ec)
    b.conv(f"{se}.fc", 6 * ec, spk, 1)
    b.conv("cond_layer", spk, c0, 1, gain=0.5)
    for i, c in enumerate(vcfg.stage_channels):
        b.conv(f"conds.{i}", spk, c, 1, gain=0.5)
    torch.save(b.sd, os.path.join(dirname, "bigvgan.pth"))
    section = {"upsample_initial_channel": c0, "upsample_rates": list(vcfg.upsample_rates),
               "upsample_kernel_sizes": list(vcfg.upsample_kernel_sizes),
               "resblock_kernel_sizes": list(vcfg.resblock_kernel_sizes),
               "resblock_dilation_sizes": [list(x) for x in vcfg.resblock_dilation_sizes],
               "activation": vcfg.activation, "snake_logscale": vcfg.snake_logscale,
               "sampling_rate": vcfg.sample_rate, "resblock": vcfg.resblock,
               "feat_upsample": vcfg.feat_upsample}
    with open(os.path.join(dirname, "config.yaml"), "w") as f:
        yaml.safe_dump({"gpt": {"model_dim": d}, "bigvgan": section}, f)
    with open(os.path.join(dirname, "bpe.model"), "wb") as f:
        f.write(_spm_model(INDEX_PIECES))
    return dirname, w.nbytes + b.nbytes


def write_voxcpm_checkpoint(dirname: str, cfg, seed: int) -> tuple:
    """VoxCPM-2: base and residual LMs, the FSQ layer, the projections, the
    feature encoder, the CFM estimator (time and delta-time MLPs) and the
    audio VAE (depthwise units, rate-conditioning layers) in the upstream
    keys, one bf16 model.safetensors; tests/fixtures/llama_style.json as its
    tokenizer.json. Returns (dir, bytes written)."""
    import shutil

    from tts_tpu_torch.weights import write_safetensors

    os.makedirs(dirname, exist_ok=True)
    w = CkptWriter(seed)
    b, est, fe = cfg.base, cfg.estimator, cfg.feat_encoder
    hs, lat = b.hidden_size, cfg.vae.latent_dim
    for prefix, s in (("base_lm", b), ("residual_lm", cfg.residual), ("feat_encoder.encoder", fe),
                      ("feat_decoder.estimator.decoder", est)):
        for i in range(s.num_layers):
            p = f"{prefix}.layers.{i}"
            w.one(f"{p}.input_layernorm.weight", s.hidden_size)
            w.one(f"{p}.post_attention_layernorm.weight", s.hidden_size)
            for n, rows in (("q", s.num_heads), ("k", s.num_kv_heads), ("v", s.num_kv_heads)):
                w.lin(f"{p}.self_attn.{n}_proj", rows * s.head_dim, s.hidden_size, bias=False)
            w.lin(f"{p}.self_attn.o_proj", s.hidden_size, s.num_heads * s.head_dim, bias=False,
                  gain=0.5)
            w.lin(f"{p}.mlp.gate_proj", s.ffn_dim, s.hidden_size, bias=False)
            w.lin(f"{p}.mlp.up_proj", s.ffn_dim, s.hidden_size, bias=False)
            w.lin(f"{p}.mlp.down_proj", s.hidden_size, s.ffn_dim, bias=False, gain=0.5)
        w.one(f"{prefix}.norm.weight", s.hidden_size)
    w.w("base_lm.embed_tokens.weight", cfg.vocab_size, hs, fan=1, gain=0.02)
    w.lin("fsq_layer.in_proj", cfg.fsq_dim, hs)
    w.lin("fsq_layer.out_proj", hs, cfg.fsq_dim, bias=False)
    w.lin("lm_to_dit_proj", est.hidden_size, hs, bias=False)
    w.lin("stop_proj", hs, hs, bias=False)
    w.lin("stop_head", 2, hs, bias=False)
    # a bias toward "go on" (class 0): a random stop head would end the
    # request at its min_latents
    w._put("stop_head.bias", torch.tensor([4.0, -4.0]))
    w.lin("res_to_dit_proj", est.hidden_size, hs, bias=False)
    w.lin("feat_encoder.in_proj", fe.hidden_size, lat)
    w.w("feat_encoder.special_token", 1, 1, 1, fe.hidden_size, fan=1)
    w.lin("enc_to_lm_proj", hs, fe.hidden_size, bias=False)
    e = "feat_decoder.estimator"
    w.lin(f"{e}.cond_proj", est.hidden_size, lat)
    w.lin(f"{e}.in_proj", est.hidden_size, lat)
    w.lin(f"{e}.out_proj", lat, est.hidden_size, bias=False)
    for m in ("time_mlp", "delta_time_mlp"):
        w.lin(f"{e}.{m}.0", est.hidden_size, est.hidden_size)
        w.lin(f"{e}.{m}.2", est.hidden_size, est.hidden_size)
    v = cfg.vae

    def snake(pre, n):
        w.pos(f"{pre}.alpha", 1, n, 1)

    def unit(pre, n):
        snake(f"{pre}.block.0", n)
        w.conv(f"{pre}.block.1", 1 if v.depthwise else n, n, 7, gain=0.5)
        snake(f"{pre}.block.2", n)
        w.conv(f"{pre}.block.3", n, n, 1, gain=0.5)

    enc = "audio_vae.encoder"
    w.conv(f"{enc}.block.0", 1, v.d_model, 7)
    ch = v.d_model
    for i, stride in enumerate(v.strides):
        blk = f"{enc}.block.{i + 1}.block"
        for j in range(3):
            unit(f"{blk}.{j}", ch)
        snake(f"{blk}.3", ch)
        w.conv(f"{blk}.4", ch, 2 * ch, 2 * stride)
        ch *= 2
    w.conv(f"{enc}.fc_mu", ch, lat, 3)
    dec = "audio_vae.decoder.model"
    rates = v.decoder_rates or tuple(reversed(v.strides))
    dc = v.decoder_channels
    w.conv(f"{dec}.0", 1, lat, 7)
    w.conv(f"{dec}.1", lat, dc, 1)
    for i, r in enumerate(rates):
        cin, cout = dc // 2 ** i, dc // 2 ** (i + 1)
        blk = f"{dec}.{i + 2}.block"
        snake(f"{blk}.0", cin)
        w.conv(f"{blk}.1", cin, cout, 2 * r, transposed=True, stride=r)
        for j in range(3):
            unit(f"{blk}.{2 + j}", cout)
        sr = f"audio_vae.decoder.sr_cond_model.{i + 2}"
        w.one(f"{sr}.scale_embed.weight", len(v.sr_bins) + 1, cin)
        w.zero(f"{sr}.bias_embed.weight", len(v.sr_bins) + 1, cin)
    out = dc // 2 ** len(rates)
    snake(f"{dec}.{len(rates) + 2}", out)
    w.conv(f"{dec}.{len(rates) + 3}", out, 1, 7, gain=0.3)
    write_safetensors(os.path.join(dirname, "model.safetensors"), w.sd)
    shutil.copy(os.path.join(FIXTURES, "llama_style.json"), os.path.join(dirname, "tokenizer.json"))
    return dirname, w.nbytes


@contextlib.contextmanager
def _spied(cls, name: str):
    """Wrap cls.name for the duration: each call's (self, args, kwargs,
    result, start, seconds) is kept."""
    calls = []
    real = getattr(cls, name)

    def rec(self, *a, **kw):
        t0 = time.perf_counter()
        out = real(self, *a, **kw)
        calls.append((self, a, kw, out, t0, time.perf_counter() - t0))
        return out

    setattr(cls, name, rec)
    try:
        yield calls
    finally:
        setattr(cls, name, real)


@contextlib.contextmanager
def _timed(module, names):
    """Wrap module-level functions (the loaders the CLI imports at call
    time): their seconds, the card synchronized, summed into a dict."""
    spent = {"s": 0.0}
    real = {n: getattr(module, n) for n in names}

    def wrap(fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent["s"] += time.perf_counter() - t0
            return out
        return timed

    for n, fn in real.items():
        setattr(module, n, wrap(fn))
    try:
        yield spent
    finally:
        for n, fn in real.items():
            setattr(module, n, fn)


@contextlib.contextmanager
def _no_regex():
    """`import regex` raises inside: the hand-rolled scanner's path."""
    import builtins

    real = builtins.__import__

    def block(name, *a, **kw):
        if name == "regex":
            raise ImportError("regex blocked")
        return real(name, *a, **kw)

    builtins.__import__ = block
    try:
        yield
    finally:
        builtins.__import__ = real


def _hf_ids(ckpt: str, fn) -> tuple:
    """fn(tokenizer) with the checkpoint's tokenizer.json read as loaded,
    and again with `regex` blocked; (ids, ids without regex, load ms,
    tokenize ms)."""
    from tts_tpu_torch.frontend.hf_tokenizer import HFTokenizer

    t0 = time.perf_counter()
    tok = HFTokenizer.from_pretrained(ckpt)
    t1 = time.perf_counter()
    ids = fn(tok)
    t2 = time.perf_counter()
    with _no_regex():
        plain = fn(HFTokenizer.from_pretrained(ckpt))
    return ids, plain, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def run_cli_command(name_limit: str, family: str, argv: list, cls, method: str, loaders,
                    expect_fn, direct_fn) -> dict:
    """One `tts_tpu_torch.cli.main(argv)` on the card: the loaders' seconds,
    the pipeline's `method` calls, the launches (against expect_fn(calls)),
    the WAV against direct_fn(calls) bit for bit. Returns the launches."""
    from tts_tpu_torch import cli
    from tts_tpu_torch.audio.wav import read_wav
    from tts_tpu_torch.ops._build import LAUNCHES

    out_path = argv[argv.index("--out") + 1]
    torch.cuda.synchronize()
    LAUNCHES.clear()
    printed = io.StringIO()
    with contextlib.ExitStack() as stack:
        spents = [stack.enter_context(_timed(module, names)) for module, names in loaders]
        calls = stack.enter_context(_spied(cls, method))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    grew = {k: LAUNCHES.get(k, 0) for k in KERNELS}
    load = sum(s["s"] for s in spents)
    if rc != 0 or not calls:
        raise AssertionError(f"cli {family}: exit {rc}, {len(calls)} pipeline calls")
    before = calls[0][4] - t0
    synth = sum(c[5] for c in calls)
    print(f"  {name_limit}: cli {family}: load {load:.3f} s, host before the first "
          f"synthesis call {before:.3f} s (load included), synthesis wall {synth:.4f} s "
          f"({len(calls)} {method} calls), main() {total:.3f} s; launches "
          f"{ {k: n for k, n in grew.items() if n} }", flush=True)
    for line in printed.getvalue().splitlines():
        print(f"    | {line}")
    want = expect_fn(calls)
    for k in KERNELS:
        if grew[k] != want.get(k, 0):
            raise AssertionError(f"cli {family}: {k} launched {grew[k]} times, expected "
                                 f"{want.get(k, 0)}")
    wav, rate = read_wav(out_path)
    ref, ref_rate, length = direct_fn(calls)
    if rate != ref_rate or len(wav) != length or not np.array_equal(wav, ref):
        raise AssertionError(f"cli {family}: {out_path} ({len(wav)} samples at {rate} Hz) is "
                             f"not the direct call's {length} at {ref_rate} bit for bit")
    print(f"  cli {family}: {len(wav)} int16 samples at {rate} Hz, peak |int16| "
          f"{int(np.abs(wav.astype(np.int32)).max()) if len(wav) else 0}, bit for bit the "
          f"loaded pipeline's direct call", flush=True)
    return grew


def run_cli(name_limit: str, ckpt_root: str, f5_files: dict | None, keep: bool = False) -> dict:
    """Phase 13: full-width upstream-key checkpoints of kani-tts-370m (+
    NanoCodec), Qwen3-TTS-0.6B (+ codec), IndexTTS-1.5 and VoxCPM-2 written
    from seeds (bf16), the F5 files of phase 12 (written here when phase 12
    did not run); each family through `tts_tpu_torch.cli.main` in process
    with an English --text on the card. keep: leave each family's directory
    (ckpt_root/<family>) for phase 15. Returns the launches."""
    import dataclasses
    import importlib.util
    import shutil

    import tts_tpu_torch.weights.f5_loader as f5_loader
    import tts_tpu_torch.weights.indextts_loader as index_loader
    import tts_tpu_torch.weights.kani_loader as kani_loader
    import tts_tpu_torch.weights.qwen_loader as qwen_loader
    import tts_tpu_torch.weights.voxcpm_loader as vox_loader
    from tts_tpu_torch.frontend.indextts_text import IndexTTSTokenizer, split_sentences
    from tts_tpu_torch.frontend.voxcpm_text import (mask_multichar_chinese_tokens,
                                                     normalize_voxcpm_text)
    from tts_tpu_torch.models.f5 import F5Config
    from tts_tpu_torch.models.indextts import IndexTTSConfig
    from tts_tpu_torch.models.kani import KaniConfig
    from tts_tpu_torch.models.nanocodec import NanoCodecConfig
    from tts_tpu_torch.models.qwen_codec import QwenCodecDecoderConfig
    from tts_tpu_torch.models.qwen_tts import QwenTTSConfig
    from tts_tpu_torch.models.vocos import VocosConfig
    from tts_tpu_torch.models.voxcpm import voxcpm_v2_config
    from tts_tpu_torch.runtime.f5 import F5Pipeline
    from tts_tpu_torch.runtime.indextts import IndexTTSPipeline
    from tts_tpu_torch.runtime.kani import HEAD_IDS, TAIL_IDS, KaniPipeline
    from tts_tpu_torch.runtime.qwen import QwenTTSPipeline
    from tts_tpu_torch.runtime.voxcpm import VoxCPMPipeline

    has_regex = importlib.util.find_spec("regex") is not None
    print(f"  the `regex` wheel is {'' if has_regex else 'not '}importable here: "
          f"{'both paths' if has_regex else 'the hand-rolled scanner'} tokenize", flush=True)
    launches: dict = {}

    def add(grew):
        for k, n in grew.items():
            launches[k] = launches.get(k, 0) + n

    def written(label, t0, nbytes):
        print(f"  {name_limit}: wrote {label} ({nbytes / 2**30:.3f} GiB bf16) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

    def same_ids(family, got, ids, plain, load_ms, tok_ms):
        if not (np.array_equal(got, ids) and np.array_equal(ids, plain)):
            raise AssertionError(f"cli {family}: the pipeline's ids {got.tolist()} differ from "
                                 f"the tokenizer's {ids.tolist()} or {plain.tolist()} (regex "
                                 f"blocked)")
        print(f"  {name_limit}: cli {family}: tokenizer.json read in {load_ms:.2f} ms, "
              f"{CLI_TEXT!r} tokenized in {tok_ms:.3f} ms, {got.shape[1]} ids, the same with "
              f"`regex` blocked", flush=True)

    def free():
        import gc

        gc.collect()
        torch.cuda.empty_cache()

    # F5: phase 12's checkpoint files
    if f5_files is None:
        t0 = time.perf_counter()
        cfg = F5Config(vocab_size=F5_VOCAB_LINES)
        ckpt, vocab, size = write_f5_checkpoint(ckpt_root, cfg, seed=20)
        vdir = write_vocos_checkpoint(ckpt_root, VocosConfig(), seed=21)
        ref_path = os.path.join(ckpt_root, "ref.wav")
        write_stereo_reference(ref_path, 6.0, seed=22)
        f5_files = {"ckpt": ckpt, "vocab": vocab, "vocoder": vdir, "ref": ref_path}
        print(f"  {name_limit}: wrote F5TTS_v1_Base + Vocos ({size / 2**30:.3f} GiB fp32) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    nfe = F5Config().nfe_steps
    depth = F5Config().depth
    f5_out = os.path.join(ckpt_root, "cli_f5.wav")

    def f5_expect(calls):
        return {"flash_attention_flat": depth * (nfe - 1),
                "mlp_block_fused": depth * (nfe - 1), "conv_pos_embed_fused": nfe - 1}

    def f5_direct(calls):
        pipe, a, kw, (wav, _), _, _ = calls[0]
        again = pipe.synthesize(*a, **kw)[0]
        return again, pipe.cfg.sample_rate, len(wav)

    add(run_cli_command(
        name_limit, "f5", ["f5", "--ckpt", f5_files["ckpt"], "--vocab", f5_files["vocab"],
                           "--vocoder", f5_files["vocoder"], "--ref-audio", f5_files["ref"],
                           "--ref-text", REF_TEXT, "--gen-text", CLI_TEXT, "--out", f5_out],
        F5Pipeline, "synthesize", [(f5_loader, ("load_f5", "load_vocos"))], f5_expect,
        f5_direct))
    free()

    # Kani: kani-tts-370m + NanoCodec
    kcfg, ccfg = KaniConfig(), NanoCodecConfig()
    t0 = time.perf_counter()
    kdir, nemo, size = write_kani_checkpoint(os.path.join(ckpt_root, "kani"), kcfg, ccfg, 40)
    written("kani-tts-370m + nemo-nano-codec", t0, size)
    if kani_loader.kani_config_from_json(os.path.join(kdir, "config.json")) != kcfg:
        raise AssertionError("the written config.json is not kani-tts-370m's")
    ids, plain, lms, tms = _hf_ids(kdir, lambda t: np.concatenate(
        [[HEAD_IDS], t(f"jenny: {CLI_TEXT}", return_tensors="np")["input_ids"], [TAIL_IDS]],
        axis=1).astype(np.int32))

    def kani_expect(calls):
        pipe, _, _, (_, st), _, _ = calls[0]
        cap, buf, _ = pipe._buf_for(None)
        return {"fused_qkv_attn": kcfg.num_attn_layers * kani_steps(st["tokens"],
                                                                    min(cap, buf))}

    def kani_direct(calls):
        pipe, a, kw, (wav, st), _, _ = calls[0]
        same_ids("kani", a[0], ids, plain, lms, tms)
        frames = max((st["tokens"] - 2) // ccfg.num_groups, 0)
        return pipe.synthesize_ids(*a, **kw)[0], ccfg.sample_rate, frames * ccfg.total_upsample

    add(run_cli_command(
        name_limit, "kani", ["kani", "--ckpt", kdir, "--codec", nemo, "--text", CLI_TEXT,
                             "--max-tokens", str(CLI_CAPS["kani"]),
                             "--out", os.path.join(ckpt_root, "cli_kani.wav")],
        KaniPipeline, "synthesize_ids", [(kani_loader, ("load_kani_lm", "load_nanocodec"))],
        kani_expect, kani_direct))
    if not keep:
        shutil.rmtree(kdir)
    free()

    # Qwen3-TTS-0.6B + its codec
    qcfg, qccfg = QwenTTSConfig(), QwenCodecDecoderConfig()
    t0 = time.perf_counter()
    qdir, size = write_qwen_checkpoint(os.path.join(ckpt_root, "qwen"), qcfg, qccfg, 50)
    written("Qwen3-TTS-0.6B + tokenizer-v2 decoder", t0, size)
    # the loader reads the predictor's cache as 40 rows (tts_tpu's), where
    # QwenTTSConfig() has 32: every width and depth is Qwen3-TTS-0.6B's
    got = qwen_loader.qwen_config_from_json(qdir)
    if got != dataclasses.replace(qcfg, predictor=dataclasses.replace(
            qcfg.predictor, max_seq_len=got.predictor.max_seq_len)):
        raise AssertionError("the written config.json is not Qwen3-TTS-0.6B's")
    ids, plain, lms, tms = _hf_ids(qdir, lambda t: t(CLI_TEXT, return_tensors="np")[
        "input_ids"].astype(np.int32))
    per_iter = qcfg.talker.num_layers + (qcfg.num_code_groups - 1) * qcfg.predictor.num_layers
    up = qccfg.total_upsample
    cap = CLI_CAPS["qwen"]

    def qwen_frames(calls):
        return len(calls[0][3][0]) // up

    def qwen_expect(calls):
        return {"fused_qkv_attn": per_iter * qwen_frames_run(qwen_frames(calls), cap)}

    def qwen_direct(calls):
        pipe, a, kw, (wav, _), _, _ = calls[0]
        same_ids("qwen", a[0], ids, plain, lms, tms)
        if not 1 <= qwen_frames(calls) <= cap or len(wav) % up:
            raise AssertionError(f"cli qwen: {len(wav)} samples, not 1..{cap} frames of {up}")
        return pipe.synthesize_ids(*a, **kw)[0], pipe.output_sample_rate, len(wav)

    add(run_cli_command(
        name_limit, "qwen", ["qwen", "--ckpt", qdir, "--text", CLI_TEXT, "--language",
                             "english", "--max-frames", str(cap),
                             "--out", os.path.join(ckpt_root, "cli_qwen.wav")],
        QwenTTSPipeline, "synthesize_ids",
        [(qwen_loader, ("load_qwen_tts", "load_qwen_codec"))], qwen_expect, qwen_direct))
    if not keep:
        shutil.rmtree(qdir)
    free()

    # IndexTTS-1.5 at phase 9's vocoder rates
    icfg = IndexTTSConfig()
    ivcfg = index_vocoder_cfg(icfg)
    t0 = time.perf_counter()
    idir, size = write_indextts_checkpoint(os.path.join(ckpt_root, "indextts"), icfg, ivcfg, 60)
    written("IndexTTS-1.5 (gpt.pth, bigvgan.pth, config.yaml, bpe.model)", t0, size)
    if index_loader._bigvgan_config_from_yaml(os.path.join(idir, "config.yaml"), icfg) != ivcfg:
        raise AssertionError("the written config.yaml is not phase 9's vocoder")
    rate = ivcfg.sample_rate
    tt = np.arange(6 * rate) / rate
    sig = (0.3 * np.sin(2 * np.pi * 220 * tt) * (1 + np.sin(2 * np.pi * 3 * tt))
           + 0.1 * np.sin(2 * np.pi * 330 * tt)
           + 0.05 * np.random.default_rng(12).standard_normal(tt.size))
    from tts_tpu_torch.audio.wav import write_wav

    iref = os.path.join(ckpt_root, "index_ref.wav")
    write_wav(iref, (sig * 12000).astype(np.int16), rate)
    t0 = time.perf_counter()
    itok = IndexTTSTokenizer(os.path.join(idir, "bpe.model"))
    sentences = split_sentences(itok.tokenize(CLI_TEXT))
    sent_ids = [np.array([itok.convert_tokens_to_ids(s)], np.int32) for s in sentences]
    print(f"  {name_limit}: cli indextts: bpe.model read and {CLI_TEXT!r} tokenized in "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms: {len(sentences)} sentences of "
          f"{[s.shape[1] for s in sent_ids]} ids", flush=True)
    igen = CLI_CAPS["indextts"]

    def index_expect(calls):
        _, _, _, (_, stats), _, _ = calls[0]
        k10 = sum(kernel10_per_call(ivcfg, min(max(8, -(-(s.tokens - 2) // 8) * 8), igen))
                  for s in stats if s.tokens > 2)
        return {"fused_qkv_rope": icfg.gpt_layers * sum(s.tokens - 1 for s in stats),
                "amp_block_fused": k10}

    def index_direct(calls):
        pipe, a, kw, (wav, stats), _, _ = calls[0]
        got = [i for _, i, _ in id_calls]
        if len(got) != len(sent_ids) or not all(np.array_equal(g, s)
                                                for g, s in zip(got, sent_ids)):
            raise AssertionError("cli indextts: the sentences' ids differ from bpe.model's")
        length = sum(max(s.tokens - 2, 0) for s in stats) * ivcfg.total_upsample \
            + len(stats) * int(rate * 0.2)
        return pipe.synthesize(*a, **kw)[0], rate, length

    id_calls = []
    real_ids = IndexTTSPipeline.synthesize_ids

    def record_ids(self, text_ids, *a, **kw):
        id_calls.append((self, text_ids, kw))
        return real_ids(self, text_ids, *a, **kw)

    IndexTTSPipeline.synthesize_ids = record_ids
    try:
        add(run_cli_command(
            name_limit, "indextts", ["indextts", "--ckpt", idir, "--ref-audio", iref,
                                     "--text", CLI_TEXT, "--max-tokens", str(igen),
                                     "--out", os.path.join(ckpt_root, "cli_indextts.wav")],
            IndexTTSPipeline, "synthesize", [(index_loader, ("load_indextts",))],
            index_expect, index_direct))
    finally:
        IndexTTSPipeline.synthesize_ids = real_ids
    if not keep:
        shutil.rmtree(idir)
    free()

    # VoxCPM-2
    vcfg = voxcpm_v2_config()
    t0 = time.perf_counter()
    vdir2, size = write_voxcpm_checkpoint(os.path.join(ckpt_root, "voxcpm"), vcfg, 70)
    written("VoxCPM-2", t0, size)
    ids, plain, lms, tms = _hf_ids(vdir2, lambda t: np.asarray(
        [mask_multichar_chinese_tokens(t)(normalize_voxcpm_text(CLI_TEXT))], np.int32))
    layers = vcfg.base.num_layers + vcfg.residual.num_layers

    def vox_expect(calls):
        return {"fused_qkv_attn": layers * calls[0][3][1]["latents"]}

    def vox_direct(calls):
        pipe, a, kw, (wav, st), _, _ = calls[0]
        same_ids("voxcpm", a[1], ids, plain, lms, tms)
        if a[0].shape != (1, 0) or a[2] is not None:
            raise AssertionError("cli voxcpm: a prompt was passed")
        return (pipe.synthesize_ids(*a, **kw)[0], pipe.output_sample_rate,
                st["latents"] * vcfg.samples_per_latent)

    add(run_cli_command(
        name_limit, "voxcpm --v2", ["voxcpm", "--v2", "--ckpt", vdir2, "--text", CLI_TEXT,
                                    "--max-latents", str(CLI_CAPS["voxcpm"]),
                                    "--out", os.path.join(ckpt_root, "cli_voxcpm.wav")],
        VoxCPMPipeline, "synthesize_ids", [(vox_loader, ("load_voxcpm",))], vox_expect,
        vox_direct))
    if not keep:
        shutil.rmtree(vdir2)
    free()
    return launches


# ----------------------------------------------------------------------------
# Phase 14: voice clone, streaming, int4 on the AR families, VoxCPM's output rate

CLONE_REF_IDS = np.arange(40, 52, dtype=np.int32)[None]     # the reference's text
STREAM = dict(chunk_frames=24, window=72, left_context=24)    # Qwen's defaults
NEAR_TIE = 1e-4             # codes may differ where two distances lie this close
SPK_TOL = 1e-4              # speaker embedding, card against CPU, rel L2
INT4_LEN = {"kani": 32, "qwen": 8, "voxcpm": 8}


def rvq_code_inputs(params: dict, emb: torch.Tensor, cfg, nq: int) -> list:
    """The vector each RVQ group's nearest-code search takes: the semantic
    projection, then the acoustic residual before each acoustic group."""
    from tts_tpu_torch.models.qwen_encoder import _nearest_code

    ins = [torch.matmul(emb, params["sem_in_proj"])]
    res = torch.matmul(emb, params["ac_in_proj"])
    for g in range(nq - 1):
        ins.append(res)
        cb = params["ac_codebooks"][g]
        res = res - cb[_nearest_code(res, cb).long()]
    return ins


def codes_near_ties(codes: np.ndarray, ref: np.ndarray, params: dict, emb_fn, cfg) -> int:
    """Frames whose codes differ from `ref` (the CPU run's); each must differ
    first at a group whose two least squared distances (in float64, from
    the CPU run's input to that group; emb_fn() gives its embeddings) lie
    within NEAR_TIE of each other, relative. Returns the count; raises on
    any other difference."""
    diff = np.nonzero((codes != ref).any(axis=1))[0]
    if not len(diff):
        return 0
    ins = rvq_code_inputs(params, emb_fn(), cfg, ref.shape[1])
    for t in diff:
        g = int(np.nonzero(codes[t] != ref[t])[0][0])
        cb = (params["sem_codebook"] if g == 0 else params["ac_codebooks"][g - 1]).double()
        d = ((ins[g][0, t].double()[None] - cb) ** 2).sum(-1)
        d1, d2 = torch.topk(d, 2, largest=False).values.tolist()
        if d2 - d1 > NEAR_TIE * d2:
            raise AssertionError(f"frame {t}: codes differ at group {g}, whose two best "
                                 f"distances {d1:.6g} and {d2:.6g} are no near tie")
    return len(diff)


def grew_of(before: dict) -> dict:
    from tts_tpu_torch.ops._build import LAUNCHES

    return {k: LAUNCHES[k] - before.get(k, 0) for k in KERNELS if LAUNCHES[k] != before.get(k, 0)}


def timed_stream(gen) -> tuple:
    """(chunks, seconds to the first chunk, seconds to the last) of a
    generator of int16 chunks."""
    t0 = time.perf_counter()
    chunks, first = [], None
    for c in gen:
        if first is None:
            first = time.perf_counter() - t0
        chunks.append(c)
    return chunks, first, time.perf_counter() - t0


def assembled(decode_fn, frames: np.ndarray, chunk: int, window: int, left: int,
              upsample: int, groups: int) -> np.ndarray:
    """runtime/streaming.ChunkedCodecStream over `frames`, pushed `chunk` at
    a time: what a stream of those frames must give."""
    from tts_tpu_torch.runtime.streaming import ChunkedCodecStream

    stream = ChunkedCodecStream(decode_fn, window=window, left_context=left,
                                upsample=upsample, num_groups=groups)
    out = []
    for i in range(0, len(frames), chunk):
        c = stream.push_frames(frames[i:i + chunk])
        if c is not None and len(c):
            out.append(c)
    out.extend(stream.finish())
    return np.concatenate(out)


def check_clone_step(pipe, prefill: torch.Tensor) -> None:
    """One talker step after the voice-clone prefill at full width: kernel 12
    (28 launches) in bf16 against the step's twins in bf16 and in fp32
    (params and cache cast), as check_qwen_step: the kernel route no further
    from the fp32 twins than STEP_SLACK times the bf16 twins."""
    from tts_tpu_torch.kv.cache import KVCache
    from tts_tpu_torch.models.qwen_tts import qwen3_stack_step
    from tts_tpu_torch.ops._build import LAUNCHES

    p, t = pipe.params, pipe.cfg.talker
    p_len = prefill.shape[1]
    kv = KVCache.create(t.num_layers, 1, t.num_kv_heads, pipe._kv_max(512), t.head_dim,
                        torch.bfloat16, "cuda")
    _, kv = qwen3_stack_step(p["talker"], prefill.to(torch.bfloat16), kv, t,
                             p["rope_cos"][:p_len], p["rope_sin"][:p_len], return_all=True)
    x = prefill[:, -1:]
    rc, rs = p["rope_cos"][p_len:p_len + 1], p["rope_sin"][p_len:p_len + 1]

    def step(params, dt):
        c = KVCache(kv.k.to(dt).clone(), kv.v.to(dt).clone(), p_len)
        return qwen3_stack_step(params, x.to(dt), c, t, rc.to(dt), rs.to(dt),
                                fused="step")[0].float()

    before = LAUNCHES["fused_qkv_attn"]
    kern = step(p["talker"], torch.bfloat16)
    k12 = LAUNCHES["fused_qkv_attn"] - before
    with twins_in_qwen():
        twin = step(p["talker"], torch.bfloat16)
        ref = step(cast_tree(p["talker"], torch.float32), torch.float32)
    e_k, e_t = rel_l2(kern, ref), rel_l2(twin, ref)
    ok = bool(torch.isfinite(kern).all()) and e_k <= STEP_SLACK * e_t and k12 == t.num_layers
    print(f"  talker step after the clone prefill ({p_len} rows), rel L2 against the fp32 "
          f"twins: kernel 12 {e_k:.6g} ({k12} launches), bf16 twins {e_t:.6g} (limit "
          f"{STEP_SLACK} x) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the clone prefill's kernel-12 step is less accurate than its "
                             "twins or did not run through kernel 12")


def int4_request(name_limit: str, label: str, fn, units: int, unit: str) -> dict:
    """One quantize=4 request under torch.profiler (the card's activities:
    kernels, copies, fills):
    the audio finite and not silent, no launch of a hand-written kernel
    (every int4 wqkv keeps kernels 11 and 12 off, as tts_tpu's gate), the
    device time a unit beside the wall. Returns the launches."""
    from torch.profiler import ProfilerActivity, profile

    from tts_tpu_torch.ops._build import LAUNCHES

    before = dict(LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wav, n = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the card's activities summed straight from the trace's raw events:
    # key_averages() parses every event into Python first (8-17 s here)
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6
    grew = grew_of(before)
    print(f"  {name_limit}: {label} quantize=4: {n} {unit}s, {len(wav)} int16 samples, wall "
          f"{wall:.4f} s (profiled), device time {busy:.3f} ms = {busy / n:.4f} ms a {unit}, "
          f"peak |int16| {int(np.abs(wav.astype(np.int32)).max())}, launches {grew}",
          flush=True)
    if n != units or wav.dtype != np.int16 or not wav.any():
        raise AssertionError(f"{label} int4: {n} {unit}s, {wav.dtype}, expected {units} and "
                             f"audio that is not silent")
    if grew:
        raise AssertionError(f"{label} int4: launches {grew}, expected none (int4 wqkv)")
    return grew


def run_clone(name_limit: str, ckpt_root: str) -> dict:
    """Phase 14: a Qwen3-TTS-0.6B checkpoint with its Mimi and speaker
    encoders written from seeds (bf16), the encoders loaded to the card in
    fp32 (the talker and codec are phase 7's, from seeds, bf16);
    encode_reference on the 6 s bench reference on the card and on the CPU;
    a voice-clone request (88 kernel-12 launches a frame) and one step of
    its prefill against the twins; Qwen and VoxCPM-2 streaming bitwise the
    window assembly over the non-streaming decode; VoxCPM-2 at 24 kHz
    bitwise resample_linear of the native request; kani-tts-370m,
    Qwen3-TTS-0.6B and VoxCPM-2 at quantize=4. Returns the launches."""
    import shutil
    from types import SimpleNamespace

    from tts_tpu_torch.audio.wav import resample_linear
    from tts_tpu_torch.models.kani import KaniConfig
    from tts_tpu_torch.models.kani import init_params as kani_init
    from tts_tpu_torch.models.nanocodec import NanoCodecConfig
    from tts_tpu_torch.models.nanocodec import init_params as codec_init
    from tts_tpu_torch.models.qwen_encoder import MimiEncoderConfig, mimi_encode
    from tts_tpu_torch.models.voxcpm import voxcpm_v2_config
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.kani import KaniDecodeConfig, KaniPipeline
    from tts_tpu_torch.runtime.qwen import QwenDecodeConfig, QwenTTSPipeline
    from tts_tpu_torch.runtime.voxcpm import VoxCPMDecodeConfig, VoxCPMPipeline
    from tts_tpu_torch.weights import place, read_safetensors
    from tts_tpu_torch.weights.loaders import host_state_dict
    from tts_tpu_torch.weights.qwen_loader import load_qwen_encoder, qwen_speaker_from_state_dict

    launches: dict = {}
    t_start = time.perf_counter()

    def add(grew):
        for k, n in grew.items():
            launches[k] = launches.get(k, 0) + n

    def part(title: str) -> None:
        print(f"  -- {title} (phase 14 at {time.perf_counter() - t_start:.1f} s)", flush=True)

    # --- the encoders, from checkpoint files
    part("the encoders from checkpoint files")
    cfg, ccfg, params, cparams = qwen_models()
    ecfg = MimiEncoderConfig()
    t0 = time.perf_counter()
    qdir, size = write_qwen_checkpoint(os.path.join(ckpt_root, "qwen_clone"), cfg, ccfg, 70,
                                       ecfg=ecfg)
    print(f"  {name_limit}: wrote Qwen3-TTS-0.6B + codec + Mimi encoder + speaker encoder "
          f"({size / 2 ** 30:.3f} GiB bf16) in {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    enc, _ = load_qwen_encoder(qdir, ecfg)
    t1 = time.perf_counter()
    spk_sd = {k: v for k, v in read_safetensors(os.path.join(qdir, "model.safetensors")).items()
              if k.startswith("speaker_encoder.")}
    spk = place(qwen_speaker_from_state_dict(host_state_dict(spk_sd)), "cuda", torch.float32,
                kind="ecapa")
    torch.cuda.synchronize()
    print(f"  {name_limit}: load_qwen_encoder to the card (fp32, the directory's every "
          f"file read) {t1 - t0:.2f} s; the speaker encoder (its keys of model.safetensors) "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    shutil.rmtree(qdir)
    scfg = SimpleNamespace(res2net_scale=8)
    pipe = QwenTTSPipeline(params, cfg, cparams, ccfg, QwenDecodeConfig(max_frames=QWEN_FRAMES))
    ref = bench_audio(24000)
    enc_cpu, spk_cpu = cpu_tree(enc), cpu_tree(spk)
    t0 = time.perf_counter()
    pipe.encode_reference(ref, enc, ecfg, spk, scfg)                    # warm-up
    torch.cuda.synchronize()
    part(f"encode_reference's first call {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    codes, emb_spk = pipe.encode_reference(ref, enc, ecfg, spk, scfg)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    codes_cpu, spk_ref = pipe.encode_reference(ref, enc_cpu, ecfg, spk_cpu, scfg)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    codes_np, ref_np = codes.cpu().numpy(), codes_cpu.numpy()
    bucket = -(-len(ref) // pipe.REF_BUCKET) * pipe.REF_BUCKET
    n_diff = codes_near_ties(codes_np, ref_np, enc_cpu, lambda: mimi_encode(
        enc_cpu, torch.as_tensor(np.pad(ref.astype(np.float32) / 32768.0,
                                        (0, bucket - len(ref)))[None]), ecfg), ecfg)
    e_spk = rel_l2(emb_spk.cpu(), spk_ref)
    groups_used = [len(np.unique(ref_np[:, g])) for g in range(ref_np.shape[1])]
    print(f"  {name_limit}: encode_reference (6 s at 24 kHz, a {bucket}-sample bucket): codes "
          f"{tuple(codes_np.shape)}, {n_diff} frames differ from the CPU run's (each at a near "
          f"tie, {NEAR_TIE} relative), distinct codes a group {groups_used}; speaker "
          f"embedding {tuple(emb_spk.shape)} rel L2 {e_spk:.3g} against the CPU run's (limit "
          f"{SPK_TOL}); {enc_ms:.2f} ms on the card (fp32, TF32 off), {cpu_ms:.1f} ms on the "
          f"CPU", flush=True)
    if e_spk > SPK_TOL or codes_np.shape != (bucket // 1920, cfg.num_code_groups):
        raise AssertionError("encode_reference: the card's output is not the CPU's")

    # --- a voice-clone request (phase 13's qwen command's cap)
    part("a voice-clone request")
    per_iter = cfg.talker.num_layers + (cfg.num_code_groups - 1) * cfg.predictor.num_layers
    cap = CLI_CAPS["qwen"]
    clone = QwenTTSPipeline(params, cfg, cparams, ccfg, QwenDecodeConfig(max_frames=cap))
    prefill, trailing = clone.build_prefill_voice_clone(QWEN_IDS, CLONE_REF_IDS, QWEN_LANG,
                                                        codes, emb_spk)
    before = dict(LAUNCHES)
    wav, st = clone.synthesize_from_prefill(prefill, trailing)
    grew = grew_of(before)
    iters = qwen_frames_run(st["frames"], cap)
    print(f"  {name_limit}: voice-clone request: prefill {tuple(prefill.shape)} ({len(codes)} "
          f"reference frames), trailing {tuple(trailing.shape)}; {st['frames']} frames, "
          f"{len(wav)} int16 samples, wall {st['wall_s']:.4f} s, launches {grew} "
          f"({grew.get('fused_qkv_attn', 0) / iters:.1f} of kernel 12 a frame step of the "
          f"programs)",
          flush=True)
    if grew != {"fused_qkv_attn": per_iter * iters} or not wav.any() \
            or not math.isfinite(st["peak"]):
        raise AssertionError(f"voice clone: launches {grew}, expected {per_iter} of kernel "
                             f"12 a frame, and audio that is finite and not silent")
    add(grew)
    check_clone_step(clone, prefill)
    del clone

    # --- Qwen streaming of the bench request
    part("Qwen streaming")
    pre, tr = pipe.build_prefill_embeds(QWEN_IDS, QWEN_LANG)
    before = dict(LAUNCHES)
    chunks, first, wall = timed_stream(pipe.synthesize_streaming(pre, tr, **STREAM))
    grew = grew_of(before)
    add(grew)
    decoded, real = [], pipe._decode
    pipe._decode = lambda *a: decoded.append(real(*a)) or decoded[-1]
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    pipe.synthesize_from_prefill(pre, tr)
    plain_wall = time.perf_counter() - t0
    del pipe._decode
    add(grew_of(before))
    frames, n = decoded[0]
    tb = pipe._trailing_bucket(tr)
    on_graphs = [d.step for d in pipe._codec_cache[("chunk", STREAM["chunk_frames"], tb)]
                 + pipe._decode_fn[tb]] + [pipe._codec_cache[STREAM["window"]]]
    if any(prog._graph is None for prog in on_graphs):
        raise AssertionError("Qwen stream: its decode or window codec is not on a CUDA graph")
    want = assembled(pipe._codec_window, frames[:n].cpu().numpy(), STREAM["chunk_frames"],
                     STREAM["window"], STREAM["left_context"], ccfg.total_upsample,
                     cfg.num_code_groups)
    got = np.concatenate(chunks)
    same = np.array_equal(got, want)
    print(f"  {name_limit}: Qwen stream (chunk {STREAM['chunk_frames']}, window "
          f"{STREAM['window']}, left {STREAM['left_context']}) of the bench request: "
          f"{len(chunks)} chunks, {len(got)} samples ({n} frames), first chunk {first:.4f} s, "
          f"whole stream {wall:.4f} s, the non-streaming request {plain_wall:.4f} s; bitwise "
          f"the assembly over _decode's frames: {same}; launches {grew}", flush=True)
    if not same or n != QWEN_FRAMES or grew != {"fused_qkv_attn": per_iter * n}:
        raise AssertionError("Qwen stream: not the window assembly over _decode's frames, "
                             "or not every frame through kernel 12")
    del pipe, frames

    # --- VoxCPM-2: a stream, and 24 kHz output
    part("VoxCPM-2 streaming and 24 kHz")
    cfg2 = voxcpm_v2_config()
    params2, vae2 = voxcpm_models(cfg2, 30)
    dec = VoxCPMDecodeConfig(max_latents=VOX_LATENTS, min_latents=VOX_LATENTS)
    vox = VoxCPMPipeline(params2, cfg2, vae2, dec)
    segs = [("text", np.concatenate([VOX_PROMPT[0], VOX_TARGET[0],
                                     [cfg2.audio_start_id]]).astype(np.int32))]
    zero = vox._zero_cond()
    max_steps = VOX_TARGET.shape[1] * dec.decode_limit_factor + 10
    noise = torch.randn((VOX_LATENTS, 1, cfg2.patch_size, cfg2.vae.latent_dim),
                        generator=torch.Generator("cuda").manual_seed(14), device="cuda")
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    native, st = vox._run_segments(segs, zero, max_steps, None, noise)
    plain_wall = time.perf_counter() - t0
    add(grew_of(before))
    # the request's latents: its decode state's, where the request left them
    (state,) = vox._dec_cache[(64, vox._latent_buf(max_steps))]
    lat_box = [state.latents.clone()]
    # the window program's capture, before the timed stream
    vox._vae_dec_fn(np.zeros((1, 5, cfg2.patch_size, cfg2.vae.latent_dim), np.float32))
    before = dict(LAUNCHES)
    chunks, first, wall = timed_stream(vox.synthesize_streaming(segs, zero, max_steps, chunk=4,
                                                                noise=noise))
    grew = grew_of(before)
    add(grew)
    got = np.concatenate(chunks)
    want = assembled(vox._vae_dec_fn, lat_box[0][0, :st["latents"]].cpu().numpy(), 4, 5, 1,
                     cfg2.samples_per_latent, cfg2.patch_size)
    layers = cfg2.base.num_layers + cfg2.residual.num_layers
    n_lat = len(got) // cfg2.samples_per_latent
    same = np.array_equal(got, want)
    print(f"  {name_limit}: VoxCPM-2 stream (chunk 4, window 5, left 1): {len(chunks)} chunks, "
          f"{len(got)} samples ({n_lat} latents; _run_segments {st['latents']}), first chunk "
          f"{first:.4f} s, whole stream {wall:.4f} s, the non-streaming request "
          f"{plain_wall:.4f} s; bitwise the assembly over _run_segments' latents: {same}; "
          f"launches {grew}", flush=True)
    if not same or n_lat != st["latents"] or grew != {"fused_qkv_attn": layers * n_lat}:
        raise AssertionError("VoxCPM stream: not the window assembly over the request's "
                             "latents, or not every latent through kernel 12")
    vox24 = VoxCPMPipeline(params2, cfg2, vae2, dec, output_sample_rate=24000)
    wav24, st24 = vox24._run_segments(segs, zero, max_steps, None, noise)
    same = np.array_equal(wav24, resample_linear(native, cfg2.output_sample_rate, 24000))
    print(f"  {name_limit}: VoxCPM-2 at output_sample_rate=24000: {len(wav24)} samples (native "
          f"{len(native)} at {cfg2.output_sample_rate} Hz), stats rate {st24['sample_rate']}, "
          f"bitwise resample_linear of the native request: {same}", flush=True)
    if not same or st24["sample_rate"] != 24000:
        raise AssertionError("VoxCPM at 24 kHz is not resample_linear of the native request")
    del vox, vox24

    # --- quantize=4 on the AR families
    part("quantize=4")
    kcfg, kccfg = KaniConfig(max_seq_len=2048, stop_token=-1), NanoCodecConfig()
    kparams = kani_init(kcfg, torch.Generator("cuda").manual_seed(2), torch.bfloat16)
    kcparams = codec_init(kccfg, torch.Generator("cuda").manual_seed(3), torch.bfloat16)
    for label, make, run, unit in (
            ("kani-tts-370m", lambda: KaniPipeline(
                kparams, kcfg, kcparams, kccfg,
                KaniDecodeConfig(max_new_tokens=INT4_LEN["kani"], repeat_penalty=1.0),
                quantize=4),
             lambda p: (lambda w, s: (w, s["tokens"]))(*p.synthesize_ids(
                 np.array(KANI_IDS, np.int32))), "token"),
            ("Qwen3-TTS-0.6B", lambda: QwenTTSPipeline(
                params, cfg, cparams, ccfg, QwenDecodeConfig(max_frames=INT4_LEN["qwen"]),
                quantize=4),
             lambda p: (lambda w, s: (w, s["frames"]))(*p.synthesize_ids(
                 QWEN_IDS, language_id=QWEN_LANG)), "frame"),
            ("VoxCPM-2", lambda: VoxCPMPipeline(
                params2, cfg2, vae2, VoxCPMDecodeConfig(max_latents=INT4_LEN["voxcpm"],
                                                        min_latents=INT4_LEN["voxcpm"]),
                quantize=4),
             lambda p: (lambda w, s: (w, s["latents"]))(*p.synthesize_ids(
                 VOX_PROMPT, VOX_TARGET)), "latent")):
        t0 = time.perf_counter()
        q4 = make()
        torch.cuda.synchronize()
        print(f"  {label}: quantize=4 (the jitted k_quant form) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        key = {"token": "kani", "frame": "qwen", "latent": "voxcpm"}[unit]
        run(q4)             # warm-up: the first request captures the programs
        int4_request(name_limit, label, lambda: run(q4), INT4_LEN[key], unit)
        del q4
    part("done")
    return launches


# ----------------------------------------------------------------------------
# Phase 15: the parity harness (tts_tpu_torch/parity) against stand-in sessions

# 41 bytes: with phase 12's 6 s reference and REF_TEXT, f5_duration gives
# 1,024 frames, a multiple of 128, so the bf16 DiT takes kernels 1-3
PARITY_GEN_TEXT = "The quick brown fox jumps over a lazy dog"
# the session-mode families in the order phase 15 runs them, each with its
# stand-ins' driver (None: run_reference's own session function)
PARITY_DRIVERS = {"f5": None, "bigvgan": None, "kani": "kani_session_stages",
                  "indextts": "indextts_session_stages", "qwen": "qwen_session_stages",
                  "voxcpm": "voxcpm_session_stages"}


@contextlib.contextmanager
def all_twins():
    """Every model module's kernel wrappers through their plain twins: the
    DiT's (kernels 1-8), Qwen's (11-15), kernel 10 and the decode heads of
    Kani, IndexTTS and VoxCPM (11, 12)."""
    import tts_tpu_torch.models.indextts as mi
    import tts_tpu_torch.models.kani as mk
    import tts_tpu_torch.models.voxcpm as mv
    import tts_tpu_torch.ops.bigvgan_stage as k10
    from tts_tpu_torch.ops import decode_qkv, decode_step

    heads = {"fused_qkv_rope": decode_qkv.fused_qkv_rope_plain,
             "fused_qkv_attn": decode_step.fused_qkv_attn_plain}
    with contextlib.ExitStack() as stack:
        stack.enter_context(twins_in_dit())
        stack.enter_context(twins_in_qwen())
        stack.enter_context(swapped(k10, {"amp_block_fused": k10.amp_block_fused_plain}))
        for m in (mk, mi, mv):
            stack.enter_context(swapped(m, heads))
        yield


@contextlib.contextmanager
def cached_loads():
    """The loaders run_reference calls, memoized on their arguments for the
    block: a family's trees load once for its passes and its stand-ins."""
    import tts_tpu_torch.weights.f5_loader as f5l
    import tts_tpu_torch.weights.indextts_loader as il
    import tts_tpu_torch.weights.kani_loader as kl
    import tts_tpu_torch.weights.loaders as bl
    import tts_tpu_torch.weights.qwen_loader as ql
    import tts_tpu_torch.weights.voxcpm_loader as vl

    memo: dict = {}

    def cached(fn):
        def load(*a, **kw):
            key = (fn.__name__, a, tuple(sorted((k, str(v)) for k, v in kw.items())))
            if key not in memo:
                memo[key] = fn(*a, **kw)
            return memo[key]
        return load

    with contextlib.ExitStack() as stack:
        for mod, names in ((f5l, ("load_f5", "load_vocos")), (bl, ("load_bigvgan",)),
                           (kl, ("load_kani_lm", "load_nanocodec")),
                           (ql, ("load_qwen_tts", "load_qwen_codec")),
                           (il, ("load_indextts",)), (vl, ("load_voxcpm",))):
            stack.enter_context(swapped(mod, {n: cached(getattr(mod, n)) for n in names}))
        yield memo


def write_bigvgan_dir(dirname: str, cfg, params: dict) -> str:
    """A HF-style BigVGAN dir (config.json + bigvgan_generator.pt) in the
    upstream keys from a params tree (AMPBlock1, snakebeta in log scale):
    each conv (k, in, out) back to (out, in, k) (ConvTranspose1d (in, out,
    k)), log(alpha) and log(1 / beta_recip - 1e-9), the loader's inverse."""
    if cfg.resblock != "1" or cfg.activation != "snakebeta" or not cfg.snake_logscale:
        raise ValueError("write_bigvgan_dir writes AMPBlock1 with log-scale snakebeta")
    sd: dict = {}

    def conv(pre, p, transposed=False):
        w = p["w"].float().cpu()
        sd[f"{pre}.weight"] = (w.permute(1, 2, 0) if transposed else w.permute(2, 1, 0)).contiguous()
        if "b" in p:
            sd[f"{pre}.bias"] = p["b"].float().cpu()

    def act(pre, p):
        sd[f"{pre}.alpha"] = p["alpha"].double().cpu().log().float()
        sd[f"{pre}.beta"] = (1.0 / p["beta_recip"].double().cpu() - 1e-9).log().float()

    conv("conv_pre", params["conv_pre"])
    for i, up in enumerate(params["ups"]):
        conv(f"ups.{i}.0", up, transposed=True)
    for n, rb in enumerate(params["resblocks"]):
        for m in range(len(rb["convs1"])):
            conv(f"resblocks.{n}.convs1.{m}", rb["convs1"][m])
            conv(f"resblocks.{n}.convs2.{m}", rb["convs2"][m])
            act(f"resblocks.{n}.activations.{2 * m}.act", rb["acts1"][m])
            act(f"resblocks.{n}.activations.{2 * m + 1}.act", rb["acts2"][m])
    act("activation_post.act", params["act_post"])
    conv("conv_post", params["conv_post"])
    os.makedirs(dirname, exist_ok=True)
    torch.save({"generator": sd}, os.path.join(dirname, "bigvgan_generator.pt"))
    h = {"num_mels": cfg.num_mels, "upsample_initial_channel": cfg.upsample_initial_channel,
         "upsample_rates": list(cfg.upsample_rates),
         "upsample_kernel_sizes": list(cfg.upsample_kernel_sizes),
         "resblock_kernel_sizes": list(cfg.resblock_kernel_sizes),
         "resblock_dilation_sizes": [list(d) for d in cfg.resblock_dilation_sizes],
         "activation": cfg.activation, "snake_logscale": cfg.snake_logscale,
         "use_bias_at_final": cfg.use_bias_at_final, "use_tanh_at_final": cfg.use_tanh_at_final,
         "sampling_rate": cfg.sample_rate, "resblock": cfg.resblock}
    with open(os.path.join(dirname, "config.json"), "w") as f:
        json.dump(h, f)
    return dirname


def index_vocoder_cfg(icfg):
    """IndexTTS-1.5's vocoder at phase 9's rates (from 1280 GPT features)."""
    from tts_tpu_torch.models.bigvgan import BigVGANConfig

    return BigVGANConfig(num_mels=icfg.gpt_dim, upsample_rates=(4, 4, 4, 4, 2, 2),
                         upsample_kernel_sizes=(8, 8, 4, 4, 4, 4),
                         use_tanh_at_final=True, use_bias_at_final=True)


def parity_artifacts(name_limit: str, root: str, f5_files: dict | None) -> dict:
    """The artifact directories of phase 15 under `root`: f5/ (links to
    phase 12's files, ref.txt, gen.txt), bigvgan/ (phase 8's weights in the
    upstream keys), and phase 13's kani/, qwen/, indextts/ and voxcpm/
    checkpoint directories (written here with phase 13's writers and seeds
    where phase 13 did not keep them); each holds empty graph files named as
    its stand-ins. Returns {family: (dir, the stand-ins' builder)}."""
    from tts_tpu_torch.models.bigvgan import BigVGANConfig
    from tts_tpu_torch.models.f5 import F5Config
    from tts_tpu_torch.models.indextts import IndexTTSConfig
    from tts_tpu_torch.models.kani import KaniConfig
    from tts_tpu_torch.models.nanocodec import NanoCodecConfig
    from tts_tpu_torch.models.qwen_codec import QwenCodecDecoderConfig
    from tts_tpu_torch.models.qwen_tts import QwenTTSConfig
    from tts_tpu_torch.models.vocos import VocosConfig
    from tts_tpu_torch.models.voxcpm import voxcpm_v2_config

    t0 = time.perf_counter()
    wrote = []
    if f5_files is None:
        ckpt, vocab, _ = write_f5_checkpoint(root, F5Config(vocab_size=F5_VOCAB_LINES), seed=20)
        vdir = write_vocos_checkpoint(root, VocosConfig(), seed=21)
        ref_path = os.path.join(root, "ref.wav")
        write_stereo_reference(ref_path, 6.0, seed=22)
        f5_files = {"ckpt": ckpt, "vocab": vocab, "vocoder": vdir, "ref": ref_path}
        wrote.append("f5")
    f5 = os.path.join(root, "f5")
    os.makedirs(f5, exist_ok=True)
    for key, name in (("ckpt", os.path.basename(f5_files["ckpt"])), ("vocab", "vocab.txt"),
                      ("vocoder", "vocos"), ("ref", "ref.wav")):
        os.symlink(f5_files[key], os.path.join(f5, name))
    with open(os.path.join(f5, "ref.txt"), "w") as f:
        f.write(REF_TEXT)
    with open(os.path.join(f5, "gen.txt"), "w") as f:
        f.write(PARITY_GEN_TEXT)
    bcfg = BigVGANConfig()
    write_bigvgan_dir(os.path.join(root, "bigvgan"), bcfg,
                      bigvgan_weights(bcfg, 9, torch.float32))
    writers = {
        "kani": lambda d: write_kani_checkpoint(d, KaniConfig(), NanoCodecConfig(), 40),
        "qwen": lambda d: write_qwen_checkpoint(d, QwenTTSConfig(), QwenCodecDecoderConfig(), 50),
        "indextts": lambda d: write_indextts_checkpoint(
            d, IndexTTSConfig(), index_vocoder_cfg(IndexTTSConfig()), 60),
        "voxcpm": lambda d: write_voxcpm_checkpoint(d, voxcpm_v2_config(), 70)}
    for fam, write in writers.items():
        if not os.path.isdir(os.path.join(root, fam)):
            write(os.path.join(root, fam))
            wrote.append(fam)
    print(f"  {name_limit}: artifact dirs under {root} in {time.perf_counter() - t0:.2f} s "
          f"(written here: {wrote or 'none, phases 12-13 kept theirs'}; bigvgan/ from phase "
          f"8's seed)", flush=True)
    return f5_files


def parity_standins(fam: str, art: str) -> dict:
    """fam's stand-ins over its files loaded to the card in fp32 (through
    the loaders run_reference calls), every kernel through its twin."""
    from tts_tpu_torch.parity import standins as SI
    from tts_tpu_torch.weights import f5_loader, indextts_loader, kani_loader, loaders
    from tts_tpu_torch.weights import qwen_loader, voxcpm_loader

    f32 = dict(dtype=torch.float32, device="cuda")
    if fam == "f5":
        import glob

        params, cfg, _ = f5_loader.load_f5(glob.glob(os.path.join(art, "*.safetensors"))[0],
                                           os.path.join(art, "vocab.txt"), **f32)
        vparams, vcfg = f5_loader.load_vocos(os.path.join(art, "vocos"), **f32)
        return SI.f5_standins(params, cfg, vparams, vcfg, seed=15, wrap=all_twins)
    if fam == "bigvgan":
        return SI.bigvgan_standins(*loaders.load_bigvgan(art, **f32), wrap=all_twins)
    if fam == "kani":
        params, cfg = kani_loader.load_kani_lm(art, **f32)
        cparams, ccfg = kani_loader.load_nanocodec(os.path.join(art, "nano_codec.nemo"), **f32)
        return SI.kani_standins(params, cfg, cparams, ccfg, wrap=all_twins)
    if fam == "indextts":
        params, cfg, _ = indextts_loader.load_indextts(art, **f32)
        return SI.indextts_standins(params["gpt"], cfg, wrap=all_twins)
    if fam == "qwen":
        params, cfg = qwen_loader.load_qwen_tts(art, **f32)
        cparams, ccfg = qwen_loader.load_qwen_codec(art, **f32)
        return SI.qwen_standins(params, cfg, cparams, ccfg, wrap=all_twins)
    params, vae, cfg = voxcpm_loader.load_voxcpm(art, **f32)
    return SI.voxcpm_standins(params, cfg, vae["dec"], wrap=all_twins)


def parity_expect(fam: str, art: str, dt) -> dict:
    """The launches one session-mode run of `fam` makes on the kernels'
    route in dt (the stand-ins run the twins): F5 22 blocks x 31 steps of
    kernels 1 and 3 and 31 of kernel 2 in bf16, kernel 4 in fp32; BigVGAN
    kernel 10 as its gate picks a call; Qwen's predictor frame kernel 12 at
    each of its 15 decode steps x 4 layers; the prefills none."""
    from tts_tpu_torch.models.f5 import F5Config
    from tts_tpu_torch.models.qwen_tts import QwenTTSConfig
    from tts_tpu_torch.weights.loaders import bigvgan_config_from_json

    if fam == "f5":
        cfg = F5Config()
        steps = cfg.nfe_steps - 1
        if dt == torch.float32:
            return {"flash_attention_onepass": cfg.depth * steps}
        return {"flash_attention_flat": cfg.depth * steps, "mlp_block_fused": cfg.depth * steps,
                "conv_pos_embed_fused": steps}
    if fam == "bigvgan":
        name = "amp_block_fused" if dt == torch.bfloat16 else "amp_block_fused_f32"
        cfg = bigvgan_config_from_json(os.path.join(art, "config.json"))
        return {name: kernel10_per_call(cfg, 512, dt)}
    if fam == "qwen":
        cfg = QwenTTSConfig()
        return {"fused_qkv_attn": (cfg.num_code_groups - 1) * cfg.predictor.num_layers}
    return {}


def parity_pass(rr, root: str, fam: str, dt, twins: bool) -> tuple:
    """One run_reference.run_all over `fam` on the card in dt, "ours"
    through the kernels or (twins) their plain twins. Returns (the session
    result, its stage diffs, the launches, seconds); an "error" result or
    none in session mode fails."""
    import tts_tpu_torch.parity.sessions as S
    from tts_tpu_torch.ops._build import LAUNCHES

    stages: list = []
    drv = PARITY_DRIVERS[fam]
    spy = {}
    if drv:
        real = getattr(S, drv)
        spy = {drv: lambda *a, **kw: stages.extend(real(*a, **kw)) or stages}
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    with swapped(S, spy), (all_twins() if twins else contextlib.nullcontext()):
        results = rr.run_all(root, (fam,), "cuda", dt)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    grew = {k: LAUNCHES.get(k, 0) for k in KERNELS}
    for r in results:
        if r.mode == "error":
            raise AssertionError(f"parity {fam}: {r.line()}")
    ses = [r for r in results if r.mode == "session"]
    if len(ses) != 1:
        raise AssertionError(f"parity {fam}: no session-mode result: "
                             f"{[r.line() for r in results]}")
    return ses[0], stages, grew, seconds


def within_slack(kern: float, twin: float) -> bool:
    """The kernel route no further from the fp32 stand-ins than STEP_SLACK
    times the bf16 twins' (both 0 passes)."""
    return math.isfinite(kern) and kern <= STEP_SLACK * twin


def launches_of(grew: dict, into: dict) -> None:
    for k, n in grew.items():
        into[k] = into.get(k, 0) + n


def predictor_group_logits(params: dict, cfg, talker_h, tok0, prefix: list, g: int,
                           fused) -> torch.Tensor:
    """Group g's logits of a predictor frame whose groups 0..g-1 took the
    tokens `prefix`: `predictor_frame`'s loop on params' device and dtype
    on the route `fused`, stopped at g. fp32."""
    from tts_tpu_torch.models.qwen_tts import (_group_input, _predictor_prefill, _rope_row,
                                               qwen3_stack_step)

    dt = params["lm_heads"][0].dtype
    h, kv, _ = _predictor_prefill(params, talker_h.to(dt), tok0, cfg, 1)
    for j, tok in enumerate(prefix):
        rc, rs = _rope_row(params, kv.length)
        toks = torch.tensor([tok], dtype=torch.int32, device=tok0.device)
        h, kv = qwen3_stack_step(params["predictor"], _group_input(params, j, toks), kv,
                                 cfg.predictor, rc, rs, fused=fused)
    return torch.matmul(h, params["lm_heads"][g]).float()


def check_frame_flip(art: str, kern: tuple, twin: tuple) -> str:
    """The Qwen predictor frame is a chain of argmaxes: a flip at a near tie
    in one group changes every later code. Where the kernels' frame leaves
    the fp32 one (the fp32 twins' predictor_frame on the stand-ins' tree),
    compare group g's logits after the fp32 frame's prefix on the kernels
    and on the bf16 twins against fp32: the kernels' max |Δ| must be at most
    STEP_SLACK times the twins'. kern / twin: (talker_h, tok0, frame) of
    each route's predictor_frame call (bf16). Returns the line to print."""
    from tts_tpu_torch.models.qwen_tts import predictor_frame
    from tts_tpu_torch.weights import qwen_loader

    p16, cfg = qwen_loader.load_qwen_tts(art, dtype=torch.bfloat16, device="cuda")
    p32, _ = qwen_loader.load_qwen_tts(art, dtype=torch.float32, device="cuda")
    # the driver's fp32 talker hidden (seed 0, after the talker stage's draw),
    # which the kernels' call got rounded to bf16
    rng = np.random.default_rng(0)
    rng.standard_normal((1, 3, cfg.talker.hidden_size))
    th = torch.from_numpy(rng.standard_normal((1, 1, cfg.talker.hidden_size))
                          .astype(np.float32)).cuda()
    tok0 = kern[1]
    if not torch.equal(th.to(torch.bfloat16), kern[0]):
        raise AssertionError("check_frame_flip: the driver's talker hidden is not the seed's")
    with torch.no_grad():
        with all_twins():
            ref = predictor_frame(p32, th, tok0, cfg, fused=False)[0].tolist()
        got, tw = kern[2].tolist(), twin[2].tolist()
        if got == ref:
            return f"kernels' frame equals fp32's {ref}"
        i = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
        g, prefix = i - 1, ref[1:i]
        with all_twins():
            l32 = predictor_group_logits(p32, cfg, th, tok0, prefix, g, False)
            lt = predictor_group_logits(p16, cfg, th, tok0, prefix, g, "step")
        lk = predictor_group_logits(p16, cfg, th, tok0, prefix, g, "step")
    ek, et = ((x - l32).abs().max().item() for x in (lk, lt))
    l32 = l32.reshape(-1)
    margin = (l32[ref[i]] - l32[got[i]]).item()
    line = (f"the kernels' frame leaves fp32's at group {g} (code {got[i]} for {ref[i]}: fp32 "
            f"margin {margin:.6g}); group {g}'s logits after fp32's prefix, max |Δ| against "
            f"fp32: kernels {ek:.6g}, twins {et:.6g} (limit {STEP_SLACK} x); the twins' frame "
            f"{'equals' if tw == ref else 'differs from'} fp32's")
    if not within_slack(ek, et):
        raise AssertionError(f"parity qwen/predictor_frame: {line}")
    return line


def parity_family(name_limit: str, rr, root: str, fam: str, memo: dict) -> dict:
    """Phase 15b for one family inside cached_loads: its stand-ins over its
    files in fp32 through the twins, then the passes (bf16 kernels, bf16
    twins, fp32 for F5 and BigVGAN), each checked. Returns the launches of
    the kernels' and fp32 passes."""
    import tts_tpu_torch.models.qwen_tts as mq

    art = os.path.join(root, fam)
    t0 = time.perf_counter()
    table = parity_standins(fam, art)
    for name in table:
        open(os.path.join(art, name), "wb").close()
    load_s = time.perf_counter() - t0
    patch = {"_have_ort": lambda: True, "_session": lambda p: table[os.path.basename(p)]}
    passes = [("kernels", torch.bfloat16, False), ("twins", torch.bfloat16, True)]
    if fam in ("f5", "bigvgan"):
        passes.append(("fp32", torch.float32, False))
    out, frames = {}, []
    real_pf = mq.predictor_frame

    def spy_pf(params, talker_hidden, codec_token0, *a, **kw):
        res = real_pf(params, talker_hidden, codec_token0, *a, **kw)
        frames.append((talker_hidden, codec_token0, res[0]))
        return res

    with swapped(rr, patch), swapped(mq, {"predictor_frame": spy_pf}):
        for label, dt, twins in passes:
            out[label] = parity_pass(rr, root, fam, dt, twins)
    kern, twin = out["kernels"], out["twins"]
    res_line = "; ".join(f"{label} {r.mel_l1:.6g} in {s:.2f} s"
                         for label, (r, _, _, s) in out.items())
    print(f"  {name_limit}: parity {fam}: stand-ins loaded in fp32 in {load_s:.2f} s "
          f"({len(memo)} loads in all); worst |Δ| or mel L1 against the stand-ins: {res_line} "
          f"(budget {rr.MEL_L1_BUDGET:g}; bf16 {'within' if kern[0].passed else 'PAST'} it "
          f"on the kernels, {'within' if twin[0].passed else 'PAST'} on the twins)", flush=True)
    if len(kern[1]) != len(twin[1]) or (PARITY_DRIVERS[fam] and not kern[1]):
        raise AssertionError(f"parity {fam}: {len(kern[1])} stages on the kernels, "
                             f"{len(twin[1])} on the twins")
    for a, b in zip(kern[1], twin[1]):
        if a.stage != b.stage:
            raise AssertionError(f"parity {fam}: stages {a.stage} / {b.stage}")
        ok = within_slack(a.max_abs, b.max_abs)
        print(f"    {a.stage:26s} kernels {a.max_abs:.6g}  twins {b.max_abs:.6g}  "
              f"{'ok' if ok else 'past'} (limit {STEP_SLACK} x; budget "
              f"{'PASS' if a.ok else 'past'})", flush=True)
        if a.stage == "qwen/predictor_frame":
            print(f"      {check_frame_flip(art, frames[0], frames[1])}", flush=True)
        elif not ok:
            raise AssertionError(f"parity {fam}: {a.stage} on the kernels {a.max_abs:.6g}, "
                                 f"past {STEP_SLACK} x the twins' {b.max_abs:.6g}")
    if not PARITY_DRIVERS[fam] and not within_slack(kern[0].mel_l1, twin[0].mel_l1):
        raise AssertionError(f"parity {fam}: mel L1 on the kernels {kern[0].mel_l1:.6g}, "
                             f"past {STEP_SLACK} x the twins' {twin[0].mel_l1:.6g}")
    if "fp32" in out and not out["fp32"][0].passed:
        raise AssertionError(f"parity {fam} fp32: {out['fp32'][0].line()}")
    launches: dict = {}
    for label, (r, _, grew, _) in out.items():
        dt = torch.float32 if label == "fp32" else torch.bfloat16
        want = {} if label == "twins" else parity_expect(fam, art, dt)
        got = {k: n for k, n in grew.items() if n}
        print(f"    {label}: launches {got} (expected {want})  | {r.line()}", flush=True)
        if got != want:
            raise AssertionError(f"parity {fam} {label}: launches {got}, expected {want}")
        if label != "twins":
            launches_of(got, launches)
    return launches


def run_parity(name_limit: str, ckpt_root: str, f5_files: dict | None) -> dict:
    """Phase 15: stft_diff_report on the card; run_reference's session mode
    for F5, BigVGAN, Kani, IndexTTS, Qwen and VoxCPM at full width against
    stand-in sessions (the port's stage functions in fp32 through the
    twins, on the same checkpoint files): "ours" in bf16 through the
    kernels, again through the bf16 twins (each stage's error, or F5's and
    BigVGAN's mel L1, within STEP_SLACK of the twins'), and F5 and BigVGAN
    in fp32 (kernels 4 and 10 within the harness's 1e-2); the launches of
    each pass against the routes'; then Kani's wav mode through the CLI
    against phase 13's WAV of the same command (mel L1 0). Returns the
    launches of the kernel-route passes."""
    import shutil

    from tts_tpu_torch.parity import run_reference as rr
    from tts_tpu_torch.parity.compare import stft_diff_report

    t_phase = time.perf_counter()

    def part(label: str) -> None:
        print(f"  [{time.perf_counter() - t_phase:.1f} s] {label}", flush=True)

    # a. the STFT against torch.stft / istft on the card
    x = np.random.default_rng(0).standard_normal(16384).astype(np.float32) * 0.1
    rep = stft_diff_report(x, n_fft=512, hop=128, device="cuda")
    limits = {"stft_mean_abs_err": 1e-5, "istft_vs_torch_mean_abs_err": 1e-6,
              "roundtrip_mean_abs_err": 1e-6}
    print(f"  {name_limit}: stft_diff_report, tests/test_parity.py's signal (n_fft 512, hop "
          f"128): " + ", ".join(f"{k} {v:.3e} (limit {limits[k]:g})" for k, v in rep.items()),
          flush=True)
    if not all(rep[k] < lim for k, lim in limits.items()):
        raise AssertionError(f"stft_diff_report past its limits on the card: {rep}")
    bench = bench_audio(24000).astype(np.float32) / 32768.0
    rep = stft_diff_report(bench, n_fft=1024, hop=256, device="cuda")
    print(f"  {name_limit}: stft_diff_report, the 6 s bench reference (n_fft 1024, hop 256): "
          + ", ".join(f"{k} {v:.3e}" for k, v in rep.items()), flush=True)
    if not all(math.isfinite(v) for v in rep.values()):
        raise AssertionError(f"stft_diff_report not finite: {rep}")

    # b. session mode against the stand-ins
    f5_files = parity_artifacts(name_limit, ckpt_root, f5_files)
    part("artifacts ready")
    launches: dict = {}
    for fam in PARITY_DRIVERS:
        with cached_loads() as memo:
            launches_of(parity_family(name_limit, rr, ckpt_root, fam, memo), launches)
        torch.cuda.empty_cache()
        part(f"{fam} done")

    # c. Kani's wav mode through the CLI against phase 13's WAV of the command
    from tts_tpu_torch import cli
    from tts_tpu_torch.ops._build import LAUNCHES

    kdir = os.path.join(ckpt_root, "kani")
    nemo = os.path.join(kdir, "nano_codec.nemo")
    args = ["--codec", nemo, "--max-tokens", str(CLI_CAPS["kani"])]
    ref = os.path.join(ckpt_root, "cli_kani.wav")
    made = not os.path.exists(ref)
    if made:                                     # phase 13 did not run
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["kani", "--ckpt", kdir, "--text", CLI_TEXT, *args, "--out", ref])
    shutil.copy(ref, os.path.join(kdir, "reference.wav"))
    with open(os.path.join(kdir, "inputs.json"), "w") as f:
        json.dump({"text": CLI_TEXT, "cli_args": args}, f)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    # wav mode only: no graphs are opened (a present onnxruntime would try
    # the empty files)
    with swapped(rr, {"_have_ort": lambda: False}), contextlib.redirect_stdout(io.StringIO()):
        results = rr.run_all(ckpt_root, ("kani",), "cuda")
    seconds = time.perf_counter() - t0
    grew = {k: n for k, n in LAUNCHES.items() if n}
    print(f"  {name_limit}: parity kani wav mode (the CLI in bf16 against "
          f"{'a first run' if made else 'phase 13'}'s WAV of the same command): "
          f"{[r.line() for r in results]} in {seconds:.2f} s, launches {grew}", flush=True)
    if len(results) != 1 or results[0].mode != "wav" or results[0].mel_l1 != 0.0:
        raise AssertionError(f"parity kani wav mode: {[r.line() for r in results]}")
    launches_of(grew, launches)
    part("kani wav mode done")
    return launches


# phase 16: the second request of the bench bucket (1408 frames, 128 text
# ids, 832 generated frames, 163,840 audio samples) with its own
# ref_signal_len (544 against 563) and duration (1327 against 1396), and
# a second bucket (1024 frames, 448 generated) for the replay orders
GRAPH_REF_S = 5.8
GRAPH_TEXT_A2 = "word " * 14 + "wo"
GRAPH_WORDS_B = 8


def replay_check(label: str, fn, args: tuple, want: dict, name_limit: str,
                 timed: int = 2) -> tuple:
    """One call of a bucket's program (on its first call the warm-up, the
    capture and a replay) against its body run eagerly on the same inputs:
    every output bitwise, the call's kernel launches equal to the eager
    run's and to `want`; then the best of `timed` replays and of `timed`
    eager runs (host wall to a synchronize). Returns (the call's launches,
    the eager outputs)."""
    from tts_tpu_torch.ops._build import LAUNCHES

    first = fn._graph is None
    pool0 = fn.pool.nbytes()
    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    got = fn(*args)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    grew = serve_grew(before, KERNELS)
    before = dict(LAUNCHES)
    ref = fn._eager(*args)
    torch.cuda.synchronize()
    eager = serve_grew(before, KERNELS)
    same = [g.shape == r.shape and g.dtype == r.dtype and torch.equal(g, r)
            for g, r in zip(got, ref)]
    diffs = [(g.float() - r.float()).abs().max().item() if g.shape == r.shape else math.inf
             for g, r in zip(got, ref)]

    def walls(call):
        res = []
        for _ in range(timed):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            res.append(time.perf_counter() - t)
        return min(res)

    replay_s, eager_s = walls(lambda: fn(*args)), walls(lambda: fn._eager(*args))
    kept = {k: n for k, n in grew.items() if n}
    rec = {"graphs": label, "card": name_limit, "first_call": first, "call_s": call_s,
           "warmup_s": fn.warmup_s, "capture_s": fn.capture_s,
           "pool_bytes": fn.pool_bytes, "pool_grew_bytes": fn.pool_bytes - pool0,
           "replay_s": replay_s, "eager_s": eager_s, "launches": kept,
           "bitwise": all(same), "max_abs_diff": diffs}
    print(f"  {label}: {'first call (warm-up + capture + replay)' if first else 'replay'} "
          f"{call_s:.4f} s; warm-up {fn.warmup_s:.4f} s, capture {fn.capture_s:.4f} s, pool "
          f"{fn.pool_bytes / 2**20:.1f} MiB (+{(fn.pool_bytes - pool0) / 2**20:.1f}); "
          f"replay {replay_s:.4f} s, eager body {eager_s:.4f} s (best of {timed}); outputs "
          f"against the eager body: {'bitwise' if all(same) else f'max |diff| {diffs}'}; "
          f"launches {kept} (eager {({k: n for k, n in eager.items() if n})}) "
          f"{'ok' if all(same) and grew == eager and kept == want else 'FAIL'}", flush=True)
    print("  " + json.dumps(rec), flush=True)
    if not all(same):
        raise AssertionError(f"{label}: the replay differs from the eager body: {diffs}")
    if grew != eager or kept != want:
        raise AssertionError(f"{label}: launches {kept}, eager {eager}, expected {want}")
    return grew, ref


def request_program(pipe, audio: np.ndarray, text: str, seed: int) -> tuple:
    """(the program of a request's bucket, its inputs at `seed`'s draw)."""
    audio_p, ids_p, ref, dur, buckets, _ = pipe._prepare(audio, REF_TEXT, text)
    return pipe._get_fn(*buckets), pipe._inputs(audio_p, ids_p, [ref], [dur], buckets[2],
                                                seed, None)


def check_orders(pipe, progs: dict, refs: dict, per_req: dict) -> None:
    """The A, B, A and B, A, B orders of two buckets' programs (one shared
    pool), each order queued back to back and read after: every request's
    output bitwise its eager body's, the launches three requests'."""
    from tts_tpu_torch.ops._build import LAUNCHES

    for order in ("ABA", "BAB"):
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        outs = [progs[k][0](*progs[k][1]) for k in order]
        torch.cuda.synchronize()
        grew = {k: n for k, n in serve_grew(before, KERNELS).items() if n}
        want = {k: sum(per_req[c].get(k, 0) for c in order) for k in grew}
        ok = all(torch.equal(g, r) for k, out in zip(order, outs)
                 for g, r in zip(out, refs[k])) and grew == want and \
            set(grew) == {k for c in order for k in per_req[c]}
        print(f"  bf16 replay order {', '.join(order)} (queued back to back, pool "
              f"{pipe._pool.nbytes() / 2**20:.1f} MiB): every output bitwise its eager "
              f"body's, launches {grew} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"replay order {order}: outputs or launches differ")


@torch.no_grad()
def run_graphs(name_limit: str) -> dict:
    """Phase 16: the per-bucket programs (runtime/program.py) on the card,
    each replay against its body run eagerly on the same inputs (bitwise)
    with the eager run's launches: F5TTS_v1_Base + Vocos at full width
    (phase 3's seeds) in bf16 (kernels 1-3), W8A8 (1, 2, 6-8), int4 (1, 2),
    layer_cache_interval=2 (352 of kernel 1), fp32 (4) and fp32 W8A8 (7, 4,
    8, 6) at the bench request; in bf16 a second request of the bench
    bucket with its own lengths on the same graph, a second bucket, the
    orders A, B, A and B, A, B, F5Pipeline.benchmark (its guard: the three
    queued outputs each equal to the latency output, in buffers of their
    own) and synthesize_batch's program at 4 requests; BigVGAN's bench mel
    in bf16 (12 of kernel 10) and fp32 (9), samples/s of replays against
    the eager body. Prints each graph's warm-up and capture seconds and
    its pool's bytes. Returns the launches of the checked calls."""
    from tts_tpu_torch.models.bigvgan import BigVGANConfig
    from tts_tpu_torch.models.f5 import F5Config, F5Model
    from tts_tpu_torch.models.f5 import init_params as f5_init
    from tts_tpu_torch.models.vocos import VocosConfig, VocosModel
    from tts_tpu_torch.models.vocos import init_params as vocos_init
    from tts_tpu_torch.runtime.f5 import F5Pipeline
    from tts_tpu_torch.runtime.vocoder import BigVGANVocoder

    cfg, vcfg = F5Config(), VocosConfig()
    depth, steps = cfg.depth, cfg.nfe_steps - 1
    audio = bench_audio(cfg.sample_rate)
    bench_text = " ".join(["word"] * 15)
    launches: dict = {}

    def count(grew):
        for k, n in grew.items():
            launches[k] = launches.get(k, 0) + n

    flat, conv = {"flash_attention_flat": depth * steps}, {"conv_pos_embed_fused": steps}
    q8 = dict.fromkeys(Q8_KERNELS, depth * steps)
    for dt in (torch.bfloat16, torch.float32):
        f5 = F5Model(cfg, f5_init(cfg, torch.Generator("cuda").manual_seed(0), dt))
        vocos = VocosModel(vcfg, vocos_init(vcfg, torch.Generator("cuda").manual_seed(1), dt))
        if dt == torch.bfloat16:
            routes = {"bf16": ({}, {**flat, **conv, "mlp_block_fused": depth * steps}),
                      "W8A8": ({"quantize": "w8a8"}, {**flat, **conv, **q8}),
                      "int4": ({"quantize": 4}, {**flat, **conv}),
                      "layer_cache_interval=2": (
                          {"layer_cache_interval": 2},
                          {"flash_attention_flat": depth * len(range(0, steps, 2)), **conv})}
        else:
            one = {"flash_attention_onepass": depth * steps}
            routes = {"fp32": ({}, one), "fp32 W8A8": ({"quantize": "w8a8"}, {**one, **q8})}
        for label, (kw, want) in routes.items():
            pipe = F5Pipeline(f5, {" ": 0}, vocos, **kw)
            fn, args = request_program(pipe, audio, bench_text, 9)
            grew, ref_a = replay_check(f"F5 {label} bench request (bucket 1408)", fn, args,
                                       want, name_limit)
            count(grew)
            if label != "bf16":
                del pipe, fn, args, ref_a
                continue
            # a second request of the bucket, its own lengths: the same graph
            short = audio[:int(GRAPH_REF_S * cfg.sample_rate)]
            fn2, args2 = request_program(pipe, short, GRAPH_TEXT_A2, 10)
            if fn2 is not fn or len(pipe._fn_cache) != 1 or \
                    torch.equal(args2[2], args[2]) or torch.equal(args2[3], args[3]):
                raise AssertionError("the second request did not take the bench bucket's "
                                     "program with lengths of its own")
            graph = fn._graph
            count(replay_check(f"F5 bf16 second request of the bucket (ref_signal_len "
                               f"{int(args2[2])} vs {int(args[2])}, duration "
                               f"{int(args2[3])} vs {int(args[3])})", fn, args2, want,
                               name_limit)[0])
            if fn._graph is not graph:
                raise AssertionError("the bucket's second request captured a new graph")
            fn_b, args_b = request_program(pipe, audio, " ".join(["word"] * GRAPH_WORDS_B), 11)
            grew_b, ref_b = replay_check("F5 bf16 second bucket (1024 frames)", fn_b, args_b,
                                         want, name_limit)
            count(grew_b)
            check_orders(pipe, {"A": (fn, args), "B": (fn_b, args_b)},
                         {"A": ref_a, "B": ref_b}, {"A": want, "B": want})
            bench = pipe.benchmark(ref_seconds=6.0, gen_words=15, iters=3)
            print(f"  {name_limit}: F5 bf16 benchmark on the replays: latency RTF "
                  f"{bench['rtf']:.6f}, sustained RTF {bench['sustained_rtf']:.6f} (the three "
                  f"queued outputs each bitwise the latency output, in buffers of their "
                  f"own), dispatch_ms {bench['dispatch_ms']:.3f}, fence_ms "
                  f"{bench['fence_ms']:.3f}", flush=True)
            print("  " + json.dumps({"graphs": "F5 bf16 benchmark", **bench}), flush=True)
            reqs = [(audio, REF_TEXT, t) for t in F5_TEXTS[:4]]
            audio_p, ids_p, refs, durs, _, frames, gen_frames = pipe._prepare_batch(reqs)
            fnb = pipe._get_batch_fn(len(reqs), audio_p.shape[1], ids_p.shape[1], frames,
                                     gen_frames)
            count(replay_check("F5 bf16 synthesize_batch program, 4 requests", fnb,
                               pipe._inputs(audio_p, ids_p, refs, durs, frames, F5_SEED,
                                            None), want, name_limit)[0])
            print(f"  F5 bf16 pipeline: {len(pipe._fn_cache)} programs "
                  f"{sorted(pipe._fn_cache)}, one pool of "
                  f"{pipe._pool.nbytes() / 2**20:.1f} MiB", flush=True)
            del pipe, fn, fn2, fn_b, fnb, graph, ref_a, ref_b
        del f5, vocos
        torch.cuda.empty_cache()

    bcfg = BigVGANConfig()
    mel = np.random.default_rng(9).standard_normal((1, 512, bcfg.num_mels)).astype(np.float32)
    for dt, name, iters in ((torch.bfloat16, "amp_block_fused", 10),
                            (torch.float32, "amp_block_fused_f32", 5)):
        label = "bf16" if dt == torch.bfloat16 else "fp32"
        voc = BigVGANVocoder(bigvgan_weights(bcfg, 9, dt), bcfg, dtype=dt)
        fn = voc._get_fn(1, 512)
        grew, _ = replay_check(f"BigVGAN {label} bench mel (1, 512, {bcfg.num_mels})", fn,
                               (torch.from_numpy(mel),),
                               {name: kernel10_per_call(bcfg, 512, dt)}, name_limit)
        count(grew)
        bench = voc.benchmark(mel_frames=512, iters=iters)
        # the same chain through the eager body
        melt = torch.zeros((1, 512, bcfg.num_mels), device="cuda")
        out = fn._eager(melt)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn._eager(melt + out.reshape(-1)[0].float() * 0.0)[0]
        torch.cuda.synchronize()
        eager_s = (time.perf_counter() - t0) / iters
        rate = out.shape[-1] / eager_s
        print(f"  {name_limit}: BigVGAN {label} bench mel, {iters} chained calls: replays "
              f"{bench['samples_per_sec']:.0f} samples/s ({1e3 * bench['wall_s']:.3f} ms a "
              f"call), eager body {rate:.0f} samples/s ({1e3 * eager_s:.3f} ms a call)",
              flush=True)
        print("  " + json.dumps({"graphs": f"BigVGAN {label} benchmark", **bench,
                                 "eager_wall_s": eager_s, "eager_samples_per_sec": rate}),
              flush=True)
        del voc, fn, out
    for k, n in run_kani_graphs(name_limit).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in run_qwen_graphs(name_limit).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in run_index_graphs(name_limit).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in run_vox_graphs(name_limit).items():
        launches[k] = launches.get(k, 0) + n
    return launches


def graph_nodes_edges(graph) -> tuple:
    """The nodes and edges of a captured torch CUDAGraph (kept after its
    instantiation), read through the driver API: ({node: kernel name, or
    the node's type for other nodes}, [(from, to, programmatic)]). An edge
    is programmatic where its type or its source port is not the default
    (cuGraphGetEdges_v2's CUgraphEdgeData)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    vp, sz = ctypes.c_void_p, ctypes.c_size_t

    def ok(err, what):
        if err:
            raise RuntimeError(f"{what}: CUDA driver error {err}")

    g = vp(graph.raw_cuda_graph())
    n = sz(0)
    ok(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (vp * n.value)()
    ok(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = {}
    for node in nodes:
        kind = ctypes.c_int()
        ok(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:                     # CU_GRAPH_NODE_TYPE_KERNEL
            names[node] = f"node type {kind.value}"
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at 0, kern (a CUkernel) at 56
        params = (ctypes.c_byte * 128)()
        ok(cu.cuGraphKernelNodeGetParams_v2(vp(node), params), "cuGraphKernelNodeGetParams")
        func = vp.from_buffer(params, 0).value
        kern = vp.from_buffer(params, 56).value
        name = ctypes.c_char_p()
        if func:
            ok(cu.cuFuncGetName(ctypes.byref(name), vp(func)), "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), vp(kern)), "cuKernelGetName")
        names[node] = name.value.decode()
    m = sz(0)
    ok(cu.cuGraphGetEdges_v2(g, None, None, None, ctypes.byref(m)), "cuGraphGetEdges_v2")
    frm, to = (vp * m.value)(), (vp * m.value)()
    data = (ctypes.c_ubyte * (8 * m.value))()
    ok(cu.cuGraphGetEdges_v2(g, frm, to, data, ctypes.byref(m)), "cuGraphGetEdges_v2")
    edges = [(frm[i], to[i], bool(data[8 * i] or data[8 * i + 2])) for i in range(m.value)]
    return names, edges


def check_ordering_premise(label: str, graph, patterns: tuple = ("index_copy",)) -> None:
    """Kernel 12's ordering premise in a captured decode step (the comment
    at csrc/decode_step.cu's early cache loads): no programmatic edge
    reaches a node of its attention launch (step_attn_kernel) from a node
    that writes the cache (a node whose kernel name holds one of `patterns`:
    the device-position append, index_copy; where a host-position cache is
    appended in the graph too, as the Qwen predictor's, its copy kernels):
    every node from which an attention node is reached through programmatic
    edges alone is printed by name, and none may be a cache writer."""
    import collections

    names, edges = graph_nodes_edges(graph)
    prog_in = collections.defaultdict(list)
    for f, t, programmatic in edges:
        if programmatic:
            prog_in[t].append(f)
    attn = [n for n, name in names.items() if "step_attn_kernel" in name]
    # the cache appends (and the token buffer's writes, index_copy too)
    writers = {n for n, name in names.items() if any(w in name for w in patterns)}
    seen: collections.Counter = collections.Counter()
    bad = []
    for a in attn:
        stack, up = list(prog_in[a]), set()
        while stack:
            f = stack.pop()
            if f not in up:
                up.add(f)
                stack.extend(prog_in[f])
        bad += [names[f] for f in up & writers]
        seen.update(names[f].split("(")[0][:60] for f in up)
    n_prog = sum(1 for _, _, p in edges if p)
    print(f"  {label}: the captured graph: {len(names)} nodes, {len(edges)} edges, "
          f"{n_prog} programmatic; {len(attn)} kernel-12 attention nodes, {len(writers)} "
          f"nodes named by {patterns} (the cache appends and the token writes); nodes "
          f"reaching an attention node through programmatic edges "
          f"alone: {dict(seen)}; cache writers among them: {len(bad)} "
          f"{'ok' if not bad and attn and writers else 'FAIL'}", flush=True)
    if bad or not attn or not writers:
        raise AssertionError(f"{label}: a programmatic edge reaches kernel 12 from a cache "
                             f"writer ({bad[:3]}), or the graph has no attention or append")


def _snap(dec) -> list:
    return [t.clone() for t in dec.state]


def _put(dec, snap: list) -> None:
    for t, v in zip(dec.state, snap):
        t.copy_(v)


def stateful_call(label: str, prog, dec, args: tuple, want: dict) -> dict:
    """One call of a Kani decode program (on its first call the warm-up,
    the capture and a replay) against its body run eagerly from the same
    state: every output and every tensor of the state after it bitwise,
    the launches equal to the eager run's and to `want`. Leaves the state
    as the call left it. Returns the call's record."""
    from tts_tpu_torch.ops._build import LAUNCHES

    first = prog._graph is None
    s0 = _snap(dec)
    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    got = prog(*args)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    grew = serve_grew(before, KERNELS)
    s1 = _snap(dec)
    _put(dec, s0)
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    ref = prog._eager(*args)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager = serve_grew(before, KERNELS)
    same = [torch.equal(g, r) for g, r in zip(got, ref)] + \
        [torch.equal(a, b) for a, b in zip(s1, _snap(dec))]
    kept = {k: n for k, n in grew.items() if n}
    if not all(same) or grew != eager or kept != want:
        raise AssertionError(f"{label}: the replay differs from its eager body (outputs and "
                             f"state bitwise {same}), or its launches {kept} (eager "
                             f"{eager}, expected {want})")
    return {"first": first, "call_s": call_s, "eager_s": eager_s, "launches": kept}


def kani_request_on_programs(label: str, pipe, dec, ids_buf: np.ndarray, lens, limit: int,
                             want_step: dict) -> dict:
    """A Kani request driven program by program (prefill, step replays
    until the stop flag, codec), each call held bitwise against its eager
    body from the same state (stateful_call). Returns a summary record."""
    recs = [stateful_call(f"{label} prefill", dec.prefill(ids_buf.shape[1]), dec,
                          (ids_buf, lens, np.int32(limit)), {})]
    replays = 0
    while not bool(dec.stop.cpu()):
        recs.append(stateful_call(f"{label} step replay {replays}", dec.step, dec, (),
                                  want_step))
        replays += 1
    recs.append(stateful_call(f"{label} codec", dec.codec, dec, (), {}))
    return {"replays": replays, "first_calls": sum(r["first"] for r in recs),
            "replay_s": sum(r["call_s"] for r in recs[1:-1] if not r["first"]),
            "eager_s": sum(r["eager_s"] for r in recs[1:-1]),
            "launches": {k: sum(r["launches"].get(k, 0) for r in recs)
                         for k in want_step}}


def check_step_twin_in_replay(pipe, dec) -> None:
    """Kernel 12 against its twin in a replayed decode step, from the state
    a prefill left: the step program replayed (kernels), its eager body
    with the twin swapped in (bf16), and one plain kani_step in fp32 on the
    same (bf16-valued) weights and state; the rows the first step appends
    at every attention layer past the first (each reads the attention
    outputs of the layers before it) from the kernels no further from fp32
    than STEP_SLACK times the twin's (check_step's rule)."""
    import tts_tpu_torch.models.kani as mk
    from tts_tpu_torch.kv.cache import KVCache
    from tts_tpu_torch.models.kani import KaniState, embed_tokens, kani_step
    from tts_tpu_torch.ops.decode_step import fused_qkv_attn_plain

    s0 = _snap(dec)
    p0 = int(dec.pos.cpu())

    def rows():
        return torch.cat([dec.k[1:, 0, :, p0].float().flatten(),
                          dec.v[1:, 0, :, p0].float().flatten()])

    dec.step()
    torch.cuda.synchronize()
    kern = rows()
    _put(dec, s0)
    with swapped(mk, {"fused_qkv_attn": fused_qkv_attn_plain}):
        dec.step._eager()
    twin = rows()
    _put(dec, s0)
    p32 = cast_tree(pipe.params, torch.float32)
    st = KaniState(KVCache(dec.k.float(), dec.v.float(), p0), dec.conv.float())
    kani_step(p32, embed_tokens(p32, dec.tok[:, None]), st, pipe.cfg, fused=False)
    ref = torch.cat([st.kv.k[1:, 0, :, p0].flatten(), st.kv.v[1:, 0, :, p0].flatten()])
    e_k, e_t = rel_l2(kern, ref), rel_l2(twin, ref)
    ok = bool(torch.isfinite(kern).all()) and e_k <= STEP_SLACK * e_t
    print(f"  Kani greedy bf16: kernel 12 in a replayed step (pos {p0}): the appended k/v "
          f"rows of attention layers 2-{pipe.cfg.num_attn_layers}, rel L2 against one fp32 "
          f"plain step: replay {e_k:.6g}, eager body with the twin {e_t:.6g} (limit "
          f"{STEP_SLACK} x); replay against the twin {rel_l2(kern, twin):.6g} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("kernel 12 in a replayed step is less accurate than its twin")


def run_kani_graphs(name_limit: str) -> dict:
    """Phase 16's Kani part: the decode programs of kani-tts-370m at full
    width (phase 6's seeds and bench config) for greedy bf16 and int8
    (kernel 12), beam 5 and a batch of 4 (kernel 11): two requests each,
    driven program by program, every call of the prefill, step and codec
    programs, the first ones included, bitwise its eager body from the same
    state with the eager run's launches (6 a decode step); the greedy bf16
    step graph's edges read for kernel 12's ordering premise; kernel 12
    against its twin in a replayed step; each program's warm-up and capture
    seconds and the pool's bytes. Returns the launches of the checked
    calls."""
    from tts_tpu_torch.models.kani import KaniConfig, init_params
    from tts_tpu_torch.models.nanocodec import NanoCodecConfig
    from tts_tpu_torch.models.nanocodec import init_params as codec_init
    from tts_tpu_torch.runtime.kani import STEPS, KaniDecodeConfig, KaniPipeline

    cfg, ccfg = KaniConfig(max_seq_len=2048, stop_token=-1), NanoCodecConfig()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(2), torch.bfloat16)
    cparams = codec_init(ccfg, torch.Generator("cuda").manual_seed(3), torch.bfloat16)
    dec_cfg = KaniDecodeConfig(max_new_tokens=KANI_NEW, repeat_penalty=1.0)
    beam_cfg = KaniDecodeConfig(max_new_tokens=KANI_NEW, repeat_penalty=1.0, use_beam=True,
                                beam_size=5, top_k=5)
    layers = cfg.num_attn_layers
    prompts = [np.array(KANI_IDS, np.int32), np.array([[5, 8, 13, 21, 34, 55]], np.int32),
               np.array([[3, 9, 4]], np.int32), np.array(KANI_IDS, np.int32)[:, :4]]
    launches: dict = {}
    for label, make, kernel in (
            ("greedy bf16", lambda: KaniPipeline(params, cfg, cparams, ccfg, dec_cfg),
             "fused_qkv_attn"),
            ("greedy int8", lambda: KaniPipeline(params, cfg, cparams, ccfg, dec_cfg,
                                                 quantize=8), "fused_qkv_attn"),
            ("beam 5", lambda: KaniPipeline(params, cfg, cparams, ccfg, beam_cfg),
             "fused_qkv_rope"),
            ("batch of 4", lambda: KaniPipeline(params, cfg, cparams, ccfg, dec_cfg),
             "fused_qkv_rope")):
        pipe = make()
        cap, buf, fbuf = pipe._buf_for(None)
        limit = min(cap, buf)
        want = {kernel: layers * STEPS}
        for req in range(2):
            if label == "batch of 4":
                dec = pipe._batch(len(prompts), fbuf)
                order = prompts if req == 0 else prompts[::-1]
                bucket = pipe._bucket(max(p.shape[1] for p in order))
                ids_buf = np.zeros((len(order), bucket), np.int32)
                lens = np.zeros((len(order),), np.int32)
                for b, p in enumerate(order):
                    ids_buf[b, bucket - p.shape[1]:] = p[0]
                    lens[b] = bucket - p.shape[1]
            else:
                dec = pipe._solo(fbuf)
                p = prompts[req]
                ids_buf = np.zeros((1, pipe._bucket(p.shape[1])), np.int32)
                ids_buf[0, :p.shape[1]] = p[0]
                lens = np.int32(p.shape[1])
            rec = kani_request_on_programs(f"Kani {label} request {req}", pipe, dec, ids_buf,
                                           lens, limit, want)
            for k, n in rec["launches"].items():
                launches[k] = launches.get(k, 0) + n
            if rec["replays"] != -(-(limit - 1) // STEPS) or \
                    rec["launches"][kernel] != layers * STEPS * rec["replays"]:
                raise AssertionError(f"Kani {label}: {rec}")
            progs = {"prefill": dec.prefill(ids_buf.shape[1]), "step": dec.step,
                     "codec": dec.codec}
            print(f"  {name_limit}: Kani {label} request {req}: prefill, {rec['replays']} step "
                  f"replays of {STEPS} steps and the codec, each bitwise its eager body from "
                  f"the same state (outputs and state), {rec['first_calls']} of them first "
                  f"calls; {kernel} launched {rec['launches'][kernel]} times "
                  f"({layers} x {STEPS} a replay); the step replays {rec['replay_s']:.4f} s "
                  f"against their eager bodies' {rec['eager_s']:.4f} s; " + "; ".join(
                      f"{k} warm-up {v.warmup_s:.4f} s capture {v.capture_s:.4f} s, "
                      f"{sum(v.launches.values())} launches recorded"
                      for k, v in progs.items()) + f"; pool {pipe._pool.nbytes() / 2**20:.1f} "
                  f"MiB", flush=True)
            print("  " + json.dumps({"graphs": f"Kani {label}", "card": name_limit,
                                     "request": req, **rec,
                                     "warmup_s": {k: v.warmup_s for k, v in progs.items()},
                                     "capture_s": {k: v.capture_s for k, v in progs.items()},
                                     "pool_bytes": pipe._pool.nbytes()}), flush=True)
        if label == "greedy bf16":
            check_ordering_premise("Kani greedy bf16 step program", dec.step._graph.graph)
            # a third request, 16 replays in (pos 131): kernel 12 against its
            # twin in the next replayed step
            p = prompts[2]
            ids_buf = np.zeros((1, pipe._bucket(p.shape[1])), np.int32)
            ids_buf[0, :p.shape[1]] = p[0]
            dec.prefill(ids_buf.shape[1])(ids_buf, np.int32(p.shape[1]), np.int32(limit))
            for _ in range(16):
                dec.step()
            check_step_twin_in_replay(pipe, dec)
        del pipe, dec
        torch.cuda.empty_cache()
    return launches


# phase 16's Qwen requests: 15 frames, each a step replay held against its
# eager body ("all" runs at 128 frames: its 768-row cache takes kernel 13)
QWEN_GRAPH_FRAMES = 15


def qwen_request_on_programs(label: str, pipe, dec, args: tuple, want_step: dict) -> dict:
    """A Qwen request driven program by program (prefill, step replays
    until the stop flag, the codec of the kept frames), each call held
    bitwise against its eager body from the same state (stateful_call).
    Returns a summary record."""
    recs = [stateful_call(f"{label} prefill", dec.prefill, dec, args, {})]
    replays = 0
    while not bool(dec.stop.cpu()):
        recs.append(stateful_call(f"{label} step replay {replays}", dec.step, dec, (),
                                  want_step))
        replays += 1
    if dec.kind == "batch":
        done = torch.clamp(dec.done, max=dec.num)
        live = (done > 0).nonzero()[:, 0]
        nfr = done.index_select(0, live)
        codec = pipe._codec(pipe._codec_fb(int(nfr.max())), len(live))
        cargs = (dec.frames.index_select(0, live), nfr)
    else:
        kept = int(dec.num) - int(dec.fin)
        codec = pipe._codec(pipe._codec_fb(kept))
        cargs = (dec.frames[:1].clone(), np.array([kept], np.int32))
    recs.append(stateful_call(f"{label} codec", codec, dec, cargs, {}))
    return {"replays": replays, "frames": int(dec.num),
            "first_calls": sum(r["first"] for r in recs),
            "replay_s": sum(r["call_s"] for r in recs[1:-1] if not r["first"]),
            "eager_s": sum(r["eager_s"] for r in recs[1:-1]),
            "launches": {k: sum(r["launches"].get(k, 0) for r in recs) for k in want_step},
            "programs": {"prefill": dec.prefill, "step": dec.step, "codec": codec}}


def check_qwen_twin_in_replay(pipe, dec, label: str) -> None:
    """Kernels 12 and 13 against their twins in a replayed step program,
    from the state a prefill and some replays left: the replay (the route's
    kernels), then from the same state its first frame's talker step with
    every kernel's twin swapped in (bf16) and one plain talker step in fp32
    on the same (bf16-valued) weights and cache, each on the talker input
    the replay's first frame computed (rebuilt from the frame it wrote);
    the rows that step appends at every talker layer past the first (each
    reads the attention outputs of the layers before it) from the kernels
    no further from fp32 than STEP_SLACK times the twins' (check_step's
    rule)."""
    from tts_tpu_torch.kv.cache import KVCache
    from tts_tpu_torch.models.qwen_tts import next_talker_input, qwen3_stack_step

    s0 = _snap(dec)
    p0, n0 = int(dec.pos.cpu()), int(dec.num.cpu())
    if bool(dec.stop.cpu()):
        raise AssertionError(f"{label}: the twin check needs a live frame")

    def rows(k, v):
        return torch.cat([k[1:, 0, :, p0].float().flatten(), v[1:, 0, :, p0].float().flatten()])

    dec.step()
    torch.cuda.synchronize()
    kern = rows(dec.k, dec.v)
    frame = dec.frames[0, n0].clone()
    _put(dec, s0)
    p, t = pipe.params, pipe.cfg.talker
    ce0 = p["talker_codec_embed"][frame[:1].long()][:, None]
    nxt = next_talker_input(p, frame, ce0, dec.tr, dec.num.clamp(max=dec.tb - 1), pipe.cfg)
    pos = dec.pos.clone()
    with twins_in_qwen():
        qwen3_stack_step(p["talker"], nxt, KVCache(dec.k, dec.v, pos, dec.kv_max), t,
                         *pipe._rope(pos), fused=pipe._fused)
    twin = rows(dec.k, dec.v)
    _put(dec, s0)
    kf, vf = dec.k.float(), dec.v.float()
    rc, rs = pipe._rope(p0)
    qwen3_stack_step(cast_tree(p["talker"], torch.float32), nxt.float(), KVCache(kf, vf, p0),
                     t, rc.float(), rs.float(), fused=False)
    ref = rows(kf, vf)
    e_k, e_t = rel_l2(kern, ref), rel_l2(twin, ref)
    ok = bool(torch.isfinite(kern).all()) and e_k <= STEP_SLACK * e_t
    print(f"  {label}: the talker step in a replayed step program (pos {p0}, frame {n0}): the "
          f"appended k/v rows of talker layers 2-{t.num_layers}, rel L2 against one fp32 plain "
          f"step: replay {e_k:.6g}, the twins {e_t:.6g} (limit {STEP_SLACK} x); replay against "
          f"the twins {rel_l2(kern, twin):.6g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the replayed step is less accurate than its twins")


@torch.no_grad()
def run_qwen_graphs(name_limit: str) -> dict:
    """Phase 16's Qwen part: the decode programs of Qwen3-TTS-0.6B at full
    width (phase 7's seeds) on every route, two requests each (the default
    route bf16 and int8 (kernel 12), beam 3 (12 on the talker, 11 on the
    predictor), a batch of 4 (11), "all" at max_frames 128 (11, 13, 14),
    "mlp_q8" int8 (11, 15)), driven program by program, every prefill, step
    and codec call, the first ones included, bitwise its eager body from
    the same state with the eager run's launches (a step: one frame
    step); the default step graph's edges read for kernel 12's ordering
    premise; kernels 12 and 13 against their twins in a replayed step; each
    program's warm-up and capture seconds and the pool's bytes. Returns
    the launches of the checked calls."""
    from tts_tpu_torch.runtime.qwen import QwenDecodeConfig, QwenTTSPipeline

    cfg, ccfg, params, cparams = qwen_models()
    g = cfg.num_code_groups
    talker, pred = cfg.talker.num_layers, (g - 1) * cfg.predictor.num_layers
    per_iter, beam_pred = talker + pred, (g - 2) * cfg.predictor.num_layers
    solo_ids = [QWEN_IDS, np.arange(5, 20, dtype=np.int32)[None]]
    batch_ids = [QWEN_IDS, np.arange(5, 20, dtype=np.int32)[None],
                 np.arange(40, 90, dtype=np.int32)[None], np.array([[7, 1, 4]], np.int32)]

    def dec_cfg(**kw):
        return QwenDecodeConfig(**{"max_frames": QWEN_GRAPH_FRAMES, **kw})

    int8 = QwenTTSPipeline(params, cfg, cparams, ccfg, dec_cfg(), quantize=8)
    routes = (
        ("default bf16", lambda: QwenTTSPipeline(params, cfg, cparams, ccfg, dec_cfg()),
         {"fused_qkv_attn": per_iter}),
        ("default int8", lambda: int8, {"fused_qkv_attn": per_iter}),
        ("beam 3", lambda: QwenTTSPipeline(params, cfg, cparams, ccfg, dec_cfg(
            use_beam=True, beam_size=3, beam_top_k=3)),
         {"fused_qkv_attn": talker, "fused_qkv_rope": beam_pred}),
        ("batch of 4", lambda: QwenTTSPipeline(params, cfg, cparams, ccfg, dec_cfg()),
         {"fused_qkv_rope": per_iter}),
        ('"all" bf16, max_frames 128', lambda: QwenTTSPipeline(
            params, cfg, cparams, ccfg, dec_cfg(max_frames=128, fused_decode="all")),
         {"fused_qkv_rope": per_iter, "decode_gqa_attention": per_iter,
          "fused_out_mlp": per_iter}),
        ('"mlp_q8" int8', lambda: QwenTTSPipeline(int8.params, cfg, cparams, ccfg,
                                                 dec_cfg(fused_decode="mlp_q8")),
         {"fused_qkv_rope": per_iter, "fused_out_mlp_q8": per_iter}))
    launches: dict = {}
    for label, make, per in routes:
        pipe = make()
        for req in range(2):
            if label == "batch of 4":
                order = batch_ids if req == 0 else batch_ids[::-1]
                reqs = [pipe.build_prefill_embeds(i, QWEN_LANG) for i in order]
                pmax = max(64, -(-max(pr.shape[1] for pr, _ in reqs) // 64) * 64)
                tb = max(pipe._trailing_bucket(tr) for _, tr in reqs)
                buf = torch.zeros((len(reqs), pmax, cfg.talker.hidden_size), device="cuda")
                pad = np.array([pmax - pr.shape[1] for pr, _ in reqs], np.int32)
                for b, (pr, _) in enumerate(reqs):
                    buf[b, pmax - pr.shape[1]:] = pr[0]
                trb = torch.cat([pipe._trailing_buf(tr, tb) for _, tr in reqs], dim=0)
                held = pipe._batch(len(reqs), pmax, tb)
                args = (buf, pad, trb)
            else:
                pre, tr = pipe.build_prefill_embeds(solo_ids[req], QWEN_LANG)
                buf, p_len, trb = pipe._request_bufs(pre, tr)
                held = pipe._solo(trb.shape[1])
                args = (buf, np.int32(p_len), trb)
            with held as dec:
                rec = qwen_request_on_programs(f"Qwen {label} request {req}", pipe, dec, args,
                                               per)
            progs = rec.pop("programs")
            for k, n in rec["launches"].items():
                launches[k] = launches.get(k, 0) + n
            if any(rec["launches"][k] != n * rec["replays"] for k, n in per.items()):
                raise AssertionError(f"Qwen {label}: {rec}")
            print(f"  {name_limit}: Qwen {label} request {req}: prefill, {rec['replays']} step "
                  f"replays of one frame step ({rec['frames']} of them live) and the "
                  f"codec, each bitwise its eager body from the same state (outputs and "
                  f"state), {rec['first_calls']} of them first calls; launches "
                  f"{rec['launches']} ({per} a frame step); the step replays "
                  f"{rec['replay_s']:.4f} s against their eager bodies' {rec['eager_s']:.4f} s; "
                  + "; ".join(f"{k} warm-up {v.warmup_s:.4f} s capture {v.capture_s:.4f} s, "
                              f"{sum(v.launches.values())} launches recorded"
                              for k, v in progs.items())
                  + f"; pool {pipe._pool.nbytes() / 2**20:.1f} MiB", flush=True)
            print("  " + json.dumps({"graphs": f"Qwen {label}", "card": name_limit,
                                     "request": req, **rec,
                                     "warmup_s": {k: v.warmup_s for k, v in progs.items()},
                                     "capture_s": {k: v.capture_s for k, v in progs.items()},
                                     "pool_bytes": pipe._pool.nbytes()}), flush=True)
        if label in ("default bf16", '"all" bf16, max_frames 128'):
            if label == "default bf16":
                check_ordering_premise("Qwen default bf16 step program", dec.step._graph.graph,
                                       patterns=("index_copy", "copy_kernel"))
            # a third request, 4 replays in: kernel 12 (13 on "all") against
            # its twin in the next replayed step
            pre, tr = pipe.build_prefill_embeds(batch_ids[2], QWEN_LANG)
            buf, p_len, trb = pipe._request_bufs(pre, tr)
            with pipe._solo(trb.shape[1]) as dec:
                dec.prefill(buf, np.int32(p_len), trb)
                for _ in range(4):
                    dec.step()
                check_qwen_twin_in_replay(pipe, dec, f"Qwen {label}")
        del pipe, dec
        torch.cuda.empty_cache()
    return launches


# phase 16's IndexTTS requests: 24 tokens, each decode step a replay held
# against its eager body
INDEX_GRAPH_GEN = 24


def index_request_on_programs(label: str, pipe, ref_of, ids: list, want_step: dict) -> dict:
    """An IndexTTS request (one row, or a batch) driven program by program
    (prefill, step replays until the stop flag, the vocode program of the
    kept frames), each call held bitwise against its eager body from the
    same state (stateful_call). `ref_of(b)` is row b's reference. Returns
    a summary record."""
    from tts_tpu_torch.runtime.indextts import STEPS

    rows = len(ids)
    tb = max(16, -(-max(i.shape[1] for i in ids) // 16) * 16)
    buf = np.zeros((rows, tb), np.int32)
    for b, i in enumerate(ids):
        buf[b, :i.shape[1]] = i[0]
    tlens = np.array([i.shape[1] for i in ids], np.int32)
    lat = torch.cat([ref_of(b)[0] for b in range(rows)])
    with pipe._held(rows, tb, INDEX_GRAPH_GEN, lat.dtype, batch=rows > 1) as dec:
        recs = [stateful_call(f"{label} prefill", dec.prefill, dec, (lat, buf, tlens), {})]
        replays = 0
        while not bool(dec.stop.cpu()):
            recs.append(stateful_call(f"{label} step replay {replays}", dec.step, dec, (),
                                      want_step))
            replays += 1
        done = dec.cnt.cpu().numpy()
        frames = [max(int(d) - 2, 0) for d in done]
        fb = pipe._frame_bucket(max(frames), INDEX_GRAPH_GEN)
        ce = torch.cat([ref_of(b)[1] for b in range(rows)])
        conds = [torch.cat([ref_of(b)[2][i] for b in range(rows)]) for i in range(len(
            ref_of(0)[2]))]
        voc = pipe._vocoder(fb, rows if rows > 1 else None, ce, conds)
        vargs = (dec.hiddens[:, :fb].clone(), np.array(frames, np.int32), ce, *conds)
        recs.append(stateful_call(f"{label} vocode", voc, dec, vargs,
                                  {"amp_block_fused": kernel10_per_call(pipe.vcfg, fb)}))
    if replays != -(-(INDEX_GRAPH_GEN - 1) // STEPS):
        raise AssertionError(f"{label}: {replays} step replays")
    return {"replays": replays, "tokens": [int(d) for d in done],
            "first_calls": sum(r["first"] for r in recs),
            "replay_s": sum(r["call_s"] for r in recs[1:-1] if not r["first"]),
            "eager_s": sum(r["eager_s"] for r in recs[1:-1]),
            "launches": {k: sum(r["launches"].get(k, 0) for r in recs)
                         for k in (*want_step, "amp_block_fused")},
            "programs": {"prefill": dec.prefill, "step": dec.step, "vocode": voc},
            "vocode_args": vargs}


def check_index_step_in_replay(pipe, ref) -> None:
    """Kernel 11 against its twin in a replayed decode step, from the state
    a prefill and 4 replays left: the step program replayed (kernel 11),
    its eager body with the twin swapped in (bf16), and one plain gpt_step
    in fp32 on the same (bf16-valued) weights, cache and input; the rows
    the step appends at every GPT layer past the first (each reads the
    attention outputs of the layers before it) from the kernel no further
    from fp32 than STEP_SLACK times the twin's (check_step's rule)."""
    import tts_tpu_torch.models.indextts as mi
    from tts_tpu_torch.kv.cache import KVCache
    from tts_tpu_torch.models.indextts import gpt_step
    from tts_tpu_torch.ops.decode_qkv import fused_qkv_rope_plain

    ids = INDEX_IDS
    with pipe._held(1, ids.shape[1], INDEX_GRAPH_GEN, ref[0].dtype) as dec:
        dec.prefill(ref[0], ids, np.array([ids.shape[1]], np.int32))
        for _ in range(4):
            dec.step()
        s0 = _snap(dec)
        p0, n0 = int(dec.pos.cpu()), int(dec.num.cpu())

        def rows():
            return torch.cat([dec.k[1:, 0, :, p0].float().flatten(),
                              dec.v[1:, 0, :, p0].float().flatten()])

        dec.step()
        torch.cuda.synchronize()
        kern = rows()
        _put(dec, s0)
        with swapped(mi, {"fused_qkv_rope": fused_qkv_rope_plain}):
            dec.step._eager()
        twin = rows()
        _put(dec, s0)
        gpt = pipe.params["gpt"]
        h = (gpt["mel_embed"][dec.tok] + gpt["mel_pos"][n0][None])[:, None]
        kf, vf = dec.k.float(), dec.v.float()
        gpt_step(cast_tree(gpt, torch.float32), h.float(), KVCache(kf, vf, p0), dec.vec,
                 pipe.cfg, dec.kv_valid[0], fused=False)
        ref32 = torch.cat([kf[1:, 0, :, p0].flatten(), vf[1:, 0, :, p0].flatten()])
    e_k, e_t = rel_l2(kern, ref32), rel_l2(twin, ref32)
    ok = bool(torch.isfinite(kern).all()) and e_k <= STEP_SLACK * e_t
    print(f"  IndexTTS bf16: kernel 11 in a replayed decode step (pos {p0}, token {n0}): the "
          f"appended k/v rows of GPT layers 2-{pipe.cfg.gpt_layers}, rel L2 against one fp32 "
          f"plain step: replay {e_k:.6g}, eager body with the twin {e_t:.6g} (limit "
          f"{STEP_SLACK} x); replay against the twin {rel_l2(kern, twin):.6g} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("kernel 11 in a replayed IndexTTS step is less accurate than its "
                             "twin")


def check_index_vocode_in_replay(pipe, prog, args: tuple) -> None:
    """Kernel 10 against its twin in a replayed vocode call: the program's
    int16 output (the replay), its body run eagerly with the twin swapped in
    (bf16), and the body in fp32 (the GPT's final_norm and the BigVGAN
    cast, the inputs too); the replay's rel L2 against fp32 at most
    STEP_SLACK times the twin's."""
    import types

    import tts_tpu_torch.ops.bigvgan_stage as k10
    from tts_tpu_torch.runtime.indextts import IndexTTSPipeline

    (got,) = prog(*args)
    with swapped(k10, {"amp_block_fused": k10.amp_block_fused_plain}):
        (twin,) = prog._eager(*args)
        p32 = cast_tree({"gpt": {"final_norm": pipe.params["gpt"]["final_norm"]},
                         "bigvgan": pipe.params["bigvgan"]}, torch.float32)
        f32 = types.SimpleNamespace(params=p32, vcfg=pipe.vcfg)
        h, n, ce, *conds = [torch.as_tensor(a, device="cuda") for a in args]
        (ref32,) = IndexTTSPipeline._vocode_body(f32, h.float(), n, ce.float(),
                                                 *[c.float() for c in conds])
    kern, twin, ref32 = got.float(), twin.float(), ref32.float()
    e_k, e_t = rel_l2(kern, ref32), rel_l2(twin, ref32)
    ok = bool(kern.abs().max() > 0) and e_k <= STEP_SLACK * e_t
    print(f"  IndexTTS bf16: kernel 10 in a replayed vocode call ({tuple(got.shape)} int16): "
          f"rel L2 against the fp32 body: replay {e_k:.6g}, eager body with the twin "
          f"{e_t:.6g} (limit {STEP_SLACK} x); replay against the twin "
          f"{rel_l2(kern, twin):.6g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("kernel 10 in a replayed vocode call is less accurate than its "
                             "twin")


@torch.no_grad()
def run_index_graphs(name_limit: str) -> dict:
    """Phase 16's IndexTTS part: the programs of IndexTTS-1.5 at full width
    (phase 9's seeds and reference) at max_gen INDEX_GRAPH_GEN, no stop
    token: the encode program of the 6 s reference (two calls); bf16 and
    int8 requests and a batch of 4, two each, driven program by program,
    every prefill, step and vocode call, the first ones included, bitwise
    its eager body from the same state with the eager run's launches (24 of
    kernel 11 a decode step, kernel 10 on the vocode call's stages its gate
    admits); kernel 11
    against its twin in a replayed step and kernel 10 in a replayed vocode
    call; each program's warm-up and capture seconds and the pool's bytes
    by route. Returns the launches of the checked calls."""
    from tts_tpu_torch.runtime.indextts import ENC_BUCKET, STEPS, IndexTTSPipeline

    cfg, vcfg, params = indextts_models()
    launches: dict = {}
    pipe = IndexTTSPipeline(params, cfg, vcfg)
    ref = pipe.encode_reference(index_audio(vcfg.sample_rate))
    (key, enc), = pipe._enc_cache.items()
    padded = enc._static[0].clone()                 # the bucket's audio, as the call gave it
    for i in range(2):
        replay_check(f"IndexTTS encode program (bucket {key} = {key // ENC_BUCKET} x "
                     f"{ENC_BUCKET} samples), call {i + 2}", enc, (padded,), {}, name_limit)
    prompts = [INDEX_IDS, np.arange(5, 20, dtype=np.int32)[None],
               np.arange(40, 90, dtype=np.int32)[None], np.array([[7, 1, 4]], np.int32)]
    want = {"fused_qkv_rope": cfg.gpt_layers * STEPS}
    for label, make, reqs in (
            ("bf16", lambda: pipe, [[prompts[0]], [prompts[1]]]),
            ("int8", lambda: IndexTTSPipeline(params, cfg, vcfg, quantize=8),
             [[prompts[0]], [prompts[1]]]),
            ("batch of 4", lambda: IndexTTSPipeline(params, cfg, vcfg),
             [prompts, prompts[::-1]])):
        p = make()
        for req, ids in enumerate(reqs):
            rec = index_request_on_programs(f"IndexTTS {label} request {req}", p,
                                            lambda b: ref, ids, want)
            progs, vargs = rec.pop("programs"), rec.pop("vocode_args")
            for k, n in rec["launches"].items():
                launches[k] = launches.get(k, 0) + n
            print(f"  {name_limit}: IndexTTS {label} request {req}: prefill, {rec['replays']} "
                  f"step replays of {STEPS} decode step(s) and the vocode call, each bitwise "
                  f"its eager body from the same state (outputs and state), "
                  f"{rec['first_calls']} of them first calls; tokens {rec['tokens']}; "
                  f"launches {rec['launches']} ({want} a replay); the step replays "
                  f"{rec['replay_s']:.4f} s against their eager bodies' {rec['eager_s']:.4f} "
                  f"s; " + "; ".join(f"{k} warm-up {v.warmup_s:.4f} s capture "
                                      f"{v.capture_s:.4f} s, {sum(v.launches.values())} "
                                      f"launches recorded" for k, v in progs.items())
                  + f"; pool {p._pool.nbytes() / 2**20:.1f} MiB", flush=True)
            print("  " + json.dumps({"graphs": f"IndexTTS {label}", "card": name_limit,
                                     "request": req, **rec,
                                     "warmup_s": {k: v.warmup_s for k, v in progs.items()},
                                     "capture_s": {k: v.capture_s for k, v in progs.items()},
                                     "pool_bytes": p._pool.nbytes()}), flush=True)
        if label == "bf16":
            check_index_step_in_replay(p, ref)
            check_index_vocode_in_replay(p, progs["vocode"], vargs)
        if p is not pipe:
            del p
        torch.cuda.empty_cache()
    print(f"  IndexTTS bf16 pipeline: programs {[k for k, _ in index_programs(pipe)]}, one "
          f"pool of {pipe._pool.nbytes() / 2**20:.1f} MiB", flush=True)
    del pipe
    torch.cuda.empty_cache()
    return launches


# phase 16's VoxCPM requests: 12 latents (min_latents = max_latents), each
# latent step a replay held against its eager body
VOX_GRAPH_LATENTS = 12


def vox_request_on_programs(label: str, pipe, dec, inputs: tuple, cap: int,
                            want_step: dict) -> dict:
    """A VoxCPM request (one row, or a batch; its CFM noise filled into the
    state) driven program by program: the prefill, step replays until the
    stop flag, the VAE program over the latents kept, each call held
    bitwise against its eager body from the same state (stateful_call).
    Returns a summary record."""
    from tts_tpu_torch.runtime.voxcpm import STEPS

    recs = [stateful_call(f"{label} prefill", dec.prefill, dec, inputs, {})]
    replays = 0
    while not bool(dec.stop.cpu()):
        recs.append(stateful_call(f"{label} step replay {replays}", dec.step, dec, (),
                                  want_step))
        replays += 1
    vae = pipe._vae(dec.rows, dec.buf)
    recs.append(stateful_call(f"{label} VAE", vae, dec, (dec.latents.clone(), dec.cnt.clone()),
                              {}))
    if replays != -(-cap // STEPS) or int(dec.cnt.min()) != cap:
        raise AssertionError(f"{label}: {replays} step replays, latents {dec.cnt.tolist()}")
    return {"replays": replays, "latents": dec.cnt.tolist(),
            "first_calls": sum(r["first"] for r in recs),
            "replay_s": sum(r["call_s"] for r in recs[1:-1] if not r["first"]),
            "eager_s": sum(r["eager_s"] for r in recs[1:-1]),
            "launches": {k: sum(r["launches"].get(k, 0) for r in recs) for k in want_step},
            "programs": {"prefill": dec.prefill, "step": dec.step, "VAE": vae}}


def check_vox_step_in_replay(label: str, pipe, dec, name: str, twin) -> None:
    """Kernel `name` (12 or 11) against its twin in a replayed latent step,
    from the state a prefill and 4 replays left: the step program replayed
    (the kernel), its eager body with the twin swapped in (bf16), and the
    step's body in fp32 (the CFM at the state's noise row, the feature
    encoder and a plain dual-LM step, on fp32 copies of the weights and the
    state); the rows the step appends at every base and residual layer
    past the first (each reads the attention outputs of the layers before
    it) and the new dit_hidden from the kernel no further from fp32 than
    STEP_SLACK times the twin's (check_step's rule)."""
    import tts_tpu_torch.models.voxcpm as vm
    from tts_tpu_torch.kv.cache import KVCache

    for _ in range(4):
        dec.step()
    s0 = _snap(dec)
    p0, n0 = int(dec.pos.cpu()), int(dec.num.cpu())

    def rows(bk, bv, rk, rv, dit):
        return torch.cat([t[1:, :, :, p0].float().flatten() for t in (bk, bv, rk, rv)]
                         + [dit.float().flatten()])

    def state_rows():
        return rows(dec.bk, dec.bv, dec.rk, dec.rv, dec.dit)

    dec.step()
    torch.cuda.synchronize()
    kern = state_rows()
    _put(dec, s0)
    with swapped(vm, {name: twin}):
        dec.step._eager()
    tw = state_rows()
    _put(dec, s0)
    cfg, p32 = pipe.cfg, cast_tree(pipe.params, torch.float32)
    at = torch.tensor([n0], device=dec.noise.device)
    latent = vm.cfm_feat_decoder_batch(p32, dec.noise.index_select(0, at)[0], dec.dit.float(),
                                       dec.feat_cond.float(), cfg)
    fe, _ = vm.feat_encoder_cond_batch(p32, latent, cfg)
    bk, bv, rk, rv = (t.float() for t in (dec.bk, dec.bv, dec.rk, dec.rv))
    dit, _, _, _ = vm.voxcpm_main_step(p32, fe, fe, 0, KVCache(bk, bv, p0), KVCache(rk, rv, p0),
                                       cfg, kv_valid=dec.kv_valid)
    ref = rows(bk, bv, rk, rv, dit)
    e_k, e_t = rel_l2(kern, ref), rel_l2(tw, ref)
    ok = bool(torch.isfinite(kern).all()) and e_k <= STEP_SLACK * e_t
    print(f"  {label}: {name} in a replayed latent step (pos {p0}, latent {n0}): the appended "
          f"k/v rows of base layers 2-{cfg.base.num_layers} and residual layers "
          f"2-{cfg.residual.num_layers} and dit_hidden, rel L2 against the fp32 step: replay "
          f"{e_k:.6g}, eager body with the twin {e_t:.6g} (limit {STEP_SLACK} x); replay "
          f"against the twin {rel_l2(kern, tw):.6g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: {name} in a replayed step is less accurate than its "
                             f"twin")


@torch.no_grad()
def run_vox_graphs(name_limit: str) -> dict:
    """Phase 16's VoxCPM part: the programs of VoxCPM-2 and VoxCPM-1.5 at
    full width (phase 10's seeds) at VOX_GRAPH_LATENTS latents, two requests
    a route, driven program by program: VoxCPM-2 bf16 and int8 requests, a
    "continuation" request with its encode (the encode program called
    twice more), a stream (its decode, then each window VAE call), and a
    VoxCPM-1.5 batch of 4; every encode, prefill, step, VAE and window call,
    the first ones included, bitwise its eager body from the same state
    with the eager run's launches (28 of kernel 12 a solo step, 28 of
    kernel 11 a batch step); the stream bitwise synthesize_streaming with
    the same seed; the bf16 step graph's edges read for kernel 12's
    ordering premise; kernel 12 against its twin in a replayed step and
    kernel 11 in a replayed batch step; each route's warm-up and capture
    seconds and the pool's bytes. Returns the launches of the checked
    calls."""
    from tts_tpu_torch.models.voxcpm import VoxCPMConfig, voxcpm_v2_config
    from tts_tpu_torch.ops.decode_qkv import fused_qkv_rope_plain
    from tts_tpu_torch.ops.decode_step import fused_qkv_attn_plain
    from tts_tpu_torch.runtime.streaming import ChunkedCodecStream
    from tts_tpu_torch.runtime.voxcpm import STEPS, VoxCPMDecodeConfig, VoxCPMPipeline

    cfg2, cfg15 = voxcpm_v2_config(), VoxCPMConfig()
    dec_cfg = VoxCPMDecodeConfig(max_latents=VOX_GRAPH_LATENTS, min_latents=VOX_GRAPH_LATENTS)
    layers = cfg2.base.num_layers + cfg2.residual.num_layers
    max_steps = VOX_TARGET.shape[1] * dec_cfg.decode_limit_factor + 10
    launches: dict = {}

    def report(label, pipe, rec, req):
        progs = rec.pop("programs")
        for k, n in rec["launches"].items():
            launches[k] = launches.get(k, 0) + n
        print(f"  {name_limit}: {label} request {req}: prefill, {rec['replays']} step replays "
              f"of {STEPS} latent step(s) and the VAE call, each bitwise its eager body from "
              f"the same state (outputs and state), {rec['first_calls']} of them first calls; "
              f"latents {rec['latents']}; launches {rec['launches']}; the step replays "
              f"{rec['replay_s']:.4f} s against their eager bodies' {rec['eager_s']:.4f} s; "
              + "; ".join(f"{k} warm-up {v.warmup_s:.4f} s capture {v.capture_s:.4f} s, "
                          f"{sum(v.launches.values())} launches recorded"
                          for k, v in progs.items())
              + f"; pool {pipe._pool.nbytes() / 2**20:.1f} MiB", flush=True)
        print("  " + json.dumps({"graphs": label, "card": name_limit, "request": req, **rec,
                                 "warmup_s": {k: v.warmup_s for k, v in progs.items()},
                                 "capture_s": {k: v.capture_s for k, v in progs.items()},
                                 "pool_bytes": pipe._pool.nbytes()}), flush=True)

    def solo(pipe, segments, fc):
        """A request's held state, inputs and cap from `seed`'s noise."""
        bufs = pipe._prompt_bufs(segments)
        return lambda seed: pipe._solo(*bufs[:2], bufs[3], bufs[2], fc, max_steps,
                                       pipe._latent_buf(max_steps), seed)

    params2, vae2 = voxcpm_models(cfg2, 30)
    ids_seg = [("text", np.concatenate([VOX_PROMPT[0], VOX_TARGET[0],
                                        [cfg2.audio_start_id]]).astype(np.int32))]
    want12 = {"fused_qkv_attn": layers * STEPS}
    bf16 = VoxCPMPipeline(params2, cfg2, vae2, dec_cfg)
    for label, pipe in (("VoxCPM-2 bf16", bf16),
                        ("VoxCPM-2 int8", VoxCPMPipeline(params2, cfg2, vae2, dec_cfg,
                                                         quantize=8))):
        held = solo(pipe, ids_seg, pipe._zero_cond())
        for req, seed in enumerate((5, 6)):
            with held(seed) as (dec, inputs, cap):
                report(label, pipe, vox_request_on_programs(f"{label} request {req}", pipe, dec,
                                                            inputs, cap, want12), req)
        if pipe is bf16:
            with held(7) as (dec, inputs, _):
                check_ordering_premise(f"{label} step program", dec.step._graph.graph)
                dec.prefill(*inputs)
                check_vox_step_in_replay(label, pipe, dec, "fused_qkv_attn",
                                         fused_qkv_attn_plain)
        del pipe
        torch.cuda.empty_cache()

    # continuation: the encode program, then two requests of its bucket
    segments, fc = bf16._v2_plan("continuation", VOX_TARGET, prompt_audio=vox_audio(
        cfg2.sample_rate), prompt_ids=VOX_PROMPT)
    (key, enc), = bf16._enc_cache.items()
    padded = enc._static[0].clone()                 # the bucket's audio, as the call gave it
    for i in range(2):
        replay_check(f"VoxCPM-2 encode program (bucket {key} samples), call {i + 2}", enc,
                     (padded,), {}, name_limit)
    held = solo(bf16, segments, fc)
    for req, seed in enumerate((5, 6)):
        with held(seed) as (dec, inputs, cap):
            report("VoxCPM-2 continuation", bf16, vox_request_on_programs(
                f"VoxCPM-2 continuation request {req}", bf16, dec, inputs, cap, want12), req)

    # a stream: the request's decode programs, then every window VAE call
    held = solo(bf16, ids_seg, bf16._zero_cond())
    for req, seed in enumerate((8, 9)):
        with held(seed) as (dec, inputs, cap):
            rec = vox_request_on_programs(f"VoxCPM-2 stream {req}", bf16, dec, inputs, cap,
                                          want12)
            lat = dec.latents[0, :cap].cpu().numpy()
        report("VoxCPM-2 stream decode", bf16, rec, req)

        def window(w, req=req):
            prog = bf16._window(w.shape[1])
            return replay_check(f"VoxCPM-2 stream {req} window VAE ({w.shape[1]} latents)", prog,
                                (torch.from_numpy(np.ascontiguousarray(w, np.float32)),), {},
                                name_limit, timed=1)[1][0]

        stream = ChunkedCodecStream(window, window=5, left_context=1,
                                    upsample=cfg2.samples_per_latent, num_groups=cfg2.patch_size)
        got = []
        for i in range(0, cap, 4):
            out = stream.push_frames(lat[i:i + 4])
            if out is not None and len(out):
                got.append(out)
        got.extend(stream.finish())
        ref = list(bf16.synthesize_streaming(ids_seg, bf16._zero_cond(), max_steps, seed=seed,
                                             chunk=4))
        same = np.array_equal(np.concatenate(got), np.concatenate(ref))
        print(f"  {name_limit}: VoxCPM-2 stream {req}: {len(got)} chunks, each window VAE call "
              f"bitwise its eager body; the assembly bitwise synthesize_streaming with the same "
              f"seed: {same}", flush=True)
        if not same:
            raise AssertionError("the VoxCPM stream differs from its checked program calls")
    print(f"  VoxCPM-2 bf16 pipeline: programs {[k for k, _ in vox_programs(bf16)]}, one pool "
          f"of {bf16._pool.nbytes() / 2**20:.1f} MiB", flush=True)
    del bf16, params2, vae2
    torch.cuda.empty_cache()

    # VoxCPM-1.5: a batch of 4
    params15, vae15 = voxcpm_models(cfg15, 40)
    pipe15 = VoxCPMPipeline(params15, cfg15, vae15, dec_cfg)
    rows = [np.arange(21, 53 + 2 * i, dtype=np.int32)[None] for i in range(4)]
    want11 = {"fused_qkv_rope": layers * STEPS}
    for req, order in enumerate((rows, rows[::-1])):
        plans = [([("text", np.concatenate([VOX_PROMPT[0], t[0], [cfg15.audio_start_id]])
                   .astype(np.int32))], None,
                  min(t.shape[1] * dec_cfg.decode_limit_factor + 10, dec_cfg.max_latents))
                 for t in order]
        inputs, buf = pipe15._batch_bufs(plans)
        s_buf = inputs[0].shape[1]
        with pipe15._held(pipe15._batch_fns, ("batch", 4, s_buf, buf), 4, s_buf, buf,
                          True) as dec:
            dec.fill_noise(None, 10 + req)
            report("VoxCPM-1.5 batch of 4", pipe15, vox_request_on_programs(
                f"VoxCPM-1.5 batch of 4 request {req}", pipe15, dec, inputs,
                int(inputs[-1].max()), want11), req)
    with pipe15._held(pipe15._batch_fns, ("batch", 4, s_buf, buf), 4, s_buf, buf, True) as dec:
        dec.fill_noise(None, 7)
        dec.prefill(*inputs)
        check_vox_step_in_replay("VoxCPM-1.5 batch of 4", pipe15, dec, "fused_qkv_rope",
                                 fused_qkv_rope_plain)
    print(f"  VoxCPM-1.5 pipeline: programs {[k for k, _ in vox_programs(pipe15)]}, one pool "
          f"of {pipe15._pool.nbytes() / 2**20:.1f} MiB", flush=True)
    del pipe15, params15, vae15
    torch.cuda.empty_cache()
    return launches


def cpu_tree(tree):
    """A params tree with every tensor moved to the CPU (exact)."""
    if isinstance(tree, dict):
        return {k: cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cpu_tree(v) for v in tree]
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


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
    # a replayed CUDA graph (F5, BigVGAN) launches its kernels in one call
    n_graph = sum(e.count for e in events if e.key == "cudaGraphLaunch")
    n_kernels = sum(count for _, count, _ in rows)
    unit = f" ({n_launch / per[0]:.1f} a {per[1]})" if per else ""
    busy_unit = f" ({busy / per[0]:.4f} ms a {per[1]})" if per else ""
    print(f"  {name_limit}: profile {label}: wall {wall:.4f} s profiled, device kernel time "
          f"{busy:.3f} ms{busy_unit}, idle {100 * (1 - busy / 1e3 / wall):.1f}% of the "
          f"profiled wall, "
          f"{n_launch} launches{unit}, {n_graph} graph launches, {n_kernels} device "
          f"kernels", flush=True)
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
    ap.add_argument("--families",
                    default="f5,kani,qwen,bigvgan,indextts,voxcpm,serving,checkpoints,cli,"
                            "clone,parity,graphs",
                    help="the pipeline phases to run after phase 2, by family: "
                         "f5 (3-5d), kani (6), qwen (7), bigvgan (8, 8c), indextts (9), "
                         "voxcpm (10), serving (11), checkpoints (12), cli (13), clone "
                         "(14), parity (15), graphs (16); default all (the smoke run's "
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

    def no_ablation(name: str, n: int = 1) -> None:
        if name in ABLATION_KERNELS:
            raise AssertionError(f"a pipeline launched {name}")
        count_launch(name, n)

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

    # phases 12-14 write checkpoint files: one directory, removed at exit
    ckpt_root, f5_files = None, None
    if fams & {"checkpoints", "cli", "clone", "parity"}:
        import atexit
        import shutil
        import tempfile

        ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        atexit.register(shutil.rmtree, ckpt_root, True)

    if "checkpoints" in fams:
        phase("phase 12: the README's F5 usage from checkpoint files (load_f5, load_vocos, "
              "read_wav, write_wav)")
        grew, f5_files = run_checkpoints(name_limit, ckpt_root)
        for k, n in grew.items():
            launches[k] = launches.get(k, 0) + n

    if "cli" in fams:
        phase("phase 13: text in, speech out through the CLI (tts_tpu_torch.cli.main, five "
              "families from checkpoint files)")
        for k, n in run_cli(name_limit, ckpt_root, f5_files, keep="parity" in fams).items():
            launches[k] = launches.get(k, 0) + n

    if "clone" in fams:
        phase("phase 14: voice clone, streaming, int4 and VoxCPM's output rate")
        t14 = time.perf_counter()
        for k, n in run_clone(name_limit, ckpt_root).items():
            launches[k] = launches.get(k, 0) + n
        print(f"  {name_limit}: phase 14 took {time.perf_counter() - t14:.1f} s", flush=True)

    if "parity" in fams:
        phase("phase 15: the parity harness (tts_tpu_torch/parity) against stand-in sessions")
        t15 = time.perf_counter()
        for k, n in run_parity(name_limit, ckpt_root, f5_files).items():
            launches[k] = launches.get(k, 0) + n
        print(f"  {name_limit}: phase 15 took {time.perf_counter() - t15:.1f} s", flush=True)

    if "graphs" in fams:
        phase("phase 16: per-bucket programs (CUDA graphs) against their eager bodies")
        t16 = time.perf_counter()
        for k, n in run_graphs(name_limit).items():
            launches[k] = launches.get(k, 0) + n
        print(f"  {name_limit}: phase 16 took {time.perf_counter() - t16:.1f} s", flush=True)

    phase("done")
    # JAX may be installed where the port runs: nothing of the run may have
    # imported it, nor the JAX package, not even inside a function
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "tts_tpu"))
    if leaked:
        raise AssertionError(f"the run imported {leaked[:8]}")
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
