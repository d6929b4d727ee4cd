#!/usr/bin/env python3
"""Two checkouts of the port in turns on one NVIDIA card: A, B, B, A.

    python3 chip_ab.py --a DIR_A --b DIR_B     # e.g. a parent commit's tree
                                               # (git archive) and this one
    python3 chip_ab.py --a DIR_A --b DIR_B --rounds 3 --parts f5_bf16

Each turn runs this script's `turn` in a fresh process from that tree's
root, so it imports that tree's tts_tpu_torch and chip_smoke.py, and runs
the parts `--parts` names (all by default), `--rounds` times A, B, B, A:
  * host: the host's time a call of kernel 3's and kernel 7's wrappers at a
    small shape (enqueue only), with and without the C call, of reading
    and of switching the current device, and a probe of the host's speed
    before and after (see `_host`);
  * f5_bf16: the bf16 F5TTS_v1_Base bench request, float and
    quantize="w8a8", under torch.profiler (device time, kernel 2's, kernel
    3's and the int8 kernels' (q8_*) shares, the profiled wall and the card's idle
    share), then F5Pipeline.benchmark (latency and sustained RTF,
    dispatch_ms: the host's prep and enqueue, fence_ms: the wait for the
    card); a digest of the W8A8 request's audio; the kernel launches of one
    request;
  * digests: a digest of kernels 1, 4 and 5's bf16 outputs on seeded
    inputs (the flash core), and of kernels 6, 7 and 8's outputs on seeded
    inputs in bf16 and fp32 activations, through the wrappers' signatures
    that both trees share, each weight in the layout the tree's pipeline
    gives it (`_card_layout`: what its quantize_dit does on the card), so
    two trees whose kernels compute the same bits give the same digests,
    which the last line compares;
  * qwen: the Qwen3-TTS-0.6B bench request (32 text ids, language 3,
    max_frames 120) on each route: the default route ("step", kernel 12)
    bf16 and int8, beam 3, a batch of 4 (8 frames, kernel 11), "all" at
    max_frames 128 (kernels 11, 13, 14) and "mlp_q8" int8 (11, 15): the
    first request's wall (on the decode programs also their warm-up and
    capture seconds and the pool's MiB), one request under torch.profiler
    (CUDA activity only: device time, the card's busy time (the union of
    the kernels' intervals: PDL launches overlap) and kernel launches a
    frame, the idle share of the profiled wall; on "all" kernel 13's device
    time and kernel 14's busy time a frame), frames/s and RTF of two timed
    requests and the idle share of each timed wall, and host launch calls
    a frame (kernel and graph launches in a CPU trace of an 8-frame request
    of the route);
  * f5_fp32: the fp32 F5TTS_v1_Base bench request (float and
    quantize="w8a8") under the profiler (device time, kernels 4-5's share)
    and three timed;
  * decode: at the Qwen3-TTS talker shape, digests of kernel 15's outputs
    (B 1, 3, 8), which the last line compares across the trees, and of
    kernel 14's (bf16 and int8 weights), which must repeat bitwise within
    each tree (its split over the input dim is an fp32 order of its own),
    with each output's rel L2 against the fp32 twin, which must stay within
    1.25x of tree A's; their device times at B 1 and kernel 14's chained
    time (CUDA events over 10 calls) at B 1 and 8; kernels 11 and 12 at the
    Qwen talker (head_dim 128, pos 126) and Kani (head_dim 64, pos 700)
    shapes: rel L2 of each output against its fp32 twin and device time a
    call; one Qwen3-TTS bench request on the default route (bf16, kernel
    12) and on "mlp_q8" (int8, kernels 11 and 15) under the profiler
    (device time a frame, the kernels' share) and two timed (frames/s); the
    greedy Kani bench request (device time a token, tokens/s of two);
    BigVGAN's bench mel in bf16 and fp32: one call's device time and
    kernel 10's share under the profiler, samples/s of 10 (bf16) or 5
    (fp32) calls;
  * kani: the Kani bench request (kani-tts-370m, 256 tokens, no stop
    token) greedy bf16 and int8, beam 5 and a batch of 4: the first
    request's wall (on the decode programs also their warm-up and capture
    seconds and the pool's MiB), one request under torch.profiler (CUDA
    activity only: device time, the card's busy time and kernel launches a
    token, the idle share of the profiled wall), tokens/s and RTF of two
    timed requests, and the idle share of each timed wall (1 - the
    profiled request's busy time / the wall);
  * indextts: the IndexTTS-1.5 bench request (32 text ids, 256 tokens, no
    stop token, chip_smoke's 6 s reference) in bf16 and int8, a batch of
    4 (row-tokens/s), and where the tree has decode programs bf16 at 4
    decode steps a replay: the first request's wall with its encode (on
    the programs also their warm-up and capture seconds and the pool's
    MiB), one request under torch.profiler (CUDA activity only: device
    time, the card's busy time and kernel 11's a token, the idle share of
    the profiled wall), kernel launches a token, host launch calls a token
    (a CPU trace of a 16-token request), tokens/s and RTF of two timed
    requests and the idle share of each timed wall; for bf16 also the
    vocoder call's and the encode's wall (best of 3) and busy ms;
  * voxcpm: the VoxCPM bench request (16 prompt ids, 32 target ids, 48
    latents, min_latents = max_latents) on VoxCPM-2 bf16 and int8, a
    VoxCPM-1.5 batch of 8 (row-latents/s), and where the tree has decode
    programs VoxCPM-2 bf16 at 2 latent steps a replay: the first request's
    wall (on the programs also their warm-up and capture seconds and the
    pool's MiB), one request under torch.profiler (CUDA activity only:
    device time, the card's busy time and kernel launches a latent, the
    idle share of the profiled wall), latents/s and RTF of two timed
    requests and the idle share of each timed wall, host launch calls a
    latent (a CPU trace of an 8-latent request); for bf16 also the VAE
    decode of the request's 48 latents and the 6 s prompt's encode (wall,
    best of 3, and busy ms), and the first chunk of a stream (chunk 4),
    its first and its second run.
Random weights from chip_smoke.py's seeds. Both trees' kernels build
first, at once. Each turn prints JSON lines; compare the trees only within
one run of this script.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def _busy_ms(prof, pats=None) -> float:
    """The card's busy time in a trace: the union of the intervals of its
    kernels (those whose names hold one of `pats`, or all), ms. Kernels
    launched with programmatic dependent launch overlap, and a sum of their
    times counts the overlap twice."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and (pats is None or any(p in e.name for p in pats)))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _profile(fn, walled: bool = False, busy=None):
    """fn() once to warm up, then once under torch.profiler: its output,
    (kernel, device ms) rows and, if walled, the profiled call's wall (s);
    with `busy` ({label: patterns or None}) also {label: busy ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    res = (out, rows, wall) if walled else (out, rows)
    if busy is not None:
        res += ({label: _busy_ms(prof, pats) for label, pats in busy.items()},)
    return res


def _walls(fn, n: int) -> list:
    import torch

    res = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        res.append(time.perf_counter() - t0)
    return res


def _f5_models(dtype):
    """F5TTS_v1_Base and Vocos in `dtype` (chip_smoke.py's seeds), the bench
    request's 6 s reference and 15-word text."""
    import numpy as np
    import torch

    from tts_tpu_torch.models.f5 import F5Config, F5Model
    from tts_tpu_torch.models.f5 import init_params as f5_init
    from tts_tpu_torch.models.vocos import VocosConfig, VocosModel
    from tts_tpu_torch.models.vocos import init_params as vocos_init

    fcfg, vcfg = F5Config(), VocosConfig()
    f5 = F5Model(fcfg, f5_init(fcfg, torch.Generator("cuda").manual_seed(0), dtype))
    vocos = VocosModel(vcfg, vocos_init(vcfg, torch.Generator("cuda").manual_seed(1), dtype))
    audio = (np.random.default_rng(0).standard_normal(int(6.0 * fcfg.sample_rate))
             * 3000).astype(np.int16)
    return f5, vocos, audio, " ".join(["word"] * 15)


def _digest(a) -> str:
    """sha256 of a tensor's or an array's bytes, 16 hex digits."""
    import torch

    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).cpu().numpy()
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def _f5_bf16(tag: str, card: str) -> None:
    """The bf16 F5 bench request, float and W8A8: profiled device time by
    kernel 3 and the int8 kernels and the rest, then F5Pipeline.benchmark;
    the W8A8 request's audio digest."""
    import torch

    import chip_smoke as cs
    from tts_tpu_torch.ops._build import LAUNCHES
    from tts_tpu_torch.runtime.f5 import F5Pipeline

    f5, vocos, audio, text = _f5_models(torch.bfloat16)
    for quantize in (None, "w8a8"):
        pipe = F5Pipeline(f5, {" ": 0}, vocos, quantize=quantize)

        def request():
            return pipe.synthesize(audio, cs.REF_TEXT, text)

        (wav, _), rows, wall = _profile(request, walled=True)
        # kernel 3 in either tree: the older ff1/ff2_kernel, or the row pass and GEMMs
        k3 = sum(ms for k, ms in rows if any(
            p in k for p in ("ff1_kernel", "ff2_kernel", "ln_mod_kernel", "dit_gemm_kernel")))
        # kernel 2 in either tree: the WMMA conv_mish_kernel or the wgmma pos_embed_mish_kernel
        k2 = sum(ms for k, ms in rows if any(p in k for p in ("conv_mish", "pos_embed_mish")))
        q8 = sum(ms for k, ms in rows if "q8_" in k)
        busy = sum(ms for _, ms in rows)
        bench = pipe.benchmark(ref_seconds=6.0, gen_words=15, iters=3)
        before = sum(LAUNCHES.values())
        request()
        launches = sum(LAUNCHES.values()) - before
        extra = {"audio_digest": _digest(wav)} if quantize else {}
        print(json.dumps({"tree": tag, "card": card, "f5_bf16": quantize or "float",
                          "device_ms": busy, "kernel2_ms": k2, "kernel2_share": k2 / busy,
                          "kernel3_ms": k3, "kernel3_share": k3 / busy,
                          "q8_ms": q8, "q8_share": q8 / busy, "profiled_wall_s": wall,
                          "idle_share": 1 - busy / 1e3 / wall,
                          **{k: bench[k] for k in ("wall_s", "rtf", "sustained_rtf", "prep_ms",
                                                   "dispatch_ms", "fence_ms")},
                          "launches_a_request": launches, **extra}), flush=True)
        del pipe


def _host(tag: str, card: str) -> None:
    """The host's time (us) a call of kernel 3's and kernel 7's wrappers at
    a small shape whose kernels the card runs faster than the host enqueues
    them (enqueue only: the wait for the card is after the clock stops),
    and of the same wrappers with `_build.launch` stubbed out (their Python
    alone); of reading the current device and of entering and leaving
    torch.cuda.device; and of a 128 x 128 torch.empty on the card before
    the port's library loads and after the rest, a probe of the host's
    speed at the time (it drifts within a process, by 1.5x and more)."""
    import torch

    from tts_tpu_torch.ops import _build, quant_matmul
    from tts_tpu_torch.ops.dit_mlp import mlp_block_fused
    from tts_tpu_torch.quant.weight_only import quantize_int8_eager

    def probe():
        return _median_us(lambda: torch.empty((128, 128), device="cuda"), 4000)

    torch.zeros(1, device="cuda")
    rec = {"tree": tag, "card": card, "probe_us_before": probe()}
    gen = torch.Generator("cuda").manual_seed(4330)

    def rn(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)

    d, f = 128, 256
    x = rn(2, 64, d)
    w = quantize_int8_eager(rn(d, 3 * d))
    wq = getattr(quant_matmul, "to_kmajor", lambda q: q)(w.q)
    calls = {"mlp_block_fused": (mlp_block_fused, (x, rn(3, d), rn(d, f), rn(f), rn(f, d),
                                                   rn(d))),
             "ln_qkv_q8": (quant_matmul.ln_qkv_q8, (x, rn(2, d), wq, w.scale, rn(3 * d)))}
    launch = _build.launch
    for key, stub in (("wrapper_us", launch), ("python_only_us", lambda *a, **k: None)):
        _build.launch = stub
        rec[key] = {name: _median_us(lambda: fn(*a), 2000) for name, (fn, a) in calls.items()}
    _build.launch = launch
    dev = torch.device("cuda", torch.cuda.current_device())

    def switch():
        with torch.cuda.device(dev):
            pass

    rec["current_device_us"] = _median_us(torch.cuda.current_device, 20000)
    rec["device_switch_us"] = _median_us(switch, 20000)
    rec["probe_us_after"] = probe()
    print(json.dumps(rec), flush=True)


def _median_us(fn, n: int, batches: int = 5) -> float:
    """Host time (us) a call of fn(): the median over `batches` of n calls
    (after one more that warms up), the card's queue drained between."""
    import statistics

    import torch

    times = []
    for _ in range(batches + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times[1:])


def _q8_digest(tag: str) -> None:
    """sha256 of kernels 6, 7 and 8's outputs on seeded inputs at the F5
    bench shapes, bf16 and fp32 activations, and of kernel 9's in bf16."""
    import torch

    from tts_tpu_torch.ops import quant_matmul
    from tts_tpu_torch.ops.dit_mlp import mlp_block_fused_q8
    from tts_tpu_torch.ops.quant_matmul import ln_qkv_q8, out_proj_residual_q8
    from tts_tpu_torch.quant.weight_only import quantize_int8_eager

    gen = torch.Generator("cuda").manual_seed(4328)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    # each weight in the layout the tree's quantize_dit gives it on a card
    kmajor = _card_layout()
    lay = getattr(quant_matmul, "to_kmajor", lambda q: q)

    def qw(name, *shape):
        w = quantize_int8_eager(rn(*shape, scale=0.02))
        return (lay(w.q) if kmajor[name] else w.q), w.scale

    d, n, f = 1024, 3072, 2048
    x, o = rn(2, 1408, d), rn(2, 1408, d)
    wqkv, wo, w1, w2 = qw("wqkv", d, n), qw("wo", d, d), qw("ff1", d, f), qw("ff2", f, d)
    mods2, mods3 = rn(2, d, scale=0.5), rn(2, 3, d, scale=0.5)
    bq, bo, gate, b1, b2 = (rn(k, scale=0.1) for k in (n, d, d, f, d))
    outs = {}
    for dt in (torch.bfloat16, torch.float32):
        xd, od = x.to(dt), o.to(dt)
        key = "bf16" if dt == torch.bfloat16 else "fp32"
        outs[f"kernel7_{key}"] = ln_qkv_q8(xd, mods2, *wqkv, bq)
        outs[f"kernel8_{key}"] = out_proj_residual_q8(od, *wo, bo, gate, xd)
        outs[f"kernel6_{key}"] = mlp_block_fused_q8(xd, mods3, *w1, b1, *w2, b2)
    # kernel 9 at its bench shape on bf16 activations (the one dtype both
    # trees take), its weight in the layout the tree's wrapper takes on a
    # card: K-major, or row-major where it refuses K-major (ValueError)
    w9 = quantize_int8_eager(rn(d, n, scale=0.02))
    for wq9 in (lay(w9.q), w9.q):
        try:
            outs["kernel9_bf16"] = quant_matmul.quantized_matmul(x.reshape(-1, d), wq9,
                                                                 w9.scale)
            break
        except ValueError:
            continue
    torch.cuda.synchronize()
    print(json.dumps({"tree": tag, "kmajor": kmajor,
                      "q8_digest": {k: _digest(v) for k, v in outs.items()}}), flush=True)


def _card_layout() -> dict:
    """{weight: whether the tree's runtime/f5.quantize_dit stores its int8
    q K-major} for wqkv, wo, ff1 and ff2 of a block on the card."""
    import torch

    from tts_tpu_torch.runtime.f5 import quantize_dit

    def w(*shape):
        return torch.randn(shape, device="cuda")

    blk = {"attn": {"wqkv": w(128, 384), "wo": w(128, 128)}, "ff1": {"w": w(128, 256)},
           "ff2": {"w": w(256, 128)}}
    q = quantize_dit({"blocks": [blk]}, "w8a8")["blocks"][0]
    return {name: not t.q.is_contiguous() for name, t in (
        ("wqkv", q["attn"]["wqkv"]), ("wo", q["attn"]["wo"]), ("ff1", q["ff1"]["w"]),
        ("ff2", q["ff2"]["w"]))}


def _flash_digest(tag: str) -> None:
    """sha256 of kernels 1, 4 and 5's bf16 outputs on seeded inputs."""
    import torch

    from tts_tpu_torch.models.f5 import f5_rope_tables
    from tts_tpu_torch.ops.flash_attention import flash_attention, flash_attention_flat

    gen = torch.Generator("cuda").manual_seed(4326)

    def rn(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)

    cos, sin = (torch.tensor(a, device="cuda").to(torch.bfloat16).float()
                for a in f5_rope_tables(1408, 64))
    kv = torch.tensor([1396, 700], dtype=torch.int32, device="cuda")
    q, k, v = rn(2, 16, 1408, 64), rn(2, 16, 1408, 64), rn(2, 16, 1408, 64)
    q5, k5, v5 = rn(2, 16, 4608, 64), rn(2, 16, 4608, 64), rn(2, 16, 4608, 64)
    outs = {"kernel1": flash_attention_flat(rn(2, 1408, 3 * 16 * 64), cos, sin, kv, heads=16),
            "kernel4": flash_attention(q, k, v, kv, packed_out=True, block_q=128,
                                       block_kv=1408, head_block=2),
            "kernel5": flash_attention(q5, k5, v5, 4600, block_q=256, block_kv=512)}
    torch.cuda.synchronize()
    print(json.dumps({"tree": tag, "flash_digest": {
        name: _digest(o) for name, o in outs.items()}}), flush=True)


PARTS = ("host", "f5_bf16", "digests", "qwen", "f5_fp32", "decode", "kani", "indextts",
         "voxcpm")


def turn(tag: str, parts: tuple) -> None:
    """One turn of `parts`, from the root of the tree under test."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card()
    if "host" in parts:
        _host(tag, card)
    if "f5_bf16" in parts:
        _f5_bf16(tag, card)
    if "digests" in parts:
        _flash_digest(tag)
        _q8_digest(tag)
    if "qwen" in parts:
        _qwen(tag, card)
    if "f5_fp32" in parts:
        _f5_fp32(tag, card)
    if "decode" in parts:
        _decode_digest(tag)
        _decode_kernels(tag, card)
        _decode_paths(tag, card)
    if "kani" in parts:
        _kani_routes(tag, card)
    if "indextts" in parts:
        _indextts(tag, card)
    if "voxcpm" in parts:
        _voxcpm(tag, card)


def _kani_routes(tag: str, card: str) -> None:
    """The `kani` part (see the module's docstring)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from tts_tpu_torch.models.kani import KaniConfig
    from tts_tpu_torch.models.kani import init_params as kani_init
    from tts_tpu_torch.models.nanocodec import NanoCodecConfig
    from tts_tpu_torch.models.nanocodec import init_params as codec_init
    from tts_tpu_torch.runtime.kani import KaniDecodeConfig, KaniPipeline

    cfg, ccfg = KaniConfig(max_seq_len=2048, stop_token=-1), NanoCodecConfig()
    params = kani_init(cfg, torch.Generator("cuda").manual_seed(2), torch.bfloat16)
    cparams = codec_init(ccfg, torch.Generator("cuda").manual_seed(3), torch.bfloat16)
    ids = np.array(cs.KANI_IDS, np.int32)
    prompts = [ids, np.array([[3, 9, 4]], np.int32), np.array([[5, 8, 13, 21, 34, 55]],
                                                               np.int32), ids[:, :4]]
    dec = KaniDecodeConfig(max_new_tokens=cs.KANI_NEW, repeat_penalty=1.0)
    beam = KaniDecodeConfig(max_new_tokens=cs.KANI_NEW, repeat_penalty=1.0, use_beam=True,
                            beam_size=5, top_k=5)
    for route, make, batch in (
            ("greedy bf16", lambda: KaniPipeline(params, cfg, cparams, ccfg, dec), False),
            ("greedy int8", lambda: KaniPipeline(params, cfg, cparams, ccfg, dec, quantize=8),
             False),
            ("beam 5", lambda: KaniPipeline(params, cfg, cparams, ccfg, beam), False),
            ("batch of 4", lambda: KaniPipeline(params, cfg, cparams, ccfg, dec), True)):
        pipe = make()

        def request(pipe=pipe, batch=batch):
            if batch:
                wavs, st = pipe.synthesize_ids_batch(prompts)
                return sum(len(w) for w in wavs), st["tokens"]
            wav, st = pipe.synthesize_ids(ids)
            return len(wav), st["tokens"]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        progs = []
        for d in list(getattr(pipe, "_decode_cache", {}).values()) + \
                list(getattr(pipe, "_batch_fns", {}).values()):
            progs += [d.step, d.codec, *d._prefill.values()] if hasattr(d, "step") else []
        pool = getattr(pipe, "_pool", None)
        # CUDA activity only: a CPU trace of an eager request's ~10^5
        # launches takes minutes to reduce
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            samples, tokens = request()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        device = sum(e.device_time_total for e in kern) / 1e3
        launched = sum(e.count for e in kern)
        busy = _busy_ms(prof)
        walls = _walls(request, 2)
        audio_s = samples / ccfg.sample_rate
        print(json.dumps({
            "tree": tag, "card": card, "kani_route": route, "tokens": tokens,
            "first_request_s": first,
            "warmup_s": sum(p.warmup_s for p in progs) if progs else None,
            "capture_s": sum(p.capture_s for p in progs) if progs else None,
            "pool_mib": pool.nbytes() / 2**20 if pool is not None else None,
            "device_ms_a_token": device / tokens, "busy_ms_a_token": busy / tokens,
            "idle_share": 1 - busy / 1e3 / wall, "profiled_wall_s": wall,
            "kernel_launches_a_token": launched / tokens,
            "tokens_per_s": [tokens / w for w in walls],
            "rtf": [w / audio_s for w in walls],
            "idle_share_timed": [1 - busy / 1e3 / w for w in walls]}), flush=True)
        del pipe, prof


# kernel 14's launches (the same names in both trees; kernel 15's are q8_*)
K14 = ("oproj_kernel", "gateup_kernel", "down_kernel")


# host calls that launch work on the card: kernels, and graphs
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaGraphLaunch")


def _host_launches(fn) -> int:
    """Host launch calls (kernels and graphs) of one fn() in a CPU trace,
    after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in HOST_LAUNCHES)


def _qwen(tag: str, card: str) -> None:
    """The `qwen` part (see the module's docstring)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from tts_tpu_torch.runtime.qwen import QwenDecodeConfig, QwenTTSPipeline

    cfg, ccfg, params, cparams = cs.qwen_models()
    int8 = QwenTTSPipeline(params, cfg, cparams, ccfg, QwenDecodeConfig(max_frames=120),
                           quantize=8).params
    prompts = [cs.QWEN_IDS, np.arange(5, 20, dtype=np.int32)[None],
               np.arange(40, 90, dtype=np.int32)[None], np.array([[7, 1, 4]], np.int32)]
    beam = dict(use_beam=True, beam_size=3, beam_top_k=3)
    routes = [("default bf16", params, {}, 120, False), ("default int8", int8, {}, 120, False),
              ("beam 3", params, beam, 120, False), ("batch of 4", params, {}, 8, True),
              ('"all" bf16', params, {"fused_decode": "all"}, 128, False),
              ('"mlp_q8" int8', int8, {"fused_decode": "mlp_q8"}, 120, False)]
    for route, weights, kw, cap, batch in routes:
        def make(max_frames, weights=weights, kw=kw):
            return QwenTTSPipeline(weights, cfg, cparams, ccfg,
                                   QwenDecodeConfig(max_frames=max_frames, **kw))

        def request(pipe):
            if batch:
                reqs = [pipe.build_prefill_embeds(i, cs.QWEN_LANG) for i in prompts]
                wavs, st = pipe.synthesize_from_prefill_batch(reqs)
                return sum(len(w) for w in wavs), st["frames"]
            wav, st = pipe.synthesize_ids(cs.QWEN_IDS, language_id=cs.QWEN_LANG)
            return len(wav), st["frames"]

        t_route = time.perf_counter()
        pipe = make(cap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        request(pipe)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        progs = cs.qwen_programs(pipe) if hasattr(cs, "qwen_programs") else []
        pool = getattr(pipe, "_pool", None)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            samples, frames = request(pipe)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        device = sum(e.device_time_total for e in kern) / 1e3
        launched = sum(e.count for e in kern)
        busy = _busy_ms(prof)
        extra = {}
        if kw.get("fused_decode") == "all":
            extra = {"kernel13_ms_a_frame": sum(
                e.device_time_total for e in kern if "cluster_kernel" in e.key) / 1e3 / frames,
                "kernel14_busy_ms_a_frame": _busy_ms(prof, K14) / frames}
        walls = _walls(lambda: request(pipe), 2)
        del prof
        short = make(8)
        calls = _host_launches(lambda: request(short))
        audio_s = samples / pipe.output_sample_rate
        print(json.dumps({
            "tree": tag, "card": card, "qwen_route": route, "frames": frames,
            "first_request_s": first,
            "warmup_s": sum(pr.warmup_s for _, pr in progs) if progs else None,
            "capture_s": sum(pr.capture_s for _, pr in progs) if progs else None,
            "pool_mib": pool.nbytes() / 2**20 if pool is not None else None,
            "device_ms_a_frame": device / frames, "busy_ms_a_frame": busy / frames,
            "idle_share": 1 - busy / 1e3 / wall, "profiled_wall_s": wall,
            "kernel_launches_a_frame": launched / frames,
            "host_launch_calls_a_frame": calls / (8 * (len(prompts) if batch else 1)),
            "frames_per_s": [frames / w for w in walls], "rtf": [w / audio_s for w in walls],
            "idle_share_timed": [1 - busy / 1e3 / w for w in walls], **extra,
            "route_s": time.perf_counter() - t_route}), flush=True)
        del pipe, short
        torch.cuda.empty_cache()


def _f5_fp32(tag: str, card: str) -> None:
    import torch

    import chip_smoke as cs
    from tts_tpu_torch.runtime.f5 import F5Pipeline

    f5, vocos, audio, text = _f5_models(torch.float32)
    for quantize in (None, "w8a8"):
        pipe = F5Pipeline(f5, {" ": 0}, vocos, quantize=quantize)

        def f5_request():
            return pipe.synthesize(audio, cs.REF_TEXT, text)

        (wav, _), rows = _profile(f5_request)
        audio_s = len(wav) / pipe.cfg.sample_rate
        walls = _walls(f5_request, 3)
        print(json.dumps({"tree": tag, "card": card, "f5_fp32": quantize or "float",
                          "wall_s": walls, "rtf": [w / audio_s for w in walls],
                          "device_ms": sum(ms for _, ms in rows),
                          "kernels_4_5_ms": sum(ms for k, ms in rows if "mha_" in k)}),
              flush=True)


def _chain_ms(fn, calls: int = 10, reps: int = 10) -> float:
    """Device time a call over chains of `calls` calls (chip_smoke.chain_ms,
    which the parent tree may lack): CUDA events behind a spinning kernel,
    the median of `reps`."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _decode_digest(tag: str) -> None:
    """At the Qwen talker shape (A 2048, H 1024, F 3072), B 1, 3, 8: sha256
    of kernel 15's outputs ("decode_digest", which must be equal across the
    trees) and of kernel 14's, bf16 and int8 weights ("k14_digest", which
    must be equal across each tree's own turns: kernel 14's split over the
    input dim is an fp32 order the contract allows, not the parent's), and
    each kernel 14 output's rel L2 against its fp32 twin (the trees' must
    be within 1.25x of tree A's); each one's device time a call at B 1
    (chip_smoke.device_ms, a profiler trace of 10) and kernel 14's at B 1
    and 8 as CUDA events over a chain of 10 calls."""
    import torch

    import chip_smoke as cs

    from tts_tpu_torch.ops.decode_mlp import (fused_out_mlp, fused_out_mlp_plain,
                                              fused_out_mlp_q8)
    from tts_tpu_torch.quant.weight_only import quantize_int8_jit

    gen = torch.Generator("cuda").manual_seed(4331)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    ws = [rn(2048, 1024, scale=0.02), rn(1024, 6144, scale=0.02), rn(3072, 1024, scale=0.02)]
    wq = [quantize_int8_jit(w) for w in ws]
    outs, k14, rel, ms, chain = {}, {}, {}, {}, {}
    for b in (1, 3, 8):
        x, att = rn(b, 1024), rn(b, 2048)
        calls = {f"kernel15_b{b}": lambda: fused_out_mlp_q8(x, att, *wq),
                 f"kernel14_bf16_b{b}": lambda: fused_out_mlp(x, att, *ws),
                 f"kernel14_int8_b{b}": lambda: fused_out_mlp(x, att, *wq)}
        for name, fn in calls.items():
            (k14 if name.startswith("kernel14") else outs)[name] = fn()
            if b == 1:
                ms[name] = cs.device_ms(fn)
            if name.startswith("kernel14") and b in (1, 8):
                chain[name] = _chain_ms(fn)
        for name, w32 in ((f"kernel14_bf16_b{b}", [w.float() for w in ws]),
                          (f"kernel14_int8_b{b}", wq)):
            ref = fused_out_mlp_plain(x.float(), att.float(), *w32)
            rel[name] = (torch.linalg.vector_norm(k14[name].float() - ref)
                         / torch.linalg.vector_norm(ref)).item()
    torch.cuda.synchronize()
    print(json.dumps({"tree": tag, "decode_digest": {k: _digest(v) for k, v in outs.items()},
                      "k14_digest": {k: _digest(v) for k, v in k14.items()},
                      "k14_rel_l2": rel, "device_ms_b1": ms, "k14_chain_ms": chain}),
          flush=True)


def _decode_kernels(tag: str, card: str) -> None:
    """Kernels 11 and 12 at the Qwen talker (head_dim 128, pos 126) and Kani
    (head_dim 64, pos 700) shapes, and kernel 11 at IndexTTS-1.5's (H 1280,
    20 x 64 heads, LayerNorm, bias, no RoPE) at B 1 and 4: each output's rel
    L2 against the fp32 twin on the same bf16 inputs ("k11_12_rel_l2",
    within 1.25x of tree A's across the trees), a digest of two calls'
    outputs ("k11_12_digest", which must repeat within each tree: the
    fp32 order of the dot is each tree's own), the time a call as CUDA
    events over a chain of 10 calls and the device time by launch
    (chip_smoke.kernel_split, a profiler trace of 10)."""
    import torch

    import chip_smoke as cs
    from tts_tpu_torch.nn.rope import rope_table
    from tts_tpu_torch.ops.decode_qkv import fused_qkv_rope, fused_qkv_rope_plain
    from tts_tpu_torch.ops.decode_step import fused_qkv_attn, fused_qkv_attn_plain

    gen = torch.Generator("cuda").manual_seed(4332)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def f32(a):
        return a.float() if isinstance(a, torch.Tensor) else a

    calls = {}
    for shape, hd, eps, layers, t, pos in (("qwen talker", 128, 1e-6, 28, 640, 126),
                                           ("kani", 64, 1e-5, 6, 2048, 700)):
        heads, kvh = 16, 8
        w = rn(1024, (heads + 2 * kvh) * hd, scale=0.02)
        nw = torch.full((hd,), hd ** -0.25, device="cuda").to(torch.bfloat16)
        cos, sin = (torch.as_tensor(a[pos:pos + 1], device="cuda").to(torch.bfloat16)
                    for a in rope_table(2048, hd, 1e6))
        kc = rn(layers, 1, kvh, t, hd, scale=hd ** -0.25)
        vc = rn(layers, 1, kvh, t, hd)
        x = rn(1, 1024)
        kw = dict(heads=heads, kv_heads=kvh, head_dim=hd, q_norm=nw, k_norm=nw, eps=eps)
        kw32 = {k: f32(v) for k, v in kw.items()}
        calls[f"kernel11 {shape}"] = (
            lambda x=x, w=w, cos=cos, sin=sin, kw=kw: fused_qkv_rope(x, w, cos, sin, **kw),
            lambda x=x, w=w, cos=cos, sin=sin, kw32=kw32: fused_qkv_rope_plain(
                x.float(), w.float(), cos.float(), sin.float(), **kw32))
        calls[f"kernel12 {shape} pos {pos}"] = (
            lambda x=x, w=w, cos=cos, sin=sin, kc=kc, vc=vc, kw=kw, n=layers - 1, p=pos:
            fused_qkv_attn(x, w, cos, sin, kc, vc, n, p, **kw),
            lambda x=x, w=w, cos=cos, sin=sin, kc=kc, vc=vc, kw32=kw32, n=layers - 1, p=pos:
            fused_qkv_attn_plain(x.float(), w.float(), cos.float(), sin.float(), kc.float(),
                                 vc.float(), n, p, **kw32))
    wi = rn(1280, 60 * 64, scale=0.02)
    ki = dict(heads=20, kv_heads=20, head_dim=64, bqkv=rn(3840, scale=0.1), norm="ln",
              ln_weight=rn(1280, scale=0.1) + 1, ln_bias=rn(1280, scale=0.1), eps=1e-5)
    ki32 = {k: f32(v) for k, v in ki.items()}
    for b in (1, 4):
        xi = rn(b, 1280)
        calls[f"kernel11 indextts B {b}"] = (
            lambda xi=xi: fused_qkv_rope(xi, wi, **ki),
            lambda xi=xi: fused_qkv_rope_plain(xi.float(), wi.float(), **ki32))
    digests, rels = {}, {}
    for name, (kernel, ref) in calls.items():
        got, want = kernel(), ref()
        again = kernel()
        torch.cuda.synchronize()
        digests[name] = [[_digest(g) for g in got], [_digest(g) for g in again]]
        rel = {part: cs.rel_l2(g.float(), r) for part, g, r in zip(("out", "k", "v"),
                                                                      got, want)}
        rels.update({f"{name} {part}": e for part, e in rel.items()})
        split = cs.kernel_split(kernel)
        print(json.dumps({"tree": tag, "card": card, "decode_kernel": name,
                          "rel_l2_vs_fp32": rel, "chain_ms": _chain_ms(kernel),
                          "device_ms_by_launch": {k: ms for k, _, ms in split},
                          "device_ms": sum(ms for _, _, ms in split)}), flush=True)
    print(json.dumps({"tree": tag, "k11_12_digest": digests, "k11_12_rel_l2": rels}),
          flush=True)


def _decode_paths(tag: str, card: str) -> None:
    """Qwen3-TTS beam 3 and a batch of 4 (8 frames, kernel 11): device and
    busy time a frame under the profiler, frames/s of two; bench requests
    on the default route (bf16) and "mlp_q8" (int8): device time a frame
    and the share of kernel 12 (default) or 15 ("mlp_q8") under the
    profiler, frames/s of two; the Kani bench request greedy (kernel 12)
    and beam 5 (kernel 11): device time a token, tokens/s of two;
    BigVGAN's bench mel: samples/s of 10 calls."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tts_tpu_torch.models.bigvgan import BigVGANConfig
    from tts_tpu_torch.models.kani import KaniConfig
    from tts_tpu_torch.models.kani import init_params as kani_init
    from tts_tpu_torch.models.nanocodec import NanoCodecConfig
    from tts_tpu_torch.models.nanocodec import init_params as codec_init
    from tts_tpu_torch.runtime.kani import KaniDecodeConfig, KaniPipeline
    from tts_tpu_torch.runtime.qwen import QwenDecodeConfig, QwenTTSPipeline
    from tts_tpu_torch.runtime.vocoder import BigVGANVocoder

    # kernel 12 in either tree: step_attn_kernel, and its first launch,
    # qkv_matvec (and the epilogue, whose name kernel 11's second launch
    # in the earlier tree has) or qkv_head_kernel; kernel 15 in either (the
    # earlier three kernels on the W8A8 route, or the q8_ ones)
    k12 = ("attn_kernel", "qkv_matvec", "qkv_epilogue", "qkv_head")
    k15 = ("q8_", "oproj_kernel", "gateup_kernel", "down_kernel")
    cfg, ccfg, params, cparams = cs.qwen_models()
    dec = QwenDecodeConfig(max_frames=cs.QWEN_FRAMES)
    bf = QwenTTSPipeline(params, cfg, cparams, ccfg, dec)
    q8 = QwenTTSPipeline(params, cfg, cparams, ccfg, QwenDecodeConfig(
        max_frames=cs.QWEN_FRAMES, fused_decode="mlp_q8"), quantize=8)
    beam = QwenTTSPipeline(params, cfg, cparams, ccfg, QwenDecodeConfig(
        max_frames=8, use_beam=True, beam_size=3, beam_top_k=3))
    small = QwenTTSPipeline(params, cfg, cparams, ccfg, QwenDecodeConfig(max_frames=8))
    prompts = [cs.QWEN_IDS, np.arange(5, 20, dtype=np.int32)[None],
               np.arange(40, 90, dtype=np.int32)[None], np.array([[7, 1, 4]], np.int32)]
    reqs = [small.build_prefill_embeds(i, cs.QWEN_LANG) for i in prompts]
    for route, fn in (("beam 3, 8 frames", lambda: beam.synthesize_ids(
            cs.QWEN_IDS, language_id=cs.QWEN_LANG)[1]["frames"]),
                      ("batch of 4, 8 frames", lambda: (
                          small.synthesize_from_prefill_batch(reqs), 8)[1])):
        frames, rows, busy = _profile(fn, busy={"all": None})
        print(json.dumps({"tree": tag, "card": card, "qwen_route": route, "frames": frames,
                          "frames_per_s": [frames / w for w in _walls(fn, 2)],
                          "device_ms_a_frame": sum(ms for _, ms in rows) / frames,
                          "busy_ms_a_frame": busy["all"] / frames}), flush=True)
    del beam, small, reqs
    for route, pipe, pats in (("default bf16", bf, k12), ("mlp_q8 int8", q8, k15)):
        def qwen():
            return pipe.synthesize_ids(cs.QWEN_IDS, language_id=cs.QWEN_LANG)

        (_, st), rows = _profile(qwen)
        frames = st["frames"]
        part = sum(ms for k, ms in rows if any(p in k for p in pats))
        print(json.dumps({"tree": tag, "card": card, "qwen_route": route, "frames": frames,
                          "frames_per_s": [frames / w for w in _walls(qwen, 2)],
                          "device_ms_a_frame": sum(ms for _, ms in rows) / frames,
                          "kernel_ms_a_frame": part / frames,
                          "kernel": "12" if pats is k12 else "15"}), flush=True)
    del bf, q8, params, cparams

    kcfg, nccfg = KaniConfig(max_seq_len=2048, stop_token=-1), NanoCodecConfig()
    kparams = kani_init(kcfg, torch.Generator("cuda").manual_seed(2), torch.bfloat16)
    kcparams = codec_init(nccfg, torch.Generator("cuda").manual_seed(3), torch.bfloat16)
    kani = KaniPipeline(kparams, kcfg, kcparams, nccfg,
                        KaniDecodeConfig(max_new_tokens=cs.KANI_NEW, repeat_penalty=1.0))
    ids = np.array(cs.KANI_IDS, np.int32)
    _, rows = _profile(lambda: kani.synthesize_ids(ids))
    print(json.dumps({"tree": tag, "card": card, "kani": "greedy bf16",
                      "tokens_per_s": [cs.KANI_NEW / w for w in _walls(
                          lambda: kani.synthesize_ids(ids), 2)],
                      "device_ms_a_token": sum(ms for _, ms in rows) / cs.KANI_NEW,
                      "kernel12_ms_a_token": sum(ms for k, ms in rows
                                                 if any(p in k for p in k12)) / cs.KANI_NEW}),
          flush=True)
    kani = KaniPipeline(kparams, kcfg, kcparams, nccfg, KaniDecodeConfig(
        max_new_tokens=cs.KANI_NEW, repeat_penalty=1.0, use_beam=True, beam_size=5, top_k=5))
    _, rows = _profile(lambda: kani.synthesize_ids(ids))
    print(json.dumps({"tree": tag, "card": card, "kani": "beam 5 bf16",
                      "tokens_per_s": [cs.KANI_NEW / w for w in _walls(
                          lambda: kani.synthesize_ids(ids), 2)],
                      "device_ms_a_token": sum(ms for _, ms in rows) / cs.KANI_NEW,
                      "kernel11_ms_a_token": sum(ms for k, ms in rows
                                                 if any(p in k for p in k12[1:]))
                      / cs.KANI_NEW}), flush=True)
    del kani, kparams, kcparams

    vcfg = BigVGANConfig()
    mel = np.random.default_rng(9).standard_normal((1, 512, vcfg.num_mels)).astype(np.float32)
    for dt in (torch.bfloat16, torch.float32):
        voc = BigVGANVocoder(cs.bigvgan_weights(vcfg, 9, dt), vcfg, dtype=dt)
        _, rows = _profile(lambda: voc(mel))
        k10 = sum(ms for k, ms in rows if "amp_branch_kernel" in k)
        bench = voc.benchmark(mel_frames=512, iters=10 if dt == torch.bfloat16 else 5)
        print(json.dumps({"tree": tag, "card": card, "bigvgan": str(dt).split(".")[-1],
                          "device_ms_a_call": sum(ms for _, ms in rows),
                          "kernel10_ms_a_call": k10,
                          "samples_per_s": bench["samples_per_sec"], "rtf": bench["rtf"]}),
              flush=True)
        del voc


def _index_audio(rate: int):
    """chip_smoke's 6 s IndexTTS reference."""
    import numpy as np

    tt = np.arange(6 * rate) / rate
    sig = (0.3 * np.sin(2 * np.pi * 220 * tt) * (1 + np.sin(2 * np.pi * 3 * tt))
           + 0.1 * np.sin(2 * np.pi * 330 * tt)
           + 0.05 * np.random.default_rng(12).standard_normal(tt.size))
    return (sig * 12000).astype(np.int16)


def _indextts(tag: str, card: str) -> None:
    """The `indextts` part (see the module's docstring)."""
    import numpy as np
    import torch

    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import tts_tpu_torch.runtime.indextts as ri
    from tts_tpu_torch.runtime.indextts import IndexTTSPipeline

    cfg, vcfg, params = cs.indextts_models()
    audio = _index_audio(vcfg.sample_rate)
    prompts = [cs.INDEX_IDS, np.arange(5, 20, dtype=np.int32)[None],
               np.arange(40, 90, dtype=np.int32)[None], np.array([[7, 1, 4]], np.int32)]
    k11 = ("qkv_head", "qkv_matvec", "qkv_epilogue")
    routes = [("bf16", {}, False, 1), ("int8", {"quantize": 8}, False, 1),
              ("batch of 4", {}, True, 1)]
    if hasattr(ri, "STEPS"):
        # the step program at 4 decode steps a replay (a tree with programs)
        routes.append(("bf16, 4 steps a replay", {}, False, 4))
    steps0 = getattr(ri, "STEPS", None)
    for route, kw, batch, steps in routes:
        if steps0 is not None:
            ri.STEPS = steps
        t_route = time.perf_counter()
        pipe = IndexTTSPipeline(params, cfg, vcfg, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = pipe.encode_reference(audio)

        def request(max_gen=cs.INDEX_GEN, pipe=pipe, ref=ref):
            if batch:
                wavs, st = pipe.synthesize_ids_batch([(p, ref) for p in prompts],
                                                     max_gen=max_gen)
                return sum(len(w) for w in wavs), st["tokens"]
            wav, st = pipe.synthesize_ids(cs.INDEX_IDS, ref, max_gen=max_gen)
            return len(wav), st.tokens

        request()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        progs = cs.index_programs(pipe) if hasattr(cs, "index_programs") else []
        pool = getattr(pipe, "_pool", None)
        # CUDA activity only: a CPU trace of an eager request's ~10^5
        # launches takes minutes to reduce
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            samples, tokens = request()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        device = sum(e.device_time_total for e in kern) / 1e3
        busy = {"all": _busy_ms(prof), "kernel11": _busy_ms(prof, k11)}
        launched = sum(e.count for e in kern)
        del prof
        walls = _walls(request, 2)
        audio_s = samples / vcfg.sample_rate
        short = 16
        calls = _host_launches(lambda: request(short))
        rec = {"tree": tag, "card": card, "indextts": route, "tokens": tokens,
               "first_request_s": first,
               "warmup_s": sum(p.warmup_s for _, p in progs) if progs else None,
               "capture_s": sum(p.capture_s for _, p in progs) if progs else None,
               "pool_mib": pool.nbytes() / 2**20 if pool is not None else None,
               "device_ms_a_token": device / tokens, "busy_ms_a_token": busy["all"] / tokens,
               "kernel11_busy_ms_a_token": busy["kernel11"] / tokens,
               "idle_share": 1 - busy["all"] / 1e3 / wall, "profiled_wall_s": wall,
               "kernel_launches_a_token": launched / tokens,
               "host_launch_calls_a_token": calls / (short * (len(prompts) if batch else 1)),
               "tokens_per_s": [tokens / w for w in walls], "rtf": [w / audio_s for w in walls],
               "idle_share_timed": [1 - busy["all"] / 1e3 / w for w in walls]}
        if route == "bf16":
            rec.update(_index_parts(pipe, ref, audio))
        rec["route_s"] = time.perf_counter() - t_route
        print(json.dumps(rec), flush=True)
        del pipe, ref
        torch.cuda.empty_cache()
    if steps0 is not None:
        ri.STEPS = steps0


def _index_parts(pipe, ref, audio) -> dict:
    """The bench request's vocoder call (its hiddens from one decode) and
    the encode of the reference: best wall of 3 (ms) and the card's busy
    time under the profiler (ms), each on the tree's own path (the
    programs where the tree has them, else the eager calls)."""
    import numpy as np

    import chip_smoke as cs

    ids = np.zeros((1, 32), np.int32)
    ids[0] = cs.INDEX_IDS[0]
    hiddens, done, _ = pipe._decode(ref[0], ids, np.array([32]), cs.INDEX_GEN)
    n = int(done[0]) - 2
    fb = min(max(8, -(-n // 8) * 8), cs.INDEX_GEN)
    ce, conds = ref[1], ref[2]
    if hasattr(pipe, "_vocoder"):
        prog = pipe._vocoder(fb, None, ce, conds)

        def vocode():
            return prog(hiddens[:, :fb], np.array([n], np.int32), ce, *conds)
    else:
        def vocode():
            return pipe._vocode(hiddens, [n], fb, ce, conds)

    out = {}
    for name, fn in (("vocode", vocode), ("encode", lambda: pipe.encode_reference(audio))):
        _, _, _, busy = _profile(fn, walled=True, busy={"all": None})
        out[f"{name}_ms"] = 1e3 * min(_walls(fn, 3))
        out[f"{name}_busy_ms"] = busy["all"]
    return out


def _vox_audio(rate: int):
    """chip_smoke's 6 s VoxCPM prompt."""
    import numpy as np

    tt = np.arange(6 * rate) / rate
    sig = (0.3 * np.sin(2 * np.pi * 220 * tt) * (1 + np.sin(2 * np.pi * 3 * tt))
           + 0.1 * np.sin(2 * np.pi * 330 * tt)
           + 0.05 * np.random.default_rng(16).standard_normal(tt.size))
    return (sig * 12000).astype(np.int16)


def _voxcpm(tag: str, card: str) -> None:
    """The `voxcpm` part (see the module's docstring)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import tts_tpu_torch.runtime.voxcpm as rv
    from tts_tpu_torch.models.voxcpm import VoxCPMConfig, voxcpm_v2_config
    from tts_tpu_torch.runtime.voxcpm import VoxCPMDecodeConfig, VoxCPMPipeline

    cfg2, cfg15 = voxcpm_v2_config(), VoxCPMConfig()
    params2, vae2 = cs.voxcpm_models(cfg2, 30)
    batch = [(cs.VOX_PROMPT, np.arange(21, 53 + 2 * i, dtype=np.int32)[None])
             for i in range(8)]
    routes = [("VoxCPM-2 bf16", cfg2, None, 1, False), ("VoxCPM-2 int8", cfg2, 8, 1, False),
              ("VoxCPM-1.5 batch of 8", cfg15, None, 1, True)]
    steps0 = getattr(rv, "STEPS", None)
    if steps0 is not None:
        # the step program at 2 latent steps a replay (a tree with programs)
        routes.append(("VoxCPM-2 bf16, 2 latent steps a replay", cfg2, None, 2, False))
    for route, cfg, quantize, steps, is_batch in routes:
        if steps0 is not None:
            rv.STEPS = steps
        t_route = time.perf_counter()
        if cfg is cfg2:
            params, vae = params2, vae2
        else:
            params, vae = cs.voxcpm_models(cfg15, 40)

        def make(latents, params=params, vae=vae, cfg=cfg, quantize=quantize):
            return VoxCPMPipeline(params, cfg, vae, VoxCPMDecodeConfig(
                max_latents=latents, min_latents=latents), quantize=quantize)

        def request(pipe, is_batch=is_batch):
            if is_batch:
                wavs, st = pipe.synthesize_ids_batch(batch)
                return sum(len(w) for w in wavs), st["latents"]
            wav, st = pipe.synthesize_ids(cs.VOX_PROMPT, cs.VOX_TARGET)
            return len(wav), st["latents"]

        pipe = make(cs.VOX_LATENTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        request(pipe)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        progs = cs.vox_programs(pipe) if hasattr(cs, "vox_programs") else []
        pool = getattr(pipe, "_pool", None)
        # CUDA activity only: a CPU trace of an eager request's ~1.5e5
        # launches takes minutes to reduce
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            samples, latents = request(pipe)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        device = sum(e.device_time_total for e in kern) / 1e3
        busy = _busy_ms(prof)
        launched = sum(e.count for e in kern)
        del prof
        walls = _walls(lambda: request(pipe), 2)
        audio_s = samples / cfg.output_sample_rate
        short = make(8)
        calls = _host_launches(lambda: request(short))
        rec = {"tree": tag, "card": card, "voxcpm": route, "latents": latents,
               "first_request_s": first,
               "warmup_s": sum(p.warmup_s for _, p in progs) if progs else None,
               "capture_s": sum(p.capture_s for _, p in progs) if progs else None,
               "pool_mib": pool.nbytes() / 2**20 if pool is not None else None,
               "device_ms_a_latent": device / latents, "busy_ms_a_latent": busy / latents,
               "idle_share": 1 - busy / 1e3 / wall, "profiled_wall_s": wall,
               "kernel_launches_a_latent": launched / latents,
               "host_launch_calls_a_latent": calls / (8 * (len(batch) if is_batch else 1)),
               "latents_per_s": [latents / w for w in walls],
               "rtf": [w / audio_s for w in walls],
               "idle_share_timed": [1 - busy / 1e3 / w for w in walls]}
        if route == "VoxCPM-2 bf16":
            rec.update(_vox_parts(pipe))
        rec["route_s"] = time.perf_counter() - t_route
        print(json.dumps(rec), flush=True)
        del pipe, short
        torch.cuda.empty_cache()
    if steps0 is not None:
        rv.STEPS = steps0


def _vox_parts(pipe) -> dict:
    """The bench request's VAE decode (its 48 latents from one decode) and
    the 6 s prompt's encode: best wall of 3 (ms, the VAE's host copy
    included) and the card's busy time under the profiler (ms), each on the
    tree's own path (the programs where the tree has them, else the eager
    calls); a stream's first chunk (chunk 4), its first and second run."""
    import numpy as np

    import chip_smoke as cs

    cfg = pipe.cfg
    segs = [("text", np.concatenate([cs.VOX_PROMPT[0], cs.VOX_TARGET[0],
                                     [cfg.audio_start_id]]).astype(np.int32))]
    max_steps = cs.VOX_TARGET.shape[1] * pipe.dcfg.decode_limit_factor + 10
    buf = pipe._latent_buf(max_steps)
    text, is_audio, fe, pos = pipe._prompt_bufs(segs)
    lat = None
    for lat, num, _ in pipe._latent_steps(text, is_audio, pos, fe, pipe._zero_cond(),
                                          max_steps, buf, pipe.dcfg.seed):
        pass
    lat = lat.clone()
    if hasattr(pipe, "_vae"):
        prog = pipe._vae(1, buf)
        counts = np.array([num], np.int32)

        def vae():
            return prog(lat, counts)[0].cpu()
    else:
        def vae():
            return pipe._vocode(lat)

    audio = _vox_audio(cfg.sample_rate)
    out = {}
    for name, fn in (("vae", vae), ("encode", lambda: pipe.encode_prompt(audio))):
        _, _, _, busy = _profile(fn, walled=True, busy={"all": None})
        out[f"{name}_ms"] = 1e3 * min(_walls(fn, 3))
        out[f"{name}_busy_ms"] = busy["all"]
    for run in ("stream_first_chunk_s", "stream_first_chunk_s_again"):
        _, out[run], _ = cs.timed_stream(pipe.synthesize_streaming(
            segs, pipe._zero_cond(), max_steps, chunk=4))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="root of tree A")
    ap.add_argument("--b", help="root of tree B")
    ap.add_argument("--rounds", type=int, default=1, help="turns A, B, B, A this many times")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated parts of a turn, of {', '.join(PARTS)}")
    ap.add_argument("--turn", metavar="TAG", help=argparse.SUPPRESS)
    args = ap.parse_args()
    parts = tuple(args.parts.split(","))
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts: unknown {sorted(set(parts) - set(PARTS))}")
    if args.turn:
        turn(args.turn, parts)
        return
    if not args.a or not args.b:
        ap.error("--a and --b are required")
    trees = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    builds = [subprocess.Popen([sys.executable, "-c",
                                "from tts_tpu_torch.ops import _build; _build.build()"],
                               cwd=t) for t in trees.values()]
    if any(p.wait() for p in builds):
        raise SystemExit("chip_ab: a build failed")
    me = os.path.abspath(__file__)
    digests: dict = {}
    for tag in ("A", "B", "B", "A") * args.rounds:
        out = subprocess.run([sys.executable, me, "--turn", tag, "--parts", args.parts],
                             cwd=trees[tag], check=True, stdout=subprocess.PIPE,
                             text=True).stdout
        print(out, end="", flush=True)
        for line in out.splitlines():
            rec = json.loads(line) if line.startswith("{") else {}
            for key in ("flash_digest", "q8_digest", "decode_digest", "k14_digest",
                        "k14_rel_l2", "k11_12_digest", "k11_12_rel_l2"):
                if key in rec:
                    digests.setdefault(key, {}).setdefault(tag, []).append(rec[key])
            if rec.get("f5_bf16") == "w8a8":
                digests.setdefault("w8a8_audio", {}).setdefault(tag, []).append(
                    rec["audio_digest"])

    def same(key):
        runs = digests.get(key, {})
        return all(d == runs["A"][0] for tree in runs.values() for d in tree)

    flash, q8 = same("flash_digest"), same("q8_digest") and same("w8a8_audio")
    decode = same("decode_digest")
    # kernels 14, 11 and 12: bitwise within each tree's turns (and over two
    # calls in a turn); across the trees within 1.25x (chip_smoke.STEP_SLACK)
    # of tree A's rel L2 against the fp32 twin

    def repeat(key):
        runs = digests.get(key, {})
        return all(d == tree[0] for tree in runs.values() for d in tree)

    def close(key):
        rels = digests.get(key, {})
        return all(r[name] <= 1.25 * rels["A"][0][name] for runs in rels.values()
                   for r in runs for name in r) if "A" in rels else True

    k14_same, k14_close = repeat("k14_digest"), close("k14_rel_l2")
    k11_12_same = repeat("k11_12_digest") and all(
        d[0] == d[1] for tree in digests.get("k11_12_digest", {}).values() for run in tree
        for d in run.values())
    k11_12_close = close("k11_12_rel_l2")
    print(json.dumps({"kernels_1_4_5_bitwise_equal_across_trees": flash,
                      "kernels_6_7_8_and_w8a8_audio_bitwise_equal_across_trees": q8,
                      "kernel_15_bitwise_equal_across_trees": decode,
                      "kernel_14_bitwise_repeatable_in_each_tree": k14_same,
                      "kernel_14_rel_l2_within_1.25x_tree_a": k14_close,
                      "kernels_11_12_bitwise_repeatable_in_each_tree": k11_12_same,
                      "kernels_11_12_rel_l2_within_1.25x_tree_a": k11_12_close,
                      "digests": digests}), flush=True)
    if not (flash and q8 and decode and k14_same and k14_close and k11_12_same
            and k11_12_close):
        raise SystemExit("chip_ab: kernel outputs differ between the trees")

if __name__ == "__main__":
    main()
