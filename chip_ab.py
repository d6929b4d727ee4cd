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
    quantize="w8a8", under torch.profiler (device time, kernel 3's and the
    int8 kernels' (q8_*) shares, the profiled wall and the card's idle
    share), then F5Pipeline.benchmark (latency and sustained RTF,
    dispatch_ms: the host's prep and enqueue, fence_ms: the wait for the
    card); a digest of the W8A8 request's audio; the kernel launches of one
    request;
  * digests: a digest of kernels 1, 4 and 5's bf16 outputs on seeded
    inputs (the flash core), and of kernels 6, 7 and 8's outputs on seeded
    inputs in bf16 and fp32 activations, through the wrappers' signatures
    that both trees share, each weight in the layout the tree's pipeline
    gives it (two trees whose kernels compute the same bits give the same
    digests, which the last line compares);
  * qwen: after a warm-up, one Qwen3-TTS-0.6B request on fused_decode="all"
    (bench ids, max_frames 128) under torch.profiler (device time a frame,
    kernel 13's share of it) and two timed;
  * f5_fp32: the fp32 F5TTS_v1_Base bench request (float and
    quantize="w8a8") under the profiler (device time, kernels 4-5's share)
    and three timed.
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


def _profile(fn, walled: bool = False):
    """fn() once to warm up, then once under torch.profiler: its output,
    (kernel, device ms) rows and, if walled, the profiled call's wall (s)."""
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
    return (out, rows, wall) if walled else (out, rows)


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
        q8 = sum(ms for k, ms in rows if "q8_" in k)
        busy = sum(ms for _, ms in rows)
        bench = pipe.benchmark(ref_seconds=6.0, gen_words=15, iters=3)
        before = sum(LAUNCHES.values())
        request()
        launches = sum(LAUNCHES.values()) - before
        extra = {"audio_digest": _digest(wav)} if quantize else {}
        print(json.dumps({"tree": tag, "card": card, "f5_bf16": quantize or "float",
                          "device_ms": busy, "kernel3_ms": k3, "kernel3_share": k3 / busy,
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
    bench shapes, bf16 and fp32 activations."""
    import torch

    from tts_tpu_torch.ops import quant_matmul
    from tts_tpu_torch.ops.dit_mlp import mlp_block_fused_q8
    from tts_tpu_torch.ops.quant_matmul import ln_qkv_q8, out_proj_residual_q8
    from tts_tpu_torch.quant.weight_only import quantize_int8_eager

    gen = torch.Generator("cuda").manual_seed(4328)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    # kernels 7 and 6 read their weights K-major where the tree has
    # to_kmajor (its quantize_dit lays them out so), else row-major
    lay = getattr(quant_matmul, "to_kmajor", lambda q: q)

    def qw(*shape, kmajor=False):
        w = quantize_int8_eager(rn(*shape, scale=0.02))
        return (lay(w.q) if kmajor else w.q), w.scale

    d, n, f = 1024, 3072, 2048
    x, o = rn(2, 1408, d), rn(2, 1408, d)
    wqkv, wo, w1, w2 = (qw(d, n, kmajor=True), qw(d, d), qw(d, f, kmajor=True),
                        qw(f, d, kmajor=True))
    mods2, mods3 = rn(2, d, scale=0.5), rn(2, 3, d, scale=0.5)
    bq, bo, gate, b1, b2 = (rn(k, scale=0.1) for k in (n, d, d, f, d))
    outs = {}
    for dt in (torch.bfloat16, torch.float32):
        xd, od = x.to(dt), o.to(dt)
        key = "bf16" if dt == torch.bfloat16 else "fp32"
        outs[f"kernel7_{key}"] = ln_qkv_q8(xd, mods2, *wqkv, bq)
        outs[f"kernel8_{key}"] = out_proj_residual_q8(od, *wo, bo, gate, xd)
        outs[f"kernel6_{key}"] = mlp_block_fused_q8(xd, mods3, *w1, b1, *w2, b2)
    torch.cuda.synchronize()
    print(json.dumps({"tree": tag, "q8_digest": {k: _digest(v) for k, v in outs.items()}}),
          flush=True)


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


PARTS = ("host", "f5_bf16", "digests", "qwen", "f5_fp32")


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


def _qwen(tag: str, card: str) -> None:
    import chip_smoke as cs
    from tts_tpu_torch.runtime.qwen import QwenDecodeConfig, QwenTTSPipeline

    cfg, ccfg, params, cparams = cs.qwen_models()
    qp = QwenTTSPipeline(params, cfg, cparams, ccfg,
                         QwenDecodeConfig(max_frames=128, fused_decode="all"))

    def qwen():
        return qp.synthesize_ids(cs.QWEN_IDS, language_id=cs.QWEN_LANG)

    (_, st), rows = _profile(qwen)
    frames = st["frames"]
    k13 = sum(ms for k, ms in rows
              if any(p in k for p in ("block_kernel", "merge_kernel", "cluster_kernel")))
    print(json.dumps({"tree": tag, "card": card, "qwen_all_frames": frames,
                      "frames_per_s": [frames / w for w in _walls(qwen, 2)],
                      "device_ms_a_frame": sum(ms for _, ms in rows) / frames,
                      "kernel13_ms_a_frame": k13 / frames}), flush=True)
    del qp, params, cparams


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
            for key in ("flash_digest", "q8_digest"):
                if key in rec:
                    digests.setdefault(key, {}).setdefault(tag, []).append(rec[key])
            if rec.get("f5_bf16") == "w8a8":
                digests.setdefault("w8a8_audio", {}).setdefault(tag, []).append(
                    rec["audio_digest"])

    def same(key):
        runs = digests.get(key, {})
        return all(d == runs["A"][0] for tree in runs.values() for d in tree)

    flash, q8 = same("flash_digest"), same("q8_digest") and same("w8a8_audio")
    print(json.dumps({"kernels_1_4_5_bitwise_equal_across_trees": flash,
                      "kernels_6_7_8_and_w8a8_audio_bitwise_equal_across_trees": q8,
                      "digests": digests}), flush=True)
    if not (flash and q8):
        raise SystemExit("chip_ab: kernel outputs differ between the trees")

if __name__ == "__main__":
    main()
