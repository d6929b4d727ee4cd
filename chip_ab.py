#!/usr/bin/env python3
"""Two checkouts of the port in turns on one NVIDIA card: A, B, B, A.

    python3 chip_ab.py --a DIR_A --b DIR_B     # e.g. a parent commit's tree
                                               # (git archive) and this one

Each turn runs this script's `turn` in a fresh process from that tree's
root, so it imports that tree's tts_tpu_torch and chip_smoke.py:
  * the bf16 F5TTS_v1_Base bench request under torch.profiler (device time,
    kernel 3's share, the profiled wall and the card's idle share), then
    F5Pipeline.benchmark (latency and sustained RTF, dispatch_ms: the host's
    prep and enqueue, fence_ms: the wait for the card);
  * a digest of kernels 1, 4 and 5's bf16 outputs on seeded inputs (the
    flash core; two trees whose kernels compute the same bits give the same
    digest, which the last line compares);
  * after a warm-up, one Qwen3-TTS-0.6B request on fused_decode="all"
    (bench ids, max_frames 128) under torch.profiler (device time a frame,
    kernel 13's share of it) and two timed;
  * the fp32 F5TTS_v1_Base bench request (float and quantize="w8a8") under
    the profiler (device time, kernels 4-5's share) and three timed.
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


def _f5_bf16(tag: str, card: str) -> None:
    """The bf16 F5 bench request: profiled device time by kernel 3 and the
    rest, then F5Pipeline.benchmark."""
    import torch

    import chip_smoke as cs
    from tts_tpu_torch.runtime.f5 import F5Pipeline

    f5, vocos, audio, text = _f5_models(torch.bfloat16)
    pipe = F5Pipeline(f5, {" ": 0}, vocos)

    def request():
        return pipe.synthesize(audio, cs.REF_TEXT, text)

    _, rows, wall = _profile(request, walled=True)
    # kernel 3 in either tree: the older ff1/ff2_kernel, or the row pass and GEMMs
    k3 = sum(ms for k, ms in rows if any(
        p in k for p in ("ff1_kernel", "ff2_kernel", "ln_mod_kernel", "dit_gemm_kernel")))
    busy = sum(ms for _, ms in rows)
    bench = pipe.benchmark(ref_seconds=6.0, gen_words=15, iters=3)
    print(json.dumps({"tree": tag, "card": card, "f5_bf16": "float", "device_ms": busy,
                      "kernel3_ms": k3, "kernel3_share": k3 / busy,
                      "profiled_wall_s": wall,
                      "idle_share": 1 - busy / 1e3 / wall,
                      **{k: bench[k] for k in ("wall_s", "rtf", "sustained_rtf", "prep_ms",
                                               "dispatch_ms", "fence_ms")}}), flush=True)


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
        name: hashlib.sha256(o.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
        for name, o in outs.items()}}), flush=True)


def turn(tag: str) -> None:
    """One turn, from the root of the tree under test."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from tts_tpu_torch.runtime.f5 import F5Pipeline
    from tts_tpu_torch.runtime.qwen import QwenDecodeConfig, QwenTTSPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card()
    _f5_bf16(tag, card)
    _flash_digest(tag)

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
    ap.add_argument("--turn", metavar="TAG", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        turn(args.turn)
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
    digests = {}
    for tag in ("A", "B", "B", "A"):
        out = subprocess.run([sys.executable, me, "--turn", tag], cwd=trees[tag], check=True,
                             stdout=subprocess.PIPE, text=True).stdout
        print(out, end="", flush=True)
        for line in out.splitlines():
            if '"flash_digest"' in line:
                digests.setdefault(tag, []).append(json.loads(line)["flash_digest"])
    same = all(d == digests["A"][0] for tree in digests.values() for d in tree)
    print(json.dumps({"kernels_1_4_5_bitwise_equal_across_trees": same, "digests": digests}),
          flush=True)
    if not same:
        raise SystemExit("chip_ab: kernels 1, 4 and 5 differ between the trees")


if __name__ == "__main__":
    main()
