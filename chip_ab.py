#!/usr/bin/env python3
"""Two checkouts of the port in turns on one NVIDIA card: A, B, B, A.

    python3 chip_ab.py --a DIR_A --b DIR_B     # e.g. a parent commit's tree
                                               # (git archive) and this one

Each turn runs this script's `turn` in a fresh process from that tree's
root, so it imports that tree's tts_tpu_torch and chip_smoke.py: after a
warm-up, one Qwen3-TTS-0.6B request on fused_decode="all" (bench ids,
max_frames 128) under torch.profiler (device time a frame, kernel 13's
share of it) and two timed, then the fp32 F5TTS_v1_Base bench request
(float and quantize="w8a8") under the profiler (device time, kernels 4-5's
share) and three timed. Random weights from chip_smoke.py's seeds. Both
trees' kernels build first, at once. Each turn prints JSON lines; compare
the trees only within one run of this script.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _profile(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, rows


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


def turn(tag: str) -> None:
    """One turn, from the root of the tree under test."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from tts_tpu_torch.models.f5 import F5Config, F5Model
    from tts_tpu_torch.models.f5 import init_params as f5_init
    from tts_tpu_torch.models.vocos import VocosConfig, VocosModel
    from tts_tpu_torch.models.vocos import init_params as vocos_init
    from tts_tpu_torch.runtime.f5 import F5Pipeline
    from tts_tpu_torch.runtime.qwen import QwenDecodeConfig, QwenTTSPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card()

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

    fcfg, vcfg = F5Config(), VocosConfig()
    f5 = F5Model(fcfg, f5_init(fcfg, torch.Generator("cuda").manual_seed(0), torch.float32))
    vocos = VocosModel(vcfg, vocos_init(vcfg, torch.Generator("cuda").manual_seed(1),
                                        torch.float32))
    audio = (np.random.default_rng(0).standard_normal(int(6.0 * fcfg.sample_rate))
             * 3000).astype(np.int16)
    text = " ".join(["word"] * 15)
    for quantize in (None, "w8a8"):
        pipe = F5Pipeline(f5, {" ": 0}, vocos, quantize=quantize)

        def f5_request():
            return pipe.synthesize(audio, cs.REF_TEXT, text)

        (wav, _), rows = _profile(f5_request)
        audio_s = len(wav) / fcfg.sample_rate
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
    for tag in ("A", "B", "B", "A"):
        subprocess.run([sys.executable, me, "--turn", tag], cwd=trees[tag], check=True)


if __name__ == "__main__":
    main()
