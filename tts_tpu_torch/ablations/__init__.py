"""Ablation entry points of the port's kernels (counterparts of
benchmarks/flash_ablation.py and benchmarks/q8_kernel_profile.py): each
times a hand-written kernel's variants at the script's shapes on the card
and prints one JSON line a variant.

    python -m tts_tpu_torch.ablations.flash_ablation [variant ...] [--device cpu]
    python -m tts_tpu_torch.ablations.q8_kernel_profile [variant ...] [--device cpu]

On the card a line holds the variant's device time a call (a torch.profiler
trace of 10 calls, the kernel's own launches) and its time over a chain of
10 calls (CUDA events), its error against the fp32 reference chain and its
bound. `--device cpu` runs the plain twins and times nothing (its timing
fields are null); without a card and without it, the run fails.

This module also holds the card's yardstick, which chip_smoke.py uses too:
the peak rates behind every bound, the card's name and power limit, and
the two timers.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

__all__ = ["EXP_S", "HBM_BYTES_S", "PEAK_OPS_S", "card", "chain_ms", "device_ms", "emit",
           "errors", "exp_floor_ms", "nbytes", "parse", "set_bound"]

# the least time the card could take (H100 SXM datasheet: dense tensor-core
# peaks, HBM rate, at the full 700 W)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
# the card's exp rate: 132 SMs x 16 SFU results a clock at 1.83 GHz (boost)
EXP_S = 132 * 16 * 1.83e9


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


def exp_floor_ms(n_scores: float) -> float:
    """The least time the SFUs take for one exp2 a score, beside a flash
    kernel's tensor-core bound (not part of bound_ms)."""
    return n_scores / EXP_S * 1e3


def card(device: torch.device | None = None) -> str:
    """The card's name and power limit as nvidia-smi reports them (card 0
    by default); "cpu" for a CPU device."""
    if device is not None and device.type != "cuda":
        return "cpu"
    index = 0 if device is None or device.index is None else device.index
    out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def device_ms(fn, iters: int = 10, only: str | tuple | None = None) -> float:
    """Device time of one call: the kernels' time in a torch.profiler trace
    of `iters` calls, over iters. A decode kernel's single-call event time
    is mostly the host's enqueue, the card waiting on it. `only` keeps the
    kernels whose name holds it (or one of a tuple of names: a wrapper's
    own kernels, without the casts and fills it issues around them). A
    trace that holds none of those kernels is taken again, up to three in
    all (on the card a trace has come back without them, once in several
    runs); then CUDA events around the `iters` calls give the time
    (enqueue and every kernel of the call included), and the line says so."""
    from torch.profiler import ProfilerActivity, profile

    keys = (only,) if isinstance(only, str) else only
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and (keys is None or any(k in e.key for k in keys))) / 1e3 / iters
        if ms > 0:
            return ms
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    what = "device time" if keys is None else f"a {' or '.join(map(repr, keys))} kernel"
    print(f"  (three profiler traces held no {what}: CUDA events over {iters} calls, "
          f"{ms:.4f} ms a call)", flush=True)
    return ms


def chain_ms(fn, calls: int = 10, reps: int = 10) -> float:
    """Device time a call over a chain of `calls` calls of fn(): CUDA events
    around the chain, enqueued behind a kernel that spins for a few ms so
    the host's enqueue runs ahead of the card and the calls run back to
    back (with programmatic dependent launch a profiler's sum of kernel
    times counts their overlap twice); the median of `reps` chains."""
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


def parse(doc: str, variants) -> argparse.Namespace:
    """The entry points' command line: variant names (default all, in
    order) and --device."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(variants),
                    help="variants to run (default: " + " ".join(variants) + ")")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) runs the kernels; cpu runs their plain twins")
    args = ap.parse_args()
    for name in args.variants:
        if name not in variants:
            ap.error(f"unknown variant {name!r}: one of {' '.join(variants)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is False); "
                         "pass --device cpu to run the plain twins")
    return args


def errors(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """max |got - ref| and their mean, in fp32."""
    err = (got.float() - ref.float()).abs()
    return {"maxabs": err.max().item(), "mad": err.mean().item()}


def emit(line: dict) -> None:
    print(json.dumps(line), flush=True)
