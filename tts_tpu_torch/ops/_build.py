"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each of `tts_tpu_torch/csrc/*.cu` compiles to an object with its own nvcc,
all started together, and the objects link into one shared library with a
plain C interface, for `sm_90a` (H100). The build runs at first use, on the
machine with the card, into `tts_tpu_torch/_build/<hash>/`, keyed by a hash
of the sources and flags, so an edited source rebuilds and an unchanged one
loads what is there. Importing this module builds nothing.

Each kernel wrapper launches through `launch`, which makes the tensors'
card the current device for the call where it is not (the C entries cache
per-device state by `cudaGetDevice`, and launch on the current device),
checks the error code the C entry returns (`cudaGetLastError()` after the
launch) and adds one to the wrapper's count in `LAUNCHES`. Under
`recording()` (the warm-up and capture of a CUDA graph) a thread's counts
go to the recorder instead: a captured launch runs at the graph's replays,
which count it (`runtime/program.py`).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "build", "count_launch", "launch", "library", "recording",
           "sm_count"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
_LIB_NAME = "libtts_tpu_torch_kernels.so"

# kernel name -> number of wrapper calls that launched it; the slot servers
# launch from their worker threads, so a count is added under a lock
LAUNCHES: collections.Counter = collections.Counter()
_count_lock = threading.Lock()
# a thread's active recorder (`recording`), if any
_local = threading.local()

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_declared: set[str] = set()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless this exact build exists. Returns
    (library path, seconds spent compiling, nvcc's log)."""
    out_dir = BUILD_DIR / _digest()
    lib = out_dir / _LIB_NAME
    log = out_dir / "nvcc.log"
    if lib.is_file():
        return lib, 0.0, log.read_text() if log.is_file() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [out_dir / f"{src.stem}.{pid}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        text = proc.communicate()[0]
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    text = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{text}")
    tmp = out_dir / f"{_LIB_NAME}.{pid}.tmp"
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    text += proc.stdout + proc.stderr
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{text}")
    log.write_text(text)
    os.replace(tmp, lib)      # atomic: a concurrent loader sees all or none
    return lib, seconds, text


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            lib.tts_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tts_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, argtypes: list, *args, device: torch.device,
           count: str | None = None) -> None:
    """Call C entry `name` (its last argument is a CUDA stream of `device`)
    with `device` current, and raise if the launch failed; count the launch
    under `count` (default `name`: a kernel's other C entries count under
    the kernel's name). The device is switched only where another is
    current."""
    lib = library()
    fn = getattr(lib, name)
    if name not in _declared:
        # ctypes would pass a bare Python int as a 32-bit int and cut a
        # pointer, so every entry is declared before its first call
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _declared.add(name)
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err:
        msg = lib.tts_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
    count_launch(count or name)


def count_launch(name: str, n: int = 1) -> None:
    """Add n to `name`'s count in LAUNCHES (from any thread), or to the
    calling thread's recorder while one is active."""
    rec = getattr(_local, "counts", None)
    if rec is not None:
        rec[name] += n
        return
    with _count_lock:
        LAUNCHES[name] += n


@contextlib.contextmanager
def recording():
    """Count the calling thread's launches into a fresh Counter, which the
    block receives, instead of LAUNCHES: a CUDA graph's warm-up (counted
    nowhere) and capture (whose counts its replays add). Other threads
    count as before."""
    prev = getattr(_local, "counts", None)
    _local.counts = counts = collections.Counter()
    try:
        yield counts
    finally:
        _local.counts = prev


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SM count of a card, as the kernels' host-side plans take it."""
    return torch.cuda.get_device_properties(device).multi_processor_count
