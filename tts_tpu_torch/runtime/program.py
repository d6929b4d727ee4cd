"""One program per shape bucket: the counterpart of tts_tpu's jitted
per-bucket programs (`runtime/f5.py`'s `_fn_cache` / `_get_fn` /
`_build_batch`, `runtime/vocoder.py`'s jitted forward).

On a card a `Program` captures its body into a CUDA graph at its first
call and replays the graph at every later one:
  * inputs: static buffers of the bucket's shapes, allocated outside the
    capture; each call copies its arguments into them on the current
    stream (host tensors through pinned memory, without a wait);
  * warm-up: the body runs on the capture stream before the capture, so
    first-call work (kernel attributes and SM counts, the STFT tables,
    cuBLAS's handles and workspace) happens outside it; its launches count
    nowhere;
  * capture: on the capture stream of the program's `GraphPool`, into its
    memory pool, which a pipeline's programs share (a server that sees many
    buckets holds about the largest graph's working memory, not their sum),
    in thread-local capture mode, so another thread's CUDA calls (a slot
    server's worker) do not break it; the launches the wrappers make are
    recorded (`_build.recording`), not counted;
  * replay: copy the inputs in, replay, clone the outputs (dispatches
    queued back to back never share an output buffer), and add the
    recorded launch counts through `_build.count_launch`, looked up at the
    call.
A capture or a replay that fails raises: nothing falls back to the eager
body. On the CPU the body runs eagerly on the arguments.

A program may carry state: tensors outside the pool that its body updates
in place (the Kani decode programs' KV cache, counters and stop flags,
runtime/kani.py). Its warm-up then runs on that state and puts it back as
it found it, so the first call advances the state once, as every later one.

A graph reads the weights' memory as it was at the capture. A pipeline keys
its programs to `weights_key` of the trees their bodies read and drops them
when the key changes (a weight replaced, moved or cast), so no replay reads
a tensor that is no longer the pipeline's.

A decode loop replays a step program until a stop flag that the program
sets on the device: `replay_ahead` queues each replay before the host
reads the flag (and the counts beside it) of the one before, through two
pinned slots (`HostSlots`), so the card does not wait for the host between
replays (the Kani and Qwen3-TTS decode programs).
"""
from __future__ import annotations

import dataclasses
import threading
import time

import torch

from ..ops import _build

__all__ = ["GraphPool", "HostSlots", "Program", "replay_ahead", "weights_key"]

# CUDA allows one stream capture at a time in a process
_capture_lock = threading.Lock()


def weights_key(*trees) -> tuple:
    """The identity of every tensor in `trees` (dicts, lists, tuples and
    dataclasses such as the quantized weights, down to tensors): its data
    pointer, shape and dtype, in order. Two calls give equal keys while
    no tensor was replaced, moved or cast."""
    out: list = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append((x.data_ptr(), x.shape, x.dtype))
        elif isinstance(x, dict):
            for k in x:
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    for tree in trees:
        walk(tree)
    return tuple(out)


class GraphPool:
    """The memory pool and capture stream that a pipeline's graphs share,
    made on the card at the first capture."""

    def __init__(self):
        self.handle = None
        self.stream = None
        self._lock = threading.Lock()

    def take(self, device: torch.device) -> tuple:
        """(pool handle, capture stream) on `device`."""
        with self._lock:
            if self.handle is None:
                self.handle = torch.cuda.graph_pool_handle()
                self.stream = torch.cuda.Stream(device)
            return self.handle, self.stream

    def nbytes(self) -> int:
        """Bytes the pool holds on the card (its segments in the caching
        allocator's snapshot)."""
        if self.handle is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self.handle))


class _Graph:
    """A CUDA graph captured on a pool's stream into its memory."""

    def __init__(self, device: torch.device, pool: GraphPool):
        self.device = device
        self.handle, self.stream = pool.take(device)
        # the graph's template is kept after instantiation, so its nodes and
        # edges can be read (`raw_cuda_graph`); capture() instantiates it
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)

    def warm_up(self, fn) -> None:
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            fn()
        cur.wait_stream(self.stream)
        torch.cuda.synchronize(self.device)

    def capture(self, fn) -> tuple:
        with torch.cuda.graph(self.graph, pool=self.handle, stream=self.stream,
                              capture_error_mode="thread_local"):
            outs = fn()
        self.graph.instantiate()
        return outs

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()


class Program:
    """body(*inputs) -> a tuple of tensors, for the inputs of one bucket:
    `inputs` lists each one's (shape, dtype). On a CUDA `device` the first
    call warms up and captures a graph into `pool`; every call replays it
    (see the module's docstring). On the CPU a call runs the body. `state`:
    the tensors the body updates in place, which its warm-up leaves as it
    found them.

    After the capture: `launches` holds the kernel launches a replay counts,
    `warmup_s` and `capture_s` the first call's seconds in each, and
    `pool_bytes` the pool's size."""

    def __init__(self, body, inputs: list, device, pool: GraphPool, state: tuple = ()):
        self.body = body
        self.state = tuple(state)
        self.specs = [(tuple(shape), dtype) for shape, dtype in inputs]
        self.device = torch.device(device)
        self.pool = pool
        self.launches: dict = {}
        self.warmup_s = self.capture_s = None
        self.pool_bytes = None
        self._graph = None
        self._static: list = []
        self._outs: tuple = ()
        self._lock = threading.Lock()

    def _coerce(self, args) -> list:
        if len(args) != len(self.specs):
            raise TypeError(f"the program takes {len(self.specs)} inputs, got {len(args)}")
        out = []
        for i, (a, (shape, dtype)) in enumerate(zip(args, self.specs)):
            a = torch.as_tensor(a)
            if tuple(a.shape) != shape:
                raise ValueError(f"input {i}: shape {tuple(a.shape)} is not the bucket's "
                                 f"{shape}")
            out.append(a.to(dtype) if a.device.type == "cpu" else a)
        return out

    @torch.no_grad()
    def __call__(self, *args) -> tuple:
        if self.device.type != "cuda":
            return self.body(*self._coerce(args))
        return self._replay(self._coerce(args))

    def _eager(self, *args) -> tuple:
        """The body on the arguments, moved to the device: the eager run a
        replay is compared with."""
        with torch.no_grad():
            return self.body(*[a.to(self.device, dtype) for a, (_, dtype)
                               in zip(self._coerce(args), self.specs)])

    def _load(self, args: list) -> None:
        for buf, a in zip(self._static, args):
            if a.device.type == "cpu" and buf.device.type == "cuda":
                a = a.pin_memory()
            buf.copy_(a, non_blocking=True)

    def _capture(self, args: list) -> None:
        t0 = time.perf_counter()
        self._static = [torch.empty(shape, dtype=dtype, device=self.device)
                        for shape, dtype in self.specs]
        self._load(args)
        graph = _Graph(self.device, self.pool)

        def run():
            return self.body(*self._static)

        kept = [t.clone() for t in self.state]
        with _build.recording():
            graph.warm_up(run)
        for t, k in zip(self.state, kept):
            t.copy_(k)
        del kept
        t1 = time.perf_counter()
        with _capture_lock, _build.recording() as counts:
            outs = graph.capture(run)
        self._outs = tuple(outs)
        self._graph = graph
        self.launches = dict(counts)
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1
        self.pool_bytes = self.pool.nbytes()

    def _replay(self, args: list) -> tuple:
        with self._lock:
            if self._graph is None:
                self._capture(args)
            else:
                self._load(args)
            self._graph.replay()
            outs = tuple(o.clone() for o in self._outs)
        for name, n in self.launches.items():
            _build.count_launch(name, n)
        return outs


class HostSlots:
    """Two host slots of a few small device tensors (a stop flag, a count):
    on a card each in pinned memory with an event after its copy. `post`
    queues a non-blocking copy into a slot; `read` waits for that copy alone
    (no .item(), which would wait for the whole stream)."""

    def __init__(self, like: tuple, device):
        card = torch.device(device).type == "cuda"
        self._slots = [[torch.zeros(t.shape, dtype=t.dtype, pin_memory=card) for t in like]
                       for _ in range(2)]
        self._events = [torch.cuda.Event() for _ in range(2)] if card else None

    def post(self, slot: int, tensors: tuple) -> None:
        for dst, src in zip(self._slots[slot], tensors):
            dst.copy_(src, non_blocking=self._events is not None)
        if self._events is not None:
            self._events[slot].record()

    def read(self, slot: int) -> list:
        """The slot's values as numpy arrays, once its copy is done."""
        if self._events is not None:
            self._events[slot].synchronize()
        return [t.numpy() for t in self._slots[slot]]


def replay_ahead(slots: HostSlots, first: tuple, step, most: int):
    """A decode loop's replays: yields the host values of `first` (the
    outputs of a prefill program), then of each of at most `most` calls of
    `step` (a step program's outputs), in order. Each call is queued before
    the host reads the values of the one before it, so after the caller
    stops reading (at its stop flag) one more call may have run."""
    slots.post(0, first)
    for r in range(most):
        slots.post((r + 1) % 2, step())
        yield slots.read(r % 2)
    yield slots.read(most % 2)
