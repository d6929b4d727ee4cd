"""Generic slot-based continuous-batching engine (counterpart of
tts_tpu/serving/slots.py).

A FIXED batch of B slots decodes in bounded CHUNKS (a Python loop of
`chunk` steps over device tensors, with no host read inside); between
chunks the engine

  1. harvests finished rows (one host read of the (fin, done) flags; the
     subclass finalizes each finished row on the device) and resolves
     their futures,
  2. expires rows whose deadline passed and rows whose future was
     cancelled (the slot is released via _kill_row and keeps serving),
  3. admits queued requests into free slots (the subclass runs a one-row
     offset prefill written in place into the batch's row),

so a request admitted mid-decode starts on the next chunk boundary and
finishes on its own schedule instead of waiting for the whole batch (the
MicroBatcher's admission-time trade, serving/batcher.py).

Shared-position invariant: all rows share ONE kv position counter (the
caches' `length`, a host int), so the KV append stays one write a layer,
and each row masks its dead prefix with a per-row first-valid-key index.
That is sound for every family here because their decode attention is
either rope-relative (Kani, Qwen, VoxCPM: an absolute shift cancels) or
position-free (the IndexTTS GPT-2: positions come from learned tables
added to the inputs). The shared counter grows monotonically; when the
next admission cannot fit before `seq_limit` the engine DRAINS (live rows
finish, the state resets fresh).

Per-request robustness:
  * submit(..., deadline_s=T) bounds queue wait + decode; expiry fails the
    future with TimeoutError and frees the slot at the next chunk boundary
    (queued requests expire without ever occupying a slot).
  * future.cancel() is honoured at the same boundaries: a queued request
    is dropped; a live one has its row killed. The row is marked finished
    and its slot state is overwritten by the next admission.
  * a crashed worker fails every waiter, UNLESS an `on_failure` callback
    is installed (SlotRouter installs one): then the unfinished requests
    are handed over, with their original futures, for re-routing.

The worker thread makes the engine's device current when it starts (the
current CUDA device is per thread) and runs with autograd off.

Subclasses implement the family-specific steps:
  _fresh()                 -> state dict (device tensors + host arrays);
                              every adapter keeps (slots,) device tensors
                              "fin" (bool, True = inert row) and "done"
  _finalize(s, slot, n)    -> result for the resolved future
  _admit_row(s, slot, payload, cap) -> prefill + in-place splice
  _step_chunk(s)           -> run one chunk over the state
  _kill_row(s, slot)       -> optional; default sets s["fin"][slot]
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field

import torch

__all__ = ["SlotEngine", "SlotStats", "StreamHandle"]


@dataclass
class SlotStats:
    requests: int = 0
    completed: int = 0
    chunks: int = 0
    drains: int = 0
    admissions_mid_decode: int = 0
    cancelled: int = 0
    deadline_expired: int = 0
    latencies_s: list = field(default_factory=list)   # submit -> complete

    def snapshot(self) -> dict:
        lat = sorted(self.latencies_s)

        def pct(p):
            if not lat:
                return 0.0
            return round(lat[min(int(p * len(lat)), len(lat) - 1)] * 1e3, 1)

        return {"requests": self.requests, "completed": self.completed,
                "chunks": self.chunks, "drains": self.drains,
                "admissions_mid_decode": self.admissions_mid_decode,
                "cancelled": self.cancelled,
                "deadline_expired": self.deadline_expired,
                "p50_ms": pct(0.50), "p99_ms": pct(0.99)}


@dataclass
class _Req:
    """One request, from submission to resolution. Travels intact through
    queue -> pending -> slot (and across servers on router failover)."""

    payload: object
    cap: int
    fut: Future
    t_submit: float
    deadline: float | None = None     # absolute perf_counter time

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


def _set_result(fut: Future, result) -> bool:
    try:
        fut.set_result(result)
        return True
    except InvalidStateError:         # racing client-side cancel
        return False


def _set_exception(fut: Future, exc: BaseException) -> bool:
    try:
        fut.set_exception(exc)
        return True
    except InvalidStateError:
        return False


def stream_failure_hook(fut: Future, handle: "StreamHandle") -> None:
    """A worker-side failure (or close()'s cancellation) must unblock the
    stream's consumer, not just the future."""
    fut.add_done_callback(
        lambda f: handle._fail(f.exception() or RuntimeError("request cancelled"))
        if (f.cancelled() or f.exception()) else None)


class StreamHandle:
    """Blocking iterator over a streaming request's audio chunks.

    The serving worker pushes int16 chunks as chunk boundaries produce
    them; iteration ends when the request completes (or errors: the
    exception re-raises in the consumer)."""

    _DONE = object()

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self.n_frames: int | None = None      # set when the stream ends
        self.emitted = False                  # any audio chunk delivered?

    def _put(self, chunk) -> None:
        self.emitted = True
        self._q.put(chunk)

    def _close(self, n_frames: int) -> None:
        self.n_frames = n_frames
        self._q.put(self._DONE)

    def _fail(self, exc: BaseException) -> None:
        self._q.put(exc)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item


class SlotEngine:
    """Base continuous-batching worker. A subclass __init__ sets up its
    state, then calls super().__init__ (which starts the worker thread)."""

    def __init__(self, *, slots: int, chunk: int, seq_limit: int,
                 start_pos: int, queue_limit: int = 256,
                 name: str = "slot-server", device=None):
        self.slots = slots
        self.chunk = chunk
        self.seq_limit = seq_limit
        self.start_pos = start_pos
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=queue_limit)
        self._pending: collections.deque = collections.deque()
        self.stats = SlotStats()
        self._lock = threading.Lock()
        self._closed = False
        # router failover hook: on worker crash, called with
        # (engine, exc, unfinished _Req list) INSTEAD of failing them
        self.on_failure = None
        self.failure: BaseException | None = None
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._worker.start()

    # ------------------------------------------------ subclass interface

    def _fresh(self) -> dict:
        raise NotImplementedError

    def _finalize(self, s, slot: int, n: int):
        raise NotImplementedError

    def _admit_row(self, s, slot: int, payload, cap: int) -> None:
        raise NotImplementedError

    def _step_chunk(self, s) -> None:
        raise NotImplementedError

    def _fin_done(self, s):
        """(fin, done) as host arrays of shape (slots,): the engine's one
        host read a chunk."""
        both = torch.stack([s["fin"].to(torch.int32), s["done"].to(torch.int32)]).cpu()
        both = both.numpy()
        return both[0].astype(bool), both[1]

    def _post_chunk(self, s) -> None:
        """Optional hook after each chunk (before the next harvest):
        adapters emit partial results for streaming requests here."""

    def _kill_row(self, s, slot: int) -> None:
        """Release a live row (deadline/cancel): mark it inert so the chunk
        stops advancing it and the slot becomes free. The next admission
        overwrites the row's state."""
        s["fin"][slot] = True
        if "stream" in s:
            s["stream"][slot] = None

    # ------------------------------------------------------------- client

    @property
    def healthy(self) -> bool:
        """Worker alive and accepting requests."""
        return not self._closed and self._worker.is_alive()

    @property
    def in_flight(self) -> int:
        """Requests submitted but not yet completed (queue + live slots)."""
        with self._lock:
            return self.stats.requests - self.stats.completed

    def _submit(self, payload, cap: int,
                deadline_s: float | None = None) -> Future:
        if self._closed:
            raise RuntimeError(f"{type(self).__name__} is closed")
        now = time.perf_counter()
        req = _Req(payload, cap, Future(), now,
                   None if deadline_s is None else now + deadline_s)
        self._enqueue(req)
        return req.fut

    def _enqueue(self, req: _Req) -> None:
        """Queue a request (fresh or re-routed by a failover callback)."""
        if self._closed:
            raise RuntimeError(f"{type(self).__name__} is closed")
        self._q.put(req, timeout=5.0)
        with self._lock:
            self.stats.requests += 1

    def close(self, timeout: float = 60.0) -> None:
        self._closed = True
        self._worker.join(timeout=timeout)
        for req in self._pending:
            req.fut.cancel()
        while True:
            try:
                self._q.get_nowait().fut.cancel()
            except queue.Empty:
                break

    # ------------------------------------------------------------- worker

    def _fresh_base(self) -> dict:
        s = self._fresh()
        s["pos"] = self.start_pos      # shared kv position counter
        s["reqs"] = [None] * self.slots   # _Req per slot
        return s

    def _harvest(self, s) -> None:
        if not any(r is not None for r in s["reqs"]):
            return
        fin, done = self._fin_done(s)
        for b in range(self.slots):
            req = s["reqs"][b]
            if req is not None and fin[b]:
                try:
                    result = self._finalize(s, b, int(done[b]))
                except Exception as e:
                    # finalize touches only this row: fail this request,
                    # keep the batch serving
                    _set_exception(req.fut, e)
                else:
                    _set_result(req.fut, result)
                s["reqs"][b] = None
                with self._lock:
                    self.stats.completed += 1
                    self.stats.latencies_s.append(
                        time.perf_counter() - req.t_submit)

    def _expire(self, s) -> None:
        """Deadline + cancellation sweep (chunk-boundary granularity)."""
        now = time.perf_counter()
        for b in range(self.slots):
            req = s["reqs"][b]
            if req is None:
                continue
            if req.fut.cancelled():
                self._kill_row(s, b)
                s["reqs"][b] = None
                with self._lock:
                    self.stats.completed += 1
                    self.stats.cancelled += 1
            elif req.expired(now):
                self._kill_row(s, b)
                s["reqs"][b] = None
                _set_exception(req.fut, TimeoutError(
                    f"request deadline exceeded after "
                    f"{now - req.t_submit:.2f}s (mid-decode)"))
                with self._lock:
                    self.stats.completed += 1
                    self.stats.deadline_expired += 1
        kept = collections.deque()
        while self._pending:
            req = self._pending.popleft()
            if req.fut.cancelled():
                with self._lock:
                    self.stats.completed += 1
                    self.stats.cancelled += 1
            elif req.expired(now):
                _set_exception(req.fut, TimeoutError(
                    f"request deadline exceeded after "
                    f"{now - req.t_submit:.2f}s (queued, never admitted)"))
                with self._lock:
                    self.stats.completed += 1
                    self.stats.deadline_expired += 1
            else:
                kept.append(req)
        self._pending = kept

    def _admit(self, s) -> None:
        while True:
            try:
                self._pending.append(self._q.get_nowait())
            except queue.Empty:
                break
        live_any = any(r is not None for r in s["reqs"])
        # drain complete: nothing live and the next admission won't fit
        if (self._pending and not live_any
                and s["pos"] + self._pending[0].cap + self.chunk
                > self.seq_limit):
            with self._lock:
                self.stats.drains += 1
            s.update(self._fresh_base())
        while self._pending:
            free = next((b for b in range(self.slots)
                         if s["reqs"][b] is None), None)
            if free is None:
                break
            req = self._pending[0]
            if s["pos"] + req.cap + self.chunk > self.seq_limit:
                break                  # no headroom: drain in progress
            self._pending.popleft()
            mid_decode = any(r is not None for r in s["reqs"])
            try:
                self._admit_row(s, free, req.payload, req.cap)
            except BaseException:
                # the worker dies with it: keep the request among the
                # unfinished ones, so it is failed or re-routed, not lost
                self._pending.appendleft(req)
                raise
            s["reqs"][free] = req
            if mid_decode:
                with self._lock:
                    self.stats.admissions_mid_decode += 1

    def _unfinished(self, s) -> list:
        """Every request not yet resolved: live slots, backlog, queue."""
        items = [r for r in s["reqs"] if r is not None]
        items.extend(self._pending)
        self._pending.clear()
        while True:
            try:
                items.append(self._q.get_nowait())
            except queue.Empty:
                break
        return [r for r in items if not r.fut.done()]

    def _run(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        s = {"reqs": [None] * self.slots}
        try:
            with torch.no_grad():
                s = self._fresh_base()
                while not self._closed:
                    self._harvest(s)
                    self._expire(s)
                    self._admit(s)
                    if not any(r is not None for r in s["reqs"]):
                        time.sleep(0.001)
                        continue
                    self._step_chunk(s)
                    s["pos"] += self.chunk
                    self._post_chunk(s)
                    with self._lock:
                        self.stats.chunks += 1
        except BaseException as e:
            # a worker failure must FAIL every waiter, not strand them:
            # live slots, the admission backlog, and anything still queued.
            # With an on_failure hook installed (router failover), the
            # unfinished requests are handed over for re-routing instead.
            self._closed = True
            self.failure = e
            items = self._unfinished(s)
            handled = False
            if self.on_failure is not None:
                try:
                    self.on_failure(self, e, items)
                    handled = True
                except Exception:
                    handled = False
            if not handled:
                for req in items:
                    _set_exception(req.fut, e)
            raise
        for r in s["reqs"]:          # closed mid-decode: unblock waiters
            if r is not None:
                r.fut.cancel()


def row_penalty(logits: torch.Tensor, save: torch.Tensor, cnt: torch.Tensor,
                penalty: float, penalty_range: int) -> torch.Tensor:
    """Per-row repetition penalty: each row's window [cnt - R, cnt) over its
    own history ends at its OWN cursor (rows start at different shared
    steps, so decoding/sampling.apply_repetition_penalty, which takes one
    cursor for all rows, does not apply); it engages once the window is
    full. An id repeated in the window is scaled once. logits (B, V); save
    (B, buf) ids; cnt (B,)."""
    r = min(penalty_range, save.shape[1])
    offs = torch.arange(r, device=logits.device)[None, :]
    start = torch.clamp(cnt - r, min=0)[:, None]
    idx = torch.clamp(start + offs, max=save.shape[1] - 1)
    window = save.gather(1, idx.long()).long()                # (B, R)
    vals = logits.gather(1, window)
    vals = torch.where((cnt >= r)[:, None], vals * penalty, vals)
    return logits.scatter(1, window, vals)

