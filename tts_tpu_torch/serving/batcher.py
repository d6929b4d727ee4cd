"""Dynamic micro-batching for the batched synthesis entry points
(counterpart of tts_tpu/serving/batcher.py).

A single worker thread owns the device: it blocks on the first queued
request, then admits whatever else arrives within `max_wait_ms` (up to
`max_batch`), rounds the group up to the next size in `batch_sizes` with
`pad_request` fillers (their outputs are dropped; a fixed size ladder
bounds the shapes the batched programs see), and runs `batch_fn` on the
combined list. Results resolve per-request futures; exceptions propagate
to every request in the failed batch.

This is admission-time grouping, not mid-decode continuous batching: a
request that arrives while a batch decodes waits for the whole batch (the
slot servers, serving/slots.py, admit mid-decode instead).
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

__all__ = ["MicroBatcher", "BatchStats"]


@dataclass
class BatchStats:
    """Aggregate serving counters (all monotonically increasing)."""

    requests: int = 0
    batches: int = 0
    padded_rows: int = 0
    failures: int = 0
    total_queue_s: float = 0.0      # admission -> batch start
    total_batch_s: float = 0.0      # batch_fn wall
    # occupancy as a running sum (not a per-batch list): long-lived
    # servers must not grow memory per batch
    occupancy_sum: int = 0          # live rows summed over batches

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.batches, 1)

    def snapshot(self) -> dict:
        return {
            "requests": self.requests,
            "batches": self.batches,
            "padded_rows": self.padded_rows,
            "failures": self.failures,
            "mean_occupancy": round(self.mean_occupancy, 3),
            "mean_queue_ms": round(
                1e3 * self.total_queue_s / max(self.requests, 1), 3),
            "mean_batch_ms": round(
                1e3 * self.total_batch_s / max(self.batches, 1), 3),
        }


class MicroBatcher:
    """batch_fn: list[request] -> list[result] (one result per request,
    order-preserving). pad_request: filler request used to round the
    batch up to a ladder size; required when batch_sizes are used."""

    _SHUTDOWN = object()

    def __init__(self, batch_fn, *, max_batch: int = 8,
                 max_wait_ms: float = 10.0,
                 batch_sizes: tuple[int, ...] = (1, 2, 4, 8),
                 pad_request=None, queue_limit: int = 256):
        if batch_sizes:
            sizes = sorted(batch_sizes)
            if max_batch not in sizes:
                raise ValueError(f"max_batch {max_batch} not in ladder "
                                 f"{sizes}")
            if sizes[-1] > max_batch:
                raise ValueError("ladder exceeds max_batch")
            if sizes != [1] and pad_request is None:
                raise ValueError("pad_request required with a size ladder")
        self._batch_fn = batch_fn
        self._max_batch = max_batch
        self._max_wait_s = max_wait_ms / 1e3
        self._sizes = tuple(sorted(batch_sizes)) if batch_sizes else ()
        self._pad_request = pad_request
        self._q: queue.Queue = queue.Queue(maxsize=queue_limit)
        self.stats = BatchStats()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="tts-microbatcher")
        self._worker.start()

    # ------------------------------------------------------------- client

    def submit(self, request) -> Future:
        """Enqueue one request; the Future resolves to batch_fn's result
        row. Raises queue.Full under backpressure; RuntimeError after
        close()."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        fut: Future = Future()
        self._q.put((request, fut, time.perf_counter()), timeout=5.0)
        return fut

    def close(self, timeout: float = 30.0) -> None:
        """Drain outstanding work and stop the worker; any request that
        raced past the shutdown sentinel is cancelled."""
        if not self._closed:
            self._closed = True
            self._q.put(self._SHUTDOWN)
            self._worker.join(timeout=timeout)
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not self._SHUTDOWN:
                    item[1].cancel()

    # ------------------------------------------------------------- worker

    def _round_up(self, n: int) -> int:
        for s in self._sizes:
            if s >= n:
                return s
        return n

    def _run(self) -> None:
        while True:
            head = self._q.get()
            if head is self._SHUTDOWN:
                return
            group = [head]
            deadline = time.perf_counter() + self._max_wait_s
            shutdown = False
            while len(group) < self._max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is self._SHUTDOWN:
                    shutdown = True
                    break
                group.append(item)

            start = time.perf_counter()
            reqs = [g[0] for g in group]
            live = len(reqs)
            target = self._round_up(live)
            reqs = reqs + [self._pad_request] * (target - live)
            try:
                results = self._batch_fn(reqs)
                if len(results) < live:
                    raise RuntimeError(
                        f"batch_fn returned {len(results)} results for "
                        f"{live} live requests")
            except Exception as e:  # propagate to every caller in the batch
                self.stats.failures += live
                for _, fut, _ in group:
                    fut.set_exception(e)
            else:
                wall = time.perf_counter() - start
                self.stats.batches += 1
                self.stats.requests += live
                self.stats.padded_rows += target - live
                self.stats.total_batch_s += wall
                self.stats.occupancy_sum += live
                for (_, fut, t_in), res in zip(group, results):
                    self.stats.total_queue_s += start - t_in
                    fut.set_result(res)
            if shutdown:
                return
