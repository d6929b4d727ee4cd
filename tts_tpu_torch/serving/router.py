"""Least-loaded routing across per-device slot servers, with failover
(counterpart of tts_tpu/serving/router.py).

Each card owns ONE slot server (its pipeline's params on that card,
serving/devices.py), and a host-side router picks the least-loaded server
per request. Cards never communicate: TTS requests are independent, so
serving across cards is pure data parallelism with no collectives. Each
server's worker thread enqueues work on its own card, so N cards decode N
slot batches concurrently.

Failover: the router installs itself as each engine's `on_failure` hook.
When a server's worker crashes, its unfinished requests (live slots,
admission backlog, queue) are re-routed to surviving servers with their
ORIGINAL futures, so clients never see the crash (a replay from scratch
gives the same greedy output). Two cases fail instead of replaying:
streaming requests that already delivered audio (a replay would duplicate
chunks), and any request when no healthy server remains. A dead server is
excluded from routing; submits keep working while one server is healthy.
"""
from __future__ import annotations

import threading

import torch

from .slots import SlotEngine, StreamHandle, _set_exception

__all__ = ["SlotRouter"]


class SlotRouter:
    """Route submits to the least-loaded of several slot servers.

    servers: adapters of the same family (e.g. one KaniSlotServer per
    device). Exposes submit/stats/close mirroring a single server.
    """

    def __init__(self, servers: list[SlotEngine]):
        if not servers:
            raise ValueError("need at least one server")
        self.servers = list(servers)
        self._lock = threading.Lock()
        self._dead: list[SlotEngine] = []
        self._failovers = 0
        self._failover_requests = 0
        for srv in self.servers:
            srv.on_failure = self._failover

    @classmethod
    def for_devices(cls, make_server, devices) -> "SlotRouter":
        """make_server(torch.device) -> a slot server whose pipeline's
        params live on that device, e.g. over
        serving.devices.replicate_pipeline(pipe, device)."""
        return cls([make_server(torch.device(d)) for d in devices])

    # ---------------------------------------------------------- routing

    def _healthy(self) -> list[SlotEngine]:
        return [s for s in self.servers if s.healthy]

    def _pick(self) -> SlotEngine:
        healthy = self._healthy()
        if not healthy:
            raise RuntimeError("no healthy slot server remains")
        return min(healthy, key=lambda s: s.in_flight)

    def submit(self, *args, deadline_s: float | None = None, **kwargs):
        return self._pick().submit(*args, deadline_s=deadline_s, **kwargs)

    def submit_stream(self, *args, **kwargs):
        return self._pick().submit_stream(*args, **kwargs)

    # --------------------------------------------------------- failover

    def _failover(self, server: SlotEngine, exc: BaseException,
                  items: list) -> None:
        """Engine on_failure hook (runs on the dying worker thread):
        re-route every unfinished request to surviving servers."""
        with self._lock:
            if server not in self._dead:
                self._dead.append(server)
            self._failovers += 1
        for req in items:
            handle = self._stream_handle_of(req.payload)
            if handle is not None and handle.emitted:
                # audio already left the building: a replay would emit
                # duplicate chunks — fail loudly instead
                _set_exception(req.fut, RuntimeError(
                    "server failed mid-stream after audio was delivered; "
                    "cannot replay without duplication"))
                continue
            try:
                target = self._pick()
            except RuntimeError:
                _set_exception(req.fut, exc)
                continue
            try:
                target._enqueue(req)       # original future travels along
                with self._lock:
                    self._failover_requests += 1
            except Exception:
                _set_exception(req.fut, exc)

    @staticmethod
    def _stream_handle_of(payload) -> StreamHandle | None:
        if isinstance(payload, tuple):
            for part in payload:
                if isinstance(part, StreamHandle):
                    return part
                if isinstance(part, tuple):
                    for sub in part:
                        if isinstance(sub, StreamHandle):
                            return sub
        return None

    # ------------------------------------------------------------ stats

    @property
    def in_flight(self) -> int:
        return sum(s.in_flight for s in self.servers)

    def stats(self) -> dict:
        per = [s.stats.snapshot() for s in self.servers]
        agg = {
            "servers": len(per),
            "healthy_servers": len(self._healthy()),
            "failovers": self._failovers,
            "failover_requests": self._failover_requests,
            "requests": sum(p["requests"] for p in per),
            "completed": sum(p["completed"] for p in per),
            "admissions_mid_decode": sum(p["admissions_mid_decode"]
                                         for p in per),
            "per_server": per,
        }
        return agg

    def close(self, timeout: float = 60.0) -> None:
        for s in self.servers:
            s.close(timeout=timeout)
