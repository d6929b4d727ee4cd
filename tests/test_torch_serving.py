"""The port's serving engine (tts_tpu_torch/serving: slots, batcher,
router, server) and runtime/streaming.py on the CPU, with no model: a toy
slot server whose rows count one step a token up to their caps exercises

  * SlotEngine: mid-decode admission, the drain at seq_limit, deadline
    expiry (queued and live), cancel of a queued and a live row, a crashed
    worker failing its waiters;
  * MicroBatcher occupancy and padding;
  * SlotRouter least-loaded routing, and failover replaying a crashed
    server's requests on a survivor with their original futures;
  * serve_http over a loopback port (WAV, stream, stats);
  * server.py's two deadline rules: a bound method's capability is read
    once, a **kwargs-only callable is not deadline-capable;
  * ChunkedCodecStream: tts_tpu's output, with each window's decode
    launched before the previous window's host copy.

Every Future.result takes a timeout and every server closes in `finally`.
"""
import http.client
import inspect
import io
import json
import threading
import time
import wave
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from tts_tpu_torch.runtime.streaming import ChunkedCodecStream
from tts_tpu_torch.serving import server as srv_mod
from tts_tpu_torch.serving.batcher import MicroBatcher
from tts_tpu_torch.serving.router import SlotRouter
from tts_tpu_torch.serving.server import TTSServer, _accepts_deadline, serve_http
from tts_tpu_torch.serving.slots import SlotEngine, StreamHandle, stream_failure_hook

T = 60          # every Future.result bound, seconds


class Toy(SlotEngine):
    """Rows count one a step; a row finishes at its cap. The result is
    (int16 wav of the payload's value repeated n times, n, the shared
    position the row was admitted at, this server's name)."""

    def __init__(self, slots=2, chunk=2, seq_limit=10**9, delay=0.0, fail_on=None,
                 name="toy"):
        self._slots, self.delay, self.fail_on, self.tag = slots, delay, fail_on, name
        self.admitted_at = []
        super().__init__(slots=slots, chunk=chunk, seq_limit=seq_limit, start_pos=0,
                         name=name)

    def submit(self, value, cap=4, deadline_s=None):
        return self._submit(value, cap, deadline_s=deadline_s)

    def submit_stream(self, value, cap=4):
        handle = StreamHandle()
        fut = self._submit(("stream", value, handle), cap)
        stream_failure_hook(fut, handle)
        return handle

    def _fresh(self):
        z = torch.zeros((self._slots,), dtype=torch.int32)
        return {"cnt": z.clone(), "done": z.clone(), "cap": z.clone(),
                "fin": torch.ones((self._slots,), dtype=torch.bool),
                "payload": [None] * self._slots, "at": [0] * self._slots}

    def _admit_row(self, s, b, payload, cap):
        if payload == self.fail_on:
            raise RuntimeError(f"{self.tag} failed on {payload!r}")
        s["cnt"][b], s["done"][b], s["cap"][b], s["fin"][b] = 0, cap, cap, False
        s["payload"][b], s["at"][b] = payload, s["pos"]
        self.admitted_at.append(s["pos"])

    def _step_chunk(self, s):
        time.sleep(self.delay)
        for _ in range(self.chunk):
            fin, cnt = s["fin"], s["cnt"]
            newly = (cnt + 1 >= s["cap"]) & ~fin
            s["done"] = torch.where(newly, cnt + 1, s["done"])
            s["cnt"] = torch.where(fin, cnt, cnt + 1)
            s["fin"] = fin | newly

    def _finalize(self, s, b, n):
        p = s["payload"][b]
        if isinstance(p, tuple):                 # a stream: its chunks, then the end
            handle = p[2]
            for i in range(n):
                handle._put(np.full(3, p[1] + i, np.int16))
            handle._close(n)
            return None, n
        return np.full(n, p if isinstance(p, int) else -1, np.int16), n, s["at"][b], self.tag


def _hold(srv):
    """Hold the worker after its first chunk until `go` is set."""
    first, go = threading.Event(), threading.Event()
    real = srv._post_chunk

    def post(s):
        real(s)
        if not first.is_set():
            first.set()
            go.wait(T)

    srv._post_chunk = post
    return first, go


def _until(cond, timeout=T):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never became true"
        time.sleep(0.005)


# ------------------------------------------------------------ SlotEngine

def test_mid_decode_admission_overtakes():
    """B, queued while A decodes, is admitted at the next chunk boundary
    and finishes on its own schedule, long before A."""
    srv = Toy(slots=2, chunk=2)
    first, go = _hold(srv)
    try:
        fut_a = srv.submit(7, cap=40)
        assert first.wait(T)
        fut_b = srv.submit(9, cap=3)
        go.set()
        wav_b, n_b, at_b, _ = fut_b.result(timeout=T)
        assert not fut_a.done()
        wav_a, n_a, at_a, _ = fut_a.result(timeout=T)
        assert (n_a, n_b, at_a, at_b) == (40, 3, 0, 2)
        assert wav_b.tolist() == [9, 9, 9] and len(wav_a) == 40
        snap = srv.stats.snapshot()
        assert snap["admissions_mid_decode"] == 1 and snap["completed"] == 2
        assert snap["p50_ms"] > 0
    finally:
        go.set()
        srv.close()


def test_drain_at_seq_limit_then_serves_on():
    """When the next admission cannot fit before seq_limit the engine lets
    the live rows finish, resets to the start position and keeps serving."""
    srv = Toy(slots=1, chunk=2, seq_limit=20)
    try:
        futs = [srv.submit(i, cap=6) for i in range(6)]
        outs = [f.result(timeout=T) for f in futs]
    finally:
        srv.close()
    assert [o[1] for o in outs] == [6] * 6
    assert srv.stats.drains >= 1
    # admissions advance the shared position by whole chunks, then restart at 0
    assert srv.admitted_at[:3] == [0, 6, 12] and srv.admitted_at[3] == 0
    assert all(p + 6 + 2 <= 20 for p in srv.admitted_at)


def test_deadlines_expire_queued_and_live_rows():
    srv = Toy(slots=1, chunk=1, delay=0.01)
    try:
        live = srv.submit(1, cap=10_000, deadline_s=2.0)
        _until(lambda: srv.stats.chunks >= 1)
        queued = srv.submit(2, cap=4, deadline_s=0.05)
        with pytest.raises(TimeoutError, match="queued"):
            queued.result(timeout=T)
        with pytest.raises(TimeoutError, match="mid-decode"):
            live.result(timeout=T)
        # the freed slot serves the next request
        assert srv.submit(3, cap=4).result(timeout=T)[1] == 4
    finally:
        srv.close()
    snap = srv.stats.snapshot()
    assert snap["deadline_expired"] == 2 and snap["completed"] == 3


def test_cancel_queued_and_live_rows():
    srv = Toy(slots=1, chunk=1, delay=0.01)
    try:
        live = srv.submit(1, cap=10_000)
        _until(lambda: srv.stats.chunks >= 1)
        queued = srv.submit(2, cap=4)
        assert queued.cancel() and live.cancel()
        _until(lambda: srv.stats.cancelled == 2)
        assert srv.submit(3, cap=5).result(timeout=T)[1] == 5
    finally:
        srv.close()
    assert srv.stats.snapshot()["completed"] == 3


def test_crashed_worker_fails_every_waiter():
    srv = Toy(slots=1, chunk=1, delay=0.01, fail_on="boom")
    try:
        a = srv.submit(1, cap=10_000)
        _until(lambda: srv.stats.chunks >= 1)
        b, c = srv.submit("boom", cap=2), srv.submit(3, cap=2)
        a.cancel()             # frees the slot, so "boom" is admitted next
        for f in (b, c):
            with pytest.raises(RuntimeError, match="toy failed on 'boom'"):
                f.result(timeout=T)
        _until(lambda: not srv.healthy)
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(4)
    finally:
        srv.close()


# ------------------------------------------------------------ MicroBatcher

def test_batcher_occupancy_and_padding():
    seen = []
    gate = threading.Event()

    def batch_fn(reqs):
        gate.wait(T)
        seen.append(list(reqs))
        return [r * 10 for r in reqs]

    mb = MicroBatcher(batch_fn, max_batch=4, max_wait_ms=200, batch_sizes=(1, 2, 4),
                      pad_request=-1)
    try:
        futs = [mb.submit(i) for i in (1, 2, 3)]
        gate.set()
        assert [f.result(timeout=T) for f in futs] == [10, 20, 30]
    finally:
        mb.close()
    assert seen == [[1, 2, 3, -1]]
    snap = mb.stats.snapshot()
    assert (snap["batches"], snap["requests"], snap["padded_rows"]) == (1, 3, 1)
    assert snap["mean_occupancy"] == 3.0


def test_batcher_error_reaches_every_request_and_ladder_checks():
    def batch_fn(reqs):
        raise ValueError("bad batch")

    mb = MicroBatcher(batch_fn, max_batch=2, max_wait_ms=50, batch_sizes=(1, 2),
                      pad_request=0)
    try:
        futs = [mb.submit(i) for i in (1, 2)]
        for f in futs:
            with pytest.raises(ValueError, match="bad batch"):
                f.result(timeout=T)
    finally:
        mb.close()
    assert mb.stats.failures == 2
    with pytest.raises(ValueError, match="pad_request"):
        MicroBatcher(batch_fn, max_batch=2, batch_sizes=(1, 2))


# ------------------------------------------------------------ SlotRouter

def test_router_routes_to_the_least_loaded_server():
    a, b = Toy(name="a"), Toy(name="b")
    hold_a = _hold(a)
    router = SlotRouter([a, b])
    try:
        f1 = a.submit(1, cap=50)                  # a: busy
        assert hold_a[0].wait(T)
        f2 = router.submit(2, cap=3)              # least loaded: b
        assert f2.result(timeout=T)[3] == "b"
        f3 = router.submit(3, cap=3, deadline_s=30.0)
        assert f3.result(timeout=T)[3] == "b"
        hold_a[1].set()
        assert f1.result(timeout=T)[3] == "a"
        st = router.stats()
        assert (st["servers"], st["healthy_servers"], st["completed"]) == (2, 2, 3)
    finally:
        hold_a[1].set()
        router.close()


def test_router_failover_replays_with_the_original_futures():
    """a's worker dies admitting "boom"; its live row and the request it
    died on replay on b with their original futures."""
    a = Toy(name="a", chunk=1, delay=0.01, fail_on="boom")
    b = Toy(name="b", chunk=1, delay=0.01)
    router = SlotRouter([a, b])
    long_b = b.submit(0, cap=10_000)               # b as loaded as a: a is picked
    try:
        x = a.submit(5, cap=30)
        _until(lambda: a.stats.chunks >= 1)
        boom = router.submit("boom", cap=2)
        wav, n, _, where = x.result(timeout=T)
        assert (n, where) == (30, "b") and wav.tolist() == [5] * 30
        wav, n, _, where = boom.result(timeout=T)
        assert (n, where) == (2, "b")
        assert isinstance(a.failure, RuntimeError) and not a.healthy
        assert router.submit(6, cap=2).result(timeout=T)[3] == "b"
        st = router.stats()
        assert (st["failovers"], st["healthy_servers"], st["failover_requests"]) == (1, 1, 2)
    finally:
        long_b.cancel()
        router.close()


# ------------------------------------------------------------ HTTP

def test_serve_http_over_loopback():
    slot = Toy(chunk=2)
    tts = TTSServer.continuous(slot, sample_rate=8000,
                               request_from_json=lambda body: int(body["value"]),
                               stream_fn=lambda v: slot.submit_stream(v, cap=3))
    httpd = serve_http(tts, port=0)
    try:
        conn = http.client.HTTPConnection(*httpd.server_address, timeout=T)
        conn.request("POST", "/synthesize", json.dumps({"value": 4}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("Content-Type") == "audio/wav"
        with wave.open(io.BytesIO(resp.read())) as w:
            assert (w.getframerate(), w.getsampwidth(), w.getnchannels()) == (8000, 2, 1)
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        assert pcm.tolist() == [4] * 4

        conn.request("POST", "/stream", json.dumps({"value": 20}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("X-TTFA-MS") is not None
        pcm = np.frombuffer(resp.read(), np.int16)
        assert pcm.tolist() == [20] * 3 + [21] * 3 + [22] * 3

        conn.request("GET", "/stats")
        st = json.loads(conn.getresponse().read())
        assert st["completed"] == 2 and st["streams"] == 1
        conn.request("GET", "/nope")
        assert conn.getresponse().status == 404
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        tts.close()


# ------------------------------------------------------------ server.py's rules

def test_bound_method_capability_is_read_once(monkeypatch):
    """tts_tpu re-reads a bound method's signature on every submit (it cannot
    cache on the method); the port reads it once, at binding."""
    calls = []
    real = inspect.signature

    def counting(fn, *a, **k):
        calls.append(fn)
        return real(fn, *a, **k)

    monkeypatch.setattr(srv_mod.inspect, "signature", counting)

    class Fresh(Toy):
        def submit(self, value, cap=4, deadline_s=None):
            return super().submit(value, cap, deadline_s)

    slot = Fresh()
    try:
        tts = TTSServer.continuous(slot, sample_rate=8000)
        for v in (1, 2, 3):
            assert tts.submit(v, deadline_s=30.0).result(timeout=T)[1] == 4
        assert len(calls) == 1
        # the answer is cached on the function: another binding reads no signature
        assert _accepts_deadline(Fresh.submit.__get__(slot)) and len(calls) == 1
    finally:
        slot.close()


def test_kwargs_only_callable_is_not_deadline_capable():
    got = []

    def submit_any(request, **kw):
        got.append(kw)
        f = Future()
        f.set_result((np.zeros(2, np.int16), 2))
        return f

    def submit_named(request, deadline_s=None):
        got.append({"deadline_s": deadline_s})
        return submit_any(request)

    assert not _accepts_deadline(submit_any)
    assert _accepts_deadline(submit_named)
    assert not _accepts_deadline(lambda request, *args: None)

    class Holder:
        stats = None

        def close(self):
            pass

    tts = TTSServer.continuous(Holder(), sample_rate=8000, submit=submit_any)
    tts.submit(1, deadline_s=5.0)
    assert got[-1] == {}                       # not passed to a bare **kwargs
    tts = TTSServer.continuous(Holder(), sample_rate=8000, submit=submit_named)
    tts.submit(1, deadline_s=5.0)
    assert got[-2] == {"deadline_s": 5.0}


# ------------------------------------------------------------ streaming

class _Dev:
    """A 'device' result whose host copy is logged."""

    def __init__(self, wav, log, k):
        self.wav, self.log, self.k = wav, log, k

    def cpu(self):
        self.log.append(("copy", self.k))
        return torch.from_numpy(self.wav)


@pytest.mark.parametrize("window,left,pushes", [(6, 2, [3, 5, 4, 1, 7]), (4, 0, [4, 4, 2]),
                                                (5, 4, [1, 1, 1, 2, 6])])
def test_chunked_codec_stream_matches_tts_tpu(window, left, pushes):
    from tts_tpu.runtime.streaming import ChunkedCodecStream as JaxStream

    up, g = 3, 2
    rng = np.random.default_rng(window * 10 + left)
    frames = rng.integers(0, 50, (sum(pushes), g))

    def decode(codes):                 # (1, W, G) -> (1, W * up): a causal toy codec
        c = codes[0].astype(np.int64)
        return np.repeat(np.cumsum(c[:, 0] * 7 + c[:, 1]), up)[None].astype(np.int16)

    log = []
    calls = []

    def dev_decode(codes):
        calls.append(len(calls))
        log.append(("decode", calls[-1]))
        return _Dev(decode(codes), log, calls[-1])

    ref_s, got_s = JaxStream(decode, window, left, up, g), \
        ChunkedCodecStream(dev_decode, window, left, up, g)
    ref, got, at = [], [], 0
    for n in pushes:
        for stream, out in ((ref_s, ref), (got_s, got)):
            o = stream.push_frames(frames[at:at + n])
            if o is not None and len(o):
                out.append(o)
        at += n
    ref += list(ref_s.finish())
    got += list(got_s.finish())
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    # window k's decode is launched before window k - 1 is copied to the host
    for k in range(1, len(calls)):
        assert log.index(("decode", k)) < log.index(("copy", k - 1))


# ------------------------------------------------------------ launch counts

def test_launch_counts_survive_concurrent_workers():
    """Slot servers launch kernels from their worker threads (two under a
    router): the count of a kernel's launches loses no update when more
    threads than cores add to it at once."""
    import os
    import sys

    from tts_tpu_torch.ops import _build

    name, threads, each = "stress_test_kernel", 2 * (os.cpu_count() or 2), 5000
    start = threading.Barrier(threads)

    def work():
        start.wait(T)
        for _ in range(each):
            _build.count_launch(name)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, daemon=True) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(T)
        assert not any(th.is_alive() for th in pool)
        assert _build.LAUNCHES[name] == threads * each
    finally:
        sys.setswitchinterval(old)
        del _build.LAUNCHES[name]
