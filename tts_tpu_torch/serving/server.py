"""Serving front-end (counterpart of tts_tpu/serving/server.py): a
pipeline-agnostic engine over MicroBatcher (or over a continuous-batching
slot server, `TTSServer.continuous`) and a dependency-free HTTP endpoint
(stdlib http.server).

`TTSServer.for_pipeline` adapts a family pipeline's batched entry point
(synthesize_ids_batch / synthesize_from_prefill_batch: an order-preserving
list of per-request inputs -> (list of int16 waveforms, stats));
`TTSServer` itself only needs a `batch_fn: list[request] -> list[waveform]`,
so custom request shapes pass through untouched.

HTTP surface (serve_http):
  POST /synthesize   {"ids": [[...int...]], ...}  -> audio/wav bytes
  POST /stream       same body -> chunked audio/L16 PCM (when the server was
                     built with a stream_fn); the first chunk flushes as
                     soon as the model emits it, and the response header
                     X-TTFA-MS carries the measured time to first audio
  GET  /stats        -> JSON stats snapshot (+ streaming TTFA)
The JSON body is decoded by the server's `request_from_json` (default: an
int32 array of "ids"), so family adapters can accept richer payloads.

A submit callable takes a server-side deadline only if it names a
`deadline_s` parameter; the capability is read from its signature once,
where the callable is bound (tts_tpu reads it on every submit for a bound
method, and counts a bare **kwargs as capable).
"""
from __future__ import annotations

import inspect
import io
import json
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .batcher import MicroBatcher

__all__ = ["TTSServer", "serve_http"]


def _accepts_deadline(fn) -> bool:
    """True if `fn` names a `deadline_s` parameter it takes by keyword.

    Capability is read from the signature rather than probed with a call:
    `except TypeError` probing swallows TypeErrors raised *inside* a
    deadline-accepting adapter. A bare **kwargs does not count: it may
    swallow the keyword or pass it where it fails. The answer is cached on
    the function (a bound method's `__func__`), so a callable's signature
    is read once."""
    target = getattr(fn, "__func__", fn)
    cached = getattr(target, "_accepts_deadline", None)
    if cached is not None:
        return cached
    try:
        p = inspect.signature(fn).parameters.get("deadline_s")
        ok = p is not None and p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                                          inspect.Parameter.KEYWORD_ONLY)
    except (TypeError, ValueError):    # builtins/partials w/o signature
        ok = False
    try:
        target._accepts_deadline = ok
    except AttributeError:             # objects without a __dict__
        pass
    return ok


class TTSServer:
    """Synchronous-future serving engine: submit() returns a
    concurrent.futures.Future resolving to an int16 waveform."""

    def __init__(self, batch_fn, *, sample_rate: int, pad_request=None,
                 max_batch: int = 8, max_wait_ms: float = 10.0,
                 batch_sizes: tuple[int, ...] = (1, 2, 4, 8),
                 request_from_json=None, stream_fn=None):
        self.sample_rate = sample_rate
        self.request_from_json = request_from_json or (
            lambda body: np.asarray(body["ids"], np.int32))
        self.stream_fn = stream_fn   # request -> iterator of int16 chunks
        # running sum/count (not a list): a long-lived server must not
        # grow memory per stream
        self._ttfa_sum = 0.0
        self._ttfa_n = 0
        self._ttfa_lock = threading.Lock()
        self.batcher = MicroBatcher(
            batch_fn, max_batch=max_batch, max_wait_ms=max_wait_ms,
            batch_sizes=batch_sizes, pad_request=pad_request)
        self._bind(self.batcher.submit)

    @classmethod
    def for_pipeline(cls, pipeline, pad_request, *, sample_rate=None,
                     **kw):
        """Adapt a family pipeline: routes through its batched entry point
        (synthesize_from_prefill_batch for Qwen, synthesize_ids_batch
        otherwise). pad_request must be a valid minimal request for that
        pipeline (used to round batches up to the size ladder)."""
        entry = getattr(pipeline, "synthesize_ids_batch", None)
        if entry is None:
            entry = getattr(pipeline, "synthesize_from_prefill_batch", None)
        if entry is None:
            raise TypeError(f"{type(pipeline).__name__} has no batched "
                            "synthesis entry point")
        sr = sample_rate or getattr(pipeline, "output_sample_rate", None) \
            or getattr(pipeline, "sample_rate", None)
        if sr is None:
            raise ValueError("pass sample_rate= (pipeline does not expose "
                             "one)")
        return cls(lambda reqs: entry(list(reqs))[0], sample_rate=sr,
                   pad_request=pad_request, **kw)

    @classmethod
    def continuous(cls, slot_server, *, sample_rate, submit=None,
                   request_from_json=None, stream_fn=None):
        """Serve over a continuous-batching slot server (serving/slots)
        instead of the admission-time MicroBatcher: requests admit
        mid-decode at chunk boundaries. `submit` adapts multi-part requests
        (default: slot_server.submit(request)); slot futures resolve to
        (wav, n), and the HTTP layer returns the wav."""
        obj = cls.__new__(cls)
        obj.sample_rate = sample_rate
        obj.request_from_json = request_from_json or (
            lambda body: np.asarray(body["ids"], np.int32))
        obj.stream_fn = stream_fn
        obj._ttfa_sum = 0.0
        obj._ttfa_n = 0
        obj._ttfa_lock = threading.Lock()
        obj.batcher = slot_server
        obj._bind(submit or slot_server.submit)
        return obj

    def _bind(self, submit) -> None:
        """Bind the submit callable and read its deadline capability once."""
        self._submit = submit
        self._deadline_ok = _accepts_deadline(submit)

    def submit(self, request, deadline_s: float | None = None):
        if deadline_s is not None and self._deadline_ok:
            # server-side deadline: the engine expires the request at a
            # chunk boundary and FREES ITS SLOT, unlike a client-side future
            # timeout, which abandons the future while the row keeps
            # decoding. Adapters without the parameter (MicroBatcher)
            # degrade to the client-side bound in synthesize().
            return self._submit(request, deadline_s=deadline_s)
        return self._submit(request)

    def synthesize(self, request, timeout: float = 300.0) -> np.ndarray:
        # the engine-side deadline mirrors the client timeout; the
        # result() bound is a backstop for engines without deadlines
        out = self.submit(request, deadline_s=timeout).result(
            timeout=timeout + 30.0)
        # slot-server futures resolve to (wav, n); batcher futures to wav
        return out[0] if isinstance(out, tuple) else out

    def record_ttfa(self, ttfa_ms: float) -> None:
        with self._ttfa_lock:
            self._ttfa_sum += ttfa_ms
            self._ttfa_n += 1

    def stats(self) -> dict:
        st = self.batcher.stats
        # SlotRouter exposes stats() (aggregate dict); MicroBatcher and the
        # slot servers expose a stats object with .snapshot()
        s = st() if callable(st) else st.snapshot()
        if self._ttfa_n:
            s["streams"] = self._ttfa_n
            s["mean_ttfa_ms"] = round(self._ttfa_sum / self._ttfa_n, 3)
        return s

    def close(self) -> None:
        self.batcher.close()


def _wav_bytes(samples: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(np.asarray(samples, np.int16).tobytes())
    return buf.getvalue()


def serve_http(server: TTSServer, host: str = "127.0.0.1", port: int = 0,
               ) -> ThreadingHTTPServer:
    """Start the HTTP front-end on a background thread; returns the
    ThreadingHTTPServer (its .server_address carries the bound port;
    call .shutdown() to stop). One handler thread per connection, all
    funneling into the shared MicroBatcher."""

    class Handler(BaseHTTPRequestHandler):
        # chunked transfer-encoding (the /stream path) is an HTTP/1.1
        # feature; the BaseHTTPRequestHandler default is HTTP/1.0, on
        # which conforming clients ignore chunk framing and read to close
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):   # quiet; stats carry the signal
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/stats":
                body = json.dumps(server.stats()).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            self._stream_started = False   # per-request (keep-alive reuses
            try:                           # the handler instance)
                n = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(n) or b"{}")
                request = server.request_from_json(payload)
                if self.path == "/synthesize":
                    # optional per-request deadline: wired through to the
                    # engine so expiry frees the slot (not just the
                    # client's wait); expiry -> HTTP 504
                    timeout = float(payload.get("deadline_s", 300.0))
                    try:
                        wav = server.synthesize(request, timeout=timeout)
                    except TimeoutError as e:
                        self._send(504, json.dumps(
                            {"error": str(e)[:500]}).encode(),
                            "application/json")
                        return
                    self._send(200, _wav_bytes(wav, server.sample_rate),
                               "audio/wav")
                elif self.path == "/stream" and server.stream_fn is not None:
                    self._stream(request)
                else:
                    self._send(404, b"not found", "text/plain")
            except Exception as e:
                if getattr(self, "_stream_started", False):
                    # headers + chunks already on the wire: a 500 status
                    # line would be injected into the chunk stream. Drop
                    # the connection without the terminating 0-chunk so
                    # the client sees a truncated (= failed) stream.
                    self.close_connection = True
                    return
                body = json.dumps({"error": str(e)[:500]}).encode()
                self._send(500, body, "application/json")

        def _stream(self, request) -> None:
            import time

            t0 = time.perf_counter()
            chunks = server.stream_fn(request)
            first = next(chunks, None)       # block until first audio
            ttfa = (time.perf_counter() - t0) * 1e3
            server.record_ttfa(ttfa)
            self._stream_started = True
            self.send_response(200)
            self.send_header("Content-Type",
                             f"audio/L16; rate={server.sample_rate}")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-TTFA-MS", f"{ttfa:.1f}")
            self.end_headers()

            def emit(chunk) -> None:
                data = np.asarray(chunk, np.int16).tobytes()
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()

            if first is not None:
                emit(first)
            for chunk in chunks:
                emit(chunk)
            self.wfile.write(b"0\r\n\r\n")

    httpd = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="tts-http").start()
    return httpd
