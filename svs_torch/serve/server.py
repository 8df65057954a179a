"""HTTP separation service (port of ``svs_tpu/serve/server.py``).

A stdlib HTTP server: POSTing a WAV to ``/separate`` returns the separated
vocal (or the accompaniment with ``?vocal_solo=0``) as a PCM16 WAV, decoded
through the same stream path as the batch decode
(:func:`svs_torch.infer.separate.separate_wav_stream`) on the model's
device.

Design (svs_tpu's, one for one):
- requests are queued and drained by ONE device-worker thread in arrival
  order; each drain pass coalesces what is waiting into stream calls, so one
  song's copies overlap another's decode on the card;
- audio at another sample rate than the model's is resampled on the host
  both ways;
- stdlib only (``http.server``).

On the card the worker makes the model's device its own current device
before its first call: the current device, the current stream and
``inference_mode`` are per thread, and the worker relies on none of what
the thread that built the service set up.  Everything that crosses between
the worker and a handler thread is numpy.

Endpoints:
  POST /separate[?vocal_solo=0][&mode=whole]   body: WAV bytes -> WAV bytes
  GET  /healthz                                -> {"status": "ok", ...}

The default ``mode`` of POST /separate is ``overlap`` (crossfaded
half-overlapping windows), not the reference-parity ``segments`` that
:meth:`SeparationService.separate` and the batch CLI keep; ``/healthz``
reports the effective ``default_mode``.
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch
import torch.nn as nn

from svs_torch.data import wav as wavio
from svs_torch.infer import separate
from svs_torch.utils.device import DeviceLike


class ServiceOverloaded(RuntimeError):
    """The request queue is full: the caller should retry later (HTTP 503)."""


class ServiceDraining(RuntimeError):
    """The service is draining for shutdown: no new work is admitted
    (HTTP 503, no Retry-After: the process is going away)."""


class ServiceTimeout(RuntimeError):
    """No result within the per-request deadline, e.g. a wedged device call
    (HTTP 504).  The handler thread is released instead of blocking
    forever."""


def _percentiles(samples, qs=(50, 90, 99)):
    """{p50: ..., p90: ..., p99: ...} over a sample window (None if empty).
    Nearest rank on a sorted copy."""
    if not samples:
        return {f"p{q}": None for q in qs}
    s = sorted(samples)
    return {f"p{q}": round(s[min(len(s) - 1, int(q / 100.0 * len(s)))], 4)
            for q in qs}


class SeparationService:
    """Owns the model and the single device-worker thread.

    Queued requests are COALESCED: each drain pass pulls everything waiting
    (up to ``max_batch``), groups it by (vocal_solo, mode) in arrival order,
    and pushes each group through one ``separate_wav_stream`` call.

    Admission control: the queue is bounded (``max_queue`` pending
    requests, each up to a full song in memory), so a burst above the
    device's throughput fast-fails with :class:`ServiceOverloaded`; every
    request carries a deadline (``request_timeout`` seconds), so a hung
    device call raises :class:`ServiceTimeout` in the waiting thread.

    The model carries its ``cfg`` and must lie on ``device`` (``cuda``
    unless the caller passes ``device="cpu"``): a model left on the host is
    refused, never run there quietly."""

    def __init__(self, model: nn.Module, *, max_batch: int = 8,
                 max_queue: int = 32, request_timeout: float = 300.0,
                 device: DeviceLike = None):
        self.device = separate._model_device(model, device)
        self.model = model
        self.cfg = model.cfg
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.request_timeout = request_timeout
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self.requests_served = 0
        self.requests_rejected = 0
        self.requests_timed_out = 0
        self.batches_run = 0
        self.max_coalesced = 0
        self._draining = False
        # observability windows (last 512 requests): seconds a request sat
        # queued before its drain pass picked it up, and seconds of device
        # work attributed to it (its group's stream-call wall / group size)
        self.queue_wait_window: collections.deque = collections.deque(
            maxlen=512)
        self.device_time_window: collections.deque = collections.deque(
            maxlen=512)
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    def _drain(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            item = self._q.get()
            if item is None or self._stop.is_set():
                return
            items = [item]
            while len(items) < self.max_batch:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:  # keep the shutdown signal
                    try:
                        self._q.put_nowait(None)
                    except queue.Full:
                        # racing clients refilled the queue; the _stop flag
                        # (set before the sentinel) still ends the loop at
                        # the next get()
                        pass
                    break
                items.append(nxt)

            now = time.perf_counter()
            for it in items:
                self.queue_wait_window.append(now - it[4])

            # group by device-call signature, preserving arrival order
            groups: dict = {}
            for it in items:
                groups.setdefault((it[1], it[2]), []).append(it)
            for (vocal_solo, mode), grp in groups.items():
                t0 = time.perf_counter()
                try:
                    outs = separate.separate_wav_stream(
                        self.model, [it[0] for it in grp],
                        vocal_solo=vocal_solo, mode=mode,
                        device=self.device)
                    for it, out in zip(grp, outs):
                        it[3].put(("ok", out))
                except Exception as e:  # propagate to the request threads
                    for it in grp:
                        it[3].put(("error", str(e)))
                per_req = (time.perf_counter() - t0) / len(grp)
                self.device_time_window.extend([per_req] * len(grp))
            self.batches_run += 1
            self.max_coalesced = max(self.max_coalesced, len(items))

    def separate(self, y: np.ndarray, vocal_solo: bool = True,
                 mode: str = "segments",
                 timeout: Optional[float] = None) -> np.ndarray:
        if self._draining:
            self.requests_rejected += 1
            raise ServiceDraining("service is draining; not admitting work")
        done: queue.Queue = queue.Queue(1)
        try:
            self._q.put_nowait((y, vocal_solo, mode, done,
                                time.perf_counter()))
        except queue.Full:
            self.requests_rejected += 1
            raise ServiceOverloaded(
                f"request queue full ({self.max_queue} pending)")
        try:
            status, payload = done.get(
                timeout=self.request_timeout if timeout is None else timeout)
        except queue.Empty:
            # the worker may still deliver later; its put() into the
            # abandoned size-1 `done` queue succeeds and is simply dropped
            self.requests_timed_out += 1
            raise ServiceTimeout(
                f"no result within {timeout or self.request_timeout:.0f}s")
        if status != "ok":
            raise RuntimeError(payload)
        self.requests_served += 1
        return payload

    def pending(self) -> int:
        return self._q.qsize()

    def stats(self) -> dict:
        """Observability snapshot for /healthz: counters, queue depth, and
        queue-wait / device-time percentiles over the last 512 requests."""
        return {
            "requests_served": self.requests_served,
            "requests_rejected": self.requests_rejected,
            "requests_timed_out": self.requests_timed_out,
            "pending": self.pending(),
            "batches_run": self.batches_run,
            "max_coalesced": self.max_coalesced,
            "draining": self._draining,
            "queue_wait_secs": _percentiles(list(self.queue_wait_window)),
            "device_time_secs": _percentiles(list(self.device_time_window)),
        }

    def drain(self, timeout: float = 60.0) -> bool:
        """Graceful shutdown: stop admitting (new requests fast-fail with
        :class:`ServiceDraining` -> 503), finish everything already queued,
        then stop the worker.  Returns True when the worker exited within
        ``timeout``; False means queued work is still running (a hung device
        call) and the caller may fall back to :meth:`shutdown`."""
        self._draining = True
        try:
            self._q.put(None, timeout=timeout)  # FIFO: behind queued work
        except queue.Full:
            return False
        self._worker.join(timeout=timeout)
        alive = self._worker.is_alive()
        self._stop.set()
        return not alive

    def shutdown(self):
        self._stop.set()
        try:
            # non-blocking: a full queue must not deadlock shutdown; the
            # drain loop checks _stop on every get, so the sentinel is
            # best-effort only
            self._q.put_nowait(None)
        except queue.Full:
            pass


# default decode mode of POST /separate when ?mode= is omitted: 'overlap'
# (crossfaded half-overlapping windows, no segment seams); the batch CLI
# keeps 'segments' for reference output parity, which a server has no
# counterpart to match
DEFAULT_MODE = "overlap"

# request bodies above this are rejected with 413 (a 10-minute stereo
# float32 WAV at 44.1 kHz is ~211 MB; the cap is a guard against memory
# exhaustion, not a format limit: raise it through serve(max_body_bytes=...))
DEFAULT_MAX_BODY = 256 << 20


def make_handler(service: SeparationService,
                 max_body_bytes: int = DEFAULT_MAX_BODY):
    cfg = service.cfg

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj, headers=()):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._json(200, {"status": ("draining" if service._draining
                                            else "ok"),
                                 "sample_rate": cfg.sample_rate,
                                 "default_mode": DEFAULT_MODE,
                                 **service.stats()})
            else:
                self._json(404, {"error": "unknown path"})

        def _discard_body(self):
            """Read a request body of an accepted size that an early error
            leaves unread: a socket closed with unread input is reset, and
            the reset can drop the response before the client reads it."""
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                return
            if 0 < n <= max_body_bytes:
                self.rfile.read(n)

        def do_POST(self):
            # counted while it answers, so that close() waits for the
            # response to be written in full
            srv = self.server
            with srv.answered:
                srv.answering += 1
            try:
                self._post()
            finally:
                with srv.answered:
                    srv.answering -= 1
                    srv.answered.notify_all()

        def _post(self):
            parsed = urlparse(self.path)
            if parsed.path != "/separate":
                self._discard_body()
                return self._json(404, {"error": "unknown path"})
            q = parse_qs(parsed.query)
            vocal_solo = q.get("vocal_solo", ["1"])[0] != "0"
            mode = q.get("mode", [DEFAULT_MODE])[0]
            if mode not in ("segments", "whole", "overlap"):
                self._discard_body()
                return self._json(400, {"error": f"unknown mode {mode!r}"})
            cl = self.headers.get("Content-Length")
            if cl is None:
                return self._json(411, {"error": "Content-Length required"})
            try:
                n = int(cl)
            except ValueError:
                return self._json(400, {"error": "bad Content-Length"})
            if n <= 0:
                return self._json(400, {"error": "empty body"})
            if n > max_body_bytes:
                return self._json(
                    413, {"error": f"body of {n} bytes exceeds the "
                                   f"{max_body_bytes}-byte limit"})
            try:
                raw = self.rfile.read(n)
                y, sr = wavio.parse_wav(raw, name="<request body>")
                y = wavio.to_mono(y)
                if sr != cfg.sample_rate:
                    y = wavio.resample(y, sr, cfg.sample_rate)
                out = service.separate(y.astype(np.float32), vocal_solo,
                                       mode)
                if sr != cfg.sample_rate:
                    out = wavio.resample(out, cfg.sample_rate, sr)
                body = wavio.encode_wav(out, sr)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except ServiceDraining as e:
                self._json(503, {"error": str(e)})
            except ServiceOverloaded as e:
                # back off roughly one drain's worth; the queue is bounded,
                # so pending / max_batch is a sane unit of wait
                retry = max(1, service.pending() // max(service.max_batch, 1))
                self._json(503, {"error": str(e)},
                           headers=[("Retry-After", str(retry))])
            except ServiceTimeout as e:
                self._json(504, {"error": str(e)})
            except Exception as e:  # a bad body, or the device call's error
                self._json(400, {"error": str(e)})

    return Handler


def install_sigterm_drain(httpd, drain_timeout: float = 60.0):
    """Make SIGTERM drain gracefully: stop admitting (new requests 503),
    finish queued work so in-flight handlers get real responses, then stop
    the accept loop.

    The signal handler only starts a helper thread: ``httpd.shutdown()``
    called from the ``serve_forever`` thread (where Python runs signal
    handlers) would deadlock.  Returns the previous handler.  Call from the
    main thread (CPython delivers signals there)."""
    import signal

    def _graceful():
        print("[svs-serve] SIGTERM: draining...", flush=True)
        ok = httpd.service.drain(timeout=drain_timeout)
        print(f"[svs-serve] drain {'complete' if ok else 'TIMED OUT'}; "
              "stopping", flush=True)
        httpd.shutdown()

    return signal.signal(
        signal.SIGTERM,
        lambda *_: threading.Thread(target=_graceful, daemon=True).start())


def serve(model: nn.Module, host: str = "127.0.0.1", port: int = 8571,
          max_body_bytes: int = DEFAULT_MAX_BODY, max_batch: int = 8,
          max_queue: int = 32, request_timeout: float = 300.0,
          warmup_secs: float = 0.0, device: DeviceLike = None):
    """Start the service and bind the port; returns the server (call its
    ``serve_forever``).

    ``warmup_secs`` > 0: one silent song of that length goes through the
    worker thread before the port binds, so the worker's cuDNN handle, the
    allocator's blocks and the pinned buffers of the length bucket it falls
    in exist before the first real request, and the resampler is imported.  Size it like a typical song;
    0 (the default) binds at once."""
    service = SeparationService(model, max_batch=max_batch,
                                max_queue=max_queue,
                                request_timeout=request_timeout,
                                device=device)
    if warmup_secs > 0:
        sr = service.cfg.sample_rate
        silent = np.zeros(max(1, int(sr * warmup_secs)), np.float32)
        service.separate(silent, mode=DEFAULT_MODE,
                         timeout=max(request_timeout, 1800.0))
        # a request at another sample rate resamples through scipy.signal,
        # whose first import takes seconds: take it here, not in a request
        import scipy.signal  # noqa: F401
        print(f"[svs-serve] warmup done ({warmup_secs:g}s song)",
              flush=True)
    httpd = ThreadingHTTPServer((host, port),
                                make_handler(service, max_body_bytes))
    httpd.service = service  # type: ignore[attr-defined]
    # the handlers answering a POST, and their condition (see close)
    httpd.answering = 0  # type: ignore[attr-defined]
    httpd.answered = threading.Condition()  # type: ignore[attr-defined]
    return httpd


def close(httpd, timeout: float) -> bool:
    """Stop the worker and the listening socket, then wait at most
    ``timeout`` seconds for the handlers still answering a POST, so that
    the responses of a drain are written in full before the process exits.
    Handler threads are daemon threads, and one that waits on an idle
    client connection is not waited for (``server_close`` would join every
    handler thread, idle ones too, with no limit).  Returns True when no
    answer was still being written."""
    httpd.service.shutdown()
    httpd.socket.close()
    with httpd.answered:
        return httpd.answered.wait_for(lambda: httpd.answering == 0,
                                       timeout)
