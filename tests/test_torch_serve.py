"""The port's HTTP separation service against svs_tpu's, on the CPU, over
real sockets.

The same narrow float32 weights go to both servers (svs_tpu ``unet.init``
-> ``state_dict_from_jax``) and every request sends both the same bytes.
Tolerances:
- a separated PCM16 response against svs_tpu's: 1 LSB (the two decodes
  agree to 1e-5 in float32, tests/test_torch_stream.py, and values that
  close can round one code apart);
- status codes, ``Content-Type`` and the ``/healthz`` contract: equal;
- the port's coalesced burst against its own serial answers: bitwise (the
  same program, song by song).
The rest mirrors tests/test_serve.py on the port: admission control,
deadlines, shutdown, the SIGTERM drain, warmup before the bind, and the
device check.  Songs of 2 s or less.
"""

import http.client
import json
import os
import signal
import threading
import time
from urllib.parse import urlparse

import numpy as np
import pytest

import jax

from svs_torch.cli import serve_cli as t_serve_cli
from svs_torch.data import wav as twav
from svs_torch.models import torch_import as t_import
from svs_torch.models.unet import UNet
from svs_torch.serve import server as tserver
from svs_torch.utils import config as tconfig
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.cli import serve_cli as j_serve_cli
from svs_tpu.models import unet as junet
from svs_tpu.serve import server as jserver
from svs_tpu.utils.config import SVSConfig as JConfig

SR = 8192
NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16))
MAX_BODY = 1 << 20


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig(**NARROW)
    params, state = jax.jit(junet.init, static_argnums=1)(
        jax.random.key(0), jcfg)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    model = UNet(TConfig(**NARROW))
    model.load_state_dict(t_import.state_dict_from_jax(params, state))
    return jcfg, params, state, model.eval()


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd):
    httpd.shutdown()
    httpd.service.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def servers(weights):
    jcfg, params, state, model = weights
    jhttpd = jserver.serve(params, state, jcfg, host="127.0.0.1", port=0,
                           max_body_bytes=MAX_BODY)
    thttpd = tserver.serve(model, host="127.0.0.1", port=0,
                           max_body_bytes=MAX_BODY, device="cpu")
    urls = {"jax": _start(jhttpd), "torch": _start(thttpd)}
    yield urls, thttpd
    _stop(jhttpd)
    _stop(thttpd)


def _request(url, method, path, body=None, headers=()):
    """One request with exactly the given headers (none added); returns
    (status, Content-Type, body, Retry-After)."""
    u = urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        conn.putrequest(method, path, skip_accept_encoding=True)
        for k, v in headers:
            conn.putheader(k, v)
        conn.endheaders(body)
        r = conn.getresponse()
        return (r.status, r.getheader("Content-Type"), r.read(),
                r.getheader("Retry-After"))
    finally:
        conn.close()


def _post(url, path, body):
    return _request(url, "POST", path, body,
                    [("Content-Length", str(len(body)))])


def _song(seed, seconds=2.0, sr=SR, channels=None):
    rng = np.random.default_rng(seed)
    shape = (int(sr * seconds),) if channels is None else (
        channels, int(sr * seconds))
    return (rng.standard_normal(shape) * 0.1).astype(np.float32)


def _codes(body):
    y, sr = twav.parse_wav(body)
    return np.round(y * 32768.0).astype(np.int32), sr


@pytest.mark.parametrize("path, body", [
    ("/separate", lambda: twav.encode_wav(_song(1), SR)),
    ("/separate?vocal_solo=0", lambda: twav.encode_wav(_song(2), SR)),
    ("/separate?mode=whole", lambda: twav.encode_wav(_song(3), SR)),
    ("/separate?mode=segments", lambda: twav.encode_wav(_song(4), SR)),
    ("/separate", lambda: twav.encode_wav(
        _song(5, seconds=1.0, sr=44100, channels=2), 44100)),
], ids=["default", "vocal_solo_0", "whole", "segments", "44k1_stereo"])
def test_separate_matches_jax_server(servers, path, body):
    urls, _ = servers
    data = body()
    got = _post(urls["torch"], path, data)
    want = _post(urls["jax"], path, data)
    assert got[0] == want[0] == 200
    assert got[1] == want[1] == "audio/wav"
    (g, g_sr), (w, w_sr) = _codes(got[2]), _codes(want[2])
    assert g_sr == w_sr == twav.parse_wav(data)[1]
    assert g.shape == w.shape and np.abs(w).max() > 100
    assert np.abs(g - w).max() <= 1


_WAV = twav.encode_wav(_song(6, seconds=1.0), SR)


@pytest.mark.parametrize("method, path, body, headers", [
    ("POST", "/separate", b"not a wav", [("Content-Length", "9")]),
    ("GET", "/nope", None, []),
    ("POST", "/nope", _WAV, [("Content-Length", str(len(_WAV)))]),
    ("POST", "/separate?mode=bogus", _WAV,
     [("Content-Length", str(len(_WAV)))]),
    ("POST", "/separate", None, []),
    ("POST", "/separate", None, [("Content-Length", str(MAX_BODY + 1))]),
    ("POST", "/separate", None, [("Content-Length", "0")]),
    ("POST", "/separate", None, [("Content-Length", "many")]),
], ids=["bad_body", "unknown_get", "unknown_post", "bad_mode",
        "no_content_length", "oversize", "empty", "bad_content_length"])
def test_error_codes_match_jax_server(servers, method, path, body, headers):
    urls, _ = servers
    got = _request(urls["torch"], method, path, body, headers)
    want = _request(urls["jax"], method, path, body, headers)
    assert got[0] == want[0] and got[0] in (400, 404, 411, 413)
    assert got[1] == want[1] == "application/json"
    assert "error" in json.loads(got[2])


@pytest.mark.parametrize("path, code", [("/nope", 404),
                                        ("/separate?mode=bogus", 400)])
def test_early_errors_are_not_lost_to_a_reset(servers, path, code):
    """An error answered before the body is read: the port reads the body
    first, so closing the socket does not reset the connection and drop
    the response (one in five to ten was lost with a 1 MiB body left unread)."""
    urls, _ = servers
    body = b"\0" * (MAX_BODY - 1024)
    for _ in range(50):
        assert _post(urls["torch"], path, body)[0] == code


def test_healthz_matches_jax_server(servers):
    urls, _ = servers
    got = json.loads(_request(urls["torch"], "GET", "/healthz")[2])
    want = json.loads(_request(urls["jax"], "GET", "/healthz")[2])
    assert set(got) == set(want)
    for key in ("status", "sample_rate", "default_mode"):
        assert got[key] == want[key]
    assert got["status"] == "ok" and got["default_mode"] == "overlap"
    for window in ("queue_wait_secs", "device_time_secs"):
        assert set(got[window]) == set(want[window]) == {"p50", "p90",
                                                         "p99"}


def test_burst_coalesced_matches_serial(servers):
    """Concurrent requests are coalesced into stream calls and return the
    same bits as serial requests; /healthz then has percentiles."""
    urls, httpd = servers
    service = httpd.service
    songs = [_song(10 + i) for i in range(6)]
    serial = [service.separate(y) for y in songs]
    results, errors = [None] * len(songs), []

    def worker(i):
        try:
            results[i] = service.separate(songs[i])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(songs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    for got, want in zip(results, serial):
        np.testing.assert_array_equal(got, want)
    assert service.max_coalesced > 1
    h = json.loads(_request(urls["torch"], "GET", "/healthz")[2])
    assert h["requests_served"] == service.requests_served
    for window in ("queue_wait_secs", "device_time_secs"):
        pcts = h[window]
        assert pcts["p50"] is not None and 0.0 <= pcts["p50"] <= pcts["p99"]


def _stall(monkeypatch):
    """Wedge the port's stream decode until released."""
    release, entered = threading.Event(), threading.Event()

    def stalled_stream(model, songs, **kw):
        entered.set()
        release.wait(timeout=60)
        return [np.zeros_like(y) for y in songs]

    monkeypatch.setattr(tserver.separate, "separate_wav_stream",
                        stalled_stream)
    return release, entered


@pytest.fixture()
def stalled_service(monkeypatch, weights):
    release, entered = _stall(monkeypatch)
    service = tserver.SeparationService(weights[3], max_queue=2,
                                        request_timeout=0.3, device="cpu")
    yield service, release, entered
    release.set()
    service.shutdown()


def _swallow(service, y):
    try:
        service.separate(y)
    except tserver.ServiceTimeout:
        pass  # the worker is wedged by design


def _fill_queue(service, entered, y):
    """Pin request 1 inside the wedged call, then queue two more (the
    queue's bound); returns the client threads."""
    first = threading.Thread(target=_swallow, args=(service, y))
    first.start()
    assert entered.wait(timeout=30)
    rest = [threading.Thread(target=_swallow, args=(service, y))
            for _ in range(2)]
    for t in rest:
        t.start()
    for _ in range(500):
        if service.pending() == 2:
            break
        time.sleep(0.02)
    assert service.pending() == 2
    return [first] + rest


def test_overload_fast_fails(stalled_service):
    service, release, entered = stalled_service
    y = _song(20, seconds=0.25)
    clients = _fill_queue(service, entered, y)
    t0 = time.perf_counter()
    with pytest.raises(tserver.ServiceOverloaded):
        service.separate(y)
    assert time.perf_counter() - t0 < 0.1
    assert service.requests_rejected == 1
    release.set()
    for t in clients:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in clients)


def test_request_timeout_releases_caller(stalled_service):
    service, release, _ = stalled_service
    t0 = time.perf_counter()
    with pytest.raises(tserver.ServiceTimeout):
        service.separate(_song(21, seconds=0.25))
    assert 0.2 < time.perf_counter() - t0 < 5.0
    assert service.requests_timed_out == 1
    release.set()


def test_shutdown_with_full_queue_does_not_block(stalled_service):
    service, release, entered = stalled_service
    clients = _fill_queue(service, entered, _song(22, seconds=0.25))
    t0 = time.perf_counter()
    service.shutdown()
    assert time.perf_counter() - t0 < 0.5
    release.set()
    for t in clients:
        t.join(timeout=30)
    service._worker.join(timeout=30)
    assert not service._worker.is_alive()


def test_http_overload_503_with_retry_after_and_504(monkeypatch, weights):
    release, entered = _stall(monkeypatch)
    httpd = tserver.serve(weights[3], host="127.0.0.1", port=0, max_queue=1,
                          request_timeout=1.0, device="cpu")
    url = _start(httpd)
    body = twav.encode_wav(_song(23, seconds=0.25), SR)
    codes = []
    try:
        def post():
            status, _, _, retry = _post(url, "/separate", body)
            codes.append((status, retry))

        threads = [threading.Thread(target=post) for _ in range(4)]
        threads[0].start()
        assert entered.wait(timeout=30)
        for t in threads[1:]:
            t.start()
            time.sleep(0.1)  # a fixed arrival order
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        got = {c for c, _ in codes}
        assert 503 in got and 504 in got
        assert all(r is not None for c, r in codes if c == 503)
        h = json.loads(_request(url, "GET", "/healthz")[2])
        assert h["requests_rejected"] >= 1
    finally:
        release.set()
        _stop(httpd)


def test_sigterm_under_burst_drains_or_503s(monkeypatch, weights):
    """SIGTERM during a burst: queued requests are served, later ones get
    503 or a refused connection, no handler hangs, the loop stops."""
    def slow_stream(model, songs, **kw):
        time.sleep(0.1)
        return [np.zeros_like(y) for y in songs]

    monkeypatch.setattr(tserver.separate, "separate_wav_stream",
                        slow_stream)
    httpd = tserver.serve(weights[3], host="127.0.0.1", port=0, max_batch=1,
                          max_queue=64, device="cpu")
    prev = tserver.install_sigterm_drain(httpd, drain_timeout=60.0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    serve_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    serve_thread.start()
    body = twav.encode_wav(_song(24, seconds=0.25), SR)
    outcomes = {}

    def post(i):
        try:
            outcomes[i] = _post(url, "/separate", body)[0]
        except OSError as e:  # refused or reset once the loop stopped
            outcomes[i] = repr(e)

    try:
        pre = [threading.Thread(target=post, args=(i,)) for i in range(8)]
        for t in pre:
            t.start()
        for _ in range(500):
            if httpd.service.pending() >= 3:
                break
            time.sleep(0.01)
        assert httpd.service.pending() >= 3
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(200):
            if httpd.service._draining:
                break
            time.sleep(0.01)
        late = [threading.Thread(target=post, args=(100 + i,))
                for i in range(3)]
        for t in late:
            t.start()
        for t in pre + late:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in pre + late), "hung handler"
        assert all(outcomes[i] in (200, 503) for i in range(8)), outcomes
        assert sum(outcomes[i] == 200 for i in range(8)) >= 3, outcomes
        for i in (100, 101, 102):
            assert outcomes[i] == 503 or isinstance(outcomes[i], str)
        serve_thread.join(timeout=10)
        assert not serve_thread.is_alive()
        assert not httpd.service._worker.is_alive()
    finally:
        signal.signal(signal.SIGTERM, prev)
        httpd.service.shutdown()
        httpd.server_close()


def test_close_waits_for_an_answer_and_no_longer_than_its_timeout(
        monkeypatch, weights):
    """close() waits for a handler that is still answering a POST, at most
    for its timeout; once the answer is written it returns True and the
    client has its 200."""
    import socket

    release, entered = _stall(monkeypatch)
    httpd = tserver.serve(weights[3], host="127.0.0.1", port=0,
                          device="cpu")
    url = _start(httpd)
    statuses = []
    client = threading.Thread(target=lambda: statuses.append(_post(
        url, "/separate", twav.encode_wav(_song(27, seconds=0.25), SR))[0]))
    idle = socket.create_connection(("127.0.0.1", httpd.server_address[1]))
    try:
        client.start()
        assert entered.wait(timeout=30)
        httpd.shutdown()
        t0 = time.perf_counter()
        assert tserver.close(httpd, timeout=0.3) is False
        assert time.perf_counter() - t0 < 2.0
        release.set()
        t0 = time.perf_counter()
        assert tserver.close(httpd, timeout=30.0) is True
        assert time.perf_counter() - t0 < 5.0  # the idle one is not awaited
        client.join(timeout=30)
        assert statuses == [200]
    finally:
        release.set()
        idle.close()
        client.join(timeout=30)


def test_warmup_runs_on_the_worker_before_the_bind(monkeypatch, weights):
    events = []
    decode = tserver.separate.separate_wav_stream

    def recording_stream(model, songs, **kw):
        events.append(("decode", threading.current_thread().name,
                       len(songs[0])))
        return decode(model, songs, **kw)

    class RecordingServer(tserver.ThreadingHTTPServer):
        def __init__(self, *a, **kw):
            events.append(("bind",))
            super().__init__(*a, **kw)

    monkeypatch.setattr(tserver.separate, "separate_wav_stream",
                        recording_stream)
    monkeypatch.setattr(tserver, "ThreadingHTTPServer", RecordingServer)
    httpd = tserver.serve(weights[3], host="127.0.0.1", port=0,
                          warmup_secs=0.5, device="cpu")
    try:
        worker = httpd.service._worker.name
        assert events == [("decode", worker, SR // 2), ("bind",)]
        assert worker != threading.current_thread().name
        assert httpd.service.requests_served == 1
        y = _song(25, seconds=0.5)
        out = httpd.service.separate(y)
        assert out.shape == y.shape and np.isfinite(out).all()
    finally:
        httpd.service.shutdown()
        httpd.server_close()


def test_a_model_on_the_host_needs_device_cpu(weights):
    """Without device='cpu' the service wants the card: with none it
    raises (resolve_device), with one it refuses the host model; either
    way before any worker thread starts."""
    before = threading.active_count()
    with pytest.raises((RuntimeError, ValueError)):
        tserver.SeparationService(weights[3])
    with pytest.raises((RuntimeError, ValueError)):
        tserver.serve(weights[3], host="127.0.0.1", port=0)
    assert threading.active_count() == before


def _flags(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_serve_cli_has_jax_flags_plus_device():
    t, j = _flags(t_serve_cli.build_parser()), _flags(
        j_serve_cli.build_parser())
    assert set(t) == set(j) | {"device"}
    assert {k: t[k] for k in j} == j
    assert t["device"] == "cuda"


def test_serve_cli_without_a_card_exits_through_resolve_device(
        monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve_cli.main(["--model_path", str(tmp_path / "none.pth")])


def test_serve_cli_serves_then_drains_on_sigterm(monkeypatch, weights,
                                                 tmp_path):
    """serve_cli.main on the host: a narrow .pth, one request, then SIGTERM
    ends serve_forever through the drain and main returns 0."""
    pth = str(tmp_path / "narrow.pth")
    t_import.save_pth(pth, weights[3])
    monkeypatch.setitem(tconfig.PRESETS, "narrow", TConfig(**NARROW))
    started = []
    serve = tserver.serve

    def recording_serve(*a, **kw):
        started.append(serve(*a, **kw))
        return started[-1]

    monkeypatch.setattr(tserver, "serve", recording_serve)
    y = _song(26, seconds=0.5)
    statuses = []

    prev = signal.getsignal(signal.SIGTERM)

    def client():
        try:
            for _ in range(500):
                if started:
                    break
                time.sleep(0.01)
            url = f"http://127.0.0.1:{started[0].server_address[1]}"
            statuses.append(
                _post(url, "/separate", twav.encode_wav(y, SR))[0])
        finally:
            # signal only once main has installed its drain handler
            for _ in range(500):
                if signal.getsignal(signal.SIGTERM) is not prev:
                    os.kill(os.getpid(), signal.SIGTERM)
                    break
                time.sleep(0.01)

    t = threading.Thread(target=client)
    t.start()
    try:
        rc = t_serve_cli.main(["--model_path", pth, "--port", "0",
                               "--preset", "narrow", "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, prev)
        t.join(timeout=30)
    assert rc == 0 and statuses == [200]
    assert not started[0].service._worker.is_alive()


def test_serve_cli_exits_on_sigterm_with_an_idle_connection_open(
        monkeypatch, weights, tmp_path):
    """A client connection that never sends its request does not hold
    serve_cli's exit: after SIGTERM main returns 0 well within the drain
    timeout (--request_timeout)."""
    import socket

    pth = str(tmp_path / "narrow.pth")
    t_import.save_pth(pth, weights[3])
    monkeypatch.setitem(tconfig.PRESETS, "narrow", TConfig(**NARROW))
    started = []
    serve = tserver.serve

    def recording_serve(*a, **kw):
        started.append(serve(*a, **kw))
        return started[-1]

    monkeypatch.setattr(tserver, "serve", recording_serve)
    prev = signal.getsignal(signal.SIGTERM)
    idle, signalled = [], []

    def client():
        for _ in range(500):
            if started and signal.getsignal(signal.SIGTERM) is not prev:
                break
            time.sleep(0.01)
        idle.append(socket.create_connection(
            ("127.0.0.1", started[0].server_address[1])))
        time.sleep(0.2)  # its handler thread is waiting on the request line
        signalled.append(time.perf_counter())
        os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=client)
    t.start()
    try:
        rc = t_serve_cli.main(["--model_path", pth, "--port", "0",
                               "--preset", "narrow", "--device", "cpu",
                               "--request_timeout", "20"])
        exit_s = time.perf_counter() - signalled[0]
    finally:
        signal.signal(signal.SIGTERM, prev)
        t.join(timeout=30)
        for sock in idle:
            sock.close()
    assert rc == 0 and exit_s < 5.0
