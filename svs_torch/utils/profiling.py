"""Tracing, counters, device phase clocks and numerics debugging (port of
``svs_tpu/utils/profiling.py``).

- :func:`trace` — the operator's exporter: a ``torch.profiler`` trace of the
  CPU and (where there is one) the CUDA device, written for TensorBoard by
  ``tensorboard_trace_handler``; the program's spans are in it
- :func:`annotate` — the program's span (``svs.<layer>.<what>``).  With no
  profiler running it returns at once (one test of torch's own "profiler
  enabled" flag), except that a span opened with ``always`` then adds its
  count and seconds to the registry's untraced ledger (``host``: the few
  spans that a metric of an untraced window reads).  Under a profiler it
  records a host event of its name (``_RecordFunctionFast``, the host op
  event that ``record_function`` is too, without the device-side copy of
  the interval that the profiler adds to a ``record_function`` span: that
  copy would count as the card's work in the trace's busy time), so its
  host interval lies on the trace's timeline beside the device's
  activities; and it adds its count, total seconds and self seconds (total
  less the child spans it covers, one stack a thread) to this module's
  registry
- :func:`mark` — the device phase clock: inside a captured CUDA graph a
  host span sees nothing, so a program marks its phase boundaries; each
  mark recorded into a graph is a one-thread kernel
  (``svs_torch/csrc/phase_clock.cu``, built with ``nvcc`` at the first
  mark) that adds the time since the previous mark on its device into the
  phase's slot of a small device buffer, on the card, at every replay.
  Where the kernel cannot run (no ``nvcc``, a build that fails, a card
  other than sm_90) the card's clocks turn off for the process with one
  warning, and nothing else changes.  On the CPU a mark does the same on
  the host clock
- :func:`publish` — counters that live on their objects (the program
  caches' builds, evictions and build seconds), summed into the registry
  when it is read: always on, never copied
- :func:`snapshot` / :func:`reset` — read / empty the registry; nothing is
  written anywhere until asked
- :func:`debug_nans` — scoped NaN checking: the first aten op whose floating
  output holds a NaN raises ``FloatingPointError`` naming the op, forward
  and backward alike (``torch.autograd.detect_anomaly`` checks the backward
  only)
- :func:`fetch_barrier`, :func:`time_amortized` — the timing barrier and
  the amortised timer that the benchmarks use
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import threading
import time
import warnings
import weakref
from typing import Dict, List

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# the phase slots a device buffer holds; a mark of a further phase raises
PHASE_SLOTS = 32
BEGIN = "begin"

_lock = threading.Lock()
_spans: Dict[str, List[float]] = {}  # name -> [count, total s, self s]
_host: Dict[str, List[float]] = {}   # untraced ``always`` spans: [count, s]
_local = threading.local()           # .stack: this thread's open spans
_slots: Dict[str, int] = {}          # phase -> its slot in every buffer
_clocks: Dict[torch.device, object] = {}  # device -> its phase buffer
_published = weakref.WeakSet()
_launch = None  # the phase clock kernel's C entry point, typed
_off = None  # why the card's phase clocks are off for the process, if so


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace into ``log_dir`` (view with
    TensorBoard's profiler plugin, or the ``.pt.trace.json`` in Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


# ------------------------------------------------------------------ spans

_OFF = contextlib.nullcontext()  # the span while no profiler runs


class _Span:
    __slots__ = ("name", "record", "t0", "child")

    def __init__(self, name: str):
        self.name = name
        self.record = _RecordFunctionFast(name)
        self.child = 0.0

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.record.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.record.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child += dt
        with _lock:
            entry = _spans.setdefault(self.name, [0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += dt
            entry[2] += dt - self.child
        return False


class _Timed:
    """An ``always`` span with no profiler running: its count and seconds
    into the untraced ledger."""
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        with _lock:
            entry = _host.get(self.name)
            if entry is None:
                entry = _host[self.name] = [0, 0.0]
            entry[0] += 1
            entry[1] += dt
        return False


def annotate(name: str, always: bool = False):
    """A span of the program, ``with annotate("svs.train.feed"): ...``;
    recorded only while a profiler runs (see the module's docstring): on
    every thread in the registry, in the trace as far as the profiler
    records the thread.  ``always``: with no profiler running, its count
    and seconds go to the untraced ledger instead (two clock reads and a
    lock a span), so a metric can read the host's time outside a trace.
    A span must close on the thread that opened it, so never hold one open
    across a generator's ``yield``."""
    if not _autograd_profiler._is_profiler_enabled:
        return _Timed(name) if always else _OFF
    return _Span(name)


# ---------------------------------------------------------- phase clocks

def _slot(phase: str) -> int:
    if phase == BEGIN:
        return -1
    slot = _slots.get(phase)
    if slot is None:
        with _lock:
            slot = _slots.setdefault(phase, len(_slots))
    if slot >= PHASE_SLOTS:
        raise ValueError(f"phase {phase!r}: more than {PHASE_SLOTS} phases")
    return slot


def _clock_plain(buf: np.ndarray, slot: int, now: int) -> None:
    """The phase clock kernel's arithmetic: ``buf[0]`` the previous mark's
    stamp, then a (sum of ns, count) pair a slot; ``slot`` < 0 stamps
    alone."""
    if slot >= 0:
        buf[1 + 2 * slot] += now - buf[0]
        buf[2 + 2 * slot] += 1
    buf[0] = now


def _clocks_off(why: str) -> None:
    """Turn the card's phase clocks off for the process, with one
    warning: marks then launch nothing and the card's phases read none."""
    global _off
    with _lock:
        first = _off is None
        if first:
            _off = why
    if first:
        warnings.warn(f"svs_torch phase clocks off: {why}", RuntimeWarning,
                      stacklevel=3)


def _kernel():
    """The phase clock kernel's launcher, ``(buf, slot, stream) -> CUDA
    error``, built and loaded at its first call."""
    global _launch
    if _launch is None:
        from svs_torch.ops.cuda import build
        fn = build.load("phase_clock").svs_phase_mark
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _card_clock(device: torch.device):
    """The card's phase buffer, made (and the kernel built) at the
    device's first mark, which must come outside a capture: the eager
    warm-up that precedes every capture of the port's programs.  None
    where the clocks are off."""
    buf = _clocks.get(device)
    if buf is not None or _off is not None:
        return buf
    if torch.cuda.is_current_stream_capturing():
        _clocks_off(f"the first phase mark on {device} came inside a CUDA "
                    "graph capture (mark once eagerly before capturing)")
        return None
    if torch.cuda.get_device_capability(device) != (9, 0):
        _clocks_off(f"{torch.cuda.get_device_name(device)} is not sm_90, "
                    "the kernel's one target")
        return None
    try:
        _kernel()
    except Exception as e:  # no nvcc, a failed build, an unwritable dir
        _clocks_off(f"the kernel did not build or load ({e})")
        return None
    with torch.inference_mode(False):  # a decode marks in inference mode
        buf = torch.zeros(1 + 2 * PHASE_SLOTS, dtype=torch.int64,
                          device=device)
    with _lock:
        return _clocks.setdefault(device, buf)


def mark(phase: str, device) -> None:
    """The end of ``phase`` (its start: the previous mark on ``device``),
    or with ``begin`` the start of a program, which adds nothing.

    On a CUDA device a mark recorded into a graph capture is the phase
    clock kernel on the current stream; each replay of the graph adds to
    the device's buffer with no host call and no synchronise.  A mark
    outside a capture there makes the buffer and launches nothing: an eager
    step's gaps between marks are the host's time, not the card's, and a
    warm-up's one-time work would swamp the replays' sums.  On any other
    device a mark adds on the host clock, every call."""
    slot = _slot(phase)
    device = torch.device(device)
    if device.type != "cuda":
        now = time.perf_counter_ns()
        with _lock:
            buf = _clocks.get(device)
            if buf is None:
                buf = _clocks[device] = np.zeros(1 + 2 * PHASE_SLOTS,
                                                 np.int64)
            _clock_plain(buf, slot, now)
        return
    if _off is not None:
        return
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with torch.cuda.device(device):
        buf = _card_clock(device)
        if buf is None or not torch.cuda.is_current_stream_capturing():
            return
        rc = _kernel()(buf.data_ptr(), slot,
                       torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        _clocks_off(f"the kernel's launch failed (CUDA error {rc})")


# -------------------------------------------------------------- registry

def publish(source) -> None:
    """Add ``source``'s counters to every :func:`snapshot`: its
    ``counters()`` (a dict of numbers), summed by name over the live
    sources; held weakly."""
    with _lock:
        _published.add(source)


def snapshot() -> Dict:
    """The registry: ``spans`` (name -> count, ``total_s``, ``self_s``;
    recorded under a profiler only), ``host`` (name -> count, ``total_s``:
    the ``always`` spans with no profiler running), ``phases`` (device
    type, ``cuda`` or ``cpu``, -> name -> count, ``s``, summed over the
    devices of the type; on the card each replay's marks, read here once,
    after a synchronise of each device) and ``counters`` (the published
    sources' sums; cumulative: compare two snapshots for a window)."""
    with _lock:
        spans = {n: {"count": int(c), "total_s": t, "self_s": s}
                 for n, (c, t, s) in _spans.items()}
        host = {n: {"count": int(c), "total_s": t}
                for n, (c, t) in _host.items()}
        slots = dict(_slots)
        clocks = list(_clocks.items())
        sources = list(_published)
    sums: Dict[str, np.ndarray] = {}
    for device, buf in clocks:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            buf = buf.cpu().numpy()
        total = sums.setdefault(device.type, np.zeros_like(buf))
        total[1:] += buf[1:]
    phases = {kind: {name: {"count": int(v[2 + 2 * k]),
                            "s": float(v[1 + 2 * k]) / 1e9}
                     for name, k in slots.items()
                     if k < PHASE_SLOTS and v[2 + 2 * k]}
              for kind, v in sums.items()}
    counters = collections.Counter()
    for source in sources:
        counters.update(source.counters())
    return {"spans": spans, "host": host, "phases": phases,
            "counters": dict(counters)}


def reset() -> None:
    """Empty the spans, the untraced ledger and the phases' sums (the
    counters are their sources' own)."""
    with _lock:
        _spans.clear()
        _host.clear()
        clocks = list(_clocks.items())
    for device, buf in clocks:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            with torch.cuda.device(device):
                buf[1:].zero_()
            torch.cuda.synchronize(device)
        else:
            with _lock:
                buf[1:] = 0


# ------------------------------------------------------------- numerics

class _NanCheck(TorchDispatchMode):
    """Runs every aten op, then raises if a floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.layout == torch.strided
                    and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN checking: inside the block, any op producing a NaN raises
    ``FloatingPointError`` at that op.  Each op's output is read back, so
    the block runs synchronously; on exit the previous state returns."""
    if not enable:
        yield
        return
    with _NanCheck():
        yield


def fetch_barrier(tree) -> float:
    """Completion barrier for timing: synchronise the device of the first
    tensor in ``tree`` and return its first element as a float.

    PyTorch returns before the card finishes; the synchronise waits for
    every stream of that device, so everything enqueued before it is done.
    Benches close their timed bursts with this, never with a bare host
    clock."""
    leaf = tree_leaves(tree)[0]
    if not isinstance(leaf, torch.Tensor):
        return float(leaf)
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    return float(leaf.detach().reshape(-1)[0])


def time_amortized(f, *args, reps: int = 100) -> float:
    """Milliseconds per call of ``f(*args)``: one warm-up call, ``reps``
    timed calls, closed by a :func:`fetch_barrier` on the final result so
    that the whole burst has run (not only been enqueued)."""
    fetch_barrier(f(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        r = f(*args)
    fetch_barrier(r)
    return (time.perf_counter() - t0) / reps * 1e3
