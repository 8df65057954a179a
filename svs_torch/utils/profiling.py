"""Tracing, timing and numerics debugging (port of
``svs_tpu/utils/profiling.py``).

- :func:`trace` — a ``torch.profiler`` trace of the CPU and (where there is
  one) the CUDA device, written for TensorBoard by
  ``tensorboard_trace_handler``
- :func:`annotate` — a named span in that trace
  (``torch.profiler.record_function``)
- :func:`debug_nans` — scoped NaN checking: the first aten op whose floating
  output holds a NaN raises ``FloatingPointError`` naming the op, forward
  and backward alike (``torch.autograd.detect_anomaly`` checks the backward
  only)
- :class:`StepTimer` — per-step wall time with warm-up discard
- :func:`device_memory_stats`, :func:`fetch_barrier`,
  :func:`time_amortized` — the memory counters, the timing barrier and the
  amortised timer that the benchmarks use
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from svs_torch.utils.device import DeviceLike


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


@contextlib.contextmanager
def annotate(name: str):
    with torch.profiler.record_function(name):
        yield


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


class StepTimer:
    """Wall-clock step timing with compile-warmup discard.

    With a CUDA ``device`` each step ends with a synchronise of that device,
    so a step's time is its device work and not only its enqueue (the
    counterpart of the value fetch that svs_tpu's StepTimer asks for).

    >>> t = StepTimer(warmup=1, device="cuda")
    >>> for batch in batches:
    ...     with t.step():
    ...         state, aux = train_step(state, batch, gen)
    >>> t.summary()   # {'steps': ..., 'mean_ms': ..., 'p50_ms': ...}
    """

    def __init__(self, warmup: int = 1, device: DeviceLike = None):
        self.warmup = warmup
        self.device = None if device is None else torch.device(device)
        self._all: List[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._all.append(time.perf_counter() - t0)

    @property
    def times(self) -> List[float]:
        return self._all[self.warmup:]

    def summary(self) -> Dict[str, float]:
        ts = self.times
        if not ts:
            return {"steps": 0}
        ms = sorted(t * 1e3 for t in ts)
        return {
            "steps": len(ms),
            "mean_ms": statistics.fmean(ms),
            "p50_ms": ms[len(ms) // 2],
            "p90_ms": ms[int(len(ms) * 0.9)],
            "max_ms": ms[-1],
        }


def device_memory_stats(device: DeviceLike = None) -> Dict:
    """Live and peak bytes of PyTorch's allocator on a CUDA device and the
    device's total memory, under svs_tpu's three keys; ``{}`` on the CPU
    (or with no CUDA device)."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.mem_get_info(device)[1]),
    }


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
