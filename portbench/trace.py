"""The traced window: a ``torch.profiler`` trace of the host and the card
around the driver's window, reduced to what the per-layer metrics read.

- ``window_s``: the ``portbench.window`` span, which the harness opens
  around the driver's window (it ends with the card synchronised);
- ``busy_s``: the union of the card's kernel, copy and set intervals inside
  that span;
- ``families``: device seconds by family of operation (kernel names sorted
  into families by :data:`FAMILIES`, first match wins);
- ``idle``: the gaps between busy intervals, summed by what the host was
  doing at each gap's middle (the innermost host event open then).

Spans of the harness's own files (``portbench.*``) mark the calls into
the program; the program adds none of its own yet.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import re
from typing import Dict, List, Tuple

import torch

WINDOW = "portbench.window"

# (family, pattern over the device operation's name); first match wins
FAMILIES: List[Tuple[str, re.Pattern]] = [
    ("copy", re.compile(r"^Mem(cpy|set)")),
    ("conv", re.compile(r"(?i)conv|fprop|dgrad|wgrad|implicit_gemm|cudnn|"
                        r"nchwtonhwc|nhwctonchw")),
    ("gemm", re.compile(r"(?i)gemm|nvjet|cutlass|cublas")),
    ("fft", re.compile(r"(?i)fft")),
    ("optimizer", re.compile(r"(?i)multi_tensor|adam")),
    ("reduce", re.compile(r"(?i)reduce|norm|softmax")),
    ("elementwise", re.compile(r"(?i)elementwise|vectorized|unrolled|"
                               r"index|copy|cat|fill|where|pow|sqrt")),
]


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if pat.search(name):
            return fam
    return "other"


@contextlib.contextmanager
def span(name: str):
    """A named host span in the trace (``portbench.<name>``)."""
    with torch.profiler.record_function(f"portbench.{name}"):
        yield


def sync(device: torch.device) -> None:
    """Wait for the card (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Traced:
    """``with Traced() as t: with t.window(): ...``; then ``t.reduce()``."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def window(self):
        return span("window")

    def reduce(self) -> Dict:
        events = self.prof.profiler.kineto_results.events()
        return reduce_events(
            [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
              e.device_type() != torch.autograd.DeviceType.CPU)
             for e in events if _kept(e)])


def _kept(e) -> bool:
    """The card's kernels, copies and sets, and the host's events; not the
    card's mirror of a host span (named as the span), which covers the
    span's kernels and is no work of its own."""
    return not (e.device_type() != torch.autograd.DeviceType.CPU
                and e.name().startswith("portbench."))


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events: List[Tuple[str, int, int, bool]]) -> Dict:
    """``events``: (name, start ns, end ns, on the device).  Returns
    ``window_s``, ``busy_s``, ``families`` (seconds), ``kernels`` (device
    seconds by name) and ``idle`` (seconds by host activity); an empty
    dict where the trace holds no window span."""
    win = [(a, b) for n, a, b, dev in events if not dev and n == WINDOW]
    if not win:
        return {}
    w0, w1 = win[0]
    fams: Dict[str, float] = collections.Counter()
    kernels: Dict[str, float] = collections.Counter()
    busy: List[Tuple[int, int]] = []
    host: List[Tuple[int, int, str]] = []
    for name, a, b, dev in events:
        if b <= w0 or a >= w1:
            continue
        if dev:
            a, b = max(a, w0), min(b, w1)
            busy.append((a, b))
            fams[family(name)] += (b - a) * 1e-9
            kernels[name] += (b - a) * 1e-9
        elif name != WINDOW:
            host.append((a, b, name))
    merged = _union(busy)
    gaps, prev = [], w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(b - a for a, b in merged) * 1e-9,
        "families": dict(fams),
        "kernels": dict(kernels),
        "idle": _name_gaps(gaps, host),
    }


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost host event open at each gap's middle
    ("no host event" where none is)."""
    host.sort()
    starts = [a for a, _, _ in host]
    out: Dict[str, float] = collections.Counter()
    active: List[Tuple[int, int, str]] = []
    i = 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) // 2
        j = bisect.bisect_right(starts, mid)
        active.extend(host[i:j])
        i = max(i, j)
        active = [e for e in active if e[1] > mid]
        name = max(active)[2] if active else "no host event"
        out[name] += (g1 - g0) * 1e-9
    return dict(out)


def breakdown(reduced: Dict, top: int = 10) -> Dict:
    """The result line's ``breakdown``: device seconds by family and idle
    seconds by host activity, largest first, ``top`` of each."""
    def largest(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]
    return {"device_ops": largest(reduced.get("families", {})),
            "idle_gaps": largest(reduced.get("idle", {}))}
