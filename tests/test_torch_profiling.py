"""The port's profiling module (svs_torch/utils/profiling.py), mirroring
tests/test_profiling.py on the CPU."""

import os
import time

import numpy as np
import pytest
import torch

from svs_torch.utils import profiling


def test_step_timer_summary():
    t = profiling.StepTimer(warmup=1, device="cpu")
    for _ in range(5):
        with t.step():
            time.sleep(0.002)
    s = t.summary()
    assert s["steps"] == 4
    assert 1.0 < s["mean_ms"] < 100.0
    assert s["p50_ms"] <= s["p90_ms"] <= s["max_ms"]


def test_step_timer_empty():
    assert profiling.StepTimer().summary() == {"steps": 0}


def test_debug_nans_catches_a_forward_op():
    x = torch.tensor(-1.0)
    with profiling.debug_nans():
        torch.exp(x)  # finite: no error
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(x)
    # restored afterwards: nan flows silently again
    assert torch.isnan(torch.log(x))
    with profiling.debug_nans(enable=False):
        assert torch.isnan(torch.log(x))


def test_debug_nans_catches_a_backward_op():
    x = torch.tensor([0.0], requires_grad=True)
    y = torch.sqrt(x) * 0.0  # forward finite; d/dx sqrt at 0 is inf, * 0 NaN
    with profiling.debug_nans():
        with pytest.raises(FloatingPointError):
            y.sum().backward()


def test_trace_writes_files(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        with profiling.annotate("phase"):
            (torch.arange(8) * 2).sum()
    found = []
    for _, _, files in os.walk(d):
        found += files
    assert found  # the profiler wrote a trace


def test_annotate_noop_smoke():
    with profiling.annotate("phase"):
        assert float((torch.ones(4) + 1).sum()) == 8.0


def test_device_memory_stats_is_empty_on_the_cpu():
    assert profiling.device_memory_stats("cpu") == {}


def test_fetch_barrier_and_time_amortized():
    v = profiling.fetch_barrier(
        {"a": torch.arange(6.0).reshape(2, 3) + 7.0})
    assert isinstance(v, float) and v == 7.0
    assert profiling.fetch_barrier(torch.tensor(3.5)) == 3.5
    assert profiling.fetch_barrier((torch.tensor([1.5, 2.0]), None)) == 1.5

    ms = profiling.time_amortized(lambda x: x * 2, torch.ones(4), reps=5)
    assert isinstance(ms, float) and ms >= 0.0
    assert np.isfinite(ms)
