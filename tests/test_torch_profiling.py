"""The port's profiling module (svs_torch/utils/profiling.py) on the CPU:
its spans, untraced ledger, registry, phase clocks (and their turning off
where the card's kernel cannot run) and counters, and the program's spans
and marks on the CPU."""

import contextlib
import glob
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from svs_torch.data import device_data as tdd
from svs_torch.data.dataset import PatchDataset
from svs_torch.infer import graphs as infer_graphs
from svs_torch.infer import separate as tsep
from svs_torch.models.unet import UNet
from svs_torch.train import graphs as train_graphs
from svs_torch.train import step as tstep
from svs_torch.utils import profiling
from svs_torch.utils.config import SVSConfig

NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16), mr_mag_impl="fft",
              input_len=128)
CPU = [torch.profiler.ProfilerActivity.CPU]
TRAIN_PHASES = ("train.unet_fwd", "train.loss_fwd", "train.loss_bwd",
                "train.unet_bwd", "train.optimizer")
DECODE_PHASES = ("decode.stft", "decode.unet", "decode.istft")


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def routed(monkeypatch):
    """The decode and train entry points on the CPU through fresh caches
    of programs (as tests/test_torch_decode_graph.py and
    test_torch_step_graph.py route them)."""
    decode = infer_graphs.ProgramCache()
    train = infer_graphs.ProgramCache(train_graphs.MAX_BYTES)
    monkeypatch.setattr(tsep, "_programmed", lambda dev: True)
    monkeypatch.setattr(infer_graphs, "CACHE", decode)
    monkeypatch.setattr(train_graphs, "programmed", lambda dev: True)
    monkeypatch.setattr(train_graphs, "CACHE", train)
    return decode, train


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two songs of spectrogram pairs, 300 and 200 frames."""
    root = str(tmp_path_factory.mktemp("spans"))
    rng = np.random.default_rng(0)
    for folder in ("mixture", "vocal"):
        os.makedirs(os.path.join(root, folder))
        for i, t in enumerate((300, 200)):
            base = os.path.join(root, folder, f"{i:04d}_s{i}")
            np.save(f"{base}_spec.npy",
                    rng.random((513, t)).astype(np.float32))
            np.save(f"{base}_phase.npy", np.exp(1j * rng.uniform(
                -3, 3, (513, t))).astype(np.complex64))
    host = PatchDataset(root, samples_per_song=2, input_len=128)
    return tdd.DeviceDataset(host, device="cpu")


def _song(seconds=1.5, sr=8192):
    rng = np.random.default_rng(1)
    return (rng.standard_normal(int(sr * seconds)) * 0.1).astype(np.float32)


def _model():
    torch.manual_seed(0)
    return UNet(SVSConfig(**NARROW)).eval()


def test_annotate_records_nothing_without_a_profiler():
    span = profiling.annotate("svs.test.off")
    with span:
        time.sleep(0.001)
    # the one shared no-op: no record_function, no clock read
    assert span is profiling.annotate("svs.test.other")
    assert profiling.snapshot()["spans"] == {}


def test_always_spans_go_to_the_untraced_ledger_alone():
    """With no profiler an ``always`` span adds its count and seconds to the
    ``host`` ledger (a plain span adds nothing); under the profiler both
    are spans, and the ledger is left as it was."""
    for _ in range(3):
        with profiling.annotate("svs.test.timed", always=True):
            with profiling.annotate("svs.test.plain"):
                time.sleep(0.001)
    snap = profiling.snapshot()
    assert snap["spans"] == {}
    assert list(snap["host"]) == ["svs.test.timed"]
    timed = snap["host"]["svs.test.timed"]
    assert timed["count"] == 3 and timed["total_s"] >= 0.003
    with torch.profiler.profile(activities=CPU):
        with profiling.annotate("svs.test.timed", always=True):
            with profiling.annotate("svs.test.plain"):
                pass
    snap = profiling.snapshot()
    assert snap["host"] == {"svs.test.timed": timed}
    assert {n: s["count"] for n, s in snap["spans"].items()} == {
        "svs.test.timed": 1, "svs.test.plain": 1}
    profiling.reset()
    assert profiling.snapshot()["host"] == {}


def test_spans_count_total_and_self_time_under_the_profiler():
    with torch.profiler.profile(activities=CPU):
        for _ in range(2):
            with profiling.annotate("svs.test.outer"):
                time.sleep(0.002)
                for _ in range(2):
                    with profiling.annotate("svs.test.inner"):
                        time.sleep(0.001)
    spans = profiling.snapshot()["spans"]
    outer, inner = spans["svs.test.outer"], spans["svs.test.inner"]
    assert outer["count"] == 2 and inner["count"] == 4
    assert inner["self_s"] == pytest.approx(inner["total_s"], rel=1e-12)
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"], rel=1e-9)
    assert outer["self_s"] >= 0.004 and inner["total_s"] >= 0.004
    profiling.reset()
    assert profiling.snapshot()["spans"] == {}


def test_span_stacks_are_per_thread():
    """One thread's child span never counts as another thread's child: the
    solo span stays open while the other thread opens and closes its
    child."""
    both = threading.Barrier(2, timeout=10)

    def nested():
        with profiling.annotate("svs.test.outer"):
            both.wait()
            with profiling.annotate("svs.test.inner"):
                time.sleep(0.003)
            both.wait()

    def solo():
        with profiling.annotate("svs.test.solo"):
            both.wait()
            time.sleep(0.006)
            both.wait()

    with torch.profiler.profile(activities=CPU):
        threads = [threading.Thread(target=f) for f in (nested, solo)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
    spans = profiling.snapshot()["spans"]
    assert {n: s["count"] for n, s in spans.items()} == {
        "svs.test.outer": 1, "svs.test.inner": 1, "svs.test.solo": 1}
    solo_s, outer = spans["svs.test.solo"], spans["svs.test.outer"]
    assert solo_s["self_s"] == solo_s["total_s"] >= 0.006
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - spans["svs.test.inner"]["total_s"], rel=1e-9)


def test_the_programs_spans_are_in_the_written_trace(tmp_path, routed,
                                                     dataset):
    cfg = SVSConfig(**NARROW)
    state = tstep.create_train_state(0, cfg, device="cpu")
    step = tstep.make_train_step(cfg)
    gen = torch.Generator().manual_seed(3)
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        for batch in dataset.batches(2, seed=0, n_steps=2):
            state, _ = step(state, batch, gen)
        tsep.separate_wav_stream(_model(), [_song()], device="cpu")
    (path,) = glob.glob(os.path.join(d, "*.json"))
    with open(path) as f:
        text = f.read()
    for name in ("svs.train.feed", "svs.train.feed.wait", "svs.train.step",
                 "svs.program.build", "svs.decode.call"):
        assert f'"{name}"' in text, name
    spans = profiling.snapshot()["spans"]
    assert spans["svs.train.feed"]["count"] == 3  # and the epoch's end
    assert spans["svs.train.feed.wait"]["count"] == 4  # songs, starts
    assert spans["svs.train.step"]["count"] == 2
    assert spans["svs.decode.call"]["count"] == 1


def test_mark_on_the_cpu_adds_and_counts_and_begin_adds_nothing(
        monkeypatch):
    clock = iter([100, 150, 400, 1000, 1010, 1030, 5000])
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: next(clock))
    for phase in ("begin", "t.a", "t.b", "begin", "t.a", "t.b"):
        profiling.mark(phase, "cpu")
    assert profiling.snapshot()["phases"] == {"cpu": {
        "t.a": {"count": 2, "s": 60e-9}, "t.b": {"count": 2, "s": 270e-9}}}
    profiling.mark("t.a", "cpu")  # 5000 - 1030 since the last mark
    assert profiling.snapshot()["phases"]["cpu"]["t.a"] == {
        "count": 3, "s": 4030e-9}
    profiling.reset()
    assert profiling.snapshot()["phases"] == {"cpu": {}}


def _no_nvcc():
    raise RuntimeError("nvcc not found")


@pytest.fixture
def card_off(monkeypatch):
    """A card as ``mark`` sees it, on the CPU: an H100 (sm_90) outside any
    capture, the clocks on, and a kernel that cannot be built (this
    machine has no ``nvcc``), so nothing is ever launched."""
    monkeypatch.setattr(profiling, "_off", None)
    monkeypatch.setattr(profiling, "_clocks", {})
    monkeypatch.setattr(profiling, "_kernel", _no_nvcc)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d=None: (9, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    return monkeypatch


@pytest.mark.parametrize("why", ["sm_80", "no_nvcc", "in_capture"])
def test_the_card_clocks_turn_off_with_one_warning(card_off, why):
    """Where the clock kernel cannot run, the first mark on the card turns
    the card's clocks off with one warning; later marks do nothing, the
    card reads no phases, and the host's clocks go on."""
    expect = {"sm_80": "is not sm_90", "no_nvcc": "nvcc not found",
              "in_capture": "inside a CUDA graph capture"}[why]
    if why == "sm_80":
        card_off.setattr(torch.cuda, "get_device_capability",
                         lambda d=None: (8, 0))
    elif why == "in_capture":
        card_off.setattr(torch.cuda, "is_current_stream_capturing",
                         lambda: True)
    with pytest.warns(RuntimeWarning, match=expect):
        profiling.mark(profiling.BEGIN, "cuda:0")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for phase in ("t.a", profiling.BEGIN, "t.a"):
            profiling.mark(phase, "cuda:0")
        profiling.mark(profiling.BEGIN, "cpu")
        profiling.mark("t.a", "cpu")
    phases = profiling.snapshot()["phases"]
    assert "cuda" not in phases and phases["cpu"]["t.a"]["count"] == 1


def test_a_train_step_marks_its_five_phases_once_a_step(dataset):
    cfg = SVSConfig(**NARROW)
    state = tstep.create_train_state(0, cfg, device="cpu")
    step = tstep.make_step_fn(cfg)
    gen = torch.Generator().manual_seed(3)
    for batch in dataset.batches(2, seed=0, n_steps=3):
        state, _ = step(state, batch, gen)
    phases = profiling.snapshot()["phases"]["cpu"]
    assert sorted(phases) == sorted(TRAIN_PHASES)
    assert all(p["count"] == 3 and p["s"] > 0 for p in phases.values())


def test_a_decode_marks_its_three_phases_once_a_song():
    tsep.separate_wav_stream(_model(), [_song(), _song(1.0)], device="cpu",
                             pcm16=False)
    phases = profiling.snapshot()["phases"]["cpu"]
    assert sorted(phases) == sorted(DECODE_PHASES)
    assert all(p["count"] == 2 and p["s"] > 0 for p in phases.values())


@pytest.mark.parametrize("kind", ["decode", "train"])
def test_a_second_call_of_a_cached_program_adds_no_builds(routed, dataset,
                                                          kind):
    decode, train = routed

    def counters():
        return profiling.snapshot()["counters"]

    if kind == "decode":
        model, song = _model(), (_song() * 32767).astype(np.int16)

        def call():
            tsep.separate_wav_stream(model, [song], pcm16=True,
                                     device="cpu")
    else:
        cfg = SVSConfig(**NARROW)
        state = tstep.create_train_state(0, cfg, device="cpu")
        step = tstep.make_train_step(cfg)
        feed = dataset.batches(2, seed=0, n_steps=3)

        def call():
            step(state, next(feed), torch.Generator().manual_seed(3))

    before = counters()
    call()
    first = counters()
    call()
    second = counters()
    assert first["program.builds"] == before["program.builds"] + 1
    assert first["program.build_s"] > before["program.build_s"]
    assert second == first
    assert (decode if kind == "decode" else train).builds == 1


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


def test_fetch_barrier_and_time_amortized():
    v = profiling.fetch_barrier(
        {"a": torch.arange(6.0).reshape(2, 3) + 7.0})
    assert isinstance(v, float) and v == 7.0
    assert profiling.fetch_barrier(torch.tensor(3.5)) == 3.5
    assert profiling.fetch_barrier((torch.tensor([1.5, 2.0]), None)) == 1.5

    ms = profiling.time_amortized(lambda x: x * 2, torch.ones(4), reps=5)
    assert isinstance(ms, float) and ms >= 0.0
    assert np.isfinite(ms)
