"""The benchmark's readers of the port's profiling registry
(``portbench/metrics/``) on made-up snapshots: each reads its number, and
returns None where there is nothing to read (no busy card in the trace,
phases on the host's clock alone, an empty registry, a program without
one)."""

import pytest

from portbench import cells
from svs_torch.utils import profiling

SNAPSHOT = {
    # under the profiler: the traced window's spans, which no reader uses
    "spans": {
        "svs.train.step": {"count": 4, "total_s": 0.090, "self_s": 0.020},
        "svs.train.feed": {"count": 4, "total_s": 0.050, "self_s": 0.010},
        "svs.decode.call": {"count": 1, "total_s": 0.900, "self_s": 0.1}},
    # outside it: two set-up steps, one a build, and ten of the window's
    "host": {
        "svs.train.step": {"count": 12, "total_s": 3.036},
        "svs.train.feed": {"count": 13, "total_s": 0.050},
        "svs.train.feed.wait": {"count": 24, "total_s": 0.040},
        "svs.program.build": {"count": 2, "total_s": 2.5},
        "svs.decode.call": {"count": 2, "total_s": 2.900},
        "svs.decode.collect.wait": {"count": 16, "total_s": 0.300}},
    "phases": {"cuda": {
        "train.loss_fwd": {"count": 100, "s": 0.5},
        "train.loss_bwd": {"count": 100, "s": 0.7},
        "train.unet_fwd": {"count": 100, "s": 0.3},
        "decode.unet": {"count": 50, "s": 0.9}}},
    "counters": {"program.builds": 2, "program.evictions": 0,
                 "program.build_s": 2.5},
}
WINDOWS = {"train": {"attempted": 10, "patches": 320},
           "decode": {"attempted": 8, "songs": 8}}
READERS = [
    # (metric, window, the value from SNAPSHOT by hand)
    ("loss_ms_per_patch.train", "train", 1e3 * (0.005 + 0.007) / 32),
    ("loss_ms_per_patch.train.fine_tune", "train",
     1e3 * (0.005 + 0.007) / 32),
    ("host_ms_per_step.train", "train",
     1e3 * (3.036 + 0.050 - 0.040 - 2.5) / 12),
    ("unet_ms_per_song.decode", "decode", 1e3 * 0.9 / 50),
    ("host_ms_per_song.decode", "decode",
     1e3 * (2.900 - 0.300 - 2.5) / 16),
]


@pytest.mark.parametrize("name,window,want", READERS,
                         ids=[r[0] for r in READERS])
def test_the_registrys_readers_on_a_made_up_snapshot(monkeypatch, name,
                                                     window, want):
    read = cells.metric_reader(name)
    readings = {"trace": {"busy_s": 2.5, "window_s": 3.0}, "window": {},
                "traced_window": WINDOWS[window], "peak_flops": None}
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAPSHOT)
    assert read(readings) == pytest.approx(want, rel=1e-12)
    # nothing of the card's: no busy card in the trace (a CPU run), phases
    # on the host's clock alone
    idle = dict(readings, trace={"busy_s": 0.0, "window_s": 3.0})
    assert read(idle) is None
    host = dict(SNAPSHOT, phases={"cpu": SNAPSHOT["phases"]["cuda"]})
    monkeypatch.setattr(profiling, "snapshot", lambda: host)
    assert read(readings) is None or name.startswith("host_")
    # nothing to read: an empty registry, then a program without one (the
    # parent of the registry), where the reader returns None
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"spans": {}, "phases": {}, "counters": {}})
    assert read(readings) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert read(readings) is None
