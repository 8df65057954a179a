"""A tiny configuration and tiny traffic for the CPU tests: the harness's
plumbing, the reference against the program, and the faults that
``correct`` has to catch, in seconds on the host.  Never a benchmark
cell: the widths are cut."""

from __future__ import annotations

import dataclasses
import json
import os

from portbench import cells

CONFIG_CHANGES = dict(
    window_size=128, hop_size=32, sample_rate=8192, input_len=64,
    freq_bins=64, samples_per_song=4, enc_channels=[2, 4, 4, 8, 8, 8],
    mr_fft_sizes=[128, 256, 64], mr_hop_sizes=[16, 32, 8],
    mr_win_lengths=[64, 128, 32], compute_dtype="float32",
    mr_mag_impl="fft", train_songs=4, train_song_seconds=2.0,
    catalogue_songs=4)


def config(name: str = "default") -> dict:
    with open(os.path.join(cells.HERE, "configs", f"{name}.json")) as f:
        return dict(json.load(f), **CONFIG_CHANGES)


def cell(name: str) -> cells.Cell:
    """The cell ``name`` with its traffic cut to a few 2-s songs (the
    number of songs is the tiny configuration's)."""
    c = cells.load_cell(name)
    p = dict(c.params)
    if c.driver == "train_loop":
        p.update(batch=4)
    else:
        p.update(song_seconds=2.0, burst=4, check_sample=4)
    return dataclasses.replace(c, params=p, trace_seconds=0.5)
