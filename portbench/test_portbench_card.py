"""On the card, at the published widths and a reduced traffic: each cell's
sound program passes its limits, and its control, the reference with fp8
convolutions in the program's place, fails at least one of them.  Skips
without a card.  ``calibrate.py`` makes the same readings at the cells'
own sizes, over more seeds."""

import dataclasses
import shutil
import tempfile

import pytest
import torch

from portbench import cells, run as harness

SEEDS = (5, 2 ** 31 + 3, 4_000_000_011)
# the traffic cut by driver: (configuration's data scale, parameters)
SMALL = {"train_loop": (dict(train_songs=4, train_song_seconds=30.0), {}),
         "stream_decode": (dict(catalogue_songs=2),
                           dict(song_seconds=60.0, burst=2,
                                check_sample=2))}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  cells.benchmark()["workloads"]])
def test_program_passes_and_control_fails(card, name):
    cell = cells.load_cell(name)
    scale, params = SMALL[cell.driver]
    cell = dataclasses.replace(cell, config=dict(cell.config, **scale),
                               params=dict(cell.params, **params))
    drv = cells.driver_module(cell.driver)
    for seed in SEEDS:
        tmp = tempfile.mkdtemp(prefix="portbench-card-")
        ctx = harness.Context(cell, cell.config,
                              harness.svs_config(cell.config), seed, card,
                              tmp)
        driver = drv.Driver(ctx)
        try:
            driver.setup()
            driver.window(0.5)
            driver.release()
            program, control = driver.check(), driver.control()
        finally:
            driver.close()
            shutil.rmtree(tmp, ignore_errors=True)
        assert all(program[k] <= cell.limits[k] for k in cell.limits), \
            (seed, program)
        assert any(control[k] > cell.limits[k] for k in cell.limits), \
            (seed, control)
