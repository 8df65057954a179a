"""A whole run of each kind of cell on the CPU at a tiny size, past the
harness's look for a card: sound, it comes out correct; with the timed path
broken underneath, it comes out not correct.  The faults are those each
cell can have on one card: a step that leaves its state unchanged, half of
the batch left out (the mean taken over the rest), and an answer altered
where it is produced."""

import time

import numpy as np
import pytest
import torch

from portbench import cells, run as harness, tiny, trace

SEED = 2 ** 31 + 77


def _run(name, traced=False):
    return harness.run(tiny.cell(name), cells.benchmark(), SEED, 0.5,
                       traced, torch.device("cpu"), config=tiny.config(),
                       t_start=time.perf_counter())


@pytest.mark.parametrize("name", ["train-default-b32", "train-ft-b32",
                                  "decode-ft-stream"])
def test_a_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["compared"]
    assert list(out)[-1] == "compared"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {
        m["name"] for m in cells.metrics_for(name, cells.benchmark(),
                                             "end_to_end")}


def test_the_reference_follows_the_feed_across_epochs():
    # 2 songs x 4 patches: an epoch is 2 batches, shorter than the 3 steps
    # the reference follows
    out = harness.run(tiny.cell("train-default-b32"), cells.benchmark(),
                      SEED, 0.3, False, torch.device("cpu"),
                      config=dict(tiny.config(), train_songs=2),
                      t_start=time.perf_counter())
    assert out["correct"], out["compared"]


def test_a_traced_run_reads_its_per_layer_metrics():
    out = _run("decode-ft-stream", traced=True)
    assert out["correct"]
    # no kernels and no peak on the CPU: the readers of the card's
    # metrics find nothing, the idle share reads the whole window
    assert out["metrics"] == {"idle_pct.decode": {"value": 100.0,
                                                  "unit": "%"}}
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _frozen(make):
    """A train step that runs and then puts the parameters back."""
    def make_frozen(cfg):
        real = make(cfg)

        def step(state, batch, gen):
            saved = [p.detach().clone() for p in state.model.parameters()]
            state, aux = real(state, batch, gen)
            with torch.no_grad():
                for p, s in zip(state.model.parameters(), saved):
                    p.copy_(s)
            return state, aux
        return step
    return make_frozen


def _half(make):
    """A train step that leaves out half of the batch."""
    def make_half(cfg):
        real = make(cfg)

        def step(state, batch, gen):
            n = len(batch["mix"]) // 2
            return real(state, {k: v[:n] for k, v in batch.items()}, gen)
        return step
    return make_half


def _half_in_replays(make):
    """A train step whose first call (the program's eager warm-up) is
    sound and whose later calls (its replays) leave out half of the
    batch."""
    def make_half(cfg):
        real, calls = make(cfg), []

        def step(state, batch, gen):
            calls.append(1)
            if len(calls) > 1:
                n = len(batch["mix"]) // 2
                batch = {k: v[:n] for k, v in batch.items()}
            return real(state, batch, gen)
        return step
    return make_half


@pytest.mark.parametrize("fault", [_frozen, _half, _half_in_replays])
def test_a_broken_train_step_is_not_correct(monkeypatch, fault):
    from svs_torch.train import step
    monkeypatch.setattr(step, "make_train_step",
                        fault(step.make_train_step))
    out = _run("train-default-b32")
    assert not out["correct"]
    if fault is _half_in_replays:  # the first step is sound
        compared = out["compared"]
        assert compared["grad_gap_median"]["value"] < 1e-3
        assert compared["replay_grad_gap_median"]["value"] > \
            compared["replay_grad_gap_median"]["limit"]


@pytest.mark.parametrize("name", ["decode-ft-stream"])
def test_an_altered_answer_is_not_correct(monkeypatch, name):
    from svs_torch.infer import separate
    real = separate.separate_wav_stream

    def altered(*args, **kwargs):
        outs = real(*args, **kwargs)
        for out in outs:  # one stretch of each song silenced
            out[len(out) // 2: len(out) // 2 + len(out) // 10] = 0
        return outs
    monkeypatch.setattr(separate, "separate_wav_stream", altered)
    assert not _run(name)["correct"]


def test_idle_gaps_are_named_by_the_host_event_open_across_them():
    ms = 1_000_000
    events = [("portbench.window", 0, 100 * ms, False),
              ("portbench.step", 0, 50 * ms, False),
              ("cudaStreamSynchronize", 60 * ms, 90 * ms, False),
              ("kernel_a", 10 * ms, 40 * ms, True),
              ("kernel_b", 30 * ms, 60 * ms, True),
              ("Memcpy HtoD", 90 * ms, 95 * ms, True)]
    r = trace.reduce_events(events)
    assert r["window_s"] == pytest.approx(0.1)
    assert r["busy_s"] == pytest.approx(0.055)
    assert r["families"]["copy"] == pytest.approx(0.005)
    assert r["idle"] == pytest.approx({"portbench.step": 0.010,
                                       "cudaStreamSynchronize": 0.030,
                                       "no host event": 0.005})


def test_block_error_sees_a_local_fault_that_the_song_hides():
    from portbench import compare
    rng = np.random.default_rng(0)
    ref = rng.standard_normal(100_000)
    bad = ref.copy()
    bad[:1000] = 0
    assert compare.block_error(ref, ref, 1000) == 0
    assert compare.block_error(bad, ref, 1000) == pytest.approx(1.0, rel=0.1)
    assert compare.block_error(bad[:-1], ref, 1000) == float("inf")
