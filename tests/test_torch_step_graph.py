"""The train and eval steps' cached programs (``svs_torch/train/graphs.py``)
on the CPU.

On the card ``make_train_step`` and ``make_eval_step`` run a cached
captured program per key.  Here they are routed through the same program
objects (the ``routed`` fixture patches ``graphs.programmed``), whose
capture and replay run the body on the CPU, so the key, the binding, the
warm-up step, the static buffers, the copies in and out and the host's
step and cycle counts all run.  Narrow U-Net (``enc_channels=(4, 8, 8, 16,
16, 16)``), 128-frame patches, float32, ``mr_mag_impl='fft'``;
numpy-seeded batches.  Tolerances:
- against svs_tpu's jitted steps (the same weights through
  ``torch_import.state_dict_from_jax``, no dropout: the two packages draw
  different masks): tests/test_torch_step.py's ``_check_step`` bounds,
  every loss <= 1e-5 relative, ``grad_norm`` <= 1e-3 relative, BN running
  statistics < 1e-4; the parameters within that file's envelope for each
  Adam update taken (max |d| <= 2.1 lr a update, mean |d| < 2e-4); the
  eval step's losses 1e-5 relative (test_torch_step.py's);
- against the port's eager body (``make_step_fn``, ``make_eval_fn``): the
  same bits, as the body is what the program runs.
"""

import copy
import dataclasses

import numpy as np
import pytest
import threadpoolctl
import torch

import jax
import jax.numpy as jnp

from svs_torch.models import torch_import as t_import
from svs_torch.train import checkpoint as ckpt
from svs_torch.train import graphs
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig

NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16), mr_mag_impl="fft",
              input_len=128)
LR2 = 5e-4  # the learning rate after the change


@pytest.fixture(autouse=True)
def one_thread():
    """One OpenMP thread while a case runs (Tier-1 runs six files at once
    on eight cores); threadpoolctl, not ``torch.set_num_threads``."""
    with threadpoolctl.threadpool_limits(1, user_api="openmp"):
        yield


@pytest.fixture
def routed(monkeypatch):
    """The entry points on the CPU through a fresh cache of programs."""
    cache = graphs.infer_graphs.ProgramCache(graphs.MAX_BYTES)
    monkeypatch.setattr(graphs, "programmed", lambda dev: True)
    monkeypatch.setattr(graphs, "CACHE", cache)
    return cache


def _batch(seed, b=2, weight=False):
    rng = np.random.default_rng(seed)
    shape = (b, 512, NARROW["input_len"])
    mix = rng.random(shape).astype(np.float32)
    out = {"mix": mix, "voc": (mix * rng.random(shape)).astype(np.float32),
           "mix_angle": rng.uniform(-np.pi, np.pi, shape).astype(np.float32),
           "voc_angle": rng.uniform(-np.pi, np.pi, shape).astype(np.float32)}
    if weight:  # a padded batch: its last row is padding
        out["weight"] = np.r_[np.ones(b - 1), 0.0].astype(np.float32)
    return out


def _states(accum=1, dropout=0.5, n=2):
    cfg = TConfig(**NARROW, dropout_rate=dropout)
    return cfg, [tstep.create_train_state(
        0, cfg, tstep.make_optimizer(cfg, accum), device="cpu")
        for _ in range(n)]


def _tensors(state):
    """Every tensor of the state: parameters, BN buffers, Adam's moments
    and counts, the accumulation buffers."""
    out = list(state.model.state_dict().values())
    for st in state.optimizer.state.values():
        out += [v for _, v in sorted(st.items())]
    return out + list(state.acc_buffers or ())


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))


# the run both sides take: (batch seed, batch size, weighted, lr before it)
RUN = ((0, 2, False, None), (1, 2, False, None), (2, 2, True, None),
       (3, 1, False, None), (4, 2, False, LR2), (5, 2, False, None),
       (6, 1, False, None))


def test_programs_are_the_eager_bodys_bits(routed):
    """Seven calls (a weighted batch, a ragged tail, an LR change, dropout
    on, accumulation over 2) leave the state of seven eager steps, with
    the same metrics, and the eval programs give the eager eval's."""
    cfg, (eager, prog) = _states(accum=2)
    eager_step, prog_step = tstep.make_step_fn(cfg), tstep.make_train_step(cfg)
    ge, gp = (torch.Generator().manual_seed(3) for _ in range(2))
    for seed, b, weight, lr in RUN:
        if lr is not None:
            tstep.set_learning_rate(eager, lr)
            tstep.set_learning_rate(prog, lr)
        batch = tstep.batch_to_device(_batch(seed, b, weight), "cpu")
        eager, want = eager_step(eager, batch, ge)
        prog, got = prog_step(prog, batch, gp)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (seed, k)
        assert (prog.step, prog.mini_step) == (eager.step, eager.mini_step)
    assert prog.step == len(RUN) and _same(prog, eager)
    assert ge.get_state().equal(gp.get_state())
    # one program per signature: full, weighted, tail
    assert len(routed) == 3 and routed.builds == 3
    for b in (2, 1):
        batch = tstep.batch_to_device(_batch(9, b), "cpu")
        want = tstep.make_eval_fn(cfg)(eager, batch)
        got = tstep.make_eval_step(cfg)(prog, batch)
        for k in want:
            assert torch.equal(got[k], want[k]), (b, k)
    assert len(routed) == 5


def _jax_pair(accum):
    jcfg = JConfig(**NARROW, dropout_rate=0.0)
    jopt = jstep.make_optimizer(jcfg, accum)
    jstate = jstep.create_train_state(jax.random.key(0), jcfg, jopt)
    cfg, (state,) = _states(accum, dropout=0.0, n=1)
    state.model.load_state_dict(t_import.state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.bn_state)))
    return jcfg, jopt, jstate, cfg, state


def _state_deltas(jstate, state):
    """BN running statistics' max |d|, and the parameters' max and mean
    |d|, of the port's state against svs_tpu's."""
    got, want = state.model.state_dict(), t_import.state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.bn_state))
    bn, params = 0.0, []
    for k, w in want.items():
        d = (got[k] - w).abs()
        if "running" in k:
            bn = max(bn, float(d.max()))
        elif "num_batches" not in k:
            params.append(d.flatten())
    d = torch.cat(params)
    return bn, float(d.max()), float(d.mean())


def test_programs_match_svs_tpus_jitted_steps(routed):
    """Four microbatches over ``accum_steps = 2`` with the learning rate
    changed after the first update, then the eval step at B = 2 and at the
    tail, against svs_tpu's jitted ``make_train_step`` /
    ``make_eval_step``.  Every microbatch's losses and ``grad_norm`` are
    held to ``_check_step``'s bounds, the state to its BN bound and
    envelope after the first update, the one-update setting it bounds:
    after that a parameter that the first update moved 2 lr apart (a
    near-zero gradient's sign) moves the next forward's statistics."""
    jcfg, jopt, jstate, cfg, state = _jax_pair(accum=2)
    jtrain, jeval = jstep.make_train_step(jcfg, jopt), \
        jstep.make_eval_step(jcfg)
    step, evals = tstep.make_train_step(cfg), tstep.make_eval_step(cfg)
    gen = torch.Generator().manual_seed(1)
    for i in range(4):
        if i == 2:
            jstate = jstep.set_learning_rate(jstate, LR2)
            tstep.set_learning_rate(state, LR2)
        batch = _batch(20 + i)
        jstate, jaux = jtrain(jstate, {k: jnp.asarray(v) for k, v in
                                       batch.items()}, jax.random.key(1))
        state, aux = step(state, tstep.batch_to_device(batch, "cpu"), gen)
        for k in ("l1", "mr", "total"):
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                       rtol=1e-5)
        np.testing.assert_allclose(float(aux["grad_norm"]),
                                   float(jaux["grad_norm"]), rtol=1e-3)
        if i == 1:
            bn, pmax, pmean = _state_deltas(jstate, state)
            assert bn < 1e-4
            assert pmax <= 2.1 * cfg.learning_rate and pmean < 2e-4
    assert state.step == int(jstate.step) == 4 and state.mini_step == 0
    assert tstep.get_learning_rate(state) == LR2
    prog = next(iter(routed._programs.values()))
    # two warm-up microbatches (Adam's moments), then one capture, at the
    # changed rate
    assert (prog.captures, prog.replays) == (1, 2)
    # the eval step on the same weights (copied in place: the programs'
    # binding holds, and they read the new values)
    with torch.no_grad():
        for k, v in t_import.state_dict_from_jax(
                jax.tree.map(np.asarray, jstate.params),
                jax.tree.map(np.asarray, jstate.bn_state)).items():
            state.model.state_dict()[k].copy_(v)
    for b in (2, 1):
        batch = _batch(30, b)
        jm = jeval(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tm = evals(state, tstep.batch_to_device(batch, "cpu"))
        for k in ("l1", "mr", "total"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)


def _call(step, state, seed, b=2, gen=None):
    return step(state, tstep.batch_to_device(_batch(seed, b), "cpu"),
                gen or torch.Generator().manual_seed(seed))


def test_a_tail_batch_builds_a_second_program_and_both_are_reused(routed):
    cfg, (state,) = _states(n=1)
    step = tstep.make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    for i, b in enumerate((2, 1, 2, 1, 2, 1)):
        state, _ = _call(step, state, i, b, gen)
    full, tail = routed._programs.values()
    assert routed.builds == 2 and state.step == 6
    # each: one warm-up call, a capture, then replays
    assert [(p.captures, p.replays) for p in (full, tail)] == [(1, 2),
                                                               (1, 2)]
    assert tuple(full.input["mix"].shape)[0] == 2
    assert tuple(tail.input["mix"].shape)[0] == 1


def test_the_first_call_is_a_real_step_and_no_call_is_extra(routed):
    """N calls are N eager steps: the warm-up call is the first step, and
    a capture runs nothing (the state and the generator move once a
    call)."""
    cfg, (eager, prog) = _states(accum=2)
    step = tstep.make_train_step(cfg)
    ge, gp = (torch.Generator().manual_seed(5) for _ in range(2))
    for n in range(1, 4):
        prog, _ = _call(step, prog, n, gen=gp)
        eager, _ = _call(tstep.make_step_fn(cfg), eager, n, gen=ge)
        assert prog.step == eager.step == n and _same(prog, eager)
        assert ge.get_state().equal(gp.get_state())
    prog_obj = next(iter(routed._programs.values()))
    # accumulation: warm-up until Adam has its moments (2 microbatches)
    assert prog_obj.captures == 1 and prog_obj.replays == 1


def test_lr_change_rebound_model_and_restored_checkpoint_capture_again(
        routed, tmp_path):
    cfg, (state,) = _states(n=1)
    step = tstep.make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    for seed in range(3):
        state, _ = _call(step, state, seed, gen=gen)
    prog = next(iter(routed._programs.values()))
    assert prog.captures == 1
    tstep.set_learning_rate(state, LR2)
    state, _ = _call(step, state, 3, gen=gen)
    assert prog.captures == 2
    # the same values at new addresses: the parameters' data rebound
    state.model.to(torch.float64).to(torch.float32)
    state, _ = _call(step, state, 4, gen=gen)
    assert prog.captures == 3
    path = str(tmp_path / "s.ckpt")
    ckpt.save(path, state, epoch=1)
    ckpt.load(path, state)  # a fresh Adam state
    state, _ = _call(step, state, 5, gen=gen)
    assert prog.captures == 4
    # another dropout generator is registered anew
    state, _ = _call(step, state, 6, gen=torch.Generator().manual_seed(9))
    assert prog.captures == 5
    state, _ = _call(step, state, 7)  # a generator made for the call
    assert prog.captures == 6 and routed.builds == 1 and state.step == 8


def test_a_returned_metric_never_aliases_a_static_buffer(routed):
    cfg, (state,) = _states(n=1)
    step, evals = tstep.make_train_step(cfg), tstep.make_eval_step(cfg)
    gen = torch.Generator().manual_seed(0)
    kept = []
    for seed in range(4):
        state, m = _call(step, state, seed, gen=gen)
        kept.append((m, {k: v.clone() for k, v in m.items()}))
    batch = tstep.batch_to_device(_batch(7), "cpu")
    e1 = evals(state, batch)
    e1_copy = {k: v.clone() for k, v in e1.items()}
    evals(state, tstep.batch_to_device(_batch(8), "cpu"))
    for m, was in kept + [(e1, e1_copy)]:
        for k in was:
            assert torch.equal(m[k], was[k]), k
    statics = [t.data_ptr() for p in routed._programs.values()
               for t in p.input.values()]
    ptrs = [v.data_ptr() for m, _ in kept for v in m.values()]
    assert len(set(ptrs)) == len(ptrs) and not set(ptrs) & set(statics)
    # the caller's batch is copied in, never held
    assert all(p.input["mix"].data_ptr() != batch["mix"].data_ptr()
               for p in routed._programs.values())


def test_an_eval_program_before_training_leaves_the_step_its_autograd(
        routed):
    """The eval program runs in ``no_grad``, not inference mode: the DFT
    filter banks it caches first (``matmul_bf16``'s, ``losses/mrstft.py``)
    are then saved by the next train step's backward."""
    from svs_torch.losses import mrstft
    cfg, (state,) = _states(n=1)
    cfg = dataclasses.replace(cfg, mr_mag_impl="matmul_bf16")
    mrstft._filters.clear()
    tstep.make_eval_step(cfg)(state, tstep.batch_to_device(_batch(0), "cpu"))
    assert mrstft._filters
    state, m = _call(tstep.make_train_step(cfg), state, 1)
    assert state.step == 1 and torch.isfinite(m["total"])


def test_cpu_entry_points_stay_eager_unless_routed(monkeypatch):
    cache = graphs.infer_graphs.ProgramCache(graphs.MAX_BYTES)
    monkeypatch.setattr(graphs, "CACHE", cache)
    cfg, (state,) = _states(n=1)
    for seed in range(2):
        state, _ = _call(tstep.make_train_step(cfg), state, seed)
    tstep.make_eval_step(cfg)(state, tstep.batch_to_device(_batch(0), "cpu"))
    assert cache.builds == 0 and len(cache) == 0 and state.step == 2
    assert not graphs.programmed(torch.device("cpu"))
    # the CPU keeps the host-form Adam (a CUDA device's is capturable)
    assert not state.optimizer.param_groups[0]["capturable"]


def test_a_freed_models_programs_go_and_the_bound_evicts(routed):
    cfg, (a, b) = _states()
    step = tstep.make_train_step(cfg)
    for s in (a, b):
        _call(step, s, 0)
    assert len(routed) == 2
    del a
    _call(step, copy.deepcopy(b), 1)  # a build drops the freed model's
    assert len(routed) == 2
    routed.max_bytes = 1  # past the bound: only the newest stays
    _call(step, b, 2, b=1)
    assert len(routed) == 1 and routed.evictions >= 1


def test_program_keys_hold_the_config(routed):
    """Two configurations of one model (another ``mr_mag_impl``) are two
    programs."""
    cfg, (state,) = _states(n=1)
    other = dataclasses.replace(cfg, mr_mag_impl="matmul_bf16")
    for c in (cfg, other, cfg):
        state, _ = _call(tstep.make_train_step(c), state, 0)
    assert routed.builds == 2
