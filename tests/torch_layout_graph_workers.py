"""What the layout programs' tests run on their ranks (a
``svs_torch.parallel.launch.Ranks`` pool of gloo ranks on the CPU).

Each function takes the pool's mesh first.  The steps run through the
program objects of ``train/graphs.py`` as on a card (:func:`routed`: the
CPU's steps are eager otherwise), so the key, the binding, the warm-up
step, the static buffers, the copies in and out and the host's counts run
on every rank.  This module imports torch and svs_torch only: the ranks
never import JAX, and what they return is numpy, which the tests hold
against svs_tpu and the eager bodies in their own process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch

from svs_torch.parallel import dp, dryrun, zero
from svs_torch.train import checkpoint as ckpt_lib
from svs_torch.train import graphs, loop
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig

from torch_tp_workers import mesh2d


@contextlib.contextmanager
def routed(on: bool = True):
    """The steps through the program objects on the CPU (``on``), in a
    fresh cache of programs: the cache."""
    cache = graphs.infer_graphs.ProgramCache(graphs.MAX_BYTES)
    was = graphs.programmed, graphs.CACHE
    if on:
        graphs.programmed = lambda dev: True
    graphs.CACHE = cache
    try:
        yield cache
    finally:
        graphs.programmed, graphs.CACHE = was


def _np(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def _mesh(mesh, kind, shape=None):
    return mesh2d(mesh, shape) if kind == "tp" else mesh


def _layout(kind, m, cfg, state_dict=None):
    state = tstep.create_train_state(0, cfg, device="cpu")
    if state_dict is not None:
        state.model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in state_dict.items()})
    return dryrun.layout_state(kind, cfg, m, state=state)


def against_svs_tpu(mesh, kind, shape, cfg_kw, state_dict, calls):
    """The layout's program over ``calls`` (``(global host batch,
    pad_rows_to)`` each, cut as ``fit`` cuts it) from ``state_dict``, no
    dropout: after each call the global metrics, the full BN running
    statistics and Adam's first moment by name; and the programs'
    (captures, replays)."""
    m = _mesh(mesh, kind, shape)
    cfg = SVSConfig(**cfg_kw)
    out = []
    with routed():
        state, step = _layout(kind, m, cfg, state_dict)
        gen = torch.Generator().manual_seed(1)
        for batch, pad in calls:
            state, metrics = step(state, dryrun.layout_batch(
                kind, m, batch, pad), gen)
            snap = zero.unshard_state(state)
            out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                        "bn": {k: v.numpy().copy() for k, v in
                               snap.state_dict.items() if "running" in k},
                        "mu": _np(snap.exp_avg)})
        return out, dryrun.programs(state.model)


def against_eager(mesh, kind, shape, cfg_kw, calls, evals):
    """The layout's program and its eager body (``step.eager``) from the
    state of seed 0, each with a dropout generator of seed 1, over
    ``calls`` (as :func:`against_svs_tpu`'s); then the eval program and
    the eager eval twice on each of ``evals`` (``(host batch, rows)``:
    padded to ``rows`` as ``fit`` pads a validation batch).  By form: each
    call's metrics, the full state after the last (the state dict, Adam's
    moments and count), the eval metrics, the programs' (captures,
    replays), the programs built and the step counts."""
    m = _mesh(mesh, kind, shape)
    cfg = SVSConfig(**cfg_kw)
    out = {}
    for form in ("program", "eager"):
        with routed() as cache:
            state, step = _layout(kind, m, cfg)
            run = step if form == "program" else step.eager
            gen = torch.Generator().manual_seed(1)
            metrics = []
            for batch, pad in calls:
                state, got = run(state, dryrun.layout_batch(kind, m, batch,
                                                            pad), gen)
                metrics.append({k: v.numpy().copy() for k, v in got.items()})
            snap = zero.unshard_state(state)
            evaluate = dryrun.layout_eval_step(kind, cfg, m)
            evaluate = evaluate if form == "program" else evaluate.eager
            ev = [{k: v.numpy().copy() for k, v in evaluate(
                state, dryrun.layout_val_batch(kind, m, b, rows)).items()}
                for b, rows in evals for _ in range(2)]
            out[form] = {
                "metrics": metrics, "sd": _np(snap.state_dict),
                "mu": _np(snap.exp_avg), "nu": _np(snap.exp_avg_sq),
                "count": snap.adam_count, "evals": ev,
                "programs": dryrun.programs(state.model),
                "builds": cache.builds, "step": state.step,
                "mini_step": state.mini_step}
    return out


def rules(mesh, cfg_kw, batch, folder):
    """The program rules at world 2 over DP: (a) the DP program, the
    single step's program on the same state and batch signature, and the
    DP program over another ``Mesh`` of the same group are three programs;
    (b) a learning-rate change and a restore from a checkpoint capture
    again; (c) the metrics returned never alias a buffer of a program, and
    keep their values over later calls."""
    cfg = SVSConfig(**cfg_kw)
    other = dataclasses.replace(mesh)  # the same group, another mesh
    out = {}
    with routed() as cache:
        state, step = _layout("dp", mesh, cfg)
        local = dryrun.layout_batch("dp", mesh, batch)
        gen = torch.Generator().manual_seed(1)
        kept = []
        for _ in range(3):
            state, got = step(state, local, gen)
            kept.append((got, {k: v.clone() for k, v in got.items()}))
        prog = graphs.CACHE.programs_of(state.model)[0]
        out["first"] = (prog.captures, prog.replays)
        tstep.set_learning_rate(state, cfg.learning_rate / 2)
        state, _ = step(state, local, gen)
        out["lr"] = prog.captures
        path = os.path.join(folder, f"rank{mesh.rank}.ckpt")
        ckpt_lib.save(path, state, epoch=1)
        ckpt_lib.load(path, state)  # a fresh Adam state
        state, _ = step(state, local, gen)
        out["restore"] = prog.captures
        # the same signature (the batch with its weight) for the single
        # step and the DP step over another mesh: programs of their own
        state, _ = tstep.make_train_step(cfg)(state, local, gen)
        state, _ = dp.make_dp_train_step(other, cfg)(state, local, gen)
        out["keys"] = sorted((k[0], k[1], k[2] is None) for k in
                             cache._programs)
        out["builds"] = cache.builds
        out["distinct_meshes"] = len({k[2] for k in cache._programs})
        statics = {t.data_ptr() for p in cache.programs_of(state.model)
                   for t in p.input.values()}
        ptrs = [v.data_ptr() for got, _ in kept for v in got.values()]
        out["aliases"] = len(set(ptrs)) != len(ptrs) or bool(
            set(ptrs) & statics)
        out["kept"] = all(torch.equal(got[k], was[k]) for got, was in kept
                          for k in was)
    return out


def fit(mesh, opts_kw, cfg_kw, on):
    """``fit`` over the mesh with its steps through the programs (``on``)
    or as their eager bodies: the full final state (state dict and Adam's
    moments) and the programs built."""
    with routed(on) as cache:
        state = loop.fit(loop.TrainOptions(mesh=mesh, device="cpu",
                                           **opts_kw), SVSConfig(**cfg_kw))
        snap = zero.unshard_state(state)
        return {"sd": _np(snap.state_dict), "mu": _np(snap.exp_avg),
                "nu": _np(snap.exp_avg_sq), "step": state.step,
                "builds": cache.builds}
