"""What the port's data-parallel tests run on their ranks (a
``svs_torch.parallel.launch.Ranks`` pool of gloo ranks on the CPU).

Each function takes the rank's mesh first.  This module imports torch and
svs_torch only: the ranks never import JAX, and what they return is numpy,
which the tests hold against svs_tpu in their own process.
"""

from __future__ import annotations

import contextlib
import os
import signal

import torch
import torch.distributed as dist

from svs_torch.parallel import dp
from svs_torch.parallel import mesh as mesh_lib
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig


def _np(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _state(cfg, state_dict=None):
    state = tstep.create_train_state(0, cfg, device="cpu")
    if state_dict is not None:
        state.model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in state_dict.items()})
    return state


def dp_grads(mesh, cfg_kw, state_dict, batch):
    """The DP forward and backward of the global ``batch`` from
    ``state_dict``: the global metrics, the all-reduced gradients by name
    and the BN running statistics after the forward, from every rank."""
    cfg = SVSConfig(**cfg_kw)
    state = _state(cfg, state_dict)
    grads, metrics = dp.dp_loss_and_grads(
        cfg, state, mesh_lib.shard_batch(mesh, batch), None, mesh)
    names = [n for n, _ in state.model.named_parameters()]
    return ({k: float(v) for k, v in metrics.items()},
            {n: g.numpy().copy() for n, g in zip(names, grads)},
            {k: v for k, v in _np(state.model.state_dict()).items()
             if "running" in k})


def dp_steps(mesh, cfg_kw, batches):
    """Steps of the DP train step over the global host ``batches`` from the
    state of seed 0, dropout from one generator of seed 1: each step's
    metrics and state dict, from every rank."""
    cfg = SVSConfig(**cfg_kw)
    state = dp.replicate_state(_state(cfg), mesh)
    step = dp.make_dp_train_step(mesh, cfg)
    gen = torch.Generator().manual_seed(1)
    metrics, states = [], []
    for b in batches:
        state, m = step(state, mesh_lib.shard_batch(mesh, b), gen)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_np(state.model.state_dict()))
    return metrics, states


def dp_eval(mesh, cfg_kw, state_dict, batch, pad_rows_to):
    """The DP eval step of the global ``batch`` through the validation
    distributor."""
    cfg = SVSConfig(**cfg_kw)
    state = _state(cfg, state_dict)
    aux = dp.make_dp_eval_step(mesh, cfg)(
        state, mesh_lib.global_batch_from_global(mesh, batch, pad_rows_to))
    return {k: float(v) for k, v in aux.items()}


def world_of_one(mesh, cfg_kw, batches):
    """Rank 0 alone, in a group of one made from the pool's: the DP steps
    and the single-device steps on the same batches (with the all-ones
    ``weight`` that ``shard_batch`` appends), state and generator; both
    runs' metrics and final state dicts.  The other ranks return None."""
    sub = dist.new_group([0])  # every rank of the group makes it
    if mesh.rank != 0:
        return None
    one = mesh_lib.Mesh(sub, 0, 1, mesh.device, backend=mesh.backend)
    cfg = SVSConfig(**cfg_kw)
    out = []
    for kind in ("dp", "single"):
        state = _state(cfg)
        if kind == "dp":
            state = dp.replicate_state(state, one)
            step = dp.make_dp_train_step(one, cfg)
        else:
            step = tstep.make_train_step(cfg)
        gen = torch.Generator().manual_seed(1)
        metrics = []
        for b in batches:
            if kind == "dp":
                local = mesh_lib.shard_batch(one, b)
            else:
                local = tstep.batch_to_device(b, "cpu")
                local["weight"] = torch.ones(len(b["mix"]))
            state, m = step(state, local, gen)
            metrics.append({k: float(v) for k, v in m.items()})
        out.append((metrics, _np(state.model.state_dict())))
    return out


def sp_decode(mesh, cfg_kw, state_dict, cases):
    """``separate_magnitude_mesh`` of each ``(mag, mode, vocal_solo)`` case;
    rank 0's outputs (None from the other ranks)."""
    from svs_torch.infer import separate

    model = _state(SVSConfig(**cfg_kw), state_dict).model.eval()
    return [separate.separate_magnitude_mesh(model, mag, mesh, mode=mode,
                                             vocal_solo=solo)
            for mag, mode, solo in cases]


@contextlib.contextmanager
def decode_routed(on: bool = True):
    """The mesh decodes' masks through the decode's program objects on the
    CPU (``on``, by the decode's switch ``separate._programmed``; the
    CPU's decode is eager otherwise), in a fresh cache of programs: the
    cache."""
    from svs_torch.infer import graphs as infer_graphs
    from svs_torch.infer import separate

    cache = infer_graphs.ProgramCache()
    was = separate._programmed, infer_graphs.CACHE
    if on:
        separate._programmed = lambda dev: True
    infer_graphs.CACHE = cache
    try:
        yield cache
    finally:
        separate._programmed, infer_graphs.CACHE = was


def sp_programs(mesh, cfg_kw, state_dict, cases):
    """Each ``(mag, mode, vocal_solo)`` case of ``separate_magnitude_mesh``
    twice through the programs (:func:`decode_routed`), then eagerly:
    rank 0's outputs of each form (None elsewhere), and the programs each
    rank's cache built and holds."""
    from svs_torch.infer import separate

    model = _state(SVSConfig(**cfg_kw), state_dict).model.eval()
    out = {}
    for form in ("program", "eager"):
        with decode_routed(form == "program") as cache:
            out[form] = [separate.separate_magnitude_mesh(
                model, mag, mesh, mode=mode, vocal_solo=solo)
                for mag, mode, solo in cases for _ in range(2)]
            out[f"{form}_builds"] = (cache.builds, len(cache))
    return out


def fit(mesh, opts_kw, cfg_kw, stop=None):
    """``fit`` over the mesh (DP, or ZeRO-1 / FSDP with ``zero1`` /
    ``fsdp`` in ``opts_kw``, or TP on a ``Mesh2D`` with ``parallel='tp'``,
    or CP with ``parallel='cp'``);
    the checkpoint paths this rank wrote, its
    step count and final full state dict, and its exit code (0, or 143
    after a stop).  ``stop``: ``(rank, after)`` sends that rank a SIGTERM
    after its ``after``-th step, or, with ``after`` a file name, when it
    first writes that checkpoint."""
    from svs_torch.parallel import halo, tp, zero
    from svs_torch.train import checkpoint as ckpt_lib
    from svs_torch.train import loop

    written, calls = [], [0]
    save = ckpt_lib.save
    make = (dp.make_dp_train_step, zero.make_zero1_train_step,
            tp.make_tp_train_step, halo.make_cp_train_step)

    def stop_at(mark):
        if stop is not None and (mesh.rank, mark) == tuple(stop):
            os.kill(os.getpid(), signal.SIGTERM)

    def recording_save(path, *args, **kw):
        written.append(os.path.basename(path))
        out = save(path, *args, **kw)
        if written.count(written[-1]) == 1:
            stop_at(written[-1])
        return out

    def stepping(make_step):
        def made(*a, **kw):
            step = make_step(*a, **kw)

            def run(*args):
                out = step(*args)
                calls[0] += 1
                stop_at(calls[0])
                return out
            return run
        return made

    ckpt_lib.save = recording_save
    (dp.make_dp_train_step, zero.make_zero1_train_step,
     tp.make_tp_train_step, halo.make_cp_train_step) = map(stepping, make)
    code = 0
    try:
        state = loop.fit(loop.TrainOptions(mesh=mesh, device="cpu",
                                           **opts_kw), SVSConfig(**cfg_kw))
        sd = _np(zero.unshard_state(state).state_dict)
    except SystemExit as e:
        code, sd = e.code, None
    finally:
        ckpt_lib.save = save
        (dp.make_dp_train_step, zero.make_zero1_train_step,
         tp.make_tp_train_step, halo.make_cp_train_step) = make
    return {"written": written, "steps": calls[0], "code": code,
            "state": sd}


def cli(mesh, module, argv):
    """``python -m svs_torch.cli.<module> argv`` on this rank; its exit
    code."""
    import importlib

    return importlib.import_module(f"svs_torch.cli.{module}").main(argv)
