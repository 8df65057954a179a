"""What the port's TP tests run on their ranks (a
``svs_torch.parallel.launch.Ranks`` pool of gloo ranks on the CPU).

Each function takes the rank's mesh (the pool's world) first and the
``(data, model)`` shape it views it as.  This module imports torch and
svs_torch only: the ranks never import JAX, and what they return is numpy
(full tensors gathered over the model sub-mesh), which the tests hold
against svs_tpu and the single-process step in their own process.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from svs_torch.parallel import dp, tp, zero
from svs_torch.parallel import mesh as mesh_lib
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig

import torch_dp_workers as W

# the pool's world as each (data, model) mesh, made once: every rank makes
# the groups of a shape at the same call
_meshes = {}


def mesh2d(mesh, shape):
    shape = tuple(shape)
    if shape not in _meshes:
        _meshes[shape] = mesh_lib.make_2d_mesh(
            *shape, device=mesh.device, backend=mesh.backend)
    return _meshes[shape]


def _state(cfg, state_dict=None, sgd_lr=None):
    """The state of seed 0 (or ``state_dict``) with Adam, or SGD at
    ``sgd_lr``."""
    state = tstep.create_train_state(0, cfg, device="cpu")
    if state_dict is not None:
        state.model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in state_dict.items()})
    if sgd_lr is not None:
        state.optimizer = torch.optim.SGD(state.model.parameters(),
                                          lr=sgd_lr)
    return state


def _tp_state(m, cfg, state_dict=None, sgd_lr=None):
    return tp.shard_state(dp.replicate_state(
        _state(cfg, state_dict, sgd_lr), m), m)


def _full(state):
    """The full state dict, gathered over the state's model sub-mesh, as
    numpy."""
    sd = state.model.state_dict()
    got = mesh_lib.gather_state(
        [(t, state.dims[n]) for n, t in sd.items()], state.mesh)
    return {n: t.numpy() for n, t in zip(sd, got)}


def _held(state):
    """The shapes this rank holds: the state dict's and each parameter's
    Adam moment's."""
    opt = state.optimizer
    names = [n for n, _ in state.model.named_parameters()]
    return {"sd": {k: tuple(v.shape)
                   for k, v in state.model.state_dict().items()},
            "mu": {n: tuple(opt.state[p]["exp_avg"].shape)
                   for n, p in zip(names, opt.param_groups[0]["params"])
                   if p in opt.state},
            "dims": dict(state.dims)}


def shards(mesh, shape, cfg_kw):
    """This rank's shapes after ``tp.shard_state`` of the state of seed 0
    with Adam's moments made (one step of zero gradients)."""
    m = mesh2d(mesh, shape)
    state = _tp_state(m, SVSConfig(**cfg_kw))
    for p in state.model.parameters():
        p.grad = torch.zeros_like(p)
    state.optimizer.step()
    return _held(state)


def steps(mesh, shape, cfg_kw, batches, state_dict=None, sgd_lr=None):
    """TP steps over the global host ``batches`` from the state of seed 0
    (or ``state_dict``), dropout from one generator of seed 1: each step's
    metrics and full state dict, and the shapes held."""
    m = mesh2d(mesh, shape)
    cfg = SVSConfig(**cfg_kw)
    state = _tp_state(m, cfg, state_dict, sgd_lr)
    step = tp.make_tp_train_step(m, cfg)
    gen = torch.Generator().manual_seed(1)
    metrics, sds = [], []
    for b in batches:
        state, got = step(state, mesh_lib.shard_batch(m.data, b), gen)
        metrics.append({k: float(v) for k, v in got.items()})
        sds.append(_full(state))
    return {"metrics": metrics, "sds": sds, "held": _held(state)}


def apply(mesh, shape, cfg_kw, state_dict, mix):
    """``tp.make_tp_apply``'s mask of the global ``mix`` on this rank."""
    m = mesh2d(mesh, shape)
    cfg = SVSConfig(**cfg_kw)
    return tp.make_tp_apply(m, cfg)(_tp_state(m, cfg, state_dict),
                                    mix).numpy()


def evaluate(mesh, shape, cfg_kw, state_dict, batch, pad_rows_to):
    """``tp.make_tp_eval_step`` of the global ``batch`` through the
    validation distributor over the data sub-mesh."""
    m = mesh2d(mesh, shape)
    cfg = SVSConfig(**cfg_kw)
    aux = tp.make_tp_eval_step(m, cfg)(
        _tp_state(m, cfg, state_dict),
        mesh_lib.global_batch_from_global(m.data, batch, pad_rows_to))
    return {k: float(v) for k, v in aux.items()}


def world_of_one(mesh, cfg_kw, batches):
    """Rank 0 alone, a (1, 1) mesh of a group of one made from the pool's:
    the TP steps and ``make_train_step`` on the same batches (with the
    all-ones ``weight`` that ``shard_batch`` appends), state and
    generator; each run's metrics, final state dict and Adam moments.
    The other ranks return None."""
    sub = dist.new_group([0])  # every rank of the group makes it
    if mesh.rank != 0:
        return None
    one = mesh_lib.Mesh(sub, 0, 1, mesh.device, backend=mesh.backend)
    m = mesh_lib.Mesh2D(**{f.name: getattr(one, f.name)
                           for f in dataclasses.fields(mesh_lib.Mesh)},
                        data=one,
                        model=dataclasses.replace(one, axis_name="model"))
    cfg = SVSConfig(**cfg_kw)
    out = {}
    for kind in ("single", "tp"):
        if kind == "single":
            state = _state(cfg)
            step = tstep.make_train_step(cfg)
        else:
            state = _tp_state(m, cfg)
            step = tp.make_tp_train_step(m, cfg)
        gen = torch.Generator().manual_seed(1)
        metrics = []
        for b in batches:
            state, got = step(state, mesh_lib.shard_batch(one, b), gen)
            metrics.append({k: float(v) for k, v in got.items()})
        snap = zero.unshard_state(state)
        out[kind] = (metrics, {k: v.numpy() for k, v in
                               snap.state_dict.items()},
                     {k: v.numpy() for k, v in snap.exp_avg.items()},
                     {k: v.numpy() for k, v in snap.exp_avg_sq.items()})
    return out


def fit(mesh, shape, opts_kw, cfg_kw, stop=None):
    """``torch_dp_workers.fit`` over the ``shape`` mesh with
    ``parallel='tp'``."""
    return W.fit(mesh2d(mesh, shape), dict(opts_kw, parallel="tp"), cfg_kw,
                 stop=stop)
