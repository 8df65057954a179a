"""What the port's ZeRO-1 / FSDP tests run on their ranks (a
``svs_torch.parallel.launch.Ranks`` pool of gloo ranks on the CPU).

Each function takes the rank's mesh first.  This module imports torch and
svs_torch only: the ranks never import JAX, and what they return is numpy
(full tensors gathered by ``zero.unshard_state`` where a state is
sharded), which the tests hold against svs_tpu and the DP step in their
own process.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from svs_torch.parallel import dryrun
from svs_torch.parallel import mesh as mesh_lib
from svs_torch.parallel import zero
from svs_torch.train import checkpoint as ckpt_lib
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig


def _np(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def layout_state(kind, mesh, cfg, state_dict=None, accum_steps=1,
                 load_path=None):
    """The state of seed 0 (or ``state_dict``, or resumed from
    ``load_path``) on every rank in layout ``kind`` (``dp``, ``zero1``,
    ``fsdp``), and its train step."""
    state = tstep.create_train_state(
        0, cfg, tstep.make_optimizer(cfg, accum_steps=accum_steps),
        device=mesh.device)
    if state_dict is not None:
        state.model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in state_dict.items()})
    if load_path is not None:
        ckpt_lib.resume(load_path, state)
    return dryrun.layout_state(kind, cfg, mesh, state=state)


def full(state):
    """Every rank's view of the full state: the state dict, Adam's moments
    and step count, as numpy."""
    snap = zero.unshard_state(state)
    return {"sd": _np(snap.state_dict), "mu": _np(snap.exp_avg),
            "nu": _np(snap.exp_avg_sq), "count": snap.adam_count,
            "step": snap.step,
            "acc": None if snap.acc_grads is None else _np(snap.acc_grads)}


def shards(mesh, cfg_kw, load_path, fsdp):
    """This rank's tensors after ``shard_state`` of the state resumed from
    ``load_path``: the model's state dict and Adam's moments by parameter
    name, as held (slices where the layout shards them)."""
    state, _ = layout_state("fsdp" if fsdp else "zero1", mesh,
                            SVSConfig(**cfg_kw), load_path=load_path)
    opt = state.optimizer
    names = [n for n, _ in state.model.named_parameters()]
    mu, nu = {}, {}
    for name, p in zip(names, opt.param_groups[0]["params"]):
        mu[name] = opt.state[p]["exp_avg"]
        nu[name] = opt.state[p]["exp_avg_sq"]
    return {"sd": _np(state.model.state_dict()), "mu": _np(mu),
            "nu": _np(nu), "dims": dict(state.dims)}


def grads(mesh, cfg_kw, state_dict, batch, kind):
    """The sharded step's forward and backward of the global ``batch``:
    the global metrics, the gradient it hands to Adam (every rank's
    slices gathered) and the BN running statistics after the forward."""
    cfg = SVSConfig(**cfg_kw)
    state, _ = layout_state(kind, mesh, cfg, state_dict)
    got, metrics = zero.zero_loss_and_grads(
        cfg, state, mesh_lib.shard_batch(mesh, batch))
    names = [n for n, _ in state.model.named_parameters()]
    gathered = mesh_lib.gather_state(
        [(g, state.dims[n]) for n, g in zip(names, got)], mesh)
    return ({k: float(v) for k, v in metrics.items()},
            {n: g.numpy() for n, g in zip(names, gathered)},
            {k: v for k, v in full(state)["sd"].items() if "running" in k})


def steps(mesh, cfg_kw, batches, kind, accum_steps=1, state_dict=None):
    """Steps of layout ``kind`` over the global host ``batches`` from the
    state of seed 0 (or ``state_dict``), dropout from one generator of
    seed 1: each step's metrics and full state dict, the final full state
    (Adam's moments included) and the bytes this rank held before and
    after (``zero.state_bytes``)."""
    cfg = SVSConfig(**cfg_kw)
    state, step = layout_state(kind, mesh, cfg, state_dict, accum_steps)
    gen = torch.Generator().manual_seed(1)
    metrics, sds = [], []
    before = zero.state_bytes(state)
    for b in batches:
        state, m = step(state, mesh_lib.shard_batch(mesh, b), gen)
        metrics.append({k: float(v) for k, v in m.items()})
        sds.append(full(state)["sd"])
    return {"metrics": metrics, "sds": sds, "final": full(state),
            "bytes": (before, zero.state_bytes(state))}


def world_of_one(mesh, cfg_kw, batches):
    """Rank 0 alone, in a group of one made from the pool's: the ZeRO-1 and
    FSDP steps and the single-device steps on the same batches (with the
    all-ones ``weight`` that ``shard_batch`` appends), state and
    generator; each run's metrics and final full state.  The other ranks
    return None."""
    sub = dist.new_group([0])  # every rank of the group makes it
    if mesh.rank != 0:
        return None
    one = mesh_lib.Mesh(sub, 0, 1, mesh.device, backend=mesh.backend)
    cfg = SVSConfig(**cfg_kw)
    out = {}
    for kind in ("single", "zero1", "fsdp"):
        if kind == "single":
            state = tstep.create_train_state(0, cfg, device="cpu")
            step = tstep.make_train_step(cfg)
        else:
            state, step = layout_state(kind, one, cfg)
        gen = torch.Generator().manual_seed(1)
        metrics = []
        for b in batches:
            local = mesh_lib.shard_batch(one, b)
            state, m = step(state, local, gen)
            metrics.append({k: float(v) for k, v in m.items()})
        out[kind] = (metrics, full(state))
    return out
