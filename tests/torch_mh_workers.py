"""What the port's multi-host tests run on their ranks (a
``svs_torch.parallel.launch.Ranks(4, hosts=2)`` pool of gloo ranks on the
CPU: two hosts of two ranks).

Each function takes the rank's mesh (the pool's world) first.  This module
imports torch and svs_torch only: the ranks never import JAX, and what
they return is numpy, which the tests hold against svs_tpu in their own
process.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from svs_torch.data.augment import Augmenter
from svs_torch.data.dataset import PatchDataset
from svs_torch.data.device_data import MultiHostDeviceDataset
from svs_torch.parallel import dp, dryrun, multihost
from svs_torch.parallel import mesh as mesh_lib
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig

import torch_dp_workers as W

# the pool's ranks as two 2-rank meshes, made once by every rank: "hosts",
# ranks (0, 2) and (1, 3), two hosts of one rank each; "one", ranks (0, 1)
# and (2, 3), one host of two ranks
_GROUPS = {"hosts": ([[0, 2], [1, 3]], 2), "one": ([[0, 1], [2, 3]], 1)}
_subs = {}


def sub(mesh, kind):
    """This rank's mesh among ``kind``'s pairs if it is in the first pair,
    else None."""
    if kind not in _subs:
        groups, hosts = _GROUPS[kind]
        _subs[kind] = mesh_lib._sub_mesh(mesh, groups, mesh.axis_name,
                                         hosts)
    groups, _ = _GROUPS[kind]
    return _subs[kind] if mesh.rank in groups[0] else None


def layout(mesh):
    """The pool mesh's hosts as ``make_mesh`` read them."""
    return (mesh.hosts, mesh.host, mesh.local_rank, mesh.local_size)


def dp_grads(mesh, cfg_kw, state_dict, host_batches, pad_to):
    """The DP forward and backward of this rank's block of its host's
    batch (``global_batch_from_local``): the global metrics, the summed
    gradients by name and the BN running statistics after it."""
    cfg = SVSConfig(**cfg_kw)
    state = W._state(cfg, state_dict)
    block = multihost.global_batch_from_local(
        mesh, host_batches[mesh.host], pad_to)
    grads, metrics = dp.dp_loss_and_grads(cfg, state, block, None, mesh)
    names = [n for n, _ in state.model.named_parameters()]
    return ({k: float(v) for k, v in metrics.items()},
            {n: g.numpy().copy() for n, g in zip(names, grads)},
            {k: v for k, v in W._np(state.model.state_dict()).items()
             if "running" in k})


def device_blocks(mesh, folder, cfg_kw, local_bs, n_steps):
    """``MultiHostDeviceDataset``'s blocks on this rank (numpy) beside
    ``dryrun.mh_data_parity``'s check of them against the host
    pipeline."""
    cfg = SVSConfig(**cfg_kw)
    ds = PatchDataset(folder, samples_per_song=cfg.samples_per_song,
                      input_len=cfg.input_len)
    multihost.shard_songs(ds, mesh.host, mesh.hosts)
    feed = MultiHostDeviceDataset(ds, mesh,
                                  multihost.pad_rows(local_bs, mesh))
    blocks = [W._np(b) for b in feed.batches(
        local_bs, seed=dryrun.MH_SEED, n_steps=n_steps)]
    check = dryrun.mh_data_parity(mesh, folder, cfg, local_bs,
                                  n_steps=n_steps)
    return blocks, check, feed.nbytes_per_device


def apply_sharded(mesh, batch, n_real):
    """``Augmenter.apply_sharded`` of this rank's block of the host batch
    ``batch`` (the same on both hosts): the remixed block (numpy), the
    generator's next draw, and ``dryrun.mh_augment_parity``'s check of
    the block against the numpy oracle."""
    q = len(batch["mix"]) // mesh.local_size
    lo = mesh.local_rank * q
    block = {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + q]))
             for k, v in batch.items()}
    aug = Augmenter(remix_p=0.8).for_epoch(dryrun.MH_SEED)
    out = aug.apply_sharded(block, n_real, mesh=mesh)
    return (W._np(out), float(aug._rng.uniform()),
            dryrun.mh_augment_parity(mesh, batch, n_real, hosts=mesh.hosts))


def fit(mesh, kind, opts_kw, cfg_kw, stop=None, load_paths=None):
    """``torch_dp_workers.fit`` over ``kind``'s first pair (None on the
    other ranks); ``load_paths``: each host's ``load_path``."""
    m = sub(mesh, kind)
    if m is None:
        return None
    if load_paths is not None:
        opts_kw = dict(opts_kw, load_path=load_paths[m.host])
    return W.fit(m, opts_kw, cfg_kw, stop)


def sync(mesh, cfg_kw, batch, ahead):
    """``sync_resume`` where host 0's ranks resumed the state of seed 99
    after one step (Adam's moments made) at epoch 3 and host 1's hold the
    fresh state of seed 0 at epoch 0, or (``ahead``) where host 1's hold
    that state at epoch 9 and host 0's the fresh one at epoch 2.  Returns
    the epoch, extras, step, state digest and Adam's moments' digest
    after it, and the seed-99 state's digests; or the error raised."""
    cfg = SVSConfig(**cfg_kw)

    def stepped():
        state = tstep.create_train_state(99, cfg, device="cpu")
        state, _ = tstep.make_train_step(cfg)(
            state, tstep.batch_to_device(batch, "cpu"),
            torch.Generator().manual_seed(1))
        return state

    def moments(state):
        opt = state.optimizer
        return hashlib.sha256(b"".join(
            opt.state[p][k].numpy().tobytes()
            for p in state.model.parameters()
            for k in ("exp_avg", "exp_avg_sq")
            if p in opt.state)).hexdigest()

    want = stepped()
    first = mesh.host == (1 if ahead else 0)
    if first:
        state, epoch = stepped(), (9 if ahead else 3)
        extras = {"best_val_loss": 0.5, "loss_list_total": [3.0, 2.0, 1.0]}
    else:
        state, epoch, extras = (tstep.create_train_state(0, cfg,
                                                         device="cpu"),
                                2 if ahead else 0, {})
    try:
        state, epoch, extras = multihost.sync_resume(state, epoch, extras,
                                                     mesh)
    except RuntimeError as e:
        return {"error": str(e)}
    return {"epoch": epoch, "extras": extras, "step": state.step,
            "digest": dryrun.state_digest(state),
            "moments": moments(state),
            "want": (dryrun.state_digest(want), moments(want)),
            "lr": tstep.get_learning_rate(state)}


def agreement(mesh, values, tol=0.0):
    """``assert_scalar_agreement`` of ``values[rank]``: None, or the error
    raised."""
    try:
        multihost.assert_scalar_agreement(values[mesh.rank], "avg_val_loss",
                                          tol, mesh=mesh)
    except RuntimeError as e:
        return str(e)
    return None


def fit_world(mesh, opts_kw, cfg_kw, shape=None):
    """``torch_dp_workers.fit`` over the pool's two hosts of two ranks, as
    a data mesh, or as the ``(data, model)`` mesh ``shape`` under TP."""
    import torch_tp_workers as T

    m = mesh if shape is None else T.mesh2d(mesh, shape)
    return W.fit(m, opts_kw, cfg_kw)
