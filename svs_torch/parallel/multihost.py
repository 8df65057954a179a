"""Multi-host training over ``torch.distributed`` (port of
``svs_tpu/parallel/multihost.py``; its ``global_batch_from_global`` and
``gather_state`` are in :mod:`svs_torch.parallel.mesh`).

svs_tpu is multi-host when ``jax.process_count() > 1``: each process is a
host that owns several devices, reads its own shard of the songs and
contributes its rows of the global batch.  Here a device is a rank, and a
host is a run of consecutive ranks of one size (a ``torchrun`` node): the
mesh records the hosts (``Mesh.hosts``, ``host``, ``local_size``,
``local_rank``; ``mesh.make_mesh`` reads and checks them).  Every rank of
a host samples the host's batch from the host's seed, so each holds the
same local batch and keeps its own block of rows of it:

- :func:`process_shard` splits a song list round-robin by host;
- :func:`local_quota` is a host's ranks on the data axis;
- :func:`global_batch_from_local` pads the host's batch to a fixed row
  count with zero rows and a 0/1 ``weight`` and returns this rank's block:
  the global batch is host 0's padded rows, then host 1's, and so on;
- :func:`host_schedule` and :func:`epoch_seed` are ``fit``'s per-host
  batch size, step count and crop seed (svs_tpu loop.py:161-205,651);
- :func:`any_flag`, :func:`assert_scalar_agreement` and
  :func:`sync_resume` keep the hosts in lockstep: a SIGTERM on any host
  stops all, a validation loss must be the same on every rank, and a host
  that resumed from a missing or stale checkpoint gets rank 0's state.

Every collective here is an all-reduce or a broadcast on the mesh's host
(gloo) group, as ``mesh.agree`` is, so ranks that share a card run it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from svs_torch.parallel import dp
from svs_torch.parallel import mesh as mesh_lib
from svs_torch.parallel.mesh import Mesh, Mesh2D

# svs_tpu's any_flag: True on every rank when it is true on any
any_flag = mesh_lib.agree


def process_shard(items: List, host: int, n_hosts: int) -> List:
    """Host ``host``'s round-robin share of a work list (song file names):
    ``items[host::n_hosts]``."""
    return items[host::n_hosts]


def shard_songs(ds, host: int, n_hosts: int) -> None:
    """Keep host ``host``'s share of ``ds.file_names`` (in place); with more
    hosts than songs a host takes song ``host % n_songs``, so none is left
    without (svs_tpu loop.py:175-180)."""
    full = ds.file_names
    ds.file_names = process_shard(full, host, n_hosts) or [
        full[host % len(full)]]


def data_mesh(mesh: Mesh) -> Mesh:
    """The mesh a batch's rows are cut over: a ``Mesh2D``'s data axis, or
    the mesh itself."""
    return mesh.data if isinstance(mesh, Mesh2D) else mesh


def local_quota(mesh: Mesh) -> int:
    """This host's ranks on the mesh's data axis (under TP its data rows)."""
    return data_mesh(mesh).local_size


def host_schedule(batch_size: int, n_items: int, n_hosts: int
                  ) -> Tuple[int, int]:
    """``(local_bs, train_steps)`` of a multi-host epoch: each host's share
    ``ceil(batch_size / n_hosts)`` of the global batch, and the steps that
    cover the global dataset's ``n_items`` patches, counted before the
    songs are sharded so that every host takes the same number."""
    local_bs = -(-batch_size // n_hosts)
    return local_bs, -(-n_items // (local_bs * n_hosts))


def pad_rows(local_bs: int, mesh: Mesh) -> int:
    """The rows a host pads its batch to: ``local_bs`` rounded up to a
    multiple of :func:`local_quota`."""
    q = local_quota(mesh)
    return -(-local_bs // q) * q


def epoch_seed(seed: int, ep: int, host: int = 0) -> int:
    """The crop (and remix) seed of epoch ``ep`` on host ``host``
    (svs_tpu loop.py:651-652); host 0 is the single-host seed."""
    return seed * 100003 + ep + host * 7919


def global_batch_from_local(mesh: Mesh, batch,
                            pad_to: Optional[int] = None
                            ) -> Dict[str, torch.Tensor]:
    """This rank's block of its host's local ``batch`` (numpy arrays or
    tensors, the same on every rank of the host), as float32 on its
    device.

    ``pad_to``: the fixed row count every host pads to (a multiple of
    :func:`local_quota`): zero rows are appended and the 0/1 ``weight``
    (ones where absent) extended with zeros, so any local batch size cuts
    over the host's ranks and the pad rows drop out of every loss and
    BatchNorm reduction.  Without it the rows must be a multiple of the
    quota already.  Each rank takes ``pad_to / quota`` rows: the global
    batch is host 0's padded rows, then host 1's (svs_tpu
    multihost.py:34-75)."""
    rows_mesh = data_mesh(mesh)
    lq = rows_mesh.local_size
    batch = dict(batch)
    rows = mesh_lib._rows(batch)
    if pad_to is None:
        if rows % lq:
            raise ValueError(f"local batch rows {rows} not a multiple of "
                             f"this host's data-axis quota {lq}: pass "
                             "pad_to")
        n = rows
    else:
        if pad_to % lq:
            raise ValueError(f"pad_to={pad_to} not a multiple of this "
                             f"host's data-axis quota {lq}")
        if rows > pad_to:
            raise ValueError(f"local batch rows {rows} exceed pad_to="
                             f"{pad_to}")
        weight = batch.pop("weight", None)
        weight = (np.ones(rows, np.float32) if weight is None
                  else mesh_lib._as_tensor(weight).float().cpu().numpy())
        batch["weight"] = np.concatenate(
            [weight, np.zeros(pad_to - rows, np.float32)])
        n = pad_to
    per = n // lq
    return mesh_lib.rows_block(batch, rows_mesh.local_rank * per, per,
                               rows_mesh.device)


def per_rank(values: List[float], mesh: Optional[Mesh]) -> np.ndarray:
    """Every rank's ``values`` as a (size, len(values)) float64 array: a
    zero-filled all-reduce (adding zeros is exact)."""
    if not mesh_lib.crosses(mesh):
        return np.asarray([values], np.float64)
    t = torch.zeros(mesh.size, len(values), dtype=torch.float64)
    t[mesh.rank] = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(t, group=mesh.host_group or mesh.group)
    return t.numpy()


def assert_scalar_agreement(value: float, what: str, tol: float = 0.0,
                            mesh: Optional[Mesh] = None) -> None:
    """Raise ``RuntimeError`` on every rank when the ranks' ``value`` (the
    validation loss that drives the best checkpoint) differ by more than
    ``tol``, or one is not finite: a real fault (a reduction that is not
    deterministic, a wrong cut), caught before the hosts' best-checkpoint
    decisions part.  A collective over ``mesh``."""
    if not mesh_lib.crosses(mesh):
        return
    vals = per_rank([float(value)], mesh).ravel()
    spread = float(np.max(vals) - np.min(vals))
    if not (spread <= tol) or not np.isfinite(vals).all():
        raise RuntimeError(
            f"cross-host disagreement on {what}: per-host values "
            f"{vals.tolist()} (spread {spread:g} > tol {tol:g}) — hosts "
            "would desync")


def _params_checksum(state) -> float:
    """A float64 sum of the parameters' sums, in one order on every rank."""
    with torch.no_grad():
        return float(sum(float(p.detach().double().sum())
                         for p in state.model.parameters()))


def sync_resume(state, start_epoch: int, extras: Dict[str, Any],
                mesh: Mesh) -> Tuple[Any, int, Dict[str, Any]]:
    """Make a per-host resume safe across the hosts (svs_tpu
    multihost.py:175-248).  Every rank shares (start epoch, parameter
    checksum).  Where all agree the resume stands.  Where they differ (a
    host with a missing checkpoint resumed at epoch 0, or read a stale
    one):

    - if rank 0 holds the newest epoch, its whole state (parameters, BN
      statistics, Adam's moments, step count and learning rate, as a
      ``.ckpt`` holds them), its epoch and its ``extras``
      (``best_val_loss``, ``loss_list_total``) are broadcast to every rank,
      which loads them into its own state and then takes every tensor of
      rank 0's (``dp.replicate_state``), with a warning;
    - if another rank is ahead of rank 0, rank 0 cannot repair it: every
      rank raises ``RuntimeError``.

    Called on every rank after the restore and before the state is
    replicated or cut, whether or not this rank's file existed (a
    collective)."""
    if not mesh_lib.crosses(mesh):
        return state, start_epoch, extras
    from svs_torch.train import checkpoint as ckpt_lib

    both = per_rank([float(start_epoch), _params_checksum(state)], mesh)
    epochs, sums = both[:, 0], both[:, 1]
    if (epochs == epochs[0]).all() and (sums == sums[0]).all():
        return state, start_epoch, extras
    if epochs.max() > epochs[0]:
        raise RuntimeError(
            "resume desync: process 0 resumed at epoch "
            f"{int(epochs[0])} but another host is ahead "
            f"(per-host epochs {epochs.astype(int).tolist()}); process 0 "
            "cannot repair this — restore its checkpoint and restart")
    if mesh.is_primary:
        print(f"[multihost] resume desync detected (per-host epochs "
              f"{epochs.astype(int).tolist()}, checksums differ) — "
              "broadcasting process 0's train state to all hosts",
              flush=True)
    box = [ckpt_lib.to_bytes(state) if mesh.is_primary else None,
           int(start_epoch), dict(extras)]
    dist.broadcast_object_list(box, src=mesh.src,
                               group=mesh.host_group or mesh.group)
    data, start_epoch, extras = box
    if not mesh.is_primary:
        state, _, _ = ckpt_lib.from_bytes(data, state)
    # every tensor rank 0's, those a .ckpt does not hold (BatchNorm's
    # batch counters) too, now that the states have one structure
    dp.replicate_state(state, mesh)
    return state, int(start_epoch), extras
