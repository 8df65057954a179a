"""What the port's mesh ``epoch_scan`` tests run on their ranks (a
``svs_torch.parallel.launch.Ranks`` pool of gloo ranks on the CPU).

Each function takes the pool's mesh first and the number ``n`` of its
first ranks to run on (``dryrun.first_ranks``; the other ranks return
None at once).  This module imports torch and svs_torch only: the ranks
never import JAX, and what they return is numpy, which the tests hold
against svs_tpu in their own process.
"""

from __future__ import annotations

import torch

from svs_torch.data.dataset import PatchDataset
from svs_torch.data.device_data import DeviceDataset
from svs_torch.parallel import dryrun
from svs_torch.train import loop
from svs_torch.train import scan
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig

_subs = {}


def sub(mesh, n):
    """This rank's mesh among the pool's first ``n`` ranks, None past
    them; each sub-mesh made once, by every rank (a collective)."""
    if n not in _subs:
        _subs[n] = dryrun.first_ranks(mesh, n)
    return _subs[n]


def _np(state):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in state.model.state_dict().items()}


def epoch(mesh, n, cfg_kw, state_dict, folder, songs, starts, seed):
    """One ``make_epoch_scan(mesh=...)`` epoch from ``state_dict`` over the
    stacked global index matrices, dropout from a generator of ``seed``:
    the per-step losses, the step count and the final state dict."""
    m = sub(mesh, n)
    if m is None:
        return None
    cfg = SVSConfig(**cfg_kw)
    state = tstep.create_train_state(0, cfg, device="cpu")
    state.model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in state_dict.items()})
    ds = DeviceDataset(PatchDataset(folder,
                                    samples_per_song=cfg.samples_per_song,
                                    input_len=cfg.input_len), mesh=m)
    state, losses = scan.make_epoch_scan(cfg, mesh=m)(
        state, ds.planes, songs, starts, torch.Generator().manual_seed(seed))
    return losses.numpy().copy(), state.step, _np(state)


def fit(mesh, n, opts_kw, cfg_kw):
    """``fit`` over the first ``n`` ranks: the step counts, the open
    accumulation cycle (or None) and the final state dict of this rank."""
    m = sub(mesh, n)
    if m is None:
        return None
    state = loop.fit(loop.TrainOptions(mesh=m, device="cpu", **opts_kw),
                     SVSConfig(**cfg_kw))
    acc = (None if state.acc_grads is None
           else [g.numpy().copy() for g in state.acc_grads])
    return dict(step=state.step, mini_step=state.mini_step, acc=acc,
                state=_np(state))

