"""What the port's CP tests run on their ranks (a
``svs_torch.parallel.launch.Ranks`` pool of gloo ranks on the CPU).

Each function takes the rank's mesh (the pool's world) first; the ``n``
it may take views the pool's first ``n`` ranks as a mesh of their own
(the other ranks return None).  This module imports torch and svs_torch
only: the ranks never import JAX, and what they return is numpy, which
the tests hold against svs_tpu and the single-process step in their own
process.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from svs_torch.infer import separate
from svs_torch.parallel import dp, dryrun, halo
from svs_torch.parallel import mesh as mesh_lib
from svs_torch.utils.config import SVSConfig

import torch_dp_workers as W

# the pool's first n ranks as a mesh, made once: every rank of the pool
# makes each group at the same call
_subs = {}


def sub(mesh, n):
    """The mesh of the pool's first ``n`` ranks on those ranks, else
    None."""
    if n not in _subs:
        _subs[n] = dryrun.first_ranks(mesh, n)
    return _subs[n]


class _Replicated(torch.autograd.Function):
    """A tensor every rank holds alike: the identity, whose adjoint is the
    mean of the ranks' gradients.  Every rank backpropagates the same
    upstream gradient of a gathered output; under ``all_gather``'s
    ``L / size`` rule each rank's gradient then carries its own block's
    path at ``size`` times its weight, and the mean over the ranks is the
    gradient of the whole function."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        return g / ctx.mesh.size, None


def halo_check(mesh, n, h, t_loc):
    """``mesh.halo_exchange`` over the first ``n`` ranks: the largest
    |difference| of each rank's output from its slice of the zero-padded
    whole tensor (float32), and whether ``torch.autograd.gradcheck`` in
    float64 passes for the function whole tensor -> every rank's
    exchanged block, gathered."""
    m = sub(mesh, n)
    if m is None:
        return None
    rng = np.random.default_rng(7)
    whole = torch.from_numpy(rng.standard_normal((1, 2, 2, n * t_loc)))
    got = mesh_lib.halo_exchange(
        mesh_lib.local_block(whole.float(), 3, m).contiguous(), h, m)
    want = torch.nn.functional.pad(whole.float(), (h, h))[
        ..., m.rank * t_loc:m.rank * t_loc + t_loc + 2 * h]
    err = float((got - want).abs().max())

    def fn(x):
        block = mesh_lib.local_block(_Replicated.apply(x, m), 3, m)
        return mesh_lib.all_gather(
            mesh_lib.halo_exchange(block.contiguous(), h, m), 3, m)

    ok = torch.autograd.gradcheck(fn, (whole.clone().requires_grad_(),),
                                  eps=1e-6, atol=1e-8)
    return {"max_abs_err": err, "gradcheck": bool(ok),
            "shape": list(got.shape)}


def apply(mesh, cfg_kw, state_dict, mix):
    """``halo.make_time_sharded_apply``'s mask of the whole ``mix`` on this
    rank."""
    model = W._state(SVSConfig(**cfg_kw), state_dict).model.eval()
    return halo.make_time_sharded_apply(mesh)(model, mix).numpy()


def steps(mesh, n, cfg_kw, batches, state_dict=None):
    """CP steps over the first ``n`` ranks of the whole host ``batches``
    from the state of seed 0 (or ``state_dict``), dropout from one
    generator of seed 1: each step's metrics and state dict."""
    m = sub(mesh, n)
    if m is None:
        return None
    cfg = SVSConfig(**cfg_kw)
    state = dp.replicate_state(W._state(cfg, state_dict), m)
    step = halo.make_cp_train_step(m, cfg)
    gen = torch.Generator().manual_seed(1)
    metrics, sds = [], []
    for b in batches:
        state, got = step(state, halo.shard_batch_time(m, b), gen)
        metrics.append({k: float(v) for k, v in got.items()})
        sds.append(W._np(state.model.state_dict()))
    return {"metrics": metrics, "sds": sds}


def decode(mesh, cfg_kw, state_dict, mag, vocal_solo):
    """``separate_magnitude_mesh(mode="whole")`` of ``mag``; rank 0's
    output (None from the other ranks)."""
    model = W._state(SVSConfig(**cfg_kw), state_dict).model.eval()
    return separate.separate_magnitude_mesh(model, mag, mesh, mode="whole",
                                            vocal_solo=vocal_solo)


def decode_programs(mesh, n, cfg_kw, state_dict, mag):
    """``separate_magnitude_mesh(mode="whole")`` of ``mag`` over the first
    ``n`` ranks, both ways of ``vocal_solo`` twice each, through the
    programs (``torch_dp_workers.decode_routed``), then eagerly: every
    rank's outputs of each form and the programs its cache built and
    holds (None beyond the first ``n`` ranks)."""
    m = sub(mesh, n)
    if m is None:
        return None
    model = W._state(SVSConfig(**cfg_kw), state_dict).model.eval()
    out = {}
    for form in ("program", "eager"):
        with W.decode_routed(form == "program") as cache:
            got = []
            for solo in (True, False, True, False):
                # every rank's mask, gathered in the program: rank 0's
                # song and the others' None, as the decode returns them
                got.append(separate.separate_magnitude_mesh(
                    model, mag, m, mode="whole", vocal_solo=solo))
            out[form] = got
            out[f"{form}_builds"] = (cache.builds, len(cache))
            out[f"{form}_mask"] = halo.make_time_sharded_apply(m)(
                model, np.pad(mag, ((0, 0), (0, 68)))[None, 1:]).numpy()
    return out


def fit(mesh, n, opts_kw, cfg_kw):
    """``torch_dp_workers.fit`` over the first ``n`` ranks with
    ``parallel='cp'``."""
    m = sub(mesh, n)
    if m is None:
        return None
    return W.fit(m, dict(opts_kw, parallel="cp"), cfg_kw)
