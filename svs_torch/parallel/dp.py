"""Data-parallel training and segment-parallel decode over a mesh (port of
``svs_tpu/parallel/dp.py``).

Train: one process per device, each holding the whole state and its rows
of the global batch (``mesh.shard_batch``).  Every reduction over the
batch crosses the ranks (``mesh.all_sum``): the loss's sums and BatchNorm's
statistics are the global weighted batch's (sync-BN, as svs_tpu's
``data``-sharded reductions are), so every rank computes the same global
loss.  Dropout masks are drawn at the global padded batch's shape from a
generator seeded alike on every rank, and each rank keeps its own rows.

The gradient rule.  ``all_sum``'s adjoint is the all-reduce SUM of the
upstream gradient, so backpropagating the global loss ``L`` on every rank
and summing the parameter gradients over the ranks would give
``size * dL/dparams``.  The step backpropagates ``L / size`` on every rank
and sums the gradients with one flat all-reduce: ``dL/dparams`` exactly,
BatchNorm's statistics included (their adjoints cross the ranks through
the same sums).  Adam then runs on the same gradient on every rank, so
every rank holds the same bits after a step.  ``grad_norm`` is the
all-reduced gradient's.

Infer: the segments of a song are independent (reference inference.py:
79-116), so each rank masks its own windows with no communication until
they are put back together (``infer.separate.separate_magnitude_mesh``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from svs_torch.losses.mrstft import combined_loss
from svs_torch.parallel.mesh import Mesh, crosses
from svs_torch.train.step import TrainState, _apply, global_norm
from svs_torch.utils.config import SVSConfig


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    """The state's tensors in one order on every rank: parameters and
    BatchNorm buffers, then Adam's per-parameter state."""
    out = list(state.model.state_dict().values())
    opt = state.optimizer.state
    for p in state.model.parameters():
        out += [opt[p][k] for k in sorted(opt.get(p, {}))
                if isinstance(opt[p][k], torch.Tensor)]
    return out


def _broadcast(t: torch.Tensor, mesh: Mesh) -> None:
    """``t`` (in place) from the group's rank 0; a host tensor (Adam's step
    count) rides on the mesh's device, where NCCL needs it."""
    buf = t if t.device == mesh.device else t.to(mesh.device)
    dist.broadcast(buf, src=mesh.src, group=mesh.group)
    if buf is not t:
        t.copy_(buf)


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Make every rank hold rank 0's parameters, BatchNorm buffers, Adam
    state and step count (in place; the state is returned).  Every rank
    must hold a state of the same structure.  A world of one holds it
    already."""
    if not crosses(mesh):
        return state
    tensors = _state_tensors(state)
    if _differs(len(tensors), mesh):
        raise ValueError("the ranks hold states of different structure")
    counters = torch.tensor([state.step, state.mini_step],
                            dtype=torch.int64)
    with torch.no_grad():
        for t in tensors:
            _broadcast(t, mesh)
        _broadcast(counters, mesh)
    state.step, state.mini_step = (int(v) for v in counters.tolist())
    return state


def _differs(n: int, mesh: Mesh) -> bool:
    """Whether ``n`` differs between the ranks."""
    t = torch.tensor([n, -n], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX,
                    group=mesh.host_group or mesh.group)
    return int(t[0]) != -int(t[1])


def _sum_over_ranks(grads: List[torch.Tensor], mesh: Mesh
                    ) -> List[torch.Tensor]:
    """The gradients summed over the ranks: one flat all-reduce (none in a
    world of one)."""
    if not crosses(mesh):
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    return [v.view_as(g) for v, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def dp_loss(cfg: SVSConfig, model: torch.nn.Module,
            batch: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator], mesh: Mesh,
            tensors: Optional[Dict[str, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The train-mode forward and the combined loss of this rank's block
    ``batch`` (with its ``weight``): the loss to backpropagate on this
    rank (``L / size``, the module's gradient rule) and the global
    metrics.  ``tensors``: parameters and buffers by state-dict name that
    the forward uses in place of the module's own
    (``torch.func.functional_call``; the FSDP step's gathered ones)."""
    model.train()
    weight = batch["weight"]
    kw = dict(weight=weight, generator=generator, mesh=mesh)
    if tensors:
        mask = torch.func.functional_call(model, tensors, (batch["mix"],),
                                          kw)
    else:
        mask = model(batch["mix"], **kw)
    total, aux = combined_loss(mask, batch["mix"], batch["voc"],
                               batch["mix_angle"], batch["voc_angle"], cfg,
                               weight=weight, group=mesh)
    seed = total / mesh.size if mesh.size > 1 else total
    return seed, {k: v.detach() for k, v in aux.items()}


def dp_loss_and_grads(cfg: SVSConfig, state: TrainState,
                      batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator], mesh: Mesh
                      ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """``step.loss_and_grads`` over the mesh: ``batch`` is this rank's
    block (with its ``weight``); the metrics are the global batch's and
    the gradients ``dL/dparams`` of the global loss, the same on every
    rank (the module's gradient rule)."""
    params = list(state.model.parameters())
    seed, metrics = dp_loss(cfg, state.model, batch, generator, mesh)
    grads = _sum_over_ranks(list(torch.autograd.grad(seed, params)), mesh)
    metrics["grad_norm"] = global_norm(grads)
    return grads, metrics


def make_dp_train_step(mesh: Mesh, cfg: Optional[SVSConfig] = None):
    """``step(state, local_batch, generator) -> (state, metrics)``: one
    optimisation step of the global batch whose rows ``local_batch``
    holds here (``mesh.shard_batch``).  ``metrics`` (``l1``, ``mr``,
    ``total``, ``grad_norm``) are the global values, the same on every
    rank; the state is updated in place, the same on every rank."""
    cfg = cfg or SVSConfig()

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None):
        grads, metrics = dp_loss_and_grads(cfg, state, batch, generator,
                                           mesh)
        _apply(state, grads)
        state.step += 1
        return state, metrics

    return step


def make_dp_eval_step(mesh: Mesh, cfg: Optional[SVSConfig] = None):
    """The validation step over sharded batches: eval-mode BatchNorm, the
    combined loss as the global weighted mean (svs_tpu's eval step on a
    batch-sharded batch)."""
    cfg = cfg or SVSConfig()

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            mask = model(batch["mix"])
            _, aux = combined_loss(mask, batch["mix"], batch["voc"],
                                   batch["mix_angle"], batch["voc_angle"],
                                   cfg, weight=batch["weight"], group=mesh)
        finally:
            model.train(was_training)
        return aux

    return step


def make_sp_separate(mesh: Mesh, cfg: Optional[SVSConfig] = None,
                     vocal_solo: bool = True):
    """Segment-parallel masking: ``fn(model, segs)`` with ``segs`` this
    rank's ``(S_local, F, input_len)`` windows on the mesh's device; the
    eval-mode masked windows, with no communication.  ``mesh`` and ``cfg``
    keep svs_tpu's signature: each rank masks its own windows, and the
    model carries its configuration."""

    @torch.inference_mode()
    def fn(model: torch.nn.Module, segs: torch.Tensor) -> torch.Tensor:
        if model.training:
            raise ValueError("separation needs the model in eval mode "
                             "(call model.eval())")
        mask = model(segs)
        if not vocal_solo:
            mask = 1.0 - mask
        return mask * segs

    return fn
