"""ZeRO-1 and FSDP: the training state sharded over the data mesh (port of
``svs_tpu/parallel/zero.py``).

svs_tpu gives the state's leaves sharding annotations and XLA derives the
collectives.  Here each rank holds its slices of the sharded leaves, and
the step writes its collectives out (``mesh.all_gather``,
``dp.dp_loss_and_grads``' flat all-reduce).  The forward, the loss, the
gradient rule and Adam are the DP step's (:mod:`svs_torch.parallel.dp`)
and torch's: the shard is the only thing that differs.

**The channel rule** (:func:`leaf_spec`, svs_tpu's ``tp.leaf_spec``,
tp.py:84-100), in torch's layouts: a conv weight shards its output
channels when ``n`` divides them, else its input channels, else it is held
whole; a per-channel vector shards dim 0; a scalar is held whole.
``Conv2d.weight`` is (O, I, k, k) and ``ConvTranspose2d.weight`` (I, O, k,
k), so the rule reads the owning module's kind, not the shape alone
(``deconv6.weight``, (32, 1, 5, 5) at the ``default`` preset, shards dim
0, its I).  Adam's moments and an accumulated gradient take their
parameter's dim; BatchNorm's running statistics dim 0.  The rule holds
every leaf whole on a mesh of one rank.

**Layouts** (:func:`shard_state`, :func:`make_zero1_train_step`):

- *ZeRO-1*: Adam's moments shard; parameters and BatchNorm buffers are
  held whole on every rank.  The step is the DP step's forward, loss and
  one flat gradient all-reduce, ``grad_norm`` the all-reduced gradient's;
  Adam then runs on this rank's slice of each parameter and gradient (the
  slices of the parameters are copied out for the update and hold no
  memory between steps), and one flat :func:`~mesh.all_gather` writes the
  updated slices back into the full parameters on every rank.
- *FSDP* (``fsdp=True``): parameters and running statistics shard too;
  the module's parameters ARE this rank's slices between steps, and Adam
  is bound to them.  A step gathers every sharded parameter and buffer in
  one flat ``all_gather`` and runs the same forward on them
  (``torch.func.functional_call``); the gather's backward all-reduces the
  upstream gradient (one flat all-reduce, as DP's) and returns this rank's
  slice; ``grad_norm`` is taken on the full all-reduced gradient before
  the slice, so it is DP's.  Adam runs on the slices, and each rank keeps
  its slice of the updated running statistics (the global statistics come
  from ``mesh.all_sum``, the same on every rank, so the slice is exact).
  The dataflow: the resting state drops n-fold, but the full parameters
  live for the whole step (gathered once before the forward, freed after
  the backward, a second copy where a slice is not contiguous), where
  svs_tpu leaves the schedule to XLA, which gathers each layer's kernel
  where the conv uses it.

Under ``accum_steps > 1`` MultiSteps' running mean runs on the slices:
the accumulated gradient shards as the moments do (svs_tpu's ``acc_grads``
are part of ``opt_state``).  At world size 1 nothing shards, and both
steps are ``make_train_step``'s bits; at world size 2 they are the DP
step's bits.

On a CUDA device over NCCL (or a world of one) both steps run as cached
captured programs, one a key (``train/graphs.py``, keyed on the layout and
the mesh).  ZeRO-1's update cuts fresh slices of the parameters for Adam
on every step and gathers the updated ones back: inside a program the cut,
Adam and the gather are all captured, so each replay writes the slices at
the addresses Adam's captured kernels read, and the binding (the model's
tensors, Adam's moments and counts) never moves.  FSDP's gather of the
parameters before the forward is captured with the step.

A checkpoint is written from :func:`unshard_state`, the full state
gathered leaf by leaf to the host (``mesh.gather_state``), as the
canonical ``.ckpt``: a run resumes into any layout.  Validation under FSDP
(:func:`make_zero1_eval_step`) gathers the parameters and the running
statistics inside the eval step, and so inside its program;
:func:`gathered` lends the model the full tensors for a block of code.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from svs_torch.parallel import dp
from svs_torch.parallel import mesh as mesh_lib
from svs_torch.parallel.mesh import Mesh
from svs_torch.train import graphs
from svs_torch.train.checkpoint import Snapshot
from svs_torch.train.step import TrainState, _apply, global_norm
from svs_torch.utils.config import SVSConfig

Dims = Dict[str, Optional[int]]


def leaf_spec(shape: Sequence[int], n: int, transposed: bool = False
              ) -> Optional[int]:
    """The dim a leaf of ``shape`` shards on over ``n`` ranks, or None when
    every rank holds it whole (the module's channel rule).  ``transposed``:
    the leaf is a ``ConvTranspose2d`` weight, (I, O, k, k)."""
    if n <= 1:
        return None
    if len(shape) == 4:
        out, inp = (1, 0) if transposed else (0, 1)
        for d in (out, inp):
            if shape[d] % n == 0 and shape[d] >= n:
                return d
    if len(shape) == 1 and shape[0] % n == 0 and shape[0] >= n:
        return 0
    return None


def tree_shardings(model: nn.Module, n: int) -> Dims:
    """The rule's dim of every parameter and buffer of ``model`` over ``n``
    ranks, by state-dict name (a parameter's is its moments' too)."""
    dims: Dims = {}
    for prefix, module in model.named_modules():
        transposed = isinstance(module, nn.ConvTranspose2d)
        leaves = list(module.named_parameters(recurse=False)) + list(
            module.named_buffers(recurse=False))
        for name, t in leaves:
            key = f"{prefix}.{name}" if prefix else name
            dims[key] = leaf_spec(t.shape, n, transposed)
    return dims


def state_shardings(mesh: Mesh, cfg: Optional[SVSConfig] = None,
                    fsdp: bool = False) -> Dict[str, Dims]:
    """:func:`tree_shardings` from ``cfg`` alone, as the layout holds each
    leaf: ``model`` (every state-dict entry; held whole but under FSDP)
    and ``opt`` (each parameter's Adam moments)."""
    from svs_torch.models.unet import UNet

    with torch.device("meta"):
        model = UNet(cfg or SVSConfig())
    rule = tree_shardings(model, mesh.size)
    return {"model": {k: (d if fsdp else None) for k, d in rule.items()},
            "opt": {k: rule[k] for k in _param_names(model)}}


@dataclasses.dataclass
class ZeroState(TrainState):
    """A :class:`TrainState` sharded over ``mesh``: Adam is bound to this
    rank's slices of the parameters (ZeRO-1: copies made for each update;
    FSDP: the module's parameters, which are slices), its moments and
    ``acc_grads`` are slices; under FSDP so are the BatchNorm running
    statistics.  ``dims``: the rule's dim of each state-dict entry."""
    mesh: Optional[Mesh] = None
    fsdp: bool = False
    dims: Dims = dataclasses.field(default_factory=dict)


def _cut(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim`` as a tensor of its own (the
    full one can be freed); ``t`` itself when ``dim`` is None."""
    if dim is None:
        return t
    return mesh_lib.local_block(t, dim, mesh).clone(
        memory_format=torch.contiguous_format)


def _param_names(model: nn.Module) -> List[str]:
    return [n for n, _ in model.named_parameters()]


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    prefix, _, attr = name.rpartition(".")
    return model.get_submodule(prefix), attr


def _set_leaf(model: nn.Module, name: str, value: torch.Tensor) -> None:
    """Point a parameter (its ``.data``) or a buffer at ``value``."""
    module, attr = _owner(model, name)
    if attr in module._parameters:
        module._parameters[attr].data = value
    else:
        module._buffers[attr] = value


def shard_state(state: TrainState, mesh: Mesh, fsdp: bool = False
                ) -> ZeroState:
    """``state`` (the same on every rank: ``dp.replicate_state`` first) as
    this rank's resting ZeRO-1 state, or with ``fsdp`` its FSDP state: the
    slices are cut, the full tensors they came from are let go, and a new
    Adam with the same hyperparameters takes over the sliced moments.  The
    module is shared with ``state``."""
    model, old = state.model, state.optimizer
    dims = tree_shardings(model, mesh.size)
    named = list(model.named_parameters())
    shapes = {n: p.shape for n, p in named}
    with torch.no_grad():
        if fsdp:
            for name, t in model.state_dict(keep_vars=True).items():
                if dims[name] is not None:
                    _set_leaf(model, name, _cut(t.data, dims[name], mesh))
            params = [p for _, p in named]
        else:
            params = [p if dims[n] is None
                      else torch.empty(0, dtype=p.dtype, device=p.device)
                      for n, p in named]
        opt = type(old)(params, **old.defaults)
        opt.param_groups[0].update({k: v for k, v in
                                    old.param_groups[0].items()
                                    if k != "params"})
        for (name, p), q in zip(named, params):
            for k, v in old.state.get(p, {}).items():
                # the moments are cut; Adam's step count is a scalar
                opt.state[q][k] = (_cut(v, dims[name], mesh)
                                   if v.shape == shapes[name] else v)
        acc = None
        if state.acc_grads is not None:
            acc = [_cut(g, dims[n], mesh)
                   for (n, _), g in zip(named, state.acc_grads)]
    return ZeroState(model, opt, step=state.step,
                     accum_steps=state.accum_steps,
                     mini_step=state.mini_step, acc_grads=acc,
                     mesh=mesh, fsdp=fsdp, dims=dims)


# ----------------------------------------------------------- flat gathers


def _unflatten(full: torch.Tensor, shapes: Sequence[torch.Size],
               dims: Sequence[int], n: int) -> List[torch.Tensor]:
    """The full tensors from a flat gather: ``full`` is every rank's flat
    slices in rank order, (n * S,); block r of each leaf along its dim is
    rank r's slice."""
    sizes = [math.prod(s) for s in shapes]
    rows = full.view(n, -1).split(sizes, dim=1)
    return [r.reshape(n, *s).movedim(0, d).flatten(d, d + 1)
            for r, s, d in zip(rows, shapes, dims)]


def _gather_flat(slices: Sequence[torch.Tensor], dims: Sequence[int],
                 mesh: Mesh, reduced: Optional[list] = None
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One flat ``all_gather`` of ``slices``: the flat leaf it started from
    (a copy of the slices) and the full tensors.  With ``reduced`` the
    gather is differentiable in the flat leaf, and ``reduced`` receives
    the all-reduced full gradient in the backward."""
    flat = torch.cat([s.detach().reshape(-1) for s in slices])
    if reduced is not None:
        flat.requires_grad_()
    full = mesh_lib.all_gather(flat, 0, mesh, reduced)
    return flat, _unflatten(full, [s.shape for s in slices], dims, mesh.size)


def _fsdp_loss_and_grads(cfg: SVSConfig, state: ZeroState,
                         batch: Dict[str, torch.Tensor],
                         generator: Optional[torch.Generator]
                         ) -> Tuple[List[torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """``dp.dp_loss_and_grads`` on the gathered parameters and buffers:
    this rank's slice of each parameter's gradient (the whole gradient of
    a parameter held whole), the global metrics; the running statistics
    the forward updated are cut back to this rank's slices."""
    mesh, model = state.mesh, state.model
    leaves = model.state_dict(keep_vars=True)
    names = _param_names(model)
    sharded = [n for n in leaves if state.dims[n] is not None]
    whole = [n for n in names if state.dims[n] is None]
    dims = [state.dims[n] for n in sharded]
    tensors, reduced, flat = {}, [], None
    if sharded:
        flat, fulls = _gather_flat([leaves[n] for n in sharded], dims, mesh,
                                   reduced)
        tensors = dict(zip(sharded, fulls))
        for n in sharded:
            if n not in names:  # a buffer: the forward writes it in place
                tensors[n] = tensors[n].detach().clone()
    seed, metrics = dp.dp_loss(cfg, model, batch, generator, mesh, tensors)
    inputs = ([flat] if flat is not None else []) + [leaves[n]
                                                     for n in whole]
    got = list(torch.autograd.grad(seed, inputs))
    flat_grad = got.pop(0) if flat is not None else None
    grads = dict(zip(whole, dp._sum_over_ranks(got, mesh)))
    full_grads = dict(grads)
    if flat is not None:
        shapes = [leaves[n].shape for n in sharded]
        sizes = [math.prod(s) for s in shapes]
        for n, g, s in zip(sharded, flat_grad.split(sizes), shapes):
            grads[n] = g.view(s)
        with torch.no_grad():
            full_grads.update(zip(sharded, _unflatten(
                reduced[0], shapes, dims, mesh.size)))
            for n in sharded:
                if n not in names:
                    leaves[n].copy_(mesh_lib.local_block(
                        tensors[n], state.dims[n], mesh))
    metrics["grad_norm"] = global_norm([full_grads[n] for n in names])
    return [grads[n] for n in names], metrics


def zero_loss_and_grads(cfg: SVSConfig, state: ZeroState,
                        batch: Dict[str, torch.Tensor],
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[List[torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """``dp.dp_loss_and_grads`` for a sharded state: this rank's slice of
    each parameter's gradient of the global loss (the whole gradient of a
    parameter held whole), in the parameters' order, and the global
    metrics (``grad_norm`` the full gradient's)."""
    if state.fsdp:
        return _fsdp_loss_and_grads(cfg, state, batch, generator)
    grads, metrics = dp.dp_loss_and_grads(cfg, state, batch, generator,
                                          state.mesh)
    return [g if state.dims[n] is None else mesh_lib.local_block(
        g, state.dims[n], state.mesh).contiguous()
        for n, g in zip(_param_names(state.model), grads)], metrics


def _zero1_update(state: ZeroState, cut: List[torch.Tensor]) -> None:
    """Adam on this rank's slices of the full parameters (``cut``: the
    gradient's slices), then one flat gather of the updated slices into
    the parameters."""
    mesh, model = state.mesh, state.model
    names = _param_names(model)
    params = list(model.parameters())
    work = state.optimizer.param_groups[0]["params"]
    sharded = [i for i, (w, p) in enumerate(zip(work, params)) if w is not p]
    with torch.no_grad():
        for i in sharded:
            work[i].data = _cut(params[i].data, state.dims[names[i]], mesh)
        try:
            if _apply(state, cut, work) and sharded:
                _, fulls = _gather_flat([work[i] for i in sharded],
                                        [state.dims[names[i]]
                                         for i in sharded], mesh)
                for i, full in zip(sharded, fulls):
                    params[i].copy_(full)
        finally:
            for i in sharded:
                work[i].data = work[i].data.new_empty(0)


def zero_body(cfg: SVSConfig, fsdp: bool = False):
    """The sharded step without its count: ``body(state, local_batch,
    generator) -> metrics`` (:func:`zero_loss_and_grads`, then Adam on the
    slices; ZeRO-1's gathers the updated slices back).  What the step's
    program captures."""

    def body(state: ZeroState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        grads, metrics = zero_loss_and_grads(cfg, state, batch, generator)
        if fsdp:
            _apply(state, grads)
        else:
            _zero1_update(state, grads)
        return metrics

    return body


def make_zero1_train_step(mesh: Mesh, cfg: Optional[SVSConfig] = None,
                          fsdp: bool = False):
    """``step(state, local_batch, generator) -> (state, metrics)`` on a
    :class:`ZeroState` of the same layout (:func:`shard_state`): the DP
    step's contract (``dp.make_dp_train_step``): ``metrics`` the global
    values, the same on every rank; the state updated in place and still
    sharded.  A program where the DP step is one; ``step.eager`` is the
    eager body."""
    cfg = cfg or SVSConfig()

    def check(state: TrainState) -> None:
        if (not isinstance(state, ZeroState) or state.fsdp != fsdp
                or state.mesh is not mesh):
            raise ValueError(f"the {'FSDP' if fsdp else 'ZeRO-1'} step "
                             "needs a state from shard_state(state, mesh, "
                             f"fsdp={fsdp}) on its mesh")

    return graphs.train_step(cfg, zero_body(cfg, fsdp),
                             "fsdp" if fsdp else "zero1", mesh, check)


def make_zero1_eval_step(mesh: Mesh, cfg: Optional[SVSConfig] = None,
                         fsdp: bool = False):
    """The validation step of a state sharded by :func:`shard_state`: the
    DP eval step (``dp.make_dp_eval_step``) on the full model.  ZeRO-1's
    model is whole; FSDP's step gathers its parameters and running
    statistics (one flat gather, a collective) and puts the slices back
    before it returns, so its program holds the gather.  The channel rule's
    dims come from ``cfg``'s model."""
    cfg = cfg or SVSConfig()
    if not fsdp:
        return dp.make_dp_eval_step(mesh, cfg)
    dims = state_shardings(mesh, cfg, fsdp=True)["model"]
    dp_eval = dp.dp_eval_body(cfg, mesh)

    def body(model: nn.Module, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        with _gathered(model, dims, mesh):
            return dp_eval(model, batch)

    def check(state: TrainState) -> None:
        if not (isinstance(state, ZeroState) and state.fsdp
                and state.mesh is mesh and state.dims == dims):
            raise ValueError("the FSDP eval step needs a state from "
                             "shard_state(state, mesh, fsdp=True) of its "
                             "config on its mesh")

    return graphs.eval_step(cfg, body, "fsdp", mesh, check)


# ---------------------------------------------------- the full state back


def unshard_state(state: TrainState) -> Snapshot:
    """The full state as a host :class:`~svs_torch.train.checkpoint.
    Snapshot`, the canonical checkpoint's content, gathered leaf by leaf
    (``mesh.gather_state``); a collective under ZeRO-1 and FSDP, called
    by every rank.  A state that is not sharded is copied to the host."""
    model, opt = state.model, state.optimizer
    mesh = state.mesh if isinstance(state, ZeroState) else None
    dims = state.dims if isinstance(state, ZeroState) else {}
    fsdp = isinstance(state, ZeroState) and state.fsdp
    sd = model.state_dict()
    full_sd = dict(zip(sd, mesh_lib.gather_state(
        [(t, dims[n] if fsdp else None) for n, t in sd.items()], mesh)))
    names = _param_names(model)
    work = opt.param_groups[0]["params"]
    moments: Dict[str, Dict[str, torch.Tensor]] = {"exp_avg": {},
                                                   "exp_avg_sq": {}}
    count = 0
    for name, p in zip(names, work):
        st = opt.state.get(p)
        if st:
            count = int(st["step"])
            for k in moments:
                moments[k][name], = mesh_lib.gather_state(
                    [(st[k], dims.get(name))], mesh)
    acc = None
    if state.acc_grads is not None:
        acc = dict(zip(names, mesh_lib.gather_state(
            [(g, dims.get(n)) for n, g in zip(names, state.acc_grads)],
            mesh)))
    group = opt.param_groups[0]
    return Snapshot(state_dict=full_sd, adam_count=count,
                    exp_avg=moments["exp_avg"],
                    exp_avg_sq=moments["exp_avg_sq"],
                    lr=float(group["lr"]), betas=tuple(group["betas"]),
                    eps=float(group["eps"]), step=int(state.step),
                    accum_steps=state.accum_steps,
                    mini_step=int(state.mini_step), acc_grads=acc)


@contextlib.contextmanager
def gathered(state: TrainState) -> Iterator[nn.Module]:
    """The model holding its full parameters and running statistics for
    the duration (a collective under FSDP: every rank enters; the slices
    come back on exit); ZeRO-1's and an unsharded state's model as it
    is."""
    if not (isinstance(state, ZeroState) and state.fsdp):
        yield state.model
        return
    with _gathered(state.model, state.dims, state.mesh) as model:
        yield model


@contextlib.contextmanager
def _gathered(model: nn.Module, dims: Dims, mesh: Mesh
              ) -> Iterator[nn.Module]:
    """:func:`gathered` of a model that holds its slices of the leaves the
    rule cuts (``dims``) over ``mesh``."""
    leaves = model.state_dict(keep_vars=True)
    sharded = [n for n in leaves if dims[n] is not None]
    if not (sharded and mesh_lib.crosses(mesh)):
        yield model
        return
    with torch.no_grad():
        _, fulls = _gather_flat([leaves[n] for n in sharded],
                                [dims[n] for n in sharded], mesh)
    held = {n: leaves[n].data if isinstance(leaves[n], nn.Parameter)
            else leaves[n] for n in sharded}
    try:
        for n, full in zip(sharded, fulls):
            _set_leaf(model, n, full)
        yield model
    finally:
        for n, t in held.items():
            _set_leaf(model, n, t)


def state_bytes(state: TrainState) -> int:
    """The bytes of the tensors a rank holds between steps: the model's
    parameters and buffers, Adam's parameters where they are not the
    model's and its state, the accumulated gradient."""
    seen: Dict[int, torch.Tensor] = {}
    tensors = list(state.model.state_dict(keep_vars=True).values())
    tensors += state.optimizer.param_groups[0]["params"]
    for st in state.optimizer.state.values():
        tensors += [v for v in st.values() if isinstance(v, torch.Tensor)]
    tensors += list(state.acc_buffers or state.acc_grads or [])
    for t in tensors:
        seen[id(t)] = t
    return sum(t.nelement() * t.element_size() for t in seen.values())
