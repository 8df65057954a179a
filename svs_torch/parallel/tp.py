"""Tensor (channel) parallelism on a 2-D ``(data, model)`` mesh (port of
``svs_tpu/parallel/tp.py``).

svs_tpu annotates shardings and lets GSPMD derive the collectives.  Torch
has no GSPMD, so here the forward is written channel-partitioned, one
process a device, on :class:`~svs_torch.parallel.mesh.Mesh2D`'s two 1-D
meshes: the batch is cut over ``data`` (``mesh.shard_batch``), the
channels over ``model`` (``mesh.make_2d_mesh``, svs_tpu's
``tp.make_2d_mesh``).

**The rule** is svs_tpu's ``tp.leaf_spec`` in torch's layouts, ZeRO's
``zero.leaf_spec`` over ``n_model`` ranks: a conv weight cuts its output
channels, else its input channels (``deconv6``: O = 1, I = 32), else it is
held whole; bias, BN scale, BN bias, the running statistics and Adam's
moments cut dim 0 with their layer; ``deconv6.bias`` and the scalars are
held whole.  TP's resting layout is so FSDP's over the model sub-mesh
(:func:`shard_state` is ``zero.shard_state(state, mesh.model,
fsdp=True)``): the module's parameters and BN buffers ARE this rank's
slices, Adam is bound to them and runs locally on them, and a checkpoint
gathers them over the model sub-mesh (``zero.unshard_state``).

**The forward** (:func:`forward`), level by level as ``UNet.forward``,
with its ``batch_norm``, ``dropout_keep`` / ``dropout2d`` and casts:

- a layer whose weight cuts O runs its conv on the full input with this
  rank's O slice and bias; BatchNorm runs on the rank's channels (it holds
  every row of them, so the train-mode statistics cross only the data
  sub-mesh, sync-BN as DP's); then the activation and Dropout2d, and
  ``mesh.all_gather`` over the model sub-mesh gives the full activation
  for the next conv and the skip;
- a layer whose weight cuts I (``deconv6``, on the concat of ``dec5``'s
  output and ``enc1``'s) convolves this rank's block of the input
  channels, the bf16 products summed in float32; the partial outputs are
  summed over the model sub-mesh (``mesh.all_sum``), rounded to the
  compute dtype once, and the whole bias is added;
- a layer held whole runs on every model rank alike.

Dropout2d's keep mask is drawn at the global (B, C) shape from the one
generator, as ``make_train_step`` draws it, and cut to this data row's
rows and this rank's channels.  The loss (masked L1 and MR-STFT through
``cfg.mr_mag_impl``: the CUDA loss kernels under ``pallas_fused`` and
``pallas_bf16``) runs on every model rank on the same mask, its sums
crossing the data sub-mesh.

**The gradient rule** is ``dp.dp_loss``'s, which the adjoints of
``all_gather`` and ``all_sum`` assume: every rank backpropagates ``L /
size`` over the whole world.  A cut leaf's gradient then arrives whole
through the gathers' adjoints, a leaf held whole is summed over the model
sub-mesh, and every leaf over the data sub-mesh; ``grad_norm`` is the full
gradient's (the squared slices summed over the model sub-mesh, each whole
leaf counted once).  A world of one runs ``make_train_step``'s arithmetic
in its order, so its step is that step's bits.

The train and eval steps run on a CUDA device over NCCL (or a world of
one) as cached captured programs, one a key (``train/graphs.py``, keyed on
the layout and the ``Mesh2D``), the row and column groups' collectives
captured with the step; gloo ranks on a CUDA device run the eager bodies.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from svs_torch.losses.mrstft import combined_loss
from svs_torch.models.unet import (UNet, batch_norm, decoder_io, dropout2d,
                                   dropout_keep)
from svs_torch.parallel import dp, zero
from svs_torch.parallel import mesh as mesh_lib
from svs_torch.parallel.mesh import Mesh2D
from svs_torch.train import graphs
from svs_torch.train.step import TrainState, _apply, global_norm
from svs_torch.utils.config import SVSConfig
from svs_torch.utils.device import torch_dtype


def shard_state(state: TrainState, mesh: Mesh2D) -> zero.ZeroState:
    """``state`` (the same on every rank: ``dp.replicate_state`` over the
    world first) as this rank's resting TP state: every parameter, BN
    buffer and Adam moment cut to its slice under the channel rule over
    the model sub-mesh.  Refuses a model sub-mesh over which the rule
    cuts nothing: the step would run the unsharded forward on every
    rank."""
    if mesh.model.size > 1 and all(
            d is None for d in zero.tree_shardings(
                state.model, mesh.model.size).values()):
        raise ValueError(f"the channel rule cuts no leaf over "
                         f"{mesh.model.size} model ranks")
    return zero.shard_state(state, mesh.model, fsdp=True)


def _conv(model: UNet, name: str, x: torch.Tensor, dims: zero.Dims,
          mesh: Mesh2D, cd: torch.dtype) -> Tuple[torch.Tensor, bool]:
    """Layer ``name`` (``conv{i}.0`` or ``deconv{i}``) of the full input
    ``x`` under the rule's cut of its weight, in the compute dtype ``cd``;
    and whether the output is this rank's block of the channels."""
    layer = model.get_submodule(name)
    transposed = isinstance(layer, nn.ConvTranspose2d)
    dim = dims[f"{name}.weight"]
    split_in = dim is not None and dim != (1 if transposed else 0)
    w = layer.weight.to(cd)
    x = x.to(cd)
    if split_in:
        # exact products of the rounded operands, summed in float32 here
        # and over the ranks, rounded once as the whole conv rounds
        x = mesh_lib.local_block(x, 1, mesh.model).float()
        w = w.float()
    if transposed:
        y = F.conv_transpose2d(x, w, None, layer.stride, layer.padding,
                               layer.output_padding)
    else:
        y = F.conv2d(x, w, None, layer.stride, layer.padding)
    if split_in:
        y = mesh_lib.all_sum(y, mesh.model).to(cd)
    cut_out = dim is not None and not split_in
    return y + layer.bias.to(cd)[None, :, None, None], cut_out


def _bn(model: UNet, name: str, y: torch.Tensor, train: bool,
        weight: Optional[torch.Tensor], mesh: Mesh2D):
    bn = model.get_submodule(name)
    return batch_norm(y, bn.weight, bn.bias, bn.running_mean,
                      bn.running_var, train=train, eps=bn.eps,
                      momentum=bn.momentum, weight=weight, group=mesh.data)


def forward(model: UNet, dims: zero.Dims, mix: torch.Tensor, mesh: Mesh2D,
            cfg: SVSConfig, *, train: bool,
            weight: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The channel-partitioned U-Net on this rank's rows ``mix`` (B, F, T)
    of the global batch: the (B, F, T) float32 mask, the same on every
    model rank.  ``model`` holds this rank's slices (:func:`shard_state`),
    ``dims`` the rule's dim of each leaf.  Train mode (``train``) takes
    BatchNorm's statistics over the global weighted batch, writes this
    rank's slices of the running statistics and draws Dropout2d from
    ``generator``; ``cfg.remat`` recomputes each level in the backward, as
    ``UNet.forward`` does."""
    cd = torch_dtype(cfg.compute_dtype)
    remat = cfg.remat and torch.is_grad_enabled()

    def run(level, *args):
        if remat:
            return checkpoint(level, *args, use_reentrant=False)
        return level(*args)

    def enc_level(i, x):
        y, cut = _conv(model, f"conv{i}.0", x, dims, mesh, cd)
        y, new_mean, new_var = _bn(model, f"conv{i}.1", y, train, weight,
                                   mesh)
        y = torch.where(y >= 0, y, cfg.leaky_slope * y)  # LeakyReLU
        if cut:
            y = mesh_lib.all_gather(y, 1, mesh.model)
        return y, new_mean, new_var

    def dec_level(i, inp, keep):
        y, cut = _conv(model, f"deconv{i}", inp, dims, mesh, cd)
        y, new_mean, new_var = _bn(model, f"deconv{i}_BAD.0", y, train,
                                   weight, mesh)
        # ReLU with JAX's gradient at an exact 0 (UNet.dec_level)
        y = torch.maximum(y, torch.zeros_like(y))
        if keep is not None:
            y = dropout2d(y, cfg.dropout_rate, keep=keep)
        if cut:
            y = mesh_lib.all_gather(y, 1, mesh.model)
        return y, new_mean, new_var

    x = mix.to(torch.float32)[:, None]
    skips = []
    for i in range(1, 7):
        x, new_mean, new_var = run(enc_level, i, x)
        if train:
            model.get_submodule(f"conv{i}.1").update(new_mean, new_var)
        skips.append(x)
    channels = [c for _, c in decoder_io(cfg.enc_channels)]
    for i in range(1, 6):
        inp = skips[5] if i == 1 else torch.cat([x, skips[6 - i]], dim=1)
        keep = None
        if train:
            b, rank = inp.shape[0], mesh.data.rank
            keep = dropout_keep((b * mesh.data.size, channels[i - 1]),
                                cfg.dropout_rate, inp.device,
                                generator)[rank * b:(rank + 1) * b]
            if dims[f"deconv{i}.weight"] == 1:
                keep = mesh_lib.local_block(keep, 1, mesh.model)
        x, new_mean, new_var = run(dec_level, i, inp, keep)
        if train:
            model.get_submodule(f"deconv{i}_BAD.0").update(new_mean,
                                                          new_var)
    # deconv6 (no BN, ReLU or dropout): O = 1 never cuts over > 1 rank
    y, _ = _conv(model, "deconv6", torch.cat([x, skips[0]], dim=1), dims,
                 mesh, cd)
    return torch.sigmoid(y.to(torch.float32))[:, 0]


def _check(state: TrainState, mesh: Mesh2D) -> None:
    if not (isinstance(state, zero.ZeroState) and state.mesh is mesh.model):
        raise ValueError("the TP step needs a state from "
                         "tp.shard_state(state, mesh) on its mesh")


def _full_norm(grads: List[torch.Tensor], whole: List[bool],
               mesh: Mesh2D) -> torch.Tensor:
    """The L2 norm of the full gradient, given each leaf's whole gradient
    or this rank's slice of it (``whole``: which)."""
    if not mesh_lib.crosses(mesh.model):
        return global_norm(grads)
    cut = sum(torch.sum(torch.square(g)) for g, w in zip(grads, whole)
              if not w)
    dist.all_reduce(cut, group=mesh.model.group)
    return torch.sqrt(cut + sum(torch.sum(torch.square(g))
                                for g, w in zip(grads, whole) if w))


def tp_loss_and_grads(cfg: SVSConfig, state: zero.ZeroState,
                      batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator], mesh: Mesh2D
                      ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """The train-mode forward and backward of this data row's block
    ``batch`` (with its ``weight``): each parameter's gradient of the
    global loss (this rank's slice of a cut one), in the parameters'
    order, and the global metrics, the same on every rank."""
    model = state.model.train()
    names = [n for n, _ in model.named_parameters()]
    weight = batch["weight"]
    mask = forward(model, state.dims, batch["mix"], mesh, cfg, train=True,
                   weight=weight, generator=generator)
    total, aux = combined_loss(mask, batch["mix"], batch["voc"],
                               batch["mix_angle"], batch["voc_angle"], cfg,
                               weight=weight, group=mesh.data)
    seed = total / mesh.size if mesh.size > 1 else total
    grads = list(torch.autograd.grad(seed, list(model.parameters())))
    whole = [state.dims[n] is None for n in names]
    if mesh_lib.crosses(mesh.model):
        at = [i for i, w in enumerate(whole) if w]
        for i, g in zip(at, dp._sum_over_ranks([grads[i] for i in at],
                                               mesh.model)):
            grads[i] = g
    grads = dp._sum_over_ranks(grads, mesh.data)
    metrics = {k: v.detach() for k, v in aux.items()}
    metrics["grad_norm"] = _full_norm(grads, whole, mesh)
    return grads, metrics


def make_tp_train_step(mesh: Mesh2D, cfg: Optional[SVSConfig] = None):
    """``step(state, local_batch, generator) -> (state, metrics)`` on a
    state from :func:`shard_state`: one optimisation step of the global
    batch whose rows ``local_batch`` holds here (``mesh.shard_batch`` over
    ``mesh.data``: every model rank of a data row gets the same rows).
    ``make_train_step``'s semantics; ``metrics`` the global values, the
    same on every rank; the state updated in place and still cut.  A
    program where the DP step is one; ``step.eager`` is the eager body."""
    cfg = cfg or SVSConfig()

    def body(state: zero.ZeroState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        grads, metrics = tp_loss_and_grads(cfg, state, batch, generator,
                                           mesh)
        _apply(state, grads)
        return metrics

    return graphs.train_step(cfg, body, "tp", mesh,
                             lambda state: _check(state, mesh))


def make_tp_eval_step(mesh: Mesh2D, cfg: Optional[SVSConfig] = None):
    """The validation step over this data row's block of a batch (with its
    ``weight``, ``mesh.global_batch_from_global`` over ``mesh.data``):
    the eval-mode channel-partitioned forward, the combined loss as the
    global weighted mean; a program where the train step is one.  The
    channel rule's dims come from ``cfg``'s model."""
    cfg = cfg or SVSConfig()
    dims = zero.state_shardings(mesh.model, cfg, fsdp=True)["model"]

    def body(model: UNet, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        mask = forward(model, dims, batch["mix"], mesh, cfg, train=False)
        _, aux = combined_loss(mask, batch["mix"], batch["voc"],
                               batch["mix_angle"], batch["voc_angle"], cfg,
                               weight=batch["weight"], group=mesh.data)
        return aux

    def check(state: TrainState) -> None:
        _check(state, mesh)
        if state.dims != dims:
            raise ValueError("the TP eval step's config cuts the model "
                             "otherwise than the state's")

    return graphs.eval_step(cfg, body, "tp", mesh, check)


def make_tp_apply(mesh: Mesh2D, cfg: Optional[SVSConfig] = None):
    """The eval-mode channel-partitioned forward ``fn(state, mix) ->
    mask``: ``mix`` the global (B, F, T) batch (numpy or a tensor, the
    same on every rank), cut over the data sub-mesh; the global (B, F, T)
    float32 mask on every rank."""
    cfg = cfg or SVSConfig()

    @torch.no_grad()
    def fn(state: zero.ZeroState, mix) -> torch.Tensor:
        _check(state, mesh)
        local = mesh_lib.shard_batch(mesh.data, {"mix": mix})["mix"]
        mask = forward(state.model, state.dims, local, mesh, cfg,
                       train=False)
        return mesh_lib.all_gather(mask, 0, mesh.data)[:len(mix)]

    return fn
