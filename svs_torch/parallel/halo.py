"""Context (time) parallelism by halo exchange (port of
``svs_tpu/parallel/halo.py``).

The U-Net is fully convolutional in time, so a song or a long patch can
run as ONE patch with its time axis cut over the ranks: each rank holds the
whole replicated state and the whole batch, and runs the conv tower on its
contiguous block of time columns.  Before each conv it takes a few edge
columns from its neighbours (``mesh.halo_exchange``: zeros at the ends of
the song, as the unsharded conv's padding), and the result equals the
unsharded forward's.  Songs and patches too long for one card's memory so
spread over several.

The halo arithmetic on the port's NCHW layout (time is dim 3 of an
activation, dim 2 of a (B, F, T) plane; kernel 5, stride 2, pad 2, and for
the transposed conv output_padding 1):

- down conv: a halo of 2, then ``F.conv2d(xh, w, stride=2,
  padding=(2, 0))``: T_loc / 2 outputs, the first centred on the block's
  first owned column;
- up conv: a halo of 1, then ``F.conv_transpose2d(xh, w, stride=2,
  padding=(2, 0), output_padding=(1, 0))``, which gives 2 T_loc + 7 time
  columns, of which ``[4, 4 + 2 T_loc)`` are this block's.

Each conv rounds through ``cfg.compute_dtype`` and adds its bias there, as
``UNet.down`` and ``UNet.deconv`` do.  Six stride-2 levels must leave
every block a whole column, so T is a multiple of ``64 * size``.  A world
of one runs the same arithmetic with zero halos: a zero pad, then the
valid convs.

Training (svs_tpu halo.py:119-300): BatchNorm takes the global batch's
statistics over the time blocks (``unet.batch_norm`` with ``group=mesh``
and the replicated ``weight``); Dropout2d's (B, C, 1, 1) masks are the
whole batch's, drawn on every rank from a generator seeded alike in
``UNet.forward``'s order, so every rank applies the single step's masks.
The loss gathers the mask over the time blocks (``mesh.all_gather``) and
the four planes without a gradient, and runs ``combined_loss`` on the
whole batch on every rank (the CUDA loss kernels under ``pallas_fused``
and ``pallas_bf16``).  The gradient rule is ``dp.dp_loss``'s: every rank
backpropagates ``L / size``, so the gather's adjoint gives each rank the
true gradient of its mask block; BatchNorm's sums and the halo's
transpose carry the rest across the ranks, and one flat all-reduce sums
the parameter gradients (``dp._sum_over_ranks``).  Adam then runs on the
same gradient on every rank, which so holds the same state.  The conv
tower is time-sharded; the loss is computed whole on every rank.  On a
CUDA device over NCCL (or a world of one) the step runs as a cached
captured program, one a key (``train/graphs.py``), its halo exchanges (24
all-reduces a forward) captured with it; gloo ranks on a CUDA device run
the eager body.  The whole-song decode (:func:`make_time_sharded_apply`)
runs as a cached decode program by the same rule.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from svs_torch.data.dataset import PLANE_KEYS
from svs_torch.infer import separate
from svs_torch.losses.mrstft import combined_loss
from svs_torch.models.unet import UNet
from svs_torch.parallel import dp
from svs_torch.parallel import mesh as mesh_lib
from svs_torch.parallel.mesh import Mesh
from svs_torch.train import graphs
from svs_torch.train.step import TrainState, _apply, global_norm
from svs_torch.utils.config import SVSConfig
from svs_torch.utils.device import torch_dtype

# time frames a block must hold per shard: six stride-2 levels
GRANULE = 64


def granule(mesh: Mesh) -> int:
    """The multiple of time frames a CP batch or song must be over
    ``mesh``: 64 frames a rank."""
    return GRANULE * mesh.size


def _down(model: UNet, mesh: Mesh, i: int, x: torch.Tensor
          ) -> torch.Tensor:
    """Encoder conv i (5x5, stride 2) of this rank's block, with its bias,
    in the compute dtype (``UNet.down`` of the block)."""
    cd = torch_dtype(model.cfg.compute_dtype)
    conv = getattr(model, f"conv{i}")[0]
    xh = mesh_lib.halo_exchange(x, 2, mesh)
    return (F.conv2d(xh.to(cd), conv.weight.to(cd), None, conv.stride,
                     (conv.padding[0], 0))
            + conv.bias.to(cd)[None, :, None, None])


def _up(model: UNet, mesh: Mesh, i: int, x: torch.Tensor) -> torch.Tensor:
    """Decoder (transposed) conv i of this rank's block, with its bias, in
    the compute dtype (``UNet.deconv`` of the block)."""
    cd = torch_dtype(model.cfg.compute_dtype)
    deconv = getattr(model, f"deconv{i}")
    t = x.shape[3]
    xh = mesh_lib.halo_exchange(x, 1, mesh)
    y = F.conv_transpose2d(xh.to(cd), deconv.weight.to(cd), None,
                           deconv.stride, (deconv.padding[0], 0),
                           (deconv.output_padding[0], 0))
    return (y[..., 4:4 + 2 * t]
            + deconv.bias.to(cd)[None, :, None, None])


def forward(model: UNet, mix: torch.Tensor, mesh: Mesh, *,
            weight: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The U-Net on this rank's time block ``mix`` (B, F, T_loc) of a
    batch every rank holds: the (B, F, T_loc) float32 mask block.
    ``UNet.forward``'s levels with the halo convs: eval or train mode as
    ``model`` is; train mode takes BatchNorm's statistics over the whole
    weighted batch (``weight``, the same on every rank; with it ``n =
    all_sum(sum w) * F * T_loc`` is ``sum(w) * F * T``, every block having
    the same T_loc), writes the running statistics and draws the whole
    batch's Dropout2d masks from ``generator`` (``dec_keep`` without a
    mesh: not DP's cut of rows); ``cfg.remat`` recomputes each level, its
    halo exchange included, in the backward."""
    down = functools.partial(_down, model, mesh)
    up = functools.partial(_up, model, mesh)
    x = mix.to(torch.float32)[:, None]
    skips = []
    for i in range(1, 7):
        x = model.encode(i, x, weight, mesh, conv=down)
        skips.append(x)
    for i in range(1, 6):
        inp = skips[5] if i == 1 else torch.cat([x, skips[6 - i]], dim=1)
        x = model.decode(i, inp, weight, model.dec_keep(i, inp, generator),
                         mesh, conv=up)
    y = up(6, torch.cat([x, skips[0]], dim=1))
    return torch.sigmoid(y.to(torch.float32))[:, 0]


def check_time(t: int, mesh: Mesh, what: str = "time axis") -> None:
    """Refuse a time axis of ``t`` frames that is not a multiple of
    :func:`granule` (svs_tpu's words)."""
    if t % granule(mesh):
        raise ValueError(
            f"{what} {t} must be a multiple of {granule(mesh)} "
            f"(64 frames per stride-2 level x {mesh.size} shards)")


def shard_batch_time(mesh: Mesh, batch) -> Dict[str, torch.Tensor]:
    """This rank's time block of each (B, F, T) plane of a batch every rank
    holds (numpy arrays or tensors), as float32 on the mesh's device, and
    the replicated (B,) ``weight`` (ones where the batch has none).  T must
    be a multiple of ``64 * size`` (svs_tpu halo.py:218)."""
    out = {}
    b = None
    for k, v in batch.items():
        if k == "weight":
            continue
        v = mesh_lib._as_tensor(v)
        b = v.shape[0]
        check_time(v.shape[2], mesh)
        out[k] = mesh_lib.local_block(v, 2, mesh).to(
            device=mesh.device, dtype=torch.float32).contiguous()
    weight = batch.get("weight")
    weight = (torch.ones(b) if weight is None
              else mesh_lib._as_tensor(weight))
    out["weight"] = weight.to(device=mesh.device, dtype=torch.float32)
    return out


def make_cp_loss(mesh: Mesh, cfg: Optional[SVSConfig] = None):
    """``fn(model, batch, generator) -> (total, aux)``: the train-mode
    forward of this rank's time blocks ``batch`` (``shard_batch_time``'s)
    and the combined loss of the whole batch, the same on every rank
    (svs_tpu halo.py:246).  Backpropagate ``total / size`` on every rank
    (the module's gradient rule)."""
    cfg = cfg or SVSConfig()

    def loss(model: UNet, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        model.train()
        weight = batch["weight"]
        mask = mesh_lib.all_gather(
            forward(model, batch["mix"], mesh, weight=weight,
                    generator=generator), 2, mesh)
        with torch.no_grad():
            full = {k: mesh_lib.all_gather(batch[k], 2, mesh)
                    for k in PLANE_KEYS}
        return combined_loss(mask, full["mix"], full["voc"],
                             full["mix_angle"], full["voc_angle"], cfg,
                             weight=weight)

    return loss


def cp_loss_and_grads(cfg: SVSConfig, state: TrainState,
                      batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator], mesh: Mesh):
    """``step.loss_and_grads`` over the time blocks: the gradients of the
    whole batch's loss, summed over the ranks, and its metrics, the same
    on every rank."""
    params = list(state.model.parameters())
    total, aux = make_cp_loss(mesh, cfg)(state.model, batch, generator)
    seed = total / mesh.size if mesh.size > 1 else total
    grads = dp._sum_over_ranks(list(torch.autograd.grad(seed, params)),
                               mesh)
    metrics = {k: v.detach() for k, v in aux.items()}
    metrics["grad_norm"] = global_norm(grads)
    return grads, metrics


def make_cp_train_step(mesh: Mesh, cfg: Optional[SVSConfig] = None):
    """``step(state, local_batch, generator) -> (state, metrics)``: one
    optimisation step of the batch whose time blocks ``local_batch`` holds
    here (``shard_batch_time``), from the state every rank holds
    (``dp.replicate_state``).  ``make_train_step``'s semantics; the
    metrics the whole batch's, the state updated in place, the same on
    every rank; a program where the DP step is one (``step.eager`` the
    eager body).  svs_tpu has no CP eval step: validation runs the plain
    eval step on the whole batch (``fit``)."""
    cfg = cfg or SVSConfig()

    def body(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        grads, metrics = cp_loss_and_grads(cfg, state, batch, generator,
                                           mesh)
        _apply(state, grads)
        return metrics

    return graphs.train_step(cfg, body, "cp", mesh)


def make_time_sharded_apply(mesh: Mesh):
    """The eval-mode forward of a time-sharded batch: ``fn(model, mix)``
    with ``mix`` the whole (B, F, T) batch (numpy or a tensor, the same on
    every rank, T a multiple of ``64 * size``); each rank masks its time
    block, and every rank gets the whole (B, F, T) float32 mask, equal to
    the unsharded forward's (svs_tpu halo.py:335).  Where
    ``separate._routed`` (a CUDA device over NCCL, or a world of one)
    the local block, the forward with its halo exchanges and the gather
    are one cached decode program (``infer/graphs.py``, keyed on the model,
    the mesh and the padded shape), as svs_tpu jits them (halo.py:354);
    gloo ranks on a card and the CPU run the body eagerly.  ``fn.eager``
    is the eager body."""

    def body(model: UNet, mix: torch.Tensor):
        block = mesh_lib.local_block(mix, 2, mesh).to(
            device=mesh.device, dtype=torch.float32)
        return (mesh_lib.all_gather(forward(model, block, mesh), 2, mesh),)

    @torch.inference_mode()
    def fn(model: UNet, mix) -> torch.Tensor:
        if model.training:
            raise ValueError("the time-sharded forward needs the model in "
                             "eval mode (call model.eval())")
        mix = mesh_lib._as_tensor(mix)
        check_time(mix.shape[2], mesh)
        return separate._run(model, mesh.device, mix, ("cp", id(mesh)),
                             body, mesh)[0]

    @torch.inference_mode()
    def eager(model: UNet, mix) -> torch.Tensor:
        mix = mesh_lib._as_tensor(mix)
        check_time(mix.shape[2], mesh)
        return body(model, mix)[0]

    fn.eager = eager
    return fn


def separate_magnitude_time_sharded(model: UNet, mag: np.ndarray,
                                    mesh: Mesh, *, vocal_solo: bool = True
                                    ) -> Optional[np.ndarray]:
    """(513, T) normalised magnitude -> masked magnitude by the whole-song
    forward with the time axis cut over the mesh (svs_tpu halo.py:357):
    full temporal context, no segment seams.  T is zero-padded to a
    multiple of ``64 * size`` (at least one granule), rows 1..512 are
    masked, the DC row is zeroed.  Every rank calls it with the same
    ``mag`` and weights; rank 0 returns the (513, T) result, the others
    None (as the segment-parallel decode, ``separate_magnitude_mesh``).

    The unsharded ``separate_magnitude(mode="whole")`` pads to a multiple
    of ``8 * input_len`` frames instead; where the two paddings differ the
    model sees a different zero tail, and the last frames differ."""
    g = granule(mesh)
    t = mag.shape[1]
    t_pad = -(-max(t, g) // g) * g
    mag_p = np.pad(mag.astype(np.float32), ((0, 0), (0, t_pad - t)))
    mask = make_time_sharded_apply(mesh)(model, mag_p[None, 1:])[0]
    if not mesh.is_primary:
        return None
    mask = mask.cpu().numpy()
    if not vocal_solo:
        mask = 1.0 - mask
    pred = mag_p[1:] * mask
    return np.concatenate([np.zeros((1, t_pad), np.float32), pred])[:, :t]
