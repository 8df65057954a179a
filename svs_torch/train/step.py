"""The train and eval steps (port of ``svs_tpu/train/step.py``).

One optimisation step is U-Net forward with BatchNorm and dropout, the mask
arithmetic, the patch iSTFT, the 3-resolution MR-STFT loss, backward and an
Adam update (reference train.py:274-300; Adam with torch's defaults,
reference model.py:116, held as svs_tpu's float32 values).  The names are
svs_tpu's; inside, the idiom is PyTorch's:

- :class:`TrainState` holds the :class:`~svs_torch.models.unet.UNet`, its
  ``torch.optim.Adam`` and a step count.  A step UPDATES THE STATE IN
  PLACE: parameters, Adam's moments and BN running statistics are
  overwritten (JAX's functional step returned a new state); the state is
  returned as well so that call sites read as svs_tpu's.
- Dropout draws from an explicit ``torch.Generator`` passed to each step.
- ``accum_steps > 1`` (``optax.MultiSteps``): each call accumulates the
  running MEAN of the microbatch gradients and Adam steps only on every
  k-th call, with that mean; BN running statistics move on every call.
- svs_tpu jits the step; here :func:`make_step_fn` is the eager step, and
  :func:`make_train_step` / :func:`make_eval_step` run it on a CUDA device
  as cached captured programs (:mod:`svs_torch.train.graphs`), eagerly on
  the CPU.  Metrics are returned as device tensors so that the step never
  waits on the card.
- Adam on a CUDA device is torch's capturable form (its step counts on
  the card and the bias corrections there in float32, as optax keeps
  them), the only form a CUDA graph replays; on the CPU the host form.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from svs_torch.losses.mrstft import combined_loss
from svs_torch.models.unet import UNet
from svs_torch.utils import profiling
from svs_torch.utils.config import SVSConfig
from svs_torch.utils.device import DeviceLike, resolve_device


# optax's Adam defaults (0.9, 0.999, 1e-8) as the float32 values that
# svs_tpu's ``inject_hyperparams`` holds and a ``.ckpt`` stores: a fresh
# Adam and one resumed from a checkpoint (``checkpoint._restore_opt``)
# then update with the same bits
BETAS = (float(np.float32(0.9)), float(np.float32(0.999)))
EPS = float(np.float32(1e-8))


@dataclasses.dataclass(frozen=True)
class AdamSpec:
    """What :func:`make_optimizer` returns: torch binds an optimizer to its
    parameters, so the spec is built into one by :func:`create_train_state`."""
    learning_rate: float
    accum_steps: int = 1

    def build(self, params) -> torch.optim.Adam:
        """torch's Adam: on a CUDA device its capturable form, which keeps
        the step counts on the card and takes the bias corrections there in
        float32, so that a CUDA graph of the step can replay it
        (``train/graphs.py``, ``train/scan.py``); on the CPU the host
        form."""
        params = list(params)
        return torch.optim.Adam(params, lr=self.learning_rate, betas=BETAS,
                                eps=EPS,
                                capturable=bool(params) and params[0].is_cuda)


@dataclasses.dataclass
class TrainState:
    model: UNet
    optimizer: torch.optim.Adam
    step: int = 0
    accum_steps: int = 1
    # MultiSteps: microbatches in the current cycle and their mean gradient
    # (``acc_buffers`` while a cycle is open, else None)
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None
    # the running mean's storage, allocated once: a CUDA graph of the step
    # holds its addresses
    acc_buffers: Optional[List[torch.Tensor]] = None


def make_optimizer(cfg: Optional[SVSConfig] = None,
                   accum_steps: int = 1) -> AdamSpec:
    """Adam (:data:`BETAS`, :data:`EPS`) at ``cfg.learning_rate``;
    ``accum_steps > 1`` updates once every ``accum_steps`` microbatches
    with their MEAN gradient (``optax.MultiSteps``).  A run resumes with
    the same ``accum_steps``.  On a CUDA device Adam takes the form a CUDA
    graph replays (:class:`AdamSpec`)."""
    cfg = cfg or SVSConfig()
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    return AdamSpec(cfg.learning_rate, accum_steps)


def create_train_state(rng: Union[int, torch.Generator] = 0,
                       cfg: Optional[SVSConfig] = None,
                       optimizer: Optional[AdamSpec] = None, *,
                       device: DeviceLike = None) -> TrainState:
    """A seeded U-Net (``rng``: a seed or a CPU ``torch.Generator``) on
    ``device`` (``cuda`` unless the caller asks for the CPU) and its Adam."""
    cfg = cfg or SVSConfig()
    optimizer = optimizer or make_optimizer(cfg)
    gen = (torch.Generator().manual_seed(rng) if isinstance(rng, int)
           else rng)
    model = UNet(cfg, generator=gen).to(resolve_device(device))
    return TrainState(model, optimizer.build(model.parameters()),
                      accum_steps=optimizer.accum_steps)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Reference train.py:251-254: set the LR mid-training (in place)."""
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def reset_accumulation(state: TrainState) -> TrainState:
    """Drop a partly filled accumulation cycle (a no-op when
    ``accum_steps == 1``): a resumed epoch then starts its cycle cleanly."""
    state.mini_step = 0
    state.acc_grads = None
    return state


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all the tensors together."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def _accumulator(state: TrainState, like) -> List[torch.Tensor]:
    """Open the accumulation cycle on ``state.acc_buffers`` (allocated at
    first use, shaped as ``like``); a cycle loaded from a checkpoint is
    copied in."""
    if state.acc_buffers is None:
        state.acc_buffers = [torch.zeros_like(g) for g in like]
    if state.acc_grads is not None and state.acc_grads is not \
            state.acc_buffers:
        with torch.no_grad():
            for buf, g in zip(state.acc_buffers, state.acc_grads):
                buf.copy_(g)
    state.acc_grads = state.acc_buffers
    return state.acc_grads


def _apply(state: TrainState, grads: List[torch.Tensor],
           params: Optional[List[torch.Tensor]] = None) -> bool:
    """One optimiser call with ``grads``: Adam, or a MultiSteps
    accumulation that reaches Adam on the k-th microbatch; whether Adam
    stepped.  ``params``: the tensors Adam is bound to, in ``grads``'
    order (the model's parameters unless given: the ZeRO-1 step's
    slices)."""
    if params is None:
        params = list(state.model.parameters())
    if state.accum_steps > 1:
        n = state.mini_step
        with torch.no_grad():
            for acc, g in zip(_accumulator(state, grads), grads):
                if n == 0:
                    acc.zero_()
                acc.add_((g - acc) / (n + 1))  # optax's running mean
        state.mini_step = (n + 1) % state.accum_steps
        if state.mini_step:
            return False
        grads = state.acc_grads
        state.acc_grads = None
    for p, g in zip(params, grads):
        p.grad = g
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    return True


def make_step_fn(cfg: Optional[SVSConfig] = None):
    """``step(state, batch, generator) -> (state, metrics)``: one
    optimisation step.  ``batch``: dict of (B, 512, T) float32 tensors on
    the model's device (mix, voc, mix_angle, voc_angle, optional (B,)
    ``weight``); ``generator``: dropout's random source.  Metrics (device
    scalars): ``l1``, ``mr``, ``total`` and ``grad_norm``, the global L2
    norm of the microbatch gradient handed to the optimiser.  Unlike
    svs_tpu's, it takes no optimizer: the state carries its Adam and
    ``accum_steps``."""
    body = _step_body(cfg or SVSConfig())

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        metrics = body(state, batch, generator)
        state.step += 1
        return state, metrics

    return step


def _step_body(cfg: SVSConfig):
    """The step without its count: the loss, the gradients and the
    optimiser call (which moves an accumulation cycle on); the metrics.
    What a train program captures."""

    def body(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        grads, metrics = loss_and_grads(cfg, state, batch, generator)
        _apply(state, grads)
        profiling.mark("train.optimizer", batch["mix"].device)
        return metrics

    return body


def loss_and_grads(cfg: SVSConfig, state: TrainState,
                   batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """The step before its optimiser call: the train-mode forward (BN
    running statistics updated in place), the combined loss and the
    parameters' gradients, with the step's metrics.  It marks its phases
    (``profiling.mark``): the U-Net's forward, the loss's forward, the
    loss's backward (a hook on the mask's gradient, which is whole once
    the loss's backward is done) and the U-Net's backward."""
    dev = batch["mix"].device
    profiling.mark(profiling.BEGIN, dev)
    model = state.model.train()
    weight = batch.get("weight")
    params = list(model.parameters())
    mask = model(batch["mix"], weight=weight, generator=generator)
    profiling.mark("train.unet_fwd", dev)
    mask.register_hook(_mark_loss_bwd)
    total, aux = combined_loss(mask, batch["mix"], batch["voc"],
                               batch["mix_angle"], batch["voc_angle"],
                               cfg, weight=weight)
    profiling.mark("train.loss_fwd", dev)
    grads = torch.autograd.grad(total, params)
    profiling.mark("train.unet_bwd", dev)
    metrics = {k: v.detach() for k, v in aux.items()}
    metrics["grad_norm"] = global_norm(grads)
    return list(grads), metrics


def _mark_loss_bwd(grad: torch.Tensor) -> None:
    profiling.mark("train.loss_bwd", grad.device)


def make_train_step(cfg: Optional[SVSConfig] = None):
    """svs_tpu's jitted step: ``step(state, batch, generator) -> (state,
    metrics)`` as :func:`make_step_fn`'s, run on a CUDA device as the cached
    captured program of its key (:mod:`svs_torch.train.graphs`: the first
    call of a key runs the eager step, later ones replay; the metrics are
    fresh tensors), eagerly on the CPU."""
    from svs_torch.train import graphs  # it imports this module
    cfg = cfg or SVSConfig()
    return graphs.train_step(cfg, _step_body(cfg))


def make_eval_fn(cfg: Optional[SVSConfig] = None):
    """The eager validation step (reference train.py:316-347): eval-mode
    BN, no dropout, the same combined loss; returns the metrics dict and
    leaves the model's mode as it found it."""
    body = _eval_body(cfg or SVSConfig())

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        return body(state.model, batch)

    return step


def _eval_body(cfg: SVSConfig):
    """The eval step on the model alone: what an eval program captures
    (it holds no reference to the model)."""

    def body(model: UNet, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            mask = model(batch["mix"])
            _, aux = combined_loss(mask, batch["mix"], batch["voc"],
                                   batch["mix_angle"], batch["voc_angle"],
                                   cfg, weight=batch.get("weight"))
        finally:
            model.train(was_training)
        return aux

    return body


def make_eval_step(cfg: Optional[SVSConfig] = None):
    """svs_tpu's jitted eval step: :func:`make_eval_fn`'s, run on a CUDA
    device as the cached captured program of its key, eagerly on the
    CPU."""
    from svs_torch.train import graphs  # it imports this module
    cfg = cfg or SVSConfig()
    return graphs.eval_step(cfg, _eval_body(cfg))


def batch_to_device(batch: Dict, device: DeviceLike = None
                    ) -> Dict[str, torch.Tensor]:
    """A sampler batch (numpy arrays) as float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
            for k, v in batch.items()}

