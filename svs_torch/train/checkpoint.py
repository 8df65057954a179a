"""Checkpoint save / load / resume (port of ``svs_tpu/train/checkpoint.py``).

The native ``.ckpt`` is svs_tpu's: one msgpack map (flax's
``msgpack_serialize`` of ``to_state_dict`` trees, svs_tpu checkpoint.py:
107-122) of

- ``params`` / ``bn_state``: svs_tpu's pytrees, lists as ``{"0": ...}``
  maps, kernels HWIO (deconvs pre-flipped), as numpy arrays;
- ``opt_state``: optax's ``inject_hyperparams(adam)`` state, ``count``,
  ``hyperparams`` (``b1``, ``b2``, ``eps``, ``eps_root``,
  ``learning_rate``), ``hyperparams_states`` and ``inner_state`` (``"0"``:
  Adam's ``count``, ``mu``, ``nu`` in the params' tree; ``"1"``: ``{}``),
  wrapped with ``accum_steps > 1`` in ``optax.MultiSteps``' ``mini_step``,
  ``gradient_step``, ``inner_opt_state``, ``acc_grads`` and
  ``skip_state``;
- ``step``, ``epoch`` and ``extras`` (loss histories, best validation
  loss).

A ``.ckpt`` written here loads in svs_tpu and one written there loads
here, with the same weights, BN statistics, Adam moments (HWIO against
OIHW like the weights, :mod:`svs_torch.models.torch_import`), learning
rate, step, epoch and extras.  torch's Adam counts its updates in each
parameter's ``step``, as optax counts them in ``count``.  The msgpack
codec is the port's own (:mod:`svs_torch.train.flax_msgpack`): neither flax
nor ``msgpack`` is needed.  The reference's ``.pth`` loads through
:func:`resume` (weights and BN statistics; the optimizer starts fresh) and
:func:`export_pth` writes one.

A write is atomic: a ``.tmp`` file, then ``os.replace``.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from svs_torch.models import torch_import
from svs_torch.train import flax_msgpack
from svs_torch.train.step import TrainState, set_learning_rate


@dataclasses.dataclass
class Snapshot:
    """What a checkpoint holds of a :class:`TrainState`, by state-dict
    name: the tensors are clones on the state's device (:class:`AsyncSaver`),
    the live ones (a synchronous save) or host copies of a sharded state's
    gathered leaves (``parallel.zero.unshard_state``)."""
    state_dict: Dict[str, torch.Tensor]
    adam_count: int
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    lr: float
    betas: Tuple[float, float]
    eps: float
    step: int
    accum_steps: int
    mini_step: int
    acc_grads: Optional[Dict[str, torch.Tensor]]


def snapshot(state: TrainState, clone: bool = False) -> Snapshot:
    """The state's checkpoint content; ``clone`` copies every tensor on its
    device first (the next step updates the state in place)."""
    keep = (lambda t: t.detach().clone()) if clone else (
        lambda t: t.detach())
    named = dict(state.model.named_parameters())
    opt = state.optimizer
    group = opt.param_groups[0]
    exp_avg, exp_avg_sq, count = {}, {}, 0
    for name, p in named.items():
        st = opt.state.get(p, {})
        if st:
            count = int(st["step"])
            exp_avg[name] = keep(st["exp_avg"])
            exp_avg_sq[name] = keep(st["exp_avg_sq"])
    acc = None
    if state.acc_grads is not None:
        acc = {name: keep(g) for name, g in zip(named, state.acc_grads)}
    return Snapshot(
        state_dict={k: keep(v) for k, v in state.model.state_dict().items()},
        adam_count=count, exp_avg=exp_avg, exp_avg_sq=exp_avg_sq,
        lr=float(group["lr"]), betas=tuple(group["betas"]),
        eps=float(group["eps"]), step=int(state.step),
        accum_steps=state.accum_steps, mini_step=int(state.mini_step),
        acc_grads=acc)


# ---------------------------------------------------------------- trees


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _put(tree: dict, name: str, value: np.ndarray) -> None:
    """Place a state-dict entry's numpy value at its svs_tpu tree path
    (``tree`` is ``{"params": ..., "bn_state": ...}``)."""
    path = torch_import.jax_path(name)
    if path is None:
        return
    top, side, level, field = path
    tree[top].setdefault(side, {}).setdefault(str(level), {})[field] = \
        np.ascontiguousarray(torch_import.to_jax_layout(name, value))


def _get(tree: dict, name: str) -> Optional[np.ndarray]:
    path = torch_import.jax_path(name)
    if path is None:
        return None
    top, side, level, field = path
    return torch_import.from_jax_layout(
        name, np.asarray(tree[top][side][str(level)][field]))


def _params_tree(values: Dict[str, torch.Tensor], names: List[str]) -> dict:
    """A params-shaped tree (``mu``, ``nu``, ``acc_grads``) of
    per-parameter values."""
    tree: dict = {"params": {}, "bn_state": {}}
    for name in names:
        _put(tree, name, _np(values[name]))
    return tree["params"]


def _scalar(v, dtype) -> np.ndarray:
    return np.asarray(v, dtype=dtype)


def _payload(snap: Snapshot, epoch: int, extras: Optional[Dict[str, Any]]
             ) -> dict:
    sd = {k: _np(v) for k, v in snap.state_dict.items()}
    tree: dict = {"params": {}, "bn_state": {}}
    for name, value in sd.items():
        _put(tree, name, value)
    names = [n for n in sd if (torch_import.jax_path(n) or ("",))[0]
             == "params"]
    # parameters Adam has not updated yet hold zero moments (optax's init)
    zeros = {n: torch.zeros_like(snap.state_dict[n]) for n in names}
    mu = _params_tree({**zeros, **snap.exp_avg}, names)
    nu = _params_tree({**zeros, **snap.exp_avg_sq}, names)
    count = _scalar(snap.adam_count, np.int32)
    inject = {
        "count": count,
        "hyperparams": {"b1": _scalar(snap.betas[0], np.float32),
                        "b2": _scalar(snap.betas[1], np.float32),
                        "eps": _scalar(snap.eps, np.float32),
                        "eps_root": _scalar(0.0, np.float32),
                        "learning_rate": _scalar(snap.lr, np.float32)},
        "hyperparams_states": {},
        "inner_state": {"0": {"count": count, "mu": mu, "nu": nu}, "1": {}},
    }
    opt_state = inject
    if snap.accum_steps > 1:
        acc = snap.acc_grads or {}
        opt_state = {
            "mini_step": _scalar(snap.mini_step, np.int32),
            "gradient_step": count,
            "inner_opt_state": inject,
            "acc_grads": _params_tree({**zeros, **acc}, names),
            "skip_state": {},
        }
    return {"params": tree["params"], "bn_state": tree["bn_state"],
            "opt_state": opt_state, "step": int(snap.step),
            "epoch": int(epoch), "extras": extras or {}}


def _atomic_write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)  # a crash never corrupts the latest ckpt


# ---------------------------------------------------------------- API


def save(path: str, state: Union[TrainState, Snapshot], *, epoch: int = 0,
         extras: Optional[Dict[str, Any]] = None) -> None:
    """Write the native ``.ckpt`` of ``state`` (or of a :class:`Snapshot`
    of it)."""
    snap = state if isinstance(state, Snapshot) else snapshot(state)
    _atomic_write(path, flax_msgpack.packb(_payload(snap, epoch, extras)))


def _restore_opt(state: TrainState, opt: dict, path: str) -> None:
    accum = "inner_opt_state" in opt
    if accum != (state.accum_steps > 1):
        raise ValueError(
            f"{path}: checkpoint optimizer state does not match this run's "
            f"optimizer layout — a run trained with a different "
            f"gradient-accumulation setting (--accum) must resume with the "
            f"same one (checkpoint: {'MultiSteps' if accum else 'Adam'}, "
            f"this run: accum_steps={state.accum_steps})")
    inject = opt["inner_opt_state"] if accum else opt
    adam = inject["inner_state"]["0"]
    hyper = inject["hyperparams"]
    count = int(adam["count"])
    tree_mu = {"params": adam["mu"]}
    tree_nu = {"params": adam["nu"]}
    optimizer = state.optimizer
    group = optimizer.param_groups[0]
    group["betas"] = (float(hyper["b1"]), float(hyper["b2"]))
    group["eps"] = float(hyper["eps"])
    # optax keeps the rate in float32; its shortest decimal is the rate the
    # run was configured with (1e-3, not 0.0010000000474974513), so that a
    # resumed run updates exactly as an uninterrupted one
    set_learning_rate(state, float(str(np.float32(hyper["learning_rate"]))))
    optimizer.state.clear()
    named = dict(state.model.named_parameters())
    # a capturable Adam (one a CUDA graph replays, train/scan.py) keeps its
    # step count on the parameter's device; a plain one keeps it on the host
    on_device = bool(group.get("capturable"))
    if count > 0:
        for name, p in named.items():
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32,
                                     device=p.device if on_device else None),
                "exp_avg": torch.from_numpy(_get(tree_mu, name).copy()).to(
                    p.device, p.dtype),
                "exp_avg_sq": torch.from_numpy(_get(tree_nu, name).copy()).to(
                    p.device, p.dtype)}
    state.mini_step, state.acc_grads = 0, None
    if accum and int(opt["mini_step"]) > 0:
        tree_acc = {"params": opt["acc_grads"]}
        state.mini_step = int(opt["mini_step"])
        state.acc_grads = [
            torch.from_numpy(_get(tree_acc, name).copy()).to(p.device,
                                                             p.dtype)
            for name, p in named.items()]


def load(path: str, template: TrainState, restore_opt: bool = True
         ) -> Tuple[TrainState, int, Dict[str, Any]]:
    """Restore a native checkpoint INTO ``template`` (in place: weights,
    BN statistics, step, and with ``restore_opt`` Adam and the
    accumulation state); returns ``(template, epoch, extras)``.

    ``restore_opt=False`` keeps the template's fresh optimizer, for
    consumers that need only the weights (inference), whatever optimizer
    layout (``--accum``) the run was trained with."""
    with open(path, "rb") as f:
        raw = flax_msgpack.unpackb(f.read())
    tree = {"params": raw["params"], "bn_state": raw["bn_state"]}
    sd = template.model.state_dict()
    new = {}
    for name, t in sd.items():
        v = _get(tree, name)
        new[name] = t if v is None else torch.from_numpy(
            np.array(v, dtype=np.float32))
    template.model.load_state_dict(new)
    if restore_opt:
        _restore_opt(template, raw["opt_state"], path)
    template.step = int(raw["step"])
    return template, int(raw["epoch"]), raw.get("extras", {})


def resume(path: str, template: TrainState, restore_opt: bool = True
           ) -> Tuple[TrainState, int, Dict[str, Any]]:
    """Load a native ``.ckpt`` or a reference ``.pth`` (reference
    train.py:216-237 resume semantics: a ``.pth`` brings the weights, BN
    statistics, epoch and loss histories; the optimizer starts fresh)."""
    if path.endswith(".pth"):
        sd, extras = torch_import.load_pth(path)
        template.model.load_state_dict(sd)
        return template, int(extras.get("epoch", 0)), extras
    return load(path, template, restore_opt=restore_opt)


def export_pth(path: str, state: Union[TrainState, Snapshot], *,
               epoch: int = 0) -> None:
    """Write a reference-loadable checkpoint (train.py rich-dict format,
    reference train.py:369-382, minus optimizer internals)."""
    sd = (state.state_dict if isinstance(state, Snapshot)
          else state.model.state_dict())
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch_import.save_pth(path, sd, epoch=epoch)


def _frozen(state: Union[TrainState, Snapshot]) -> Snapshot:
    """A snapshot that the next step cannot change: a state's is cloned; a
    :class:`Snapshot` (a gathered one, ``parallel.zero.unshard_state``)
    is already a copy."""
    return state if isinstance(state, Snapshot) else snapshot(state,
                                                              clone=True)


class AsyncSaver:
    """Checkpoint writes off the training thread.

    ``save()`` clones the state on its device (the next step updates the
    parameters in place, so the snapshot is taken before it is enqueued)
    and hands the fetch to the host and the write to a single worker
    thread, so training continues at once; the worker keeps the writes in
    order.  ``wait()`` drains the pending writes and re-raises any worker
    error (call it before reading the file or exiting)."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: List[concurrent.futures.Future] = []

    def save(self, path: str, state: Union[TrainState, Snapshot], *,
             epoch: int = 0, extras: Optional[Dict[str, Any]] = None
             ) -> None:
        snap = _frozen(state)
        # callers pass live lists (loss_history) that keep growing
        extras = copy.deepcopy(extras) if extras else None
        self._pending.append(self._pool.submit(save, path, snap, epoch=epoch,
                                               extras=extras))

    def export_pth(self, path: str, state: Union[TrainState, Snapshot], *,
                   epoch: int = 0) -> None:
        snap = _frozen(state)
        self._pending.append(self._pool.submit(export_pth, path, snap,
                                               epoch=epoch))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()  # re-raises any worker error, not just the last

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown()
