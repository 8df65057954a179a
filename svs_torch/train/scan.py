"""A whole training epoch as replays of one captured CUDA graph (port of
``svs_tpu/train/scan.py``).

With the dataset on the card (``data/device_data.py``) no step needs the
host.  svs_tpu compiles the epoch into one XLA program that scans the step
over the epoch's crop indices; the counterpart here is one
``torch.cuda.CUDAGraph`` of the step, captured once and replayed for every
full batch.  A replay is the gather (``device_data.gather_crops``), the
optional remix (``augment.apply_remix``), the step (the forward, the
combined loss, the backward and Adam: ``train/step.py``) and a write of the
step's ``total`` into row *i* of a static ``(n_steps,)`` loss vector; the
step reads its row of the epoch's index matrix from a step counter on the
card, so a replay takes no argument from the host.  Per epoch there is one
host-to-device copy (the stacked indices, and augment's stacked draws) and
one fetch of the loss vector, svs_tpu's contract (scan.py:49-63).

What the capture needs, and how it is met:

- Adam runs in its capturable form (its step counts on the card:
  ``make_optimizer(capturable=True)``, which ``fit`` asks for under
  ``epoch_scan``), so the eager step and a replay are the same bits.  The
  learning rate, betas and eps are baked into the graph, so a changed rate
  (the epoch-400 drop) captures it again; so does anything that rebinds a
  tensor the graph holds (a parameter, a BN buffer, an Adam moment, the
  accumulation buffers, the dataset's planes): the graph is keyed on their
  addresses.
- The first steps of the first epoch run eagerly on a side stream before
  the capture (PyTorch's recipe): they build the kernels, put the loss
  kernels' bases on the card and give Adam its state, so no build, host
  copy or allocation of optimiser state is captured.  They are real steps
  of the epoch, in its order.
- Dropout draws from the caller's ``torch.Generator``, registered with
  every graph, so each replay draws fresh masks: the same masks the eager
  step draws from the same generator state.
- ``accum_steps > 1`` (``optax.MultiSteps``): one graph per position in the
  accumulation cycle, sharing one memory pool, each the eager step's
  ``_apply`` at that position; the running mean lives in the state's
  ``acc_buffers``, allocated once (position 0 zeroes them), and the last
  position also applies Adam.

On the CPU (the tests) ``epoch`` runs the same per-step body eagerly, with
no graph.  On a CUDA device it captures, and a failed capture raises: it
never falls back to eager steps on the card.  :func:`run_epoch` is one
epoch as ``fit`` runs it: the replays, then the ragged tail batch through
the eager step (as svs_tpu's loop does).  The mesh variant waits for the
parallel layouts (ROADMAP A.10).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from svs_torch.data.device_data import epoch_index_arrays, gather_crops
from svs_torch.train.step import TrainState, _accumulator, _apply, \
    loss_and_grads
from svs_torch.utils.config import SVSConfig


def make_epoch_scan(cfg: Optional[SVSConfig] = None, augment: bool = False,
                    mesh=None) -> Callable:
    """``epoch(state, planes, songs, starts, generator, *aug) -> (state,
    losses)``.

    ``planes``: the ``DeviceDataset``'s plane dict; ``songs`` / ``starts``:
    the stacked ``(n_steps, B)`` int32 index matrices
    (``device_data.epoch_index_arrays``); ``aug`` (with ``augment``): the
    stacked ``(perm, g_voc, g_acc)`` of ``Augmenter.epoch_vectors``.  The
    state is updated in place and returned; ``generator`` (dropout's
    source) moves on as ``n_steps`` eager steps would move it; ``losses``
    is the ``(n_steps,)`` per-step total on the planes' device."""
    if mesh is not None:
        raise NotImplementedError(
            "epoch_scan over a device mesh is not ported to svs_torch yet "
            "(ROADMAP A.10); make_epoch_scan runs on one device")
    return _EpochScan(cfg or SVSConfig(), augment)


def run_epoch(epoch_fn: Callable, step: Callable, state: TrainState, ds,
              batch_size: int, seed: int,
              generator: Optional[torch.Generator] = None, augmenter=None
              ) -> Tuple[TrainState, torch.Tensor]:
    """One shuffled epoch of the ``DeviceDataset`` ``ds``: its full batches
    through ``epoch_fn`` (:func:`make_epoch_scan`'s), then the ragged tail
    through the eager ``step``, in the index stream and generator order of
    the per-step loop.  ``augmenter``: an ``Augmenter`` already set for the
    epoch.  Returns the state and the per-step totals on the device."""
    songs, starts, tail = epoch_index_arrays(ds.host, batch_size,
                                             shuffle=True, seed=seed)
    losses = []
    if len(songs):
        aug = (augmenter.epoch_vectors(len(songs), batch_size)
               if augmenter is not None else ())
        state, vec = epoch_fn(state, ds.planes, songs, starts, generator,
                              *aug)
        losses.append(vec)
    if tail is not None:
        batch = ds.gather(tail[0], tail[1])
        if augmenter is not None:
            batch = augmenter(batch, n_real=len(tail[0]))
        state, aux = step(state, batch, generator)
        losses.append(aux["total"].reshape(1))
    dev = next(iter(ds.planes.values())).device
    return state, (torch.cat(losses) if losses
                   else torch.zeros(0, dtype=torch.float32, device=dev))


def _bindings(state: TrainState, planes: Dict[str, torch.Tensor]) -> tuple:
    """What a captured graph holds: the addresses of every tensor it reads
    or writes in place, and the optimiser's constants."""
    opt = state.optimizer
    ptrs = [t.data_ptr() for t in state.model.state_dict().values()]
    for st in opt.state.values():
        ptrs += [t.data_ptr() for t in st.values()
                 if isinstance(t, torch.Tensor)]
    ptrs += [t.data_ptr() for t in state.acc_buffers or ()]
    ptrs += [p.data_ptr() for p in planes.values()]
    consts = tuple((g["lr"], tuple(g["betas"]), g["eps"],
                    g["weight_decay"]) for g in opt.param_groups)
    return tuple(ptrs), consts


class _EpochScan:
    def __init__(self, cfg: SVSConfig, augment: bool):
        self.cfg = cfg
        self.augment = augment
        self.graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, dict]] = {}
        self.key = None
        # static buffers: the epoch's index matrix (songs, starts and, with
        # augment, perm) and gains, the step counter and the loss vector
        self.idx: Optional[torch.Tensor] = None
        self.gains: Optional[torch.Tensor] = None
        self.ctr: Optional[torch.Tensor] = None
        self.losses: Optional[torch.Tensor] = None
        self.captures = 0  # how many times the graphs were captured
        self.replays = 0   # how many steps ran as replays

    # -- the per-step body: eager on the CPU and in warm-up, else captured
    def _body(self, state: TrainState, planes, generator) -> dict:
        """The step at the state's cycle position (``_apply`` moves it on
        when it runs eagerly)."""
        row = self.idx.index_select(0, self.ctr)[0]
        batch = gather_crops(planes, row[0], row[1], self.cfg.input_len)
        if self.augment:
            gains = self.gains.index_select(0, self.ctr)[0]
            from svs_torch.data.augment import apply_remix
            batch = apply_remix(batch, row[2], gains[0], gains[1])
        grads, metrics = loss_and_grads(self.cfg, state, batch, generator)
        _apply(state, grads)
        self.losses.index_copy_(0, self.ctr, metrics["total"].reshape(1))
        self.ctr.add_(1)
        return metrics

    # -- buffers
    def _load(self, planes, songs, starts, aug) -> int:
        n = songs.shape[0]
        dev = next(iter(planes.values())).device
        cols = [songs, starts] + ([aug[0]] if self.augment else [])
        host_idx = torch.from_numpy(np.stack(cols, axis=1).astype(np.int64))
        if self.idx is None or self.idx.shape != host_idx.shape:
            self.idx = torch.empty(host_idx.shape, dtype=torch.int64,
                                   device=dev)
            self.ctr = torch.zeros(1, dtype=torch.int64, device=dev)
            self.losses = torch.zeros(n, dtype=torch.float32, device=dev)
            self.key = None  # new static buffers: capture again
        self.idx.copy_(host_idx)  # the epoch's one upload of indices
        if self.augment:
            host_gains = torch.from_numpy(
                np.stack([aug[1], aug[2]], axis=1).astype(np.float32))
            if self.gains is None or self.gains.shape != host_gains.shape:
                self.gains = torch.empty(host_gains.shape,
                                         dtype=torch.float32, device=dev)
                self.key = None
            self.gains.copy_(host_gains)
        self.ctr.zero_()
        return n

    # -- the epoch
    def __call__(self, state: TrainState, planes: Dict[str, torch.Tensor],
                 songs: np.ndarray, starts: np.ndarray,
                 generator: Optional[torch.Generator] = None, *aug
                 ) -> Tuple[TrainState, torch.Tensor]:
        if self.augment != bool(aug) or (aug and len(aug) != 3):
            raise ValueError("augment=True takes (perm, g_voc, g_acc); "
                             "augment=False takes none")
        songs, starts = np.asarray(songs), np.asarray(starts)
        dev = next(iter(planes.values())).device
        if songs.shape[0] == 0:
            return state, torch.zeros(0, dtype=torch.float32, device=dev)
        n = self._load(planes, songs, starts, aug)
        if dev.type == "cuda":
            self._replay_epoch(state, planes, generator, n)
        else:
            for _ in range(n):
                self._body(state, planes, generator)
                state.step += 1
        return state, self.losses.clone()

    def _replay_epoch(self, state, planes, generator, n: int) -> None:
        if generator is None:
            raise ValueError("epoch_scan on a CUDA device needs dropout's "
                             "torch.Generator (a graph registers it)")
        if not all(g["capturable"] for g in state.optimizer.param_groups):
            raise ValueError("epoch_scan needs the state's Adam in its "
                             "capturable form "
                             "(step.make_optimizer(capturable=True))")
        done = 0
        if not self.graphs:
            done = self._warm_up(state, planes, generator, n)
        if done == n:
            return
        if state.acc_grads is not None:
            _accumulator(state, state.acc_grads)  # a loaded cycle
        key = _bindings(state, planes)
        if key != self.key:
            self._capture(state, planes, generator)
            self.key = key
        for _ in range(done, n):
            k = state.mini_step
            self.graphs[k][0].replay()
            # what the replayed _apply did to the host's cycle position
            state.step += 1
            state.mini_step = (k + 1) % state.accum_steps
            state.acc_grads = state.acc_buffers if state.mini_step else None
            self.replays += 1

    def _warm_up(self, state, planes, generator, n: int) -> int:
        """Eager steps of the epoch on a side stream until Adam has its
        state (at least one): returns how many ran."""
        params = list(state.model.parameters())
        dev = params[0].device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        done = 0
        with torch.cuda.stream(side):
            while done < n and (done == 0 or len(state.optimizer.state)
                                < len(params)):
                self._body(state, planes, generator)
                state.step += 1
                done += 1
        torch.cuda.current_stream(dev).wait_stream(side)
        return done

    def _capture(self, state, planes, generator) -> None:
        """One graph per accumulation position, in one memory pool; capture
        runs nothing, so the host's cycle position is put back after it."""
        self.graphs = {}
        position, acc = state.mini_step, state.acc_grads
        pool = None
        try:
            for k in range(state.accum_steps):
                graph = torch.cuda.CUDAGraph()
                graph.register_generator_state(generator)
                state.mini_step = k
                state.acc_grads = state.acc_buffers if k else None
                with torch.cuda.graph(graph, pool=pool):
                    metrics = self._body(state, planes, generator)
                pool = graph.pool()
                self.graphs[k] = (graph, metrics)
        finally:
            state.mini_step, state.acc_grads = position, acc
        self.captures += 1
