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

What the capture needs, and how it is met (the rules ``train/graphs.py``
shares with the step programs):

- Adam runs in its capturable form (its step counts on the card:
  ``make_optimizer``'s default on a CUDA device), so the eager step and a
  replay are the same bits.  The learning rate, betas and eps are baked
  into the graph, so a changed rate (the epoch-400 drop) captures it
  again; so does anything that rebinds a tensor the graph holds (a
  parameter, a BN buffer, an Adam moment, the accumulation buffers, the
  dataset's planes) or a TF32 or cuDNN flag: the graph is keyed on them
  (``graphs.binding``).
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
the train step ``fit`` runs (``make_train_step``'s program of the tail's
shape on the card, as svs_tpu's loop runs its jitted step).

Over a plain data-parallel mesh (``mesh=``, svs_tpu scan.py:102-148) every
rank runs the same epoch on its own card: the body gathers the global
batch, remixes it whole (with ``augment``), keeps this rank's block of
rows and runs the DP step's body (``dp.dp_body``, the one the DP step's
program captures: sync-BN, the global loss, the gradient summed over the
ranks), so the graph holds the step's collectives.  The block is
``mesh.shard_batch``'s: the batch padded with zero rows to a multiple of
the ranks, with the 0/1 ``weight``; both are static device buffers made
when the epoch's indices are loaded, so no replay touches the host.  NCCL
makes its communicator at the first collective, which the eager warm-up
step runs before any capture; every rank captures and replays the same
graphs in the same order (a capture again after the learning-rate drop
happens on every rank alike).  Gloo's
collectives run on the host, where no graph can hold them: a mesh of more
than one rank over gloo on a CUDA device (two ranks sharing one card) is
refused before any step.  On the CPU the gloo ranks run the body eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from svs_torch.data.device_data import epoch_index_arrays, gather_crops
from svs_torch.parallel import dp
from svs_torch.parallel import mesh as mesh_lib
from svs_torch.train import graphs as step_graphs
from svs_torch.train.step import TrainState, _step_body
from svs_torch.utils.config import SVSConfig

# svs_tpu's refusal of epoch_scan off a single process or plain-DP mesh
SCAN_REFUSAL = ("epoch_scan requires the device-resident dataset on a "
                "single-process run, mesh-free or plain-DP mesh "
                "(device_data='on'/'auto' with the dataset under the HBM "
                "cap; not cp/tp/zero1/fsdp)")


def refuse_mesh(mesh) -> None:
    """What ``epoch_scan`` refuses of a mesh, before any step: anything
    but a 1-D data mesh (``TypeError``), a 2-D one or one of several hosts
    (svs_tpu's rule), and gloo on a CUDA device across ranks (the port's:
    no CUDA graph holds a host collective)."""
    if not isinstance(mesh, mesh_lib.Mesh):
        raise TypeError("epoch_scan's mesh must be a parallel.mesh.Mesh "
                        f"(make_mesh), not {type(mesh).__name__}")
    if isinstance(mesh, mesh_lib.Mesh2D) or mesh.hosts > 1:
        raise ValueError(SCAN_REFUSAL)
    if mesh_lib.host_collectives(mesh):
        raise ValueError(
            f"epoch_scan over {mesh.size} gloo ranks on {mesh.device.type}: "
            "a CUDA graph cannot capture gloo's collectives, which run on "
            "the host (ranks that share one card run gloo, since NCCL "
            "refuses them); train these ranks without epoch_scan, or one "
            "card a rank over NCCL")


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
    is the ``(n_steps,)`` per-step total on the planes' device.

    ``mesh``: a plain data-parallel ``parallel.mesh.Mesh``; the state is
    the rank's replicated one, the planes its ``DeviceDataset``'s and the
    index matrices the global batch's, the same on every rank; ``losses``
    are the global batch's (:func:`refuse_mesh` says what is refused)."""
    if mesh is not None:
        refuse_mesh(mesh)
    return _EpochScan(cfg or SVSConfig(), augment, mesh)


def run_epoch(epoch_fn: Callable, step: Callable, state: TrainState, ds,
              batch_size: int, seed: int,
              generator: Optional[torch.Generator] = None, augmenter=None,
              mesh=None) -> Tuple[TrainState, torch.Tensor]:
    """One shuffled epoch of the ``DeviceDataset`` ``ds``: its full batches
    through ``epoch_fn`` (:func:`make_epoch_scan`'s), then the ragged tail
    through ``step``, in the index stream and generator order of
    the per-step loop.  ``augmenter``: an ``Augmenter`` already set for the
    epoch.  ``mesh``: the epoch function's; the tail is then remixed whole
    and cut to this rank's rows (``mesh.shard_batch``) for the DP
    ``step``.  Returns the state and the per-step totals on the device."""
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
        if mesh is not None:
            batch = mesh_lib.shard_batch(mesh, batch)
        state, aux = step(state, batch, generator)
        losses.append(aux["total"].reshape(1))
    dev = next(iter(ds.planes.values())).device
    return state, (torch.cat(losses) if losses
                   else torch.zeros(0, dtype=torch.float32, device=dev))


class _EpochScan:
    def __init__(self, cfg: SVSConfig, augment: bool, mesh=None):
        self.cfg = cfg
        self.augment = augment
        self.mesh = mesh
        # the step without its count: the single step's, or the DP step's
        self.step_body = (_step_body(cfg) if mesh is None
                          else dp.dp_body(cfg, mesh))
        # per accumulation position: the graph and its static metrics
        self.graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, dict]] = {}
        self.key = None
        # static buffers: the epoch's index matrix (songs, starts and, with
        # augment, perm) and gains, the step counter and the loss vector
        self.idx: Optional[torch.Tensor] = None
        self.gains: Optional[torch.Tensor] = None
        self.ctr: Optional[torch.Tensor] = None
        self.losses: Optional[torch.Tensor] = None
        # with a mesh: this rank's (first row, real rows) of the global
        # batch, its 0/1 weight and the zero rows past the batch's end
        self.rows: Tuple[int, int] = (0, 0)
        self.weight: Optional[torch.Tensor] = None
        self.pad: Optional[torch.Tensor] = None
        self.block_spec = None
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
        if self.mesh is not None:
            batch = self._block(batch)
        metrics = self.step_body(state, batch, generator)
        self.losses.index_copy_(0, self.ctr, metrics["total"].reshape(1))
        self.ctr.add_(1)
        return metrics

    def _block(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global batch, as ``mesh.shard_batch``
        cuts them, from the static weight and pad rows."""
        lo, n_own = self.rows
        out = {}
        for k, v in batch.items():
            own = v.narrow(0, lo, n_own)
            out[k] = own if self.pad is None else torch.cat([own, self.pad])
        out["weight"] = self.weight
        return out

    # -- buffers
    def _load_block(self, planes, b: int) -> None:
        """The mesh body's static buffers for a global batch of ``b``
        rows: ``mesh.shard_batch``'s cut, made once on the device."""
        first = next(iter(planes.values()))
        spec = (b, first.shape[1], first.dtype, first.device)
        if spec == self.block_spec:
            return
        per = -(-b // self.mesh.size)
        lo = min(self.mesh.rank * per, b)
        n_own = min(per, b - lo)
        weight = torch.zeros(per, dtype=torch.float32)
        weight[:n_own] = 1.0
        self.weight = weight.to(first.device)
        self.pad = (first.new_zeros((per - n_own, first.shape[1],
                                     self.cfg.input_len))
                    if n_own < per else None)
        self.rows, self.block_spec = (lo, n_own), spec
        self.key = None  # new static buffers: capture again

    def _load(self, planes, songs, starts, aug) -> int:
        n = songs.shape[0]
        dev = next(iter(planes.values())).device
        if self.mesh is not None:
            self._load_block(planes, songs.shape[1])
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
        if self.mesh is not None and dev != self.mesh.device:
            raise ValueError(f"the planes lie on {dev}, the mesh's rank on "
                             f"{self.mesh.device}")
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
        """The epoch's steps on the card (``train/graphs.py``'s capture
        rules): eager warm-up steps before the first capture, a capture
        whenever the binding moved, then replays."""
        if generator is None:
            raise ValueError("epoch_scan on a CUDA device needs dropout's "
                             "torch.Generator (a graph registers it)")
        step_graphs.require_capturable(state, "epoch_scan")
        dev = self.idx.device

        def run():
            return self._body(state, planes, generator)

        done = 0
        if not self.graphs:
            done, _ = step_graphs.warm_up(state, run, n, dev)
        if done == n:
            return
        step_graphs.adopt_cycle(state)
        key = step_graphs.binding(state, [*planes.values(), self.weight,
                                          self.pad])
        if key != self.key:
            self.graphs = {}
            self.graphs, _ = step_graphs.capture(state, run, generator, dev)
            self.key = key
            self.captures += 1
        for _ in range(done, n):
            step_graphs.replay(state, self.graphs)
            self.replays += 1
