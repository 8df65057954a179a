"""The training loop (port of ``svs_tpu/train/loop.py``).

Contracts kept from the reference (train.py:239-389) and svs_tpu:

- the learning rate drops to ``cfg.lr_after_drop`` at ``cfg.lr_drop_epoch``
  and ``svs_<label>_400.ckpt`` is written (train.py:251-262);
- validation every ``val_interval`` epochs with the best checkpoint
  ``svs_best_<label>.ckpt`` tracked from 100.0 (train.py:209,316-355),
  restored from the checkpoint on resume;
- the append-only text log ``<log_dir>/log_<label>.txt``: one train-loss
  float per epoch and ``Val <float>`` after each validation, buffered and
  flushed at validation time (train.py:313-314,350,357-363,384-387);
- ``metrics_<label>.jsonl``, one line per epoch and per validation;
- the latest checkpoint ``svs_<label>.ckpt`` every ``save_every`` epochs;
- resume from ``load_path`` (a native ``.ckpt`` or a reference ``.pth``);
- SIGTERM sets a flag; the loop saves at its next safe point and exits 143;
- the per-epoch crop seed ``seed * 100003 + ep``.

The step is svs_torch's (:mod:`svs_torch.train.step`), which updates the
state in place: on one CUDA device the train and eval steps run as cached
captured programs (:mod:`svs_torch.train.graphs`, svs_tpu's jitted steps:
one per batch shape, so the ragged tail and validation's last batch have
their own), eagerly on the CPU.  So do the DP, ZeRO-1, FSDP, TP and CP
steps below on a CUDA device over NCCL (or a world of one), their
collectives captured with them; gloo ranks on a CUDA device run their
eager bodies (``graphs.mesh_programmed``), as does PP.  Adam
is its capturable form on a CUDA device, whatever the path.  The epoch's
losses stay on the device until the epoch ends and are fetched once, so no
step waits on the card.
Dropout draws from one ``torch.Generator`` on the training device, seeded
from ``seed + 1`` (svs_tpu's ``jax.random.key(seed + 1)``; the two streams
differ).  The MR-STFT loss's magnitudes follow ``cfg.mr_mag_impl``: the
CUDA kernels ``pallas_fused`` / ``pallas_fused_wide`` (loss_partials) and
``pallas_bf16`` (spectral_mag) run here when ``fit`` is given such a
config; the default stays ``matmul_bf16``, which on the card runs the
loss_partials kernels' rounded instances (``losses/mrstft.py``).

``epoch_scan`` runs each epoch's full batches as replays of one captured
CUDA graph of the step (:mod:`svs_torch.train.scan`; eager on the CPU),
then the ragged tail through the train step; it needs the dataset on the
device.  Over a plain-DP mesh the graph is of the DP step, its collectives
included, on every rank (a single process a host, as svs_tpu allows it:
loop.py:477-494), and the tail is cut as the per-step loop cuts it.
``val_sdr`` scores the validation songs' separated vocals with BSS eval
after each validation (:mod:`svs_torch.evaluation.val_sdr`).

With ``mesh`` (a ``parallel.mesh.Mesh``, one process per device) and
``parallel="dp"`` the loop is data-parallel (svs_tpu loop.py:393-447): each
rank steps on its rows of every global batch through
``parallel.dp.make_dp_train_step`` (sync-BN, global losses, the gradient
summed over the ranks) from rank 0's replicated state, and validates
through the global weighted eval step (remainder batches padded to the
full batch's rows).  Every rank reads the checkpoint it resumes from; rank
0 alone writes ``CKPT/`` and ``LOG/`` (svs_tpu's ``is_primary``) and scores
``val_sdr``.  The SIGTERM flag is agreed across the ranks where the loop
checks it, so that every rank stops at the same step.

With ``zero1`` or ``fsdp`` the DP mesh's state is sharded
(:mod:`svs_torch.parallel.zero`, svs_tpu loop.py:395-406): the state is
replicated from rank 0 and then cut into each rank's slices, so a resume
is broadcast first and sharded after; the step is
``zero.make_zero1_train_step``; every save site (latest, best, the
learning-rate drop, preemption, the ``.pth`` export) gathers the full
state on every rank (``zero.unshard_state``, svs_tpu loop.py:463-465)
before rank 0 writes the canonical ``.ckpt``, so a checkpoint resumes
into any layout; validation under FSDP gathers the parameters inside its
eval step (``zero.make_zero1_eval_step``).
``epoch_scan`` is refused with either, as svs_tpu refuses it.

With ``parallel="tp"`` and a 2-D mesh (``parallel.mesh.make_2d_mesh``) the
loop is tensor-parallel (:mod:`svs_torch.parallel.tp`, svs_tpu loop.py:
346-371): the state is replicated over the world from rank 0 and cut into
each rank's channel slices (``tp.shard_state``), the step is
``tp.make_tp_train_step`` on this data row's rows of each global batch
(the crops and the remix the global batch's, as under DP), validation
``tp.make_tp_eval_step``; every save site gathers the full state over the
model sub-mesh (``zero.unshard_state``) before rank 0 writes the
canonical ``.ckpt``, so a TP run resumes into DP and the other way round;
the SIGTERM flag is agreed over the whole world.  ``epoch_scan``,
``zero1`` and ``fsdp`` are refused with TP, as svs_tpu refuses them.

With ``parallel="pp"`` and a pair of stage devices
(``parallel.pp.make_pp_mesh``) the loop is pipeline-parallel
(:mod:`svs_torch.parallel.pp`, svs_tpu loop.py:313-342), in one process:
the state is made on stage 0's device, restored there from a checkpoint,
then cut into its stages (``pp.shard_state``); the step is
``pp.make_pp_train_step`` with ``pp_micro`` microbatches split at
``pp_split``, fed by the host pipeline (no device dataset, as svs_tpu's),
each batch padded to ``batch_size`` rows by ``pp.pad_batch`` (a padded
microbatch is skipped); batches and the dropout generator live on stage 0's
device, which runs the loss; validation is ``pp.make_pp_eval_step``; both
steps run as cached programs where both stages are one CUDA device
(``pp.programmed``: a full batch and a ragged tail a program each), and
eagerly over two distinct cards; every save site writes
``pp.gather_state``'s copy of the whole state on one device, the canonical
``.ckpt``.  A multi-process run, a mesh that is not two stages, a
``pp_micro`` that does not divide ``batch_size``, ``accum_steps > 1``,
``epoch_scan``, ``zero1`` and ``fsdp`` are refused.

With ``parallel="cp"`` and a data mesh the loop is context-parallel
(:mod:`svs_torch.parallel.halo`, svs_tpu loop.py:219-249,283-297): every
rank holds the whole state (replicated from rank 0) and samples the same
whole batch from the shared epoch seed, remixes it whole, and steps on its
block of the time axis (``halo.make_cp_train_step``).  The dataset stays
on the device in its time-sharded form (``DeviceDataset(time_sharded=
True)``) where ``device_data`` allows it and ``input_len`` is a multiple
of ``64 * size`` ("auto" takes the host pipeline with
``halo.shard_batch_time`` otherwise, "on" raises); validation runs the
plain eval step on the whole batch; rank 0 writes the canonical ``.ckpt``
of the replicated state.  ``epoch_scan``, ``zero1`` and ``fsdp`` are
refused with CP, as svs_tpu refuses them.

With a mesh of more than one host (``Mesh.hosts``: ``torchrun``'s nodes,
or one process a host through ``train_cli --coordinator``) the loop is
multi-host (:mod:`svs_torch.parallel.multihost`, svs_tpu loop.py:161-205,
273-280,394-448,603-611,651,774-781).  Under DP, ZeRO-1, FSDP and TP each
host trains on its round-robin share of the songs (a host with none takes
one, wrapping around), samples ``local_bs = ceil(batch_size / hosts)``
rows a step from its own seed (``seed * 100003 + ep + host * 7919``) for
``ceil(len(songs' patches) / (local_bs * hosts))`` steps, counted before
the songs are cut so that every host takes as many, pads its batch to a
multiple of its data ranks with zero rows and a 0/1 ``weight``, and each
of its ranks steps on its block of it (``global_batch_from_local``; under
TP the host's data rows).  Under DP, ZeRO-1 and FSDP the host's songs stay
on each rank's device where ``device_data`` allows
(``MultiHostDeviceDataset``, gated on the bytes a device); the remix is
then each rank's share of its host's draws (``Augmenter.apply_sharded``),
and otherwise the numpy remix of the host's real rows before they are
padded.  CP keeps the songs whole and the seed unmixed: every host samples
the same batch, which the loop then handles as one host does.  Validation
iterates the whole validation set on every host; its loss must agree
across the ranks (``assert_scalar_agreement``).  After a restore every
rank runs ``sync_resume``, which gives a host with a missing or older
checkpoint rank 0's state.  The SIGTERM flag is agreed at every 8th step
and at each epoch's end.  A TP mesh whose model group spans two hosts,
``val_sdr`` and ``epoch_scan`` are refused, as svs_tpu refuses them.

``device_put``, a callable of the host batch (numpy; the remixed batch's
tensors on the device with ``augment``, remixed first as a whole, or under
several hosts the host's rows in numpy) to this rank's step input,
replaces the distributor of the training and the validation batches (the
default's ``mesh.shard_batch`` / ``global_batch_from_global``,
``halo.shard_batch_time`` or ``pp.pad_batch``) and keeps the dataset on
the host.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from svs_torch.data import device_data as dd
from svs_torch.data.dataset import PatchDataset
from svs_torch.parallel import dp
from svs_torch.parallel import mesh as mesh_lib
from svs_torch.parallel import halo, multihost, pp, tp, zero
from svs_torch.train import checkpoint as ckpt_lib
from svs_torch.train.scan import SCAN_REFUSAL, refuse_mesh
from svs_torch.train.step import (TrainState, batch_to_device,
                                  create_train_state, get_learning_rate,
                                  make_eval_step, make_optimizer,
                                  make_train_step, reset_accumulation,
                                  set_learning_rate)
from svs_torch.utils.config import SVSConfig
from svs_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainOptions:
    """svs_tpu's ``TrainOptions`` (the reference's CLI surface, train.py:
    157-167, and svs_tpu's extensions), the same fields and defaults, plus
    ``device``."""
    train_folder: str = "./data/vocals"
    load_path: str = "result.ckpt"
    label: str = "run"
    epoch: int = 2
    batch_size: int = 2
    valid_folder: str = "unet_spectrograms/valid"
    val_interval: int = 20
    ckpt_dir: str = "CKPT"
    log_dir: str = "LOG"
    seed: int = 0
    export_pth: bool = False
    # write checkpoints from a worker thread (device-side snapshot first)
    async_save: bool = False
    progress: bool = True
    # latest-checkpoint cadence in epochs (the reference writes every epoch)
    save_every: int = 1
    # the host batch -> this rank's step input, in place of the default
    # distributor (the dataset then stays on the host)
    device_put: Optional[Callable] = None
    # keep the spectrogram dataset on the device and gather crops there
    # (data/device_data.py): "auto" when it fits device_data_cap_mb
    device_data: str = "auto"  # "auto" | "on" | "off"
    device_data_cap_mb: float = 2048.0
    epoch_scan: bool = False   # the epoch as replays of a CUDA graph
    # a parallel.mesh.Mesh: data-parallel training over its ranks (with
    # parallel="cp" context-parallel); with parallel="tp" a Mesh2D
    # (make_2d_mesh), with parallel="pp" the pair of stage devices
    # (pp.make_pp_mesh)
    mesh: Optional[object] = None
    parallel: str = "dp"       # "dp" | "cp" | "tp" | "pp"
    pp_micro: int = 4
    pp_split: int = 3
    # shard Adam's moments (zero1), and the parameters and BN statistics
    # too (fsdp), over the mesh's ranks
    zero1: bool = False
    fsdp: bool = False
    # gradient accumulation: one Adam update every accum_steps microbatches
    # with their mean gradient; resume with the same value
    accum_steps: int = 1
    val_sdr: bool = False      # vocal SDR at each validation
    val_sdr_songs: Optional[int] = None
    # remix augmentation (data/augment.py), off by default
    augment: bool = False
    remix_p: float = 0.5
    aug_gain_lo: float = 0.25
    aug_gain_hi: float = 1.25
    # the port's own: the training device ("cuda" unless the caller asks
    # for the CPU; raises without a card)
    device: Optional[str] = None


def _refuse_unported(opts: TrainOptions) -> None:
    if opts.parallel not in ("dp", "cp", "tp", "pp"):
        raise ValueError(f"unknown parallel layout {opts.parallel!r}")
    if opts.device_data not in ("auto", "on", "off"):
        raise ValueError(f"device_data must be on/off/auto, got "
                         f"{opts.device_data!r}")
    if opts.parallel == "pp":
        _refuse_pp(opts)
        return
    if opts.parallel == "tp":
        if not isinstance(opts.mesh, mesh_lib.Mesh2D):
            raise ValueError("parallel='tp' needs a (data, model) mesh: "
                             "TrainOptions.mesh = parallel.mesh."
                             "make_2d_mesh(n_data, n_model)")
        if opts.zero1 or opts.fsdp:
            raise ValueError("zero1 / fsdp compose with dp only (TP "
                             "already shards the state with its channels)")
        if opts.epoch_scan:
            raise ValueError(SCAN_REFUSAL)
    if opts.parallel == "cp":
        if (not isinstance(opts.mesh, mesh_lib.Mesh)
                or isinstance(opts.mesh, mesh_lib.Mesh2D)):
            raise ValueError("parallel='cp' needs a data mesh: "
                             "TrainOptions.mesh = parallel.mesh.make_mesh()")
        if opts.zero1 or opts.fsdp:
            raise ValueError("zero1 / fsdp compose with dp only (CP "
                             "replicates the state)")
        if opts.epoch_scan:
            raise ValueError(SCAN_REFUSAL)
    if opts.mesh is None:
        if opts.zero1 or opts.fsdp:
            raise ValueError("zero1 / fsdp shard the training state across "
                             "a DP mesh: pass TrainOptions.mesh "
                             "(parallel.mesh.make_mesh)")
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise ValueError("multi-process training requires "
                             "TrainOptions.mesh (parallel.mesh.make_mesh)")
        return
    if not isinstance(opts.mesh, mesh_lib.Mesh):
        raise TypeError("TrainOptions.mesh must be a parallel.mesh.Mesh "
                        f"(make_mesh), not {type(opts.mesh).__name__}")
    if opts.mesh.hosts > 1:
        # svs_tpu loop.py:163,353-369,486-491
        if opts.val_sdr:
            raise ValueError("val_sdr requires a single-process run: "
                             "whole-song decode gathers the full params on "
                             "the host")
        if opts.epoch_scan:
            raise ValueError(SCAN_REFUSAL)
        if opts.parallel == "tp" and opts.mesh.model_crosses_hosts:
            raise ValueError(
                "multi-host TP: the 'model' axis crosses hosts — build the "
                "mesh data-major (parallel.mesh.make_2d_mesh) with the "
                "model ranks of a group on one host, so TP activations "
                "stay within a host")
    if opts.epoch_scan:
        if opts.zero1 or opts.fsdp:
            raise ValueError(SCAN_REFUSAL)
        refuse_mesh(opts.mesh)  # gloo ranks sharing a card, before a step
    if (opts.device is not None
            and torch.device(opts.device).type != opts.mesh.device.type):
        raise ValueError(f"device {opts.device!r} is not the mesh's "
                         f"{opts.mesh.device}")


def _refuse_pp(opts: TrainOptions) -> None:
    """svs_tpu's refusals for ``parallel='pp'`` (loop.py:321-337)."""
    if (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise ValueError("parallel='pp' is single-process: one process "
                         "drives both stage devices")
    devs = pp.stage_devices(opts.mesh)
    pp.stage_levels(opts.pp_split)
    if opts.pp_micro < 1 or opts.batch_size % opts.pp_micro:
        raise ValueError(f"pp_micro must divide batch_size "
                         f"({opts.pp_micro} vs {opts.batch_size})")
    if opts.accum_steps > 1:
        raise ValueError("parallel='pp' does not compose with accum_steps "
                         "> 1 (pipeline microbatching already accumulates; "
                         "raise pp_micro instead)")
    if opts.zero1 or opts.fsdp:
        raise ValueError("zero1 / fsdp compose with dp only")
    if opts.epoch_scan:
        raise ValueError(SCAN_REFUSAL)
    if (opts.device is not None
            and torch.device(opts.device).type != devs[0].type):
        raise ValueError(f"device {opts.device!r} is not stage 0's "
                         f"{devs[0]}")


def _dataset(folder: str, cfg: SVSConfig) -> PatchDataset:
    return PatchDataset(folder, samples_per_song=cfg.samples_per_song,
                        input_len=cfg.input_len)


def _on_device(batch, dev: torch.device):
    """A host batch (numpy) onto the device; device batches pass."""
    if isinstance(next(iter(batch.values())), torch.Tensor):
        return batch
    return batch_to_device(batch, dev)


def fit(opts: TrainOptions, cfg: Optional[SVSConfig] = None) -> TrainState:
    cfg = cfg or SVSConfig()
    _refuse_unported(opts)
    if opts.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {opts.accum_steps}")
    is_pp = opts.parallel == "pp"  # on a pair of stages (_refuse_pp)
    # the data mesh; a PP run is one process, whose stage 0 takes the
    # batches, runs the loss and holds the dropout generator
    mesh = None if is_pp else opts.mesh
    # rank 0 alone writes files and prints (svs_tpu's is_primary)
    primary = mesh is None or mesh.is_primary
    say = print if primary else (lambda *a, **k: None)
    dev = (pp.stage_devices(opts.mesh)[0] if is_pp
           else mesh.device if mesh is not None
           else resolve_device(opts.device))
    if primary:
        os.makedirs(opts.ckpt_dir, exist_ok=True)
        os.makedirs(opts.log_dir, exist_ok=True)
    log_file = os.path.join(opts.log_dir, f"log_{opts.label}.txt")
    metrics_file = os.path.join(opts.log_dir, f"metrics_{opts.label}.jsonl")
    best_weight = os.path.join(opts.ckpt_dir, f"svs_best_{opts.label}.ckpt")
    ckpt_weight = os.path.join(opts.ckpt_dir, f"svs_{opts.label}.ckpt")

    train_ds = _dataset(opts.train_folder, cfg)
    valid_ds = None
    if os.path.exists(opts.valid_folder):
        try:
            valid_ds = _dataset(opts.valid_folder, cfg)
        except FileNotFoundError:
            valid_ds = None
    if valid_ds is None:
        say(f"Warning: no validation folder {opts.valid_folder}; skipping "
            "validation.")
    is_cp = opts.parallel == "cp"  # on a data mesh (_refuse_unported)
    hook = opts.device_put
    # several hosts, each sampling its own rows (svs_tpu loop.py:161-205;
    # CP samples one batch on every host, as on one host)
    multi = mesh is not None and mesh.hosts > 1
    per_host = multi and not is_cp
    local_bs, train_steps, pad_to = opts.batch_size, None, None
    if per_host:
        # the step count from the global dataset, before the cut
        local_bs, train_steps = multihost.host_schedule(
            opts.batch_size, len(train_ds), mesh.hosts)
        multihost.shard_songs(train_ds, mesh.host, mesh.hosts)
        pad_to = multihost.pad_rows(local_bs, mesh)
    if hook is not None or opts.device_data == "off" or is_pp:
        pass  # host batches: the hook's, or PP's padded whole batches
    elif multi:
        # DP / ZeRO-1 / FSDP: each rank holds its host's songs, gated on
        # the bytes a device; validation keeps the host pipeline
        if not (is_cp or opts.parallel == "tp") and (
                opts.device_data == "on"
                or dd.resident_bytes(train_ds)
                <= opts.device_data_cap_mb * 2**20):
            train_ds = dd.MultiHostDeviceDataset(train_ds, mesh, pad_to)
            say(f"[svs-torch] device-resident dataset (multi-host): "
                f"{train_ds.nbytes_per_device / 2**20:.0f} MiB/device")
    elif is_cp:
        # time-sharded on the device where input_len meets the granule
        # ("on" refuses one that does not), else the host pipeline;
        # validation keeps the host pipeline (svs_tpu loop.py:236-249)
        if opts.device_data == "on" or \
                train_ds.input_len % halo.granule(mesh) == 0:
            train_ds = dd.maybe_device_dataset(
                train_ds, opts.device_data, opts.device_data_cap_mb,
                mesh=mesh, device=dev, time_sharded=True)
    else:
        train_ds = dd.maybe_device_dataset(train_ds, opts.device_data,
                                           opts.device_data_cap_mb,
                                           mesh=mesh, device=dev)
        valid_ds = dd.maybe_device_dataset(valid_ds, opts.device_data,
                                           opts.device_data_cap_mb,
                                           mesh=mesh, device=dev)
    if isinstance(train_ds, dd.DeviceDataset):
        say(f"[svs-torch] device-resident dataset: "
            f"{train_ds.nbytes / 2**20:.0f} MiB on {dev}")
    sharded_feed = isinstance(train_ds, dd.MultiHostDeviceDataset)

    epoch_fn = None
    if opts.epoch_scan:
        if not isinstance(train_ds, dd.DeviceDataset):
            raise ValueError(SCAN_REFUSAL)
        # looked up when fit runs, so that a caller may wrap them
        from svs_torch.train.scan import make_epoch_scan, run_epoch
        epoch_fn = make_epoch_scan(cfg, augment=opts.augment, mesh=mesh)

    # capturable on a CUDA device (the form a CUDA graph replays), so the
    # step programs (the single device's and every layout's), their eager
    # bodies and epoch_scan's graphs all update as one Adam
    optimizer = make_optimizer(cfg, accum_steps=opts.accum_steps)
    state = create_train_state(opts.seed, cfg, optimizer, device=dev)
    sharded = opts.zero1 or opts.fsdp  # on a mesh (_refuse_unported)
    is_tp = opts.parallel == "tp"  # on a Mesh2D (_refuse_unported)
    # the mesh a global batch's rows are cut over
    rows = mesh.data if is_tp else mesh
    if is_pp:
        train_step = pp.make_pp_train_step(opts.mesh, cfg,
                                           n_micro=opts.pp_micro,
                                           split=opts.pp_split)
        eval_step = pp.make_pp_eval_step(opts.mesh, cfg, split=opts.pp_split)
    elif mesh is None:
        train_step = make_train_step(cfg)
        eval_step = make_eval_step(cfg)
    elif is_tp:
        train_step = tp.make_tp_train_step(mesh, cfg)
        eval_step = tp.make_tp_eval_step(mesh, cfg)
    elif is_cp:
        # svs_tpu validates CP on the whole batch through the plain step
        train_step = halo.make_cp_train_step(mesh, cfg)
        eval_step = make_eval_step(cfg)
    elif sharded:
        train_step = zero.make_zero1_train_step(mesh, cfg, fsdp=opts.fsdp)
        eval_step = zero.make_zero1_eval_step(mesh, cfg, fsdp=opts.fsdp)
    else:
        train_step = dp.make_dp_train_step(mesh, cfg)
        eval_step = dp.make_dp_eval_step(mesh, cfg)

    start_epoch = 0
    extras = {}
    if os.path.exists(opts.load_path):
        # every rank reads it
        state, start_epoch, extras = ckpt_lib.resume(opts.load_path, state)
        say(f"Loaded checkpoint from {opts.load_path} "
            f"(epoch {start_epoch})")
    if multi:
        # every rank, whether or not its file existed (a collective): a
        # host behind rank 0 takes its state
        state, start_epoch, extras = multihost.sync_resume(
            state, start_epoch, extras, mesh)
    if mesh is not None:
        dp.replicate_state(state, mesh)
    if sharded:
        state = zero.shard_state(state, mesh, fsdp=opts.fsdp)
    elif is_tp:
        state = tp.shard_state(state, mesh)
    elif is_pp:  # after the restore, which loads onto one device
        state = pp.shard_state(state, opts.mesh, split=opts.pp_split)

    augmenter = None
    if opts.augment:
        from svs_torch.data.augment import Augmenter
        # across hosts the numpy remix of the host's rows, except on
        # the device-resident shards (svs_tpu loop.py:505-524)
        augmenter = Augmenter(opts.remix_p, opts.aug_gain_lo,
                              opts.aug_gain_hi,
                              host=multi and not sharded_feed)

    time_cut = isinstance(train_ds, dd.DeviceDataset) and \
        train_ds.time_sharded

    def _local(batch, n_real: int):
        """A host or device batch as this rank's step input: remixed
        whole, then (with a mesh) cut to this rank's (data row's) rows, or
        under CP to this rank's time block (a time-sharded device batch is
        cut already: the remix is row-local and elementwise in time).
        Across hosts the host's rows are remixed in numpy, then padded
        and cut; a device-resident block is its own shard of the remix."""
        if sharded_feed:
            return (batch if augmenter is None else
                    augmenter.apply_sharded(batch, n_real, mesh=rows))
        if augmenter is not None:
            batch = (augmenter(batch) if augmenter.host else
                     augmenter(_on_device(batch, dev), n_real=n_real))
        if hook is not None:
            return hook(batch)
        if per_host:
            return multihost.global_batch_from_local(rows, batch, pad_to)
        if is_pp:  # moved to stage 0 by the step
            return pp.pad_batch(batch, opts.batch_size)
        if mesh is None:
            return _on_device(batch, dev)
        if is_cp:
            return batch if time_cut else halo.shard_batch_time(mesh, batch)
        return mesh_lib.shard_batch(rows, batch)

    def _val_local(batch):
        """A validation batch as this rank's eval input (with a mesh, a
        remainder batch padded to the full batch's rows; under CP the
        whole batch)."""
        if hook is not None:
            return hook(batch)
        if is_pp:
            return pp.pad_batch(batch, opts.batch_size)
        if mesh is None or is_cp:
            return _on_device(batch, dev)
        return mesh_lib.global_batch_from_global(rows, batch,
                                                 opts.batch_size)

    def _record(record: dict) -> None:
        if primary:
            with open(metrics_file, "a") as f:
                f.write(json.dumps(record) + "\n")

    # 100.0 per reference train.py:209, restored on resume so that a
    # resumed run cannot overwrite svs_best with a worse model
    best_val_loss = float(extras.get("best_val_loss", 100.0))
    saver = ckpt_lib.AsyncSaver() if opts.async_save and primary else None
    # what a save writes: a sharded state is gathered on every rank first
    # (a collective), then rank 0 writes it
    snap_state = (zero.unshard_state if sharded or is_tp
                  else pp.gather_state if is_pp else (lambda s: s))

    def save_ckpt(path, snap, **kw):
        if primary:
            (saver.save if saver else ckpt_lib.save)(path, snap, **kw)

    def export_ckpt(path, snap, **kw):
        if primary:
            (saver.export_pth if saver else ckpt_lib.export_pth)(path, snap,
                                                                 **kw)

    log_buffer: List[str] = []
    # the per-epoch loss history, persisted like the reference's
    # loss_list_total (model.py:112-114, train.py:377-379)
    loss_history: List[float] = [float(x) for x in
                                 extras.get("loss_list_total", [])]
    gen = torch.Generator(dev).manual_seed(opts.seed + 1)

    def _flush_log():
        nonlocal log_buffer
        if log_buffer and primary:
            with open(log_file, "a") as f:
                f.writelines(log_buffer)
        log_buffer = []

    # graceful preemption: SIGTERM only sets a flag; the loop saves at its
    # next safe point (between steps, where the in-place update is done)
    # and exits 143, so ``--load_path <latest>`` resumes
    stop_requested = False

    def _sigterm(_sig, _frm):
        nonlocal stop_requested
        stop_requested = True

    previous = None
    try:
        previous = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # not the main thread: no hook

    def _preempt_exit(epoch_to_save: int, already_saved: bool = False):
        if not already_saved:
            # resume re-runs the interrupted epoch: drop a half-filled
            # accumulation cycle (step.reset_accumulation)
            save_ckpt(ckpt_weight, snap_state(reset_accumulation(state)),
                      epoch=epoch_to_save,
                      extras={"loss_list_total": loss_history,
                              "best_val_loss": best_val_loss})
        raise SystemExit(143)

    try:
        for ep in range(start_epoch, opts.epoch):
            if ep == cfg.lr_drop_epoch:  # train.py:251-262
                set_learning_rate(state, cfg.lr_after_drop)
                save_ckpt(os.path.join(opts.ckpt_dir,
                                       f"svs_{opts.label}_400.ckpt"),
                          snap_state(state), epoch=ep + 1)
                say(f"\n[Info] Epoch {ep}: learning rate set to "
                    f"{cfg.lr_after_drop}\n")

            t0 = time.time()
            losses: List[torch.Tensor] = []
            epoch_seed = multihost.epoch_seed(
                opts.seed, ep, mesh.host if per_host else 0)
            n_steps = train_steps or train_ds.steps_per_epoch(local_bs)
            if augmenter is not None:
                # one generator per epoch, from the epoch seed: a resumed
                # epoch redraws the same augmentations
                augmenter.for_epoch(epoch_seed)
            n_items = len(train_ds)
            every = max(1, n_steps // 10)
            if epoch_fn is not None:
                # the full batches as graph replays, the ragged tail through
                # the train step: the index stream and generator order of
                # the per-step loop below
                state, loss_vec = run_epoch(epoch_fn, train_step, state,
                                            train_ds, opts.batch_size,
                                            epoch_seed, gen, augmenter,
                                            mesh=mesh)
                losses.append(loss_vec)
                if opts.progress:
                    print(f"Epoch {ep + 1}/{opts.epoch} [Train] "
                          f"{n_steps}/{n_steps}", flush=True)
                # a stop request is served at the epoch's end, below
            else:
                for i, batch in enumerate(train_ds.batches(
                        local_bs, shuffle=True, seed=epoch_seed,
                        n_steps=train_steps)):
                    # the real rows from the schedule: a host's batches
                    # are all full (train_steps wraps its songs around)
                    b = _local(batch, local_bs if train_steps else min(
                        local_bs, n_items - i * local_bs))
                    state, aux = train_step(state, b, gen)
                    losses.append(aux["total"])  # stays on the device
                    if opts.progress and primary and (
                            (i + 1) % every == 0 or i + 1 == n_steps):
                        print(f"Epoch {ep + 1}/{opts.epoch} [Train] "
                              f"{i + 1}/{n_steps}", flush=True)
                    # across hosts at every 8th step, as svs_tpu polls
                    if (not multi or i % 8 == 7) and mesh_lib.agree(
                            stop_requested, mesh):
                        # mid-epoch: epoch=ep, so resume re-runs this epoch
                        _preempt_exit(ep)

            # one fetch for the epoch's losses
            values = (torch.cat([x.reshape(-1) for x in losses]).cpu()
                      .tolist() if losses else [])
            avg_train_loss = (float(np.mean(values)) if values
                              else float("nan"))
            log_buffer.append(f"{avg_train_loss}\n")
            loss_history.append(avg_train_loss)
            epoch_secs = time.time() - t0
            _record({"epoch": ep + 1, "train_loss": avg_train_loss,
                     "lr": get_learning_rate(state),
                     "steps": len(values), "secs": round(epoch_secs, 3)})

            if valid_ds is not None and (ep + 1) % opts.val_interval == 0:
                # fixed crop seed: the same validation patches every pass
                # (svs_tpu's choice; the reference re-rolls them); each
                # layout's eval step takes its own state (FSDP's gathers
                # inside it, TP's runs on the channel slices)
                val_losses = [
                    eval_step(state, _val_local(batch))["total"]
                    for batch in valid_ds.batches(
                        opts.batch_size, shuffle=False, seed=opts.seed)]
                avg_val_loss = float(np.mean(
                    torch.stack(val_losses).cpu().tolist()))
                if multi:
                    # the hosts' best-checkpoint decisions must not part
                    multihost.assert_scalar_agreement(
                        avg_val_loss, "avg_val_loss", mesh=mesh)
                log_buffer.append(f"Val {avg_val_loss}\n")
                say(f"\n[Epoch {ep + 1}] Train Loss: {avg_train_loss:.4e} "
                    f"| Val Loss: {avg_val_loss:.4e}")
                if avg_val_loss < best_val_loss:
                    best_val_loss = avg_val_loss
                    snap = snap_state(state)
                    save_ckpt(best_weight, snap, epoch=ep + 1,
                              extras={"best_val_loss": best_val_loss,
                                      "loss_list_total": loss_history})
                    if opts.export_pth:
                        export_ckpt(best_weight[:-5] + ".pth", snap,
                                    epoch=ep + 1)
                val_record = {"epoch": ep + 1, "val_loss": avg_val_loss}
                sdr = None
                if opts.val_sdr:
                    # after the best-checkpoint decision, so the scoring
                    # never moves the loss-based contract; a song that
                    # fails is skipped inside validation_sdr
                    from svs_torch.evaluation.val_sdr import validation_sdr
                    with zero.gathered(state) as model:
                        if is_pp:  # the whole model on stage 0's device
                            model = pp.gather_state(state).model
                        if primary:
                            sdr = validation_sdr(
                                model, opts.valid_folder, cfg,
                                max_songs=opts.val_sdr_songs, device=dev)
                if sdr is not None:
                    for k in ("SDR", "SIR", "SAR", "NSDR"):
                        val_record[f"vocal_{k.lower()}"] = sdr[k]
                    val_record["sdr_songs"] = len(sdr["per_song"])
                    if sdr["SDR"] is not None:
                        print(f"[Epoch {ep + 1}] Val vocal SDR "
                              f"{sdr['SDR']:.3f} dB | NSDR "
                              f"{sdr['NSDR']:.3f} dB "
                              f"({len(sdr['per_song'])} songs)")
                _record(val_record)
                _flush_log()
            else:
                say(f"Epoch {ep + 1} Avg Loss: {avg_train_loss:.4e}")

            saved_latest = ((ep + 1) % opts.save_every == 0
                            or ep + 1 == opts.epoch)
            if saved_latest:
                snap = snap_state(state)
                save_ckpt(ckpt_weight, snap, epoch=ep + 1,
                          extras={"loss_list_total": loss_history,
                                  "best_val_loss": best_val_loss})
                if opts.export_pth:
                    export_ckpt(ckpt_weight[:-5] + ".pth", snap,
                                epoch=ep + 1)
            if mesh_lib.agree(stop_requested, mesh):
                # epoch complete: no second write of the same latest ckpt
                _preempt_exit(ep + 1, already_saved=saved_latest)

        say("Finish training!")
        return state
    finally:
        # drain the checkpoint writes and flush the text log on every exit
        # path (normal, preemption, loader or step errors)
        try:
            if saver:
                saver.close()
            _flush_log()
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
