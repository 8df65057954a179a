"""The training loop (port of ``svs_tpu/train/loop.py``, one device).

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

The step is svs_torch's eager step (:mod:`svs_torch.train.step`), which
updates the state in place; the epoch's losses stay on the device until
the epoch ends and are fetched once, so no step waits on the card.
Dropout draws from one ``torch.Generator`` on the training device, seeded
from ``seed + 1`` (svs_tpu's ``jax.random.key(seed + 1)``; the two streams
differ).  The MR-STFT loss's magnitudes follow ``cfg.mr_mag_impl``: the
CUDA kernels ``pallas_fused`` / ``pallas_fused_wide`` (loss_partials) and
``pallas_bf16`` (spectral_mag) run here when ``fit`` is given such a
config; the default stays ``matmul_bf16``.

``epoch_scan`` runs each epoch's full batches as replays of one captured
CUDA graph of the step (:mod:`svs_torch.train.scan`; eager on the CPU),
then the ragged tail through the eager step; it needs the dataset on the
device.  ``val_sdr`` scores the validation songs' separated vocals with
BSS eval after each validation (:mod:`svs_torch.evaluation.val_sdr`).

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
into any layout; validation under FSDP runs on the gathered parameters.
``epoch_scan`` is refused with either, as svs_tpu refuses it.

Not ported yet, and refused with ``NotImplementedError`` naming its
ROADMAP item: TP (A.10.4), PP (A.10.5), CP (A.10.6), the ``device_put``
hook and multi-host runs (A.10.7), and ``epoch_scan`` over a DP mesh
(A.10.2).
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
from svs_torch.parallel import zero
from svs_torch.train import checkpoint as ckpt_lib
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
    device_put: Optional[Callable] = None  # sharding hook: ROADMAP A.10.7
    # keep the spectrogram dataset on the device and gather crops there
    # (data/device_data.py): "auto" when it fits device_data_cap_mb
    device_data: str = "auto"  # "auto" | "on" | "off"
    device_data_cap_mb: float = 2048.0
    epoch_scan: bool = False   # the epoch as replays of a CUDA graph
    # a parallel.mesh.Mesh: data-parallel training over its ranks
    mesh: Optional[object] = None
    parallel: str = "dp"       # "cp" / "tp" / "pp": ROADMAP A.10.6 / 4 / 5
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


# svs_tpu's refusal of epoch_scan off a single process or plain-DP mesh
SCAN_REFUSAL = ("epoch_scan requires the device-resident dataset on a "
                "single-process run, mesh-free or plain-DP mesh "
                "(device_data='on'/'auto' with the dataset under the HBM "
                "cap; not cp/tp/zero1/fsdp)")


def _refuse_unported(opts: TrainOptions) -> None:
    def no(what: str, item: str) -> None:
        raise NotImplementedError(f"{what} is not ported to svs_torch yet "
                                  f"(ROADMAP {item})")

    items = {"tp": "A.10.4", "pp": "A.10.5", "cp": "A.10.6"}
    if opts.parallel in items:
        no(f"parallel={opts.parallel!r}", items[opts.parallel])
    if opts.parallel != "dp":
        raise ValueError(f"unknown parallel layout {opts.parallel!r}")
    if opts.device_put is not None:
        no("a device_put sharding hook", "A.10.7")
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
    if opts.epoch_scan:
        if opts.zero1 or opts.fsdp:
            raise ValueError(SCAN_REFUSAL)
        no("epoch_scan over a mesh", "A.10.2")
    if (opts.device is not None
            and torch.device(opts.device).type != opts.mesh.device.type):
        raise ValueError(f"device {opts.device!r} is not the mesh's "
                         f"{opts.mesh.device}")


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
    mesh = opts.mesh
    # rank 0 alone writes files and prints (svs_tpu's is_primary)
    primary = mesh is None or mesh.is_primary
    say = print if primary else (lambda *a, **k: None)
    dev = mesh.device if mesh is not None else resolve_device(opts.device)
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
    if opts.device_data != "off":
        train_ds = dd.maybe_device_dataset(train_ds, opts.device_data,
                                           opts.device_data_cap_mb,
                                           mesh=mesh, device=dev)
        valid_ds = dd.maybe_device_dataset(valid_ds, opts.device_data,
                                           opts.device_data_cap_mb,
                                           mesh=mesh, device=dev)
        if isinstance(train_ds, dd.DeviceDataset):
            say(f"[svs-torch] device-resident dataset: "
                f"{train_ds.nbytes / 2**20:.0f} MiB on {dev}")

    epoch_fn = None
    if opts.epoch_scan:
        if not isinstance(train_ds, dd.DeviceDataset):
            raise ValueError(SCAN_REFUSAL)
        from svs_torch.train.scan import make_epoch_scan, run_epoch
        epoch_fn = make_epoch_scan(cfg, augment=opts.augment)

    # a CUDA graph replays Adam only in its capturable form; the eager
    # loop keeps torch's host form
    optimizer = make_optimizer(cfg, accum_steps=opts.accum_steps,
                               capturable=opts.epoch_scan)
    state = create_train_state(opts.seed, cfg, optimizer, device=dev)
    sharded = opts.zero1 or opts.fsdp  # on a mesh (_refuse_unported)
    if mesh is None:
        train_step = make_train_step(cfg)
        eval_step = make_eval_step(cfg)
    elif sharded:
        train_step = zero.make_zero1_train_step(mesh, cfg, fsdp=opts.fsdp)
        eval_step = dp.make_dp_eval_step(mesh, cfg)
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
    if mesh is not None:
        dp.replicate_state(state, mesh)
    if sharded:
        state = zero.shard_state(state, mesh, fsdp=opts.fsdp)

    augmenter = None
    if opts.augment:
        from svs_torch.data.augment import Augmenter
        augmenter = Augmenter(opts.remix_p, opts.aug_gain_lo,
                              opts.aug_gain_hi)

    def _local(batch, n_real: int):
        """A host or device batch as this rank's step input: remixed
        whole, then (with a mesh) cut to this rank's rows."""
        if augmenter is not None:
            batch = augmenter(_on_device(batch, dev), n_real=n_real)
        if mesh is None:
            return _on_device(batch, dev)
        return mesh_lib.shard_batch(mesh, batch)

    def _val_local(batch):
        """A validation batch as this rank's eval input (with a mesh, a
        remainder batch padded to the full batch's rows)."""
        if mesh is None:
            return _on_device(batch, dev)
        return mesh_lib.global_batch_from_global(mesh, batch,
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
    snap_state = zero.unshard_state if sharded else (lambda s: s)

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
            epoch_seed = opts.seed * 100003 + ep
            n_steps = train_ds.steps_per_epoch(opts.batch_size)
            if augmenter is not None:
                # one generator per epoch, from the epoch seed: a resumed
                # epoch redraws the same augmentations
                augmenter.for_epoch(epoch_seed)
            n_items = len(train_ds)
            every = max(1, n_steps // 10)
            if epoch_fn is not None:
                # the full batches as graph replays, the ragged tail through
                # the eager step: the index stream and generator order of
                # the per-step loop below
                state, loss_vec = run_epoch(epoch_fn, train_step, state,
                                            train_ds, opts.batch_size,
                                            epoch_seed, gen, augmenter)
                losses.append(loss_vec)
                if opts.progress:
                    print(f"Epoch {ep + 1}/{opts.epoch} [Train] "
                          f"{n_steps}/{n_steps}", flush=True)
                # a stop request is served at the epoch's end, below
            else:
                for i, batch in enumerate(train_ds.batches(
                        opts.batch_size, shuffle=True, seed=epoch_seed)):
                    b = _local(batch, min(opts.batch_size,
                                          n_items - i * opts.batch_size))
                    state, aux = train_step(state, b, gen)
                    losses.append(aux["total"])  # stays on the device
                    if opts.progress and primary and (
                            (i + 1) % every == 0 or i + 1 == n_steps):
                        print(f"Epoch {ep + 1}/{opts.epoch} [Train] "
                              f"{i + 1}/{n_steps}", flush=True)
                    if mesh_lib.agree(stop_requested, mesh):
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
                # (svs_tpu's choice; the reference re-rolls them)
                with zero.gathered(state):
                    val_losses = [
                        eval_step(state, _val_local(batch))["total"]
                        for batch in valid_ds.batches(
                            opts.batch_size, shuffle=False, seed=opts.seed)]
                avg_val_loss = float(np.mean(
                    torch.stack(val_losses).cpu().tolist()))
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
                    with zero.gathered(state):
                        if primary:
                            sdr = validation_sdr(
                                state.model, opts.valid_folder, cfg,
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
