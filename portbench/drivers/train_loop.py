"""Training traffic: ``fit``'s per-step path on a seeded on-disk dataset.

Set-up writes the configuration's ``train_songs`` seeded songs of
``train_song_seconds`` (its dataset, cut from MUSDB18's 100 training songs)
as the program's ``.npy`` spectrogram pairs under the run's temporary
directory, loads them through ``PatchDataset`` and ``maybe_device_dataset(..., "auto")`` (as
``fit`` does; the cell is refused if the data is not resident), builds the
train state with the seeded weights, ``make_train_step(cfg)`` and the
dropout generator, and runs the first ``ref_steps`` steps of epoch 0
through the same calls as the window.  Those steps are what ``correct``
holds to the reference; the window goes on from step ``ref_steps + 1``.
The program runs its first step eagerly and captures and replays from the
second on, so the second step's gradient is the first that the window's
replayed program computes; ``correct`` compares it as well as the first.

The window steps batches of ``batch`` patches from ``DeviceDataset.batches``
epoch after epoch (each epoch its own crop seed, as ``fit``'s), until the
host clock passes the window's seconds, then synchronises the card.
"""

from __future__ import annotations

import gc
import itertools
import os
import statistics
import time
from typing import Dict

import numpy as np
import torch

from portbench import compare, flops, songs, weights
from portbench.reference import dsp, precision, train as ref_train, unet
from portbench.trace import span, sync

PARAMS = {"batch": int, "ref_steps": int}
CONFIG_KEYS = ("train_songs", "train_song_seconds")
LIMITS = ("loss_gap", "grad_gap_median", "replay_grad_gap_median",
          "change_gap")
CAP_MB = 2048.0  # fit's default device_data_cap_mb


def index_stream(n_songs: int, samples_per_song: int, frames: int,
                 length: int, batch: int, seed: int):
    """The reference's sampler (train.py:65-143 over a virtual epoch of
    ``n_songs * samples_per_song`` items): a seeded shuffle of the items,
    then one uniform crop start a croppable item, in batch order; yields
    (songs, starts) a batch."""
    rng = np.random.default_rng(seed)
    n = n_songs * samples_per_song
    order = np.arange(n)
    rng.shuffle(order)
    for lo in range(0, n, batch):
        idx = order[lo:lo + batch]
        starts = [int(rng.integers(0, frames - length, endpoint=True))
                  if frames > length else 0 for _ in idx]
        yield idx % n_songs, starts


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.cell.params
        self.cfg = ctx.svs

    def epoch_seed(self, ep: int) -> int:
        return self.ctx.derive("epoch", ep)

    def _batches(self):
        ep = 0
        while True:
            yield from self.data.batches(self.p["batch"], shuffle=True,
                                         seed=self.epoch_seed(ep))
            ep += 1

    def setup(self) -> None:
        from svs_torch.data import device_data as dd
        from svs_torch.data.dataset import PatchDataset
        from svs_torch.train.step import create_train_state, make_train_step

        ctx, cfg, dev = self.ctx, self.cfg, self.ctx.device
        n = int(round(cfg.sample_rate * ctx.config["train_song_seconds"]))
        seeds = [ctx.derive("song", i)
                 for i in range(ctx.config["train_songs"])]
        self.folder = os.path.join(ctx.tmpdir, "dataset")
        with span("setup.dataset"):
            songs.write_dataset(self.folder, seeds, n, ctx.config, dev)
            host = PatchDataset(self.folder,
                                samples_per_song=cfg.samples_per_song,
                                input_len=cfg.input_len)
            self.data = dd.maybe_device_dataset(host, "auto", CAP_MB,
                                                device=dev)
            if not isinstance(self.data, dd.DeviceDataset):
                raise RuntimeError("the dataset is not resident on the "
                                   "device: fit would feed it from the host")
            self.frames = host.song_length(0)
        self.params0 = weights.make(ctx.derive("weights"), cfg.enc_channels,
                                    dev)
        self.state = create_train_state(0, cfg, device=dev)
        weights.load_into(self.state.model, self.params0)
        self.step = make_train_step(cfg)
        self.gen = torch.Generator(dev).manual_seed(ctx.derive("dropout"))
        self.feed = self._batches()
        losses, moments = [], [self._moments(zero=True)]
        for k in range(self.p["ref_steps"]):
            self.state, aux = self.step(self.state, next(self.feed),
                                        self.gen)
            losses.append(aux["total"])
            if k < 2:
                moments.append(self._moments())
        beta1 = ref_train.BETAS[0]
        names = list(moments[0])
        params = dict(self.state.model.named_parameters())
        self.first = {
            "loss": [float(x) for x in losses],
            # each of the first two steps' gradient as Adam got it, from its
            # first moment: exp_avg_k = beta1 exp_avg_(k-1) + (1 - beta1) g_k
            "grad": [{n: (m[n] - beta1 * prev[n]) / (1 - beta1)
                      for n in names}
                     for prev, m in zip(moments, moments[1:])],
            "change": {n: (params[n].detach() - self.params0[n]).cpu()
                       for n in names},
        }
        self.params0 = {k: v.cpu() for k, v in self.params0.items()}
        self.patch_flops = flops.for_config(ctx.config)["train"]

    def _moments(self, zero: bool = False) -> Dict[str, torch.Tensor]:
        """A copy on the host of Adam's first moment of each parameter;
        zeros before the first step and for a parameter Adam holds no
        state of."""
        state = self.state.optimizer.state
        return {n: state[p]["exp_avg"].detach().to("cpu", torch.float64,
                                                    copy=True)
                if not zero and "exp_avg" in state.get(p, {}) else
                torch.zeros(p.shape, dtype=torch.float64)
                for n, p in self.state.model.named_parameters()}

    def window(self, seconds: float) -> Dict:
        batch = self.p["batch"]
        steps = 0
        t0 = time.perf_counter()
        while True:
            with span("step"):
                self.state, _ = self.step(self.state, next(self.feed),
                                          self.gen)
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        with span("sync"):
            sync(self.ctx.device)
        secs = time.perf_counter() - t0
        return {"seconds": secs, "attempted": steps, "failed": 0,
                "patches": steps * batch,
                "train_flops_per_patch": self.patch_flops,
                "e2e": {"train_patches_per_s": steps * batch / secs}}

    def release(self) -> None:
        from svs_torch.train import graphs
        self.state = self.step = self.data = self.feed = None
        graphs.CACHE.clear()
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        pass

    # ----------------------------------------------------------- correct

    def reference_steps(self, conv=unet.conv_f32, mag=dsp.spectral_mag,
                        rows: int = None, from_step: int = 0) -> Dict:
        """The reference's first ``ref_steps`` steps from the same weights,
        data files, crop seed and dropout seed.  ``conv`` and ``mag``: the
        control's lower precision in the reference's place; ``rows``: the
        first rows of each batch alone from step ``from_step`` on (a
        fault's reading)."""
        ctx, dev, cfg = self.ctx, self.ctx.device, self.ctx.config
        names = songs.dataset_names(self.folder)
        stream = (b for ep in itertools.count() for b in index_stream(
            len(names), cfg["samples_per_song"], self.frames,
            cfg["input_len"], self.p["batch"], self.epoch_seed(ep)))
        gen = torch.Generator(dev).manual_seed(ctx.derive("dropout"))
        params = {k: v.to(dev) for k, v in self.params0.items()}
        trainable = ref_train.trainable(params)
        opt = ref_train.Adam(params, trainable, cfg["learning_rate"])
        losses, grad = [], []
        with precision.exact():
            for k in range(self.p["ref_steps"]):
                idx, starts = next(stream)
                crops = [songs.crop(self.folder, names[i], s,
                                    cfg["input_len"])
                         for i, s in zip(idx, starts)]
                kept = crops[:rows] if k >= from_step else crops
                batch = {key: torch.from_numpy(np.stack(
                    [c[key] for c in kept])).to(dev) for key in crops[0]}
                keeps = unet.dropout_keeps(len(batch["mix"]),
                                           cfg["enc_channels"], gen, dev)
                loss, grads = ref_train.step(params, opt, batch, keeps, cfg,
                                             conv, mag)
                losses.append(loss)
                if k < 2:
                    grad.append({n: g.cpu() for n, g in grads.items()})
        return {"loss": losses, "grad": grad,
                "change": {n: (params[n] - self.params0[n].to(dev)).cpu()
                           for n in trainable}}

    def readings(self, got: Dict, ref: Dict) -> Dict[str, float]:
        """The numbers over the leaves that the reference moves
        (``compare.moving``: a conv bias ahead of a train-mode BatchNorm
        has a gradient of round-off, which bf16 makes large and Adam turns
        into a step of either sign).  A gradient is compared by its median
        leaf: the first step's (``grad_gap_median``, the program's eager
        warm-up) and the second's (``replay_grad_gap_median``, its first
        replay).  The worst leaf (``grad_gap``, kept for the record) is a
        BatchNorm vector's, whose gradient is a sum of 10^5-10^7 terms
        that cancel, so bf16's rounding swings it from seed to seed
        (PERF.md)."""
        live = compare.moving(ref["grad"][0])
        grad = [compare.leaf_gaps(g, r, compare.moving(r))
                for g, r in zip(got["grad"], ref["grad"])]
        return {"loss_gap": compare.loss_gap(got["loss"], ref["loss"]),
                "grad_gap": max(grad[0].values()),
                "grad_gap_median": statistics.median(grad[0].values()),
                "replay_grad_gap_median": statistics.median(
                    grad[1].values()),
                "change_gap": compare.leaf_gap(got["change"], ref["change"],
                                               live)}

    def check(self) -> Dict[str, float]:
        self.ref = self.reference_steps()
        return self.readings(self.first, self.ref)

    def control(self) -> Dict[str, float]:
        """The control's readings: the reference with fp8 convs and fp8
        loss magnitudes in the program's place."""
        return self.readings(self.reference_steps(
            precision.conv_fp8, precision.spectral_mag_fp8), self.ref)

    def faults(self) -> Dict[str, Dict[str, float]]:
        """The readings of the faults a one-card training cell can have,
        planted in the reference: half of each batch left out (the mean
        taken over the rest) in every step, or in the replays alone (from
        the second step on), and a step that leaves the state unchanged
        (no step: the change is 0)."""
        half = self.p["batch"] // 2
        still = dict(self.first, change={k: torch.zeros_like(v) for k, v in
                                         self.first["change"].items()})
        return {"half_batch": self.readings(
                    self.reference_steps(rows=half), self.ref),
                "half_batch_replays": self.readings(
                    self.reference_steps(rows=half, from_step=1), self.ref),
                "unchanged": self.readings(still, self.ref)}

    def worst(self) -> Dict[str, str]:
        """The worst leaf of each leaf number (for the calibration's
        record)."""
        out = {}
        for key, got, ref in (("grad", self.first["grad"][0],
                                self.ref["grad"][0]),
                               ("replay_grad", self.first["grad"][1],
                                self.ref["grad"][1]),
                               ("change", self.first["change"],
                                self.ref["change"])):
            live = compare.moving(self.ref["grad"][0] if key == "change"
                                  else ref)
            gaps = compare.leaf_gaps(got, ref, live)
            out[key] = max(gaps, key=gaps.get)
        return out
