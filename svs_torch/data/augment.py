"""Remix augmentation: random source gains and cross-song vocal remixing
(port of ``svs_tpu/data/augment.py``, one device).

An extension of svs_tpu's; the reference has no augmentation (train.py
builds batches straight from the stored spectrogram crops, train.py:
119-135), and it is off unless ``--augment`` is passed.  Random source
gains and cross-track remixing are the standard music-source-separation
augmentations (Uhlich et al. 2017, sec. 3).

It is exact given only (mix, voc) spectrogram pairs: the STFT is linear, so
the accompaniment's complex spectrogram is ``acc = mix·e^{i·mix_angle} −
voc·e^{i·voc_angle}``, and a remixed example is

    new_voc = g_v · voc[partner]        (partner = another row of the batch)
    new_mix = g_a · acc + new_voc

``|new_voc| = g_v·|voc[partner]|`` exactly (a positive gain commutes with
the magnitude) and the vocal angle is unchanged; only the mixture's
magnitude and angle take a complex round trip.

The randomness is drawn on the host from a numpy generator per epoch
(seeded from the epoch seed, as svs_tpu's), as three (B,) vectors, so the
same seed gives svs_tpu's draws exactly; :func:`apply_remix` is a handful
of elementwise tensor ops and a row gather on the batch's device.  Zero-
weight pad rows keep ``perm`` identity and unit gains, so they stay exactly
zero.  Under a data mesh the loop remixes the global batch before each
rank keeps its rows (``train/loop.py``), so the partners cross the
global batch as svs_tpu's ``out_shardings`` variant's do; the multi-host
``apply_sharded`` waits for ROADMAP A.10.7.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def draw_vectors(rng: np.random.Generator, n_real: int, n_rows: int,
                 remix_p: float, gain_lo: float, gain_hi: float
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One step's ``(perm, g_voc, g_acc)``: each real row's vocal partner
    (a uniform choice among the real rows with probability ``remix_p``,
    else itself), U[gain_lo, gain_hi] gains on the real rows, identity and
    1.0 on the ``n_rows - n_real`` pad rows.  The draw order (integers,
    uniform, uniform, uniform) is svs_tpu's."""
    perm = np.arange(n_rows, dtype=np.int32)
    partners = rng.integers(0, n_real, size=n_real).astype(np.int32)
    take = rng.uniform(size=n_real) < remix_p
    perm[:n_real] = np.where(take, partners, perm[:n_real])
    g_voc = np.ones(n_rows, np.float32)
    g_acc = np.ones(n_rows, np.float32)
    g_voc[:n_real] = rng.uniform(gain_lo, gain_hi,
                                 size=n_real).astype(np.float32)
    g_acc[:n_real] = rng.uniform(gain_lo, gain_hi,
                                 size=n_real).astype(np.float32)
    return perm, g_voc, g_acc


def draw_epoch(rng: np.random.Generator, n_steps: int, n_rows: int,
               remix_p: float, gain_lo: float, gain_hi: float
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``n_steps`` full-batch draws stacked (n_steps, n_rows), consuming
    the generator as ``n_steps`` calls of :func:`draw_vectors` would."""
    if n_steps == 0:
        return (np.zeros((0, n_rows), np.int32),
                np.zeros((0, n_rows), np.float32),
                np.zeros((0, n_rows), np.float32))
    cols = [draw_vectors(rng, n_rows, n_rows, remix_p, gain_lo, gain_hi)
            for _ in range(n_steps)]
    return (np.stack([c[0] for c in cols]),
            np.stack([c[1] for c in cols]),
            np.stack([c[2] for c in cols]))


def apply_remix(batch: Dict[str, torch.Tensor], perm: torch.Tensor,
                g_voc: torch.Tensor, g_acc: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """The row-local remix on the batch's device: batch planes -> batch
    planes.  Pad rows (zero planes, identity, unit gains) stay exactly
    zero; the target planes take no trigonometry."""
    mix, voc = batch["mix"], batch["voc"]
    mr = mix * torch.cos(batch["mix_angle"])
    mi = mix * torch.sin(batch["mix_angle"])
    vr = voc * torch.cos(batch["voc_angle"])
    vi = voc * torch.sin(batch["voc_angle"])
    ar, ai = mr - vr, mi - vi  # accompaniment, exact by STFT linearity
    gv = g_voc[:, None, None]
    ga = g_acc[:, None, None]
    nvr = gv * vr.index_select(0, perm)
    nvi = gv * vi.index_select(0, perm)
    nmr = ga * ar + nvr
    nmi = ga * ai + nvi
    out = {
        "mix": torch.sqrt(nmr * nmr + nmi * nmi),
        "mix_angle": torch.atan2(nmi, nmr),
        "voc": gv * voc.index_select(0, perm),
        "voc_angle": batch["voc_angle"].index_select(0, perm),
    }
    if "weight" in batch:
        out["weight"] = batch["weight"]
    return out


def apply_remix_np(batch: Dict[str, np.ndarray], perm, g_voc, g_acc
                   ) -> Dict[str, np.ndarray]:
    """Independent numpy oracle of :func:`apply_remix` (svs_tpu's,
    copied)."""
    mix_c = batch["mix"] * np.exp(1j * batch["mix_angle"])
    voc_c = batch["voc"] * np.exp(1j * batch["voc_angle"])
    acc_c = mix_c - voc_c
    gv = np.asarray(g_voc)[:, None, None]
    ga = np.asarray(g_acc)[:, None, None]
    nv = gv * voc_c[perm]
    nm = ga * acc_c + nv
    out = {
        "mix": np.abs(nm).astype(np.float32),
        "mix_angle": np.angle(nm).astype(np.float32),
        "voc": (gv * batch["voc"][perm]).astype(np.float32),
        "voc_angle": batch["voc_angle"][perm],
    }
    if "weight" in batch:
        out["weight"] = batch["weight"]
    return out


class Augmenter:
    """What the training loop drives, one instance a run: ``for_epoch``
    arms the epoch's generator, ``__call__`` draws a step's vectors and
    remixes the batch (tensors on the batch's device).  ``host=True``
    applies the numpy oracle to a numpy batch instead (svs_tpu's mode for
    per-host rows before a multi-host assembly)."""

    def __init__(self, remix_p: float = 0.5, gain_lo: float = 0.25,
                 gain_hi: float = 1.25, host: bool = False):
        if not (0.0 <= remix_p <= 1.0):
            raise ValueError(f"remix_p must be in [0, 1], got {remix_p}")
        if not (0.0 < gain_lo <= gain_hi):
            raise ValueError(f"need 0 < gain_lo <= gain_hi, got "
                             f"({gain_lo}, {gain_hi})")
        self.remix_p = float(remix_p)
        self.gain_lo = float(gain_lo)
        self.gain_hi = float(gain_hi)
        self.host = bool(host)
        self._rng: Optional[np.random.Generator] = None

    def for_epoch(self, epoch_seed: int) -> "Augmenter":
        """A fresh generator for one epoch, at svs_tpu's seed (offset from
        the crop sampler's bare ``epoch_seed``)."""
        self._rng = np.random.default_rng(epoch_seed * 1_000_003 + 17)
        return self

    def epoch_vectors(self, n_steps: int, n_rows: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The stacked ``(n_steps, n_rows)`` draws of a whole-epoch run
        (:func:`draw_epoch`): the generator moves as ``n_steps`` full-batch
        calls would move it, so a ragged tail's call afterwards continues
        the same stream."""
        if self._rng is None:
            raise RuntimeError("call for_epoch(seed) first")
        return draw_epoch(self._rng, n_steps, n_rows, self.remix_p,
                          self.gain_lo, self.gain_hi)

    def __call__(self, batch, n_real: Optional[int] = None):
        """``n_real``: the count of non-pad rows, from the loop's own
        schedule (``None``: every row is real)."""
        if self._rng is None:
            raise RuntimeError("call for_epoch(seed) first")
        n_rows = int(batch["mix"].shape[0])
        if n_real is None:
            n_real = n_rows
        if not (0 < n_real <= n_rows):
            raise ValueError(
                f"n_real must be in (0, n_rows={n_rows}], got {n_real}")
        perm, g_voc, g_acc = draw_vectors(
            self._rng, n_real, n_rows, self.remix_p, self.gain_lo,
            self.gain_hi)
        if self.host:
            return apply_remix_np(batch, perm, g_voc, g_acc)
        dev = batch["mix"].device
        return apply_remix(batch, torch.from_numpy(perm).long().to(dev),
                           torch.from_numpy(g_voc).to(dev),
                           torch.from_numpy(g_acc).to(dev))
