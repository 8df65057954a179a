"""Device-resident training data: the whole spectrogram dataset on the card
(port of ``svs_tpu/data/device_data.py``, single device).

The host pipeline (``dataset.py``) ships 4 x (B, 512, L) float32 planes per
step, ~34 MB at B = 32, over the host-to-device link.  Here the whole
dataset is put on the device ONCE (songs zero-padded into one
``(n_songs, F, T_max)`` box per plane) and each step's random crops are
gathered there: the per-step host-to-device traffic drops to two ``(B,)``
index vectors.

- one gather per plane: advanced indexing with (B, 1, 1) song, (1, F, 1)
  row and (B, 1, L) column indices, so crop offsets are data, not shapes
- reference semantics unchanged: the same virtual epoch (n_songs x
  samples_per_song, reference train.py:83-84) and the same shared random
  128-frame crop (train.py:119-126).  The (song, start) stream comes from
  ``PatchDataset.index_batches``, the SAME numpy RNG sequence the host
  pipeline uses, so device and host pipelines yield bitwise-equal batches
  (tests/test_torch_device_data.py)
- songs shorter than ``input_len`` are zero-padded at load with start 0,
  reproducing the reference's pad branch (train.py:127-135)

Memory: 4 float32 planes of (S, F, T_max).  MUSDB18-scale (100 songs x
~2560 frames x 512 bins) is ~2.1 GB; ``resident_bytes`` lets callers gate on
a cap first.

With a mesh (``mesh=``, one process per device: a data mesh, or under TP
a 2-D ``(data, model)`` mesh), each rank keeps the planes on its own
device and gathers the global batch's crops, the same on every rank; the
training loop remixes that global batch (the partners cross it, as
svs_tpu's do) and then keeps this rank's rows, or under TP its data row's
(``parallel.mesh.shard_batch`` over the data axis; svs_tpu loop.py:
228-234).  A DP or TP epoch so consumes exactly the single-device
epoch's batches.

``time_sharded`` (with a data mesh) is context parallelism's layout
(``parallel.halo.shard_batch_time``): each rank gathers only its time
block of every crop, all the batch's rows, with an all-ones ``weight``.
The remix is row-local and elementwise in time, so the loop may remix the
blocks: the block of the remixed batch.

:class:`MultiHostDeviceDataset` is the multi-host form (a mesh of more than
one host): each rank holds its host's song shard on its own device (as
svs_tpu holds it on each of a host's devices: the same bytes a device),
walks the host's index stream and gathers only its own block of the
host's padded batch, which is ``parallel.multihost.global_batch_from_local``
of the host pipeline's batch, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from svs_torch.data.dataset import PLANE_KEYS, PatchDataset
from svs_torch.parallel import halo
from svs_torch.utils import profiling
from svs_torch.utils.device import DeviceLike, resolve_device

_KEYS = PLANE_KEYS


def resident_bytes(ds: PatchDataset) -> int:
    """Device footprint of ``DeviceDataset(ds)`` WITHOUT loading anything:
    4 float32 planes of (n_songs, F, max(T_max, input_len)); song shapes
    come from .npy headers only (mmap)."""
    lens = [ds.song_length(i) for i in range(ds.n_songs)]
    t_max = max(max(lens), ds.input_len)
    rows = int(ds._song_arrays(ds.file_names[0])[0].shape[0])
    f = rows - (1 if ds.drop_dc else 0)
    return 4 * ds.n_songs * f * t_max * 4


def gather_crops(planes: Dict[str, torch.Tensor], songs: torch.Tensor,
                 starts: torch.Tensor, input_len: int
                 ) -> Dict[str, torch.Tensor]:
    """(B,) song indices + (B,) crop offsets (int64, on the planes' device)
    -> dict of (B, F, L) crops, gathered on the device with no host
    traffic."""
    first = next(iter(planes.values()))
    dev = first.device
    rows = torch.arange(first.shape[1], device=dev)[None, :, None]
    cols = (starts[:, None] + torch.arange(input_len, device=dev))[:, None, :]
    idx = songs[:, None, None]
    return {k: p[idx, rows, cols] for k, p in planes.items()}


class DeviceDataset:
    """Device-resident mirror of a :class:`PatchDataset`.

    Same ``batches`` signature and semantics as the host dataset; yields
    dicts of (B, F, L) float32 tensors on ``device`` (``cuda`` unless the
    caller asks for the CPU) instead of numpy.  For training where the
    host-to-device link bounds the epoch.

    ``mesh``: a data mesh or a 2-D mesh, whose device then holds the
    planes; the batches are the global batch's, the same on every rank.
    ``time_sharded`` (with a data mesh): each batch is this rank's time
    block of the global batch, with the replicated all-ones ``weight``
    (``halo.shard_batch_time``'s layout, svs_tpu device_data.py:106-136);
    ``input_len`` must be a multiple of ``64 * size``.
    """

    def __init__(self, host: PatchDataset, mesh=None, *,
                 device: DeviceLike = None, time_sharded: bool = False):
        self.host = host
        self.mesh = mesh
        self.time_sharded = bool(time_sharded)
        # refused before the planes are packed
        if time_sharded:
            if mesh is None:
                raise ValueError("time_sharded requires a mesh")
            halo.check_time(host.input_len, mesh,
                            "time_sharded: input_len")
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self.planes = {k: torch.from_numpy(v).to(self.device)
                       for k, v in _pack_planes(host).items()}
        self.nbytes = sum(v.numel() * v.element_size()
                          for v in self.planes.values())

    # -- PatchDataset surface used by the training loop -------------------
    def __len__(self) -> int:
        return len(self.host)

    @property
    def n_songs(self) -> int:
        return self.host.n_songs

    @property
    def input_len(self) -> int:
        return self.host.input_len

    def steps_per_epoch(self, batch_size: int,
                        drop_last: bool = False) -> int:
        return self.host.steps_per_epoch(batch_size, drop_last)

    def gather(self, songs: np.ndarray, starts: np.ndarray
               ) -> Dict[str, torch.Tensor]:
        """One batch at explicit (song, start) indices.  The index copies
        are from pageable memory, so the host waits there for the card
        (the span ``svs.train.feed.wait``)."""
        def index(a):
            with profiling.annotate("svs.train.feed.wait", always=True):
                return torch.as_tensor(np.asarray(a, np.int64)).to(
                    self.device)
        if not self.time_sharded:
            return gather_crops(self.planes, index(songs), index(starts),
                                self.input_len)
        # this rank's columns of each crop: the same gather, offset
        per = self.input_len // self.mesh.size
        out = gather_crops(self.planes, index(songs),
                           index(np.asarray(starts, np.int64)
                                 + self.mesh.rank * per), per)
        out["weight"] = torch.ones(len(songs), device=self.device)
        return out

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: Optional[int] = None,
        drop_last: bool = False,
        prefetch: int = 2,  # unused: the gather is enqueued, not waited on
        n_steps: Optional[int] = None,
    ) -> Iterator[Dict[str, torch.Tensor]]:
        """The epoch's batches; each draw of the host's indices, with its
        gather, is the span ``svs.train.feed`` (the epoch's last draw,
        which finds none, too), closed before the batch is yielded."""
        n_songs = self.host.n_songs
        stream = self.host.index_batches(
            batch_size, shuffle=shuffle, seed=seed, drop_last=drop_last,
            n_steps=n_steps)
        while True:
            with profiling.annotate("svs.train.feed", always=True):
                drawn = next(stream, None)
                if drawn is None:
                    return
                batch = self.gather(np.asarray(drawn[0]) % n_songs,
                                    drawn[1])
            yield batch


class MultiHostDeviceDataset(DeviceDataset):
    """Device-resident training data of a multi-host DP job (svs_tpu
    device_data.py:263-369).

    ``host``: this host's :class:`PatchDataset` (its songs already
    ``multihost.process_shard``-ed), packed onto this rank's device;
    ``mesh``: the data mesh of more than one host; ``pad_to``: the rows
    every host pads its batch to (a multiple of ``local_quota``).
    ``batches`` walks the host's index stream; each batch is this rank's
    ``q = pad_to / local_quota`` rows of the host's batch padded with zero
    rows: the real rows gathered on the device, the pad rows zeros, with
    the 0/1 ``weight``.  Per step the host moves two (q,) index vectors to
    the device; no collective touches the data."""

    def __init__(self, host: PatchDataset, mesh, pad_to: int):
        from svs_torch.parallel import multihost

        lq = multihost.local_quota(mesh)
        if pad_to % lq:
            raise ValueError(f"pad_to={pad_to} not a multiple of this "
                             f"host's data-axis quota {lq}")
        super().__init__(host, multihost.data_mesh(mesh))
        self.pad_to = int(pad_to)
        self.quota = self.pad_to // lq
        # every rank holds its host's whole shard
        self.nbytes_per_device = self.nbytes

    def gather(self, songs: np.ndarray, starts: np.ndarray
               ) -> Dict[str, torch.Tensor]:
        """This rank's rows of the host batch at explicit (song, start)
        indices (its real rows, then zero rows to ``quota``), with the
        0/1 ``weight``."""
        if len(songs) > self.pad_to:
            raise ValueError(f"local batch {len(songs)} > pad_to "
                             f"{self.pad_to}")
        q, lo = self.quota, self.mesh.local_rank * self.quota
        idx = np.asarray(songs, np.int64)[lo:lo + q]
        n = len(idx)
        out = gather_crops(
            self.planes, torch.from_numpy(idx).to(self.device),
            torch.from_numpy(np.asarray(starts, np.int64)[lo:lo + q]).to(
                self.device), self.input_len)
        if n < q:
            out = {k: torch.cat([v, v.new_zeros((q - n,) + v.shape[1:])])
                   for k, v in out.items()}
        weight = torch.zeros(q, device=self.device)
        weight[:n] = 1.0
        out["weight"] = weight
        return out


def _pack_planes(host: PatchDataset) -> Dict[str, np.ndarray]:
    """The (S, F, T_max) float32 plane boxes: magnitudes straight from the
    mmaps, angles from the host's once-per-song cache (the single shared
    angle computation — see ``PatchDataset._song_angles``), short songs
    zero-padded."""
    lo = 1 if host.drop_dc else 0
    lens = [host.song_length(i) for i in range(host.n_songs)]
    t_max = max(max(lens), host.input_len)
    rows = int(host._song_arrays(host.file_names[0])[0].shape[0])
    planes = {k: np.zeros((host.n_songs, rows - lo, t_max), np.float32)
              for k in _KEYS}
    for s, name in enumerate(host.file_names):
        mix_m, voc_m, _, _ = host._song_arrays(name)
        t = mix_m.shape[1]
        planes["mix"][s, :, :t] = mix_m[lo:]
        planes["voc"][s, :, :t] = voc_m[lo:]
        mix_a, voc_a = host._song_angles(name)
        planes["mix_angle"][s, :, :t] = mix_a
        planes["voc_angle"][s, :, :t] = voc_a
    # release the host-side per-song angle cache (~10 MB/song): the
    # resident planes now hold those values, and any later host-pipeline
    # use just recomputes identical entries (np.angle is deterministic)
    host._angles.clear()
    return planes


def epoch_index_arrays(ds: PatchDataset, batch_size: int, *,
                       shuffle: bool = True, seed=None,
                       drop_last: bool = False, n_steps=None):
    """The epoch's index stream as stacked ``(n_full, B)`` int32 arrays of
    (song, start) pairs, plus the ragged tail batch (or None): the input
    layout of a whole-epoch program.  Same single RNG sequence as every
    other backend (``index_batches``)."""
    n_songs = ds.n_songs
    songs_l, starts_l, tail = [], [], None
    for idxs, starts in ds.index_batches(batch_size, shuffle=shuffle,
                                         seed=seed, drop_last=drop_last,
                                         n_steps=n_steps):
        if len(idxs) == batch_size:
            songs_l.append(np.asarray(idxs, np.int32) % n_songs)
            starts_l.append(starts.astype(np.int32))
        else:  # only ever the final remainder batch
            tail = (np.asarray(idxs, np.int32) % n_songs,
                    starts.astype(np.int32))
    songs = (np.stack(songs_l) if songs_l
             else np.zeros((0, batch_size), np.int32))
    starts = (np.stack(starts_l) if starts_l
              else np.zeros((0, batch_size), np.int32))
    return songs, starts, tail


def maybe_device_dataset(ds: Optional[PatchDataset], mode: str,
                         cap_mb: float, mesh=None, *,
                         device: DeviceLike = None,
                         time_sharded: bool = False) -> Optional[object]:
    """Gate for the training loop: returns a DeviceDataset when ``mode`` is
    "on", or "auto" and the resident footprint fits ``cap_mb``; otherwise
    the host dataset unchanged ("off" -> host dataset).  ``time_sharded``:
    :class:`DeviceDataset`'s."""
    if ds is None or mode == "off":
        return ds
    if mode not in ("on", "auto"):
        raise ValueError(f"device_data must be on/off/auto, got {mode!r}")
    if mode == "auto" and resident_bytes(ds) > cap_mb * 2**20:
        return ds
    return DeviceDataset(ds, mesh=mesh, device=device,
                         time_sharded=time_sharded)
