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

With a data mesh (``mesh=``, one process per device), each rank keeps the
planes on its own device and gathers the global batch's crops, the same on
every rank; the training loop remixes that global batch (the partners
cross it, as svs_tpu's do) and then keeps this rank's rows
(``parallel.mesh.shard_batch``).  A DP epoch so consumes exactly the
single-device epoch's batches.  svs_tpu's
``time_sharded`` mode (ROADMAP A.10.6) and ``MultiHostDeviceDataset``
(A.10.7) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from svs_torch.data.dataset import PLANE_KEYS, PatchDataset
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

    ``mesh``: a data mesh, whose device then holds the planes; the batches
    are the global batch's, the same on every rank.
    """

    def __init__(self, host: PatchDataset, mesh=None, *,
                 device: DeviceLike = None):
        self.host = host
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
        """One batch at explicit (song, start) indices."""
        def index(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(self.device)
        return gather_crops(self.planes, index(songs), index(starts),
                            self.input_len)

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
        n_songs = self.host.n_songs
        for idxs, starts in self.host.index_batches(
                batch_size, shuffle=shuffle, seed=seed,
                drop_last=drop_last, n_steps=n_steps):
            yield self.gather(np.asarray(idxs) % n_songs, starts)


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
                         device: DeviceLike = None) -> Optional[object]:
    """Gate for the training loop: returns a DeviceDataset when ``mode`` is
    "on", or "auto" and the resident footprint fits ``cap_mb``; otherwise
    the host dataset unchanged ("off" -> host dataset)."""
    if ds is None or mode == "off":
        return ds
    if mode not in ("on", "auto"):
        raise ValueError(f"device_data must be on/off/auto, got {mode!r}")
    if mode == "auto" and resident_bytes(ds) > cap_mb * 2**20:
        return ds
    return DeviceDataset(ds, mesh=mesh, device=device)
