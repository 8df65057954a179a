"""Training patch sampler, numpy backend (port of
``svs_tpu/data/dataset.py``).

The reference ``SpectrogramDataset`` semantics (reference train.py:65-143):
per item, pick song ``idx % n_songs``, load mixture+vocal magnitude and
phase .npy, take ``np.angle(phase)`` as float32, drop the DC bin
(513 -> 512), apply ONE shared random 128-frame time crop to all four
arrays (zero-pad when the song is shorter), yield (mix, voc, mix_angle,
voc_angle).  Host code with no torch in it: this is svs_tpu's numpy backend
copied, so both packages give bitwise-equal batches for one seed.

- spectrograms are opened once as memory-maps; a crop reads only its
  columns
- batches are single contiguous (B, 512, 128) numpy arrays
- prefetching is one background thread and a queue
- the RNG is one seeded generator (:meth:`PatchDataset.index_batches`)

The C++ loader backend (``backend="native"``) is not yet ported;
``"auto"`` means numpy.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


# the batch dict's plane keys, in stacking order
PLANE_KEYS = ("mix", "voc", "mix_angle", "voc_angle")


class PatchDataset:
    def __init__(
        self,
        path: str,
        samples_per_song: int = 64,
        input_len: int = 128,
        drop_dc: bool = True,
        backend: str = "auto",
    ):
        """backend: 'numpy' or 'auto' (numpy); the C++ loader ('native')
        is not yet ported and raises."""
        self.path = path
        self.mixture_path = os.path.join(path, "mixture")
        self.vocal_path = os.path.join(path, "vocal")
        self.samples_per_song = samples_per_song
        self.input_len = input_len
        self.drop_dc = drop_dc

        if backend == "native":
            raise NotImplementedError(
                "PatchDataset backend 'native' (the C++ loader) is not yet "
                "ported; use 'numpy' or 'auto'")
        if backend not in ("numpy", "auto"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = "numpy"

        if not os.path.exists(self.mixture_path):
            raise FileNotFoundError(
                f"mixture folder not found: {self.mixture_path}"
            )
        names = sorted(
            f for f in os.listdir(self.mixture_path) if f.endswith("_spec.npy")
        )
        # keep only songs whose vocal spec exists (train.py:79)
        self.file_names: List[str] = [
            f for f in names
            if os.path.exists(os.path.join(self.vocal_path, f))
        ]
        if not self.file_names:
            raise FileNotFoundError(f"no paired _spec.npy files under {path}")
        self._mmaps: Dict[str, Tuple[np.ndarray, ...]] = {}
        self._angles: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self.file_names) * self.samples_per_song

    @property
    def n_songs(self) -> int:
        return len(self.file_names)

    def _song_arrays(self, name: str):
        if name not in self._mmaps:
            phase_name = name.replace("_spec.npy", "_phase.npy")
            self._mmaps[name] = tuple(
                np.load(os.path.join(d, f), mmap_mode="r")
                for d, f in (
                    (self.mixture_path, name),
                    (self.vocal_path, name),
                    (self.mixture_path, phase_name),
                    (self.vocal_path, phase_name),
                )
            )
        return self._mmaps[name]

    def _song_angles(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        """Full-song float32 angle planes (mixture, vocal), DC-dropped,
        computed ONCE per song and cached.  The reference recomputes
        ``np.angle`` per item (train.py:105-106); computing per song is
        ~samples_per_song x cheaper, and numpy's angle kernel is
        SIMD-layout-dependent at the last ulp, so every pipeline must share
        one computation, not just one formula.  Cost: the cache holds 2
        float32 planes per touched song (~10 MB/4-min song) in host RAM."""
        if name not in self._angles:
            _, _, mix_p, voc_p = self._song_arrays(name)
            lo = 1 if self.drop_dc else 0
            self._angles[name] = tuple(
                np.angle(np.ascontiguousarray(p[lo:])).astype(np.float32)
                for p in (mix_p, voc_p))
        return self._angles[name]

    def song_length(self, idx: int) -> int:
        """Time frames of song ``idx % n_songs`` (mmap header read only)."""
        name = self.file_names[idx % len(self.file_names)]
        return int(self._song_arrays(name)[0].shape[1])

    def sample(self, idx: int, rng: np.random.Generator):
        """One training item (reference train.py:86-143)."""
        t = self.song_length(idx)
        l = self.input_len
        # draw only when a crop is possible — the RNG call order of
        # index_batches
        start = (int(rng.integers(0, t - l, endpoint=True))  # train.py:121
                 if t > l else 0)
        return self.crop(idx, start)

    def crop(self, idx: int, start: int):
        """The item at a GIVEN crop offset (the deterministic half of
        :meth:`sample`)."""
        name = self.file_names[idx % len(self.file_names)]
        mix_m, voc_m, _, _ = self._song_arrays(name)
        mix_af, voc_af = self._song_angles(name)
        lo = 1 if self.drop_dc else 0  # DC drop (train.py:110-113)
        t = mix_m.shape[1]
        l = self.input_len
        if t > l:
            sl = slice(start, start + l)
            mix = np.asarray(mix_m[lo:, sl], np.float32)
            voc = np.asarray(voc_m[lo:, sl], np.float32)
            mix_a = np.ascontiguousarray(mix_af[:, sl])
            voc_a = np.ascontiguousarray(voc_af[:, sl])
        else:
            pad = ((0, 0), (0, l - t))
            mix = np.pad(np.asarray(mix_m[lo:], np.float32), pad)
            voc = np.pad(np.asarray(voc_m[lo:], np.float32), pad)
            mix_a = np.pad(mix_af, pad)
            voc_a = np.pad(voc_af, pad)
        return mix, voc, mix_a, voc_a

    def index_batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: Optional[int] = None,
        drop_last: bool = False,
        n_steps: Optional[int] = None,
    ) -> Iterator[Tuple[List[int], np.ndarray]]:
        """Yield the ``(dataset_indices, crop_starts)`` stream that defines
        an epoch: the SINGLE source of the epoch's RNG sequence.  Its RNG
        call order (permutations first, then one
        ``integers`` draw per croppable item in batch order) reproduces the
        original host sampler exactly.
        """
        rng = np.random.default_rng(seed)
        n = len(self)
        if n_steps is not None:
            need = n_steps * batch_size
            reps = -(-need // n)
            if shuffle:
                order = np.concatenate(
                    [rng.permutation(n) for _ in range(reps)])[:need]
            else:
                order = np.tile(np.arange(n), reps)[:need]
            spans = [(i * batch_size, (i + 1) * batch_size)
                     for i in range(n_steps)]
        else:
            order = np.arange(n)
            if shuffle:
                rng.shuffle(order)
            ends = range(batch_size, n + 1, batch_size) if drop_last else \
                range(batch_size, n + batch_size, batch_size)
            spans = [(e - batch_size, min(e, n)) for e in ends
                     if e - batch_size < n]

        l = self.input_len
        for lo_i, hi_i in spans:
            idxs = [int(order[i]) for i in range(lo_i, hi_i)]
            starts = np.zeros(len(idxs), np.int64)
            for j, idx in enumerate(idxs):
                t = self.song_length(idx)
                if t > l:  # train.py:121; short songs zero-pad at start 0
                    starts[j] = int(rng.integers(0, t - l, endpoint=True))
            yield idxs, starts

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: Optional[int] = None,
        drop_last: bool = False,
        prefetch: int = 2,
        n_steps: Optional[int] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield dict batches of stacked (B, 512, input_len) arrays with
        background prefetch.

        ``n_steps``: yield EXACTLY this many full batches, wrapping around
        the (re-shuffled) index order as needed.  Multi-host training uses
        this to keep every host's step count in lockstep regardless of how
        the songs split across hosts (collective programs must be entered
        the same number of times everywhere); the sampler is a random patch
        cropper anyway, so wraparound only re-crops songs.
        """
        def produce(q: queue.Queue):
            try:
                for idxs, starts in self.index_batches(
                        batch_size, shuffle=shuffle, seed=seed,
                        drop_last=drop_last, n_steps=n_steps):
                    items = [self.crop(i, int(s))
                             for i, s in zip(idxs, starts)]
                    batch = {k: np.stack([it[j] for it in items])
                             for j, k in enumerate(PLANE_KEYS)}
                    q.put(batch)
                q.put(None)
            except BaseException as e:  # surface in the consumer, don't
                q.put(e)                # silently truncate the epoch

        q: queue.Queue = queue.Queue(maxsize=prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def steps_per_epoch(self, batch_size: int, drop_last: bool = False) -> int:
        n = len(self)
        return n // batch_size if drop_last else -(-n // batch_size)
