"""Seeded synthetic songs, made on the device, and the spectrogram dataset
written from them.

The signal follows ``svs_torch/utils/benchmark.py``'s music fixture
(a harmonic "vocal" with vibrato, a low accompaniment and a noise floor),
widened so that songs differ: each song draws its own melody, on/off
phrasing, bass line and chord from the seed.  Everything a song is made
of is drawn from ``numpy.random.default_rng(seed)`` (a few hundred
numbers) and ``torch.Generator`` on the device (the noise); the
waveform is computed on the device in a few calls.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import dsp

NOTE_S = 0.4      # one melody note
BASS_S = 0.8      # one bass note
PEAK = 0.9        # the mixture's peak, below PCM16's full scale


def _hz(midi: np.ndarray) -> np.ndarray:
    return 440.0 * 2.0 ** ((midi - 69) / 12.0)


def _held(values: np.ndarray, seconds: float, n: int, sr: int,
          device) -> torch.Tensor:
    """``values`` each held for ``seconds``, sampled at ``sr`` over ``n``
    samples."""
    idx = torch.arange(n, device=device) // max(1, int(seconds * sr))
    v = torch.as_tensor(values, dtype=torch.float64, device=device)
    return v[idx.clamp(max=len(values) - 1)]


def song(seed: int, n: int, sr: int, device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(vocal, accompaniment) float32 waveforms of ``n`` samples; their
    sum peaks at :data:`PEAK`."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device).manual_seed(int(rng.integers(2 ** 62)))
    dur = n / sr
    t = torch.arange(n, dtype=torch.float64, device=device) / sr
    notes = int(np.ceil(dur / NOTE_S)) + 1
    f0 = _held(_hz(rng.integers(55, 80, notes)), NOTE_S, n, sr, device)
    vib = 1.0 + 0.01 * torch.sin(2 * np.pi * rng.uniform(4.5, 6.0) * t)
    phase = torch.cumsum(2 * np.pi * f0 * vib / sr, 0)
    on = _held((rng.random(notes) < 0.7).astype(np.float64), NOTE_S, n, sr,
               device)
    vocal = sum((0.3 / h) * torch.sin(h * phase) for h in range(1, 7)) * on
    bass_n = int(np.ceil(dur / BASS_S)) + 1
    fb = _held(_hz(rng.integers(33, 48, bass_n)), BASS_S, n, sr, device)
    pb = torch.cumsum(2 * np.pi * fb / sr, 0)
    chord = _hz(rng.integers(48, 67) + np.array([0, 4, 7]))
    accomp = (0.2 * torch.sin(pb) + 0.08 * torch.sin(2 * pb)
              + sum(0.05 * torch.sin(2 * np.pi * f * t) for f in chord))
    accomp = accomp + 0.02 * torch.randn(n, generator=gen, device=device,
                                         dtype=torch.float64)
    scale = PEAK / (vocal + accomp).abs().max().clamp(min=1e-9)
    return ((vocal * scale).to(torch.float32),
            (accomp * scale).to(torch.float32))


def mixture(seed: int, n: int, sr: int, device,
            pcm16: bool) -> np.ndarray:
    """One song's mixture on the host: int16 PCM or float32."""
    v, a = song(seed, n, sr, device)
    y = v + a
    if pcm16:
        y = torch.clamp(torch.round(y * 32768.0), -32768, 32767)
        return y.to(torch.int16).cpu().numpy()
    return y.cpu().numpy()


def _to_spec(y: torch.Tensor, norm: torch.Tensor, n_fft: int,
             hop: int) -> Tuple[np.ndarray, np.ndarray]:
    """The dataset's pair of a track (reference data.py:46-112): float32
    magnitude over the mixture's peak magnitude, complex64 unit phase
    (1 where the magnitude is 0)."""
    s = dsp.stft(y, n_fft, hop)
    mag = s.abs()
    phase = torch.where(mag > 0, s / mag.clamp(min=1e-30),
                        torch.ones_like(s))
    return ((mag / norm).cpu().numpy(),
            phase.to(torch.complex64).cpu().numpy())


def write_dataset(folder: str, seeds: List[int], n: int, cfg: Dict,
                  device) -> int:
    """Write one ``<i>_song<i>_{spec,phase}.npy`` pair a track under
    ``folder/{mixture,vocal}`` for each seed (the layout of the program's
    ``data_cli to_spec``).  Returns the bytes written."""
    sr, n_fft, hop = cfg["sample_rate"], cfg["window_size"], cfg["hop_size"]
    written = 0
    for track in ("mixture", "vocal"):
        os.makedirs(os.path.join(folder, track), exist_ok=True)
    for i, seed in enumerate(seeds):
        vocal, accomp = song(seed, n, sr, device)
        mix = vocal + accomp
        norm = torch.clamp(dsp.stft(mix, n_fft, hop).abs().max(), min=1e-12)
        for track, y in (("mixture", mix), ("vocal", vocal)):
            mag, phase = _to_spec(y, norm, n_fft, hop)
            base = os.path.join(folder, track, f"{i:04d}_song{i}")
            np.save(base + "_spec.npy", mag)
            np.save(base + "_phase.npy", phase)
            written += mag.nbytes + phase.nbytes
    return written


def dataset_names(folder: str) -> List[str]:
    """The dataset's songs' file names, in the order the program's
    sampler indexes them (sorted)."""
    return sorted(f for f in os.listdir(os.path.join(folder, "mixture"))
                  if f.endswith("_spec.npy"))


def crop(folder: str, name: str, start: int,
         length: int) -> Dict[str, np.ndarray]:
    """``length`` frames from ``start`` of one song, as the reference
    trains on them (train.py:86-143): the four planes, magnitudes and
    float32 phase angles, the DC row dropped."""
    out = {}
    for track, key in (("mixture", "mix"), ("vocal", "voc")):
        d = os.path.join(folder, track)
        sl = slice(start, start + length)
        out[key] = np.asarray(np.load(os.path.join(d, name),
                                      mmap_mode="r")[1:, sl], np.float32)
        phase = np.load(os.path.join(d, name.replace("_spec.npy",
                                                     "_phase.npy")),
                        mmap_mode="r")[1:, sl]
        out[key + "_angle"] = np.angle(phase).astype(np.float32)
    return out
