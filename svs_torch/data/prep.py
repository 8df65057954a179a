"""wav <-> spectrogram preprocessing (port of ``svs_tpu/data/prep.py``).

Reproduces the reference's on-disk contract exactly (reference
data.py:46-169):

to_spec (data.py:46-112):
  <tar>/{mixture,vocal}/<idx:04d>_<song>_{spec,phase}.npy
  - spec: float32 magnitude (n_fft//2+1, T), every track divided by the
    MIXTURE's max magnitude (zero-guarded)            (data.py:84-85,105)
  - phase: complex64 unit phase                       (data.py:80,101)
  - vocals length-aligned to the mixture (truncate / zero-pad) (data.py:97-98)

to_wave (data.py:117-169):
  masked magnitude + phase (searched flat, then in a mixture/ subdir; random
  phase fallback) -> iSTFT -> peak-normalise to 0.9 -> PCM16 wav.

The STFT front end runs on the device: on CUDA through the hand-written
``stft_magphase`` kernel (svs_torch/ops/cuda/dsp.py), elsewhere through
``torch.fft`` (svs_torch/ops/stft.py), mirroring svs_tpu's Pallas/XLA routing
(prep.py:52-80).  Song lengths are padded to the same buckets as svs_tpu's
(2^18 samples, 256 frames) and sliced back to the exact frame count, so the
files equal svs_tpu's.  Progress is one printed line per song or file (the
port does not depend on tqdm).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from svs_torch.data import wav as wavio
from svs_torch.ops import stft as dsp
from svs_torch.ops.cuda import dsp as cuda_dsp
from svs_torch.utils.config import num2str
from svs_torch.utils.device import DeviceLike, resolve_device

# wav filename -> target folder (reference data.py:41-44)
TRACK_MAP = {"mixture.wav": "mixture", "vocals.wav": "vocal"}

_BUCKET = 1 << 18  # 262144 samples (= 32 s @ 8192 Hz) padding granularity


def _bucket_pad(y: np.ndarray) -> np.ndarray:
    n = ((y.shape[-1] + _BUCKET - 1) // _BUCKET) * _BUCKET
    return np.pad(y, (0, n - y.shape[-1]))


def stft_magphase(y: np.ndarray, n_fft: int, hop: int, impl: str = "auto",
                  device: DeviceLike = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Device STFT + magphase of an arbitrary-length host signal, with
    bucket padding; exact librosa frame count (1 + T//hop).

    ``impl``: 'kernel' = the fused stft_magphase kernel (its plain version
    for a CPU device), 'fft' = ``torch.fft``, 'auto' = 'kernel' on CUDA and
    'fft' elsewhere.  Returns (mag float32 (F, T), phase complex64 (F, T)).
    """
    dev = resolve_device(device)
    if impl == "auto":
        impl = "kernel" if dev.type == "cuda" else "fft"
    n_frames = 1 + len(y) // hop  # librosa center=True frame count
    yt = torch.from_numpy(_bucket_pad(np.asarray(y, np.float32))).to(dev)
    if impl == "kernel":
        mag, phase_ri = cuda_dsp.stft_magphase(yt, n_fft=n_fft, hop_length=hop)
    elif impl == "fft":
        mag, phase_ri = dsp.stft_magphase(yt, n_fft=n_fft, hop_length=hop)
    else:
        raise ValueError(f"unknown impl {impl!r}; expected auto, fft or kernel")
    mag = mag[:, :n_frames].cpu().numpy()
    ri = phase_ri[:, :, :n_frames].cpu().numpy()
    return mag, (ri[0] + 1j * ri[1]).astype(np.complex64)


def istft_device(spec: np.ndarray, n_fft: int, hop: int,
                 length: Optional[int] = None,
                 device: DeviceLike = None) -> np.ndarray:
    """Device iSTFT of a host complex spectrogram (data.py:159 equivalent);
    the length slice happens after the full hop*(T-1) transform."""
    dev = resolve_device(device)
    ri = torch.from_numpy(np.stack([spec.real, spec.imag]).astype(np.float32))
    y = dsp.istft_ri(ri.to(dev), n_fft=n_fft, hop_length=hop).cpu().numpy()
    if length is not None:
        if y.shape[-1] >= length:
            y = y[..., :length]
        else:
            y = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, length - y.shape[-1])])
    return y


def song_to_spec(
    song_path: str,
    tar: str,
    idx: int,
    song_name: str,
    *,
    win_size: int,
    hop_size: int,
    sr: int,
    device: DeviceLike = None,
) -> bool:
    """Process one song folder (reference data.py:66-109). Returns True if
    the mixture existed and specs were written."""
    mix_path = os.path.join(song_path, "mixture.wav")
    if not os.path.exists(mix_path):
        return False

    y_mix, _ = wavio.load_audio(mix_path, sr=sr, mono=True)
    # one pass yields the norm AND the mixture's spec/phase
    mag_mix, phase_mix = stft_magphase(y_mix, win_size, hop_size,
                                       device=device)
    norm = float(mag_mix.max())
    if norm == 0:
        norm = 1.0  # zero-guard (data.py:85)

    for wav_file, folder in TRACK_MAP.items():
        track_path = os.path.join(song_path, wav_file)
        if not os.path.exists(track_path):
            continue
        if wav_file == "mixture.wav":
            mag, phase = mag_mix, phase_mix
        else:
            y, _ = wavio.load_audio(track_path, sr=sr, mono=True)
            # length-align to the mixture (data.py:97-98)
            if len(y) > len(y_mix):
                y = y[: len(y_mix)]
            else:
                y = np.pad(y, (0, len(y_mix) - len(y)))
            mag, phase = stft_magphase(y, win_size, hop_size, device=device)
        # C order, as svs_tpu writes them: the C++ loader (native/
        # svs_native.cpp) maps only C-ordered .npy files
        mag = np.ascontiguousarray(mag / norm, dtype=np.float32)
        base = f"{num2str(idx)}_{song_name}"
        np.save(os.path.join(tar, folder, f"{base}_spec.npy"), mag)
        np.save(os.path.join(tar, folder, f"{base}_phase.npy"),
                np.ascontiguousarray(phase))
    return True


def to_spec(src: str, tar: str, *, win_size: int, hop_size: int, sr: int,
            progress: bool = True, device: DeviceLike = None) -> int:
    """Directory-level to_spec (reference data.py:46-112).

    A song whose files cannot be read or parsed is reported and skipped
    (per-song resilience, data.py:111-112); a device error stops the run.
    """
    dev = resolve_device(device)
    os.makedirs(tar, exist_ok=True)
    for folder in TRACK_MAP.values():
        os.makedirs(os.path.join(tar, folder), exist_ok=True)
    songs = sorted(
        d for d in os.listdir(src) if os.path.isdir(os.path.join(src, d))
    )
    done = 0
    for idx, name in enumerate(songs):
        if progress:
            print(f"to_spec {idx + 1}/{len(songs)}: {name}")
        try:
            done += song_to_spec(
                os.path.join(src, name), tar, idx, name,
                win_size=win_size, hop_size=hop_size, sr=sr, device=dev,
            )
        except (OSError, ValueError) as e:
            print(f"Error processing {name}: {e}")
    return done


def find_phase(phase_dir: str, spec_name: str) -> Optional[np.ndarray]:
    """Phase search order of reference data.py:132-143: flat dir, then a
    mixture/ subdir."""
    phase_name = spec_name.replace("_spec.npy", "_phase.npy")
    for p in (
        os.path.join(phase_dir, phase_name),
        os.path.join(phase_dir, "mixture", phase_name),
    ):
        if os.path.exists(p):
            return np.load(p)
    return None


def to_wave(src: str, tar: str, phase_dir: str, *, win_size: int,
            hop_size: int, sr: int, progress: bool = True,
            seed: Optional[int] = None, device: DeviceLike = None) -> int:
    """Directory-level to_wave (reference data.py:117-169).

    The random-phase fallback draws from numpy's ``default_rng(seed)``, as
    svs_tpu does, so both packages draw the same numbers.
    """
    dev = resolve_device(device)
    os.makedirs(tar, exist_ok=True)
    files = sorted(f for f in os.listdir(src) if f.endswith("_spec.npy"))
    rng = np.random.default_rng(seed)
    done = 0
    for i, spec_name in enumerate(files):
        if progress:
            print(f"to_wave {i + 1}/{len(files)}: {spec_name}")
        try:
            mag = np.load(os.path.join(src, spec_name))
            phase = find_phase(phase_dir, spec_name)
            if phase is None:
                # random-phase fallback (data.py:145-148)
                phase = np.exp(2j * np.pi * rng.random(mag.shape)).astype(
                    np.complex64
                )
            min_len = min(mag.shape[1], phase.shape[1])
            spec = mag[:, :min_len] * phase[:, :min_len]
            y = istft_device(_pad_spec_frames(spec), win_size, hop_size,
                             length=hop_size * (min_len - 1), device=dev)
            peak = float(np.max(np.abs(y)))
            if peak > 0:
                y = y / peak * 0.9  # renormalise (data.py:162-164)
            wavio.write_wav(
                os.path.join(tar, spec_name.replace("_spec.npy", ".wav")),
                y, sr,
            )
            done += 1
        except (OSError, ValueError) as e:  # per-file resilience (data.py:168-169)
            print(f"Failed to reconstruct {spec_name}: {e}")
    return done


_FRAME_BUCKET = 256


def _pad_spec_frames(spec: np.ndarray) -> np.ndarray:
    """Pad the time axis to a bucket multiple (svs_tpu compiles O(1) iSTFT
    shapes this way; the port keeps it so both transform the same frames);
    the iSTFT result is sliced back via its length= argument."""
    t = spec.shape[-1]
    n = ((t + _FRAME_BUCKET - 1) // _FRAME_BUCKET) * _FRAME_BUCKET
    return np.pad(spec, [(0, 0)] * (spec.ndim - 1) + [(0, n - t)])
