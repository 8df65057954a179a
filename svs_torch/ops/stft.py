"""STFT / iSTFT / framing primitives (port of ``svs_tpu/ops/stft.py``).

Semantics (the same parity targets as the JAX module):
- ``stft(...)`` with ``center=True, pad_mode='constant'`` matches
  ``librosa.stft`` (reference data.py:79,100) and returns complex64
  ``(..., n_fft//2+1, n_frames)`` in (freq, time) layout.
- ``stft(...)`` with ``pad_mode='reflect'`` matches ``torch.stft`` defaults
  (auraloss's MR-STFT loss, reference train.py:26,293), including the
  zero-centred window padding when ``win_length < n_fft``.
- ``istft(...)`` matches ``librosa.istft`` (reference data.py:159) and
  ``torch.istft`` (reference train.py:51-58): windowed overlap-add with
  squared-window normalisation, centre trim of ``n_fft//2`` per side,
  default output length ``hop * (n_frames - 1)``.

The transforms are ``torch.fft`` on whatever device the input lies on; the
framing and overlap-add are gather-free (K = ceil(frame/hop) shifted slices).
``stft_magphase`` / ``istft_ri`` keep the JAX package's stacked (2, F, T)
real/imag contract at their public edge.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def centered_hann_dft(n_fft: int, win: int):
    """Host-side (numpy) real-DFT bases with a CENTRED periodic hann window
    folded in (torch.stft semantics for win <= n_fft): returns (cos, sin)
    each (n_fft, n_fft//2 + 1) float32, with rfft's  e^{-i...}  sign on sin."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    f = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * t * f / n_fft
    w = np.zeros((n_fft, 1), np.float32)
    left = (n_fft - win) // 2
    w[left:left + win, 0] = 0.5 - 0.5 * np.cos(
        2.0 * np.pi * np.arange(win) / win)
    return ((np.cos(ang) * w).astype(np.float32),
            (-np.sin(ang) * w).astype(np.float32))


def hann_window(win_length: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Periodic Hann window — matches ``torch.hann_window`` and
    ``scipy.signal.get_window('hann', n, fftbins=True)`` (librosa's default),
    computed as svs_tpu computes it (f32 ``0.5 - 0.5 cos``)."""
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    w = 0.5 - 0.5 * torch.cos(2.0 * np.pi * n / win_length)
    return w.to(dtype)


def pad_center(window: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Zero-pad a window symmetrically to ``n_fft`` (torch.stft semantics for
    ``win_length < n_fft``: left pad ``(n_fft - win) // 2``)."""
    win = window.shape[-1]
    if win == n_fft:
        return window
    left = (n_fft - win) // 2
    return F.pad(window, (left, n_fft - win - left))


def frame_signal(y: torch.Tensor, frame_length: int,
                 hop_length: int) -> torch.Tensor:
    """Slice ``y (..., T)`` into overlapping frames ``(..., n_frames, frame_length)``.

    n_frames = 1 + (T - frame_length) // hop_length  (requires T >= frame_length).
    """
    t = y.shape[-1]
    if t < frame_length:
        raise ValueError(
            f"signal length {t} is shorter than frame_length {frame_length}; "
            "pad the input (or use center=True) before framing")
    n_frames = 1 + (t - frame_length) // hop_length
    # gather-free: view the signal as hop-sized rows and concatenate
    # K = ceil(frame/hop) shifted row slices (the inverse of overlap_add)
    k = -(-frame_length // hop_length)
    padded = (n_frames + k) * hop_length
    z = F.pad(y, (0, padded - t)).reshape(*y.shape[:-1], n_frames + k,
                                          hop_length)
    chunks = [z[..., j:j + n_frames, :] for j in range(k)]
    return torch.cat(chunks, dim=-1)[..., :frame_length]


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Overlap-add ``frames (..., n_frames, frame_length)`` at ``hop_length``.

    Output length is ``frame_length + hop_length * (n_frames - 1)``; K strided
    adds (K = ceil(frame/hop)) instead of a scatter.
    """
    *lead, n_frames, frame_length = frames.shape
    k = -(-frame_length // hop_length)
    padded_len = k * hop_length
    if padded_len != frame_length:
        frames = F.pad(frames, (0, padded_len - frame_length))
    chunks = frames.reshape(*lead, n_frames, k, hop_length)
    out = frames.new_zeros((*lead, n_frames + k - 1, hop_length))
    for j in range(k):
        out[..., j:j + n_frames, :] += chunks[..., :, j, :]
    out = out.reshape(*lead, (n_frames + k - 1) * hop_length)
    return out[..., :frame_length + hop_length * (n_frames - 1)]


def _pad_last(y: torch.Tensor, left: int, right: int,
              mode: str) -> torch.Tensor:
    """Pad the last axis of ``y (..., T)``; reflect pad takes a 2-D view
    (F.pad's reflect mode wants (C, T) or (N, C, T))."""
    if mode == "constant":
        return F.pad(y, (left, right))
    lead = y.shape[:-1]
    out = F.pad(y.reshape(-1, y.shape[-1]), (left, right), mode=mode)
    return out.reshape(*lead, out.shape[-1])


def stft(
    y: torch.Tensor,
    n_fft: int = 1024,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """Short-time Fourier transform of ``y (..., T)``.

    Returns complex64 ``(..., n_fft//2 + 1, n_frames)`` — (freq, time) layout
    matching librosa (reference data.py:79).
    """
    if hop_length is None:
        hop_length = n_fft // 4
    if win_length is None:
        win_length = n_fft
    if window is None:
        window = hann_window(win_length, device=y.device)
    window = pad_center(window.to(y.dtype), n_fft)

    if center:
        y = _pad_last(y, n_fft // 2, n_fft // 2, pad_mode)

    frames = frame_signal(y, n_fft, hop_length) * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    # (..., n_frames, n_bins) -> (..., n_bins, n_frames)
    return spec.transpose(-1, -2).to(torch.complex64)


def istft(
    S: torch.Tensor,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    n_fft: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Inverse STFT of ``S (..., n_bins, n_frames)`` complex.

    Windowed overlap-add with squared-window (NOLA) normalisation; matches
    ``librosa.istft`` (reference data.py:159) and ``torch.istft``
    (reference train.py:51-58) where their domains overlap.
    """
    n_bins, n_frames = S.shape[-2], S.shape[-1]
    if n_fft is None:
        n_fft = 2 * (n_bins - 1)
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = win_length // 4
    if window is None:
        window = hann_window(win_length, device=S.device)
    window = pad_center(window, n_fft).to(torch.float32)

    frames = torch.fft.irfft(S.transpose(-1, -2), n=n_fft, dim=-1)
    frames = frames.to(torch.float32) * window
    y = overlap_add(frames, hop_length)

    # squared-window normalisation envelope
    wsq = (window[None, :] ** 2).expand(n_frames, n_fft)
    envelope = overlap_add(wsq, hop_length)
    y = torch.where(envelope > 1e-11,
                    y / torch.clamp(envelope, min=1e-11),
                    torch.zeros((), dtype=y.dtype, device=y.device))

    if center:
        y = y[..., n_fft // 2: y.shape[-1] - n_fft // 2]
    if length is not None:
        if y.shape[-1] >= length:
            y = y[..., :length]
        else:
            y = F.pad(y, (0, length - y.shape[-1]))
    return y


def magphase(S: torch.Tensor):
    """Split a complex spectrogram into (magnitude, unit-phase complex).

    ``librosa.magphase`` semantics (reference data.py:80,101): the phase of
    a zero bin is 1+0j (``angle(0) == 0``).
    """
    mag = torch.abs(S)
    phase = torch.polar(torch.ones_like(mag), torch.angle(S))
    return mag, phase.to(torch.complex64)


def polar(mag: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """``torch.polar`` semantics: mag * exp(i * angle) (reference train.py:44)."""
    return torch.complex(mag * torch.cos(angle),
                         mag * torch.sin(angle)).to(torch.complex64)


def amplitude_to_db(
    S: torch.Tensor,
    ref: float = 1.0,
    amin: float = 1e-5,
    top_db: Optional[float] = 80.0,
) -> torch.Tensor:
    """``librosa.amplitude_to_db`` semantics (used by the reference
    visualizer, aaa.py:106-108): ``20 log10(max(amin, |S|)) - 20
    log10(max(amin, ref))``, floored at ``top_db`` below the peak unless
    ``top_db`` is None; on the device ``S`` lies on."""
    mag = torch.abs(S)
    ref_t = torch.as_tensor(ref, dtype=mag.dtype, device=mag.device)
    db = (20.0 * torch.log10(torch.clamp(mag, min=amin))
          - 20.0 * torch.log10(torch.clamp(ref_t, min=amin)))
    if top_db is not None:
        db = torch.maximum(db, db.max() - top_db)
    return db


def stft_magphase(y: torch.Tensor, n_fft: int, hop_length: int):
    """STFT + magnitude/phase split of the preprocessing path (replaces
    reference data.py:79-80's host librosa calls) on ``torch.fft``.

    The unit phase is returned as stacked (2, F, T) float32 real/imag planes,
    the contract of svs_tpu's ``stft_magphase_jit``.
    """
    S = stft(y, n_fft=n_fft, hop_length=hop_length)
    mag, phase = magphase(S)
    phase_ri = torch.stack([phase.real, phase.imag])
    return mag.to(torch.float32), phase_ri.to(torch.float32)


def istft_ri(spec_ri: torch.Tensor, n_fft: int,
             hop_length: int) -> torch.Tensor:
    """iSTFT of a spectrogram given as stacked (2, F, T) float32 real/imag
    planes; full ``hop*(T-1)`` output, callers slice to length."""
    S = torch.complex(spec_ri[0], spec_ri[1])
    return istft(S, hop_length=hop_length, win_length=n_fft, n_fft=n_fft)
