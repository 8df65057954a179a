"""Fused STFT front end: the CUDA kernel's two wrappers and their plain
PyTorch versions.

Replaces two TPU kernels of ``svs_tpu/ops/pallas/dsp.py``:

- ``stft_magphase`` (``_stft_magphase_kernel``, pallas_call at dsp.py:203):
  centre constant pad, periodic-hann windowed real DFT in true float32,
  ``mag (n_bins, n_frames)`` and unit phase ``(2, n_bins, n_frames)``
  real/imag planes, phase 1+0j where mag <= 1e-30 (librosa.magphase
  contract, reference data.py:80);
- ``stft_magnitude`` (``_stft_mag_kernel``, pallas_call at dsp.py:134): the
  same front end, ``mag`` alone (the ``bench_cli --frontend`` path).

On Hopper it is an implicit-framing GEMM (``svs_torch/csrc/stft_magphase.cu``)
against one basis whose column pairs are the cosine and sine of a bin
(:func:`paired_basis`); it never writes a frame matrix and computes the
magnitude (and the phase) in the epilogue; one kernel template, two C entry
points.  At the decode shape it is bound by f32 FMA work, not bytes (~86 us
at 67 TFLOP/s against ~9 us for its ~29 MB on an H100 SXM; numbers in the
source and in PERF.md).  It keeps FFMA — no TF32 — to match the TPU
kernels' ``Precision.HIGHEST``.

:func:`stft_magphase` and :func:`stft_magnitude` launch the kernel for a
CUDA tensor and take the plain version only for a tensor on the CPU; a build
or launch error raises.  Each has its own launch count.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from svs_torch.ops import stft as dsp
from svs_torch.ops.cuda import build

KERNEL = "stft_magphase"
_TAP_TILE = 16    # kBK in the .cu: basis rows padded to a multiple of it
_COL_TILE = 128   # kBN in the .cu: basis columns padded to a multiple of it

# launches of the CUDA kernel, stft_magphase's and stft_magnitude's
# (plain-version calls are not counted)
launches = 0
mag_launches = 0

_bases: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def windowed_dft(n_fft: int):
    """(n_fft, n_fft//2 + 1) cos / -sin bases with the periodic hann window
    folded in: the numbers of svs_tpu's ``_windowed_dft`` (dsp.py:46-62),
    without its hop chunking and padding."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    f = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * t * f / n_fft
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
         ).astype(np.float32)[:, None]
    cos = (np.cos(ang) * w).astype(np.float32)
    sin = (-np.sin(ang) * w).astype(np.float32)  # rfft sign convention
    return cos, sin


def paired_basis(n_fft: int) -> np.ndarray:
    """The kernel's (n_taps, n_cols) basis: columns 2b and 2b+1 are the
    cosine and the negated sine of bin b, for 1 <= b < n_fft/2; the sines of
    bin 0 and of the Nyquist bin are zero, so column 0 is bin 0's cosine and
    column 1 the Nyquist bin's.  Rows past n_fft and columns past n_fft are
    zero (padding to the kernel's tiles)."""
    cos, sin = windowed_dft(n_fft)
    half = n_fft // 2
    out = np.zeros((_cdiv(n_fft, _TAP_TILE) * _TAP_TILE,
                    _cdiv(n_fft, _COL_TILE) * _COL_TILE), np.float32)
    out[:n_fft, 0:n_fft:2] = cos[:, :half]
    out[:n_fft, 1:n_fft:2] = sin[:, :half]
    out[:n_fft, 1] = cos[:, half]
    return out


def unpair(cols: torch.Tensor, n_fft: int):
    """(n_cols, ...) products with :func:`paired_basis` -> re, im, each
    (n_fft//2 + 1, ...)."""
    zero = torch.zeros_like(cols[:1])
    re = torch.cat([cols[0:n_fft:2], cols[1:2]])
    im = torch.cat([zero, cols[3:n_fft:2], zero])
    return re, im


def _device_basis(n_fft: int, device: torch.device) -> torch.Tensor:
    """The paired basis, uploaded once per (n_fft, device)."""
    key = (n_fft, device)
    if key not in _bases:
        _bases[key] = torch.from_numpy(paired_basis(n_fft)).to(device)
    return _bases[key]


def _epilogue(re: torch.Tensor, im: torch.Tensor):
    """mag and unit phase from re/im (dsp.py:165-174)."""
    mag = torch.sqrt(re * re + im * im)
    nz = mag > 1e-30
    inv = torch.where(nz, 1.0 / torch.where(nz, mag, torch.ones_like(mag)),
                      torch.zeros_like(mag))
    pre = torch.where(nz, re * inv, torch.ones_like(mag))
    pim = im * inv
    return mag, torch.stack([pre, pim])


def _spectrum_plain(y: torch.Tensor, n_fft: int, hop_length: int):
    """re, im of the kernel's GEMM done as an f32 ``torch.matmul``: the same
    framing and basis."""
    basis = _device_basis(n_fft, y.device)
    frames = dsp.frame_signal(F.pad(y, (n_fft // 2, n_fft // 2)), n_fft,
                              hop_length)                # (n_frames, n_fft)
    cols = torch.matmul(frames, basis[:n_fft, :n_fft]).T  # (n_fft, n_frames)
    return unpair(cols, n_fft)


def stft_magphase_plain(y: torch.Tensor, n_fft: int = 1024,
                        hop_length: int = 768):
    """Plain PyTorch version of the kernel: the same framing, the same
    basis as an f32 ``torch.matmul``, the same epilogue.  On the card this
    needs ``torch.backends.cuda.matmul.allow_tf32 = False`` to stay true
    f32."""
    _check(y, n_fft, hop_length, "stft_magphase")
    return _epilogue(*_spectrum_plain(y, n_fft, hop_length))


def stft_magnitude_plain(y: torch.Tensor, n_fft: int = 1024,
                         hop_length: int = 768) -> torch.Tensor:
    """Plain PyTorch version of the magnitude-only kernel: the same framing
    and basis as an f32 ``torch.matmul``, then sqrt(re^2 + im^2) (TF32 off
    on the card, as :func:`stft_magphase_plain`)."""
    _check(y, n_fft, hop_length, "stft_magnitude")
    re, im = _spectrum_plain(y, n_fft, hop_length)
    return torch.sqrt(re * re + im * im)


def _check(y: torch.Tensor, n_fft: int, hop_length: int, name: str) -> None:
    if y.ndim != 1:
        raise ValueError(f"{name} expects a 1-D signal")
    if y.dtype != torch.float32:
        raise TypeError(f"{name} expects float32, got {y.dtype}")
    if n_fft < 2 or n_fft % 2 or hop_length < 1:
        raise ValueError(f"bad geometry n_fft={n_fft} hop={hop_length} "
                         "(n_fft must be even)")


def _kernel_fn(name: str, n_outputs: int):
    """The C entry point ``name`` with ``n_outputs`` output pointers,
    built and typed on first use (every pointer and the stream as
    c_void_p, so ctypes never cuts them to 32 bits)."""
    fn = getattr(build.load(KERNEL), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * (n_outputs + 1))
    return fn


def _launch(y: torch.Tensor, n_fft: int, hop_length: int, phase: bool):
    """One launch of the kernel; returns ``mag`` and, with ``phase``, the
    phase planes."""
    global launches, mag_launches
    name = "stft_magphase" if phase else "stft_magnitude"
    if not y.is_contiguous():
        raise ValueError(f"{name} expects a contiguous signal")
    n_bins = n_fft // 2 + 1
    # frames of the signal centre-padded by n_fft/2 a side (dsp.py:87-89)
    n_frames = 1 + y.shape[0] // hop_length
    basis = _device_basis(n_fft, y.device)
    mag = torch.empty((n_bins, n_frames), dtype=torch.float32,
                      device=y.device)
    outs = [mag]
    if phase:
        outs.append(torch.empty((2, n_bins, n_frames), dtype=torch.float32,
                                device=y.device))
    fn = _kernel_fn(f"svs_{name}", len(outs))
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        rc = fn(y.data_ptr(), y.shape[0], basis.data_ptr(), basis.shape[0],
                basis.shape[1], hop_length, n_fft // 2, n_bins, n_frames,
                *[o.data_ptr() for o in outs], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    if phase:
        launches += 1
        return tuple(outs)
    mag_launches += 1
    return mag


def stft_magphase(y: torch.Tensor, n_fft: int = 1024, hop_length: int = 768):
    """Fused STFT + librosa.magphase of ``y (T,)`` float32.

    Returns ``(mag (n_bins, n_frames), phase_ri (2, n_bins, n_frames))``
    float32, the contract of svs_tpu's Pallas ``stft_magphase``.  A CUDA
    tensor goes through the kernel (or raises); a CPU tensor through
    :func:`stft_magphase_plain`.
    """
    _check(y, n_fft, hop_length, "stft_magphase")
    if y.device.type == "cuda":
        return _launch(y, n_fft, hop_length, phase=True)
    if y.device.type == "cpu":
        return stft_magphase_plain(y, n_fft, hop_length)
    raise ValueError(f"stft_magphase runs on cuda or cpu, not {y.device}")


def stft_magnitude(y: torch.Tensor, n_fft: int = 1024,
                   hop_length: int = 768) -> torch.Tensor:
    """Fused |STFT| of ``y (T,)`` float32 -> (n_fft//2 + 1, 1 + T//hop)
    float32, the contract of svs_tpu's Pallas ``stft_magnitude``
    (librosa-compatible: centre constant pad, periodic hann).  A CUDA tensor
    goes through the kernel (or raises); a CPU tensor through
    :func:`stft_magnitude_plain`.
    """
    _check(y, n_fft, hop_length, "stft_magnitude")
    if y.device.type == "cuda":
        return _launch(y, n_fft, hop_length, phase=False)
    if y.device.type == "cpu":
        return stft_magnitude_plain(y, n_fft, hop_length)
    raise ValueError(f"stft_magnitude runs on cuda or cpu, not {y.device}")
