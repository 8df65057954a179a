"""Fused STFT front end: the CUDA kernels' wrappers and their plain PyTorch
versions.

Replaces two TPU kernels of ``svs_tpu/ops/pallas/dsp.py``:

- ``stft_magphase`` (``_stft_magphase_kernel``, pallas_call at dsp.py:203):
  centre constant pad, periodic-hann windowed real DFT in true float32,
  ``mag (n_bins, n_frames)`` and unit phase ``(2, n_bins, n_frames)``
  real/imag planes, phase 1+0j where mag <= 1e-30 (librosa.magphase
  contract, reference data.py:80);
- ``stft_magnitude`` (``_stft_mag_kernel``, pallas_call at dsp.py:134): the
  same front end, ``mag`` alone (the ``bench_cli --frontend`` path).

Two routes, picked from ``n_fft`` alone before anything is launched
(:func:`route`), each one kernel template with a magnitude-only instance:

- ``fft`` (power-of-two ``n_fft`` from 64 to 4096, every geometry the repo
  uses): a shared-memory real FFT, ``svs_torch/csrc/stft_fft.cu``.  A
  frame's ``n_fft`` windowed samples are packed as ``n_fft/2`` complex
  values, transformed by radix-8 Stockham passes (a radix-2 or radix-4
  pass last where log2(n_fft/2) is no multiple of 3) and split into the
  ``n_fft/2 + 1`` bins.  The function is bound by its bytes (the signal
  read once, one or three planes written once): ~7.5 us at the 4-minute
  decode shape on an H100 SXM, where the FFT's ~82 MFLOP take ~1.2 us at
  the f32 peak.  Its outputs are views of rows padded to a multiple of 8
  frames (:func:`launch`).
- ``gemm`` (any other even ``n_fft``, e.g. ``data_cli --win_size 1000``):
  an implicit-framing FFMA GEMM against one basis whose column pairs are
  the cosine and sine of a bin (:func:`paired_basis`),
  ``svs_torch/csrc/stft_magphase.cu``; bound by its n_fft-deep f32 FMA
  work (~86 us at the decode shape).

Both stay true float32 (no TF32), as the TPU kernels'
``Precision.HIGHEST``; both share the epilogue
(``csrc/stft_epilogue.cuh``), so the magnitude of ``stft_magnitude`` is
the same bits as ``stft_magphase``'s on either route.

:func:`stft_magphase` and :func:`stft_magnitude` launch the route's kernel
for a CUDA tensor and take the route's plain version only for a tensor on
the CPU; a build or launch error raises.  Counts: ``launches`` and
``mag_launches`` count every launch of the two functions, ``fft_launches``
and ``gemm_launches`` the launches of each route.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from svs_torch.ops import stft as dsp
from svs_torch.ops.cuda import build

KERNEL = "stft_fft"            # the fft route's library
GEMM_KERNEL = "stft_magphase"  # the gemm route's library
KERNELS = (KERNEL, GEMM_KERNEL)
FFT_MIN, FFT_MAX = 64, 4096    # the n_fft the fft route's kernel is built for
# the fft route's output rows are padded to a multiple of this many frames:
# a block's 8 frames then fill one 32-byte sector of each row
_ROW_ALIGN = 8
_TAP_TILE = 16    # kBK in stft_magphase.cu: basis rows padded to a multiple
_COL_TILE = 128   # kBN in stft_magphase.cu: basis columns padded likewise

# launches of the CUDA kernels (plain-version calls are not counted):
# stft_magphase's and stft_magnitude's on either route, and each route's
launches = 0
mag_launches = 0
fft_launches = 0
gemm_launches = 0

_bases: Dict[Tuple[int, torch.device], torch.Tensor] = {}
_tables: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def route(n_fft: int) -> str:
    """``"fft"`` for a power-of-two ``n_fft`` in [64, 4096], ``"gemm"`` for
    any other even ``n_fft``; an odd one raises ``ValueError``."""
    if n_fft < 2 or n_fft % 2:
        raise ValueError(f"bad geometry n_fft={n_fft} (n_fft must be even)")
    if FFT_MIN <= n_fft <= FFT_MAX and n_fft & (n_fft - 1) == 0:
        return "fft"
    return "gemm"


def reset_counts() -> None:
    global launches, mag_launches, fft_launches, gemm_launches
    launches = mag_launches = fft_launches = gemm_launches = 0


# ----------------------------------------------------------------- gemm route


def windowed_dft(n_fft: int):
    """(n_fft, n_fft//2 + 1) cos / -sin bases with the periodic hann window
    folded in: the numbers of svs_tpu's ``_windowed_dft`` (dsp.py:46-62),
    without its hop chunking and padding."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    f = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * t * f / n_fft
    w = hann(n_fft)[:, None]
    cos = (np.cos(ang) * w).astype(np.float32)
    sin = (-np.sin(ang) * w).astype(np.float32)  # rfft sign convention
    return cos, sin


def paired_basis(n_fft: int) -> np.ndarray:
    """The gemm kernel's (n_taps, n_cols) basis: columns 2b and 2b+1 are the
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


def _magnitude(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """sqrt(re^2 + im^2) with the f32 square root correctly rounded, as the
    kernels' ``sqrtf``: taken in float64 and rounded once.  PyTorch's f32
    ``sqrt`` on an AVX-512 CPU build is off by one ulp in under 1 % of its
    outputs (tests/test_torch_fft_frontend.py)."""
    return torch.sqrt((re * re + im * im).double()).float()


def _epilogue(re: torch.Tensor, im: torch.Tensor):
    """mag and unit phase from re/im (dsp.py:165-174)."""
    mag = _magnitude(re, im)
    nz = mag > 1e-30
    inv = torch.where(nz, 1.0 / torch.where(nz, mag, torch.ones_like(mag)),
                      torch.zeros_like(mag))
    pre = torch.where(nz, re * inv, torch.ones_like(mag))
    pim = im * inv
    return mag, torch.stack([pre, pim])


def _frames(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(n_frames, n_fft) frames of ``y`` centre-padded by n_fft/2 a side."""
    return dsp.frame_signal(F.pad(y, (n_fft // 2, n_fft // 2)), n_fft,
                            hop_length)


def _spectrum_plain(y: torch.Tensor, n_fft: int, hop_length: int):
    """re, im of the gemm kernel's product done as an f32 ``torch.matmul``:
    the same framing and basis."""
    basis = _device_basis(n_fft, y.device)
    frames = _frames(y, n_fft, hop_length)
    cols = torch.matmul(frames, basis[:n_fft, :n_fft]).T  # (n_fft, n_frames)
    return unpair(cols, n_fft)


def stft_magphase_plain(y: torch.Tensor, n_fft: int = 1024,
                        hop_length: int = 768):
    """Plain PyTorch version of the gemm route: the same framing, the same
    basis as an f32 ``torch.matmul``, the same epilogue.  On the card this
    needs ``torch.backends.cuda.matmul.allow_tf32 = False`` to stay true
    f32.  Any even ``n_fft``: it is also the function's reference."""
    _check(y, n_fft, hop_length, "stft_magphase")
    return _epilogue(*_spectrum_plain(y, n_fft, hop_length))


def stft_magnitude_plain(y: torch.Tensor, n_fft: int = 1024,
                         hop_length: int = 768) -> torch.Tensor:
    """Plain PyTorch version of the gemm route's magnitude-only kernel: the
    same framing and basis as an f32 ``torch.matmul``, then sqrt(re^2 +
    im^2) (TF32 off on the card, as :func:`stft_magphase_plain`)."""
    _check(y, n_fft, hop_length, "stft_magnitude")
    re, im = _spectrum_plain(y, n_fft, hop_length)
    return _magnitude(re, im)


# ------------------------------------------------------------------ fft route


def hann(n_fft: int) -> np.ndarray:
    """The periodic hann window, computed in float64 and rounded to f32
    (svs_tpu's dsp.py:55-56)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
            ).astype(np.float32)


def fft_tables(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """The fft kernel's tables, float64 rounded to f32: the window
    ``(n_fft,)`` and the twiddles ``(n_fft, 2)``, row k = (cos, -sin) of
    2 pi k / n_fft, that is exp(-2 pi i k / n_fft), rfft's sign."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)
    return hann(n_fft), tw


def fft_passes(m: int) -> List[Tuple[int, int]]:
    """(radix, Ns) of each Stockham pass of the kernel's m-point complex
    FFT: radix 8 while 8 divides what is left, then one radix-2 or
    radix-4 pass; Ns is the product of the earlier passes' radices."""
    out, ns = [], 1
    while ns < m:
        r = min(8, m // ns)
        out.append((r, ns))
        ns *= r
    return out


def _device_tables(n_fft: int, device: torch.device):
    """The window and twiddles on ``device``, uploaded once per (n_fft,
    device)."""
    key = (n_fft, device)
    if key not in _tables:
        _tables[key] = tuple(torch.from_numpy(t).to(device)
                             for t in fft_tables(n_fft))
    return _tables[key]


_SQRT_HALF = float(np.float32(np.sqrt(0.5)))


def _fft2(ar, ai, br, bi):
    return ar + br, ai + bi, ar - br, ai - bi


def _fft4(r, i):
    """4-point DFT of lists ``r``, ``i`` (natural order in and out), the
    kernel's ``fft4``."""
    r0, i0, r2, i2 = _fft2(r[0], i[0], r[2], i[2])
    r1, i1, r3, i3 = _fft2(r[1], i[1], r[3], i[3])
    r3, i3 = i3, -r3                                  # * -i
    r0, i0, r1, i1 = _fft2(r0, i0, r1, i1)            # U0, U2
    r2, i2, r3, i3 = _fft2(r2, i2, r3, i3)            # U1, U3
    return [r0, r2, r1, r3], [i0, i2, i1, i3]


def _fft8(r, i):
    """8-point DFT, the kernel's ``fft8``: a radix-2 split into two 4-point
    DFTs, the odd half turned by W8^1, W8^2 = -i, W8^3."""
    r, i = list(r), list(i)
    for k in range(4):
        r[k], i[k], r[k + 4], i[k + 4] = _fft2(r[k], i[k], r[k + 4],
                                               i[k + 4])
    c = _SQRT_HALF
    r[5], i[5] = c * (r[5] + i[5]), c * (i[5] - r[5])
    r[6], i[6] = i[6], -r[6]
    r[7], i[7] = c * (i[7] - r[7]), -c * (r[7] + i[7])
    ar, ai = _fft4(r[:4], i[:4])
    br, bi = _fft4(r[4:], i[4:])
    return ([x for pair in zip(ar, br) for x in pair],
            [x for pair in zip(ai, bi) for x in pair])


def _butterfly(radix: int, r, i):
    if radix == 8:
        return _fft8(r, i)
    if radix == 4:
        return _fft4(r, i)
    r0, i0, r1, i1 = _fft2(r[0], i[0], r[1], i[1])
    return [r0, r1], [i0, i1]


def _spectrum_fft_plain(y: torch.Tensor, n_fft: int, hop_length: int):
    """re, im (n_fft//2 + 1, n_frames) by the fft kernel's arithmetic, step
    by step in f32 tensor ops (no ``torch.fft``): window and pack, the
    Stockham passes as reshapes and twiddle multiplies, the split step."""
    window, tw = _device_tables(n_fft, y.device)
    m = n_fft // 2
    xw = _frames(y, n_fft, hop_length) * window       # (n_frames, n_fft)
    nf = xw.shape[0]
    zr, zi = xw[:, 0::2], xw[:, 1::2]                 # z[n] = x[2n] + i x[2n+1]
    for radix, ns in fft_passes(m):
        # butterfly j reads z[j + r*m/radix]; j = a*ns + b
        vr = list(zr.reshape(nf, radix, m // radix).unbind(1))
        vi = list(zi.reshape(nf, radix, m // radix).unbind(1))
        if ns > 1:
            b = torch.arange(m // radix, device=y.device) % ns
            for r in range(1, radix):
                w = tw[r * b * (n_fft // (ns * radix))]
                vr[r], vi[r] = (vr[r] * w[:, 0] - vi[r] * w[:, 1],
                                vr[r] * w[:, 1] + vi[r] * w[:, 0])
        vr, vi = _butterfly(radix, vr, vi)
        # output r of butterfly j goes to a*ns*radix + r*ns + b
        shape = (nf, m // (ns * radix), ns)
        zr = torch.stack([v.reshape(shape) for v in vr], 2).reshape(nf, m)
        zi = torch.stack([v.reshape(shape) for v in vi], 2).reshape(nf, m)
    # split: X[k] = E[k] + W^k O[k] with E, O the even and odd samples' DFTs
    k = torch.arange(1, m, device=y.device)
    ar, ai, br, bi = zr[:, k], zi[:, k], zr[:, m - k], zi[:, m - k]
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    orr, oi = 0.5 * (ai + bi), 0.5 * (br - ar)
    wr, wi = tw[k, 0], tw[k, 1]
    xr = er + (wr * orr - wi * oi)
    xi = ei + (wr * oi + wi * orr)
    r0, i0 = zr[:, :1], zi[:, :1]
    zero = torch.zeros_like(r0)
    re = torch.cat([r0 + i0, xr, r0 - i0], 1)
    im = torch.cat([zero, xi, zero], 1)
    return re.T.contiguous(), im.T.contiguous()   # dense (n_bins, n_frames)


def stft_magphase_fft_plain(y: torch.Tensor, n_fft: int = 1024,
                            hop_length: int = 768):
    """Plain PyTorch version of the fft route's kernel: its packing, radix
    passes, split step and epilogue in f32 tensor ops, from the same f32
    window and twiddle tables."""
    _check(y, n_fft, hop_length, "stft_magphase")
    _check_fft(n_fft)
    return _epilogue(*_spectrum_fft_plain(y, n_fft, hop_length))


def stft_magnitude_fft_plain(y: torch.Tensor, n_fft: int = 1024,
                             hop_length: int = 768) -> torch.Tensor:
    """Plain PyTorch version of the fft route's magnitude-only kernel."""
    _check(y, n_fft, hop_length, "stft_magnitude")
    _check_fft(n_fft)
    re, im = _spectrum_fft_plain(y, n_fft, hop_length)
    return _magnitude(re, im)


def _check_fft(n_fft: int) -> None:
    if route(n_fft) != "fft":
        raise ValueError(f"the fft route takes a power-of-two n_fft in "
                         f"[{FFT_MIN}, {FFT_MAX}], not {n_fft}")


# ------------------------------------------------------------------ wrappers


def plain_for(n_fft: int, phase: bool):
    """The plain version of the route that ``n_fft`` selects."""
    if route(n_fft) == "fft":
        return stft_magphase_fft_plain if phase else stft_magnitude_fft_plain
    return stft_magphase_plain if phase else stft_magnitude_plain


def _check(y: torch.Tensor, n_fft: int, hop_length: int, name: str) -> None:
    if y.ndim != 1:
        raise ValueError(f"{name} expects a 1-D signal")
    if y.dtype != torch.float32:
        raise TypeError(f"{name} expects float32, got {y.dtype}")
    if n_fft < 2 or n_fft % 2 or hop_length < 1:
        raise ValueError(f"bad geometry n_fft={n_fft} hop={hop_length} "
                         "(n_fft must be even)")


def _kernel_fn(lib: str, name: str, n_tables: int, n_ints: int):
    """The C entry point ``name`` of library ``lib``: a signal pointer, its
    length, ``n_tables`` table pointers, ``n_ints`` ints, then the output
    pointers and the stream; built and typed on first use (every pointer
    and the stream as c_void_p, so ctypes never cuts them to 32 bits)."""
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:
        n_outputs = 2 if name.endswith("magphase") else 1
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * n_tables
                       + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p] * (n_outputs + 1))
    return fn


def launch(y: torch.Tensor, n_fft: int, hop_length: int, phase: bool,
           via: str):
    """One launch of route ``via``'s kernel (``"fft"`` or ``"gemm"``) on a
    CUDA tensor; returns ``mag`` and, with ``phase``, the phase planes.
    The wrappers pass ``route(n_fft)``; the gemm route also takes a
    power-of-two ``n_fft``, which is how its time is compared.

    The fft route writes rows padded to a multiple of 8 frames and returns
    the ``(..., n_frames)`` views: each block's stores then fill whole
    32-byte sectors, which an odd ``n_frames`` row pitch would split
    (2.6x the kernel's time at hop 256, where the planes outgrow L2).
    ``.contiguous()`` gives dense tensors where one is needed."""
    global launches, mag_launches, fft_launches, gemm_launches
    name = "stft_magphase" if phase else "stft_magnitude"
    _check(y, n_fft, hop_length, name)
    if via == "fft":
        _check_fft(n_fft)
    elif via != "gemm":
        raise ValueError(f"unknown route {via!r}; expected fft or gemm")
    if y.device.type != "cuda" or not y.is_contiguous():
        raise ValueError(f"{name} launches on a contiguous CUDA signal")
    n_bins = n_fft // 2 + 1
    # frames of the signal centre-padded by n_fft/2 a side (dsp.py:87-89)
    n_frames = 1 + y.shape[0] // hop_length
    ld = (_cdiv(n_frames, _ROW_ALIGN) * _ROW_ALIGN if via == "fft"
          else n_frames)
    mag = torch.empty((n_bins, ld), dtype=torch.float32, device=y.device)
    outs = [mag]
    if phase:
        outs.append(torch.empty((2, n_bins, ld), dtype=torch.float32,
                                device=y.device))
    if via == "fft":
        window, tw = _device_tables(n_fft, y.device)
        fn = _kernel_fn(KERNEL, f"svs_stft_fft_{name[5:]}", 2, 4)
        args = (window.data_ptr(), tw.data_ptr(), n_fft, hop_length,
                n_frames, ld)
    else:
        basis = _device_basis(n_fft, y.device)
        fn = _kernel_fn(GEMM_KERNEL, f"svs_{name}", 1, 6)
        args = (basis.data_ptr(), basis.shape[0], basis.shape[1],
                hop_length, n_fft // 2, n_bins, n_frames)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        rc = fn(y.data_ptr(), y.shape[0], *args,
                *[o.data_ptr() for o in outs], stream)
    if rc != 0:
        raise RuntimeError(f"{name} ({via}) kernel launch failed: CUDA "
                           f"error {rc}")
    if via == "fft":
        fft_launches += 1
    else:
        gemm_launches += 1
    outs = [o[..., :n_frames] for o in outs]
    if phase:
        launches += 1
        return tuple(outs)
    mag_launches += 1
    return outs[0]


def stft_magphase(y: torch.Tensor, n_fft: int = 1024, hop_length: int = 768):
    """Fused STFT + librosa.magphase of ``y (T,)`` float32.

    Returns ``(mag (n_bins, n_frames), phase_ri (2, n_bins, n_frames))``
    float32, the contract of svs_tpu's Pallas ``stft_magphase``.  A CUDA
    tensor goes through the kernel of :func:`route`'s choice (or raises); a
    CPU tensor through that route's plain version.

    On the fft route the CUDA results are strided views of rows padded to a
    multiple of 8 frames (``stride(-2)`` is that pitch, not ``n_frames``);
    take ``.contiguous()`` before ``.view()`` or handing ``.data_ptr()``
    to code that assumes dense rows.  CPU results are dense.
    """
    _check(y, n_fft, hop_length, "stft_magphase")
    via = route(n_fft)
    if y.device.type == "cuda":
        return launch(y, n_fft, hop_length, True, via)
    if y.device.type == "cpu":
        return plain_for(n_fft, True)(y, n_fft, hop_length)
    raise ValueError(f"stft_magphase runs on cuda or cpu, not {y.device}")


def stft_magnitude(y: torch.Tensor, n_fft: int = 1024,
                   hop_length: int = 768) -> torch.Tensor:
    """Fused |STFT| of ``y (T,)`` float32 -> (n_fft//2 + 1, 1 + T//hop)
    float32, the contract of svs_tpu's Pallas ``stft_magnitude``
    (librosa-compatible: centre constant pad, periodic hann).  A CUDA
    tensor goes through the kernel of :func:`route`'s choice (or raises); a
    CPU tensor through that route's plain version.  On the fft route the
    CUDA result is a strided view of padded rows, as
    :func:`stft_magphase`'s.
    """
    _check(y, n_fft, hop_length, "stft_magnitude")
    via = route(n_fft)
    if y.device.type == "cuda":
        return launch(y, n_fft, hop_length, False, via)
    if y.device.type == "cpu":
        return plain_for(n_fft, False)(y, n_fft, hop_length)
    raise ValueError(f"stft_magnitude runs on cuda or cpu, not {y.device}")
