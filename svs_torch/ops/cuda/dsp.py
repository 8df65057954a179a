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

Three routes, picked from ``n_fft`` alone before anything is launched
(:func:`route`), each one kernel template with a magnitude-only instance:

- ``fft`` (power-of-two ``n_fft`` from 64 to 4096, every geometry the repo
  uses): a shared-memory real FFT, ``svs_torch/csrc/stft_fft.cu``.  A
  frame's ``n_fft`` windowed samples are packed as ``n_fft/2`` complex
  values, transformed by radix-8 Stockham passes (a radix-2 or radix-4
  pass last where log2(n_fft/2) is no multiple of 3) and split into the
  ``n_fft/2 + 1`` bins.  The function is bound by its bytes (the signal
  read once, one or three planes written once): ~7.5 us at the 4-minute
  decode shape on an H100 SXM, where the FFT's ~82 MFLOP take ~1.2 us at
  the f32 peak.
- ``mixed`` (every other ``n_fft`` from 2 to 16,384, odd ones included,
  e.g. ``data_cli --win_size 1000`` or ``999``): a shared-memory FFT over a
  pass plan chosen on the host (:func:`mixed_plan`),
  ``svs_torch/csrc/stft_mixed.cu``.  An even ``n_fft`` packs a frame as
  ``n_fft/2`` complex values, an odd one packs two frames as the real and
  imaginary parts of one ``n_fft``-point sequence.  Where that length has
  no prime factor above 7, radix-8/4/2/3/5/7 passes transform it; else
  Bluestein's chirp turns it into a cyclic convolution of a power-of-two
  length L >= 2P - 1 run by the same passes.
- ``gemm`` (an even ``n_fft`` above 16,384): an implicit-framing FFMA GEMM
  against one basis whose column pairs are the cosine and sine of a bin
  (:func:`paired_basis`), ``svs_torch/csrc/stft_magphase.cu``; bound by its
  n_fft-deep f32 FMA work.  ``launch(..., via="gemm")`` also takes smaller
  ``n_fft``, which is how the two FFT routes are timed against it.  An odd
  ``n_fft`` above 16,384 is refused.

All stay true float32 (no TF32), as the TPU kernels' ``Precision.HIGHEST``;
all share the epilogue (``csrc/stft_epilogue.cuh``), so the magnitude of
``stft_magnitude`` is the same bits as ``stft_magphase``'s on every route.
The fft and mixed routes return views of rows padded to a multiple of 8
frames (:func:`launch`).

:func:`stft_magphase` and :func:`stft_magnitude` launch the route's kernel
for a CUDA tensor and take the route's plain version only for a tensor on
the CPU; a build or launch error raises.  Counts: ``launches`` and
``mag_launches`` count every launch of the two functions, ``fft_launches``,
``mixed_launches`` and ``gemm_launches`` the launches of each route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from svs_torch.ops import stft as dsp
from svs_torch.ops.cuda import build

KERNEL = "stft_fft"            # the fft route's library
MIXED_KERNEL = "stft_mixed"    # the mixed route's library
GEMM_KERNEL = "stft_magphase"  # the gemm route's library
KERNELS = (KERNEL, MIXED_KERNEL, GEMM_KERNEL)
FFT_MIN, FFT_MAX = 64, 4096    # the n_fft the fft route's kernel is built for
MIXED_MAX = 16384              # the largest n_fft of the mixed route
# the fft and mixed routes' output rows are padded to a multiple of this
# many frames: a block's 8 frames then fill one 32-byte sector of each row
_ROW_ALIGN = 8
_TAP_TILE = 16    # kBK in stft_magphase.cu: basis rows padded to a multiple
_COL_TILE = 128   # kBN in stft_magphase.cu: basis columns padded likewise

# launches of the CUDA kernels (plain-version calls are not counted):
# stft_magphase's and stft_magnitude's on any route, and each route's
launches = 0
mag_launches = 0
fft_launches = 0
mixed_launches = 0
gemm_launches = 0

_bases: Dict[Tuple[int, torch.device], torch.Tensor] = {}
_tables: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}
_mixed: Dict[Tuple[int, torch.device], Dict[str, torch.Tensor]] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def route(n_fft: int) -> str:
    """``"fft"`` for a power-of-two ``n_fft`` in [64, 4096], ``"mixed"`` for
    any other ``n_fft`` in [2, 16384], odd ones included, ``"gemm"`` for an
    even ``n_fft`` above that; anything else raises ``ValueError``."""
    if n_fft < 2:
        raise ValueError(f"bad geometry n_fft={n_fft} (n_fft must be at "
                         "least 2)")
    if FFT_MIN <= n_fft <= FFT_MAX and n_fft & (n_fft - 1) == 0:
        return "fft"
    if n_fft <= MIXED_MAX:
        return "mixed"
    if n_fft % 2 == 0:
        return "gemm"
    raise ValueError(f"odd n_fft={n_fft} above {MIXED_MAX}: the mixed route "
                     f"takes odd n_fft up to {MIXED_MAX}, the gemm route even "
                     "ones only")


def reset_counts() -> None:
    global launches, mag_launches, fft_launches, mixed_launches, gemm_launches
    launches = mag_launches = fft_launches = mixed_launches = 0
    gemm_launches = 0


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
    _check_gemm(n_fft)
    return _epilogue(*_spectrum_plain(y, n_fft, hop_length))


def stft_magnitude_plain(y: torch.Tensor, n_fft: int = 1024,
                         hop_length: int = 768) -> torch.Tensor:
    """Plain PyTorch version of the gemm route's magnitude-only kernel: the
    same framing and basis as an f32 ``torch.matmul``, then sqrt(re^2 +
    im^2) (TF32 off on the card, as :func:`stft_magphase_plain`)."""
    _check(y, n_fft, hop_length, "stft_magnitude")
    _check_gemm(n_fft)
    re, im = _spectrum_plain(y, n_fft, hop_length)
    return _magnitude(re, im)


def _check_gemm(n_fft: int) -> None:
    if n_fft % 2:
        raise ValueError(f"the gemm route takes an even n_fft, not {n_fft}")


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


# ---------------------------------------------------------------- mixed route

_PACK = 16            # about the points a thread transforms in a pass
_BLOCK_FRAMES = 8     # frames a block, where they fit
_SMEM_MAX = 232_448   # the shared memory a block may opt in to (bytes)


class MixedPlan(NamedTuple):
    """The mixed route's plan for one ``n_fft``: ``p`` points of the packed
    complex sequence (n_fft/2 for an even n_fft, a frame a sequence; n_fft
    for an odd one, two frames a sequence), ``q`` the length the passes
    transform (``p``, or Bluestein's power of two L >= 2p - 1) and the
    (radix, Ns) of each of its decimation-in-time passes."""
    n_fft: int
    p: int
    q: int
    passes: Tuple[Tuple[int, int], ...]

    @property
    def bluestein(self) -> bool:
        return self.q != self.p

    @property
    def frames_per_seq(self) -> int:
        return 2 if self.n_fft % 2 else 1


def mixed_passes(q: int) -> List[Tuple[int, int]]:
    """(radix, Ns) of each decimation-in-time pass of the kernel's q-point
    FFT, :func:`fft_passes` widened to the factors 3, 5 and 7: radix 8
    while 8 divides what is left, then one radix-2 or radix-4 pass, then
    the 3s, 5s and 7s; Ns is the product of the earlier passes' radices.
    A q with a prime factor above 7 raises ``ValueError``."""
    rest, radices = q, []
    while rest % 8 == 0:
        radices.append(8)
        rest //= 8
    if rest % 4 == 0 or rest % 2 == 0:
        radices.append(4 if rest % 4 == 0 else 2)
        rest //= radices[-1]
    for r in (3, 5, 7):
        while rest % r == 0:
            radices.append(r)
            rest //= r
    if rest != 1:
        raise ValueError(f"{q} has a prime factor above 7")
    out, ns = [], 1
    for r in radices:
        out.append((r, ns))
        ns *= r
    return out


@functools.lru_cache(maxsize=None)
def mixed_plan(n_fft: int) -> MixedPlan:
    """The pass plan of the mixed route at ``n_fft``: the packed length p's
    own passes where p is 7-smooth, else Bluestein's with the power of two
    L >= 2p - 1."""
    if route(n_fft) != "mixed":
        raise ValueError(f"the mixed route takes n_fft in [2, {MIXED_MAX}] "
                         f"that the fft route does not, not {n_fft}")
    p = n_fft // 2 if n_fft % 2 == 0 else n_fft
    try:
        return MixedPlan(n_fft, p, p, tuple(mixed_passes(p)))
    except ValueError:
        q = 1 << (2 * p - 2).bit_length()
        return MixedPlan(n_fft, p, q, tuple(mixed_passes(q)))


def dit_order(q: int, passes) -> np.ndarray:
    """(q,) int32: where the decimation-in-time passes want input point n
    so that they leave the transform in natural order, the digit reversal
    of n over the plan's radices.  The decimation-in-frequency passes of
    the mirrored plan (Bluestein's forward transform) leave bin k there."""
    n = np.arange(q)
    pos, weight = np.zeros(q, np.int64), q
    for radix, _ in reversed(passes):
        weight //= radix
        pos += (n % radix) * weight
        n = n // radix
    return pos.astype(np.int32)


def mixed_tables(n_fft: int) -> Dict[str, np.ndarray]:
    """The mixed kernel's tables, float64 rounded to f32 (pairs are (re,
    im) rows): ``window`` (n_fft,); ``tw`` (q, 2), exp(-2 pi i k / q);
    ``split`` (p, 2), exp(-2 pi i k / n_fft) for the even split step;
    ``perm`` (q,) int32, :func:`dit_order`; and for Bluestein ``chirp``
    (p, 2), exp(-i pi n^2 / p) with n^2 taken mod 2p in integers, and
    ``filt`` (q, 2), the FFT of the chirp filter conj(chirp) laid out
    circularly, over q (the inverse transform's scale), in ``perm``'s
    order.  Empty (0, 2) tables where the plan has no use for them."""
    plan = mixed_plan(n_fft)
    p, q = plan.p, plan.q

    def pairs(z: np.ndarray) -> np.ndarray:
        return np.stack([z.real, z.imag], axis=1).astype(np.float32)

    empty = np.zeros((0, 2), np.float32)
    perm = dit_order(q, plan.passes)
    out = {
        "window": hann(n_fft),
        "tw": pairs(np.exp(-2j * np.pi * np.arange(q) / q)),
        "split": (pairs(np.exp(-2j * np.pi * np.arange(p) / n_fft))
                  if n_fft % 2 == 0 else empty),
        "perm": perm,
        "chirp": empty,
        "filt": empty,
    }
    if plan.bluestein:
        n2 = np.arange(p, dtype=np.int64) ** 2 % (2 * p)
        chirp = np.exp(-1j * np.pi * n2 / p)
        b = np.zeros(q, np.complex128)
        b[:p] = np.conj(chirp)
        b[q - p + 1:] = np.conj(chirp[1:])[::-1]
        filt = np.empty(q, np.complex128)
        filt[perm] = np.fft.fft(b) / q
        out["chirp"], out["filt"] = pairs(chirp), pairs(filt)
    return out


def _device_mixed(n_fft: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The mixed kernel's tables on ``device``, uploaded once per (n_fft,
    device)."""
    key = (n_fft, device)
    if key not in _mixed:
        _mixed[key] = {k: torch.from_numpy(v).to(device)
                       for k, v in mixed_tables(n_fft).items()}
    return _mixed[key]


def seq_pairs(q: int) -> int:
    """(re, im) pairs from one sequence's plane to the next in the kernel:
    point i lives at i + i/16, so strided passes spread over the banks, and
    the count is odd, so the epilogue's reads of one bin across sequences
    fall in different banks."""
    return (q + q // 16) | 1


class MixedGeometry(NamedTuple):
    """A mixed launch's shape: ``threads`` a sequence, ``seqs`` sequences a
    block, ``smem`` dynamic shared memory a block (bytes), ``scratch``,
    whether the planes outgrow it and live in device memory instead, and
    ``staged``, whether the frames' signal span fits beside the planes."""
    threads: int
    seqs: int
    smem: int
    scratch: bool
    staged: bool


@functools.lru_cache(maxsize=None)
def mixed_geometry(plan: MixedPlan, hop_length: int) -> MixedGeometry:
    """The launch shape the mixed kernel takes at ``plan``, with its shared
    memory as ``stft_mixed.cu``'s ``dispatch`` computes it: about 16 of
    the q points a thread, and as many sequences a block as give 8 frames
    (the fft route's block at n_fft 1024) within 1,024 threads and a
    block's 227 KB; the planes first, then the frames' signal span where
    it fits.  Only the planes of Bluestein's L = 32,768 (an odd n_fft
    above 8,192 with a prime factor above 7) outgrow a block's 227 KB; they
    live in a device-memory scratch."""
    threads = min(1024, max(32, _cdiv(_cdiv(plan.q, _PACK), 32) * 32))
    scratch = 8 * seq_pairs(plan.q) > _SMEM_MAX
    stride = min(hop_length, plan.n_fft)

    def sizes(seqs: int) -> Tuple[int, bool]:
        planes = 0 if scratch else 8 * seqs * seq_pairs(plan.q)
        span = 4 * ((seqs * plan.frames_per_seq - 1) * stride + plan.n_fft)
        staged = planes + span <= _SMEM_MAX
        return (planes + span if staged else planes), staged

    seqs = max(1, min(_BLOCK_FRAMES // plan.frames_per_seq, 1024 // threads))
    while seqs > 1 and sizes(seqs)[0] > _SMEM_MAX:
        seqs -= 1
    smem, staged = sizes(seqs)
    if smem > _SMEM_MAX:
        raise ValueError(f"n_fft={plan.n_fft} hop={hop_length} needs {smem} "
                         f"bytes of shared memory a block, more than "
                         f"{_SMEM_MAX}")
    return MixedGeometry(threads, seqs, smem, scratch, staged)


_C = {r: (np.cos(2 * np.pi * np.arange(r) / r).astype(np.float32),
          np.sin(2 * np.pi * np.arange(r) / r).astype(np.float32))
      for r in (3, 5, 7)}


def _odd_dft(radix: int, r, i):
    """radix-point DFT (3, 5 or 7) of lists ``r``, ``i``, the kernel's
    ``dft_odd``: the sums and differences of points j and radix - j, then
    each pair of outputs k, radix - k from one cosine and one sine sum."""
    cos, sin = _C[radix]
    h = (radix - 1) // 2
    sr = [r[j] + r[radix - j] for j in range(1, h + 1)]
    si = [i[j] + i[radix - j] for j in range(1, h + 1)]
    dr = [r[j] - r[radix - j] for j in range(1, h + 1)]
    di = [i[j] - i[radix - j] for j in range(1, h + 1)]
    yr, yi = [None] * radix, [None] * radix
    yr[0], yi[0] = r[0], i[0]
    for j in range(h):
        yr[0], yi[0] = yr[0] + sr[j], yi[0] + si[j]
    for k in range(1, h + 1):
        ar, ai, br, bi = r[0], i[0], 0.0, 0.0
        for j in range(1, h + 1):
            c, s = float(cos[j * k % radix]), float(sin[j * k % radix])
            ar, ai = ar + c * sr[j - 1], ai + c * si[j - 1]
            br, bi = br + s * dr[j - 1], bi + s * di[j - 1]
        yr[k], yi[k] = ar + bi, ai - br
        yr[radix - k], yi[radix - k] = ar - bi, ai + br
    return yr, yi


def _mixed_butterfly(radix: int, r, i):
    return _odd_dft(radix, r, i) if radix % 2 else _butterfly(radix, r, i)


def _cmul(ar, ai, w):
    return ar * w[:, 0] - ai * w[:, 1], ar * w[:, 1] + ai * w[:, 0]


def _run_passes(zr, zi, passes, tw, dit: bool):
    """The kernel's ``run_passes`` over rows of (n, q) planes, in place at
    g Ns R + r Ns + b for butterfly b of block g.  Decimation in time (the
    plan's passes in order, digit-reversed in, natural order out) turns
    point r by W_{Ns R}^{r b} before the R-point DFT; decimation in
    frequency (the passes last to first, natural in, :func:`dit_order`
    out) turns output r after it."""
    n, q = zr.shape
    for radix, ns in (passes if dit else reversed(passes)):
        g = q // (ns * radix)
        vr = list(zr.reshape(n, g, radix, ns).unbind(2))
        vi = list(zi.reshape(n, g, radix, ns).unbind(2))
        w = [tw[r * torch.arange(ns, device=zr.device) * g]
             for r in range(radix)]
        if dit and ns > 1:
            for r in range(1, radix):
                vr[r], vi[r] = _cmul(vr[r], vi[r], w[r])
        vr, vi = _mixed_butterfly(radix, vr, vi)
        if not dit and ns > 1:
            for r in range(1, radix):
                vr[r], vi[r] = _cmul(vr[r], vi[r], w[r])
        zr = torch.stack(vr, 2).reshape(n, q)
        zi = torch.stack(vi, 2).reshape(n, q)
    return zr, zi


def _spectrum_mixed_plain(y: torch.Tensor, n_fft: int, hop_length: int):
    """re, im (n_fft//2 + 1, n_frames) by the mixed kernel's arithmetic,
    step by step in f32 tensor ops (no ``torch.fft``): window and pack,
    the passes (Bluestein's chirp, forward passes, filter and inverse
    passes where the plan says), the split step."""
    plan = mixed_plan(n_fft)
    t = _device_mixed(n_fft, y.device)
    p, q = plan.p, plan.q
    xw = _frames(y, n_fft, hop_length) * t["window"]  # (n_frames, n_fft)
    n_frames = xw.shape[0]
    if n_fft % 2 == 0:
        zr, zi = xw[:, 0::2], xw[:, 1::2]   # z[n] = x[2n] + i x[2n+1]
    else:
        # frames 2s and 2s+1 as one sequence; an odd count pairs the last
        # frame with zeros
        xw = F.pad(xw, (0, 0, 0, n_frames % 2))
        zr, zi = xw[0::2], xw[1::2]
    n = zr.shape[0]
    if plan.bluestein:
        zr, zi = _cmul(zr, zi, t["chirp"])
        zr, zi = F.pad(zr, (0, q - p)), F.pad(zi, (0, q - p))
        zr, zi = _run_passes(zr, zi, plan.passes, t["tw"], dit=False)
        zr, zi = _cmul(zr, zi, t["filt"])
        # conjugated, the forward passes give the inverse, conjugated
        zr, zi = _run_passes(zr, -zi, plan.passes, t["tw"], dit=True)
        # Z[k] = chirp[k] conj(w[k])
        zr, zi = _cmul(zr[:, :p], -zi[:, :p], t["chirp"])
    else:
        perm = t["perm"].long()
        pr, pi = zr.new_empty(n, q), zi.new_empty(n, q)
        pr[:, perm], pi[:, perm] = zr, zi
        zr, zi = _run_passes(pr, pi, plan.passes, t["tw"], dit=True)
    if n_fft % 2 == 0:
        # split: X[k] = E[k] + W^k O[k], as the fft route's
        k = torch.arange(1, p, device=y.device)
        ar, ai, br, bi = zr[:, k], zi[:, k], zr[:, p - k], zi[:, p - k]
        er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
        orr, oi = 0.5 * (ai + bi), 0.5 * (br - ar)
        w = t["split"][k]
        xr = er + (w[:, 0] * orr - w[:, 1] * oi)
        xi = ei + (w[:, 0] * oi + w[:, 1] * orr)
        r0, i0 = zr[:, :1], zi[:, :1]
        zero = torch.zeros_like(r0)
        re = torch.cat([r0 + i0, xr, r0 - i0], 1)
        im = torch.cat([zero, xi, zero], 1)
    else:
        # X_a[k] = (Z[k] + conj Z[p-k]) / 2, X_b[k] = (Z[k] - conj Z[p-k]) / 2i
        k = torch.arange(n_fft // 2 + 1, device=y.device)
        pk = (p - k) % p
        ar, ai, br, bi = zr[:, k], zi[:, k], zr[:, pk], zi[:, pk]
        re = torch.stack([0.5 * (ar + br), 0.5 * (ai + bi)], 1)
        im = torch.stack([0.5 * (ai - bi), 0.5 * (br - ar)], 1)
        re = re.reshape(2 * n, -1)[:n_frames]
        im = im.reshape(2 * n, -1)[:n_frames]
    return re.T.contiguous(), im.T.contiguous()   # dense (n_bins, n_frames)


def stft_magphase_mixed_plain(y: torch.Tensor, n_fft: int = 1000,
                              hop_length: int = 250):
    """Plain PyTorch version of the mixed route's kernel: its packing, pass
    plan, Bluestein steps, split step and epilogue in f32 tensor ops, from
    the kernel's own f32 tables."""
    _check(y, n_fft, hop_length, "stft_magphase")
    return _epilogue(*_spectrum_mixed_plain(y, n_fft, hop_length))


def stft_magnitude_mixed_plain(y: torch.Tensor, n_fft: int = 1000,
                               hop_length: int = 250) -> torch.Tensor:
    """Plain PyTorch version of the mixed route's magnitude-only kernel."""
    _check(y, n_fft, hop_length, "stft_magnitude")
    re, im = _spectrum_mixed_plain(y, n_fft, hop_length)
    return _magnitude(re, im)


# ------------------------------------------------------------------ wrappers


def plain_for(n_fft: int, phase: bool):
    """The plain version of the route that ``n_fft`` selects."""
    via = route(n_fft)
    if via == "fft":
        return stft_magphase_fft_plain if phase else stft_magnitude_fft_plain
    if via == "mixed":
        return (stft_magphase_mixed_plain if phase
                else stft_magnitude_mixed_plain)
    return stft_magphase_plain if phase else stft_magnitude_plain


def _check(y: torch.Tensor, n_fft: int, hop_length: int, name: str) -> None:
    if y.ndim != 1:
        raise ValueError(f"{name} expects a 1-D signal")
    if y.dtype != torch.float32:
        raise TypeError(f"{name} expects float32, got {y.dtype}")
    if n_fft < 2 or hop_length < 1:
        raise ValueError(f"bad geometry n_fft={n_fft} hop={hop_length} "
                         "(n_fft must be at least 2, hop at least 1)")


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


def _frame_count(n_samples: int, n_fft: int, hop_length: int) -> int:
    """Frames of a signal centre-padded by n_fft//2 a side (dsp.py:87-89):
    1 + T // hop for an even n_fft, 1 + (T - 1) // hop for an odd one."""
    return 1 + (n_samples + 2 * (n_fft // 2) - n_fft) // hop_length


def _launch_mixed(fn, y, n_fft: int, hop_length: int, n_frames: int,
                  ld: int, outs) -> int:
    """One launch of the mixed kernel ``fn``; returns its CUDA error."""
    plan = mixed_plan(n_fft)
    geo = mixed_geometry(plan, hop_length)
    t = _device_mixed(n_fft, y.device)
    n_blocks = _cdiv(n_frames, geo.seqs * plan.frames_per_seq)
    grid, scratch = n_blocks, None
    if geo.scratch:
        # one plane pair a block in device memory, a block an SM
        grid = min(n_blocks, torch.cuda.get_device_properties(
            y.device).multi_processor_count)
        scratch = torch.empty((grid * seq_pairs(plan.q), 2),
                              dtype=torch.float32, device=y.device)
    radices = (ctypes.c_int * max(1, len(plan.passes)))(
        *[r for r, _ in plan.passes])
    return fn(y.data_ptr(), y.shape[0], t["window"].data_ptr(),
              t["tw"].data_ptr(), t["split"].data_ptr(),
              t["chirp"].data_ptr(), t["filt"].data_ptr(),
              t["perm"].data_ptr(),
              0 if scratch is None else scratch.data_ptr(),
              ctypes.addressof(radices), len(plan.passes), n_fft, plan.q,
              geo.seqs, geo.threads, grid, hop_length, n_frames, ld,
              *[o.data_ptr() for o in outs],
              torch.cuda.current_stream(y.device).cuda_stream)


def launch(y: torch.Tensor, n_fft: int, hop_length: int, phase: bool,
           via: str):
    """One launch of route ``via``'s kernel (``"fft"``, ``"mixed"`` or
    ``"gemm"``) on a CUDA tensor; returns ``mag`` and, with ``phase``, the
    phase planes.  The wrappers pass ``route(n_fft)``; the gemm route also
    takes any smaller even ``n_fft``, which is how its time is compared.

    The fft and mixed routes write rows padded to a multiple of 8 frames
    and return the ``(..., n_frames)`` views: each block's stores then fill
    whole 32-byte sectors, which an odd ``n_frames`` row pitch would split
    (2.6x the fft kernel's time at hop 256, where the planes outgrow L2).
    ``.contiguous()`` gives dense tensors where one is needed."""
    global launches, mag_launches, fft_launches, mixed_launches, gemm_launches
    name = "stft_magphase" if phase else "stft_magnitude"
    _check(y, n_fft, hop_length, name)
    if via == "fft":
        _check_fft(n_fft)
    elif via == "mixed":
        mixed_plan(n_fft)
    elif via == "gemm":
        _check_gemm(n_fft)
    else:
        raise ValueError(f"unknown route {via!r}; expected fft, mixed or "
                         "gemm")
    if y.device.type != "cuda" or not y.is_contiguous():
        raise ValueError(f"{name} launches on a contiguous CUDA signal")
    n_bins = n_fft // 2 + 1
    n_frames = _frame_count(y.shape[0], n_fft, hop_length)
    ld = (n_frames if via == "gemm"
          else _cdiv(n_frames, _ROW_ALIGN) * _ROW_ALIGN)
    mag = torch.empty((n_bins, ld), dtype=torch.float32, device=y.device)
    outs = [mag]
    if phase:
        outs.append(torch.empty((2, n_bins, ld), dtype=torch.float32,
                                device=y.device))
    with torch.cuda.device(y.device):
        if via == "mixed":
            fn = _kernel_fn(MIXED_KERNEL, f"svs_stft_mixed_{name[5:]}", 8, 9)
            rc = _launch_mixed(fn, y, n_fft, hop_length, n_frames, ld, outs)
        else:
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
            rc = fn(y.data_ptr(), y.shape[0], *args,
                    *[o.data_ptr() for o in outs], stream)
    if rc != 0:
        raise RuntimeError(f"{name} ({via}) kernel launch failed: CUDA "
                           f"error {rc}")
    if via == "fft":
        fft_launches += 1
    elif via == "mixed":
        mixed_launches += 1
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

    On the fft and mixed routes the CUDA results are strided views of rows
    padded to a multiple of 8 frames (``stride(-2)`` is that pitch, not
    ``n_frames``); take ``.contiguous()`` before ``.view()`` or handing
    ``.data_ptr()`` to code that assumes dense rows.  CPU results are
    dense.
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
    """Fused |STFT| of ``y (T,)`` float32 -> (n_fft//2 + 1, n_frames)
    float32 (1 + T//hop frames, 1 + (T - 1)//hop at an odd n_fft), the
    contract of svs_tpu's Pallas ``stft_magnitude`` (librosa-compatible:
    centre constant pad, periodic hann).  A CUDA
    tensor goes through the kernel of :func:`route`'s choice (or raises); a
    CPU tensor through that route's plain version.  On the fft and mixed
    routes the CUDA result is a strided view of padded rows, as
    :func:`stft_magphase`'s.
    """
    _check(y, n_fft, hop_length, "stft_magnitude")
    via = route(n_fft)
    if y.device.type == "cuda":
        return launch(y, n_fft, hop_length, False, via)
    if y.device.type == "cpu":
        return plain_for(n_fft, False)(y, n_fft, hop_length)
    raise ValueError(f"stft_magnitude runs on cuda or cpu, not {y.device}")
