"""What the two MR-STFT loss kernels share: geometry, bases, padding, the
limits of the CUDA kernels, the plain versions of their GEMMs, and the fold
back to the waveform.

Both ``diff_mag.spectral_mag`` and ``fused_loss.loss_partials`` compute the
reflect-padded, centred-hann windowed real DFT of (B, T) waveforms with
bfloat16 operands and float32 accumulation (the numerics of svs_tpu's
Pallas kernels ``ops/pallas/diff_mag.py`` and ``ops/pallas/fused_loss.py``).
On Hopper that is one implicit GEMM per signal (``svs_torch/csrc/
spectral.cuh``, on wgmma), in the forward and again in the backward:

    cols[b, f, c] = sum_i  xp[b, f*hop + tap_lo + i] * basis[tap_lo + i, c]

with the frames an implicit operand (never written), ``i`` running only
over the taps where the centred window is non-zero (``tap_lo``, aligned
down to 8 samples, to ``tap_lo + n_taps``, in 64-tap stages), and the
columns of one bin side by side: column 2q is the windowed cosine of bin q
and 2q+1 its sine.  At an even n_fft, bin 0 and the Nyquist bin, whose
sines are zero, share the first pair (column 0 and column 1), so the
n_fft/2 + 1 bins fill exactly n_fft columns; an odd n_fft has no Nyquist
bin, and its n_fft//2 + 1 bins take a pair each (n_fft + 1 columns).  The
kernels' bases pad these columns with zeros to whole 128-column tiles
(``Geometry.n_cols``), as the Pallas kernels pad the bins to 128 lanes.

The backward recomputes the spectrum and goes back to the waveform without
per-shift planes: the adjoint kernel computes, for hop-wide rows r of the
padded signal,

    dxp[b, r*hop + c] = sum_j sum_col G[b, r - j, col] * basis[j*hop + c, col]

over the shifts j whose taps meet the window, which is the overlap-add of
``G @ basis^T`` done inside the GEMM's accumulators: deterministic, no
atomics, no (K, B, rows, hop) planes in memory.  The bases are stored
pre-tiled in the order and the 128-byte swizzled layout the kernels' stages
consume (:func:`dft_tiles`, :func:`shift_tiles`).  The reflect pad's
mirror-add stays plain tensor code here, as it was XLA code outside the TPU
kernel.

The CUDA kernels take every geometry the Pallas kernels take, at most
65,535 examples.  A block's shared memory grows with the hop (the DFT
GEMM's signal spans) and with the shifts that meet the window (the
adjoint's cotangent chunks); where either would pass the 227 KB an H100
block may have, the kernels stage the frames in pieces a stage, and the
shifts in groups (:func:`dft_staging`, :func:`adj_group`, mirrors of the
C++ choices and sizes).  :func:`check_card` refuses what they do not take
before a kernel is built or launched.

Every function here runs on the CPU and on the card; the plain versions use
float32 products of the bfloat16-rounded operands (on the card with
``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from svs_torch.ops import stft as dsp

EPS = 1e-8        # power clip (auraloss; svs_tpu losses/mrstft.py)
# the kernels' tiling (svs_torch/csrc/spectral.cuh)
STAGE = 64        # kStageK: taps or columns per stage
DFT_FRAMES = 64   # kDftBM: frames per DFT block
DFT_COLS = 128    # kDftN: columns per DFT block
# adjoint hop tiles with a wgmma instance; other hops take tiles of 64
HOP_WIDTHS = (56, 120, 240)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Shapes of one (B, T) waveform at one resolution."""
    batch: int
    t: int
    n_fft: int
    hop: int
    win: int

    @property
    def pad(self) -> int:
        return self.n_fft // 2

    @property
    def t_padded(self) -> int:
        return self.t + 2 * self.pad

    @property
    def n_frames(self) -> int:
        return 1 + (self.t_padded - self.n_fft) // self.hop

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def n_pairs(self) -> int:
        """Column pairs that carry bins: n_fft/2 (bin 0 and Nyquist share
        pair 0) at an even n_fft, n_fft//2 + 1 at an odd one."""
        return (self.n_fft + 1) // 2

    @property
    def n_cols(self) -> int:
        """The kernels' basis columns: the pairs padded with zero columns
        to whole DFT_COLS tiles."""
        return _cdiv(2 * self.n_pairs, DFT_COLS) * DFT_COLS

    @property
    def k(self) -> int:
        """Hop-shifts a frame spans, ceil(n_fft / hop)."""
        return _cdiv(self.n_fft, self.hop)

    @property
    def left(self) -> int:
        """First tap of the centred window."""
        return (self.n_fft - self.win) // 2

    @property
    def tap_lo(self) -> int:
        """First tap the kernels read (a multiple of 8: 16-byte aligned)."""
        return self.left - self.left % 8

    @property
    def n_taps(self) -> int:
        """Taps the kernels contract over, a multiple of STAGE."""
        return _cdiv(self.left + self.win - self.tap_lo, STAGE) * STAGE

    @property
    def stride(self) -> int:
        """Row pitch of the kernels' padded bf16 signal: room for the last
        frame's read past the window, a multiple of 8."""
        return _cdiv(self.t_padded + 2 * STAGE, 8) * 8

    @property
    def rows(self) -> int:
        """Hop-wide rows of the adjoint's output (the frames' span)."""
        return self.n_frames + self.k - 1

    @property
    def shift_lo(self) -> int:
        """First hop shift whose taps meet the window."""
        return self.left // self.hop

    @property
    def n_shifts(self) -> int:
        """Hop shifts the adjoint contracts (those meeting the window)."""
        return (self.left + self.win - 1) // self.hop - self.shift_lo + 1

    @property
    def hop_width(self) -> int:
        """The adjoint's tile of hop columns (wgmma's N): the hop rounded
        up to 8 where a kernel instance has that width, else 64."""
        n = _cdiv(self.hop, 8) * 8
        return n if n in HOP_WIDTHS else 64

    @property
    def hop_tiles(self) -> int:
        return _cdiv(self.hop, self.hop_width)


def geometry(x: torch.Tensor, n_fft: int, hop: int, win: int) -> Geometry:
    if x.ndim != 2:
        raise ValueError(f"expected (B, T) waveforms, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32 waveforms, got {x.dtype}")
    if n_fft < 4 or hop < 1 or not 0 < win <= n_fft:
        raise ValueError(f"bad geometry n_fft={n_fft} hop={hop} win={win}")
    if x.shape[1] <= n_fft // 2:
        raise ValueError(f"reflect pad of {n_fft // 2} needs more than "
                         f"{n_fft // 2} samples, got {x.shape[1]}")
    return Geometry(x.shape[0], x.shape[1], n_fft, hop, win)


def paired_basis(n_fft: int, win: int) -> np.ndarray:
    """(n_fft taps, 2*n_pairs columns) float32 centred-hann DFT basis in the
    paired column layout of the module docstring."""
    cos, sin = dsp.centered_hann_dft(n_fft, win)
    n_pairs = (n_fft + 1) // 2
    out = np.zeros((n_fft, 2 * n_pairs), np.float32)
    out[:, 0::2] = cos[:, :n_pairs]
    out[:, 1::2] = sin[:, :n_pairs]
    if n_fft % 2 == 0:
        out[:, 1] = cos[:, n_pairs]  # Nyquist beside bin 0
    return out


def unpair(cols: torch.Tensor, n_fft: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 2*n_pairs) paired columns -> re, im, each (..., n_fft//2 + 1);
    ``n_fft`` defaults to the column count (an even n_fft)."""
    re, im = cols[..., 0::2], cols[..., 1::2]
    if n_fft is not None and n_fft % 2:
        return re, im
    zero = torch.zeros_like(cols[..., :1])
    return (torch.cat([re, cols[..., 1:2]], dim=-1),
            torch.cat([zero, im[..., 1:], zero], dim=-1))


def pair(re: torch.Tensor, im: torch.Tensor,
         n_fft: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`unpair` (the sines of bin 0 and Nyquist drop)."""
    if n_fft is not None and n_fft % 2:
        return torch.stack([re, im], dim=-1).flatten(-2)
    n_bins = re.shape[-1]
    cols = torch.stack([re[..., :-1], im[..., :-1]], dim=-1).flatten(-2)
    cols[..., 1] = re[..., n_bins - 1]
    return cols


_bases: Dict[tuple, torch.Tensor] = {}


def _cached(key, make):
    if key not in _bases:
        _bases[key] = make()
    return _bases[key]


def basis_bf16(n_fft: int, win: int, device) -> torch.Tensor:
    """The paired basis rounded to bfloat16 (as the TPU kernels' bases)."""
    return _cached(("basis", n_fft, win, torch.device(device)), lambda: (
        torch.from_numpy(paired_basis(n_fft, win)).to(torch.bfloat16)
        .to(device)))


def swizzle128(t: torch.Tensor) -> torch.Tensor:
    """(..., rows, 64) bf16 -> the 128-byte swizzled layout of wgmma's
    K-major operand: row r's 16-byte chunk c stored at chunk c ^ (r % 8).
    Its own inverse."""
    rows = t.shape[-2]
    chunks = t.unflatten(-1, (8, 8))
    r = torch.arange(rows)[:, None]
    return chunks[..., r, torch.arange(8)[None, :] ^ (r % 8), :].flatten(-2)


def dft_tiles(geo: Geometry, device) -> torch.Tensor:
    """(n_cols/128, n_taps/64, 128, 64) bf16: the DFT GEMM's basis, forward
    and backward, taps ``tap_lo`` onwards of each column (zero past n_fft,
    and zero columns past the pairs), one (column tile, stage) block per
    bulk copy, swizzled."""
    def make():
        b = basis_bf16(geo.n_fft, geo.win, "cpu")
        taps = torch.zeros((geo.n_taps, geo.n_cols), dtype=torch.bfloat16)
        n = min(geo.n_taps, geo.n_fft - geo.tap_lo)
        taps[:n, :b.shape[1]] = b[geo.tap_lo:geo.tap_lo + n]
        t = taps.T.reshape(geo.n_cols // DFT_COLS, DFT_COLS,
                           geo.n_taps // STAGE, STAGE).transpose(1, 2)
        return swizzle128(t).contiguous().to(device)
    return _cached(("dft", geo.n_fft, geo.win, torch.device(device)), make)


def shift_tiles(geo: Geometry, device) -> torch.Tensor:
    """(hop_tiles, n_cols/64, n_shifts, hop_width, 64) bf16: the adjoint's
    basis; row c of hop tile h and shift ``shift_lo + j`` is tap
    (shift_lo + j)*hop + h*hop_width + c (zero past the hop or n_fft, and in
    the zero columns), its 64 columns of one chunk swizzled, one block per
    bulk copy."""
    def make():
        b = basis_bf16(geo.n_fft, geo.win, "cpu")
        width = geo.hop_width
        rows = torch.zeros((geo.hop_tiles, geo.n_shifts, width, geo.n_cols),
                           dtype=torch.bfloat16)
        for h in range(geo.hop_tiles):
            for j in range(geo.n_shifts):
                lo = (geo.shift_lo + j) * geo.hop + h * width
                n = max(0, min(width, geo.hop - h * width, geo.n_fft - lo))
                rows[h, j, :n, :b.shape[1]] = b[lo:lo + n]
        t = rows.unflatten(-1, (geo.n_cols // STAGE, STAGE)).permute(
            0, 3, 1, 2, 4)
        return swizzle128(t).contiguous().to(device)
    return _cached(("shifts", geo.n_fft, geo.hop, geo.win,
                    torch.device(device)), make)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]


def padded_signal(x: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """(B, stride) bf16: the reflect-padded signal the kernels frame, zero
    past ``t_padded`` (svs_tpu's ``_z_views_bf16`` without the views)."""
    xp = torch.zeros((geo.batch, geo.stride), dtype=torch.bfloat16,
                     device=x.device)
    xp[:, :geo.t_padded] = reflect_pad(x, geo.pad)
    return xp


# ---------------------------------------------------------------- plain


def cols_plain(x: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """(B, n_frames, 2*n_pairs) float32 paired re/im columns: the forward GEMM
    with float32 products of the bf16-rounded signal and basis."""
    xp = reflect_pad(x, geo.pad).to(torch.bfloat16).float()
    frames = dsp.frame_signal(xp, geo.n_fft, geo.hop)
    return torch.matmul(frames, basis_bf16(geo.n_fft, geo.win,
                                           x.device).float())


def magnitude(re: torch.Tensor, im: torch.Tensor):
    """power and sqrt(max(power, EPS)), as the kernels' epilogues."""
    power = re * re + im * im
    return power, torch.sqrt(torch.clamp(power, min=EPS))


def grad_columns(scale: torch.Tensor, re: torch.Tensor, im: torch.Tensor,
                 n_fft: int) -> torch.Tensor:
    """The cotangent of the paired columns, ``scale * re`` and
    ``scale * im`` rounded to bf16 (diff_mag.py:112-113), as float32."""
    g = pair(scale * re, scale * im, n_fft)
    return g.to(torch.bfloat16).float()


def mirror_add(dxp: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """Reflect pad backward: (B, >= t_padded) cotangent of the padded signal
    -> (B, T) cotangent of the signal (diff_mag.py:189-196)."""
    pad, t = geo.pad, geo.t
    dxp = dxp[:, :geo.t_padded]
    if dxp.shape[1] < geo.t_padded:
        dxp = F.pad(dxp, (0, geo.t_padded - dxp.shape[1]))
    dx = dxp[:, pad:pad + t].clone()
    dx[:, 1:pad + 1] += dxp[:, :pad].flip(-1)
    dx[:, t - pad - 1:t - 1] += dxp[:, pad + t:].flip(-1)
    return dx


def adjoint_plain(g_cols: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """(B, n_frames, 2*n_pairs) column cotangent -> (B, T) signal cotangent:
    ``g_cols @ basis^T``, overlap-added at hop, then the mirror-add."""
    d_frames = torch.matmul(
        g_cols, basis_bf16(geo.n_fft, geo.win, g_cols.device).float().T)
    return mirror_add(dsp.overlap_add(d_frames, geo.hop), geo)


# ---------------------------------------------------------------- kernels

SMEM_LIMIT = 232_448  # shared memory an H100 block may have (227 KB)
MAX_BATCH = 65_535    # the grids' z dimension: one example a slice
# the other terms of a block's shared memory in spectral.cuh: the DFT
# GEMM's ring of 4 basis stages and its gradient epilogue's staging of 64
# bf16 rows of 136 columns; with pieces, each ring stage also holds each
# signal's 64 frame pieces of 72 samples; the adjoint's 128-row tiles, its
# ring of 4 shift tiles and 3 cotangent chunks; in both, 1 KB of alignment
# slack and the mbarriers
_DFT_STAGES, _OUT_PITCH = 4, DFT_COLS + 8
_PIECE_LEN = STAGE + 8
_ADJ_ROWS, _ADJ_STAGES, _G_STAGES = 128, 4, 3


def dft_span(hop: int, n_taps: int) -> int:
    """Signal samples a DFT block stages per signal: its 64 frames'
    (64 - 1)*hop + n_taps from an offset aligned down to 8, in whole 64s
    (``dft_span`` in spectral.cuh)."""
    return _cdiv(7 + (DFT_FRAMES - 1) * hop + n_taps, 64) * 64


def dft_smem(nsig: int, span: int) -> int:
    """Bytes of shared memory a DFT block asks for with ``nsig`` signal
    spans of ``span`` samples (``dft_smem`` in spectral.cuh)."""
    staged = DFT_FRAMES * _OUT_PITCH * 2
    return (1024 + _DFT_STAGES * DFT_COLS * STAGE * 2
            + max(nsig * span * 2, staged) + 8 * (2 * _DFT_STAGES + 1))


def dft_piece_smem(nsig: int) -> int:
    """Bytes of shared memory a DFT block asks for when it stages its frames
    in pieces (``dft_piece_smem`` in spectral.cuh): a ring of 4 stages,
    each a basis stage and ``nsig`` signals' 64 pieces."""
    stage = DFT_COLS * STAGE * 2 + nsig * DFT_FRAMES * _PIECE_LEN * 2
    return 1024 + _DFT_STAGES * stage + 8 * (2 * _DFT_STAGES + 1)


def dft_staging(nsig: int, hop: int, n_taps: int) -> Tuple[str, int]:
    """How a DFT block with ``nsig`` signals stages its frames, and the
    bytes of shared memory it then asks for (``dft_pieces`` and
    ``dft_smem_for`` in spectral.cuh): one span a signal where that fits a
    block, else pieces a stage."""
    span = dft_smem(nsig, dft_span(hop, n_taps))
    if span <= SMEM_LIMIT:
        return "span", span
    return "pieces", dft_piece_smem(nsig)


def adj_smem(width: int, k: int) -> int:
    """Bytes of shared memory an adjoint block asks for with hop tiles of
    ``width`` and groups of ``k`` shifts (``adj_smem`` in spectral.cuh)."""
    return (1024 + _ADJ_STAGES * width * 128
            + _G_STAGES * (_ADJ_ROWS + k - 1) * 128 + 128
            + 8 * 2 * (_ADJ_STAGES + _G_STAGES))


def adj_group(width: int, k: int) -> int:
    """Shifts an adjoint block contracts per staged piece of cotangent rows
    (``adj_group`` in spectral.cuh): all ``k`` where their rows fit a
    block, else as many as fit."""
    fit = (SMEM_LIMIT - adj_smem(width, 1)) // (_G_STAGES * 128) + 1
    return min(k, fit)


def check_card(x: torch.Tensor, geo: Geometry, name: str, nsig: int) -> None:
    """Raise ``ValueError`` for what the CUDA kernels of ``name`` (with
    ``nsig`` signals: 1 for spectral_mag, 2 for loss_partials) do not take:
    a waveform that is not contiguous, or more examples than their grids
    hold, named in the message with its numbers: every hop and n_fft is
    taken (the staging :func:`dft_staging` and :func:`adj_group` mirror
    fits a block at every geometry).  The wrappers call it
    before any build, allocation or launch, forward and backward alike, so
    that neither runs when the other cannot."""
    if not x.is_contiguous():
        raise ValueError(f"{name} expects a contiguous waveform")
    if geo.batch > MAX_BATCH:
        raise ValueError(f"{name}: the kernels' grids take at most "
                         f"{MAX_BATCH:,} examples, got {geo.batch:,}")


def dft_args(geo: Geometry, device) -> tuple:
    """The DFT GEMM's arguments after its signal pointers (forward and
    backward): pitch, batch, readable row length, basis tiles and shape."""
    tiles = dft_tiles(geo, device)
    return (geo.stride, geo.batch, geo.stride - geo.tap_lo,
            tiles.data_ptr(), geo.n_taps, geo.n_cols, geo.n_fft, geo.hop,
            geo.n_frames)


def tap_base(geo: Geometry, xp: torch.Tensor) -> int:
    """Pointer to a padded signal's first tap."""
    return xp.data_ptr() + 2 * geo.tap_lo


def empty_g_cols(geo: Geometry, device) -> torch.Tensor:
    """The backward's bf16 column cotangent between its two launches:
    (B, n_cols/64, n_frames, 64), column chunk major, each frame's 64
    columns 128-byte swizzled by frame % 8 (``g_col_offset`` in
    spectral.cuh)."""
    return torch.empty((geo.batch, geo.n_cols // STAGE, geo.n_frames, STAGE),
                       dtype=torch.bfloat16, device=device)


def adjoint_args(geo: Geometry, device) -> tuple:
    shifts = shift_tiles(geo, device)
    return (shifts.data_ptr(), geo.n_shifts, geo.shift_lo, geo.hop_width)


def fold_rows(rows: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """The adjoint kernel's (B, rows, hop) output -> (B, T) cotangent."""
    return mirror_add(rows.reshape(geo.batch, -1), geo)
