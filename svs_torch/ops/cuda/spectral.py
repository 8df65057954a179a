"""What the two MR-STFT loss kernels share: geometry, bases, padding, the
plain versions of their GEMMs, and the fold back to the waveform.

Both ``diff_mag.spectral_mag`` and ``fused_loss.loss_partials`` compute the
reflect-padded, centred-hann windowed real DFT of (B, T) waveforms with
bfloat16 operands and float32 accumulation (the numerics of svs_tpu's
Pallas kernels ``ops/pallas/diff_mag.py`` and ``ops/pallas/fused_loss.py``).
On Hopper that is one implicit GEMM per signal (``svs_torch/csrc/
spectral_gemm.cuh``):

    cols[b, f, c] = sum_i  xp[b, f*hop + tap_lo + i] * basis[tap_lo + i, c]

with the frames an implicit operand (never written), ``i`` running only
over the taps where the centred window is non-zero (``tap_lo`` to
``tap_lo + n_taps``), and the columns of one bin side by side: column 2q
is the windowed cosine of bin q and 2q+1 its sine, for 1 <= q < n_fft/2;
bin 0 and the Nyquist bin, whose sines are zero, share the first pair
(column 0 and column 1), so the n_fft/2 + 1 bins fill exactly n_fft columns.

The backward's transposed product goes back to the waveform without
per-shift planes: the adjoint kernel computes, for hop-wide rows r of the
padded signal,

    dxp[b, r*hop + c] = sum_j sum_col G[b, r - j, col] * basis[j*hop + c, col]

which is the overlap-add of ``G @ basis^T`` done inside the GEMM's
accumulators: deterministic, no atomics, no (K, B, rows, hop) planes in
memory.  The reflect pad's mirror-add stays plain tensor code here, as it
was XLA code outside the TPU kernel.

Every function here runs on the CPU and on the card; the plain versions use
float32 products of the bfloat16-rounded operands (on the card with
``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from svs_torch.ops import stft as dsp

EPS = 1e-8        # power clip (auraloss; svs_tpu losses/mrstft.py)
TAP_TILE = 32     # kBK in spectral_gemm.cuh: taps per shared-memory stage
HOP_TILE = 64     # kAdjBN in spectral_gemm.cuh: hop columns per block


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
    def k(self) -> int:
        """Hop-shifts a frame spans, ceil(n_fft / hop)."""
        return _cdiv(self.n_fft, self.hop)

    @property
    def left(self) -> int:
        """First tap of the centred window."""
        return (self.n_fft - self.win) // 2

    @property
    def tap_lo(self) -> int:
        """First tap the kernels read (even: 4-byte aligned bf16 pairs)."""
        return self.left - self.left % 2

    @property
    def n_taps(self) -> int:
        """Taps the kernels contract over, a multiple of TAP_TILE."""
        return _cdiv(self.left + self.win - self.tap_lo, TAP_TILE) * TAP_TILE

    @property
    def stride(self) -> int:
        """Row pitch of the kernels' padded bf16 signal: room for the last
        frame's read past the window, a multiple of 8."""
        return _cdiv(self.t_padded + TAP_TILE, 8) * 8

    @property
    def rows(self) -> int:
        """Hop-wide rows of the adjoint's output (the frames' span)."""
        return self.n_frames + self.k - 1

    @property
    def hop_pad(self) -> int:
        return _cdiv(self.hop, HOP_TILE) * HOP_TILE


def geometry(x: torch.Tensor, n_fft: int, hop: int, win: int) -> Geometry:
    if x.ndim != 2:
        raise ValueError(f"expected (B, T) waveforms, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32 waveforms, got {x.dtype}")
    if n_fft < 4 or n_fft % 2 or hop < 1 or not 0 < win <= n_fft:
        raise ValueError(f"bad geometry n_fft={n_fft} hop={hop} win={win}")
    if x.shape[1] <= n_fft // 2:
        raise ValueError(f"reflect pad of {n_fft // 2} needs more than "
                         f"{n_fft // 2} samples, got {x.shape[1]}")
    return Geometry(x.shape[0], x.shape[1], n_fft, hop, win)


def paired_basis(n_fft: int, win: int) -> np.ndarray:
    """(n_fft taps, n_fft columns) float32 centred-hann DFT basis in the
    paired column layout of the module docstring."""
    cos, sin = dsp.centered_hann_dft(n_fft, win)
    half = n_fft // 2
    out = np.zeros((n_fft, n_fft), np.float32)
    out[:, 0:n_fft:2] = cos[:, :half]
    out[:, 1:n_fft:2] = sin[:, :half]
    out[:, 1] = cos[:, half]
    return out


def unpair(cols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n_fft) paired columns -> re, im, each (..., n_fft//2 + 1)."""
    n_fft = cols.shape[-1]
    zero = torch.zeros_like(cols[..., :1])
    re = torch.cat([cols[..., 0:n_fft:2], cols[..., 1:2]], dim=-1)
    im = torch.cat([zero, cols[..., 3:n_fft:2], zero], dim=-1)
    return re, im


def pair(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`unpair` (the sines of bin 0 and Nyquist drop)."""
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


def basis_taps(geo: Geometry, device) -> torch.Tensor:
    """(n_fft columns, n_taps) bf16: the forward GEMM's operand, taps
    ``tap_lo`` onwards of each column, zero past n_fft."""
    def make():
        b = basis_bf16(geo.n_fft, geo.win, "cpu")
        out = torch.zeros((geo.n_taps, geo.n_fft), dtype=torch.bfloat16)
        n = min(geo.n_taps, geo.n_fft - geo.tap_lo)
        out[:n] = b[geo.tap_lo:geo.tap_lo + n]
        return out.T.contiguous().to(device)
    return _cached(("taps", geo.n_fft, geo.hop, geo.win,
                    torch.device(device)), make)


def basis_shifts(geo: Geometry, device) -> torch.Tensor:
    """(k, hop_pad, n_fft columns) bf16: the adjoint's operand, row c of
    shift j being tap j*hop + c (zero for c >= hop or past n_fft)."""
    def make():
        b = basis_bf16(geo.n_fft, geo.win, "cpu")
        out = torch.zeros((geo.k, geo.hop_pad, geo.n_fft),
                          dtype=torch.bfloat16)
        for j in range(geo.k):
            n = min(geo.hop, geo.n_fft - j * geo.hop)
            out[j, :n] = b[j * geo.hop:j * geo.hop + n]
        return out.to(device)
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
    """(B, n_frames, n_fft) float32 paired re/im columns: the forward GEMM
    with float32 products of the bf16-rounded signal and basis."""
    xp = reflect_pad(x, geo.pad).to(torch.bfloat16).float()
    frames = dsp.frame_signal(xp, geo.n_fft, geo.hop)
    return torch.matmul(frames, basis_bf16(geo.n_fft, geo.win,
                                           x.device).float())


def magnitude(re: torch.Tensor, im: torch.Tensor):
    """power and sqrt(max(power, EPS)), as the kernels' epilogues."""
    power = re * re + im * im
    return power, torch.sqrt(torch.clamp(power, min=EPS))


def grad_columns(scale: torch.Tensor, re: torch.Tensor,
                 im: torch.Tensor) -> torch.Tensor:
    """The cotangent of the paired columns, ``scale * re`` and
    ``scale * im`` rounded to bf16 (diff_mag.py:112-113), as float32."""
    g = pair(scale * re, scale * im)
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
    """(B, n_frames, n_fft) column cotangent -> (B, T) signal cotangent:
    ``g_cols @ basis^T``, overlap-added at hop, then the mirror-add."""
    d_frames = torch.matmul(
        g_cols, basis_bf16(geo.n_fft, geo.win, g_cols.device).float().T)
    return mirror_add(dsp.overlap_add(d_frames, geo.hop), geo)


# ---------------------------------------------------------------- kernels


def check_card(x: torch.Tensor, geo: Geometry, name: str) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{name} expects a contiguous waveform")
    if geo.hop % 2:
        raise ValueError(f"{name}: the CUDA kernel reads bf16 pairs and "
                         f"needs an even hop, got {geo.hop}")
    if geo.n_fft % 128:
        raise ValueError(f"{name}: the CUDA kernel tiles 128 columns and "
                         f"needs n_fft % 128 == 0, got {geo.n_fft}")


def kernel_args(geo: Geometry, xp: torch.Tensor, device) -> tuple:
    """The forward GEMM's arguments common to every entry point: the
    signal's base at ``tap_lo``, its pitch, the tap basis and the shape."""
    taps = basis_taps(geo, device)
    return (xp.data_ptr() + 2 * geo.tap_lo, geo.stride, geo.batch,
            taps.data_ptr(), geo.n_taps, geo.n_fft, geo.hop, geo.n_frames)


def adjoint_args(geo: Geometry, device) -> tuple:
    shifts = basis_shifts(geo, device)
    return (shifts.data_ptr(), geo.k, geo.hop_pad, geo.left, geo.win)


def fold_rows(rows: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """The adjoint kernel's (B, rows, hop) output -> (B, T) cotangent."""
    return mirror_add(rows.reshape(geo.batch, -1), geo)
