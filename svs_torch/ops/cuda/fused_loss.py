"""Reduction-fused MR-STFT loss: the CUDA kernels' wrapper and their plain
PyTorch version.

Replaces the TPU kernel ``svs_tpu/ops/pallas/fused_loss.py::loss_partials``
(custom VJP; forward ``_fwd_kernel`` / ``_fwd_kernel_wide``, pallas_call at
fused_loss.py:327; backward ``_bwd_kernel`` / ``_bwd_kernel_wide``,
pallas_call at fused_loss.py:379), the kernel of
``mr_mag_impl='pallas_fused'`` and ``'pallas_fused_wide'``.  Same function:
per example, the three sums [sum (|Y|-|X|)^2, sum |Y|^2,
sum |log|X| - log|Y||] over the (frame, bin) cells of the magnitudes of x
(prediction) and y (target), both (B, T) float32; bf16 operands, f32
accumulation, power clipped at 1e-8.  Differentiable in x only.

``rounded`` is the same function with the spectrum of x and y stored as
bf16 before the power, as ``mr_mag_impl='matmul_bf16'`` computes it (its
DFT is a bf16 ``torch.matmul`` whose output is bf16;
``svs_torch/losses/mrstft.py``): the kernels' rounded instances, and the
plain version with the same rounding.  Its backward scales the rounded
re/im, as autograd does through the cast, and at a tie |X| = |Y| takes the
log term's subgradient +1 of the composition's ``abs_like_jax`` (the
unrounded function takes sign(0) = 0, as the TPU kernel does).

On Hopper (``svs_torch/csrc/fused_loss.cu`` on ``spectral.cuh``) both
directions run the implicit-framing DFT GEMM for x and for y in one block
(``wgmma`` fed by bulk async copies on mbarriers), the two sharing each
basis stage.  The forward's epilogue reduces the block's cells to three
sums in a fixed order, written to a small per-(example, frame tile, column
tile) buffer that ``torch.sum`` reduces: no atomics, so the result is the
same bits from call to call.  The backward is two launches: the GEMM
again with an epilogue that turns the cotangents of sums 0 and 2 into the
bf16 column cotangent of x, then the adjoint GEMM of ``spectral.py`` that
overlap-adds it into the waveform.
``wide`` is a TPU lane-layout variant of the same numbers: on Hopper both
names are one contraction of depth n_taps and run the same kernels.
Bounds on an H100 SXM at the train step's shapes (B = 32, 97,536
samples, one call per resolution; chip_smoke.py's ``loss_bounds``, tabled
in PERF.md):
- the function's least work is its operations, not its bytes: the real
  FFTs of x and y (and an inverse FFT in the backward) at the 67 TFLOP/s
  float32 rate, 23-25 us a forward call and 35-38 us a backward, against
  7.5 us for reading x and y (25 MB at 3.35 TB/s).  The float32 rate
  applies because the function accumulates in float32: only an FFT's
  first butterflies multiply bf16 operands, every later one combines
  float32 sums, which the bf16 tensor-core rate does not cover;
- this formulation, the window-deep DFT-as-GEMM on the bf16 tensor cores
  (989 TFLOP/s dense) over 64-tap stages: 33-131 us a forward call; 55-210
  us a backward, the DFTs of x and y and the adjoint over the hop shifts
  that meet the window.

:func:`loss_partials` launches the kernels for CUDA tensors and takes the
plain version only for tensors on the CPU; a geometry the kernels do not
take raises ``ValueError`` before anything is launched
(``spectral.check_card``; :func:`card_takes` asks first), and a build or
launch error raises.  The launch counts are published to
``profiling.snapshot()['counters']`` (:func:`counters`).
"""

from __future__ import annotations

import ctypes
import sys
from typing import Dict, Optional

import torch

from svs_torch.ops.cuda import build
from svs_torch.ops.cuda import spectral as sp
from svs_torch.parallel.mesh import all_sum
from svs_torch.utils import profiling

KERNEL = "fused_loss"

# launches of the CUDA kernels, and calls recorded into a CUDA graph
# (diff_mag.py's counts)
fwd_launches = 0
bwd_launches = 0
fwd_captured = 0
bwd_captured = 0


def reset_counts() -> None:
    global fwd_launches, bwd_launches, fwd_captured, bwd_captured
    fwd_launches = bwd_launches = fwd_captured = bwd_captured = 0


def counters() -> Dict[str, int]:
    """The counts as ``profiling.snapshot()['counters']`` shows them."""
    return {"fused_loss.fwd_launches": fwd_launches,
            "fused_loss.bwd_launches": bwd_launches,
            "fused_loss.fwd_captured": fwd_captured,
            "fused_loss.bwd_captured": bwd_captured}


profiling.publish(sys.modules[__name__])


# ---------------------------------------------------------------- plain


def _spectrum_plain(x, geo, rounded):
    re, im = sp.unpair(sp.cols_plain(x, geo), geo.n_fft)
    if rounded:
        re, im = (v.to(torch.bfloat16).float() for v in (re, im))
    return re, im


def _mags_plain(x, y, geo, rounded):
    rex, imx = _spectrum_plain(x, geo, rounded)
    rey, imy = _spectrum_plain(y, geo, rounded)
    px, mx = sp.magnitude(rex, imx)
    _, my = sp.magnitude(rey, imy)
    return rex, imx, px, mx, my


def loss_partials_plain(x: torch.Tensor, y: torch.Tensor, n_fft: int,
                        hop: int, win: int,
                        rounded: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: (B, 3) float32."""
    geo = sp.geometry(x, n_fft, hop, win)
    _, _, _, mx, my = _mags_plain(x, y, geo, rounded)
    d = my - mx
    return torch.stack([(d * d).sum((1, 2)), (my * my).sum((1, 2)),
                        torch.abs(torch.log(mx) - torch.log(my)).sum((1, 2))],
                       dim=-1)


def loss_partials_bwd_plain(x: torch.Tensor, y: torch.Tensor,
                            g: torch.Tensor, n_fft: int, hop: int,
                            win: int, rounded: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the backward kernels: the (B, T) cotangent
    of x for a (B, 3) cotangent of the partials (fused_loss.py:255-264)."""
    geo = sp.geometry(x, n_fft, hop, win)
    rex, imx, px, mx, my = _mags_plain(x, y, geo, rounded)
    g = g.to(torch.float32)
    c_diff = g[:, 0, None, None]
    c_log = g[:, 2, None, None]
    # at a tie the rounded function's log term takes abs_like_jax's +1
    sign = (torch.where(mx >= my, 1.0, -1.0) if rounded
            else torch.sign(mx - my))
    gmag = c_diff * (-2.0) * (my - mx) + c_log * sign / mx
    live = (px >= sp.EPS).float()
    scale = gmag * live / mx
    return sp.adjoint_plain(sp.grad_columns(scale, rex, imx, n_fft), geo)


# ---------------------------------------------------------------- kernels


def _fns():
    lib = build.load(KERNEL)
    fwd, bwd = lib.svs_loss_partials_fwd, lib.svs_loss_partials_bwd
    if fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # x, y, pitch, batch, row length, tiles, the shape (n_taps,
        # n_cols, n_fft, hop, n_frames)
        dft = [p, p, ll, i, i, p, i, i, i, i, i]
        fwd.restype = bwd.restype = ctypes.c_int
        # then the partials, the rounding, the stream
        fwd.argtypes = dft + [p, i, p]
        # then the cotangents, the shift tiles and their range, the output,
        # the rounding, the stream
        bwd.argtypes = dft + [p, p, p, i, i, i, p, i, p]
    return fwd, bwd


def _check(x, y, geo):
    sp.check_card(x, geo, "loss_partials", 2)
    if y.shape != x.shape or y.device != x.device or not y.is_contiguous():
        raise ValueError("loss_partials expects x and y of one shape, on one "
                         "device, contiguous")


def _launch_fwd(x, y, geo, rounded=False):
    global fwd_launches, fwd_captured
    _check(x, y, geo)
    fwd, _ = _fns()
    xp, yp = sp.padded_signal(x, geo), sp.padded_signal(y, geo)
    # one row of three sums per (example, frame tile, column tile) block
    tiles = (-(-geo.n_frames // sp.DFT_FRAMES), geo.n_cols // sp.DFT_COLS)
    part = torch.empty((geo.batch, *tiles, 3), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fwd(sp.tap_base(geo, xp), sp.tap_base(geo, yp),
                 *sp.dft_args(geo, x.device), part.data_ptr(), int(rounded),
                 stream)
    if rc != 0:
        raise RuntimeError(f"loss_partials forward kernel launch failed: "
                           f"CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        fwd_captured += 1
    else:
        fwd_launches += 1
    return part.sum((1, 2))


def _launch_bwd(x, y, g, geo, rounded=False):
    global bwd_launches, bwd_captured
    _check(x, y, geo)
    _, bwd = _fns()
    xp, yp = sp.padded_signal(x, geo), sp.padded_signal(y, geo)
    g = g.to(torch.float32).contiguous()
    g_cols = sp.empty_g_cols(geo, x.device)
    rows = torch.empty((geo.batch, geo.rows, geo.hop), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = bwd(sp.tap_base(geo, xp), sp.tap_base(geo, yp),
                 *sp.dft_args(geo, x.device), g.data_ptr(), g_cols.data_ptr(),
                 *sp.adjoint_args(geo, x.device), rows.data_ptr(),
                 int(rounded), stream)
    if rc != 0:
        raise RuntimeError(f"loss_partials backward kernel launch failed: "
                           f"CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        bwd_captured += 1
    else:
        bwd_launches += 1
    return sp.fold_rows(rows, geo)


def loss_partials_fwd(x: torch.Tensor, y: torch.Tensor, n_fft: int,
                      hop: int, win: int,
                      rounded: bool = False) -> torch.Tensor:
    """The forward alone: (B, 3) partial sums."""
    geo = sp.geometry(x, n_fft, hop, win)
    if x.device.type == "cuda":
        return _launch_fwd(x, y, geo, rounded)
    if x.device.type == "cpu":
        return loss_partials_plain(x, y, n_fft, hop, win, rounded)
    raise ValueError(f"loss_partials runs on cuda or cpu, not {x.device}")


def loss_partials_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                      n_fft: int, hop: int, win: int,
                      rounded: bool = False) -> torch.Tensor:
    """The backward alone: (B, T) cotangent of x for a (B, 3) cotangent of
    the partials (only its columns 0 and 2 matter)."""
    geo = sp.geometry(x, n_fft, hop, win)
    if tuple(g.shape) != (geo.batch, 3):
        raise ValueError(f"cotangent shape {tuple(g.shape)} != "
                         f"{(geo.batch, 3)}")
    if x.device.type == "cuda":
        return _launch_bwd(x, y, g, geo, rounded)
    if x.device.type == "cpu":
        return loss_partials_bwd_plain(x, y, g, n_fft, hop, win, rounded)
    raise ValueError(f"loss_partials runs on cuda or cpu, not {x.device}")


class LossPartials(torch.autograd.Function):
    """The partial sums with the kernels' forward and backward; y, the
    training target, gets no gradient (``None``)."""

    @staticmethod
    def forward(ctx, x, y, n_fft, hop, win, rounded):
        ctx.geometry = (n_fft, hop, win, rounded)
        ctx.save_for_backward(x, y)
        return loss_partials_fwd(x, y, n_fft, hop, win, rounded)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        dx = loss_partials_bwd(x, y, g, *ctx.geometry)
        return dx, None, None, None, None, None


def loss_partials(x: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int,
                  win: int, wide: bool = False,
                  rounded: bool = False) -> torch.Tensor:
    """Per-example partial sums (B, 3) = [sum(|Y|-|X|)^2, sum|Y|^2,
    sum|log|X|-log|Y||] of x (prediction) and y (target), both (B, T).
    Differentiable in x only.  ``wide`` names svs_tpu's single-matmul TPU
    variant; the numbers are the same and so is the kernel here.
    ``rounded``: the spectrum stored as bf16 before the power."""
    del wide
    return LossPartials.apply(x.contiguous(), y.contiguous(), n_fft, hop,
                              win, rounded)


def card_takes(x: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int,
               win: int) -> bool:
    """Whether the kernels run (B, T) prediction x and target y at this
    geometry: both float32 on one sm_90 card, one shape, and a geometry
    that ``spectral.geometry`` and ``spectral.check_card`` take (the
    kernels make the waveforms contiguous first)."""
    if (x.device.type != "cuda" or y.device != x.device
            or y.shape != x.shape or y.dtype != x.dtype
            or torch.cuda.get_device_capability(x.device) != (9, 0)):
        return False
    try:
        sp.check_card(x.contiguous(), sp.geometry(x, n_fft, hop, win),
                      "loss_partials", 2)
    except (TypeError, ValueError):
        return False
    return True


def stft_loss_fused(x: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int,
                    win: int, weight: Optional[torch.Tensor] = None,
                    w_sc: float = 1.0, w_log_mag: float = 1.0,
                    wide: bool = False, group=None,
                    rounded: bool = False) -> torch.Tensor:
    """Single-resolution SC + log-mag loss via the fused partials kernel
    (svs_tpu fused_loss.py:411-436); x = prediction (differentiated),
    y = target (detached); both (B, T) waveforms.  ``group``: the data
    mesh whose ranks hold the rest of the batch (``weight`` is then
    required); the kernel's per-row
    partials are then summed over the global batch's rows (with
    ``sum(weight)``) before the square roots.  ``rounded``: the spectrum
    stored as bf16 before the power (``matmul_bf16``'s numbers)."""
    if x.ndim != 2:
        raise ValueError("stft_loss_fused expects (B, T) waveforms")
    p = loss_partials(x, y.detach(), n_fft, hop, win, wide, rounded)
    geo = sp.geometry(x, n_fft, hop, win)
    if weight is None:
        s = torch.sum(p, dim=0)
        n_examples = x.shape[0] * 1.0
    else:
        s = all_sum(torch.cat([torch.sum(p * weight[:, None], dim=0),
                               torch.sum(weight)[None]]), group)
        s, n_examples = s[:3], s[3]
    # zero-safe sqrt on the SC numerator: d sqrt/d s0 is inf at s0 == 0 (an
    # exactly-perfect prediction); both wheres keep the discarded branch
    # finite so its zero gradient stays zero, not NaN
    live = s[0] > 0
    s0 = torch.where(live, s[0], torch.ones_like(s[0]))
    sc = (torch.where(live, torch.sqrt(s0), torch.zeros_like(s0))
          / torch.sqrt(s[1]))
    log_mag = s[2] / (n_examples * geo.n_bins * geo.n_frames)
    return w_sc * sc + w_log_mag * log_mag
