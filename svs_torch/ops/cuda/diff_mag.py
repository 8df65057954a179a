"""Differentiable |STFT| for the MR-STFT loss: the CUDA kernels' wrapper and
their plain PyTorch version.

Replaces the TPU kernel ``svs_tpu/ops/pallas/diff_mag.py::spectral_mag``
(custom VJP; forward ``_fwd_kernel``, pallas_call at diff_mag.py:130;
backward ``_bwd_kernel``, pallas_call at diff_mag.py:171), the magnitudes of
``mr_mag_impl='pallas_bf16'``.  Same function: x (B, T) float32 ->
(B, n_bins, n_frames) float32, reflect pad, centred hann of ``win`` inside
``n_fft``, bf16 operands with f32 accumulation, ``sqrt(max(power, 1e-8))``.
The backward recomputes re/im, zeroes the gradient where power < 1e-8,
rounds the scaled re/im cotangents to bf16 and contracts them with the
transposed basis.

On Hopper (``svs_torch/csrc/diff_mag.cu`` on ``spectral.cuh``) both
directions run one implicit-framing DFT GEMM on the bf16 tensor cores
(``wgmma``, f32 accumulators, fed by bulk async copies on mbarriers): the
forward is that GEMM with an epilogue that writes the magnitude through
shared memory as whole rows of frames; the backward is two launches, the
GEMM again with an epilogue that writes the bf16 column cotangent, then the
adjoint GEMM that overlap-adds it straight into hop-wide rows of the padded
signal (no per-shift planes, no atomics: the result does not vary from run
to run).
Bounds on an H100 SXM at the train step's shapes (B = 32, 97,536
samples, one call per resolution; chip_smoke.py's ``loss_bounds``, tabled
in PERF.md):
- the function's least work is its bytes: a forward reads 12.5 MB of
  signal and writes 53-64 MB of magnitude, 20-23 us at 3.35 TB/s, more
  than its real FFT at the 67 TFLOP/s float32 rate (float32 for the
  reason given in fused_loss.py); a backward 23-27 us;
- this formulation, the window-deep DFT-as-GEMM on the bf16 tensor cores
  (989 TFLOP/s dense) over 64-tap stages: 23-66 us a forward call; 38-145
  us a backward, the DFT and the adjoint over the hop shifts that meet the
  window.

:func:`spectral_mag` launches the kernels for a CUDA tensor and takes the
plain version only for a tensor on the CPU; a geometry the kernels do not
take raises ``ValueError`` before anything is launched
(``spectral.check_card``), and a build or launch error raises.
"""

from __future__ import annotations

import ctypes

import torch

from svs_torch.ops.cuda import build
from svs_torch.ops.cuda import spectral as sp

KERNEL = "diff_mag"

# launches of the CUDA kernels (plain-version calls are not counted); one
# backward is the gradient-spectrum and adjoint launches together
fwd_launches = 0
bwd_launches = 0


def reset_counts() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = bwd_launches = 0


# ---------------------------------------------------------------- plain


def spectral_mag_plain(x: torch.Tensor, n_fft: int, hop: int,
                       win: int) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel."""
    geo = sp.geometry(x, n_fft, hop, win)
    re, im = sp.unpair(sp.cols_plain(x, geo), n_fft)
    _, mag = sp.magnitude(re, im)
    return mag.transpose(1, 2)


def spectral_mag_bwd_plain(x: torch.Tensor, g: torch.Tensor, n_fft: int,
                           hop: int, win: int) -> torch.Tensor:
    """Plain PyTorch version of the backward kernels: d(sum g*mag)/dx."""
    geo = sp.geometry(x, n_fft, hop, win)
    re, im = sp.unpair(sp.cols_plain(x, geo), n_fft)
    power, mag = sp.magnitude(re, im)
    live = (power >= sp.EPS).float()
    scale = g.transpose(1, 2).float() * live / mag
    return sp.adjoint_plain(sp.grad_columns(scale, re, im, n_fft), geo)


# ---------------------------------------------------------------- kernels


def _fns():
    """The C entry points, built and typed on first use (pointers and the
    stream as c_void_p, so ctypes never cuts them to 32 bits)."""
    lib = build.load(KERNEL)
    fwd, bwd = lib.svs_spectral_mag_fwd, lib.svs_spectral_mag_bwd
    if fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # signal, pitch, batch, row length, tiles, the shape (n_taps,
        # n_cols, n_fft, hop, n_frames, and spectral_mag's n_bins)
        dft = [p, ll, i, i, p, i, i, i, i, i, i]
        fwd.restype = bwd.restype = ctypes.c_int
        fwd.argtypes = dft + [p, p]
        # then the cotangents, the shift tiles and their range, the output
        bwd.argtypes = dft + [p, p, p, i, i, i, p, p]
    return fwd, bwd


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _launch_fwd(x: torch.Tensor, geo: sp.Geometry) -> torch.Tensor:
    global fwd_launches
    sp.check_card(x, geo, "spectral_mag", 1)
    fwd, _ = _fns()
    xp = sp.padded_signal(x, geo)
    mag = torch.empty((geo.batch, geo.n_bins, geo.n_frames),
                      dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fwd(sp.tap_base(geo, xp), *sp.dft_args(geo, x.device),
                 geo.n_bins, mag.data_ptr(), stream)
    _raise_on(rc, "spectral_mag forward")
    fwd_launches += 1
    return mag


def _launch_bwd(x: torch.Tensor, g: torch.Tensor,
                geo: sp.Geometry) -> torch.Tensor:
    global bwd_launches
    sp.check_card(x, geo, "spectral_mag", 1)
    _, bwd = _fns()
    xp = sp.padded_signal(x, geo)
    g = g.to(torch.float32).contiguous()
    g_cols = sp.empty_g_cols(geo, x.device)
    rows = torch.empty((geo.batch, geo.rows, geo.hop), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = bwd(sp.tap_base(geo, xp), *sp.dft_args(geo, x.device),
                 geo.n_bins, g.data_ptr(), g_cols.data_ptr(),
                 *sp.adjoint_args(geo, x.device), rows.data_ptr(), stream)
    _raise_on(rc, "spectral_mag backward")
    bwd_launches += 1
    return sp.fold_rows(rows, geo)


def spectral_mag_fwd(x: torch.Tensor, n_fft: int, hop: int,
                     win: int) -> torch.Tensor:
    """The forward alone: the kernel on a CUDA tensor, else the plain
    version (CPU)."""
    geo = sp.geometry(x, n_fft, hop, win)
    if x.device.type == "cuda":
        return _launch_fwd(x, geo)
    if x.device.type == "cpu":
        return spectral_mag_plain(x, n_fft, hop, win)
    raise ValueError(f"spectral_mag runs on cuda or cpu, not {x.device}")


def spectral_mag_bwd(x: torch.Tensor, g: torch.Tensor, n_fft: int, hop: int,
                     win: int) -> torch.Tensor:
    """The backward alone: (B, T) cotangent of x for a (B, n_bins,
    n_frames) cotangent ``g`` of the magnitude."""
    geo = sp.geometry(x, n_fft, hop, win)
    if tuple(g.shape) != (geo.batch, geo.n_bins, geo.n_frames):
        raise ValueError(f"cotangent shape {tuple(g.shape)} != "
                         f"{(geo.batch, geo.n_bins, geo.n_frames)}")
    if x.device.type == "cuda":
        return _launch_bwd(x, g, geo)
    if x.device.type == "cpu":
        return spectral_mag_bwd_plain(x, g, n_fft, hop, win)
    raise ValueError(f"spectral_mag runs on cuda or cpu, not {x.device}")


class SpectralMag(torch.autograd.Function):
    """|STFT| with the kernels' forward and backward (recompute in the
    backward: only x is kept, as the TPU kernel's custom VJP does)."""

    @staticmethod
    def forward(ctx, x, n_fft, hop, win):
        ctx.geometry = (n_fft, hop, win)
        ctx.save_for_backward(x)
        return spectral_mag_fwd(x, n_fft, hop, win)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return spectral_mag_bwd(x, g, *ctx.geometry), None, None, None


def spectral_mag(x: torch.Tensor, n_fft: int, hop: int,
                 win: int) -> torch.Tensor:
    """Differentiable fused |STFT| of x (B, T) -> (B, n_bins, n_frames);
    reflect-padded, centred hann window, power clipped at 1e-8."""
    return SpectralMag.apply(x.contiguous(), n_fft, hop, win)
