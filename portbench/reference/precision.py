"""Precision settings of the reference, and the control's lower precision.

:func:`exact` turns TF32 off for the reference's matmuls and convs.
The control is the step below what the configurations state in
bfloat16: the convolutions (:func:`conv_fp8`) and, in training, the loss's
windowed-DFT magnitudes (:func:`spectral_mag_fp8`; ``mr_mag_impl``
``matmul_bf16``).  Operands are rounded to float8 e4m3 and the backward's
incoming gradients to e5m2, each with one scale per tensor (its largest
magnitude at the format's largest finite value), and the products
accumulate in float32, as fp8 tensor cores do.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.unet import conv_f32

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def exact():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def quantize(x: torch.Tensor, dtype: torch.dtype,
             largest: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one per-tensor scale, back in
    float32."""
    amax = x.detach().abs().max().clamp(min=1e-30)
    scale = largest / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8(torch.autograd.Function):
    """Forward: e4m3 rounding; backward: the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return quantize(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return quantize(g, torch.float8_e5m2, E5M2_MAX)


class _GradFp8(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return quantize(g, torch.float8_e5m2, E5M2_MAX)


def conv_fp8(x, w, b, transpose):
    y = conv_f32(_Fp8.apply(x), _Fp8.apply(w), None, transpose)
    return _GradFp8.apply(y) + b[None, :, None, None]


def _dft_basis(n_fft: int, win: int, device) -> torch.Tensor:
    """(n_fft, 2 * (n_fft//2 + 1)) cos | -sin basis with a periodic Hann
    window of ``win`` centred in ``n_fft`` folded in."""
    t = np.arange(n_fft)[:, None]
    f = np.arange(n_fft // 2 + 1)[None, :]
    w = np.zeros((n_fft, 1))
    left = (n_fft - win) // 2
    w[left:left + win, 0] = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win)
                                               / win)
    ang = 2 * np.pi * t * f / n_fft
    basis = np.concatenate([np.cos(ang) * w, -np.sin(ang) * w], axis=1)
    return torch.from_numpy(basis.astype(np.float32)).to(device)


def spectral_mag_fp8(x: torch.Tensor, n_fft: int, hop: int,
                     win: int) -> torch.Tensor:
    """The loss's |STFT| (reflect-padded, centred) as frames @ DFT basis
    with both operands in fp8: (..., T) -> (..., n_fft//2 + 1, frames)."""
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (n_fft // 2, n_fft // 2),
               mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop)
    out = _GradFp8.apply(_Fp8.apply(frames) @ _Fp8.apply(
        _dft_basis(n_fft, win, x.device)))
    bins = n_fft // 2 + 1
    power = out[..., :bins] ** 2 + out[..., bins:] ** 2
    mag = torch.sqrt(torch.clamp(power, min=1e-8))
    return mag.transpose(-1, -2).reshape(*lead, bins, -1)
