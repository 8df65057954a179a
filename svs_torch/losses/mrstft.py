"""Multi-resolution STFT waveform loss and the patch iSTFT feeding it (port
of ``svs_tpu/losses/mrstft.py``).

Rebuilds the reference's auraloss ``MultiResolutionSTFTLoss`` (reference
train.py:26, default resolutions) and its ``specific_istft`` helper
(reference train.py:33-60):

- resolutions (fft, hop, win) = (1024,120,600), (2048,240,1200), (512,50,240)
- per resolution: spectral convergence  ||  |Y|-|X| ||_F / || |Y| ||_F
  plus log-magnitude L1  mean| log|X| - log|Y| |
- magnitudes are sqrt(clamp(|S|^2, min=1e-8)); reflect-padded STFT with
  centred (zero-padded) hann windows
- total = mean over resolutions

``mr_mag_impl`` picks how the magnitudes are computed: ``fft`` (torch.fft,
the exact path), ``matmul_bf16`` (frames @ windowed-DFT basis as a bf16
``torch.matmul``, the default), ``pallas_bf16`` (the ``spectral_mag`` CUDA
kernels) and ``pallas_fused`` / ``pallas_fused_wide`` (the
``loss_partials`` CUDA kernels, which never write a magnitude).  The names
are svs_tpu's; the last three run hand-written Hopper kernels on a CUDA
tensor and their plain PyTorch versions on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from svs_torch.losses.masked_l1 import abs_like_jax, masked_l1_pair
from svs_torch.ops import stft as dsp
from svs_torch.ops.cuda import diff_mag, fused_loss
from svs_torch.parallel.mesh import Mesh, all_sum
from svs_torch.utils.config import SVSConfig


def patch_istft(mag: torch.Tensor, angle: torch.Tensor, *, n_fft: int = 1024,
                hop_length: int = 768) -> torch.Tensor:
    """Reference ``specific_istft`` (train.py:33-60): re-pad the dropped DC
    bin (512 -> 513), combine magnitude with phase angle, iSTFT.

    Args:  mag, angle: (..., 512, T) float (DC bin dropped, train.py:110-113).
    Returns: (..., hop*(T-1)) float32 waveform.
    """
    mag = F.pad(mag, (0, 0, 1, 0))
    angle = F.pad(angle, (0, 0, 1, 0))
    spec = dsp.polar(mag, angle)
    return dsp.istft(spec, hop_length=hop_length, win_length=n_fft,
                     n_fft=n_fft)


def _spectral_mag_fft(x: torch.Tensor, n_fft: int, hop: int,
                      win: int) -> torch.Tensor:
    S = dsp.stft(x, n_fft=n_fft, hop_length=hop, win_length=win,
                 pad_mode="reflect")
    power = S.real ** 2 + S.imag ** 2
    return torch.sqrt(torch.clamp(power, min=1e-8))


_filters: Dict[tuple, torch.Tensor] = {}


def _dft_filters(n_fft: int, win: int, device) -> torch.Tensor:
    """(n_fft, 2*(n_fft//2+1)) cos|sin windowed-DFT bank in bfloat16, made
    once per device (the sin half carries rfft's sign; magnitudes do not
    see it)."""
    key = (n_fft, win, torch.device(device))
    if key not in _filters:
        cos, sin = dsp.centered_hann_dft(n_fft, win)
        _filters[key] = torch.from_numpy(np.concatenate([cos, sin], axis=1)
                                         ).to(device=device,
                                              dtype=torch.bfloat16)
    return _filters[key]


def _spectral_mag_matmul(x: torch.Tensor, n_fft: int, hop: int,
                         win: int) -> torch.Tensor:
    """|STFT| as frames @ windowed-DFT-basis matmuls in bfloat16 with f32
    accumulation, the DFT output STORED in bfloat16 before squaring
    (svs_tpu mrstft.py:85-104).  x: (..., T) -> (..., n_bins, n_frames)."""
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (n_fft // 2, n_fft // 2),
               mode="reflect")[:, 0]
    frames = dsp.frame_signal(xp.to(torch.bfloat16), n_fft, hop)
    # bf16 out of an f32 accumulation
    out = torch.matmul(frames, _dft_filters(n_fft, win, x.device))
    n_bins = n_fft // 2 + 1
    re = out[..., :n_bins].float()
    im = out[..., n_bins:].float()
    power = re * re + im * im
    mag = torch.sqrt(torch.clamp(power, min=1e-8))
    return mag.transpose(-1, -2).reshape(*lead, n_bins, -1)


def _spectral_mag_kernel(x: torch.Tensor, n_fft: int, hop: int,
                         win: int) -> torch.Tensor:
    """The ``spectral_mag`` kernels (svs_torch/ops/cuda/diff_mag.py)."""
    lead = x.shape[:-1]
    out = diff_mag.spectral_mag(x.reshape(-1, x.shape[-1]), n_fft, hop, win)
    return out.reshape(*lead, *out.shape[1:])


_MAG_IMPLS = {
    "fft": _spectral_mag_fft,
    "matmul_bf16": _spectral_mag_matmul,
    "pallas_bf16": _spectral_mag_kernel,
}


def _norm0(x: torch.Tensor) -> torch.Tensor:
    """Frobenius norm with a DEFINED (zero) gradient at ``x == 0``: the
    value of ``torch.linalg.norm`` everywhere, but 0 instead of NaN as the
    gradient when x vanishes (an exactly-perfect prediction).  The inner
    where keeps the discarded sqrt branch finite (svs_tpu
    mrstft.py:126-137)."""
    return _root0(torch.sum(torch.square(x)))


def _root0(ss: torch.Tensor) -> torch.Tensor:
    """sqrt(ss) with the zero subgradient of :func:`_norm0` at 0."""
    live = ss > 0
    root = torch.sqrt(torch.where(live, ss, torch.ones_like(ss)))
    return torch.where(live, root, torch.zeros_like(ss))


def stft_loss(x: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int,
              win: int, w_sc: float = 1.0, w_log_mag: float = 1.0,
              impl: str = "matmul_bf16",
              weight: Optional[torch.Tensor] = None,
              group: Optional[Mesh] = None) -> torch.Tensor:
    """Single-resolution STFT loss (auraloss STFTLoss defaults): spectral
    convergence + log-magnitude L1.  x = prediction, y = target.

    weight: optional per-example (B,) 0/1 validity mask (x, y shaped
    (B, T)); zeroed examples drop out of both norms and the log-mag mean.
    group: the data mesh whose ranks hold the rest of the batch (``weight``
    is then required).  Both
    Frobenius norms are the global batch's (``||w(Y-X)||_F / ||wY||_F``,
    svs_tpu mrstft.py:189-194), so their squared sums are all-reduced
    before the square root (``_root0`` keeps the zero subgradient), and so
    are the log-magnitude sum and ``sum(weight)``.

    Prediction and target run as separate magnitude calls on purpose: the
    target needs no gradient, so its backward never runs."""
    if impl in ("pallas_fused", "pallas_fused_wide"):
        if x.ndim != 2:
            x = x.reshape(-1, x.shape[-1])
            y = y.reshape(-1, y.shape[-1])
            if weight is not None:
                raise ValueError(f"{impl}: weight needs (B, T) inputs")
        return fused_loss.stft_loss_fused(
            x, y, n_fft, hop, win, weight=weight, w_sc=w_sc,
            w_log_mag=w_log_mag, wide=impl.endswith("_wide"), group=group)
    mag = _MAG_IMPLS[impl]
    x_mag = mag(x, n_fft, hop, win)
    y_mag = mag(y, n_fft, hop, win)
    if weight is None:
        sc = _norm0(y_mag - x_mag) / torch.linalg.norm(y_mag)
        log_mag = torch.mean(abs_like_jax(torch.log(x_mag)
                                          - torch.log(y_mag)))
    else:
        w = weight.reshape(weight.shape + (1,) * (x_mag.ndim - 1))
        s = all_sum(torch.stack([
            torch.sum(torch.square(w * (y_mag - x_mag))),
            torch.sum(torch.square(w * y_mag)),
            torch.sum(w * abs_like_jax(torch.log(x_mag) - torch.log(y_mag))),
            torch.sum(weight)]), group)
        sc = _root0(s[0]) / torch.sqrt(s[1])
        log_mag = s[2] / (s[3] * x_mag.shape[-1] * x_mag.shape[-2])
    return w_sc * sc + w_log_mag * log_mag


def mr_stft_loss(x: torch.Tensor, y: torch.Tensor,
                 fft_sizes: Sequence[int] = (1024, 2048, 512),
                 hop_sizes: Sequence[int] = (120, 240, 50),
                 win_lengths: Sequence[int] = (600, 1200, 240),
                 impl: str = "matmul_bf16",
                 weight: Optional[torch.Tensor] = None,
                 group: Optional[Mesh] = None) -> torch.Tensor:
    """Multi-resolution STFT loss on waveforms ``(..., T)``; prediction
    first, target second (reference train.py:293 call order)."""
    total = 0.0
    for n_fft, hop, win in zip(fft_sizes, hop_sizes, win_lengths):
        total = total + stft_loss(x, y, n_fft, hop, win, impl=impl,
                                  weight=weight, group=group)
    return total / len(fft_sizes)


def combined_loss(mask: torch.Tensor, mix: torch.Tensor, voc: torch.Tensor,
                  mix_angle: torch.Tensor, voc_angle: torch.Tensor,
                  cfg: Optional[SVSConfig] = None,
                  weight: Optional[torch.Tensor] = None,
                  group: Optional[Mesh] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """The reference's full training loss (train.py:274-296):
    alpha_L1 * (masked L1 pair) + alpha_MR * MR-STFT(pred_wav, target_wav).

    The predicted wav uses the predicted magnitude and the MIXTURE phase;
    the target wav the true vocal magnitude and phase (train.py:287-290).
    Inputs are (B, 512, T) patches.  Returns (total, aux dict).
    weight: optional (B,) 0/1 validity mask, excluded from every reduction.
    group: the data mesh whose ranks hold the rest of the batch; every
    reduction is then the global batch's, the same on every rank.
    """
    cfg = cfg or SVSConfig()
    l1_total, pred_vocal = masked_l1_pair(mask, mix, voc, weight, group)
    pred_wav = patch_istft(pred_vocal, mix_angle, n_fft=cfg.window_size,
                           hop_length=cfg.hop_size)
    target_wav = patch_istft(voc, voc_angle, n_fft=cfg.window_size,
                             hop_length=cfg.hop_size)
    mr = mr_stft_loss(pred_wav, target_wav, cfg.mr_fft_sizes,
                      cfg.mr_hop_sizes, cfg.mr_win_lengths,
                      impl=cfg.mr_mag_impl, weight=weight, group=group)
    total = cfg.alpha_l1 * l1_total + cfg.alpha_mr * mr
    return total, {"l1": l1_total, "mr": mr, "total": total}
