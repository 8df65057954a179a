"""The plain transforms and losses of the reference, in float32 on
``torch.stft`` / ``torch.istft`` (zouyuoz/SVS-UNet-PyTorch ``data.py``,
``train.py``; the MR-STFT loss is auraloss's ``MultiResolutionSTFTLoss``
at its default resolutions).  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def hann(n: int, device) -> torch.Tensor:
    return torch.hann_window(n, periodic=True, dtype=torch.float32,
                             device=device)


def stft(y: torch.Tensor, n_fft: int, hop: int, win: int = None,
         pad_mode: str = "constant") -> torch.Tensor:
    """Centred STFT of ``y (..., T)`` -> complex ``(..., n_fft//2+1,
    1 + T//hop)``: librosa's zero padding (``pad_mode='constant'``, the
    data and decode path) or torch's reflect padding (the loss), with a
    periodic Hann window of ``win`` samples centred in ``n_fft``."""
    win = win or n_fft
    lead = y.shape[:-1]
    s = torch.stft(y.reshape(-1, y.shape[-1]), n_fft, hop, win_length=win,
                   window=hann(win, y.device), center=True,
                   pad_mode=pad_mode, return_complex=True)
    return s.reshape(*lead, *s.shape[-2:])


def istft(spec: torch.Tensor, n_fft: int, hop: int,
          length: int = None) -> torch.Tensor:
    """Inverse of :func:`stft` (Hann window of ``n_fft``, squared-window
    normalisation, centre trim): ``hop * (frames - 1)`` samples, cut or
    zero-padded to ``length`` where it is given (librosa's output of the
    frames alone, brought to the song's length)."""
    lead = spec.shape[:-2]
    y = torch.istft(spec.reshape(-1, *spec.shape[-2:]), n_fft, hop,
                    window=hann(n_fft, spec.device), center=True)
    if length is not None:
        y = F.pad(y, (0, max(0, length - y.shape[-1])))[..., :length]
    return y.reshape(*lead, y.shape[-1])


def patch_istft(mag: torch.Tensor, angle: torch.Tensor, n_fft: int,
                hop: int) -> torch.Tensor:
    """train.py's ``specific_istft``: the dropped DC row put back as zeros,
    magnitude and phase angle combined, inverted."""
    mag = F.pad(mag, (0, 0, 1, 0))
    angle = F.pad(angle, (0, 0, 1, 0))
    return istft(torch.polar(mag, angle), n_fft, hop)


def spectral_mag(x: torch.Tensor, n_fft: int, hop: int,
                 win: int) -> torch.Tensor:
    s = stft(x, n_fft, hop, win, pad_mode="reflect")
    return torch.sqrt(torch.clamp(s.real ** 2 + s.imag ** 2, min=1e-8))


def mr_stft_loss(x: torch.Tensor, y: torch.Tensor, ffts: Sequence[int],
                 hops: Sequence[int], wins: Sequence[int],
                 mag=spectral_mag) -> torch.Tensor:
    """Mean over resolutions of spectral convergence
    ||Y-X||_F / ||Y||_F over the batch plus mean |log X - log Y|;
    ``x`` the prediction, ``y`` the target; ``mag`` computes the
    magnitudes (:func:`spectral_mag`, or the control's)."""
    total = 0.0
    for n_fft, hop, win in zip(ffts, hops, wins):
        xm = mag(x, n_fft, hop, win)
        ym = mag(y, n_fft, hop, win)
        sc = torch.linalg.norm(ym - xm) / torch.linalg.norm(ym)
        log_mag = torch.mean(torch.abs(torch.log(xm) - torch.log(ym)))
        total = total + sc + log_mag
    return total / len(ffts)


def combined_loss(mask, mix, voc, mix_angle, voc_angle, cfg: dict,
                  mag=spectral_mag):
    """train.py:274-296: alpha_l1 * (L1(mask*mix, voc) + L1((1-mask)*mix,
    max(mix-voc, 0))) + alpha_mr * MR-STFT(predicted vocal wav, true vocal
    wav), the prediction on the mixture's phase.  Returns (total, l1,
    mr)."""
    pred_vocal = mask * mix
    l1 = (torch.mean(torch.abs(pred_vocal - voc))
          + torch.mean(torch.abs((1.0 - mask) * mix
                                 - torch.clamp(mix - voc, min=0.0))))
    n_fft, hop = cfg["window_size"], cfg["hop_size"]
    pred_wav = patch_istft(pred_vocal, mix_angle, n_fft, hop)
    target_wav = patch_istft(voc, voc_angle, n_fft, hop)
    mr = mr_stft_loss(pred_wav, target_wav, cfg["mr_fft_sizes"],
                      cfg["mr_hop_sizes"], cfg["mr_win_lengths"], mag)
    return cfg["alpha_l1"] * l1 + cfg["alpha_mr"] * mr, l1, mr
