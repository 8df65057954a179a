"""The reference's whole-song separation (zouyuoz/SVS-UNet-PyTorch
``inference.py``, batched): STFT, the mixture-max normalisation, the DC
row dropped, independent ``input_len``-frame segments (the tail zero
padded), the eval-mode U-Net's mask, the DC row masked to zero, the
masked complex spectrogram inverted, and PCM16 decode and re-quantisation
around it.  Imports nothing of the program.

The song is first zero-padded to a multiple of 2**18 samples, the
bucket at which the served decode runs (the padding reaches the mask of
the song's last segment, so it is part of the answer).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import dsp, unet

SAMPLE_BUCKET = 1 << 18


def padded_len(n: int, n_fft: int) -> int:
    return -(-max(n, n_fft) // SAMPLE_BUCKET) * SAMPLE_BUCKET


def segments(n: int, cfg: dict) -> int:
    """Segments the padded song of ``n`` samples is cut into."""
    frames = 1 + padded_len(n, cfg["window_size"]) // cfg["hop_size"]
    return -(-frames // cfg["input_len"])


def _front(y: np.ndarray, cfg: dict, device):
    """The padded waveform, its spectrogram and the normalised magnitude
    segments (n_seg, F - 1, input_len) of the mono song ``y``."""
    n = len(y)
    x = torch.from_numpy(np.asarray(y)).to(device).to(torch.float32)
    if y.dtype == np.int16:
        x = x / 32768.0
    x = F.pad(x, (0, padded_len(n, cfg["window_size"]) - n))
    n_fft, hop, seg = cfg["window_size"], cfg["hop_size"], cfg["input_len"]
    spec = dsp.stft(x, n_fft, hop)
    mag = spec.abs()
    norm = torch.clamp(mag.max(), min=1e-12)
    f, t = mag.shape
    t_pad = -(-t // seg) * seg
    mag_in = F.pad(mag[1:] / norm, (0, t_pad - t))
    return x, spec, mag_in.reshape(f - 1, t_pad // seg, seg).permute(1, 0, 2)


@torch.no_grad()
def segments_of(y: np.ndarray, cfg: dict, device) -> torch.Tensor:
    """The model's input for the song ``y``: its normalised segments."""
    return _front(y, cfg, device)[2]


@torch.no_grad()
def separate(p, y: np.ndarray, cfg: dict, device,
             conv=unet.conv_f32) -> np.ndarray:
    """The vocal estimate of the mono song ``y`` (int16 PCM: decoded
    /32768 and re-quantised with rounding half to even; or float32), of
    ``y``'s length and dtype."""
    n = len(y)
    x, spec, segs = _front(y, cfg, device)
    mask = unet.forward(p, segs, train=False, conv=conv, eps=cfg["bn_eps"])
    f, t = spec.shape
    mask = mask.permute(1, 0, 2).reshape(f - 1, -1)[:, :t]
    mask = torch.cat([torch.zeros_like(mask[:1]), mask])
    out = dsp.istft(spec * mask, cfg["window_size"], cfg["hop_size"],
                    length=x.shape[-1])[:n]
    if y.dtype == np.int16:
        out = torch.clamp(torch.round(out * 32768.0), -32768, 32767)
        return out.to(torch.int16).cpu().numpy()
    return out.cpu().numpy()
