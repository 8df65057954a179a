"""Whole-song separation (port of ``svs_tpu/infer/separate.py``).

The reference runs sliding-window inference one 128-frame segment at a time
at batch 1 (reference inference.py:79-116).  Here a song's spectrogram is cut
into ALL its segments at once and masked in one batched forward on the
model's device.  The model carries its configuration (``model.cfg``): the
segment length, window and hop come from it, where svs_tpu takes a ``cfg``
argument beside its parameter pytrees.

Segment semantics preserved from the reference (inference.py:65-123):
- DC bin dropped before the model, zero DC row re-added after
- non-overlapping 128-frame segments, zero-padded tail, un-padded on output
- ``vocal_solo=False`` flips the mask to 1-mask (inference.py:102)
- magnitudes are mask * input (inference.py:107)

Shapes are padded exactly as svs_tpu pads them (segments rounded up to a
multiple of 8, samples to 2^18): in the ``whole`` and ``overlap`` modes the
zero padding reaches the model's receptive field near the song's end, so the
same padding is what keeps the two packages' outputs equal.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from svs_torch.ops import stft as dsp
from svs_torch.utils.config import SVSConfig
from svs_torch.utils.device import DeviceLike, resolve_device

_SEG_BUCKET = 8
_SAMPLE_BUCKET = 1 << 18


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _mask_segments(model: nn.Module, mag_nodc: torch.Tensor,
                   cfg: SVSConfig) -> torch.Tensor:
    """Reference semantics: independent input_len windows (inference.py:
    79-116), batched.  mag_nodc (512, T), T a multiple of input_len."""
    f, t = mag_nodc.shape
    seg_len = cfg.input_len
    segs = mag_nodc.reshape(f, t // seg_len, seg_len).permute(1, 0, 2)
    mask = model(segs)
    return mask.permute(1, 0, 2).reshape(f, t)


def _mask_whole(model: nn.Module, mag_nodc: torch.Tensor,
                cfg: SVSConfig) -> torch.Tensor:
    """Whole-song single-patch forward: the model is fully convolutional in
    time, so every frame gets full temporal context."""
    return model(mag_nodc[None])[0]


def _mask_overlap(model: nn.Module, mag_nodc: torch.Tensor,
                  cfg: SVSConfig) -> torch.Tensor:
    """50%-overlapping windows blended with a triangular crossfade
    (svs_tpu separate.py:63-96).  T must be a multiple of input_len."""
    f, t = mag_nodc.shape
    hop = cfg.input_len // 2
    # half-window pad each side so edge frames also get two full windows
    x = F.pad(mag_nodc, (hop, hop))
    rows = x.reshape(f, -1, hop)                          # (F, T/hop + 2, hop)
    segs = torch.cat([rows[:, :-1], rows[:, 1:]], dim=-1)
    segs = segs.permute(1, 0, 2)                          # (n_win, F, seg)

    mask = model(segs)

    # triangular crossfade; the ascending half of window w and descending
    # half of window w-1 sum to exactly 1 on their shared hop of frames
    asc = (torch.arange(hop, dtype=torch.float32, device=mask.device)
           + 0.5) / hop
    w = torch.cat([asc, asc.flip(0)])
    weighted = mask * w[None, None, :]
    n_rows = t // hop + 2
    acc = mask.new_zeros((n_rows, f, hop))
    acc[:-1] += weighted[:, :, :hop]
    acc[1:] += weighted[:, :, hop:]
    return acc[1:-1].permute(1, 0, 2).reshape(f, t)      # drop pad rows


_MASK_MODES = {
    "segments": _mask_segments,
    "whole": _mask_whole,
    "overlap": _mask_overlap,
}


def _check(model: nn.Module, mode: str) -> None:
    if mode not in _MASK_MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of "
                         f"{sorted(_MASK_MODES)}")
    if model.training:
        raise ValueError("separation needs the model in eval mode "
                         "(call model.eval())")


def _mask_frames(model, mag_nodc, cfg, vocal_solo: bool,
                 mode: str) -> torch.Tensor:
    mask = _MASK_MODES[mode](model, mag_nodc, cfg)
    if not vocal_solo:
        mask = 1.0 - mask
    return mask


def _model_device(model: nn.Module, device: DeviceLike) -> torch.device:
    """The model's device, which must be the one asked for (``cuda`` unless
    the caller passes ``device="cpu"``): a model left on the host is never
    run there quietly."""
    want = resolve_device(device)
    have = next(model.parameters()).device
    if have.type != want.type:
        raise ValueError(f"the model is on {have}, not on {want}: move it "
                         f"with model.to(...) or pass device={have.type!r}")
    return have


@torch.inference_mode()
def separate_magnitude(
    model: nn.Module,
    mag: np.ndarray,
    *,
    vocal_solo: bool = True,
    mode: str = "segments",
    device: DeviceLike = None,
) -> np.ndarray:
    """(513, T) float32 normalised magnitude -> masked magnitude, any T, on
    ``device`` (default ``cuda``), where the model must lie.

    mode='segments' reproduces the reference's independent 128-frame
    windows (inference.py:75-120); 'whole' runs the song as ONE patch;
    'overlap' blends 50%-overlapping windows with a triangular crossfade.
    """
    cfg = model.cfg
    _check(model, mode)
    t = mag.shape[1]
    # time padded to a bucketed multiple of input_len (separate.py:147-153)
    n_seg = max(_cdiv(t, cfg.input_len), 1)
    t_padded = _cdiv(n_seg, _SEG_BUCKET) * _SEG_BUCKET * cfg.input_len
    mag_p = np.pad(mag.astype(np.float32), ((0, 0), (0, t_padded - t)))
    m = torch.from_numpy(mag_p).to(_model_device(model, device))
    mask = _mask_frames(model, m[1:], cfg, vocal_solo, mode)
    pred = torch.cat([torch.zeros_like(m[:1]), m[1:] * mask])  # DC row 0
    return pred[:, :t].cpu().numpy()


def _separate_padded(model, y: torch.Tensor, n: int, cfg: SVSConfig,
                     vocal_solo: bool, both: bool, mode: str):
    """Padded waveform -> separated waveform(s) (separate.py:243-281).

    Uses the exact complex spectrogram and keeps the absolute scale (the
    file-mediated path loses the norm factor and re-normalises to 0.9)."""
    spec = dsp.stft(y, n_fft=cfg.window_size, hop_length=cfg.hop_size)
    mag = torch.abs(spec)
    norm = torch.clamp(mag.max(), min=1e-12)  # mixture-max norm (data.py:84-85)

    f, t = mag.shape
    seg = cfg.input_len
    t_padded = _cdiv(t, seg) * seg
    mag_in = F.pad(mag[1:] / norm, (0, t_padded - t))

    mask = _mask_frames(model, mag_in, cfg, vocal_solo, mode)[:, :t]
    mask = torch.cat([torch.zeros_like(mask[:1]), mask])  # DC row 0

    def decode(m):
        return dsp.istft(spec * m, hop_length=cfg.hop_size,
                         win_length=cfg.window_size, n_fft=cfg.window_size,
                         length=y.shape[-1])[:n]

    vocal = decode(mask)
    if both:
        # both=True complements the DC-zeroed mask (accomp DC weight 1), so
        # vocal + accomp reconstruct the input exactly
        return vocal, decode(1.0 - mask)
    return vocal


@torch.inference_mode()
def separate_wav(
    model: nn.Module,
    y: np.ndarray,
    *,
    vocal_solo: bool = True,
    both: bool = False,
    mode: str = "segments",
    device: DeviceLike = None,
) -> np.ndarray | Tuple[np.ndarray, np.ndarray]:
    """Full separation of a host waveform at the configured sample rate, on
    ``device`` (default ``cuda``), where the model must lie.

    Returns the vocal estimate (or (vocal, accompaniment) with both=True),
    same length and scale as the input.  mode as in separate_magnitude.
    """
    cfg = model.cfg
    _check(model, mode)
    n = len(y)
    n_pad = _cdiv(max(n, cfg.window_size), _SAMPLE_BUCKET) * _SAMPLE_BUCKET
    y_p = torch.from_numpy(np.pad(np.asarray(y, np.float32), (0, n_pad - n)))
    y_p = y_p.to(_model_device(model, device))
    out = _separate_padded(model, y_p, n, cfg, vocal_solo, both, mode)
    if both:
        return out[0].cpu().numpy(), out[1].cpu().numpy()
    return out.cpu().numpy()
