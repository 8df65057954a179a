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

:func:`separate_wav_stream` separates many songs in a row, optionally as
PCM16 (int16 in and out, decoded and re-quantised on the device).  On the
card it keeps the copies off the compute stream, so that one song's
transfers overlap another's decode.  :func:`separate_magnitude_mesh`
spreads one song's windows, or in ``whole`` mode its time axis, over the
ranks of a data mesh (``parallel.mesh``, ``parallel.halo``).

On the card :func:`separate_magnitude`, :func:`separate_wav` and
:func:`separate_wav_stream` run their padded body as a cached captured
program (``infer/graphs.py``), one per signature and bucketed shape, as
svs_tpu runs its jitted ones; the program computes the padded length and
the caller takes the song's slice.  On the CPU, which the caller asks for
explicitly, they run the body eagerly.  The mesh decodes' masks run as
programs too: each rank's windows (``dp.make_sp_separate``, on any CUDA
rank) and the time-sharded whole song (``halo.make_time_sharded_apply``,
over NCCL or a world of one: :func:`_routed`); the windows' cutting and the all-reduce
that brings them to rank 0 stay outside, as svs_tpu's jit covers the mask
alone.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from svs_torch.infer import graphs
from svs_torch.ops import stft as dsp
from svs_torch.parallel.mesh import Mesh, crosses, host_collectives
from svs_torch.utils import profiling
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
    pred, = _run(model, _model_device(model, device),
                 torch.from_numpy(mag_p), ("spec", mode, vocal_solo),
                 lambda mdl, m: (_separate_spec(mdl, m, cfg, vocal_solo,
                                                mode),))
    return pred[:, :t].cpu().numpy()


def _separate_spec(model, m: torch.Tensor, cfg: SVSConfig, vocal_solo: bool,
                   mode: str) -> torch.Tensor:
    """(513, T) padded normalised magnitude -> (513, T) masked magnitude
    (separate.py:114-122); the DC row dropped before the model and re-added
    as zeros."""
    mask = _mask_frames(model, m[1:], cfg, vocal_solo, mode)
    return torch.cat([torch.zeros_like(m[:1]), m[1:] * mask])


def _programmed(dev: torch.device) -> bool:
    """Whether the decode on ``dev`` runs as a cached program: on the
    card it always does; on the CPU, which a caller asks for explicitly, it
    runs eagerly (the CPU tests patch this to route the host through the
    programs)."""
    return dev.type == "cuda"


def _routed(dev: torch.device, mesh: Optional[Mesh] = None) -> bool:
    """Whether :func:`_run` takes the program: where :func:`_programmed`,
    but not for a body that holds ``mesh``'s collectives where they run on
    the host (``host_collectives``: gloo across ranks on a CUDA device),
    which no graph can hold."""
    return _programmed(dev) and (mesh is None or not host_collectives(mesh))


def _run(model, dev: torch.device, x: torch.Tensor, signature: tuple,
         body: graphs.Body, mesh: Optional[Mesh] = None) -> graphs.Outputs:
    """``body`` on ``x`` (padded, on any device) on ``dev``: the cached
    program of ``signature`` where :func:`_routed` (``mesh``: the mesh
    whose collectives the body holds, if any), else eagerly.  Returns
    fresh tensors of the padded length."""
    if _routed(dev, mesh):
        return graphs.CACHE.program(model, signature, x, body)(x)
    return body(model, x.to(dev))


def _wav_body(cfg: SVSConfig, vocal_solo: bool, both: bool, mode: str,
              pcm16: bool) -> Tuple[tuple, graphs.Body]:
    """The padded wav -> wav decode's signature and body (a tuple of its
    outputs: the vocal, and the accompaniment with ``both``)."""
    signature = ("wav", mode, vocal_solo, both, pcm16)
    if pcm16:
        return signature, lambda model, y: (_separate_padded_pcm16(
            model, y, cfg, vocal_solo, mode),)
    if both:
        return signature, lambda model, y: _separate_padded(
            model, y, cfg, vocal_solo, True, mode)
    return signature, lambda model, y: (_separate_padded(
        model, y, cfg, vocal_solo, False, mode),)


def separate_magnitude_mesh(
    model: nn.Module,
    mag: np.ndarray,
    mesh: Mesh,
    *,
    vocal_solo: bool = True,
    mode: str = "segments",
) -> Optional[np.ndarray]:
    """:func:`separate_magnitude` over a data mesh (svs_tpu separate.py:
    159-240): segment-parallel (SP), each rank masking its own contiguous
    block of the song's windows on its device with no communication; the
    masked windows then meet on rank 0, which puts the song back together
    and returns it (the other ranks return None).  Every rank calls it
    with the same ``mag`` and a model holding the same weights.

    mode='segments': the reference's independent windows; 'overlap': the
    50%-overlapping windows, whose triangular crossfade commutes with SP
    because the blend is linear in the masked frames (the numpy
    accumulation below).  The window count is padded with zero windows to
    a multiple of ``lcm(size, 8)`` (the unsharded path's bucket of 8) and
    their outputs sliced off, so no value changes.  mode='whole': the
    halo-exchange time-sharded forward of the whole song
    (``halo.separate_magnitude_time_sharded``; it pads the song to a
    multiple of ``64 * size`` frames, where :func:`separate_magnitude`
    pads to ``8 * input_len``).
    """
    if mode == "whole":
        from svs_torch.parallel import halo
        _check(model, mode)
        _model_device(model, mesh.device)
        return halo.separate_magnitude_time_sharded(model, mag, mesh,
                                                    vocal_solo=vocal_solo)
    if mode not in ("segments", "overlap"):
        raise ValueError(f"unknown mode {mode!r}; expected one of "
                         f"{sorted(_MASK_MODES)}")
    cfg = model.cfg
    _check(model, mode)
    dev = _model_device(model, mesh.device)

    t = mag.shape[1]
    seg = cfg.input_len
    nodc = mag.astype(np.float32)[1:]
    f = nodc.shape[0]
    n_seg = max(_cdiv(t, seg), 1)
    t_pad = n_seg * seg
    if mode == "segments":
        x = np.pad(nodc, ((0, 0), (0, t_pad - t)))
        segs = x.reshape(f, n_seg, seg).transpose(1, 0, 2)
    else:  # overlap: hop-stepped windows, half-window zero pad each side
        hop = seg // 2
        x = np.pad(nodc, ((0, 0), (hop, hop + t_pad - t)))
        rows = x.reshape(f, -1, hop)                  # (F, t_pad/hop+2, hop)
        segs = np.concatenate([rows[:, :-1], rows[:, 1:]],
                              axis=-1).transpose(1, 0, 2)
    n_win = len(segs)
    granule = mesh.size * _SEG_BUCKET // math.gcd(mesh.size, _SEG_BUCKET)
    n_rows = _cdiv(n_win, granule) * granule
    per = n_rows // mesh.size
    lo = mesh.rank * per
    own = np.zeros((per, f, seg), np.float32)
    have = segs[lo:min(lo + per, n_win)]
    own[:len(have)] = have

    from svs_torch.parallel.dp import make_sp_separate
    fn = make_sp_separate(mesh, cfg, vocal_solo=vocal_solo)
    out = fn(model, torch.from_numpy(own).to(dev))
    if crosses(mesh):
        # every rank's block in its place, zeros elsewhere, summed: an
        # all-reduce, which NCCL and gloo both run on CUDA tensors
        whole = out.new_zeros((n_rows, f, seg))
        whole[lo:lo + per] = out
        dist.all_reduce(whole, group=mesh.group)
        out = whole
    if not mesh.is_primary:
        return None
    masked = out.cpu().numpy()[:n_win]

    if mode == "segments":
        pred = masked.transpose(1, 0, 2).reshape(f, t_pad)
    else:
        # numpy mirror of _mask_overlap's triangular accumulation, applied
        # to the already-masked frames
        asc = (np.arange(hop, dtype=np.float32) + 0.5) / hop
        tri = np.concatenate([asc, asc[::-1]])
        weighted = masked * tri[None, None, :]
        acc = np.zeros((t_pad // hop + 2, f, hop), np.float32)
        acc[:-1] += weighted[:, :, :hop]
        acc[1:] += weighted[:, :, hop:]
        pred = acc[1:-1].transpose(1, 0, 2).reshape(f, t_pad)
    return np.concatenate(
        [np.zeros((1, t_pad), np.float32), pred])[:, :t]


def _separate_padded(model, y: torch.Tensor, cfg: SVSConfig,
                     vocal_solo: bool, both: bool, mode: str,
                     finish=None):
    """Padded waveform -> separated waveform(s) of the padded length
    (separate.py:243-281); ``finish``: applied to each output last (the
    PCM16 re-quantisation).

    Uses the exact complex spectrogram and keeps the absolute scale (the
    file-mediated path loses the norm factor and re-normalises to 0.9).
    Marks its phases (``profiling.mark``): the STFT, the U-Net, then the
    mask, the iSTFT and ``finish``."""
    profiling.mark(profiling.BEGIN, y.device)
    spec = dsp.stft(y, n_fft=cfg.window_size, hop_length=cfg.hop_size)
    mag = torch.abs(spec)
    profiling.mark("decode.stft", y.device)
    norm = torch.clamp(mag.max(), min=1e-12)  # mixture-max norm (data.py:84-85)

    f, t = mag.shape
    seg = cfg.input_len
    t_padded = _cdiv(t, seg) * seg
    mag_in = F.pad(mag[1:] / norm, (0, t_padded - t))

    mask = _mask_frames(model, mag_in, cfg, vocal_solo, mode)[:, :t]
    profiling.mark("decode.unet", y.device)
    mask = torch.cat([torch.zeros_like(mask[:1]), mask])  # DC row 0

    def decode(m):
        out = dsp.istft(spec * m, hop_length=cfg.hop_size,
                        win_length=cfg.window_size, n_fft=cfg.window_size,
                        length=y.shape[-1])
        return out if finish is None else finish(out)

    # both=True complements the DC-zeroed mask (accomp DC weight 1), so
    # vocal + accomp reconstruct the input exactly
    outs = (decode(mask), decode(1.0 - mask)) if both else decode(mask)
    profiling.mark("decode.istft", y.device)
    return outs


def _separate_padded_pcm16(model, y_i16: torch.Tensor, cfg: SVSConfig,
                           vocal_solo: bool, mode: str) -> torch.Tensor:
    """PCM16 variant (separate.py:287-301): int16 in, int16 out; the decode
    (x / 32768) and the re-quantisation run on the device, halving the
    bytes that cross the host link.  ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    y = y_i16.to(torch.float32) / 32768.0
    return _separate_padded(
        model, y, cfg, vocal_solo, False, mode,
        finish=lambda out: torch.clamp(torch.round(out * 32768.0), -32768,
                                       32767).to(torch.int16))


def _padded_len(n: int, cfg: SVSConfig) -> int:
    return _cdiv(max(n, cfg.window_size), _SAMPLE_BUCKET) * _SAMPLE_BUCKET


@torch.inference_mode()
def separate_wav_stream(
    model: nn.Module,
    songs: Sequence[np.ndarray],
    *,
    vocal_solo: bool = True,
    pcm16: bool = False,
    mode: str = "segments",
    device: DeviceLike = None,
) -> List[np.ndarray]:
    """Sustained separation of many songs, with the transfers overlapped
    (separate.py:304-348).

    songs: 1-D float32 arrays (int16 with ``pcm16``; they cross the host
    link as int16, half the bytes, and are decoded on the device).  Returns
    the vocal estimates as numpy arrays of the input's dtype, cut to each
    song's length.

    On the card, song i+1's host-to-device copy and decode are enqueued
    before song i's result is read back: the copies run from pinned host
    buffers on two side streams (one each way), ordered against the compute
    stream by events, so the card's steady cost per song is
    max(H2D, decode, D2H) rather than their sum.  The side streams read and
    write fresh buffers, never the program's static ones: on the compute
    stream the program copies the song into its static input just before
    its replay and its static output into a fresh tensor just after.
    Every buffer of a song is held until its result is read, so no stream
    reads freed memory.

    Spans: ``svs.decode.call`` the whole call; on the card, a song's
    ``svs.decode.stage_in`` (its pinned buffer, zeroed and filled, and the
    copy's enqueue), ``svs.decode.replay`` (the program's lookup and
    replay) and ``svs.decode.collect`` (with ``.wait``, the wait for its
    copy back).
    """
    with profiling.annotate("svs.decode.call", always=True):
        return _stream(model, songs, vocal_solo, pcm16, mode, device)


def _stream(model, songs, vocal_solo: bool, pcm16: bool, mode: str,
            device: DeviceLike) -> List[np.ndarray]:
    cfg = model.cfg
    _check(model, mode)
    dev = _model_device(model, device)
    np_dtype = np.int16 if pcm16 else np.float32
    signature, body = _wav_body(cfg, vocal_solo, False, mode, pcm16)

    def run(y_p: torch.Tensor) -> torch.Tensor:
        return _run(model, dev, y_p, signature, body)[0]

    if dev.type != "cuda":
        outs = []
        for y in songs:
            y = np.asarray(y, np_dtype)
            y_p = torch.from_numpy(np.pad(y, (0, _padded_len(len(y), cfg)
                                              - len(y))))
            outs.append(run(y_p)[:len(y)].numpy())
        return outs

    compute = torch.cuda.current_stream(dev)
    h2d, d2h = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    t_dtype = torch.int16 if pcm16 else torch.float32
    outs, pending = [], None
    for y in songs:
        with profiling.annotate("svs.decode.stage_in"):
            y = np.asarray(y, np_dtype)
            n = len(y)
            host_in = torch.zeros(_padded_len(n, cfg), dtype=t_dtype,
                                  pin_memory=True)
            host_in.numpy()[:n] = y
            with torch.cuda.stream(h2d):
                y_dev = host_in.to(dev, non_blocking=True)
        compute.wait_stream(h2d)
        with profiling.annotate("svs.decode.replay"):
            out = run(y_dev)[:n]
        d2h.wait_stream(compute)
        host_out = torch.empty(n, dtype=t_dtype, pin_memory=True)
        with torch.cuda.stream(d2h):
            host_out.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(d2h)
        if pending is not None:
            outs.append(_collect(*pending[:2]))
        # every buffer of the song lives until its result is read: y_dev
        # and out are read on other streams than the ones they were made on
        pending = (done, host_out, host_in, y_dev, out)
    if pending is not None:
        outs.append(_collect(*pending[:2]))
    return outs


def _collect(done: torch.cuda.Event, host_out: torch.Tensor) -> np.ndarray:
    """Wait for one song's device-to-host copy; a copy out of the pinned
    buffer, which then goes back to the allocator."""
    with profiling.annotate("svs.decode.collect"):
        with profiling.annotate("svs.decode.collect.wait", always=True):
            done.synchronize()
        return host_out.numpy().copy()


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
    y_p = torch.from_numpy(np.pad(np.asarray(y, np.float32),
                                  (0, _padded_len(n, cfg) - n)))
    signature, body = _wav_body(cfg, vocal_solo, both, mode, False)
    out = _run(model, _model_device(model, device), y_p, signature, body)
    if both:
        return out[0][:n].cpu().numpy(), out[1][:n].cpu().numpy()
    return out[0][:n].cpu().numpy()
