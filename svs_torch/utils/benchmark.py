"""End-to-end throughput benchmark on the card (port of
``svs_tpu/utils/benchmark.py``; driven by ``python -m
svs_torch.cli.bench_cli``).

Headline metric: DEVICE-RESIDENT decode frames/s — the whole wav -> STFT ->
U-Net mask -> iSTFT -> wav program (on the card a replay of its captured
graph, ``infer/graphs.py``) with its input already on the card, a burst of
calls closed by one :func:`~svs_torch.utils.profiling.fetch_barrier`.
Beside it: host streaming of PCM16 songs (``stream_frames_per_sec``, which
the host link bounds), the link and device-memory calibrations, the train
step's ms (on the card its cached program's replay, ``train/graphs.py``,
and its eager body) and MFU at B = 32, and the training epoch with the
host input pipeline and with the dataset resident on the card.

Every time here is a wall clock around work that ends in a synchronise of
the card: the time a user feels.  Same function names, arguments and JSON
keys as svs_tpu's wherever the same quantity is measured.  PyTorch has no
cost model of bytes, so the train step's byte count and its floor fields
are left out (svs_tpu leaves them out too when its cost model gives none).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from svs_torch.ops.cuda import fused_loss
from svs_torch.utils.device import DeviceLike, resolve_device
from svs_torch.utils.profiling import fetch_barrier

# dense bf16 tensor-core peak FLOP/s by device name (NVIDIA's data sheets),
# the MFU denominator; the convs run in bf16 at the shipped presets
_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM
    "NVIDIA H100 PCIe": 756e12,
}

# loss paths whose magnitudes run in the hand-written kernels, launched
# through ctypes: torch's FLOP counter cannot see inside them
_KERNEL_MAG_IMPLS = ("pallas_bf16", "pallas_fused", "pallas_fused_wide")


def _device_peak_flops(device: DeviceLike) -> Optional[float]:
    """The card's bf16 peak by the LONGEST matching name prefix, whatever
    the table's order; None on the CPU or on a card not in the table."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device)
    hits = [(len(name), peak) for name, peak in _PEAK_FLOPS.items()
            if kind.startswith(name)]
    return max(hits)[1] if hits else None


def _music_fixture(n: int, sample_rate: int, seed: int = 0,
                   pcm16: bool = False) -> np.ndarray:
    """A music-like test signal rather than white noise: harmonic "vocal"
    with vibrato + low "accompaniment" + noise floor, so the PCM16 quantise
    path and the mask see a realistic magnitude distribution (throughput
    itself is shape-dependent only)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / sample_rate
    vib = 1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t)
    y = (0.3 * np.sin(2 * np.pi * 440.0 * vib * t)
         + 0.15 * np.sin(2 * np.pi * 880.0 * t)
         + 0.2 * np.sin(2 * np.pi * 130.0 * t)
         + 0.02 * rng.standard_normal(n)).astype(np.float32)
    if pcm16:
        y = (y * 32768.0).clip(-32768, 32767).astype(np.int16)
    return y


def hbm_bandwidth_bench(mib: int = 256, reps: int = 50,
                        device: DeviceLike = None) -> float:
    """Device-memory bandwidth in the same run: an elementwise scale
    over a ``mib``-MiB f32 buffer (read + write = 2x bytes), best of 3
    bursts of ``reps``.  Returns GiB/s."""
    dev = resolve_device(device)
    n = mib * (1 << 20) // 4
    y = torch.ones(n, device=dev) * 1.0000001
    fetch_barrier(y)  # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            y = y * 1.0000001
        fetch_barrier(y)
        best = min(best, (time.perf_counter() - t0) / reps)
    return (2 * n * 4) / best / (1 << 30)


def link_bandwidth_bench(mib: int = 16, reps: int = 5,
                         device: DeviceLike = None) -> Dict:
    """Host<->device link in the same run: the best of ``reps`` timed
    copies of a ``mib``-MiB f32 buffer from pageable numpy to the device and
    back, as a user's ``torch.from_numpy(x).to(dev)`` and ``t.cpu()`` do
    (``stream_frames_per_sec`` is bound by this link)."""
    dev = resolve_device(device)
    x = np.ones((mib * (1 << 20) // 4,), np.float32)
    d = torch.from_numpy(x).to(dev)
    d.cpu().numpy()  # warm both directions
    h2d = d2h = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        d = torch.from_numpy(x).to(dev)
        fetch_barrier(d)
        h2d = min(h2d, time.perf_counter() - t0)
        t0 = time.perf_counter()
        d.cpu().numpy()
        d2h = min(d2h, time.perf_counter() - t0)
    return {
        "link_h2d_mib_per_sec": round(mib / h2d, 1),
        "link_d2h_mib_per_sec": round(mib / d2h, 1),
        "link_probe_mib": mib,
    }


def train_step_bench(cfg=None, batch_size: int = 32, steps: int = 100,
                     seed: int = 0, hbm_gibps: Optional[float] = None,
                     device: DeviceLike = None) -> Dict:
    """Train-step throughput at the documented batch size (reference
    train.py:396 uses B = 32): ms/step, steps/s and MFU against the card's
    dense bf16 peak.  A fixed pre-staged random batch, so this measures the
    STEP only (the epoch bench below covers the input pipeline); best of 3
    bursts of ``steps``.

    ``train_step_ms`` is the step as ``make_train_step`` runs it (on the
    card the cached captured program's replay, ``train/graphs.py``; its
    first calls, the eager warm-up and the capture, run before the
    bursts); ``train_step_eager_ms`` times the eager body
    (``make_step_fn``) the same way, beside it.

    ``train_flops_per_step`` is what ``torch.utils.flop_counter`` counts over
    one eager body step (forward, backward and Adam; the convs and
    matmuls), taken before the program's warm-up and capture, which would
    count again.  Under a kernel-backed ``mr_mag_impl``, and under
    ``matmul_bf16`` where it ran the loss kernels (on the card,
    ``losses/mrstft.py``), it is None: the hand kernels are launched
    through ctypes, invisible to the counter, and a partial count would
    understate the MFU.  ``hbm_gibps`` (a same-run
    :func:`hbm_bandwidth_bench`) is reported beside it."""
    from torch.utils.flop_counter import FlopCounterMode

    from svs_torch.train.step import (create_train_state, make_step_fn,
                                      make_train_step)
    from svs_torch.utils.config import get_config

    dev = resolve_device(device)
    cfg = cfg or get_config("default")  # the SHIPPED config (bf16)
    rng = np.random.default_rng(seed)
    shape = (batch_size, cfg.freq_bins, cfg.input_len)
    host = {
        "mix": rng.random(shape, np.float32),
        "voc": rng.random(shape, np.float32) * 0.5,
        "mix_angle": (rng.random(shape, np.float32) - 0.5) * 6.0,
        "voc_angle": (rng.random(shape, np.float32) - 0.5) * 6.0,
    }
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    state = create_train_state(0, cfg, device=dev)
    eager, program = make_step_fn(cfg), make_train_step(cfg)
    gen = torch.Generator(dev).manual_seed(2)

    launched = fused_loss.fwd_launches
    with FlopCounterMode(display=False) as counter:
        state, aux = eager(state, batch, gen)  # one eager step, counted
    fetch_barrier(aux["total"])
    hidden = (cfg.mr_mag_impl in _KERNEL_MAG_IMPLS
              or fused_loss.fwd_launches != launched)
    flops_per_step = (None if hidden
                      else float(counter.get_total_flops()) or None)

    def best_secs(step):
        nonlocal state
        for _ in range(2):  # the program's warm-up step and its capture
            state, aux = step(state, batch, gen)
        fetch_barrier(aux["total"])
        # the state chains step to step, so the last step's loss depends
        # on the whole burst; the barrier synchronises the card either way
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(steps):
                state, aux = step(state, batch, gen)
            fetch_barrier(aux["total"])
            best = min(best, (time.perf_counter() - t0) / steps)
        return best

    best = best_secs(program)
    eager_best = best_secs(eager)
    peak = _device_peak_flops(dev)
    mfu = (flops_per_step / best / peak * 100.0
           if flops_per_step and peak else None)
    out = {
        "train_step_ms": round(best * 1e3, 2),
        "train_step_eager_ms": round(eager_best * 1e3, 2),
        "train_steps_per_sec": round(1.0 / best, 2),
        "train_batch": batch_size,
        "train_dtype": cfg.compute_dtype,
        "train_mr_mag_impl": cfg.mr_mag_impl,
        "train_flops_per_step": flops_per_step,
        "train_mfu_pct": round(mfu, 2) if mfu is not None else None,
    }
    if hbm_gibps:
        out["train_hbm_gibps"] = round(hbm_gibps, 1)
    return out


def decode_device_bench(model=None, cfg=None, secs: float = 240.0,
                        reps: int = 300, seed: int = 0,
                        device: DeviceLike = None) -> Dict:
    """DEVICE-RESIDENT whole-song decode: the padded wav -> wav decode as
    ``separate_wav`` runs it on the card (the cached captured program:
    copy into its static input, replay, copy out; ``infer/graphs.py``) run
    ``reps`` times on a waveform already on the card, closed by ONE
    barrier; best of 3 bursts.  The card's decode throughput, independent
    of the host link.  ``decode_device_eager_ms_per_song`` times the eager
    body (``separate._separate_padded``) the same way, beside it."""
    from svs_torch.infer import separate
    from svs_torch.models.unet import UNet
    from svs_torch.utils.config import get_config

    dev = resolve_device(device)
    cfg = cfg or (model.cfg if model is not None else get_config("default"))
    if model is None:
        model = UNet(cfg, generator=torch.Generator().manual_seed(0))
        model = model.to(dev).eval()
    separate._check(model, "segments")

    n = int(cfg.sample_rate * secs)
    n_pad = separate._padded_len(n, cfg)
    y = np.pad(_music_fixture(n, cfg.sample_rate, seed), (0, n_pad - n))
    y_dev = torch.from_numpy(y).to(dev)
    signature, body = separate._wav_body(cfg, True, False, "segments",
                                         False)

    @torch.inference_mode()
    def program():
        return separate._run(model, dev, y_dev, signature, body)[0]

    @torch.inference_mode()
    def eager():
        return body(model, y_dev)[0]

    def best_secs(run):
        fetch_barrier(run())  # warm (the program's first call captures it)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(reps):
                out = run()
            fetch_barrier(out)
            best = min(best, (time.perf_counter() - t0) / reps)
        return best

    best = best_secs(program)
    eager_best = best_secs(eager)
    n_frames = 1 + n // cfg.hop_size
    return {
        "decode_device_ms_per_song": round(best * 1e3, 3),
        "decode_device_song_secs": secs,
        "decode_device_frames_per_sec": round(n_frames / best, 1),
        "decode_device_realtime_x": round(secs / best, 0),
        "decode_device_eager_ms_per_song": round(eager_best * 1e3, 3),
    }


def train_epoch_bench(cfg=None, batch_size: int = 32, n_songs: int = 4,
                      song_frames: int = 1500, epochs: int = 2,
                      seed: int = 0, device_resident: bool = False,
                      epoch_scan: bool = False,
                      device: DeviceLike = None) -> Dict:
    """End-to-end training throughput: epoch wall time and patches/s over a
    real on-disk PatchDataset — host sampling + patch assembly +
    host-to-device copy + the step, i.e. what a training loop does per
    epoch minus checkpoints and validation.

    ``device_resident=True`` benches the device-resident dataset instead
    (data/device_data.py: dataset on the card, crops gathered there); its
    fields get a ``_device`` suffix.  ``epoch_scan=True`` (implies
    ``device_resident``) benches the whole epoch as replays of one captured
    CUDA graph of the step (train/scan.py; eager on the CPU), the ragged
    tail through the train step; its fields get a ``_scan`` suffix.  On the
    card every step is ``make_train_step``'s program."""
    from svs_torch.data.dataset import PatchDataset
    from svs_torch.train.step import (batch_to_device, create_train_state,
                                      make_train_step)
    from svs_torch.utils.config import get_config

    dev = resolve_device(device)
    cfg = cfg or get_config("default")
    rng = np.random.default_rng(seed)
    work = tempfile.mkdtemp(prefix="svs_epoch_bench_")
    try:
        for folder in ("mixture", "vocal"):
            os.makedirs(os.path.join(work, folder), exist_ok=True)
        for i in range(n_songs):
            base = f"{i:04d}_bench{i}"
            for folder in ("mixture", "vocal"):
                mag = rng.random((513, song_frames)).astype(np.float32)
                ang = (rng.random((513, song_frames)).astype(np.float32)
                       * 6.0 - 3.0)
                np.save(os.path.join(work, folder, f"{base}_spec.npy"), mag)
                np.save(os.path.join(work, folder, f"{base}_phase.npy"),
                        np.exp(1j * ang).astype(np.complex64))

        ds = PatchDataset(work, samples_per_song=cfg.samples_per_song,
                          input_len=cfg.input_len)
        if device_resident or epoch_scan:
            from svs_torch.data.device_data import DeviceDataset
            ds = DeviceDataset(ds, device=dev)
        state = create_train_state(0, cfg, device=dev)
        step = make_train_step(cfg)
        gen = torch.Generator(dev).manual_seed(1)

        if epoch_scan:
            from svs_torch.train import scan
            epoch_fn = scan.make_epoch_scan(cfg)

            def run_epoch(ep):
                nonlocal state
                state, losses = scan.run_epoch(epoch_fn, step, state, ds,
                                               batch_size, seed * 7 + ep, gen)
                if len(losses):
                    fetch_barrier(losses[-1])
        else:
            def run_epoch(ep):
                nonlocal state
                aux = None
                for batch in ds.batches(batch_size, shuffle=True,
                                        seed=seed * 7 + ep):
                    if not device_resident:
                        batch = batch_to_device(batch, dev)
                    state, aux = step(state, batch, gen)
                # the losses are read once per epoch, as a training loop does
                fetch_barrier(aux["total"])

        run_epoch(0)  # warm-up (cuDNN and cuBLAS set-up)
        t0 = time.perf_counter()
        for ep in range(1, epochs + 1):
            run_epoch(ep)
        secs = (time.perf_counter() - t0) / epochs
        sfx = ("_scan" if epoch_scan
               else "_device" if device_resident else "")
        return {
            f"train_epoch{sfx}_secs": round(secs, 2),
            f"train_epoch{sfx}_patches": len(ds),
            f"train_patches_per_sec{sfx}": round(len(ds) / secs, 1),
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_bench(secs: float = 240.0, reps: int = 8, seed: int = 0,
              cfg=None, compute_dtype: Optional[str] = None,
              pcm16: bool = True, train: bool = True,
              device: DeviceLike = None) -> Dict:
    """The full bench line.

    Headline ``value``: device-resident decode frames/s.
    ``stream_frames_per_sec``: sustained host streaming of ``reps`` songs of
    ``secs`` seconds — the serving configuration (PCM16 wavs in and out,
    transfers overlapped with decode).  With ``train=True`` the line also
    carries the train step's throughput and MFU at the shipped default
    config and the end-to-end epoch metrics.  A sub-bench that fails
    leaves an ``*_error`` field and the rest of the line stands.
    """
    from svs_torch.infer import separate
    from svs_torch.models.unet import UNet
    from svs_torch.utils.config import get_config

    dev = resolve_device(device)
    cfg = cfg or get_config("default")  # the SHIPPED config (bf16)
    if compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    model = UNet(cfg, generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()

    n = int(cfg.sample_rate * secs)
    y = _music_fixture(n, cfg.sample_rate, seed, pcm16=pcm16)

    out = separate.separate_wav_stream(model, [y], pcm16=pcm16, device=dev)
    if out[0].shape != y.shape or not np.isfinite(
            out[0].astype(np.float32)).all():
        raise RuntimeError("stream decode: wrong shape or non-finite output")

    # best of 3: the host side (dispatch, copies) varies run to run
    elapsed = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        outs = separate.separate_wav_stream(model, [y] * reps, pcm16=pcm16,
                                            device=dev)
        elapsed = min(elapsed, (time.perf_counter() - t0) / reps)
        if len(outs) != reps:
            raise RuntimeError(f"stream decode: {len(outs)} of {reps} songs")

    n_frames = 1 + n // cfg.hop_size
    stream_fps = n_frames / elapsed
    target_fps = 50.0 * cfg.sample_rate / cfg.hop_size

    dev_line = decode_device_bench(model, cfg, secs=secs, seed=seed,
                                   device=dev)

    result = {
        "metric": "decode_device_frames_per_sec",
        "value": dev_line["decode_device_frames_per_sec"],
        "unit": (f"frames/s (DEVICE-RESIDENT decode, "
                 f"{dev_line['decode_device_ms_per_song']} ms per "
                 f"{secs:.0f}s song = "
                 f"{dev_line['decode_device_realtime_x']:.0f}x realtime on "
                 "the card; see stream_frames_per_sec for the link-bound "
                 "host number)"),
        "vs_baseline": round(dev_line["decode_device_frames_per_sec"]
                             / target_fps, 2),
        **dev_line,
        "stream_frames_per_sec": round(stream_fps, 1),
        "stream_realtime_x": round(secs / elapsed, 0),
        "stream_io": "pcm16" if pcm16 else "f32",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    # a failing sub-bench must not take the headline with it
    try:
        result.update(link_bandwidth_bench(device=dev))
    except Exception as e:
        result["link_bench_error"] = repr(e)
    if train:
        hbm = None
        try:
            hbm = hbm_bandwidth_bench(device=dev)
        except Exception as e:
            result["hbm_bench_error"] = repr(e)
        try:
            result.update(train_step_bench(cfg, hbm_gibps=hbm, device=dev))
        except Exception as e:
            result["train_bench_error"] = repr(e)
        try:
            result.update(train_epoch_bench(cfg, device=dev))
        except Exception as e:
            result["train_epoch_bench_error"] = repr(e)
        try:
            result.update(train_epoch_bench(cfg, device_resident=True,
                                            device=dev))
        except Exception as e:
            result["train_epoch_device_bench_error"] = repr(e)
        # the epoch_scan variant stays out of the default line, as in
        # svs_tpu's; train_epoch_bench(epoch_scan=True) reaches it
    return result
