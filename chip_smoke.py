#!/usr/bin/env python3
"""Drive the PyTorch port (``svs_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --loss-times TREE   # loss kernels of TREE only

Phases, each printing what it found on its own line:

1. device  — the card's name and its ``nvidia-smi`` name / power limit;
2. build   — nvcc builds every hand-written kernel library from
             ``svs_torch/csrc`` (one nvcc per source, all started together);
3. kernels — each kernel against its plain PyTorch version on the card
             (TF32 off) at the main paths' shapes.  The front ends
             ``stft_magphase`` and ``stft_magnitude`` on both routes: the
             fft kernel at the decode shapes, at ``bench_cli
             --frontend``'s 240-s signal, at hop 256 and at n_fft 2048 and
             4096, the gemm kernel at n_fft 1000, and the zero signal on
             each; timed by device time (torch.profiler) beside their plain
             versions, ``torch.stft`` + ``abs`` and the gemm kernel at the
             same shapes.  The four MR-STFT loss kernels (``spectral_mag``
             and ``loss_partials``, forward and backward) at the train
             step's shapes (B = 32, 97,536 samples, all three resolutions),
             a ragged shape and a weighted batch; timed by device time
             (torch.profiler) summed over their own ``spec::`` kernels,
             each backward's two launches apart, and by CUDA events
             (``event_ms``); ``ptxas -v`` of the loss kernels printed once;
             then the four loss kernels at a geometry past each limit they
             once had (n_fft % 128, an odd hop, an odd n_fft, signal spans
             past a block's shared memory, the adjoint's 600 shifts at hop
             2), against their plain versions, timed by CUDA events;
4. slice   — the decode path through the CLIs a user calls, at the full
             width of the ``default`` preset (bf16, seeded random weights
             saved as a reference ``.pth``): ``data_cli --direction to_spec``
             -> ``infer_cli`` -> ``data_cli --direction to_wave`` on three
             synthetic 60-s songs; the kernels' launch counts are zeroed
             just before and read just after (every front-end launch on
             the fft route); one song's bf16 masks held
             against the same weights and input on the CPU; then
             ``separate_wav`` timed, with one torch.profiler trace of its
             device time by family;
5. serve   — ``python -m svs_torch.cli.serve_cli`` in its own process on
             the slice's ``.pth`` (60-s warmup on its worker thread), driven
             over HTTP: 50 serial requests of one 60-s song, a burst of 8
             distinct songs (``vocal_solo=0``, ``mode=segments``,
             ``mode=whole`` and a 44.1-kHz stereo WAV among them), each
             response held against ``separate_wav`` in this process (1 LSB),
             ``/healthz``'s counts and percentiles, the 404 / 400 / 411 /
             413 paths, SIGTERM during a second burst (200 or 503 only, exit
             0); then ``amplitude_to_db`` on the card against the CPU and
             ``viz_cli --device cuda`` (a figure where matplotlib imports,
             else an ImportError that names it); one ``serve:`` JSON line
             (serial p50 / p90, the burst's throughput over its 8192-Hz
             songs and the 44.1-kHz song's latency apart, coalescing, the
             percentiles, a serial request's device share from a trace of
             its one-song stream call, and one in-process stream call of
             the burst's songs for scale);
6. train   — the training path on the slice's spectra: ``PatchDataset``
             batches of 32, one seeded full-width ``default`` state, three
             steps from it under each of ``matmul_bf16``, ``pallas_fused``,
             ``pallas_fused_wide`` and ``pallas_bf16`` (counts zeroed just
             before each and read just after), ms per step from CUDA
             events and the device's busy share of a step from a
             torch.profiler trace;
7. bench   — the bench entry point: ``bench_cli --frontend`` (counts
             zeroed just before and read just after: 102 launches of each
             front-end kernel, all on the fft route), then the default
             line ``bench_cli --secs 60 --reps 2``
             at the ``default`` preset (PCM16 stream, device-resident
             decode, the train step at B = 32 with its MFU, the epoch with
             the host pipeline and with the dataset on the card), every
             number finite and positive; one song of the PCM16 stream held
             against ``separate_wav`` (2 LSB), and ``DeviceDataset``
             batches on the card against the host ``PatchDataset``'s
             (bitwise);
8. fit     — the training entry point at the full ``default`` preset
             (B = 32, bf16 convs, seeded weights): ``train_cli`` for two
             epochs with validation on the slice's spectra (log, metrics and
             checkpoints checked), a resume from its ``.ckpt`` for a third,
             ``infer_cli`` separating a song from that ``.ckpt``, one epoch of
             ``fit`` under each of ``matmul_bf16``, ``pallas_fused`` and
             ``pallas_bf16`` without dropout (the loss kernels' counts zeroed
             just before each and read just after; the kernel paths' mean
             loss against ``matmul_bf16``'s), one epoch traced for the
             device's idle share, and one ``fine_tune`` step with remat
             against the same step without it;
9. scan    — ``fit(epoch_scan=True)`` (each epoch's full batches as replays
             of one captured CUDA graph of the step) at the full ``default``
             preset, B = 32, 35 patches a song (3 full steps and a ragged
             tail an epoch), 2 epochs across a learning-rate drop, under
             each of ``matmul_bf16``, ``pallas_bf16`` and ``pallas_fused``
             with ``val_sdr``, against the eager fit with the same
             (capturable) Adam: per-step losses and parameters, captures
             and replays, the loss kernels' wrapper counts (eager launches
             and calls recorded into a graph, zeroed just before, read just
             after) and their launches in the fit's replays (the fit traced
             by torch.profiler); then, after the counts are read, the
             step's ms with and without the graph (CUDA events) and the
             idle share of a traced graph epoch; then SIGTERM (exit 143) at
             the first epoch and the resume from its ``.ckpt`` against the
             uninterrupted fit, and ``accum_steps = 2`` with augmentation;
10. native — the port's C++ loader: native batches bitwise equal to numpy's,
             an epoch of batches timed with each, and a ``train_cli`` epoch
             with ``'auto'`` resolved to native;
11. eval   — ``eval_cli --impl torch`` (BSS eval in float64 on the card)
             against ``--impl numpy`` on the slice's separated wavs, and
             ``validation_sdr`` of one song on the card against the host's
             BSS, no fallback;
12. dp     — the data-parallel layer (``svs_torch.parallel``): ``make_mesh``
             alone makes a world of one over NCCL, and the full-width
             ``default`` DP step at B = 32 under ``pallas_fused`` and
             ``pallas_bf16`` (the loss kernels' counts zeroed just before
             and read just after) is held against ``make_train_step`` on
             the same batch with an all-ones ``weight`` (the same bits,
             and within ``__graft_entry__``'s envelope), both timed by
             CUDA events; ``separate_magnitude_mesh`` of a 4-minute song's
             magnitude (float32) against ``separate_magnitude``; then
             whether NCCL runs two ranks on one card (a pool of two worker
             processes: its all-reduce must then be right, and the one
             refusal taken is NCCL's duplicate GPU), and two ranks on the card (gloo with CUDA tensors where NCCL
             refuses) stepping B = 2 x 16 of the float32 ``default`` model
             against the single-process B = 32 step, the ranks' states the
             same bits; any failure fails the run;
13. zero   — ZeRO-1 and FSDP (``svs_torch.parallel.zero``) beside DP, cuDNN
             deterministic: a world of one over NCCL, the full-width
             ``default`` step at B = 32 under ``pallas_fused`` and
             ``pallas_bf16`` (counts zeroed just before each step and read
             just after; each sharded step must be ``make_train_step``'s
             bits, Adam's moments included), then two ranks on the card
             over dp's backend, float32, 2 x 16: each sharded step the DP
             two-rank step's bits, each rank's resting state within 1 % of
             117.9 / 78.6 / 58.9 MB (DP / ZeRO-1 / FSDP), its peak memory
             and the steps' ms (CUDA events, in turns) printed beside;
14. parity — the U-Net at float32 on the card (cuDNN, TF32 off) against the
             same weights and input on the CPU, and one float32 ``fft``
             train step (B = 4, no dropout) on the card against the CPU.

Each phase's seconds are printed on a ``phase seconds`` line.

The line before the last is the ``nvidia-smi`` name and power limit, the one
before it the ``kernels`` JSON; the last line is the ``{"ok": true, ...}``
JSON.  Any failed check raises, so the exit code is not 0 and no result line
is printed.  Without a CUDA device, or without the repository beside it, the
script fails the same way.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): float32
# outside the tensor cores, bf16 on the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

SR = 8192
SONG_SECONDS = 60
N_SONGS = 3
# bench_cli --frontend's default signal length (seconds, not bucketed)
FRONTEND_SECONDS = 240
# kernel tolerance: tests/test_pallas.py's bound for the TPU kernel against
# the exact FFT; both sides here are f32 sums in different orders
ATOL, RTOL = 2e-3, 1e-4
# float32 U-Net, cuDNN (TF32 off) against oneDNN on the CPU: the same sums
# in other orders through 12 conv layers; the sigmoid's slope is <= 1/4
UNET_F32_ATOL = 1e-4
# bf16 U-Net, cuDNN against the CPU: both round every activation to bf16
# (2^-8 relative), so a sum taken in another order can round one ulp apart
# and carry through the layers; tests/test_torch_unet.py's bf16 bound
UNET_BF16_MAX, UNET_BF16_MEDIAN = 1e-2, 1e-3
# the MR-STFT loss kernels against their plain versions: the same bf16
# products, f32 sums in other orders (tensor-core accumulators against
# cuBLAS's f32 GEMM); the backward rounds the scaled re/im cotangents to
# bf16 on both sides, where one f32 ulp of difference moves a value by a
# bf16 ulp (tests/test_torch_cuda.py's and tests/test_fused_loss.py's bounds)
MAG_ATOL, MAG_RTOL = 2e-3, 1e-3
PARTIALS_RTOL = 1e-4
GRAD_MAX, GRAD_COS = 2e-2, 0.9999
# the train step's loss resolutions and shapes (default preset, B = 32
# patches of 128 frames -> 768 * 127 samples)
RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))
TRAIN_B, TRAIN_T = 32, 768 * 127
IMPLS = ("matmul_bf16", "pallas_fused", "pallas_fused_wide", "pallas_bf16")
# first-step MR-STFT loss of each kernel implementation against
# matmul_bf16's, same card, weights, batch and dropout masks:
# tests/test_fused_loss.py:95's bound between these paths
MR_RTOL = 5e-3
# first-step grad_norm of each kernel implementation against matmul_bf16's:
# the loss kernels' backward rounds the scaled re/im cotangents to bf16 at
# other points than the bf16 matmul path, a 2^-8 relative change per
# element with no common sign over ~10^7 elements, so the norm of the
# U-Net's gradient moves far less (8.5e-6 relative observed on the H100);
# 1e-3 leaves two orders of room and still catches a wrong adjoint
GN_RTOL = 1e-3
# float32 train step, card (cuDNN and cuFFT, TF32 off) against the CPU:
# __graft_entry__.py's envelope for one step against another
# implementation of it, except the loss, whose 3 FFT resolutions and 12
# convs sum in other orders on the two backends (1e-4 relative)
STEP_LOSS_RTOL, STEP_GN_RTOL, STEP_BN_ATOL = 1e-4, 1e-3, 1e-4
# the DP step's kernel paths and their loss-kernel launches a step
# (spectral_mag fwd, bwd, loss_partials fwd, bwd)
DP_PER_STEP = {"pallas_fused": (0, 0, 3, 3), "pallas_bf16": (6, 3, 0, 0)}
# the SP decode's song (seconds at 8192 Hz) and its bound against the
# unsharded decode: tests/test_infer_mesh.py's, float32 on both sides
SP_SECONDS, SP_ATOL = 240, 2e-5
# the state a rank holds between steps at the default preset's full width
# over two ranks (9,823,313 float32 parameters and Adam's two moments,
# counted from their shapes), MB of 1e6 bytes, and the bound on a reading
ZERO_MB = {"dp": 117.9, "zero1": 78.6, "fsdp": 58.9}
ZERO_MB_RTOL = 0.01


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def write_songs(np, wav, root: str, seed: int) -> None:
    """MUSDB-layout folder: <root>/songN/{mixture,vocals}.wav."""
    rng = np.random.default_rng(seed)
    t = np.arange(SONG_SECONDS * SR) / SR
    for i in range(N_SONGS):
        d = os.path.join(root, f"song{i}")
        os.makedirs(d)
        f0 = rng.uniform(150, 600)
        vocal = 0.3 * np.sin(2 * np.pi * f0 * t * (1 + 0.01 * np.sin(t)))
        accomp = 0.2 * rng.standard_normal(len(t))
        wav.write_wav(os.path.join(d, "mixture.wav"),
                      (vocal + accomp).astype(np.float32), SR)
        wav.write_wav(os.path.join(d, "vocals.wav"),
                      vocal.astype(np.float32), SR)


def device_events(torch, fn, reps: int = 1, cpu: bool = False):
    """The kernels that ``reps`` calls of ``fn`` launched, as (name, device
    ms, launches), from a torch.profiler trace (``cpu``: the host's
    activity traced too).  A trace without device time is taken again, up
    to three times: on the H100 one trace of work that ran held no kernel
    records (once in PR 5's runs), and a measurement, not the kernel, was
    at fault."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    for _ in range(3):
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
                  for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        if sum(ms for _, ms, _ in events) > 0:
            return events
    check(False, "the profiler saw the calls' device time")


def device_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()`` call: the summed duration of the kernels
    it launched, from a torch.profiler trace of ``reps`` calls.  Unlike
    :func:`cuda_ms` it leaves out the gaps while the host enqueues, which a
    kernel of ~20 us a call does not cover."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return sum(ms for _, ms, _ in device_events(torch, fn, reps)) / reps


def spec_kernel_ms(torch, fn, reps: int = 10, warmup: int = 3):
    """Device time of one ``fn()`` call summed over the hand-written loss
    kernels it launched (names in namespace ``spec::``), and that time by
    kernel, from a torch.profiler trace of ``reps`` calls; the padding,
    casts and fold around them are left out.

    The mean is taken over the launches the trace holds, not over
    ``reps``, and a trace that holds fewer is reported: on the H100 two
    traces of 10 calls read a kernel 1.5x faster than the six others of
    the same code while the CUDA events of the same calls did not move,
    as a trace missing about a third of its records would."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    by = {}
    for key, ms, count in device_events(torch, fn, reps):
        if "spec::" in key:
            name = key.split("(")[0].replace("void ", "")
            per_call = max(1, round(count / reps))  # launches in one call
            if count != per_call * reps:
                print(f"profiler: {count} records of {name} for {reps} "
                      f"calls; the mean is taken over the {count}")
            by[name] = by.get(name, 0.0) + ms / count * per_call
    check(sum(by.values()) > 0, "the profiler saw the loss kernels")
    return sum(by.values()), by


def loss_inputs(torch, np, n_fft: int):
    """The train step's shapes at one resolution, seeded by it: x, y
    (B, T), a magnitude cotangent and a partials cotangent."""
    rng = np.random.default_rng(n_fft)
    x, y = (torch.from_numpy((rng.standard_normal((TRAIN_B, TRAIN_T)) * 0.3)
                             .astype(np.float32)).cuda() for _ in range(2))
    n_frames = 1 + TRAIN_T // dict((r[0], r[1]) for r in RESOLUTIONS)[n_fft]
    g_mag = torch.from_numpy(rng.standard_normal(
        (TRAIN_B, n_fft // 2 + 1, n_frames)).astype(np.float32)).cuda()
    g_part = torch.from_numpy(rng.uniform(0.5, 1.5, (TRAIN_B, 3)).astype(
        np.float32)).cuda()
    return x, y, g_mag, g_part


def loss_times(torch, np, cdm, cfl) -> dict:
    """Device time (``spec_kernel_ms``) and CUDA-event time of the four
    loss kernels at each train resolution, through the wrappers of the
    ``diff_mag`` and ``fused_loss`` modules given (this tree's or an
    earlier one's)."""
    out = {}
    for n_fft, hop, win in RESOLUTIONS:
        geo = (n_fft, hop, win)
        x, y, g_mag, g_part = loss_inputs(torch, np, n_fft)
        calls = {
            "spectral_mag_fwd": lambda: cdm.spectral_mag_fwd(x, *geo),
            "spectral_mag_bwd": lambda: cdm.spectral_mag_bwd(x, g_mag, *geo),
            "loss_partials_fwd": lambda: cfl.loss_partials_fwd(x, y, *geo),
            "loss_partials_bwd": lambda: cfl.loss_partials_bwd(x, y, g_part,
                                                               *geo),
        }
        for name, fn in calls.items():
            ms, by = spec_kernel_ms(torch, fn)
            out.setdefault(name, {})[f"{n_fft}/{hop}/{win}"] = {
                "ms": ms, "by_kernel": by,
                "event_ms": cuda_ms(torch, fn, reps=10)}
    for name, shapes in out.items():
        shapes["sum"] = {k: sum(t[k] for t in shapes.values())
                         for k in ("ms", "event_ms")}
    return out


def frontend_phase(torch, np, cdsp, phase: bool):
    """The front-end kernels against their plain versions: ``stft_magphase``
    (``phase``) or ``stft_magnitude``, on the fft route (power-of-two n_fft)
    and the gemm route (n_fft 1000), with the gemm kernel timed beside the
    fft kernel at the same shapes; returns the JSON entry."""
    rng = np.random.default_rng(0)

    def signal(n_samples: int, bucket: int = 1 << 18):
        n = -(-n_samples // bucket) * bucket  # prep's 2^18-sample bucket
        y = np.zeros(n, np.float32)
        y[:n_samples] = rng.standard_normal(n_samples) * 0.3
        return torch.from_numpy(y).cuda()

    cases = [
        # (label, signal, n_fft, hop)
        ("decode 4-min song, default", signal(4 * 60 * SR), 1024, 768),
        ("main-path 60-s song, default", signal(SONG_SECONDS * SR), 1024, 768),
        ("hq44k 60-s song, hop 256 (K=4)", signal(60 * 44100), 1024, 256),
        ("4-min song, n_fft 2048", signal(4 * 60 * SR), 2048, 512),
        ("4-min song, n_fft 4096", signal(4 * 60 * SR), 4096, 1024),
        ("4-min song, n_fft 1000 (gemm route)", signal(4 * 60 * SR), 1000,
         250),
        ("zero signal", torch.zeros(1 << 18, device="cuda"), 1024, 768),
        ("zero signal, n_fft 1000", torch.zeros(1 << 18, device="cuda"),
         1000, 250),
    ]
    if phase:
        name, main_label = "stft_magphase", "decode 4-min song, default"
        kernel = cdsp.stft_magphase
    else:
        # bench_cli --frontend's own signal: 240 s, not bucketed
        name, main_label = "stft_magnitude", "bench --frontend 240-s song"
        kernel = cdsp.stft_magnitude
        cases.append((main_label, signal(FRONTEND_SECONDS * SR, bucket=1),
                      1024, 768))
    max_err = 0.0
    timing = {}
    for label, y, n_fft, hop in cases:
        via = cdsp.route(n_fft)
        plain = cdsp.plain_for(n_fft, phase)
        routes = (cdsp.fft_launches, cdsp.gemm_launches)
        got = kernel(y, n_fft, hop)
        torch.cuda.synchronize()
        moved = (cdsp.fft_launches - routes[0], cdsp.gemm_launches - routes[1])
        check(moved == ((1, 0) if via == "fft" else (0, 1)),
              f"{name} {label}: one launch on the {via} route")
        want = plain(y, n_fft, hop)
        if phase:
            (mag, ph), (ref_mag, ref_ph) = got, want
            spec, ref_spec = mag * ph, ref_mag * ref_ph
            e_spec = (spec - ref_spec).abs().max().item()
            check(torch.equal(mag, cdsp.stft_magnitude(y, n_fft, hop)),
                  f"{label}: stft_magnitude's magnitude is stft_magphase's, "
                  "bit for bit")
        else:
            mag, ref_mag = got, want
        e_mag = (mag - ref_mag).abs().max().item()
        scale = max(ref_mag.abs().max().item(), 1e-30)
        line = (f"kernel {name} {label}: route={via} samples={y.numel()} "
                f"frames={mag.shape[1]} max_abs_err mag={e_mag:.3e} ")
        if phase:
            line += f"mag*phase={e_spec:.3e} "
        line += f"max_rel_err mag={e_mag / scale:.3e}"
        print(line + (f" mag*phase={e_spec / scale:.3e}" if phase else ""))
        torch.testing.assert_close(mag, ref_mag, atol=ATOL, rtol=RTOL)
        max_err = max(max_err, e_mag)
        if phase:
            torch.testing.assert_close(spec, ref_spec, atol=ATOL, rtol=0)
            max_err = max(max_err, e_spec)
        if label.startswith("zero signal"):
            check(bool((mag == 0).all()), f"{name} {label}: mag is 0")
            if phase:
                check(bool((ph[0] == 1).all() and (ph[1] == 0).all()),
                      f"{label}: phase is exactly 1+0j")
            continue
        window = torch.hann_window(n_fft, device="cuda")
        runs = {
            "ms": lambda: kernel(y, n_fft, hop),
            "plain_ms": lambda: plain(y, n_fft, hop),
            "library_ms": lambda: torch.stft(
                y, n_fft, hop, window=window, center=True,
                pad_mode="constant", return_complex=True).abs(),
        }
        if via == "fft":
            # the gemm design at the same shape, through its C entry
            runs["earlier_ms"] = lambda: cdsp.launch(y, n_fft, hop, phase,
                                                     "gemm")
        t = {k: device_ms(torch, fn) for k, fn in runs.items()}
        # the same calls back to back by CUDA events: for a kernel of tens
        # of microseconds this reads the host's enqueue, not the card
        t["event_ms"] = cuda_ms(torch, runs["ms"])
        t["library_event_ms"] = cuda_ms(torch, runs["library_ms"])
        n_bins, n_frames = mag.shape
        # the least work of the function: per frame the window multiply, a
        # real FFT (2.5 n log2 n operations, half a complex FFT's 5 n log2 n)
        # and, per bin, |z| (3) and the two divides of the unit phase (3
        # more); the signal read once, magnitude (and phase) written once
        planes, per_bin = (3, 6) if phase else (1, 3)
        flops = n_frames * (n_fft + 2.5 * n_fft * math.log2(n_fft)
                            + per_bin * n_bins)
        bytes_ = 4 * (y.numel() + planes * n_bins * n_frames)
        t["bound_ms"] = max(flops / PEAK_F32_FLOPS, bytes_ / PEAK_BYTES) * 1e3
        t["bound_by"] = ("operations" if flops / PEAK_F32_FLOPS
                         >= bytes_ / PEAK_BYTES else "bytes")
        t["gflop"] = flops / 1e9
        t["mbytes"] = bytes_ / 1e6
        if via == "fft":
            # the kernel's own work: per frame the window multiply, the
            # n/2-point complex FFT (5 (n/2) log2(n/2)), the split step
            # (16 a bin) and the epilogue, over the f32 peak, or its bytes
            m = n_fft // 2
            form = n_frames * (n_fft + 5 * m * math.log2(m) + 16 * (m - 1)
                               + per_bin * n_bins)
        else:
            # the DFT as a GEMM: a multiply and an add per tap for each of
            # the n_fft real values of a frame's spectrum, and the basis
            form = 2 * n_frames * n_fft * n_fft
            bytes_ += 4 * n_fft * n_fft
        t["formulation_bound_ms"] = max(form / PEAK_F32_FLOPS,
                                        bytes_ / PEAK_BYTES) * 1e3
        t["formulation_gflop"] = form / 1e9
        print(f"kernel {name} {label} times: " + json.dumps(t))
        timing[label] = dict(t, samples=y.numel(), n_fft=n_fft, hop=hop,
                             route=via)
    main = timing[main_label]
    for label, t in timing.items():
        if t["route"] == "fft" and t["n_fft"] == 1024:
            print(f"kernel {name} {label}: fft {t['ms']:.5f} ms, gemm "
                  f"{t['earlier_ms']:.5f} ms ({t['earlier_ms'] / t['ms']:.2f}x)"
                  f", torch.stft + abs {t['library_ms']:.5f} ms "
                  f"({t['library_ms'] / t['ms']:.2f}x)")
    return {
        "name": name,
        "route": "cuda",
        "source": "svs_torch/csrc/stft_fft.cu",
        "replaces": ("svs_tpu/ops/pallas/dsp.py:179" if phase
                     else "svs_tpu/ops/pallas/dsp.py:115"),
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library": "torch.stft (cuFFT) + abs",
        "earlier_ms": main["earlier_ms"],
        "earlier": ("the gemm design (svs_torch/csrc/stft_magphase.cu, now "
                    "the route for n_fft that is no power of two), same "
                    "shape, same run"),
        "formulation_bound_ms": main["formulation_bound_ms"],
        "timing": "device time per call, torch.profiler, 20 calls",
        "shape": {"samples": main["samples"], "n_fft": 1024, "hop": 768},
        "other_shapes": {k: v for k, v in timing.items() if k != main_label},
    }


def build_phase(build, names, reported) -> None:
    """Build every kernel library at once, one nvcc each; print seconds,
    then what ptxas says of the kernels of the libraries ``reported``
    (registers, shared memory, spills), both reports built together."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    build.load_all(names)
    print(f"build {', '.join(names)} (one nvcc each, all started "
          f"together): {time.perf_counter() - t0:.1f} s")
    with ThreadPoolExecutor(len(reported)) as pool:
        reports = list(pool.map(build.ptxas_report, reported))
    for name, report in zip(reported, reports):
        for line in report.splitlines():
            if any(k in line for k in ("Compiling entry", "spill", "Used",
                                       "Performance")):
                print(f"ptxas {name}.cu: {line.strip()}")


def _rel_err(got, want):
    d = (got - want).abs().max().item()
    return d, d / max(want.abs().max().item(), 1e-30)


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return ((a @ b) / (a.norm() * b.norm())).item()


def _fft_ops(n_fft: int, win: int) -> float:
    """Operations of one frame's real FFT and its window multiply."""
    return win + 2.5 * n_fft * math.log2(n_fft)


def loss_bounds(name: str, geo):
    """(bound_ms, bound_by, formulation_bound_ms) of one call at the
    ``spectral.Geometry`` geo.

    bound: the function's least work, the larger of its bytes (inputs read
    once, outputs written once) over HBM and its operations (real FFTs of
    the frames, inverse FFTs in a backward, and the per-cell arithmetic)
    over the f32 peak.  formulation: the kernels' own GEMMs on the bf16
    tensor cores, a multiply and an add per term, or the bytes, whichever
    is larger: the window-deep DFT of each signal over the taps the kernels
    contract (``n_taps``, whole 64-tap stages, the same in both
    directions), and in a backward its adjoint, hop-wide rows times the
    shifts that meet the window."""
    b, t, n_fft, win = geo.batch, geo.t, geo.n_fft, geo.win
    n_bins = n_fft // 2 + 1
    frames, cells = b * geo.n_frames, b * geo.n_frames * n_bins
    fft = frames * _fft_ops(n_fft, win)
    dft = 2.0 * frames * n_fft * geo.n_taps           # one signal's DFT
    adjoint = (2.0 * b * geo.rows * geo.hop_width * geo.hop_tiles * n_fft
               * geo.n_shifts)
    sig, mag = 4 * b * t, 4 * cells
    flops, bytes_, gemm = {
        "spectral_mag_fwd": (fft + 4 * cells, sig + mag, dft),
        "spectral_mag_bwd": (2 * fft + 8 * cells, 2 * sig + mag,
                             dft + adjoint),
        "loss_partials_fwd": (2 * fft + 14 * cells, 2 * sig + 12 * b,
                              2 * dft),
        "loss_partials_bwd": (3 * fft + 20 * cells, 3 * sig + 12 * b,
                              2 * dft + adjoint),
    }[name]
    f_ms, b_ms = flops / PEAK_F32_FLOPS * 1e3, bytes_ / PEAK_BYTES * 1e3
    form_ms = max(gemm / PEAK_BF16_FLOPS * 1e3, b_ms)
    return (max(f_ms, b_ms), "operations" if f_ms >= b_ms else "bytes",
            form_ms)


# geometries past the loss kernels' old limits, which the Pallas kernels
# always took: (B, T, n_fft, hop, win, what it exercises)
WIDENED = (
    (TRAIN_B, TRAIN_T, 64, 16, 64, "n_fft % 128: DDSP's smallest scale"),
    (TRAIN_B, TRAIN_T, 1000, 125, 600, "odd hop, n_fft % 128"),
    (TRAIN_B, TRAIN_T, 129, 33, 100, "odd n_fft (no Nyquist), odd hop"),
    (TRAIN_B, TRAIN_T, 1024, 700, 1024, "loss_partials' spans in pieces"),
    (TRAIN_B, TRAIN_T, 2048, 1298, 1200, "both kernels' spans in pieces"),
    (4, 4_000, 2048, 2, 1200, "600 adjoint shifts in groups"),
)


def widened_phase(torch, np, cdm, cfl, sp) -> dict:
    """The four loss kernels at each geometry of ``WIDENED`` against their
    plain versions, within the train shapes' tolerances, timed by CUDA
    events; returns {kernel name: {geometry: numbers}}."""
    rng = np.random.default_rng(4)
    out = {}
    for b, t, n_fft, hop, win, what in WIDENED:
        geo = (n_fft, hop, win)
        g = sp.Geometry(b, t, *geo)
        x, y = (torch.from_numpy((rng.standard_normal((b, t)) * 0.3).astype(
            np.float32)).cuda() for _ in range(2))
        g_mag = torch.from_numpy(rng.standard_normal(
            (b, g.n_bins, g.n_frames)).astype(np.float32)).cuda()
        g_part = torch.from_numpy(rng.uniform(0.5, 1.5, (b, 3)).astype(
            np.float32)).cuda()
        runs = {
            "spectral_mag_fwd": (lambda: cdm.spectral_mag_fwd(x, *geo),
                                 lambda: cdm.spectral_mag_plain(x, *geo)),
            "spectral_mag_bwd": (
                lambda: cdm.spectral_mag_bwd(x, g_mag, *geo),
                lambda: cdm.spectral_mag_bwd_plain(x, g_mag, *geo)),
            "loss_partials_fwd": (
                lambda: cfl.loss_partials_fwd(x, y, *geo),
                lambda: cfl.loss_partials_plain(x, y, *geo)),
            "loss_partials_bwd": (
                lambda: cfl.loss_partials_bwd(x, y, g_part, *geo),
                lambda: cfl.loss_partials_bwd_plain(x, y, g_part, *geo)),
        }
        staging = {n: sp.dft_staging(n, hop, g.n_taps)[0] for n in (1, 2)}
        for name, (kernel, plain) in runs.items():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            abs_err, rel_err = _rel_err(got, want)
            check(bool(torch.isfinite(got).all()), f"{name} {geo} finite")
            if name.endswith("bwd"):
                cos = _cosine(got, want)
                check(rel_err < GRAD_MAX and cos > GRAD_COS,
                      f"{name} {geo}: gradient agrees")
            elif name == "loss_partials_fwd":
                torch.testing.assert_close(got, want, atol=0,
                                           rtol=PARTIALS_RTOL)
            else:
                torch.testing.assert_close(got, want, atol=MAG_ATOL,
                                           rtol=MAG_RTOL)
            ms = cuda_ms(torch, kernel, reps=5, warmup=1)
            numbers = {"B": b, "T": t, "ms": ms, "max_abs_err": abs_err,
                       "max_rel_err": rel_err, "exercises": what,
                       "staging": staging[2 if "partials" in name else 1],
                       "n_cols": g.n_cols, "n_shifts": g.n_shifts,
                       "shift_group": sp.adj_group(g.hop_width, g.n_shifts)}
            print(f"kernel {name} widened {n_fft}/{hop}/{win} B={b} T={t} "
                  f"({what}): " + json.dumps(numbers))
            out.setdefault(name, {})[f"{n_fft}/{hop}/{win}"] = numbers
    return out


def loss_kernel_phase(torch, np):
    """spectral_mag and loss_partials, forward and backward, against their
    plain versions at the train step's shapes; returns the JSON entries."""
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.ops.cuda import spectral as sp

    rng = np.random.default_rng(3)

    def wave(b, t):
        return torch.from_numpy((rng.standard_normal((b, t)) * 0.3).astype(
            np.float32)).cuda()

    def library(x, n_fft, hop, win):
        """cuFFT magnitudes: torch.stft with the centred window, reflect
        pad, then the clip (a composition of calls, used nowhere)."""
        s = torch.stft(x, n_fft, hop, win_length=win,
                       window=torch.hann_window(win, device=x.device),
                       center=True, pad_mode="reflect", return_complex=True)
        return torch.sqrt(torch.clamp(s.real ** 2 + s.imag ** 2, min=1e-8))

    def library_partials(x, y, *geo):
        mx, my = library(x, *geo), library(y, *geo)
        d = my - mx
        return torch.stack([(d * d).sum((1, 2)), (my * my).sum((1, 2)),
                            (mx.log() - my.log()).abs().sum((1, 2))], -1)

    names = ("spectral_mag_fwd", "spectral_mag_bwd", "loss_partials_fwd",
             "loss_partials_bwd")
    totals = {n: dict(ms=0.0, event_ms=0.0, plain_ms=0.0, library_ms=0.0,
                      bound_ms=0.0, formulation_bound_ms=0.0, max_abs_err=0.0,
                      shapes={}) for n in names}
    cdm.reset_counts()
    cfl.reset_counts()
    for b, t, label in ((TRAIN_B, TRAIN_T, "step"), (3, 9_001, "ragged")):
        for n_fft, hop, win in RESOLUTIONS:
            geo = (n_fft, hop, win)
            x, y = wave(b, t), wave(b, t)
            mag = cdm.spectral_mag_fwd(x, *geo)
            g_mag = torch.randn(mag.shape, device="cuda",
                                generator=torch.Generator("cuda")
                                .manual_seed(n_fft))
            g_part = torch.from_numpy(rng.uniform(0.5, 1.5, (b, 3)).astype(
                np.float32)).cuda()
            xg = x.clone().requires_grad_()
            lib_mag = library(xg, *geo)
            lib_part = library_partials(xg, y, *geo)
            runs = {
                "spectral_mag_fwd": (
                    lambda: cdm.spectral_mag_fwd(x, *geo),
                    lambda: cdm.spectral_mag_plain(x, *geo),
                    lambda: library(x, *geo)),
                "spectral_mag_bwd": (
                    lambda: cdm.spectral_mag_bwd(x, g_mag, *geo),
                    lambda: cdm.spectral_mag_bwd_plain(x, g_mag, *geo),
                    lambda: torch.autograd.grad(lib_mag, xg, g_mag,
                                                retain_graph=True)),
                "loss_partials_fwd": (
                    lambda: cfl.loss_partials_fwd(x, y, *geo),
                    lambda: cfl.loss_partials_plain(x, y, *geo),
                    lambda: library_partials(x, y, *geo)),
                "loss_partials_bwd": (
                    lambda: cfl.loss_partials_bwd(x, y, g_part, *geo),
                    lambda: cfl.loss_partials_bwd_plain(x, y, g_part, *geo),
                    lambda: torch.autograd.grad(lib_part, xg, g_part,
                                                retain_graph=True)),
            }
            for name, (kernel, plain, lib) in runs.items():
                got = kernel()
                torch.cuda.synchronize()
                want = plain()
                abs_err, rel_err = _rel_err(got, want)
                line = (f"kernel {name} {label} B={b} T={t} res={n_fft}/"
                        f"{hop}/{win}: max_abs_err={abs_err:.3e} "
                        f"max_rel_err={rel_err:.3e}")
                if name.endswith("bwd"):
                    cos = _cosine(got, want)
                    line += f" cosine={cos:.7f}"
                    check(rel_err < GRAD_MAX and cos > GRAD_COS,
                          f"{name} {label} {n_fft}: gradient agrees")
                elif name == "loss_partials_fwd":
                    torch.testing.assert_close(got, want, atol=0,
                                               rtol=PARTIALS_RTOL)
                else:
                    torch.testing.assert_close(got, want, atol=MAG_ATOL,
                                               rtol=MAG_RTOL)
                check(bool(torch.isfinite(got).all()), f"{name} finite")
                tot = totals[name]
                tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
                if label != "step":
                    print(line)
                    continue
                bound, by, form = loss_bounds(name, sp.Geometry(b, t, *geo))
                ms, split = spec_kernel_ms(torch, kernel)
                times = {"ms": ms, "by_kernel": split,
                         "event_ms": cuda_ms(torch, kernel, reps=10),
                         "plain_ms": cuda_ms(torch, plain, reps=5),
                         "library_ms": device_ms(torch, lib, reps=10),
                         "bound_ms": bound, "bound_by": by,
                         "formulation_bound_ms": form}
                print(line + " times: " + json.dumps(times))
                for k in ("ms", "event_ms", "plain_ms", "library_ms",
                          "bound_ms", "formulation_bound_ms"):
                    tot[k] += times[k]
                tot["shapes"][f"{n_fft}/{hop}/{win}"] = times
            del lib_mag, lib_part, xg

    for name in names:
        if name.endswith("bwd"):
            for shape, t in totals[name]["shapes"].items():
                print(f"kernel {name} {shape} launches: " + ", ".join(
                    f"{k} {v:.5f} ms" for k, v in t["by_kernel"].items()))

    # a weighted batch: weight [1, 0] drops row 1 out of all three sums
    x, y = wave(2, 20_000), wave(2, 20_000)
    w = torch.tensor([1.0, 0.0], device="cuda")
    a = cfl.stft_loss_fused(x, y, 1024, 120, 600, weight=w).item()
    one = cfl.stft_loss_fused(x[:1].contiguous(), y[:1].contiguous(), 1024,
                              120, 600).item()
    print(f"kernel loss_partials weight [1, 0]: {a:.7f} vs the single row "
          f"{one:.7f}")
    check(abs(a - one) <= 1e-6 * abs(one), "weight [1, 0] drops row 1")
    print(f"kernel check launches: spectral_mag {cdm.fwd_launches} fwd "
          f"{cdm.bwd_launches} bwd, loss_partials {cfl.fwd_launches} fwd "
          f"{cfl.bwd_launches} bwd")
    widened = widened_phase(torch, np, cdm, cfl, sp)

    sources = {"spectral_mag": ("svs_torch/csrc/diff_mag.cu",
                                ("svs_tpu/ops/pallas/diff_mag.py:130",
                                 "svs_tpu/ops/pallas/diff_mag.py:171")),
               "loss_partials": ("svs_torch/csrc/fused_loss.cu",
                                 ("svs_tpu/ops/pallas/fused_loss.py:327",
                                  "svs_tpu/ops/pallas/fused_loss.py:379"))}
    entries = []
    for name in names:
        tot = totals[name]
        src, (fwd_at, bwd_at) = sources[name.rsplit("_", 1)[0]]
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": fwd_at if name.endswith("fwd") else bwd_at,
            "launches": None,  # filled from the train phase
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            # what bounds the larger part of the three calls' sum
            "bound_by": max(("bytes", "operations"), key=lambda by: sum(
                t["bound_ms"] for t in tot["shapes"].values()
                if t["bound_by"] == by)),
            "library_ms": tot["library_ms"],
            "event_ms": tot["event_ms"],
            "timing": ("ms: device time per call summed over the spec:: "
                       "kernels (torch.profiler, 10 calls); library_ms: "
                       "device time of all its kernels; event_ms and "
                       "plain_ms: CUDA events over back-to-back calls"),
            "library": "composition: torch.stft (cuFFT) magnitudes"
                       + (", the three sums" if "partials" in name else "")
                       + (", autograd backward" if name.endswith("bwd")
                          else ""),
            "formulation_bound_ms": tot["formulation_bound_ms"],
            "shape": {"B": TRAIN_B, "T": TRAIN_T,
                      "per": "one call at each of the three resolutions"},
            "shapes": tot["shapes"],
            "widened": widened[name],
        })
    return entries


def train_phase(torch, np, spec: str):
    """Three steps from one seeded full-width state under each
    mr_mag_impl; returns (launch counts of the phase, first batch)."""
    from svs_torch.data.dataset import PatchDataset
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import get_config

    ds = PatchDataset(spec, samples_per_song=64, input_len=128)
    host = list(ds.batches(TRAIN_B, seed=0, n_steps=4))
    batches = [tstep.batch_to_device(b, "cuda") for b in host]
    # per step: (spectral_mag fwd, bwd, loss_partials fwd, bwd)
    per_step = {"matmul_bf16": (0, 0, 0, 0), "pallas_fused": (0, 0, 3, 3),
                "pallas_fused_wide": (0, 0, 3, 3),
                "pallas_bf16": (6, 3, 0, 0)}
    total = [0, 0, 0, 0]
    first_mr, first_gn = {}, {}
    for impl in IMPLS:
        cfg = dataclasses.replace(get_config("default"), mr_mag_impl=impl)
        state = tstep.create_train_state(0, cfg, device="cuda")
        step = tstep.make_train_step(cfg)
        gen = torch.Generator("cuda").manual_seed(1)
        cdm.reset_counts()
        cfl.reset_counts()
        ms, metrics = [], []
        for batch in batches[:3]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, batch, gen)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            metrics.append({k: float(v) for k, v in m.items()})
        counts = (cdm.fwd_launches, cdm.bwd_launches, cfl.fwd_launches,
                  cfl.bwd_launches)
        want = tuple(3 * n for n in per_step[impl])
        check(counts == want, f"{impl}: kernel launches {counts} == {want} "
              "(spectral_mag fwd/bwd, loss_partials fwd/bwd) in 3 steps")
        total = [a + c for a, c in zip(total, counts)]
        for m in metrics:
            check(all(math.isfinite(v) for v in m.values()),
                  f"{impl}: finite losses and grad_norm")
        first_mr[impl] = metrics[0]["mr"]
        first_gn[impl] = metrics[0]["grad_norm"]
        busy = device_breakdown(
            torch, lambda: step(state, batches[3], gen), f"train {impl} step",
            (("loss_kernels", ("spec::",)),) + FAMILIES)
        steady = sum(ms[1:]) / len(ms[1:])
        print(f"train {impl}: ms per step {[round(v, 3) for v in ms]} "
              f"(steps 2-3 mean {steady:.3f}); device busy {busy:.3f} ms, "
              f"idle share {1.0 - busy / steady:.3f}; launches "
              f"{list(counts)}; metrics step 1 {json.dumps(metrics[0])}, "
              f"step 3 {json.dumps(metrics[2])}")
        del state, step
    for impl in IMPLS[1:]:
        rel = abs(first_mr[impl] - first_mr["matmul_bf16"]) / abs(
            first_mr["matmul_bf16"])
        print(f"train {impl}: first-step mr {first_mr[impl]:.7f} vs "
              f"matmul_bf16 {first_mr['matmul_bf16']:.7f}, rel {rel:.2e} "
              f"(bound {MR_RTOL:g})")
        check(rel < MR_RTOL, f"{impl}: first-step mr near matmul_bf16's")
        gn = abs(first_gn[impl] - first_gn["matmul_bf16"]) / first_gn[
            "matmul_bf16"]
        print(f"train {impl}: first-step grad_norm {first_gn[impl]:.7f} vs "
              f"matmul_bf16 {first_gn['matmul_bf16']:.7f}, rel {gn:.2e} "
              f"(bound {GN_RTOL:g})")
        check(gn < GN_RTOL, f"{impl}: first-step grad_norm near matmul_bf16's")
    names = ("spectral_mag_fwd", "spectral_mag_bwd", "loss_partials_fwd",
             "loss_partials_bwd")
    return dict(zip(names, total)), host[0]


# fit: patches a song at B = 32 (3 songs: 3 steps an epoch)
FIT_SAMPLES = 32


def _read_lines(path: str):
    with open(path) as f:
        return f.read().splitlines()


def fit_phase(torch, np, work: str):
    """The training entry point at the full default preset on the slice's
    spectra; returns the loss kernels' launch counts of the two ``fit``
    runs under the kernel paths (each zeroed just before and read just
    after) and the numbers of the phase."""
    from svs_torch.cli import infer_cli, train_cli
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.train import checkpoint as ckpt
    from svs_torch.train import flax_msgpack
    from svs_torch.train import loop
    from svs_torch.train import step as tstep
    from svs_torch.models.unet import param_count
    from svs_torch.utils.config import get_config

    spec = os.path.join(work, "spec")
    ckpt_dir, log_dir = os.path.join(work, "CKPT"), os.path.join(work, "LOG")
    numbers = {}
    common = ["--train_folder", spec, "--valid_folder", spec,
              "--batch_size", str(TRAIN_B), "--samples_per_song",
              str(FIT_SAMPLES), "--val_interval", "1", "--label", "smoke",
              "--ckpt_dir", ckpt_dir, "--log_dir", log_dir,
              "--device", "cuda", "--preset", "default"]
    steps = -(-N_SONGS * FIT_SAMPLES // TRAIN_B)

    t0 = time.perf_counter()
    rc = train_cli.main(common + ["--epoch", "2", "--load_path",
                                  os.path.join(work, "none.ckpt")])
    numbers["train_cli_2_epochs_s"] = time.perf_counter() - t0
    check(rc == 0, "train_cli exit code 0")
    log = _read_lines(os.path.join(log_dir, "log_smoke.txt"))
    print("fit: train_cli log " + json.dumps(log))
    check(len(log) == 4 and [x.startswith("Val ") for x in log]
          == [False, True, False, True]
          and all(math.isfinite(float(x.split()[-1])) for x in log),
          "train_cli log: a finite loss per epoch, each with a Val line")
    metrics = [json.loads(x) for x in _read_lines(
        os.path.join(log_dir, "metrics_smoke.jsonl"))]
    check(all(math.isfinite(v) for r in metrics for v in r.values()),
          "metrics lines finite")
    numbers["epoch_s"] = [r["secs"] for r in metrics if "secs" in r]
    latest = os.path.join(ckpt_dir, "svs_smoke.ckpt")
    check(os.path.exists(latest) and os.path.exists(
        os.path.join(ckpt_dir, "svs_best_smoke.ckpt")),
        "svs_best_smoke.ckpt and svs_smoke.ckpt written")

    def saved(path):
        with open(path, "rb") as f:
            raw = flax_msgpack.unpackb(f.read())
        return raw["epoch"], raw["step"]

    check(saved(latest) == (2, 2 * steps), f"latest ckpt at epoch 2, step "
          f"{2 * steps}: {saved(latest)}")
    t0 = time.perf_counter()
    rc = train_cli.main(common + ["--epoch", "3", "--load_path", latest])
    numbers["resume_1_epoch_s"] = time.perf_counter() - t0
    check(rc == 0 and saved(latest) == (3, 3 * steps),
          f"resume carried on to epoch 3, step {3 * steps}: {saved(latest)}")
    print(f"fit: resumed from epoch 2 to {saved(latest)}")

    masked = os.path.join(work, "masked_ckpt")
    rc = infer_cli.main(["--model_path", latest, "--tar", masked,
                         "--mixture_folder", os.path.join(spec, "mixture"),
                         "--preset", "default", "--limit", "1",
                         "--device", "cuda"])
    check(rc == 0, "infer_cli from the .ckpt exit code 0")
    out = np.load(os.path.join(masked, "0000_song0_spec.npy"))
    mix = np.load(os.path.join(spec, "mixture", "0000_song0_spec.npy"))
    check(out.shape == mix.shape and np.isfinite(out).all()
          and (out[1:] <= mix[1:] + 1e-6).all(),
          "infer_cli from the .ckpt: shape, finite, |mask| <= 1")

    # fit under each loss path, one epoch, no dropout, one seeded state
    per_step = {"matmul_bf16": (0, 0, 0, 0), "pallas_fused": (0, 0, 3, 3),
                "pallas_bf16": (6, 3, 0, 0)}
    launches = [0, 0, 0, 0]
    means = {}
    for impl in per_step:
        cfg = dataclasses.replace(get_config("default"), mr_mag_impl=impl,
                                  dropout_rate=0.0,
                                  samples_per_song=FIT_SAMPLES)
        opts = loop.TrainOptions(
            train_folder=spec, valid_folder="none", label=f"fit_{impl}",
            epoch=1, batch_size=TRAIN_B, load_path="none",
            ckpt_dir=ckpt_dir, log_dir=log_dir, progress=False,
            device="cuda")
        cdm.reset_counts()
        cfl.reset_counts()
        state = loop.fit(opts, cfg)
        counts = (cdm.fwd_launches, cdm.bwd_launches, cfl.fwd_launches,
                  cfl.bwd_launches)
        want = tuple(steps * n for n in per_step[impl])
        check(counts == want, f"fit {impl}: kernel launches {counts} == "
              f"{want} (spectral_mag fwd/bwd, loss_partials fwd/bwd)")
        launches = [a + c for a, c in zip(launches, counts)]
        log = _read_lines(os.path.join(log_dir, f"log_fit_{impl}.txt"))
        means[impl] = float(log[0])
        print(f"fit {impl}: epoch mean loss {means[impl]:.7f}, launches "
              f"{list(counts)}, params {param_count(state.model)}")
        check(param_count(state.model) == 9_823_313, "full-width default")
        del state
    for impl in ("pallas_fused", "pallas_bf16"):
        rel = abs(means[impl] - means["matmul_bf16"]) / abs(
            means["matmul_bf16"])
        print(f"fit {impl}: epoch mean loss vs matmul_bf16 rel {rel:.2e} "
              f"(bound {MR_RTOL:g})")
        check(rel < MR_RTOL, f"fit {impl}: mean loss near matmul_bf16's")

    # the device's busy share of an epoch: two fit calls traced, one
    # epoch and none (the same set-up: the dataset's upload, the state),
    # the difference of their device time over the epoch's seconds
    cfg = dataclasses.replace(get_config("default"),
                              samples_per_song=FIT_SAMPLES)
    busy = {}
    for epochs in (1, 0):
        opts = loop.TrainOptions(
            train_folder=spec, valid_folder="none",
            label=f"fit_traced{epochs}", epoch=epochs, batch_size=TRAIN_B,
            load_path="none", ckpt_dir=ckpt_dir, log_dir=log_dir,
            progress=False, device="cuda")
        busy[epochs] = sum(ms for _, ms, _ in device_events(
            torch, lambda: loop.fit(opts, cfg)))
    traced = [json.loads(x) for x in _read_lines(
        os.path.join(log_dir, "metrics_fit_traced1.jsonl"))][0]["secs"]
    epoch_busy = busy[1] - busy[0]
    numbers.update(traced_epoch_s=traced, traced_epoch_busy_ms=epoch_busy,
                   traced_setup_busy_ms=busy[0],
                   traced_idle_share=1.0 - epoch_busy / (traced * 1e3))
    print(f"fit: one traced epoch of {steps} steps at B={TRAIN_B}: "
          f"{traced:.3f} s, device busy {epoch_busy:.3f} ms (fit calls of "
          f"one epoch and none: {busy[1]:.3f} - {busy[0]:.3f}), idle share "
          f"{numbers['traced_idle_share']:.3f}")

    # remat: one fine_tune step with and without, same state and masks
    cfg = get_config("fine_tune")
    rng = np.random.default_rng(8)
    b = 4
    mix = rng.random((b, 512, cfg.input_len)).astype(np.float32)
    batch = {"mix": mix, "voc": (mix * rng.random(mix.shape)).astype(
        np.float32)}
    for k in ("mix_angle", "voc_angle"):
        batch[k] = rng.uniform(-np.pi, np.pi, mix.shape).astype(np.float32)
    batch = tstep.batch_to_device(batch, "cuda")
    res = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        state = tstep.create_train_state(0, c, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        _, m = tstep.make_train_step(c)(
            state, batch, torch.Generator("cuda").manual_seed(1))
        res[remat] = ({k: float(v) for k, v in m.items()},
                      torch.cuda.max_memory_allocated() / 2**20)
        del state
    (m0, mem0), (m1, mem1) = res[False], res[True]
    loss_rel = abs(m1["total"] - m0["total"]) / abs(m0["total"])
    gn_rel = abs(m1["grad_norm"] - m0["grad_norm"]) / m0["grad_norm"]
    print(f"fit: fine_tune step B={b} x {cfg.input_len} frames, remat vs "
          f"not: total {m1['total']:.7f} vs {m0['total']:.7f} (rel "
          f"{loss_rel:.2e}), grad_norm rel {gn_rel:.2e}; peak memory "
          f"{mem1:.0f} vs {mem0:.0f} MiB")
    check(loss_rel <= 1e-6, "remat: the same loss")
    check(gn_rel < GN_RTOL, "remat: the same grad_norm")
    numbers.update(remat_peak_mib=mem1, no_remat_peak_mib=mem0)
    print("fit numbers: " + json.dumps(numbers))
    names = ("spectral_mag_fwd", "spectral_mag_bwd", "loss_partials_fwd",
             "loss_partials_bwd")
    return dict(zip(names, launches))


# scan: patches a song at B = 32 (3 songs, 105 patches: 3 full steps and a
# ragged tail of 9 an epoch), 2 epochs with the learning-rate drop at the
# second and validation at its end
SCAN_SAMPLES = 35
SCAN_EPOCHS = 2
# graph replay against the eager step, per-step losses: the same kernels on
# the same inputs and the same (capturable) Adam, so the same bits on the
# H100; the bound is the acceptance's
SCAN_LOSS_RTOL = 1e-5
# per step: (spectral_mag fwd, bwd, loss_partials fwd, bwd) wrapper calls
LOSS_PER_STEP = {"matmul_bf16": (0, 0, 0, 0), "pallas_fused": (0, 0, 3, 3),
                 "pallas_fused_wide": (0, 0, 3, 3),
                 "pallas_bf16": (6, 3, 0, 0)}
LOSS_NAMES = ("spectral_mag_fwd", "spectral_mag_bwd", "loss_partials_fwd",
              "loss_partials_bwd")


def _kernel_of(name: str):
    """A loss kernel's profiler name -> (function, direction) or None:
    ``spec::dft_wgmma<NSIG, EPI, FRAG>`` (NSIG 1 spectral_mag, 2
    loss_partials; EPI 0/1 forward, 2/3 backward) and the backward's
    ``spec::adjoint_wgmma``."""
    if "spec::dft_wgmma<" in name:
        nsig, epi = (int(v) for v in
                     name.split("dft_wgmma<")[1].split(",")[:2])
        fn = "spectral_mag" if nsig == 1 else "loss_partials"
        return f"{fn}_{'fwd' if epi < 2 else 'bwd'}"
    if "spec::adjoint_wgmma<" in name:
        return "adjoint"
    return None


def _loss_counts():
    """The loss kernels' wrapper counts: (launches, calls captured into a
    graph), each in LOSS_NAMES order."""
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    return ((cdm.fwd_launches, cdm.bwd_launches, cfl.fwd_launches,
             cfl.bwd_launches),
            (cdm.fwd_captured, cdm.bwd_captured, cfl.fwd_captured,
             cfl.bwd_captured))


def _recording_fit(torch, opts, cfg, capturable=False, trace=False,
                   stop=False):
    """``loop.fit(opts, cfg)`` with every step's ``total`` recorded in
    order (the eager steps', the scan's tail included, and each graph
    epoch's loss vector).  ``capturable``: the state's Adam in its
    capturable form, as under ``epoch_scan`` (an eager fit to hold a graph
    fit against); ``trace``: the whole fit under torch.profiler, its loss
    kernels' device launches counted by ``_kernel_of``; ``stop``: SIGTERM
    during the first epoch, and the fit's exit code kept.  Returns (state,
    losses, seen): ``seen`` holds the epoch function and its last
    arguments, the traced launches and the exit code."""
    import signal

    from torch.profiler import ProfilerActivity, profile

    from svs_torch.train import loop
    from svs_torch.train import scan

    totals, seen = [], {}
    make_step, make_scan = loop.make_train_step, scan.make_epoch_scan
    make_opt = loop.make_optimizer

    def step_factory(c):
        step = make_step(c)

        def run(state, batch, gen=None):
            state, m = step(state, batch, gen)
            totals.append(m["total"].reshape(1))
            return state, m
        return run

    def scan_factory(*a, **k):
        epoch = make_scan(*a, **k)
        seen["epoch"] = epoch

        def run(*args):
            if stop:
                os.kill(os.getpid(), signal.SIGTERM)
            state, losses = epoch(*args)
            seen["args"] = args
            totals.append(losses)
            return state, losses
        return run

    def optimizer(c, **k):
        return make_opt(c, **{**k, "capturable": True})

    loop.make_train_step, scan.make_epoch_scan = step_factory, scan_factory
    if capturable:
        loop.make_optimizer = optimizer
    prof = profile(activities=[ProfilerActivity.CUDA]) if trace else None
    state = None
    try:
        with prof if trace else contextlib.nullcontext():
            try:
                state = loop.fit(opts, cfg)
            except SystemExit as e:
                if not stop:
                    raise
                seen["code"] = e.code
            torch.cuda.synchronize()
    finally:
        loop.make_train_step, scan.make_epoch_scan = make_step, make_scan
        loop.make_optimizer = make_opt
    if trace:
        kernels = {}
        for ev in prof.key_averages():
            k = _kernel_of(ev.key)
            if k and ev.device_type == torch.autograd.DeviceType.CUDA:
                kernels[k] = kernels.get(k, 0) + ev.count
        seen["kernels"] = kernels
    losses = torch.cat(totals).cpu().numpy() if totals else None
    return state, losses, seen


def _param_envelope(torch, a, b, lr: float):
    d = torch.cat([(p - q).abs().flatten().float() for p, q in
                   zip(a.model.parameters(), b.model.parameters())])
    return d.max().item(), d.mean().item(), 2.1 * lr


def _graph_vs_eager(torch, np, label, eager, graphed, lr):
    """Per-step losses and parameters of a graph run against the eager run
    of the same fit; prints and checks; returns the largest relative
    difference of a step's loss."""
    (s_e, l_e, _), (s_g, l_g, _) = eager, graphed
    check(l_e.shape == l_g.shape and np.isfinite(l_g).all(),
          f"{label}: {l_e.shape} step losses either way, finite")
    rel = float(np.max(np.abs(l_g - l_e) / np.abs(l_e)))
    pmax, pmean, bound = _param_envelope(torch, s_e, s_g, lr)
    print(f"{label}: {len(l_e)} step losses graph vs eager, max rel diff "
          f"{rel:.3e} (bound {SCAN_LOSS_RTOL:g}); params max |d| "
          f"{pmax:.3e} (bound {bound:.3e}), mean {pmean:.3e} (bound 2e-4)")
    check(rel <= SCAN_LOSS_RTOL, f"{label}: step losses within "
          f"{SCAN_LOSS_RTOL:g} relative of the eager run's")
    check(s_e.step == s_g.step, f"{label}: the same step count")
    check(pmax <= bound and pmean < 2e-4,
          f"{label}: parameters within the envelope")
    return rel


def scan_phase(torch, np, work: str):
    """``fit(epoch_scan=True)``, the whole epoch as replays of a captured
    CUDA graph, against the eager fit (its Adam in the same capturable
    form) under each loss path.  The graph fits run under torch.profiler,
    so the loss kernels' launches in their replays are counted in the fit
    itself.  Returns, per loss kernel, summed over the graph fits under the
    kernel paths: the wrappers' eager launches (the warm-up step, the
    tails, validation) and calls recorded into a graph (each count zeroed
    just before the fit and read just after), and the replays' launches
    (the profiler's count less the eager launches); and the phase's
    numbers."""
    from svs_torch.data.device_data import gather_crops
    from svs_torch.evaluation import bss_torch
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.train import checkpoint as ckpt
    from svs_torch.train import flax_msgpack
    from svs_torch.train import loop
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import get_config

    spec = os.path.join(work, "spec")
    ckpt_dir, log_dir = os.path.join(work, "CKPT"), os.path.join(work, "LOG")
    n_full = N_SONGS * SCAN_SAMPLES // TRAIN_B
    check(n_full == 3 and N_SONGS * SCAN_SAMPLES % TRAIN_B,
          "3 full steps and a ragged tail an epoch")
    n_val = -(-N_SONGS * SCAN_SAMPLES // TRAIN_B)

    def opts(label, **kw):
        base = dict(train_folder=spec, valid_folder=spec, label=label,
                    epoch=SCAN_EPOCHS, batch_size=TRAIN_B, load_path="none",
                    ckpt_dir=ckpt_dir, log_dir=log_dir, progress=False,
                    device_data="on", val_interval=SCAN_EPOCHS,
                    save_every=SCAN_EPOCHS, device="cuda")
        base.update(kw)
        return loop.TrainOptions(**base)

    def config(impl, **kw):
        return dataclasses.replace(get_config("default"), mr_mag_impl=impl,
                                   samples_per_song=SCAN_SAMPLES,
                                   lr_drop_epoch=1, **kw)

    lr = get_config("default").learning_rate
    # matmul_bf16 without dropout and from one .ckpt, so that its graph fit
    # is also the uninterrupted run the resume is held against (a resumed
    # run draws dropout from its seed again, and its Adam takes the file's
    # float32 betas); the kernel paths with dropout, their masks drawn from
    # the generator the graph registers
    init = os.path.join(ckpt_dir, "scan_init.ckpt")
    ckpt.save(init, tstep.create_train_state(
        0, config("matmul_bf16"), device="cuda"))
    runs = {"matmul_bf16": dict(dropout_rate=0.0),
            "pallas_bf16": {}, "pallas_fused": {}}
    numbers, calls, captured, replayed = {}, {}, {}, {}
    for impl, cfg_kw in runs.items():
        cfg = config(impl, **cfg_kw)
        load = dict(load_path=init) if cfg_kw else {}
        t0 = time.perf_counter()
        eager = _recording_fit(torch, opts(f"eager_{impl}", **load), cfg,
                               capturable=True)
        t1 = time.perf_counter()
        cdm.reset_counts()
        cfl.reset_counts()
        # traced under the kernel paths (matmul_bf16 runs no loss kernel)
        graphed = _recording_fit(
            torch, opts(f"scan_{impl}", epoch_scan=True, val_sdr=True,
                        **load), cfg, trace=impl != "matmul_bf16")
        t2 = time.perf_counter()
        got, rec = _loss_counts()
        epoch, args = graphed[2]["epoch"], graphed[2]["args"]
        seen = graphed[2].get("kernels", {})
        # eager launches: the warm-up step, a tail an epoch and the
        # validation batches' forward; captured: both captures (the rate
        # drops at the second epoch); the rest of the steps are replays
        per = LOSS_PER_STEP[impl]
        n_rep = SCAN_EPOCHS * n_full - 1
        eager_steps = 1 + SCAN_EPOCHS
        want = tuple(v * (eager_steps + (n_val if i % 2 == 0 else 0))
                     for i, v in enumerate(per))
        want_rec = tuple(2 * v for v in per)
        eager_by_kernel = dict(zip(LOSS_NAMES, got))
        eager_by_kernel["adjoint"] = got[1] + got[3]
        rep = {k: n - eager_by_kernel[k] for k, n in seen.items()}
        per_kernel = dict(zip(LOSS_NAMES, per))
        per_kernel["adjoint"] = per[1] + per[3]
        want_rep = {k: n_rep * v for k, v in per_kernel.items() if v}
        print(f"scan {impl}: fit {SCAN_EPOCHS} epochs eager "
              f"{t1 - t0:.2f} s, graph {t2 - t1:.2f} s (with val_sdr, "
              f"traced under the kernel paths); captures {epoch.captures}, "
              f"replays {epoch.replays}; wrapper launches {list(got)} (want "
              f"{list(want)}), captured calls {list(rec)} (want "
              f"{list(want_rec)}); the fit's trace: loss kernels "
              f"{json.dumps(seen)}, replays' {json.dumps(rep)} (want "
              f"{json.dumps(want_rep)})")
        check(epoch.captures == 2, f"scan {impl}: captured at epoch 1 and "
              "again after the learning-rate drop")
        check(epoch.replays == n_rep, f"scan {impl}: {n_rep} replays")
        check(got == want and rec == want_rec,
              f"scan {impl}: wrapper launches {got} == {want}, captured "
              f"{rec} == {want_rec}")
        check(rep == want_rep, f"scan {impl}: the fit's replays ran the "
              f"loss kernels {rep} == {want_rep}")
        rel = _graph_vs_eager(torch, np, f"scan {impl}", eager, graphed, lr)
        if impl == "matmul_bf16":
            # the measurements below train the state on: keep the fit's end
            done = graphed[0]
            full = (types.SimpleNamespace(model=copy.deepcopy(done.model),
                                          step=done.step), graphed[1], None)
        val = [json.loads(x) for x in _read_lines(
            os.path.join(log_dir, f"metrics_scan_{impl}.jsonl"))][-1]
        check(val.get("sdr_songs") == N_SONGS
              and all(math.isfinite(val[f"vocal_{k}"])
                      for k in ("sdr", "sir", "sar", "nsdr")),
              f"scan {impl}: val_sdr wrote the vocal SDR fields {val}")
        calls[impl], captured[impl], replayed[impl] = got, rec, rep

        # measurements after the fit (its counts are read): the step's
        # time with the graph (replays of the last epoch's index matrices,
        # 3 steps a call) and eager (gather and step, torch's host-form
        # Adam, as the eager fit runs it), by CUDA events, and the device's
        # busy share of one traced graph epoch
        state, planes, songs, starts, gen = args[:5]
        fn = lambda: epoch(state, planes, songs, starts, gen)  # noqa: E731
        graph_ms = cuda_ms(torch, fn, reps=5, warmup=1) / n_full
        busy = sum(ms for _, ms, _ in device_events(torch, fn))
        step = tstep.make_train_step(cfg)
        host_form = tstep.create_train_state(0, cfg, device="cuda")
        s_t = torch.as_tensor(songs[0], dtype=torch.int64, device="cuda")
        st_t = torch.as_tensor(starts[0], dtype=torch.int64, device="cuda")
        eager_ms = cuda_ms(torch, lambda: step(
            host_form, gather_crops(planes, s_t, st_t, cfg.input_len), gen),
            reps=6, warmup=2)
        idle = 1.0 - busy / (graph_ms * n_full)
        numbers[impl] = dict(graph_step_ms=graph_ms, eager_step_ms=eager_ms,
                             graph_epoch_busy_ms=busy,
                             graph_idle_share=idle, loss_rel_diff=rel,
                             eager_fit_s=t1 - t0, graph_fit_s=t2 - t1)
        print(f"scan {impl}: step ms graph {graph_ms:.3f}, eager "
              f"{eager_ms:.3f} (CUDA events, B={TRAIN_B}); one graph epoch "
              f"of {n_full} replays: device busy {busy:.3f} ms, idle share "
              f"{idle:.3f}")
        del eager, graphed, state, step, host_form

    # SIGTERM under epoch_scan, served at the first epoch's end (exit 143),
    # then the resume from that .ckpt for the second epoch, against the
    # uninterrupted matmul_bf16 graph fit above
    cfg = config("matmul_bf16", dropout_rate=0.0)
    half = _recording_fit(torch, opts("half", epoch_scan=True,
                                      load_path=init), cfg, stop=True)
    with open(os.path.join(ckpt_dir, "svs_half.ckpt"), "rb") as f:
        raw = flax_msgpack.unpackb(f.read())
    print(f"scan SIGTERM: exit {half[2].get('code')}, checkpoint at epoch "
          f"{raw['epoch']}, step {raw['step']}")
    check(half[2].get("code") == 143
          and (raw["epoch"], raw["step"]) == (1, n_full + 1),
          "SIGTERM under epoch_scan: saved at the epoch's end, exit 143")
    resumed = _recording_fit(torch, opts(
        "half", epoch_scan=True,
        load_path=os.path.join(ckpt_dir, "svs_half.ckpt")), cfg)
    tail = (full[0], full[1][-(n_full + 1):], None)
    _graph_vs_eager(torch, np, "scan resume (epoch 2 from the SIGTERM "
                    ".ckpt vs uninterrupted)", tail, resumed, lr)
    del full, half, resumed, tail

    # accumulation (one graph per cycle position) with the remix
    # augmentation
    kw = dict(accum_steps=2, augment=True)
    cfg = config("matmul_bf16")
    eager = _recording_fit(torch, opts("e_accum_aug", **kw), cfg,
                           capturable=True)
    graphed = _recording_fit(torch, opts("g_accum_aug", epoch_scan=True,
                                         **kw), cfg)
    _graph_vs_eager(torch, np, "scan accum_steps=2 with augment", eager,
                    graphed, lr)
    check(sorted(graphed[2]["epoch"].graphs) == [0, 1],
          "accum_steps=2: one graph per cycle position")
    del eager, graphed

    check(bss_torch.fallbacks == 0, "val_sdr: no BSS call fell back")
    print("scan numbers: " + json.dumps(numbers))
    kernel_paths = ("pallas_bf16", "pallas_fused")
    out = {}
    for i, name in enumerate(LOSS_NAMES):
        out[name] = {
            "scan_launches": sum(calls[p][i] for p in kernel_paths),
            "scan_captured": sum(captured[p][i] for p in kernel_paths),
            "replay_launches": sum(replayed[p].get(name, 0)
                                   for p in kernel_paths)}
    return out


def native_phase(torch, np, work: str) -> dict:
    """The port's C++ loader: native batches against numpy's, and a
    ``train_cli`` epoch from the host pipeline with 'auto' resolved to it."""
    from svs_torch.cli import train_cli
    from svs_torch.data import native
    from svs_torch.data.dataset import PatchDataset
    from svs_torch.train import loop

    spec = os.path.join(work, "spec")
    seconds = {}
    t0 = time.perf_counter()
    check(native.available(), "the native library builds and loads")
    seconds["build_s"] = time.perf_counter() - t0
    check(os.path.dirname(native.SO_PATH).endswith(
        os.path.join("svs_torch", "_build")), "built under svs_torch/_build")
    nat = PatchDataset(spec, samples_per_song=FIT_SAMPLES, backend="native")
    ref = PatchDataset(spec, samples_per_song=FIT_SAMPLES, backend="numpy")
    n = 0
    for a, b in zip(nat.batches(TRAIN_B, seed=3), ref.batches(TRAIN_B,
                                                              seed=3)):
        for k in a:
            check(np.array_equal(a[k], b[k]),
                  f"native batch {k} equals numpy's")
        n += 1
    # the host pipeline's epoch of batches, each backend, best of 3
    for name, ds in (("native", nat), ("numpy", ref)):
        best = float("inf")
        for rep in range(3):
            t0 = time.perf_counter()
            for _ in ds.batches(TRAIN_B, seed=4 + rep):
                pass
            best = min(best, time.perf_counter() - t0)
        seconds[f"{name}_epoch_batches_s"] = best
    backends = []
    make = loop._dataset

    def recording(folder, cfg):
        ds = make(folder, cfg)
        backends.append(ds.backend)
        return ds

    loop._dataset = recording
    t0 = time.perf_counter()
    try:
        rc = train_cli.main([
            "--label", "native", "--train_folder", spec, "--valid_folder",
            "none", "--batch_size", str(TRAIN_B), "--samples_per_song",
            str(FIT_SAMPLES), "--epoch", "1", "--device_data", "off",
            "--load_path", "none", "--ckpt_dir", os.path.join(work, "CKPT"),
            "--log_dir", os.path.join(work, "LOG"), "--device", "cuda"])
    finally:
        loop._dataset = make
    seconds["train_cli_epoch_s"] = time.perf_counter() - t0
    log = _read_lines(os.path.join(work, "LOG", "log_native.txt"))
    print(f"native: {n} batches of {TRAIN_B} bitwise equal to numpy's; "
          f"train_cli epoch on the host pipeline, backends {backends}, "
          f"loss {log}; seconds {json.dumps(seconds)}")
    check(rc == 0 and backends == ["native"] and math.isfinite(float(log[0])),
          "train_cli ran an epoch with 'auto' resolved to native")
    return seconds


def eval_phase(torch, np, work: str) -> dict:
    """``eval_cli --impl torch`` (f64 on the card) against ``--impl numpy``
    on the slice's separated wavs, and ``validation_sdr`` on the card."""
    import shutil

    from svs_torch.cli import eval_cli
    from svs_torch.evaluation import bss_torch
    from svs_torch.evaluation.val_sdr import validation_sdr
    from svs_torch.models.unet import UNet
    from svs_torch.utils.config import get_config

    mix, ref = os.path.join(work, "eval_mix"), os.path.join(work, "eval_ref")
    for d in (mix, ref):
        os.makedirs(d)
    for i in range(N_SONGS):
        song = os.path.join(work, "songs", f"song{i}")
        shutil.copy(os.path.join(song, "mixture.wav"),
                    os.path.join(mix, f"{i:04d}_song{i}.wav"))
        shutil.copy(os.path.join(song, "vocals.wav"),
                    os.path.join(ref, f"{i:04d}_song{i}.wav"))
    seconds, tables = {}, {}
    before = bss_torch.fallbacks
    for impl in ("torch", "numpy"):
        out = os.path.join(work, f"eval_{impl}.csv")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = eval_cli.main(["--est", os.path.join(work, "wav"), "--mix",
                                mix, "--ref", ref, "--impl", impl,
                                "--device", "cuda", "--out_csv", out])
        seconds[f"eval_cli_{impl}_s"] = time.perf_counter() - t0
        check(rc == 0, f"eval_cli --impl {impl} exit code 0")
        with open(out) as f:
            tables[impl] = {r["track"]: {k: float(r[k]) for k in
                                         ("SDR", "SIR", "SAR", "NSDR")}
                            for r in csv.DictReader(f)}
    check(sorted(tables["torch"]) == sorted(tables["numpy"])
          and len(tables["torch"]) == N_SONGS, "eval_cli scored every song")
    diff = max(abs(tables["torch"][t][k] - v)
               for t, m in tables["numpy"].items() for k, v in m.items())
    vals = [v for m in tables["torch"].values() for v in m.values()]
    print(f"eval: eval_cli --impl torch (f64 on the card) vs --impl numpy, "
          f"{N_SONGS} songs of {SONG_SECONDS} s: max |d| {diff:.3e} dB "
          f"(bound 1e-9); fallbacks {bss_torch.fallbacks - before}; "
          f"song0 {json.dumps(tables['torch']['0000_song0'])}")
    check(diff <= 1e-9 and all(math.isfinite(v) for v in vals),
          "eval_cli on the card equals the numpy reference within 1e-9 dB")
    check(bss_torch.fallbacks == before, "eval_cli: no BSS call fell back")

    cfg = get_config("default")
    model = UNet(cfg, generator=torch.Generator().manual_seed(0)).to("cuda")
    spec = os.path.join(work, "spec")
    # one song: the scan phase's fits ran validation_sdr on all three on
    # the card; the host's BSS takes 2.6 s a song
    out = {}
    for impl in ("torch", "numpy"):
        t0 = time.perf_counter()
        out[impl] = validation_sdr(model, spec, cfg, impl=impl, max_songs=1,
                                   device="cuda")
        seconds[f"validation_sdr_{impl}_s"] = time.perf_counter() - t0
    d = max(abs(out["torch"][k] - out["numpy"][k])
            for k in ("SDR", "SIR", "SAR", "NSDR"))
    print(f"eval: validation_sdr of 1 song on the card, BSS on the card vs "
          f"the host: max |d| {d:.3e} dB; seconds {json.dumps(seconds)}")
    check(d <= 1e-9 and len(out["torch"]["per_song"]) == 1
          and not out["torch"]["skipped"],
          "validation_sdr: the song scored, card BSS equals the host's")
    check(bss_torch.fallbacks == before, "validation_sdr: no fallback")
    return seconds


def _ms(pair) -> str:
    return " / ".join(f"{v:.3f}" for v in pair)


def dp_phase(torch, np, spec: str) -> dict:
    """The data-parallel layer on the card; returns the loss kernels'
    launches in the world-of-one DP steps, and the backend two ranks on
    the card run over (NCCL, or gloo where NCCL refuses a duplicate
    GPU)."""
    import torch.distributed as dist

    from svs_torch.data.dataset import PatchDataset
    from svs_torch.infer import separate
    from svs_torch.models.unet import UNet
    from svs_torch.parallel import dryrun, mesh as mesh_lib
    from svs_torch.parallel.launch import Ranks
    from svs_torch.utils.config import get_config

    ds = PatchDataset(spec, samples_per_song=64, input_len=128)
    host = {k: np.asarray(v) for k, v in
            next(iter(ds.batches(TRAIN_B, seed=11))).items()}
    default = get_config("default")
    line = {"smi": nvidia_smi_line()}

    # a world of one over NCCL (no torchrun environment)
    mesh = mesh_lib.make_mesh()
    check(mesh.size == 1 and mesh.backend == "nccl",
          f"make_mesh alone: a world of one over NCCL ({mesh})")
    total = [0, 0, 0, 0]
    for impl in DP_PER_STEP:
        cfg = dataclasses.replace(default, mr_mag_impl=impl)
        r = dryrun.layout_parity(mesh, cfg, host, ("dp",), time_reps=5)["dp"]
        r["dp_ms"] = [t[0] for t in r["ms"]]
        counts = tuple(r["kernels"])
        check(counts == DP_PER_STEP[impl], f"dp {impl}: loss-kernel launches "
              f"{counts} == {DP_PER_STEP[impl]} in one DP step")
        total = [a + c for a, c in zip(total, counts)]
        print(f"dp world 1 (nccl) {impl}: default preset B={TRAIN_B}, DP step "
              f"{_ms(r['dp_ms'])} ms vs make_train_step {_ms(r['ref_ms'])} ms "
              f"(CUDA events, means of 5 steps in turns: single, DP, DP, "
              f"single); loss rel {r['loss_rel']:.2e}, "
              f"grad_norm rel {r['grad_norm_rel']:.2e}, BN {r['bn_abs']:.2e}, "
              f"params max {r['params_max']:.2e} mean {r['params_mean']:.2e}; "
              f"launches {list(counts)}")
        check(r["ok"], f"dp {impl}: the world-of-one DP step within the "
              "dry-run envelope of make_train_step")
        check(all(r[k] == 0.0 for k in ("loss_rel", "grad_norm_rel", "bn_abs",
                                        "params_max")),
              f"dp {impl}: the world-of-one DP step gives make_train_step's "
              "bits")
        line[f"w1_{impl}"] = r

    frames = SP_SECONDS * SR // 768 + 1
    mag = np.abs(np.random.default_rng(4).standard_normal(
        (513, frames))).astype(np.float32)
    cfg32 = dataclasses.replace(default, compute_dtype="float32")
    model = UNet(cfg32, generator=torch.Generator().manual_seed(0))
    model = model.to("cuda").eval()
    for mode in ("segments", "overlap"):
        ms = {}
        for name, fn in (
                ("mesh", lambda: separate.separate_magnitude_mesh(
                    model, mag, mesh, mode=mode)),
                ("one", lambda: separate.separate_magnitude(
                    model, mag, mode=mode, device="cuda"))):
            fn()  # warm
            t0 = time.perf_counter()
            out = fn()
            ms[name] = (time.perf_counter() - t0) * 1e3
            ms[name + "_out"] = out
        err = float(np.abs(ms.pop("mesh_out") - ms.pop("one_out")).max())
        print(f"dp world 1 sp {mode}: {SP_SECONDS}-s song ({frames} frames), "
              f"float32, separate_magnitude_mesh {ms['mesh']:.2f} ms vs "
              f"separate_magnitude {ms['one']:.2f} ms (wall, host included); "
              f"max |d| {err:.3e} (bound {SP_ATOL:g})")
        check(err <= SP_ATOL, f"sp {mode}: the mesh decode equals the "
              "unsharded one")
        line[f"sp_{mode}"] = dict(ms, max_abs_err=err)
    dist.destroy_process_group()

    # two ranks on the one card: NCCL first, gloo with CUDA tensors if it
    # refuses
    t0 = time.perf_counter()
    try:
        with Ranks(2, device="cuda:0", backend="nccl", timeout=180) as ranks:
            got = ranks.run(dryrun.collective_probe)
    except RuntimeError as e:
        # NCCL's one expected refusal; any other failure fails the phase
        hit = [x.strip() for x in str(e).splitlines()
               if "Duplicate GPU" in x]
        check(bool(hit), "NCCL, two ranks on one card: ran, or refused as "
              f"a duplicate GPU, not: {str(e)[-2000:]}")
        nccl, backend = "refused: " + hit[0][:400], "gloo"
    else:
        check(got == [2.0, 2.0], "NCCL, two ranks on one card: the "
              f"all_reduce of ones gives [2.0, 2.0], not {got}")
        nccl, backend = f"ran, all_reduce of ones gave {got}", "nccl"
    print(f"dp two ranks on one card, NCCL: {nccl} "
          f"({time.perf_counter() - t0:.1f} s); the two-rank step runs "
          f"over {backend}")
    line["nccl_two_ranks_one_card"] = nccl
    with Ranks(2, device="cuda:0", backend=backend, timeout=900) as ranks:
        ranks.run(dryrun.no_tf32)
        for impl in DP_PER_STEP:
            cfg = dataclasses.replace(cfg32, mr_mag_impl=impl)
            r = ranks.run(dryrun.layout_parity, cfg, host, ("dp",),
                          time_reps=3)[0]["dp"]
            r["dp_ms"] = [t[0] for t in r["ms"]]
            print(f"dp world 2 ({backend}, one card) {impl}: float32 default "
                  f"preset, B = 2 x {TRAIN_B // 2} against the single-process "
                  f"B={TRAIN_B} step: loss rel {r['loss_rel']:.2e}, "
                  f"grad_norm rel {r['grad_norm_rel']:.2e}, BN "
                  f"{r['bn_abs']:.2e}, params max {r['params_max']:.2e} "
                  f"mean {r['params_mean']:.2e}, "
                  f"rank spread {r['spread']:g}; DP step {_ms(r['dp_ms'])} "
                  f"ms vs {_ms(r['ref_ms'])} ms (CUDA events on rank 0, "
                  f"means of 3 steps in turns); rank 0 launches "
                  f"{r['kernels']}")
            check(tuple(r["kernels"]) == DP_PER_STEP[impl],
                  f"dp world 2 {impl}: the loss kernels launched on rank 0")
            check(r["ok"] and r["spread"] == 0.0,
                  f"dp world 2 {impl}: the single-process step within the "
                  "dry-run envelope, the ranks the same bits")
            line[f"w2_{impl}"] = dict(r, backend=backend)
    print("dp: " + json.dumps(line))
    return dict(zip(LOSS_NAMES, total)), backend


def _mb(values) -> str:
    return " / ".join(f"{v / 1e6:.3f}" for v in values)


def zero_phase(torch, np, spec: str, backend: str) -> dict:
    """ZeRO-1 and FSDP on the card (``svs_torch.parallel.zero``, through
    ``dryrun.layout_parity``): a world of one over NCCL at the ``default``
    preset, B = 32, under ``pallas_fused`` and ``pallas_bf16`` (each
    sharded step ``make_train_step``'s bits, the loss kernels launched
    inside it at ``DP_PER_STEP``'s counts), then two ranks on the card over
    ``backend`` (dp_phase's: gloo where NCCL refused a duplicate GPU),
    float32, 2 x 16 (each sharded step the DP step's bits, each rank's
    resting state within ``ZERO_MB_RTOL`` of ``ZERO_MB``).  cuDNN's
    deterministic algorithms throughout, TF32 off.  Returns the loss
    kernels' launches in the world-of-one sharded steps."""
    import torch.distributed as dist

    from svs_torch.data.dataset import PatchDataset
    from svs_torch.parallel import dryrun, mesh as mesh_lib
    from svs_torch.parallel.launch import Ranks
    from svs_torch.utils.config import get_config

    ds = PatchDataset(spec, samples_per_song=64, input_len=128)
    host = {k: np.asarray(v) for k, v in
            next(iter(ds.batches(TRAIN_B, seed=11))).items()}
    default = get_config("default")
    line = {"smi": nvidia_smi_line()}
    total = [0, 0, 0, 0]
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = mesh_lib.make_mesh()
        check(mesh.size == 1 and mesh.backend == "nccl",
              f"make_mesh alone: a world of one over NCCL ({mesh})")
        for impl in DP_PER_STEP:
            cfg = dataclasses.replace(default, mr_mag_impl=impl)
            r = dryrun.layout_parity(mesh, cfg, host, time_reps=5)
            for kind in ("zero1", "fsdp"):
                x = r[kind]
                counts = tuple(x["kernels"])
                check(counts == DP_PER_STEP[impl], f"zero {kind} {impl}: "
                      f"loss-kernel launches {counts} == "
                      f"{DP_PER_STEP[impl]} in one step")
                total = [a + c for a, c in zip(total, counts)]
                check(all(x[k] == 0.0 for k in ("loss_rel", "grad_norm_rel",
                                                "bn_abs", "params_max"))
                      and x["vs_dp"] == 0.0 and x["shards_ok"],
                      f"zero {kind} {impl}: the world-of-one step gives "
                      "make_train_step's bits (metrics, parameters, BN, "
                      "Adam's moments)")
            print(f"zero world 1 (nccl) {impl}: default preset B={TRAIN_B}, "
                  "the same bits as make_train_step and the DP step; ms "
                  "(CUDA events, means of 5 steps in turns single, DP, "
                  "ZeRO-1, FSDP, FSDP, ZeRO-1, DP, single; cudnn "
                  f"deterministic): single {_ms(r['dp']['ref_ms'])}; "
                  + "; ".join(f"{k} {_ms([t[0] for t in r[k]['ms']])}"
                              for k in dryrun.LAYOUTS)
                  + "; peak MB " + ", ".join(
                      f"{k} {_mb(r[k]['peak'])}" for k in dryrun.LAYOUTS)
                  + "; launches " + ", ".join(
                      f"{k} {r[k]['kernels']}" for k in dryrun.LAYOUTS))
            line[f"w1_{impl}"] = r
        dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = was

    cfg32 = dataclasses.replace(default, compute_dtype="float32")
    with Ranks(2, device="cuda:0", backend=backend, timeout=900) as ranks:
        ranks.run(dryrun.no_tf32)
        ranks.run(dryrun.deterministic)
        for impl in DP_PER_STEP:
            cfg = dataclasses.replace(cfg32, mr_mag_impl=impl)
            r = ranks.run(dryrun.layout_parity, cfg, host, time_reps=3)[0]
            print(f"zero world 2 ({backend}, one card) {impl}: float32 "
                  f"default preset, B = 2 x {TRAIN_B // 2}: vs DP "
                  + ", ".join(f"{k} {r[k]['vs_dp']:g}"
                              for k in ("zero1", "fsdp"))
                  + "; spread " + ", ".join(f"{k} {r[k]['spread']:g}"
                                            for k in dryrun.LAYOUTS)
                  + "; resting MB a rank " + ", ".join(
                      f"{k} {_mb(r[k]['bytes'])}" for k in dryrun.LAYOUTS)
                  + "; peak MB a rank " + ", ".join(
                      f"{k} {_mb(r[k]['peak'])}" for k in dryrun.LAYOUTS)
                  + f"; ms a step, ranks 0 / 1 (CUDA events, means of 3 "
                  f"steps in turns; {backend}'s and the host's time, not "
                  f"checked): single B={TRAIN_B} {_ms(r['dp']['ref_ms'])}; "
                  + "; ".join(
                      f"{k} " + ", ".join(_ms(t) for t in r[k]["ms"])
                      for k in dryrun.LAYOUTS)
                  + f"; envelope vs the single B={TRAIN_B} step: params "
                  "max " + ", ".join(f"{k} {r[k]['params_max']:.2e}"
                                     for k in dryrun.LAYOUTS))
            for kind in ("zero1", "fsdp"):
                x = r[kind]
                check(x["vs_dp"] == 0.0 and x["spread"] == 0.0
                      and x["shards_ok"] and x["ok"],
                      f"zero world 2 {kind} {impl}: the DP two-rank step's "
                      "bits, the ranks' gathered states the same, each "
                      "leaf the channel rule's slice")
            for kind in dryrun.LAYOUTS:
                want = ZERO_MB[kind] * 1e6
                check(all(abs(b - want) <= ZERO_MB_RTOL * want
                          for b in r[kind]["bytes"]),
                      f"zero world 2 {kind}: resting bytes a rank "
                      f"{r[kind]['bytes']} within {ZERO_MB_RTOL:g} of "
                      f"{want:g}")
            line[f"w2_{impl}"] = dict(r, backend=backend)
    print("zero: " + json.dumps(line))
    return dict(zip(LOSS_NAMES, total))


def step_parity_phase(torch, np, host_batch) -> None:
    """One float32 fft step (B = 4, no dropout) on the card, TF32 off,
    against the same weights and batch on the CPU."""
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import get_config

    cfg = dataclasses.replace(get_config("default"), compute_dtype="float32",
                              mr_mag_impl="fft", dropout_rate=0.0)
    batch = {k: v[:4] for k, v in host_batch.items()}
    out = {}
    for dev in ("cpu", "cuda"):
        state = tstep.create_train_state(0, cfg, device=dev)
        state, m = tstep.make_train_step(cfg)(
            state, tstep.batch_to_device(batch, dev))
        out[dev] = ({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in
                     state.model.state_dict().items()})
    (cm, csd), (gm, gsd) = out["cpu"], out["cuda"]
    loss = max(abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-30)
               for k in ("l1", "mr", "total"))
    gn = abs(gm["grad_norm"] - cm["grad_norm"]) / cm["grad_norm"]
    bn = max((gsd[k] - csd[k]).abs().max().item() for k in csd
             if "running" in k)
    params = [(gsd[k] - csd[k]).abs() for k in csd
              if "running" not in k and "num_batches" not in k]
    pmax = max(d.max().item() for d in params)
    pmean = (sum(d.sum().item() for d in params)
             / sum(d.numel() for d in params))
    print(f"parity: default-width float32 fft train step, B=4, card (TF32 "
          f"off) vs CPU: loss rel {loss:.3e} (bound {STEP_LOSS_RTOL:g}), "
          f"grad_norm rel {gn:.3e} ({STEP_GN_RTOL:g}), BN stats "
          f"{bn:.3e} ({STEP_BN_ATOL:g}), params max {pmax:.3e} (2.1 lr) "
          f"mean {pmean:.3e} (2e-4); total {gm['total']:.6f} vs "
          f"{cm['total']:.6f}")
    check(loss <= STEP_LOSS_RTOL and gn <= STEP_GN_RTOL
          and bn < STEP_BN_ATOL and pmax <= 2.1 * cfg.learning_rate
          and pmean < 2e-4, "float32 train step on the card matches the CPU")


def slice_phase(torch, np, work: str):
    """The main path through the CLIs; returns the kernels' launch counts."""
    from svs_torch.cli import data_cli, infer_cli
    from svs_torch.data import wav
    from svs_torch.infer import separate
    from svs_torch.models import torch_import
    from svs_torch.models.unet import UNet, param_count
    from svs_torch.ops.cuda import dsp as cdsp
    from svs_torch.utils.config import get_config

    songs, spec = os.path.join(work, "songs"), os.path.join(work, "spec")
    masked, out = os.path.join(work, "masked"), os.path.join(work, "wav")
    write_songs(np, wav, songs, seed=1)
    cfg = get_config("default")
    model = UNet(cfg, generator=torch.Generator().manual_seed(0))
    pth = os.path.join(work, "default_seed0.pth")
    torch_import.save_pth(pth, model)
    print(f"slice: {N_SONGS} songs x {SONG_SECONDS} s at {SR} Hz; default "
          f"preset, {param_count(model)} params, {cfg.compute_dtype}")

    cdsp.reset_counts()
    stages = {}
    t0 = time.perf_counter()
    rc = data_cli.main(["--src", songs, "--tar", spec, "--device", "cuda"])
    stages["to_spec_s"] = time.perf_counter() - t0
    check(rc == 0, "data_cli to_spec exit code 0")
    t0 = time.perf_counter()
    rc = infer_cli.main(["--model_path", pth, "--tar", masked,
                         "--mixture_folder", os.path.join(spec, "mixture"),
                         "--preset", "default", "--mode", "segments",
                         "--device", "cuda"])
    stages["inference_s"] = time.perf_counter() - t0
    check(rc == 0, "infer_cli exit code 0")
    t0 = time.perf_counter()
    rc = data_cli.main(["--src", masked, "--tar", out, "--phase", spec,
                        "--direction", "to_wave", "--device", "cuda"])
    stages["to_wave_s"] = time.perf_counter() - t0
    check(rc == 0, "data_cli to_wave exit code 0")
    launches = {"stft_magphase": cdsp.launches}
    routes = {"fft": cdsp.fft_launches, "gemm": cdsp.gemm_launches}
    print("slice stages: " + json.dumps(stages))
    print("slice launches: " + json.dumps(launches) + ", by route "
          + json.dumps(routes))
    check(launches["stft_magphase"] == 2 * N_SONGS,
          f"stft_magphase launched twice per song (mixture and vocals): "
          f"{launches['stft_magphase']} for {N_SONGS} songs")
    check(routes == {"fft": 2 * N_SONGS, "gemm": 0},
          "to_spec went through the fft route only")

    n_frames = 1 + SONG_SECONDS * SR // cfg.hop_size
    for i in range(N_SONGS):
        base = f"{i:04d}_song{i}"
        for folder in ("mixture", "vocal"):
            mag = np.load(os.path.join(spec, folder, f"{base}_spec.npy"))
            ph = np.load(os.path.join(spec, folder, f"{base}_phase.npy"))
            check(mag.shape == ph.shape == (513, n_frames)
                  and np.isfinite(mag).all() and np.isfinite(ph).all(),
                  f"{folder}/{base} spectra: shape (513, {n_frames}), finite")
        m = np.load(os.path.join(masked, f"{base}_spec.npy"))
        check(m.shape == (513, n_frames) and np.isfinite(m).all()
              and (m[0] == 0).all(),
              f"masked {base}: shape, finite, DC row zero")
        y, sr = wav.read_wav(os.path.join(out, f"{base}.wav"))
        check(sr == SR and len(y) == cfg.hop_size * (n_frames - 1)
              and np.isfinite(y).all() and 0 < np.abs(y).max() <= 0.9 + 1e-4,
              f"wav {base}: length, finite, peak 0.9")

    # infer_cli's bf16 masks of song0 on the card against the same .pth and
    # spectrum on the CPU (the DC row is zero on both sides)
    mix0 = np.load(os.path.join(spec, "mixture", "0000_song0_spec.npy"))
    got = np.load(os.path.join(masked, "0000_song0_spec.npy"))
    want = separate.separate_magnitude(
        infer_cli.load_model(pth, cfg, "cpu"), mix0, device="cpu")
    err = np.abs(got[1:] - want[1:]) / np.maximum(mix0[1:], 1e-30)
    print(f"slice: infer_cli bf16 masks of song0, cuDNN vs CPU: "
          f"max_abs_diff mask={err.max():.3e} median={np.median(err):.3e} "
          f"(bounds {UNET_BF16_MAX:g}, {UNET_BF16_MEDIAN:g})")
    check(err.max() < UNET_BF16_MAX and np.median(err) < UNET_BF16_MEDIAN,
          "U-Net bf16 on the card matches the CPU")

    # the kernel's spectra against the torch.fft front end on one song
    from svs_torch.data import prep
    y_mix, _ = wav.load_audio(os.path.join(songs, "song0", "mixture.wav"))
    km, kp = prep.stft_magphase(y_mix, 1024, 768, impl="kernel",
                                device="cuda")
    fm, fp = prep.stft_magphase(y_mix, 1024, 768, impl="fft", device="cuda")
    e = float(np.abs(km * kp - fm * fp).max())
    print(f"slice: kernel front end vs torch.fft front end, song0: "
          f"max_abs_err mag*phase={e:.3e}")
    check(e < ATOL, "kernel front end agrees with the torch.fft front end")

    # separate_wav (the in-process wav -> wav decode), per song
    model = model.cuda().eval()
    rng = np.random.default_rng(2)
    per_song = {}
    for seconds in (SONG_SECONDS, 4 * 60):
        y = (rng.standard_normal(seconds * SR) * 0.1).astype(np.float32)
        per_song[f"{seconds}s_song_ms"] = cuda_ms(
            torch, lambda: separate.separate_wav(model, y), reps=5,
            warmup=2)
        v = separate.separate_wav(model, y)
        check(v.shape == y.shape and np.isfinite(v).all(),
              "separate_wav: shape and finite")
    print("separate_wav: " + json.dumps(per_song))
    busy = device_breakdown(torch, lambda: separate.separate_wav(model, y),
                            "separate_wav 240-s song")
    idle = 1.0 - busy / per_song["240s_song_ms"]
    print(f"separate_wav 240-s song: device busy {busy:.3f} ms of "
          f"{per_song['240s_song_ms']:.3f} ms, idle share {idle:.3f}")
    return launches


# the serve phase: serve_cli in its own process at the full ``default``
# preset, answering serial requests of one 60-s song and a burst of distinct
# songs, each held against separate_wav in this process
SERVE_SERIAL, SERVE_BURST = 50, 8
SERVE_WARMUP_S = 60
# seconds for serve_cli to load, warm up and bind, and to drain and exit
SERVE_START_S, SERVE_EXIT_S = 300, 120
# the burst's first requests (path, sample rate, channels); the rest are
# 8192-Hz mono songs at the server's defaults
SERVE_ODD = (("/separate?vocal_solo=0", SR, 1),
             ("/separate?mode=segments", SR, 1),
             ("/separate?mode=whole", SR, 1), ("/separate", 44100, 2))
# a response against the same decode in this process, both PCM16 encoded
# on the host: the same kernels at the same shapes (the server's stream
# runs them on another stream), so one code apart at most
SERVE_LSB = 1
# amplitude_to_db on the card against the CPU: float32 log10 on two
# backends (tests/test_torch_viz.py's bound against svs_tpu)
DB_RTOL = DB_ATOL = 1e-5


def _http(port: int, method: str, path: str, body=None, headers=(),
          connected=None):
    """One request to 127.0.0.1:port with exactly the headers given (none
    added); ``connected`` is set once the connection is open.  Returns
    (status, body)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.connect()
        if connected is not None:
            connected.set()
        conn.putrequest(method, path, skip_accept_encoding=True)
        for k, v in headers:
            conn.putheader(k, v)
        conn.endheaders(body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _post_wav(port: int, path: str, body: bytes, connected=None):
    return _http(port, "POST", path, body,
                 [("Content-Length", str(len(body)))], connected)


def _healthz(port: int) -> dict:
    status, body = _http(port, "GET", "/healthz")
    check(status == 200, f"/healthz answers 200, not {status}")
    return json.loads(body)


def _burst(port: int, requests, before_join=None):
    """POST every (path, body) at once from its own thread; returns the
    (status, body, seconds from the burst's start to its answer) of each
    and the wall seconds of the burst.  ``before_join`` runs once every
    connection is open."""
    import threading
    results = [None] * len(requests)
    opened = [threading.Event() for _ in requests]

    def post(i):
        try:
            status, body = _post_wav(port, *requests[i], connected=opened[i])
        except OSError as e:
            status, body = repr(e), b""
        results[i] = (status, body, time.perf_counter() - t0)

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if before_join is not None:
        for e in opened:
            check(e.wait(timeout=60), "every burst connection opened")
        before_join()
    for t in threads:
        t.join(timeout=SERVE_START_S)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads),
          "no request of the burst hangs")
    return results, wall


def serve_phase(torch, np, work: str) -> dict:
    """``python -m svs_torch.cli.serve_cli`` on the slice's full-width
    ``default`` .pth, driven over HTTP; returns the ``serve:`` line."""
    import signal
    import socket
    from urllib.parse import parse_qs

    from svs_torch.cli import infer_cli, viz_cli
    from svs_torch.data import wav
    from svs_torch.infer import separate
    from svs_torch.ops import stft as tdsp
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import dsp as cdsp
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.serve.server import DEFAULT_MAX_BODY, DEFAULT_MODE
    from svs_torch.utils.config import get_config

    # the host resampler's module, imported here (and timed, if this is its
    # first import) so that the import is not timed as resampling;
    # serve_cli imports it at warmup, not in a request
    t0 = time.perf_counter()
    import scipy.signal  # noqa: F401
    line = {"scipy_signal_import_s": time.perf_counter() - t0}

    cfg = get_config("default")
    pth = os.path.join(work, "default_seed0.pth")
    rng = np.random.default_rng(4)

    def song_body(sr: int, channels: int) -> bytes:
        t = np.arange(SONG_SECONDS * sr) / sr
        vocal = 0.3 * np.sin(2 * np.pi * rng.uniform(150, 600) * t)
        y = vocal + 0.2 * rng.standard_normal((channels, len(t)))
        return wav.encode_wav(y.astype(np.float32), sr)

    model = infer_cli.load_model(pth, cfg, "cuda")

    resample_s = []  # host seconds of each resampling, there and back

    def resampled(y, sr_from: int, sr_to: int):
        t0 = time.perf_counter()
        y = wav.resample(y, sr_from, sr_to)
        resample_s.append(time.perf_counter() - t0)
        return y

    def host_input(body: bytes):
        y, sr = wav.parse_wav(body)
        y = wav.to_mono(y)
        return (resampled(y, sr, SR) if sr != SR else y), sr

    def in_process(path: str, body: bytes) -> bytes:
        """What the server should answer: the same parse, mixdown and
        resampling around separate_wav on the card, encoded as PCM16."""
        q = parse_qs(path.partition("?")[2])
        y, sr = host_input(body)
        out = separate.separate_wav(
            model, y.astype(np.float32),
            vocal_solo=q.get("vocal_solo", ["1"])[0] != "0",
            mode=q.get("mode", [DEFAULT_MODE])[0])
        return wav.encode_wav(resampled(out, SR, sr) if sr != SR
                              else out, sr)

    def lsb(got: bytes, want: bytes) -> int:
        (g, g_sr), (w, w_sr) = wav.parse_wav(got), wav.parse_wav(want)
        check(g_sr == w_sr and g.shape == w.shape and np.abs(w).max() > 0,
              f"a response's rate and shape: {g_sr} {g.shape} against "
              f"{w_sr} {w.shape}")
        return int(np.abs(np.round(g * 32768.0)
                          - np.round(w * 32768.0)).max())

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log_path = os.path.join(work, "serve_cli.log")

    def server_log() -> str:
        with open(log_path) as f:
            return f.read()

    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "svs_torch.cli.serve_cli",
             "--model_path", pth, "--port", str(port),
             "--warmup_secs", str(SERVE_WARMUP_S)],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        while True:
            check(proc.poll() is None,
                  f"serve_cli exited ({proc.returncode}) before it "
                  f"answered:\n{server_log()}")
            try:
                if _http(port, "GET", "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            check(time.perf_counter() - t0 < SERVE_START_S,
                  f"serve_cli answered /healthz within {SERVE_START_S} s:"
                  f"\n{server_log()}")
            time.sleep(0.2)
        line["startup_s"] = time.perf_counter() - t0

        # serial: one song, one request after another
        body = song_body(SR, 1)
        want = in_process("/separate", body)
        serial, worst = [], 0
        for _ in range(SERVE_SERIAL):
            t0 = time.perf_counter()
            status, got = _post_wav(port, "/separate", body)
            serial.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"serial request: 200, not {status}")
            worst = max(worst, lsb(got, want))
        line["serial_ms"] = serial
        line["serial_p50_ms"] = float(np.percentile(serial, 50))
        line["serial_p90_ms"] = float(np.percentile(serial, 90))
        # the window holds the warmup and the serial requests' stream calls
        line["serial_device_time_secs"] = {
            k: _healthz(port)["device_time_secs"][k] for k in ("p50", "p90")}

        # a burst of distinct songs, some with other queries and rates
        rates = [sr for _, sr, _ in SERVE_ODD] + [SR] * (
            SERVE_BURST - len(SERVE_ODD))
        requests = [(path, song_body(sr, ch)) for path, sr, ch in
                    SERVE_ODD + (("/separate", SR, 1),)
                    * (SERVE_BURST - len(SERVE_ODD))]
        results, wall = _burst(port, requests)
        for (path, b), (status, got, _) in zip(requests, results):
            check(status == 200, f"burst {path}: 200, not {status}")
            worst = max(worst, lsb(got, in_process(path, b)))
        print(f"serve check: {SERVE_SERIAL} serial and {SERVE_BURST} burst "
              f"responses against separate_wav in this process: max "
              f"{worst} LSB (bound {SERVE_LSB})")
        check(worst <= SERVE_LSB, "the server's answers are separate_wav's")
        # throughput over the songs at the model's rate; the 44.1-kHz
        # song waits on the host resampler, so its latency stands apart
        same = [r[2] for r, sr in zip(results, rates) if sr == SR]
        line.update(burst_wall_s=wall, burst_request_s=[r[2] for r in results],
                    burst_same_rate_songs=len(same),
                    burst_same_rate_wall_s=max(same),
                    burst_same_rate_songs_per_s=len(same) / max(same),
                    burst_44k1_request_s=[r[2] for r, sr in zip(results, rates)
                                          if sr != SR],
                    max_lsb=worst, resample_44k1_s=resample_s[-2:])
        h = _healthz(port)
        served = 1 + SERVE_SERIAL + SERVE_BURST  # the warmup is one
        check(h["requests_served"] == served,
              f"/healthz requests_served {h['requests_served']} == {served}")
        check(h["max_coalesced"] > 1, f"the burst was coalesced: "
              f"max_coalesced {h['max_coalesced']}")
        for window in ("queue_wait_secs", "device_time_secs"):
            check(all(v is not None for v in h[window].values()),
                  f"/healthz {window} has percentiles")
            line[window] = {k: h[window][k] for k in ("p50", "p90")}
        line["max_coalesced"] = h["max_coalesced"]
        line["batches_run"] = h["batches_run"]

        # a serial request's device share: the device time of the one-song
        # stream call the worker makes for it (traced in this process, no
        # coalescing) over the serial p50 on the client
        y1 = host_input(body)[0].astype(np.float32)
        separate.separate_wav_stream(model, [y1], mode=DEFAULT_MODE)
        line["serial_request_device_ms"] = device_breakdown(
            torch, lambda: separate.separate_wav_stream(
                model, [y1], mode=DEFAULT_MODE),
            "serve check: in-process stream of the serial 60-s song")
        line["serial_device_share"] = (line["serial_request_device_ms"]
                                       / line["serial_p50_ms"])

        # for scale: the burst's songs through one stream call in this
        # process, the hand kernels' counts zeroed just before
        ys = [host_input(b)[0].astype(np.float32) for _, b in requests]
        separate.separate_wav_stream(model, ys, mode=DEFAULT_MODE)
        cdsp.reset_counts(), cdm.reset_counts(), cfl.reset_counts()
        t0 = time.perf_counter()
        outs = separate.separate_wav_stream(model, ys, mode=DEFAULT_MODE)
        line["stream_in_process_s"] = time.perf_counter() - t0
        line["hand_kernel_launches"] = (
            cdsp.launches + cdsp.mag_launches + sum(_loss_counts()[0]))
        check(all(o.shape == y.shape and np.isfinite(o).all()
                  for o, y in zip(outs, ys)), "the stream: shape, finite")
        line["stream_device_ms_per_song"] = device_breakdown(
            torch, lambda: separate.separate_wav_stream(
                model, ys, mode=DEFAULT_MODE),
            f"serve check: in-process stream of {SERVE_BURST} 60-s songs"
        ) / SERVE_BURST

        # the error paths
        codes = {
            "unknown_path_get": (_http(port, "GET", "/nope")[0], 404),
            "unknown_path_post": (_post_wav(port, "/nope", body)[0], 404),
            "bad_body": (_post_wav(port, "/separate", b"not a wav")[0], 400),
            "bad_mode": (_post_wav(port, "/separate?mode=bogus", body)[0],
                         400),
            "no_content_length": (_http(port, "POST", "/separate")[0], 411),
            "oversize": (_http(port, "POST", "/separate", None, [
                ("Content-Length", str(DEFAULT_MAX_BODY + 1))])[0], 413),
        }
        for what, (got, want_code) in codes.items():
            check(got == want_code, f"{what}: {want_code}, not {got}")

        # SIGTERM while a second burst is in flight: once every connection
        # is open and the server has answered one of them
        def sigterm():
            for _ in range(SERVE_START_S * 100):
                if _healthz(port)["requests_served"] > served:
                    break
                time.sleep(0.01)
            proc.send_signal(signal.SIGTERM)

        results, _ = _burst(port, requests, before_join=sigterm)
        statuses = [r[0] for r in results]
        check(all(s in (200, 503) for s in statuses),
              f"every request under SIGTERM ends 200 or 503: {statuses}")
        t0 = time.perf_counter()
        rc = proc.wait(timeout=SERVE_EXIT_S)
        check(rc == 0, f"serve_cli exits 0 after SIGTERM, not {rc}:\n"
                       f"{server_log()}")
        line["sigterm"] = {"ok": statuses.count(200),
                           "unavailable": statuses.count(503),
                           "exit_s": time.perf_counter() - t0}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    # the diagnostics on the card
    mix_path = os.path.join(work, "spec", "mixture", "0000_song0_spec.npy")
    mix = torch.from_numpy(np.load(mix_path))
    db_card = tdsp.amplitude_to_db(mix.cuda(), ref=float(mix.max()))
    db_cpu = tdsp.amplitude_to_db(mix, ref=float(mix.max()))
    err = float((db_card.cpu() - db_cpu).abs().max())
    print(f"serve check: amplitude_to_db on the card against the CPU: "
          f"max_abs_err {err:.3e} dB")
    check(torch.allclose(db_card.cpu(), db_cpu, rtol=DB_RTOL, atol=DB_ATOL),
          "amplitude_to_db on the card matches the CPU")
    png = os.path.join(work, "viz.png")
    argv = ["--model_path", pth, "--spec_path", mix_path, "--out", png,
            "--device", "cuda"]
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        try:
            viz_cli.main(argv)
        except ImportError as e:
            check("matplotlib" in str(e), "the ImportError names matplotlib")
            line["viz_cli"] = f"no matplotlib here; it raised: {e}"
        else:
            check(False, "viz_cli without matplotlib raises ImportError")
    else:
        check(viz_cli.main(argv) == 0 and os.path.getsize(png) > 10000,
              "viz_cli wrote its figure")
        line["viz_cli"] = "figure written"
    print(f"serve check: viz_cli --device cuda: {line['viz_cli']}")
    return line


def run_cli(main, argv) -> dict:
    """Run a CLI's ``main(argv)``, echo what it printed, return its last
    line as JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    print(text, end="")
    check(rc == 0, f"{' '.join(argv)}: exit code 0")
    return json.loads(text.strip().splitlines()[-1])


def bench_phase(torch, np, spec: str):
    """The bench entry point (``bench_cli``) at the full ``default`` preset
    on the card, with the counts zeroed just before each run and read just
    after; then the PCM16 stream against ``separate_wav`` and the
    device-resident batches against the host sampler's.  Returns the launch
    counts of the ``--frontend`` run."""
    from svs_torch.cli import bench_cli
    from svs_torch.data.dataset import PatchDataset
    from svs_torch.data.device_data import DeviceDataset
    from svs_torch.infer import separate
    from svs_torch.models.unet import UNet
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import dsp as cdsp
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.utils.benchmark import _music_fixture
    from svs_torch.utils.config import get_config

    def zero():
        cdsp.reset_counts()
        cdm.reset_counts()
        cfl.reset_counts()

    def counts():
        return {"stft_magphase": cdsp.launches,
                "stft_magnitude": cdsp.mag_launches,
                "spectral_mag_fwd": cdm.fwd_launches,
                "spectral_mag_bwd": cdm.bwd_launches,
                "loss_partials_fwd": cfl.fwd_launches,
                "loss_partials_bwd": cfl.bwd_launches}

    seconds = {}
    t0 = time.perf_counter()
    zero()
    front = run_cli(bench_cli.main, ["--frontend", "--device", "cuda"])
    launches = counts()
    routes = {"fft": cdsp.fft_launches, "gemm": cdsp.gemm_launches}
    seconds["frontend_s"] = time.perf_counter() - t0
    print("bench --frontend launches: " + json.dumps(launches)
          + ", front ends by route " + json.dumps(routes))
    check(routes == {"fft": 204, "gemm": 0},
          "bench --frontend went through the fft route only")
    # one warm-up, 100 timed calls and one for the error, each front end
    check(launches["stft_magnitude"] == 102
          and launches["stft_magphase"] == 102,
          "bench --frontend launched each front-end kernel 102 times")
    check(front["mag_max_abs_err"] < ATOL
          and front["magphase_max_abs_err"] < ATOL,
          "bench --frontend: kernels agree with torch.stft within the "
          "kernel tolerance")

    t0 = time.perf_counter()
    zero()
    # 60-s songs, 2 a stream (the line's defaults are 240 s and 5): the
    # checks below hold for any length
    line = run_cli(bench_cli.main, ["--device", "cuda", "--secs", "60",
                                    "--reps", "2"])
    seconds["default_line_s"] = time.perf_counter() - t0
    print("bench default line launches: " + json.dumps(counts()))
    errors = [k for k in line if k.endswith("_error")]
    check(not errors, f"bench default line: no sub-bench failed {errors}")
    numbers = {k: v for k, v in line.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    check(all(math.isfinite(v) and v > 0 for v in numbers.values()),
          f"bench default line: every number finite and positive {numbers}")
    for key in ("decode_device_ms_per_song", "stream_frames_per_sec",
                "train_step_ms", "train_patches_per_sec",
                "train_patches_per_sec_device", "train_flops_per_step",
                "train_mfu_pct"):
        check(key in numbers, f"bench default line has {key}")
    check(line["train_mr_mag_impl"] == "matmul_bf16"
          and line["train_dtype"] == "bfloat16",
          "bench default line: the shipped default preset")

    # the PCM16 stream (two songs, so one's copies overlap the other's
    # decode) against separate_wav on the first, same card and weights
    t0 = time.perf_counter()
    cfg = get_config("default")
    model = UNet(cfg, generator=torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    songs = [_music_fixture(n * SR, SR, seed=s, pcm16=True)
             for s, n in ((3, SONG_SECONDS), (4, 30))]
    outs = separate.separate_wav_stream(model, songs, pcm16=True,
                                        device="cuda")
    check([o.dtype for o in outs] == [np.int16] * 2
          and [o.shape for o in outs] == [y.shape for y in songs],
          "PCM16 stream: int16 outputs of the songs' lengths")
    want = separate.separate_wav(model, songs[0].astype(np.float32) / 32768,
                                 device="cuda")
    lsb = np.abs(outs[0].astype(np.float64) - want * 32768.0).max()
    f32 = separate.separate_wav_stream(
        model, [s.astype(np.float32) / 32768 for s in songs], device="cuda")
    f32_err = float(np.abs(f32[0] - want).max())
    print(f"bench: PCM16 stream vs separate_wav, 60-s song: max {lsb:.3f} "
          f"LSB (bound 2); f32 stream vs separate_wav: max_abs_err "
          f"{f32_err:.3e}")
    check(lsb <= 2.0, "PCM16 stream within 2 LSB of separate_wav")
    check(f32_err <= 1e-5, "f32 stream matches separate_wav")

    # the device-resident dataset on the card against the host sampler
    ds = PatchDataset(spec, samples_per_song=64, input_len=128)
    dev = DeviceDataset(ds, device="cuda")
    n_batches = 0
    for kw in (dict(seed=5, n_steps=3), dict(seed=6, drop_last=True)):
        for hb, db in zip(ds.batches(TRAIN_B, **kw),
                          dev.batches(TRAIN_B, **kw)):
            for k, v in hb.items():
                check(torch.equal(db[k].cpu(), torch.from_numpy(v)),
                      f"DeviceDataset batch {k} equals the host's")
            n_batches += 1
    print(f"bench: DeviceDataset on the card, {n_batches} batches of "
          f"{TRAIN_B} bitwise equal to the host PatchDataset's "
          f"({dev.nbytes / 2**20:.1f} MiB resident)")
    seconds["stream_and_data_checks_s"] = time.perf_counter() - t0
    print("bench seconds: " + json.dumps(seconds))
    return launches


# kernel-name fragments -> the layer they belong to (profiler breakdowns)
FAMILIES = (("conv", ("conv", "cudnn", "xmma", "implicit", "gemm", "dgrad",
                      "wgrad", "nchw", "nhwc")),
            ("fft", ("fft",)),
            ("copy", ("memcpy", "memset")))


def device_breakdown(torch, fn, label: str, families=FAMILIES) -> float:
    """Device time of one ``fn()`` call by kernel family, from a
    torch.profiler trace; returns the summed device milliseconds."""
    by_family, n_kernels = {}, 0
    for key, ms, count in device_events(torch, fn, cpu=True):
        name = key.lower()
        family = next((f for f, keys in families
                       if any(k in name for k in keys)), "elementwise")
        by_family[family] = by_family.get(family, 0.0) + ms
        n_kernels += count
    busy = sum(by_family.values())
    check(busy > 0, f"the profiler saw device time in {label}")
    print(f"{label} device ms by family: "
          + json.dumps(dict(by_family, kernels=n_kernels)))
    return busy


def parity_phase(torch):
    from svs_torch.models.unet import UNet
    from svs_torch.utils.config import get_config

    cfg = dataclasses.replace(get_config("default"), compute_dtype="float32")
    cpu = UNet(cfg, generator=torch.Generator().manual_seed(0)).eval()
    gpu = UNet(cfg).cuda().eval()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.rand((2, 512, 128), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = cpu(x)
        got = gpu(x.cuda()).cpu()
    err = (got - want).abs().max().item()
    print(f"parity: default-width U-Net, float32, cuDNN (TF32 off) vs CPU: "
          f"max_abs_diff mask={err:.3e} (bound {UNET_F32_ATOL:g})")
    check(err < UNET_F32_ATOL, "U-Net float32 on the card matches the CPU")


def loss_times_main(tree: str) -> int:
    """``--loss-times TREE``: only the loss kernels' times (``loss_times``)
    through the ``svs_torch`` of the source tree TREE (an earlier version
    unpacked beside this one, or this one), as one JSON line; for timing
    two designs in one run on one card."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    check(cdm.__file__.startswith(tree + os.sep), f"svs_torch from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    times = loss_times(torch, np, cdm, cfl)
    print(json.dumps({"tree": tree, "device": nvidia_smi_line(),
                      "loss_times": times}))
    return 0


def main(argv=None) -> int:
    import numpy as np
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--loss-times"] and len(argv) == 2:
        return loss_times_main(argv[1])
    check(not argv, f"unknown arguments {argv}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from svs_torch.ops.cuda import build
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import dsp as cdsp
    from svs_torch.ops.cuda import fused_loss as cfl

    # every f32 comparison on the card is true f32: cuDNN's convs and
    # cuBLAS's matmuls would otherwise round operands to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; tf32 off for cudnn and matmul")

    seconds = {}
    t0 = time.perf_counter()
    build_phase(build, [*cdsp.KERNELS, cdm.KERNEL, cfl.KERNEL],
                [cdm.KERNEL, cfl.KERNEL])
    seconds["build"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    entries = [frontend_phase(torch, np, cdsp, phase=True),
               frontend_phase(torch, np, cdsp, phase=False)]
    entries += loss_kernel_phase(torch, np)
    seconds["kernels"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as work:
        t0 = time.perf_counter()
        launches = slice_phase(torch, np, work)
        seconds["slice"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve_line = serve_phase(torch, np, work)
        seconds["serve"] = time.perf_counter() - t0
        print("serve: " + json.dumps(serve_line))
        t0 = time.perf_counter()
        train_launches, batch = train_phase(torch, np,
                                            os.path.join(work, "spec"))
        seconds["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bench_launches = bench_phase(torch, np, os.path.join(work, "spec"))
        seconds["bench"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fit_launches = fit_phase(torch, np, work)
        seconds["fit"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        scan_counts = scan_phase(torch, np, work)
        seconds["scan"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        native_phase(torch, np, work)
        seconds["native"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eval_phase(torch, np, work)
        seconds["eval"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dp_counts, backend = dp_phase(torch, np, os.path.join(work, "spec"))
        seconds["dp"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        zero_counts = zero_phase(torch, np, os.path.join(work, "spec"),
                                 backend)
        seconds["zero"] = time.perf_counter() - t0
    print("train phase launches: " + json.dumps(train_launches))
    # the loss kernels' launches on the paths that run them: fit under the
    # kernel loss paths (the fit phase's eager fit), and fit with
    # epoch_scan: the wrappers' eager launches there (warm-up step, tails,
    # validation), the calls they recorded into the graphs, and the
    # replays' launches that the profiler saw in those fits
    launches.update(fit_launches)
    launches["stft_magnitude"] = bench_launches["stft_magnitude"]
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
        check(entry["launches"] > 0,
              f"{entry['name']} launched on its main path")
        if entry["name"] in scan_counts:
            entry.update(scan_counts[entry["name"]])
            check(entry["scan_launches"] > 0 and entry["scan_captured"] > 0
                  and entry["replay_launches"] > 0,
                  f"{entry['name']} launched and replayed under epoch_scan")
        if entry["name"] in dp_counts:
            # the DP steps' own count, zeroed just before and read after
            entry["dp_launches"] = dp_counts[entry["name"]]
            check(entry["dp_launches"] > 0,
                  f"{entry['name']} launched inside the DP step")
        if entry["name"] in zero_counts:
            # the world-of-one ZeRO-1 and FSDP steps' own count
            entry["zero_launches"] = zero_counts[entry["name"]]
            check(entry["zero_launches"] > 0,
                  f"{entry['name']} launched inside the sharded steps")

    t0 = time.perf_counter()
    parity_phase(torch)
    step_parity_phase(torch, np, batch)
    seconds["parity"] = time.perf_counter() - t0
    print("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in seconds.items()}))

    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
