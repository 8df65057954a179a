#!/usr/bin/env python3
"""Drive the PyTorch port (``svs_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing what it found on its own line:

1. device  — the card's name and its ``nvidia-smi`` name / power limit;
2. build   — nvcc builds every hand-written kernel library from
             ``svs_torch/csrc`` (one nvcc per source, all started together);
3. kernels — each kernel against its plain PyTorch version on the card
             (TF32 off) at the main paths' shapes, with CUDA-event times of
             the kernel, the plain version and a PyTorch yardstick:
             ``stft_magphase`` at the decode shapes, and the four MR-STFT
             loss kernels (``spectral_mag`` and ``loss_partials``, forward
             and backward) at the train step's shapes (B = 32, 97,536
             samples, all three resolutions), a ragged shape and a weighted
             batch;
4. slice   — the decode path through the CLIs a user calls, at the full
             width of the ``default`` preset (bf16, seeded random weights
             saved as a reference ``.pth``): ``data_cli --direction to_spec``
             -> ``infer_cli`` -> ``data_cli --direction to_wave`` on three
             synthetic 60-s songs; the kernels' launch counts are zeroed
             just before and read just after; one song's bf16 masks held
             against the same weights and input on the CPU; then
             ``separate_wav`` timed, with one torch.profiler trace of its
             device time by family;
5. train   — the training path on the slice's spectra: ``PatchDataset``
             batches of 32, one seeded full-width ``default`` state, three
             steps from it under each of ``matmul_bf16``, ``pallas_fused``,
             ``pallas_fused_wide`` and ``pallas_bf16`` (counts zeroed just
             before each and read just after), ms per step from CUDA
             events and the device's busy share of a step from a
             torch.profiler trace;
6. parity  — the U-Net at float32 on the card (cuDNN, TF32 off) against the
             same weights and input on the CPU, and one float32 ``fft``
             train step (B = 4, no dropout) on the card against the CPU.

The line before the last is the ``nvidia-smi`` name and power limit, the one
before it the ``kernels`` JSON; the last line is the ``{"ok": true, ...}``
JSON.  Any failed check raises, so the exit code is not 0 and no result line
is printed.  Without a CUDA device, or without the repository beside it, the
script fails the same way.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): float32
# outside the tensor cores, bf16 on the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

SR = 8192
SONG_SECONDS = 60
N_SONGS = 3
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
# float32 train step, card (cuDNN and cuFFT, TF32 off) against the CPU:
# __graft_entry__.py's envelope for one step against another
# implementation of it, except the loss, whose 3 FFT resolutions and 12
# convs sum in other orders on the two backends (1e-4 relative)
STEP_LOSS_RTOL, STEP_GN_RTOL, STEP_BN_ATOL = 1e-4, 1e-3, 1e-4


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


def kernel_phase(torch, np, cdsp):
    """stft_magphase against its plain version; returns the JSON entry."""
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
        ("zero signal", torch.zeros(1 << 18, device="cuda"), 1024, 768),
    ]
    max_err = 0.0
    timing = {}
    for label, y, n_fft, hop in cases:
        mag, ph = cdsp.stft_magphase(y, n_fft, hop)
        torch.cuda.synchronize()
        ref_mag, ref_ph = cdsp.stft_magphase_plain(y, n_fft, hop)
        spec, ref_spec = mag * ph, ref_mag * ref_ph
        e_mag = (mag - ref_mag).abs().max().item()
        e_spec = (spec - ref_spec).abs().max().item()
        scale = max(ref_mag.abs().max().item(), 1e-30)
        print(f"kernel {label}: samples={y.numel()} frames={mag.shape[1]} "
              f"max_abs_err mag={e_mag:.3e} mag*phase={e_spec:.3e} "
              f"max_rel_err mag={e_mag / scale:.3e} "
              f"mag*phase={e_spec / scale:.3e}")
        torch.testing.assert_close(mag, ref_mag, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(spec, ref_spec, atol=ATOL, rtol=0)
        max_err = max(max_err, e_mag, e_spec)
        if label == "zero signal":
            check(bool((mag == 0).all()), "zero signal: mag is exactly 0")
            check(bool((ph[0] == 1).all() and (ph[1] == 0).all()),
                  "zero signal: phase is exactly 1+0j")
            continue
        window = torch.hann_window(n_fft, device="cuda")
        t = {
            "ms": cuda_ms(torch, lambda: cdsp.stft_magphase(y, n_fft, hop)),
            "plain_ms": cuda_ms(
                torch, lambda: cdsp.stft_magphase_plain(y, n_fft, hop)),
            "library_ms": cuda_ms(torch, lambda: torch.stft(
                y, n_fft, hop, window=window, center=True,
                pad_mode="constant", return_complex=True).abs()),
        }
        n_bins, n_frames = mag.shape
        # the least work of the function: per frame the window multiply, a
        # real FFT (2.5 n log2 n operations, half a complex FFT's 5 n log2 n)
        # and, per bin, |z| and the two divides of the unit phase (6); the
        # signal read once, magnitude and phase written once
        flops = n_frames * (n_fft + 2.5 * n_fft * math.log2(n_fft)
                            + 6 * n_bins)
        bytes_ = 4 * (y.numel() + 3 * n_bins * n_frames)
        t["bound_ms"] = max(flops / PEAK_F32_FLOPS, bytes_ / PEAK_BYTES) * 1e3
        t["bound_by"] = ("operations" if flops / PEAK_F32_FLOPS
                         >= bytes_ / PEAK_BYTES else "bytes")
        t["gflop"] = flops / 1e9
        t["mbytes"] = bytes_ / 1e6
        # the bound of the DFT done as a GEMM, as this kernel does it: a
        # multiply and an add per tap for each of the n_fft real values of a
        # frame's spectrum, and the n_fft x n_fft basis read once more
        gemm_flops = 2 * n_frames * n_fft * n_fft
        t["formulation_bound_ms"] = max(
            gemm_flops / PEAK_F32_FLOPS,
            (bytes_ + 4 * n_fft * n_fft) / PEAK_BYTES) * 1e3
        t["formulation_gflop"] = gemm_flops / 1e9
        print(f"kernel {label} times: " + json.dumps(t))
        timing[label] = dict(t, samples=y.numel(), n_fft=n_fft, hop=hop)
    main = timing["decode 4-min song, default"]
    return {
        "name": "stft_magphase",
        "route": "cuda",
        "source": "svs_torch/csrc/stft_magphase.cu",
        "replaces": "svs_tpu/ops/pallas/dsp.py:179",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "formulation_bound_ms": main["formulation_bound_ms"],
        "shape": {"samples": main["samples"], "n_fft": 1024, "hop": 768},
        "other_shapes": {k: v for k, v in timing.items()
                         if k != "decode 4-min song, default"},
    }


def build_phase(build, names) -> None:
    """Build every kernel library at once, one nvcc each; print seconds."""
    t0 = time.perf_counter()
    build.load_all(names)
    print(f"build {', '.join(names)} (one nvcc each, all started "
          f"together): {time.perf_counter() - t0:.1f} s")


def _rel_err(got, want):
    d = (got - want).abs().max().item()
    return d, d / max(want.abs().max().item(), 1e-30)


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return ((a @ b) / (a.norm() * b.norm())).item()


def _fft_ops(n_fft: int, win: int) -> float:
    """Operations of one frame's real FFT and its window multiply."""
    return win + 2.5 * n_fft * math.log2(n_fft)


def loss_bounds(name: str, b: int, t: int, n_fft: int, hop: int, win: int,
                n_taps: int):
    """(bound_ms, bound_by, formulation_bound_ms) of one call.

    bound: the function's least work, the larger of its bytes (inputs read
    once, outputs written once) over HBM and its operations (real FFTs of
    the frames, inverse FFTs in a backward, and the per-cell arithmetic)
    over the f32 peak.  formulation: the kernel's own GEMMs, a multiply
    and an add per tap of the window-deep contraction, on the bf16 tensor
    cores, or its bytes, whichever is larger."""
    n_frames = 1 + (t + 2 * (n_fft // 2) - n_fft) // hop
    n_bins = n_fft // 2 + 1
    frames, cells = b * n_frames, b * n_frames * n_bins
    fft = frames * _fft_ops(n_fft, win)
    gemm = 2.0 * frames * n_fft * n_taps   # one signal's DFT (or adjoint)
    sig, mag = 4 * b * t, 4 * cells
    flops, bytes_, gemms = {
        "spectral_mag_fwd": (fft + 4 * cells, sig + mag, 1),
        "spectral_mag_bwd": (2 * fft + 8 * cells, 2 * sig + mag, 2),
        "loss_partials_fwd": (2 * fft + 14 * cells, 2 * sig + 12 * b, 2),
        "loss_partials_bwd": (3 * fft + 20 * cells, 3 * sig + 12 * b, 3),
    }[name]
    f_ms, b_ms = flops / PEAK_F32_FLOPS * 1e3, bytes_ / PEAK_BYTES * 1e3
    form_ms = max(gemms * gemm / PEAK_BF16_FLOPS * 1e3, b_ms)
    return (max(f_ms, b_ms), "operations" if f_ms >= b_ms else "bytes",
            form_ms)


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
    totals = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                      formulation_bound_ms=0.0, max_abs_err=0.0,
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
                n_taps = sp.Geometry(b, t, *geo).n_taps
                bound, by, form = loss_bounds(name, b, t, *geo, n_taps)
                times = {"ms": cuda_ms(torch, kernel, reps=10),
                         "plain_ms": cuda_ms(torch, plain, reps=5),
                         "library_ms": cuda_ms(torch, lib, reps=10),
                         "bound_ms": bound, "bound_by": by,
                         "formulation_bound_ms": form}
                print(line + " times: " + json.dumps(times))
                for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                          "formulation_bound_ms"):
                    tot[k] += times[k]
                tot["shapes"][f"{n_fft}/{hop}/{win}"] = times
            del lib_mag, lib_part, xg

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
            "library": "composition: torch.stft (cuFFT) magnitudes"
                       + (", the three sums" if "partials" in name else "")
                       + (", autograd backward" if name.endswith("bwd")
                          else ""),
            "formulation_bound_ms": tot["formulation_bound_ms"],
            "shape": {"B": TRAIN_B, "T": TRAIN_T,
                      "per": "one call at each of the three resolutions"},
            "shapes": tot["shapes"],
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
    first_mr = {}
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
    names = ("spectral_mag_fwd", "spectral_mag_bwd", "loss_partials_fwd",
             "loss_partials_bwd")
    return dict(zip(names, total)), host[0]


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

    cdsp.launches = 0
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
    print("slice stages: " + json.dumps(stages))
    print("slice launches: " + json.dumps(launches))
    check(launches["stft_magphase"] == 2 * N_SONGS,
          f"stft_magphase launched twice per song (mixture and vocals): "
          f"{launches['stft_magphase']} for {N_SONGS} songs")

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


# kernel-name fragments -> the layer they belong to (profiler breakdowns)
FAMILIES = (("conv", ("conv", "cudnn", "xmma", "implicit", "gemm", "dgrad",
                      "wgrad", "nchw", "nhwc")),
            ("fft", ("fft",)),
            ("copy", ("memcpy", "memset")))


def device_breakdown(torch, fn, label: str, families=FAMILIES) -> float:
    """Device time of one ``fn()`` call by kernel family, from a
    torch.profiler trace; returns the summed device milliseconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_family, n_kernels = {}, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        family = next((f for f, keys in families
                       if any(k in name for k in keys)), "elementwise")
        by_family[family] = (by_family.get(family, 0.0)
                             + ev.self_device_time_total / 1e3)
        n_kernels += ev.count
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


def main() -> int:
    import numpy as np
    import torch

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

    build_phase(build, [cdsp.KERNEL, cdm.KERNEL, cfl.KERNEL])

    entries = [kernel_phase(torch, np, cdsp)] + loss_kernel_phase(torch, np)

    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as work:
        launches = slice_phase(torch, np, work)
        train_launches, batch = train_phase(torch, np,
                                            os.path.join(work, "spec"))
    launches.update(train_launches)
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
        check(entry["launches"] > 0,
              f"{entry['name']} launched on its main path")

    parity_phase(torch)
    step_parity_phase(torch, np, batch)

    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
