#!/usr/bin/env python3
"""Drive the PyTorch port (``svs_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing what it found on its own line:

1. device  — the card's name and its ``nvidia-smi`` name / power limit;
2. build   — nvcc builds the hand-written kernel from ``svs_torch/csrc``;
3. kernels — each kernel against its plain PyTorch version on the card
             (TF32 off) at the main path's shapes, with CUDA-event times of
             the kernel, the plain version and a one-call PyTorch yardstick;
4. slice   — the main path through the CLIs a user calls, at the full width
             of the ``default`` preset (bf16, seeded random weights saved as
             a reference ``.pth``): ``data_cli --direction to_spec`` ->
             ``infer_cli`` -> ``data_cli --direction to_wave`` on three
             synthetic 60-s songs; the kernels' launch counts are zeroed
             just before and read just after; one song's bf16 masks held
             against the same weights and input on the CPU; then
             ``separate_wav`` timed, with one torch.profiler trace of its
             device time by family;
5. parity  — the U-Net at float32 on the card (cuDNN, TF32 off) against the
             same weights and input on the CPU.

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
# outside the tensor cores and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
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
    busy = decode_breakdown(torch, lambda: separate.separate_wav(model, y))
    idle = 1.0 - busy / per_song["240s_song_ms"]
    print(f"separate_wav 240-s song: device busy {busy:.3f} ms of "
          f"{per_song['240s_song_ms']:.3f} ms, idle share {idle:.3f}")
    return launches


# kernel-name fragments -> the layer they belong to (decode breakdown)
FAMILIES = (("conv", ("conv", "cudnn", "xmma", "implicit", "gemm", "dgrad",
                      "wgrad", "nchw", "nhwc")),
            ("fft", ("fft",)),
            ("copy", ("memcpy", "memset")))


def decode_breakdown(torch, fn) -> float:
    """Device time of one ``fn()`` call by kernel family, from a
    torch.profiler trace; returns the summed device milliseconds."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_family, n_kernels = {}, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        family = next((f for f, keys in FAMILIES
                       if any(k in name for k in keys)), "elementwise")
        by_family[family] = (by_family.get(family, 0.0)
                             + ev.self_device_time_total / 1e3)
        n_kernels += ev.count
    busy = sum(by_family.values())
    check(busy > 0, "the profiler saw device time in separate_wav")
    print("separate_wav 240-s song device ms by family: "
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
    from svs_torch.ops.cuda import dsp as cdsp

    # every f32 comparison on the card is true f32: cuDNN's convs and
    # cuBLAS's matmuls would otherwise round operands to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; tf32 off for cudnn and matmul")

    t0 = time.perf_counter()
    build.load(cdsp.KERNEL)
    print(f"build {cdsp.KERNEL}: {time.perf_counter() - t0:.1f} s")

    entry = kernel_phase(torch, np, cdsp)

    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as work:
        launches = slice_phase(torch, np, work)
    entry["launches"] = launches[entry["name"]]

    parity_phase(torch)

    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
