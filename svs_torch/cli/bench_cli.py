"""``bench`` CLI — one-JSON-line end-to-end throughput benchmark (port of
``svs_tpu/cli/bench_cli.py``).

    python -m svs_torch.cli.bench_cli                # the full line
    python -m svs_torch.cli.bench_cli --train        # the train step only
    python -m svs_torch.cli.bench_cli --frontend     # the front-end kernels
    python -m svs_torch.cli.bench_cli --device cpu   # on the host

    python -m svs_torch.cli.bench_cli --dp-smoke --devices 8

Each mode prints one JSON line.  ``--dp-smoke`` is svs_tpu's multi-device
dry run: ``--devices`` gloo ranks on the CPU, the DP, ZeRO-1 and FSDP
train steps against the unsharded step and the segment-parallel decode
against the unsharded decode (``svs_torch.parallel.dryrun``); it exits 1
when a check fails.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Benchmark full-song separation "
                                            "throughput.")
    p.add_argument("--secs", type=float, default=240.0,
                   help="synthetic song length in seconds")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--dtype", type=str, default=None,
                   choices=[None, "float32", "bfloat16"],
                   help="conv compute dtype override")
    p.add_argument("--frontend", action="store_true",
                   help="microbench the spectrogram front end instead: the "
                        "hand-written CUDA kernels against torch.stft")
    p.add_argument("--train", action="store_true",
                   help="microbench the training step instead: ms/step, "
                        "steps/s and MFU at --batch")
    p.add_argument("--batch", type=int, default=32,
                   help="train-bench batch size (reference docs use 32)")
    p.add_argument("--dp-smoke", action="store_true",
                   help="the multi-device dry run: --devices gloo ranks on "
                        "the CPU, the DP, ZeRO-1 and FSDP train steps and "
                        "the segment-parallel decode against the unsharded "
                        "ones; pass/fail and wall time")
    p.add_argument("--devices", type=int, default=8,
                   help="with --dp-smoke: the ranks to start (svs_tpu's "
                        "virtual mesh has 8)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to bench on (default cuda; 'cpu' runs the "
                        "kernels' plain versions on the host)")
    return p


def _frontend_bench(secs: float, device) -> int:
    """|STFT| by the ``stft_magnitude`` kernel against ``torch.stft`` +
    ``abs``, and the ``stft_magphase`` kernel against the torch.fft front
    end (``svs_torch.ops.stft.stft_magphase``), at n_fft 1024, hop 768."""
    import numpy as np
    import torch

    from svs_torch.ops import stft as dsp
    from svs_torch.ops.cuda import dsp as cdsp
    from svs_torch.utils.device import resolve_device
    from svs_torch.utils.profiling import time_amortized as timeit

    dev = resolve_device(device)
    y = torch.from_numpy((np.random.default_rng(0)
                          .standard_normal(int(8192 * secs)) * 0.3
                          ).astype(np.float32)).to(dev)
    window = torch.hann_window(1024, device=dev)

    def torch_mag(s):
        return torch.stft(s, 1024, 768, window=window, center=True,
                          pad_mode="constant", return_complex=True).abs()

    t_kernel = timeit(lambda: cdsp.stft_magnitude(y, 1024, 768))
    t_torch = timeit(lambda: torch_mag(y))
    err = float((cdsp.stft_magnitude(y, 1024, 768)
                 - torch_mag(y)).abs().max())
    # the preprocessing front end: fused mag+phase kernel vs torch.fft
    t_mp_kernel = timeit(lambda: cdsp.stft_magphase(y, 1024, 768))
    t_mp_torch = timeit(lambda: dsp.stft_magphase(y, 1024, 768))
    mp_mag, _ = cdsp.stft_magphase(y, 1024, 768)
    torch_mp_mag, _ = dsp.stft_magphase(y, 1024, 768)
    mp_err = float((mp_mag - torch_mp_mag).abs().max())
    print(json.dumps({
        "metric": "frontend_stft_ms",
        "mag_kernel_ms": round(t_kernel, 3),
        "mag_torch_ms": round(t_torch, 3),
        "mag_max_abs_err": err,
        "magphase_kernel_ms": round(t_mp_kernel, 3),
        "magphase_torch_ms": round(t_mp_torch, 3),
        "magphase_max_abs_err": mp_err,
    }))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.disable(logging.WARNING)
    if args.frontend:
        return _frontend_bench(args.secs, args.device)
    if args.dp_smoke:
        if args.devices < 1:
            print(f"bench_cli --dp-smoke: --devices must be >= 1, got "
                  f"{args.devices}; nothing was run", file=sys.stderr)
            return 2
        from svs_torch.parallel.dryrun import dp_smoke

        line = dp_smoke(args.devices)
        print(json.dumps(line))
        return 0 if line["ok"] else 1
    if args.train:
        import dataclasses

        from svs_torch.utils.benchmark import train_step_bench
        from svs_torch.utils.config import get_config

        cfg = get_config("default")  # the shipped config (bf16)
        if args.dtype:
            cfg = dataclasses.replace(cfg, compute_dtype=args.dtype)
        print(json.dumps(dict({"metric": "train_step"},
                              **train_step_bench(cfg, batch_size=args.batch,
                                                 device=args.device))))
        return 0
    from svs_torch.utils.benchmark import run_bench

    print(json.dumps(run_bench(secs=args.secs, reps=args.reps,
                               compute_dtype=args.dtype,
                               device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
