"""``evaluate`` CLI: BSS eval over folders of wavs (port of
``svs_tpu/cli/eval_cli.py``).

Flag surface and output preserved from reference evaluate.py:88-182:
  --est --mix --ref --ext --out_csv
and svs_tpu's --jobs and --impl, with ``--impl torch`` (BSS eval as one
batched torch program on --device, default cuda, in float64:
``svs_torch/evaluation/bss_torch.py``) in the place of ``jax``, and
``--impl numpy`` the host reference.  With ``--impl torch --jobs > 1`` the
worker pool starts its processes with ``spawn``: a process that has touched
CUDA cannot be forked.

Run as ``python -m svs_torch.cli.eval_cli``.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Evaluate SVS results with SDR / SIR / SAR / NSDR "
                    "(vocal only).")
    p.add_argument("--est", type=str, required=True,
                   help="predicted vocal wav folder")
    p.add_argument("--mix", type=str, required=True,
                   help="ground-truth mixture wav folder")
    p.add_argument("--ref", type=str, required=True,
                   help="ground-truth vocal wav folder")
    p.add_argument("--ext", type=str, default="wav")
    p.add_argument("--out_csv", type=str, default=None)
    p.add_argument("--jobs", type=int, default=1,
                   help="parallel worker processes (the reference evaluates "
                        "serially)")
    p.add_argument("--impl", type=str, default="numpy",
                   choices=("numpy", "torch"),
                   help="BSS eval backend: 'numpy' (host f64, reference "
                        "parity) or 'torch' (one batched program on "
                        "--device in f64, numpy for a call whose result "
                        "holds a NaN)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of --impl torch (default cuda; 'cpu' "
                        "runs on the host)")
    return p


def _eval_track(paths, impl: str = "numpy", device: str = "cuda"):
    """One track's metrics (importable by the worker processes)."""
    pred_path, mix_path, ref_path = paths
    from svs_torch.data import wav as wavio

    mix, sr_mix = wavio.load_audio(mix_path, sr=None, mono=True)
    ref, sr_ref = wavio.load_audio(ref_path, sr=None, mono=True)
    est, sr_est = wavio.load_audio(pred_path, sr=None, mono=True)
    if not (sr_mix == sr_ref == sr_est):
        raise ValueError(f"Sample rate mismatch: mix={sr_mix}, "
                         f"ref={sr_ref}, est={sr_est}")
    if impl == "torch":
        from svs_torch.evaluation import bss_torch
        return bss_torch.compute_metrics_for_track(mix, ref, est,
                                                   device=device)
    from svs_torch.evaluation import bss
    return bss.compute_metrics_for_track(mix, ref, est)


def _pool_context(impl: str):
    """The worker pool's start method.  ``torch`` workers touch CUDA, and a
    forked child of a process that has touched CUDA cannot use it: spawn.
    numpy workers fork when the parent runs one OS thread (forking a parent
    with threads can deadlock the children), else spawn."""
    import multiprocessing

    if impl == "torch":
        return multiprocessing.get_context("spawn")
    try:  # Linux: count the OS threads (C threads included)
        single = len(os.listdir("/proc/self/task")) == 1
    except OSError:  # no /proc: the platform-safe choice
        single = False
    return multiprocessing.get_context("fork" if single else "spawn")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np

    if args.impl == "torch":
        from svs_torch.utils.device import resolve_device
        resolve_device(args.device)  # no card and no --device cpu: raise

    pred_files = sorted(glob.glob(os.path.join(args.est, f"*.{args.ext}")))
    if not pred_files:
        print(f"[Error] No *.{args.ext} files found in {args.est}")
        return 1

    all_results = []
    lists = {k: [] for k in ("SDR", "SIR", "SAR", "NSDR")}

    print("=== Start Evaluation ===")
    print(f"#tracks = {len(pred_files)}\n")

    jobs = []
    for pred_path in pred_files:
        basename = os.path.basename(pred_path)
        mix_path = os.path.join(args.mix, basename)
        ref_path = os.path.join(args.ref, basename)
        if not os.path.exists(mix_path):
            print(f"[Warning] Mixture file not found, skip: {mix_path}")
            continue
        if not os.path.exists(ref_path):
            print(f"[Warning] Vocal ref file not found, skip: {ref_path}")
            continue
        jobs.append((basename, (pred_path, mix_path, ref_path)))

    results = []
    if args.jobs > 1:
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=args.jobs,
                                 mp_context=_pool_context(args.impl)) as pool:
            futures = [(b, pool.submit(_eval_track, p, args.impl,
                                       args.device)) for b, p in jobs]
            for b, f in futures:
                try:
                    results.append((b, f.result()))
                except Exception as e:
                    print(f"[Error] Failed on {b}: {e}")
    else:
        for b, p in jobs:
            try:
                results.append((b, _eval_track(p, args.impl, args.device)))
            except Exception as e:
                print(f"[Error] Failed on {b}: {e}")

    for basename, metrics in results:
        track = os.path.splitext(basename)[0]
        print(f"{track[:20]}:\t"
              f"SDR={metrics['SDR']:.3f} dB,\t"
              f"SIR={metrics['SIR']:.3f} dB,\t"
              f"SAR={metrics['SAR']:.3f} dB,\t"
              f"NSDR={metrics['NSDR']:.3f} dB")
        for k in lists:
            lists[k].append(metrics[k])
        all_results.append({"track": track, **metrics})

    if not all_results:
        print("\n[Error] No valid tracks evaluated.")
        return 1

    print("\n=== Overall Mean Metrics (vocal) ===")
    print(f"Mean SDR : {np.mean(lists['SDR']):.3f} dB")
    print(f"Mean SIR : {np.mean(lists['SIR']):.3f} dB")
    print(f"Mean SAR : {np.mean(lists['SAR']):.3f} dB")
    print(f"Mean NSDR: {np.mean(lists['NSDR']):.3f} dB")

    if args.out_csv is not None:
        fieldnames = ["track", "SDR", "SIR", "SAR", "NSDR"]
        with open(args.out_csv, "w", newline="", encoding="utf-8") as f:
            writer = csv.DictWriter(f, fieldnames=fieldnames)
            writer.writeheader()
            for row in all_results:
                writer.writerow(row)
        print(f"\n[Info] Results saved to {args.out_csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
