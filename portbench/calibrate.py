"""The readings that ``correct``'s limits are set from, at a cell's own size:
for each seed, the program's (set-up and a short window at the cell's
load, as a run makes them, then the comparison with the reference) and
the control's (the reference with fp8 convs in the program's place,
compared with the float32 reference on the same inputs).  One process for
all the seeds.  Benchmark runs never run it.

    python portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--control 1]

Prints one JSON line a seed and one with the largest program reading and
the smallest control reading of each number.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import cells, run as harness  # noqa: E402

import torch  # noqa: E402


def readings(cell, seed: int, seconds: float, control: bool,
             device) -> dict:
    drv = cells.driver_module(cell.driver)
    tmp = tempfile.mkdtemp(prefix="portbench-cal-")
    ctx = harness.Context(cell, cell.config, harness.svs_config(cell.config),
                          seed, device, tmp)
    driver = drv.Driver(ctx)
    out = {"seed": seed}
    try:
        t0 = time.perf_counter()
        driver.setup()
        out["setup_s"] = time.perf_counter() - t0
        w = driver.window(seconds)
        out["window"] = {"seconds": w["seconds"], "attempted": w["attempted"],
                         **w["e2e"]}
        driver.release()
        out["program"] = driver.check()
        if hasattr(driver, "worst"):
            out["worst_leaf"] = driver.worst()
        if control:
            out["control"] = driver.control()
            if hasattr(driver, "faults"):
                out["faults"] = driver.faults()
    finally:
        driver.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=1)
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rows = []
    for s in args.seeds.split(","):
        row = readings(cell, int(s), args.seconds, bool(args.control), dev)
        rows.append(row)
        print(json.dumps(harness._finite(row)), flush=True)
    summary = {"workload": cell.name, "seeds": len(rows),
               "program_max": {k: max(r["program"][k] for r in rows)
                               for k in cell.limits}}
    if args.control:
        summary["control_min"] = {k: min(r["control"][k] for r in rows)
                                  for k in cell.limits}
    print(json.dumps(harness._finite(summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
