"""Run one cell of the benchmark of ``svs_torch`` once.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for.  Set-up (imports, the seeded data and weights, the warm-up that builds
and captures the program) runs first; then the window of ``--seconds``
(``--trace 1``: that window untraced, whose counts the shares of the peak
read, then a traced window of the cell's ``trace_seconds`` at most);
then the peak device memory is read, the program's state is freed, and
what the window produced is compared with the plain reference
(``portbench/reference/``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``: each
number that decided ``correct`` with its limit (also the last lines of
standard error).

Exits 2 without a result where the card is missing, and 3 where a module
of JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
import zlib  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths, so that
# a cell's later runs there find what its first run built
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import cells, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "svs_tpu")
# dense bf16 tensor-core peak FLOP/s by device name (NVIDIA's data sheet;
# svs_torch/utils/benchmark.py's table), the denominator of the mfu shares
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell, its configuration (the file's
    dict and the program's ``SVSConfig``), the seed, the device and the
    run's temporary directory."""
    cell: cells.Cell
    config: dict
    svs: object
    seed: int
    device: torch.device
    tmpdir: str

    def derive(self, *tag) -> int:
        """A seed for one use (``tag``), drawn from the run's seed."""
        words = [self.seed % 2 ** 32, self.seed // 2 ** 32] + [
            zlib.crc32(str(t).encode()) for t in tag]
        return int(np.random.SeedSequence(words).generate_state(
            1, np.uint64)[0] >> 2)


def svs_config(config: dict):
    """The program's configuration from a configuration file's fields."""
    from svs_torch.utils.config import SVSConfig
    fields = {f.name for f in dataclasses.fields(SVSConfig)}
    return SVSConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in config.items() if k in fields})


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def card(device: torch.device, chips: int) -> dict:
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    if device.type == "cuda":
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
                capture_output=True, text=True, timeout=30)
            dev["power_limit_w"] = float(out.stdout.strip())
        except (OSError, ValueError, subprocess.TimeoutExpired):
            pass
    return dev


def run(cell: cells.Cell, bench: dict, seed: int, seconds: float,
        traced: bool, device: torch.device, config: dict = None,
        t_start: float = None) -> dict:
    """One run of ``cell`` on ``device``; the result line as a dict.
    ``config`` replaces the cell's configuration (the CPU tests' tiny
    one)."""
    t_start = T_START if t_start is None else t_start
    config = config or cell.config
    drv = cells.driver_module(cell.driver)
    tmp = tempfile.mkdtemp(prefix="portbench-run-")
    ctx = Context(cell, config, svs_config(config), seed, device, tmp)
    driver = drv.Driver(ctx)
    try:
        driver.setup()
        trace.sync(device)
        setup_s = time.perf_counter() - t_start
        w = driver.window(seconds)
        if traced:
            # the profiler slows the host, so the traced window reads the
            # device alone, and the shares of the peak read the window above
            with trace.Traced() as t:
                with t.window():
                    tw = driver.window(min(seconds, cell.trace_seconds))
            reduced = t.reduce()
        dev = card(device, cell.chips)
        driver.release()
        try:
            compared = driver.check()
        except Exception:  # a check that cannot run is no pass
            traceback.print_exc()
            compared = {k: float("inf") for k in cell.limits}
    finally:
        driver.close()
        shutil.rmtree(tmp, ignore_errors=True)
    correct = all(compared[k] <= cell.limits[k] for k in cell.limits)
    if traced:
        dev["busy_s"] = reduced.get("busy_s", 0.0)
        dev["window_s"] = reduced.get("window_s", 0.0)
        readings = {"trace": reduced, "window": w, "traced_window": tw,
                    "peak_flops": PEAK_FLOPS.get(dev["kind"])}
        metrics = {}
        for m in cells.metrics_for(cell.name, bench, "per_layer"):
            value = cells.metric_reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(w["e2e"], setup_s=setup_s)
        # ``<quantity>.<part>`` is the driver's ``<quantity>`` in the cells
        # that it lists: one quantity split where cells spread apart
        metrics = {m["name"]: {"value": values.get(
                       m["name"], values.get(m["name"].split(".")[0])),
                   "unit": m["unit"]}
                   for m in cells.metrics_for(cell.name, bench,
                                              "end_to_end")}
    done = [w, tw] if traced else [w]
    out = {"correct": bool(correct),
           "attempted": sum(int(x["attempted"]) for x in done),
           "failed": sum(int(x["failed"]) for x in done),
           "metrics": metrics, "device": dev}
    if traced:
        out["breakdown"] = trace.breakdown(reduced)
        out["top_kernels"] = trace.breakdown(
            {"families": reduced.get("kernels", {})}, 15)["device_ops"]
    out["compared"] = {k: {"value": compared[k], "limit": cell.limits[k]}
                       for k in cell.limits}
    return out


def _finite(x):
    """Non-finite numbers as strings: the line stays JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = cells.benchmark()
    cell = cells.load_cell(args.workload, bench=bench)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(cell, bench, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, v in out["compared"].items():
        print(f"compared {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
