"""Where the harness finds a cell, its configuration, its traffic driver and
its per-layer metrics' readers: by the names in ``BENCHMARK.json``, with
no code that knows any one of them.

- a configuration ``<c>``: ``portbench/configs/<c>.json``, the
  configuration as it is run (the program's ``SVSConfig`` fields, the
  preset it mirrors, the published source, ``reduced`` and ``assumed``);
- a cell ``<w>``: ``portbench/workloads/<w>.json``, which names its
  configuration, traffic mix, chips and why (as ``BENCHMARK.json`` does),
  the driver that generates its traffic, the driver's parameters, the
  traced window's length, and the limits of ``correct``'s numbers;
- a driver ``<d>``: ``portbench/drivers/<d>.py``, one module a kind of
  traffic (``PARAMS`` names the parameters it reads, ``CONFIG_KEYS`` the
  data scale it takes from the configuration, ``LIMITS`` the numbers it
  compares, ``Driver`` runs it);
- a per-layer metric ``<m>``: ``portbench/metrics/<m>.py``, whose
  ``read(readings)`` returns the value, or None where the run gave it
  nothing to read.

This module imports nothing of the program, so that the CPU tests can
validate cells without it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELL_KEYS = {"config", "traffic", "chips", "why", "driver", "params",
             "trace_seconds", "limits"}


class CellError(ValueError):
    """A cell, configuration, driver or metric that cannot be used."""


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    config: Dict            # the configuration file's contents
    traffic: str
    chips: int
    why: str
    driver: str
    params: Dict
    trace_seconds: float
    limits: Dict[str, float]


def benchmark(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(path: str, what: str) -> Dict:
    if not os.path.isfile(path):
        raise CellError(f"{what}: no file {os.path.relpath(path)}")
    with open(path) as f:
        return json.load(f)


def _module(path: str, what: str):
    if not os.path.isfile(path):
        raise CellError(f"{what}: no file {os.path.relpath(path)}")
    name = "portbench_" + re.sub(r"\W", "_", os.path.relpath(path, HERE))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_module(name: str, root: str = ROOT):
    return _module(os.path.join(root, "portbench", "drivers", f"{name}.py"),
                   f"driver {name!r}")


def metric_reader(name: str, root: str = ROOT):
    mod = _module(os.path.join(root, "portbench", "metrics", f"{name}.py"),
                  f"metric {name!r}")
    if not callable(getattr(mod, "read", None)):
        raise CellError(f"metric {name!r}: its file has no read()")
    return mod.read


def _is(value, kind: type) -> bool:
    """``value`` is of ``kind`` (an int stands for a float; a bool is
    neither)."""
    if kind is bool or isinstance(value, bool):
        return kind is bool and isinstance(value, bool)
    if kind is float:
        return isinstance(value, (int, float))
    return isinstance(value, kind)


def load_cell(name: str, root: str = ROOT,
              bench: Optional[Dict] = None) -> Cell:
    """The cell ``name`` from its workload file, validated: its
    configuration file, its driver and the driver's parameters and limits
    must all be there (with the data scale the driver reads from the
    configuration), and where ``BENCHMARK.json`` lists the cell, the two
    must agree on its configuration, traffic, chips and why."""
    if not NAME.match(name):
        raise CellError(f"cell name {name!r} is not a valid name")
    w = _load_json(os.path.join(root, "portbench", "workloads",
                                f"{name}.json"), f"cell {name!r}")
    if set(w) != CELL_KEYS:
        raise CellError(f"cell {name!r}: keys {sorted(w)}, expected "
                        f"{sorted(CELL_KEYS)}")
    for key in ("config", "traffic", "driver"):
        if not NAME.match(str(w[key])):
            raise CellError(f"cell {name!r}: {key} {w[key]!r} is not a "
                            "valid name")
    if w["chips"] not in (1, 4):
        raise CellError(f"cell {name!r}: chips must be 1 or 4")
    config = _load_json(os.path.join(root, "portbench", "configs",
                                     f"{w['config']}.json"),
                        f"configuration {w['config']!r}")
    drv = driver_module(w["driver"], root)
    missing = set(drv.PARAMS) - set(w["params"])
    extra = set(w["params"]) - set(drv.PARAMS)
    if missing or extra:
        raise CellError(f"cell {name!r}: driver {w['driver']!r} reads "
                        f"{sorted(drv.PARAMS)}; missing {sorted(missing)}, "
                        f"unknown {sorted(extra)}")
    for key, kind in drv.PARAMS.items():
        if not _is(w["params"][key], kind):
            raise CellError(f"cell {name!r}: param {key} must be "
                            f"{kind.__name__}")
    absent = [k for k in getattr(drv, "CONFIG_KEYS", ()) if k not in config]
    if absent:
        raise CellError(f"cell {name!r}: driver {w['driver']!r} reads "
                        f"{absent} from its configuration "
                        f"{w['config']!r}, which has none")
    if set(w["limits"]) != set(drv.LIMITS):
        raise CellError(f"cell {name!r}: limits {sorted(w['limits'])}, "
                        f"driver {w['driver']!r} compares "
                        f"{sorted(drv.LIMITS)}")
    bench = bench if bench is not None else benchmark(root)
    entry = next((c for c in bench.get("workloads", ())
                  if c["name"] == name), None)
    if entry is not None:
        for key in ("config", "traffic", "chips", "why"):
            if entry[key] != w[key]:
                raise CellError(f"cell {name!r}: {key} is {w[key]!r} in "
                                f"its file, {entry[key]!r} in "
                                "BENCHMARK.json")
    return Cell(name, w["config"], config, w["traffic"], w["chips"],
                w["why"], w["driver"], dict(w["params"]),
                float(w["trace_seconds"]), dict(w["limits"]))


def metrics_for(name: str, bench: Dict, kind: str) -> List[Dict]:
    """The ``kind`` (``end_to_end`` or ``per_layer``) metrics that cell
    ``name`` reports: those that list it, and those that list no cells
    and move an end-to-end metric that it reports."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", (name,))]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in moved)]
