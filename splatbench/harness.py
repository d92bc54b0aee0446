"""The benchmark's general machinery: finding a cell's files by name, the
device checks, the caches, the check for JAX, and the result line.

Layout (every piece is found by the name ``BENCHMARK.json`` gives it):

- ``configs/<config>.json``     the scene and the render settings
- ``traffic/<traffic>.json``    a traffic mix: ``kind`` names the driver
- ``drivers/<kind>.py``         one general generator per kind of traffic
- ``workloads/<cell>.json``     the cell: its config, traffic and limits
- ``metrics/<metric>.py``       one reader per per-layer metric

An end-to-end metric named ``<quantity>.<variant>`` reports the driver's
``<quantity>`` under a bound of its own: cells whose runs spread alike
share a name, so that a host-bound cell's wide bound does not blunt a
device-bound cell's narrow one.

A later cell, mix, configuration or metric is new files and new entries
in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "gaussiansplats3d_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussiansplats3d_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result: the message goes to stderr and
    the process exits non-zero without a result line."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise BenchError(f"no BENCHMARK.json in {root}")
    return load_json(path)


def cell(name: str, root: Path = ROOT, here: Path = HERE) -> dict:
    """Everything one cell names, by name: its entry in BENCHMARK.json, its
    workload file, its configuration and its traffic mix, and the metrics
    it reports."""
    sp = spec(root)
    entry = next((w for w in sp["workloads"] if w["name"] == name), None)
    if entry is None:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    conf = next((c for c in sp["configs"] if c["name"] == entry["config"]),
                None)
    if conf is None:
        raise BenchError(f"no config {entry['config']!r} in BENCHMARK.json")
    work = load_json(here / "workloads" / f"{name}.json")
    mix = load_json(here / "traffic" / f"{entry['traffic']}.json")
    config = load_json(root / conf["file"])

    def reports(metric):
        return name in metric.get("workloads", [w["name"] for w in
                                                sp["workloads"]])
    return {"name": name, "entry": entry, "workload": work,
            "config": config, "mix": mix, "chips": int(entry["chips"]),
            "end_to_end": [m for m in sp["end_to_end"] if reports(m)],
            "per_layer": [m for m in sp["per_layer"] if reports(m)]}


def load_module(path: Path, name: str):
    """A module of the benchmark from its file (names may hold dots)."""
    if not path.exists():
        raise BenchError(f"missing {path.relative_to(ROOT)}")
    mod_name = "splatbench_" + name.replace(".", "_").replace("-", "_")
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def driver(c: dict, here: Path = HERE):
    kind = c["mix"]["kind"]
    return load_module(here / "drivers" / f"{kind}.py", f"driver.{kind}")


def quantity(metric: str) -> str:
    """The driver's quantity that an end-to-end metric reports."""
    return metric.split(".", 1)[0]


def reader(metric: str, here: Path = HERE):
    return load_module(here / "metrics" / f"{metric}.py", f"metric.{metric}")


def require_devices(count: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: the benchmark measures the card "
                         "and never falls back to the CPU")
    if torch.cuda.device_count() < count:
        raise BenchError(f"the cell needs {count} CUDA device(s), found "
                         f"{torch.cuda.device_count()}")


def set_caches(root: Path = ROOT) -> None:
    """Kernel caches at fixed paths inside the checkout.  The program's
    nvcc builds go to its own ``_build/`` there; Triton's cache, should
    anything compile through Triton, to ``.splatbench_cache/triton``."""
    os.environ["TRITON_CACHE_DIR"] = str(root / ".splatbench_cache"
                                         / "triton")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the program's name begins with the JAX
    package's)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def device_info(count: int, peak: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def quantile(values, q: int, n: int = 100):
    """The q-th of n quantiles of ``values`` (statistics.quantiles)."""
    if len(values) < 2:
        return float(values[0]) if values else float("nan")
    return float(statistics.quantiles(values, n=n)[q - 1])


def worst(*values) -> float:
    """The largest of ``values``; infinity if any is not finite (a NaN
    must not hide behind ``max``)."""
    if any(not math.isfinite(v) for v in values):
        return math.inf
    return max(values)


def compare(readings: dict, limits: dict) -> tuple:
    """(correct, compared): each number beside its limit, in the order the
    workload lists its limits.  A number that is missing or not finite is
    not correct."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        # JSON has no NaN or infinity: a number that is not finite is null
        out[name] = {"value": v if good or (v is not None
                                            and math.isfinite(v)) else None,
                     "limit": limit}
    return ok, out


def result_line(correct, attempted, failed, metrics, device, compared,
                breakdown=None, extra=None) -> str:
    """The last line of standard output; ``compared`` comes last."""
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if extra:
        line.update(extra)
    line["compared"] = compared
    return json.dumps(line)


def compared_lines(compared: dict) -> list:
    return [f"compared {k} {v['value']!r} limit {v['limit']!r}"
            for k, v in compared.items()]
