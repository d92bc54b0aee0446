"""Run one cell of the benchmark once and print its result line.

    python3 splatbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the kernels' build or load, the scene, cameras and targets drawn
on the device from the seed, the cell's warm-up) is timed from the start
of this process to the start of the window as ``setup_s``.  With
``--trace 0`` the window runs ``--seconds`` seconds and the line carries
the cell's end-to-end metrics; with ``--trace 1`` a short window runs
under ``torch.profiler`` and the line carries the cell's per-layer
metrics, ``busy_s``, ``window_s`` and ``breakdown``.  Either way the
outputs of the timed path are then checked against the plain reference
(``reference/``), each number compared is printed beside its limit, and
the last line of standard output is one JSON object.

Without a CUDA device, or with fewer than the cell asks for, it exits 3
and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from splatbench import harness, layers, trace  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout
        return out.strip().splitlines()[0] if out.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def execute(args, device=None, t_start=T_START, root=harness.ROOT,
            here=harness.HERE):
    """One run; returns (result line, lines for stderr).  ``device`` other
    than None skips the look for a card (the CPU tests drive the rest of a
    run so); ``root`` and ``here`` locate BENCHMARK.json and the
    benchmark's files."""
    import torch
    c = harness.cell(args.workload, root, here)
    if device is None:
        harness.require_devices(c["chips"])
        device = torch.device("cuda")
    harness.set_caches()
    try:
        from splatbench import program
        gt = program.load(harness.PROGRAM)
    except ImportError as e:
        raise harness.BenchError(f"cannot import the program: {e}") from e
    drv = harness.driver(c, here)
    ctx = SimpleNamespace(cell=c, seed=args.seed, device=device, gt=gt)
    run = drv.Run(ctx)
    log(f"set-up {run.split}")
    cuda = device.type == "cuda"
    metrics, breakdown, extra = {}, None, {"setup_split": run.split}
    units = {m["name"]: m["unit"] for m in c["end_to_end"] + c["per_layer"]}
    if args.trace == 0:
        w = run.window(args.seconds)
        log(f"window {w['t1'] - w['t0']:.3f} s, {w['attempted']} calls")
        attempted, failed = w["attempted"], w["failed"]
        values = dict(w["metrics"], setup_s=w["t0"] - t_start)
        for m in c["end_to_end"]:
            q = harness.quantity(m["name"])
            if q not in values:
                raise harness.BenchError(f"{c['name']} gives no {m['name']}")
            metrics[m["name"]] = {"value": values[q], "unit": m["unit"]}
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    else:
        tr = run.traced(trace)
        log(f"traced window {tr.window_s:.3f} s")
        attempted, failed = len(run.traced_views), 0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        probe = layers.Probe(run, tr)
        for m in c["per_layer"]:
            t0 = time.perf_counter()
            v = harness.reader(m["name"], here).read(probe)
            log(f"{m['name']} {v!r} ({time.perf_counter() - t0:.1f} s)")
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        breakdown = tr.breakdown()
        del probe
    device_line = (harness.device_info(c["chips"], peak) if cuda else
                   {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0})
    if args.trace == 1:
        device_line.update(busy_s=tr.busy_s, window_s=tr.window_s)
    if cuda:
        extra["power"] = power_limit()
    run.free()
    t0 = time.perf_counter()
    readings = run.readings()
    extra["check_s"] = time.perf_counter() - t0
    log(f"check {extra['check_s']:.1f} s")
    correct, compared = harness.compare(readings, c["workload"]["limits"])
    found = harness.forbidden_modules()
    if found:
        raise harness.BenchError("loaded modules of JAX or the JAX package: "
                                 + ", ".join(found))
    line = harness.result_line(correct, attempted, failed, metrics,
                               device_line, compared, breakdown, extra)
    return line, harness.compared_lines(compared)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        line, lines = execute(args)
    except harness.BenchError as e:
        log(f"splatbench: {e}")
        return 3
    print(line, flush=True)
    for s in lines:
        log(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
