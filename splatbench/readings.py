"""The readings that the limits of ``correct`` are set from, on many seeds
in one process: the program's (as a run reads them), the control's (the
reference in bfloat16 put in the program's place) and, with ``--fault``,
the program's with a fault planted (``faults.py``).

    python3 splatbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault <name>] [--seconds 2]

One JSON line per seed on standard output.  Orbit cells run a short
window of ``--seconds`` at the cell's own load before the frames kept are
compared; training cells need none.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from splatbench import faults, harness, program  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None, device=None, root=harness.ROOT,
         here=harness.HERE) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault", choices=faults.NAMES)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch
    c = harness.cell(args.workload, root, here)
    if device is None:
        harness.require_devices(c["chips"])
        device = torch.device("cuda")
    dev = device
    harness.set_caches()
    gt = program.load(harness.PROGRAM)
    drv = harness.driver(c, here)
    kind = c["mix"]["kind"]
    for seed in args.seeds:
        ctx = SimpleNamespace(cell=c, seed=seed, device=dev, gt=gt)
        t0 = time.perf_counter()
        if args.fault:
            with faults.plant(gt, args.fault, kind):
                r = _program_readings(drv, ctx, kind, args.seconds)
        else:
            r = _program_readings(drv, ctx, kind, args.seconds)
        print(json.dumps({"seed": seed, "side": args.fault or "program",
                          "readings": r,
                          "s": time.perf_counter() - t0}), flush=True)
    for seed in args.control_seeds:
        ctx = SimpleNamespace(cell=c, seed=seed, device=dev, gt=gt)
        t0 = time.perf_counter()
        r = drv.control(ctx, torch.bfloat16)
        print(json.dumps({"seed": seed, "side": "control_bf16",
                          "readings": r, "s": time.perf_counter() - t0}),
              flush=True)
    return 0


def _program_readings(drv, ctx, kind, seconds):
    import torch
    run = drv.Run(ctx)
    if kind == "orbit":
        run.window(seconds)
    run.free()
    r = run.readings()
    del run
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    return r


if __name__ == "__main__":
    sys.exit(main())
