"""CPU tests of the benchmark.  They import the benchmark and the program,
never JAX or the JAX package, and run at tiny sizes with the program's
plain kernels on the CPU; tests that need the card carry the ``cuda``
marker and skip here.

    python -m pytest splatbench/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (and nvcc); skips elsewhere")


def tiny_tree(dst: Path, splats: int = 3000, width: int = 64,
              height: int = 48) -> Path:
    """A copy of the benchmark with tiny cells added as files (configs,
    mixes, workloads and BENCHMARK.json entries only): ``t3-train``,
    ``t3-orbit``, ``t2-train`` and ``t2-orbit``."""
    shutil.copytree(ROOT / "splatbench", dst / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, base in (("tiny-3d", "garden-3dgs"),
                       ("tiny-2d", "truck-2dgs")):
        c = json.loads((ROOT / f"splatbench/configs/{base}.json").read_text())
        c.update(name=name, splats=splats, width=width, height=height)
        c["render"]["tile_size"] = 16
        # room for every pair of a close camera's big splats: a pair the
        # program drops is a wrong image
        c["render"]["aux_multiplier"] = 8.0
        (dst / f"splatbench/configs/{name}.json").write_text(json.dumps(c))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"splatbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    for kind in ("train", "orbit"):
        m = json.loads((ROOT / f"splatbench/traffic/{kind}.json").read_text())
        m.update(views=4, max_frames=40, trace_frames=3, trace_steps=2,
                 max_steps=1000, warmup_steps=1, warmup_frames=1,
                 sample_frames=2)
        (dst / f"splatbench/traffic/tiny-{kind}.json").write_text(
            json.dumps(m))
    limits = {"train": {"loss_gap": 1e-4, "grad_gap": 1e-4,
                        "change_gap": 1e-3},
              "orbit": {"color_rms": 2e-3, "alpha_rms": 2e-3}}
    for cell, conf, kind in (("t3-train", "tiny-3d", "train"),
                             ("t3-orbit", "tiny-3d", "orbit"),
                             ("t2-train", "tiny-2d", "train"),
                             ("t2-orbit", "tiny-2d", "orbit")):
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": f"tiny-{kind}", "chips": 1,
                                   "why": "test"})
        (dst / f"splatbench/workloads/{cell}.json").write_text(
            json.dumps({"limits": limits[kind]}))
        like = ("garden3d-" if conf == "tiny-3d" else "truck2d-") + kind
        for section in ("end_to_end", "per_layer"):
            for m in bench[section]:
                if like in m.get("workloads", []):
                    m["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tiny"))


def run_cell(root: Path, cell: str, seed: int = 987654321987,
             trace: int = 0, seconds: float = 0.5):
    """One run of ``cell`` of the tree at ``root`` on the CPU: (result
    line as a dict, stderr lines)."""
    import time

    import torch

    from splatbench import run
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace)])
    line, lines = run.execute(args, device=torch.device("cpu"),
                              t_start=time.perf_counter(), root=root,
                              here=root / "splatbench")
    return json.loads(line), lines
