"""The benchmark's files are found by name, a new cell is files alone, the
result line has the contract's shape, and no run loads JAX."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["splatbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            reported = e2e[m["moves"]].get("workloads", [cell])
            assert cell in reported, (m["name"], cell)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_are_found_by_name(cell):
    from splatbench import harness
    c = harness.cell(cell)
    assert c["config"]["name"] == c["entry"]["config"]
    assert (ROOT / "splatbench/drivers" / f"{c['mix']['kind']}.py").exists()
    assert c["workload"]["limits"]
    e2e = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


@pytest.mark.parametrize("cell", ["t3-train", "t3-orbit", "t2-train",
                                  "t2-orbit"])
def test_a_cell_added_as_files_runs(tiny, cell):
    line, lines = run_cell(tiny, cell)
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "compared"
    assert set(line["compared"]) == set(
        json.loads((tiny / f"splatbench/workloads/{cell}.json").read_text())
        ["limits"])
    assert lines and all(s.startswith("compared ") for s in lines)
    e2e = [m["name"] for m in json.loads((tiny / "BENCHMARK.json")
                                         .read_text())["end_to_end"]
           if cell in m.get("workloads", [cell])]
    assert set(line["metrics"]) == set(e2e)
    for v in line["metrics"].values():
        assert v["value"] > 0 and UNIT.match(v["unit"])
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in line["device"]


def test_traced_line_has_the_trace_keys(tiny):
    line, _ = run_cell(tiny, "t3-train", trace=1)
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device ran: every per-layer reader finds nothing to read
    assert line["metrics"] == {}


def test_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "splatbench/run.py", "--workload", "garden3d-train",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_exits_nonzero_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "splatbench", tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    script = (
        "import sys, torch\n"
        f"sys.path = [{str(tmp_path)!r}] + [p for p in sys.path "
        f"if p.rstrip('/') != {str(ROOT)!r}]\n"
        "from splatbench import harness, run\n"
        "args = run.parse(['--workload', 'garden3d-orbit', '--seed', '1', "
        "'--seconds', '1'])\n"
        "try:\n"
        "    run.execute(args, device=torch.device('cpu'))\n"
        "except harness.BenchError as e:\n"
        "    print('refused:', e); sys.exit(3)\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3, proc.stderr
    assert "cannot import the program" in proc.stdout


def test_a_run_loads_no_jax(tiny):
    script = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT / 'splatbench/tests')!r})\n"
        "from conftest import run_cell\n"
        "from pathlib import Path\n"
        f"line, _ = run_cell(Path({str(tiny)!r}), 't3-orbit')\n"
        "tops = sorted({m.split('.', 1)[0] for m in sys.modules})\n"
        "print(json.dumps(tops))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "gaussiansplats3d_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "gaussiansplats3d_tpu"}


def test_forbidden_names_compare_whole(monkeypatch):
    from splatbench import harness
    monkeypatch.setitem(sys.modules, "gaussiansplats3d_tpu_torch.x", object())
    assert harness.forbidden_modules() == [] or \
        "gaussiansplats3d_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gaussiansplats3d_tpu.core", object())
    assert "gaussiansplats3d_tpu" in harness.forbidden_modules()
