"""A ``train_mesh`` cell added as files alone runs on four gloo ranks on the
CPU: set-up, the window, the traced window and the check; its control and
every planted fault read ``correct: false``; a rank that raises ends the
run non-zero with every rank reaped; the mesh reference loads nothing of
the program or of JAX."""

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT, run_cell, tiny_tree
from splatbench import harness, program

CELL = "tm-train"
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-3}


@pytest.fixture(scope="module")
def tiny_mesh(tmp_path_factory):
    """The tiny tree with a (2, 2) mesh cell: config4's configuration at
    2,000 splats, 128 x 64, tile 16 (2 tile rows a slab)."""
    dst = tiny_tree(tmp_path_factory.mktemp("tiny_mesh"))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    c = json.loads((ROOT / "splatbench/configs/config4-16m-sh0.json")
                   .read_text())
    c.update(name="tiny-mesh", splats=2000, width=128, height=64)
    c["render"].update(tile_size=16, aux_multiplier=8.0)
    (dst / "splatbench/configs/tiny-mesh.json").write_text(json.dumps(c))
    bench["configs"].append({"name": "tiny-mesh", "source": "test",
                             "file": "splatbench/configs/tiny-mesh.json",
                             "reduced": [], "why": "test"})
    m = json.loads((ROOT / "splatbench/traffic/train_mesh.json").read_text())
    m.update(views=4, trace_steps=2, max_steps=1000, warmup_steps=1)
    (dst / "splatbench/traffic/tiny-train_mesh.json").write_text(
        json.dumps(m))
    bench["workloads"].append({"name": CELL, "config": "tiny-mesh",
                               "traffic": "tiny-train_mesh", "chips": 4,
                               "why": "test"})
    (dst / f"splatbench/workloads/{CELL}.json").write_text(
        json.dumps({"limits": LIMITS}))
    for section in ("end_to_end", "per_layer"):
        for metric in bench[section]:
            if "config4-train-4gpu" in metric.get("workloads", []):
                metric["workloads"].append(CELL)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def _ctx(root, fault=None, seed=424242):
    c = harness.cell(CELL, root, root / "splatbench")
    return c, SimpleNamespace(cell=c, seed=seed, device=torch.device("cpu"),
                              gt=program.load(harness.PROGRAM), fault=fault)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_mesh_cell_added_as_files_runs(tiny_mesh, trace):
    line, lines = run_cell(tiny_mesh, CELL, trace=trace, seconds=1.0)
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["compared"]) == set(LIMITS)
    assert len(line["setup_split"]["rank_peak_bytes"]) == 4
    if trace == 0:
        assert set(line["metrics"]) == {"train_msplats_per_s", "setup_s"}
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        # the readers read the card alone
        assert line["metrics"] == {} and "window_s" in line["device"]
    assert not torch.distributed.is_initialized()


def test_rank_0s_slab_work_is_counted(tiny_mesh):
    """``train_mfu.mesh``'s count (the card's reader alone calls it): B1 and
    B2 on rank 0's slab, gathered as the exchange gathers it, and its
    shard's projection; the other ranks join each view's collectives."""
    from splatbench import work
    c, ctx = _ctx(tiny_mesh)
    drv = harness.driver(c, tiny_mesh / "splatbench")
    run = drv.Run(ctx)
    try:
        views = run.m.order[:2]
        ops = [run.slab_ops(v) for v in views]
        run.m.command(drv.RECORDS, views[0])
        recs, starts, counts, exit_k, in_view = run.m.slab_records(views[0])
    finally:
        run.free()
    assert all(o > 0 for o in ops) and ops == [run.slab_ops(v)
                                               for v in views]
    # rank 0's slab is the first of 2 bands: its tiles are 2 of 4 rows
    assert starts.shape[0] == 2 * run.cfg.tiles_x and int(counts.sum()) > 0
    proj = work.projection_ops(in_view, 0, False, True)
    assert 0 < proj < ops[0]


def test_the_window_runs_whole_batches_in_step_on_every_rank(tiny_mesh):
    """A command runs ``BATCH`` steps on every rank, each from its own copy
    of the seeded order; the end compares the ranks' step counts, and a
    rank out of step ends the run with an error, every rank reaped."""
    c, ctx = _ctx(tiny_mesh)
    drv = harness.driver(c, tiny_mesh / "splatbench")
    run = drv.Run(ctx)
    try:
        before = run.m.next_step
        w = run.window(0.1)
        assert w["attempted"] % drv.BATCH == 0
        assert run.m.next_step == before + w["attempted"]
        run.m.next_step += 1      # rank 0 alone: out of step
    except BaseException:
        run.free()
        raise
    with pytest.raises(harness.BenchError, match="different numbers"):
        run.free()
    assert all(p.poll() is not None for p in run.procs)
    assert not torch.distributed.is_initialized()


def test_mesh_control_is_not_correct(tiny_mesh):
    c, ctx = _ctx(tiny_mesh)
    drv = harness.driver(c, tiny_mesh / "splatbench")
    correct, compared = harness.compare(drv.control(ctx, torch.bfloat16),
                                        c["workload"]["limits"])
    assert not correct, compared
    assert any(v["value"] > 3 * v["limit"] for v in compared.values())


@pytest.mark.parametrize("fault", ["no_allreduce", "half_batch", "altered"])
def test_a_planted_mesh_fault_is_not_correct(tiny_mesh, fault):
    c, ctx = _ctx(tiny_mesh, fault)
    drv = harness.driver(c, tiny_mesh / "splatbench")
    run = drv.Run(ctx)
    run.window(0.1)
    run.free()
    correct, compared = harness.compare(run.readings(),
                                        c["workload"]["limits"])
    assert not correct, compared
    # the fault was planted for the run alone
    line, _ = run_cell(tiny_mesh, CELL, seconds=0.1)
    assert line["correct"] is True, line["compared"]


def test_a_rank_that_raises_ends_the_run(tiny_mesh):
    """The last rank raises at its first step: the run ends non-zero within
    the timeout, and no rank outlives it."""
    code = textwrap.dedent(f"""
        import sys, torch
        sys.path.insert(0, {str(ROOT)!r})
        sys.path.insert(0, {str(ROOT / "splatbench/tests")!r})
        from pathlib import Path
        from test_splatbench_mesh import _ctx
        from splatbench import harness
        root = Path({str(tiny_mesh)!r})
        c, ctx = _ctx(root, "raise")
        run = harness.driver(c, root / "splatbench").Run(ctx)
        run.window(0.1)
        print("finished")
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240, cwd=str(ROOT))
    assert p.returncode != 0 and "finished" not in p.stdout, p.stderr[-3000:]
    assert "planted fault" in p.stderr
    pids = [int(x) for ln in p.stderr.splitlines()
            if ln.startswith("ranks 1-3: pids") for x in ln.split()[3:]]
    assert len(pids) == 3
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_mesh_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import splatbench.reference.mesh; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"jax", "jaxlib", "flax", "gaussiansplats3d_tpu",
                       "gaussiansplats3d_tpu_torch"}, tops
