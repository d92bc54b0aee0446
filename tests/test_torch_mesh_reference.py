"""The mesh's training step (``make_train_step`` over a (2, 2) gather mesh)
against the benchmark's mesh reference, ``splatbench/reference/mesh.py``:
the one statement of what the sharded step computes (the single-device
loss; each slab's record cotangents from its own pixels, every row but x
and y rounded to bfloat16 on the wire; the slabs' parameter gradients
summed, then Adam).

Four gloo ranks on the CPU run tests/torch_mesh_worker.py (torch, the port
and the benchmark's input makers only): a seeded 2,000-splat SH0 scene at
128 x 64, tile 16 (4 tile rows, 2 a slab), 3 steps on 3 ring views.  Bars,
each between the sound reference and the variants that must fail it:

- the losses: relative 1e-5 (sound: under 4e-7);
- the first step's gradients, gathered over the splat group, as vectors:
  |g - g_ref| / |g_ref| <= 1e-4 per field (sound: under 3e-5; the
  reference without the wire's rounding: 3e-4 to 6e-3, without the tile
  all-reduce: above 0.9).  Later steps start from parameters that Adam's
  near-sign steps have already moved apart;
- each field's change after the last step, as norms: relative 5e-4
  (sound: under 1e-4; without the all-reduce: 0.2 and more).

The exchange's counters read the rows the traced step routes and the
default capacity, and nothing while no profiler records.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from splatbench.reference import mesh as mesh_ref
from splatbench.reference import render as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
FIELDS = ("means", "log_scales", "quats", "rgb", "logit_opacity")
LOSS_TOL, GRAD_TOL, CHANGE_TOL = 1e-5, 1e-4, 5e-4


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "4",
                               f"file://{out}/store", str(out)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    with np.load(out / "results.npz") as data:
        return {k: data[k] for k in data.files}


def _reference(**kw):
    p0, views, targets = W.inputs()
    s = ref.settings(W.CONFIG, W.MIX)
    with ref.no_tf32():
        r = mesh_ref.train(p0, views[:W.STEPS], list(targets[:W.STEPS]), s,
                           W.LR, W.SHAPE[1], keep=True, **kw)
    return p0, r


def _gaps(res, p0, r):
    """(loss gaps, first-step gradient gaps, change-norm gaps)."""
    loss = [abs(float(res[f"loss/{k}"]) - r["losses"][k]) / r["losses"][k]
            for k in range(W.STEPS)]
    grad, change = {}, {}
    for f in FIELDS:
        g_ref = r["grads"][0][f].numpy()
        grad[f] = float(np.linalg.norm(res[f"grad/0/{f}"] - g_ref)
                        / np.linalg.norm(g_ref))
        c_ref = float(torch.linalg.norm((r["params"][f] - p0[f]).double()))
        c = float(np.linalg.norm((res[f"params/{f}"]
                                  - p0[f].numpy()).astype(np.float64)))
        change[f] = abs(c - c_ref) / c_ref
    return loss, grad, change


def test_mesh_step_matches_the_mesh_reference(group):
    loss, grad, change = _gaps(group, *_reference())
    assert max(loss) <= LOSS_TOL, loss
    assert max(grad.values()) <= GRAD_TOL, grad
    assert max(change.values()) <= CHANGE_TOL, change


@pytest.mark.parametrize("left_out", ["tile_allreduce", "wire_rounding"])
def test_a_reference_with_a_part_left_out_fails(group, left_out):
    kw = {"slabs": [0]} if left_out == "tile_allreduce" else {"wire": False}
    loss, grad, change = _gaps(group, *_reference(**kw))
    assert max(grad.values()) > GRAD_TOL, grad
    if left_out == "tile_allreduce":
        assert min(grad.values()) > 100 * GRAD_TOL, grad
        assert min(change.values()) > 100 * CHANGE_TOL, change
    else:
        # the rounding moves no loss, and every field's gradient but the
        # means' (whose cotangent is mostly the exact x and y) by over 1e-3
        assert max(loss) <= LOSS_TOL, loss
        assert sum(v > 10 * GRAD_TOL for v in grad.values()) >= 4, grad


def test_exchange_counters_read_the_traced_step_alone(group):
    calls, kept, slots, dropped = (int(v) for v in group["traced"])
    assert (calls, kept, slots, dropped) == (1, int(group["n_keep"]),
                                             int(group["ecap"]), 0)
    assert 0 < kept < slots
    assert not group["untraced"].any()
    assert group["spans"].all()
