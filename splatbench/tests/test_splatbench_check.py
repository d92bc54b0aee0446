"""The comparison that decides ``correct`` fails what it must: the control
(the reference in bfloat16 put in the program's place) and every fault a
cell can have, planted in the program underneath a run that skips only
the look for a card."""

import json
from types import SimpleNamespace

import pytest
import torch

from conftest import run_cell
from splatbench import faults, harness, program

CELLS = ["t3-train", "t3-orbit", "t2-train", "t2-orbit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    c = harness.cell(cell, tiny, tiny / "splatbench")
    drv = harness.driver(c, tiny / "splatbench")
    ctx = SimpleNamespace(cell=c, seed=424242, device=torch.device("cpu"),
                          gt=program.load(harness.PROGRAM))
    readings = drv.control(ctx, torch.bfloat16)
    correct, compared = harness.compare(readings, c["workload"]["limits"])
    assert not correct, compared
    # and it fails by a wide margin on at least one number
    assert any(v["value"] > 3 * v["limit"] for v in compared.values())


FAULTS = [(cell, f) for cell in CELLS for f in faults.NAMES
          if cell.endswith("train") or f == "altered"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(tiny, cell, fault):
    gt = program.load(harness.PROGRAM)
    with faults.plant(gt, fault, "train" if "train" in cell else "orbit"):
        line, lines = run_cell(tiny, cell)
    assert line["correct"] is False, line["compared"]
    assert any("compared" in s for s in lines)
    # the program is whole again after the block
    line, _ = run_cell(tiny, cell)
    assert line["correct"] is True, line["compared"]


def test_limits_are_set_for_every_cell():
    from conftest import ROOT
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        limits = json.loads((ROOT / f"splatbench/workloads/{w['name']}.json")
                            .read_text())["limits"]
        assert limits and all(0 < v < 1 for v in limits.values())


@pytest.mark.parametrize("seed", [7, 987654321987])
def test_reference_surfel_box_is_the_definitions(seed):
    """The surfel box's extent is a difference of near-equal squares that
    float32 rounds to noise for a surfel under a pixel; the reference takes
    it in float32 term by term as the definition does, so on the truck's
    sub-pixel surfels its box is the program's to the bit."""
    from conftest import ROOT
    from splatbench import scene
    from splatbench.reference import render as ref
    gt = program.load(harness.PROGRAM)
    config = json.loads((ROOT / "splatbench/configs/truck-2dgs.json")
                        .read_text())
    config["splats"] = 4000
    mix = json.loads((ROOT / "splatbench/traffic/train.json").read_text())
    dev = torch.device("cpu")
    p = scene.draw_params(config, seed, dev)
    cfg = program.render_config(gt, config, mix)
    s = ref.settings(config, mix)
    for view in scene.ring_views(config, mix)[:4]:
        sp, mask = program.project(gt, program.splat_data(gt, p),
                                   program.camera(gt, view, dev), cfg)
        f = ref.project_2d(p, view, s, torch.float32)
        assert torch.equal(mask, f["mask"])
        assert torch.equal(sp.rx[mask], f["rx"][mask])
        assert torch.equal(sp.ry[mask], f["ry"][mask])
