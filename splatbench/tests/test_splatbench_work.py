"""The work counts copied into splatbench/work.py count what
chip_smoke.py's originals count, at a tiny size on the CPU."""

import json

import pytest
import torch

import chip_smoke
from conftest import ROOT
from splatbench import program, scene
import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu_torch.render import cuda_rasterize as cr
from gaussiansplats3d_tpu_torch.render import cuda_surfel as cs


def _inputs(name, mode_2d):
    config = json.loads((ROOT / f"splatbench/configs/{name}.json")
                        .read_text())
    config.update(splats=4000, width=96, height=64)
    config["render"]["tile_size"] = 16
    if mode_2d:
        config["scene"]["scale_mult"] = 1.5
    mix = json.loads((ROOT / "splatbench/traffic/train.json").read_text())
    cfg = program.render_config(gt, config, mix)
    p = scene.draw_params(config, 5, "cpu")
    cam = program.camera(gt, scene.camera_of(config,
                                             scene.orbit_eye(5.0, 20, 30)),
                         "cpu")
    with torch.no_grad():
        proj, _ = program.project(gt, program.splat_data(gt, p), cam, cfg)
        recs, starts, counts, _, _ = program.bin_records(gt, proj, cfg)
        exit_k = program.tile_exits(gt, recs, starts, counts, cfg)
    return cfg, proj, recs, starts, counts, exit_k


@pytest.mark.parametrize("which", ["b1", "b2"])
def test_3d_counts_match_chip_smoke(which):
    cfg, _, recs, starts, counts, exit_k = _inputs("garden-3dgs", False)
    from gaussiansplats3d_tpu_torch.render.binning import SortedPairs
    pairs = SortedPairs(recs, starts, counts, torch.tensor(0),
                        torch.tensor(0))
    mine = getattr(__import__("splatbench.work", fromlist=["x"]),
                   f"{which}_work")(recs, starts, counts, exit_k,
                                    (cfg.tile_size, cfg.tiles_x,
                                     cfg.num_tiles), cfg.min_alpha)
    _, ops, nbytes = getattr(chip_smoke, f"{which}_work")(cr, pairs, exit_k,
                                                          cfg)
    assert mine == (ops, nbytes) and ops > 0


@pytest.mark.parametrize("which", ["b3", "b4"])
def test_surfel_counts_match_chip_smoke(which):
    cfg, _, recs, starts, counts, exit_k = _inputs("truck-2dgs", True)
    ids = torch.arange(cfg.num_tiles, dtype=torch.int32)
    mine = getattr(__import__("splatbench.work", fromlist=["x"]),
                   f"{which}_work")(recs, starts, counts, exit_k,
                                    (cfg.tile_size, cfg.tiles_x,
                                     cfg.num_tiles), cfg.min_alpha)
    _, ops, nbytes = getattr(chip_smoke, f"{which}_work")(
        cs, (recs, starts, counts, ids), exit_k, cfg)
    assert mine == (ops, nbytes) and ops > 0
