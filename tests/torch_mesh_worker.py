"""One rank of the mesh reference test's gloo group
(tests/test_torch_mesh_reference.py).

Run as ``python tests/torch_mesh_worker.py RANK WORLD STORE OUT``: the rank
joins a ``file://`` rendezvous, builds a (2, 2) gather mesh, keeps its rows
of the test's scene and runs ``make_train_step`` for the test's steps, each
step's gradients and the last parameters gathered over the splat group;
then one more step under ``torch.profiler``.  Rank 0 writes what it
gathered, the exchange counters (untraced and traced) and the counts they
should read to ``OUT/results.npz``.  It imports torch, the port and the
benchmark's input makers (``splatbench.scene``, ``splatbench.program``),
never JAX.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import gaussiansplats3d_tpu_torch as gt  # noqa: E402
from gaussiansplats3d_tpu_torch import parallel as par  # noqa: E402
from gaussiansplats3d_tpu_torch.parallel import sharded as sh  # noqa: E402
from gaussiansplats3d_tpu_torch.parallel import train as tr  # noqa: E402
from gaussiansplats3d_tpu_torch.render.projection import (  # noqa: E402
    project_splats)
from gaussiansplats3d_tpu_torch.utils import metrics  # noqa: E402
from splatbench import program, scene  # noqa: E402

SHAPE = (2, 2)
STEPS = 3
LR = 1e-3
CONFIG = {
    "splats": 2000, "sh_degree": 0, "width": 128, "height": 64,
    "render_mode_2d": False,
    "scene": {"extent": 2.0, "scale_lo": 0.005, "scale_hi": 0.05,
              "scale_mult": 3.0, "opacity_lo": 0.3, "opacity_hi": 1.0,
              "sh_std": 0.2},
    "camera": {"fov_y_deg": 60.0, "near": 0.1, "far": 500.0},
    "render": {"tile_size": 16, "sort_bits": 16, "lanes": 2,
               "aux_multiplier": 8.0, "min_alpha": 1.0 / 255.0,
               "kernel_2d_size": 0.3, "max_screen_space_splat_size": 1024.0,
               "background": [0.05, 0.1, 0.15]}}
MIX = {"views": 4, "radius": [4.5, 6.5], "elevation_deg": [10.0, 40.0],
       "target_grid": [3, 4], "record_precision": "mixed"}
SCENE_SEED, TARGET_SEED = 1729, 987654321987
COUNTERS = ("exchange.calls", "exchange.kept", "exchange.slots",
            "exchange.dropped")
SPANS = ("gs.exchange", "gs.exchange.bwd", "gs.allreduce")


def inputs(device="cpu"):
    """The test's scene (training parameters), ring views and targets."""
    return (scene.draw_params(CONFIG, SCENE_SEED, device),
            scene.ring_views(CONFIG, MIX),
            scene.draw_targets(CONFIG, MIX, TARGET_SEED, device))


def run(mesh, out):
    rank = torch.distributed.get_rank()
    saved = {}
    cfg = program.render_config(gt, CONFIG, MIX)
    p0, views, targets = inputs()
    cams = [program.camera(gt, v, "cpu") for v in views]
    blocks = [tr.image_to_tile_blocks(t, cfg) for t in targets]
    params = tr.SplatParams(**{f: sh.local_rows(p0[f], mesh).clone()
                               for f in scene.FIELDS})
    state = tr.TrainState(params=params,
                          opt_state=tr.adam(LR)(params.parameters()))
    step = par.make_train_step(cfg, mesh, tr.adam(LR), route="gather",
                               slab_mode="banded")
    fields = dict(zip(scene.FIELDS, state.params.parameters()))
    metrics.reset()
    for k in range(STEPS):
        state, m = step(state, cams[k], *blocks[k])
        saved[f"loss/{k}"] = float(m["loss"])
        for f, p in fields.items():
            if p.numel():
                saved[f"grad/{k}/{f}"] = sh.gather_rows(p.grad, mesh)
    for f, p in fields.items():
        if p.numel():
            saved[f"params/{f}"] = sh.gather_rows(p.detach(), mesh)
    saved["untraced"] = [int(c in metrics.totals()) for c in COUNTERS]
    # what the traced step's exchange should count: the shard's rows whose
    # box touches this rank's slab, and the default capacity
    _, j = mesh.get_coordinate()
    with torch.no_grad():
        proj = project_splats(state.params.to_splats(), cams[STEPS], cfg)
        saved["n_keep"] = int(sh.touch_rows(cfg, proj, j, SHAPE[1],
                                            "banded").sum())
    saved["ecap"] = sh.default_exchange_capacity(
        cfg, state.params.num_splats, SHAPE[1])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, cams[STEPS], *blocks[STEPS])
    saved["traced"] = [metrics.total(c) for c in COUNTERS]
    names = {e.key for e in prof.key_averages()}
    saved["spans"] = [int(s in names) for s in SPANS]
    if rank == 0:
        np.savez(os.path.join(out, "results.npz"),
                 **{k: (v.numpy() if isinstance(v, torch.Tensor)
                        else np.asarray(v)) for k, v in saved.items()})


def main():
    rank, world, store, out = sys.argv[1:5]
    torch.set_num_threads(1)
    par.initialize_distributed(store, int(world), int(rank), device="cpu")
    try:
        run(par.make_mesh("cpu", *SHAPE), out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
