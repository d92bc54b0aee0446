"""What the benchmark takes from the program under test, the PyTorch and
CUDA port: its render and training step, its stages (projection, binning)
for the per-layer timings, the records and tile exits its compositors see
(for the work counts), and its kernel libraries.  Nothing else of the
program is read, and the program is never handed anything but the
inputs that ``scene.py`` draws.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import torch

# The CUDA kernel libraries (csrc/<name>.cu) each path launches.
LIBRARIES = {("3d", "train"): ("composite_fwd", "composite_bwd"),
             ("3d", "orbit"): ("composite_fwd",),
             ("2d", "train"): ("surfel_fwd", "surfel_bwd"),
             ("2d", "orbit"): ("surfel_fwd",)}


def load(name: str):
    return importlib.import_module(name)


def mode(config: dict) -> str:
    return "2d" if config["render_mode_2d"] else "3d"


def build(gt, config: dict, kind: str) -> float:
    """Build (or find built) the cell's kernel libraries; seconds taken."""
    build_mod = importlib.import_module(gt.__name__ + "._build")
    t0 = time.perf_counter()
    for lib in LIBRARIES[(mode(config), kind)]:
        build_mod.build(lib)
    return time.perf_counter() - t0


def render_config(gt, config: dict, mix: dict):
    r = config["render"]
    return gt.RenderConfig(
        width=int(config["width"]), height=int(config["height"]),
        sh_degree=int(config["sh_degree"]),
        render_mode_2d=bool(config["render_mode_2d"]),
        tile_size=int(r["tile_size"]), sort_bits=int(r["sort_bits"]),
        lanes=int(r["lanes"]), aux_multiplier=float(r["aux_multiplier"]),
        min_alpha=float(r["min_alpha"]),
        kernel_2d_size=float(r["kernel_2d_size"]),
        max_screen_space_splat_size=float(r["max_screen_space_splat_size"]),
        background=tuple(float(b) for b in r["background"]),
        record_precision=mix["record_precision"],
        forward_only=bool(mix.get("forward_only", False)))


def camera(gt, cam: dict, device):
    return gt.Camera(view=cam["view"].to(device), proj=cam["proj"].to(device),
                     cam_pos=cam["cam_pos"].to(device))


def splat_data(gt, p: dict):
    """The scene's parameters as the renderer's splats (scales and opacity
    activated, as the training step's ``to_splats`` does)."""
    opacity = torch.sigmoid(p["logit_opacity"])[:, None]
    return gt.SplatData(
        means=p["means"], scales=torch.exp(p["log_scales"]), quats=p["quats"],
        colors=torch.cat([p["rgb"], opacity], 1), sh=p["sh"])


def train_parts(gt):
    return importlib.import_module(gt.__name__ + ".parallel.train")


def project(gt, splats, cam, cfg):
    """The path's projection: (projected, mask)."""
    if cfg.render_mode_2d:
        surfel = importlib.import_module(gt.__name__ + ".render.surfel")
        sp = surfel.project_surfels(splats, cam, cfg)
        return sp, sp.mask
    proj_mod = importlib.import_module(gt.__name__ + ".render.projection")
    proj = proj_mod.project_splats(splats, cam, cfg)
    return proj, proj.mask


def projected_fields(proj, cfg) -> list:
    """The differentiable tensors of a projection."""
    if cfg.render_mode_2d:
        return list(proj.t) + [proj.mean2d, proj.color, proj.opacity]
    return [proj.xs, proj.ys, proj.conic_a, proj.conic_b, proj.conic_c,
            proj.col_r, proj.col_g, proj.col_b, proj.opacity]


def with_leaves(proj, cfg):
    """A copy of a projection whose differentiable fields are fresh
    leaves (the binning stage's inputs, timed alone)."""
    if cfg.render_mode_2d:
        return dataclasses.replace(
            proj, t=tuple(t.detach().requires_grad_(True) for t in proj.t),
            mean2d=proj.mean2d.detach().requires_grad_(True),
            color=proj.color.detach().requires_grad_(True),
            opacity=proj.opacity.detach().requires_grad_(True))
    names = ("xs", "ys", "conic_a", "conic_b", "conic_c", "col_r", "col_g",
             "col_b", "opacity")
    return dataclasses.replace(proj, **{
        n: getattr(proj, n).detach().requires_grad_(True) for n in names})


def bin_records(gt, proj, cfg):
    """The path's binning: (records, tile_starts, tile_counts, total pairs,
    overflow)."""
    if cfg.render_mode_2d:
        surfel = importlib.import_module(gt.__name__ + ".render.surfel")
        return surfel.bin_sort_surfels(proj, cfg)
    binning = importlib.import_module(gt.__name__ + ".render.binning")
    pairs = binning.bin_sort_records(proj, cfg)
    return (pairs.records, pairs.tile_starts, pairs.tile_counts,
            pairs.total_pairs, pairs.overflow)


def tile_exits(gt, records, starts, counts, cfg):
    """``exit_k`` of the path's forward compositor on these records."""
    ids = torch.arange(cfg.num_tiles, dtype=torch.int32,
                       device=records.device)
    if cfg.render_mode_2d:
        cs = importlib.import_module(gt.__name__ + ".render.cuda_surfel")
        return cs.composite_surfel_fwd(records, starts, counts, ids, cfg)[2]
    cr = importlib.import_module(gt.__name__ + ".render.cuda_rasterize")
    return cr.composite_fwd(records, starts, counts, ids, cfg)[2]
