"""On-card kernel parity gate (counterpart of the JAX package's
``tools/tpu_parity.py``; its name says which card it gates).

The CPU tests exercise only the kernels' plain PyTorch versions; this tool
runs the CUDA kernels (B1-B4) on the card at shapes that exercise the risky
kernel paths:

- early exit (an opaque wall of splats drives transmittance under the
  exit threshold mid-tile, so the backward replay starts at exit_k);
- tile windows that start mid-chunk, so neighbouring tiles read the same
  floor-aligned chunk;
- the depth channel's 4-wide record layout;
- the 2DGS surfel kernels (ray-plane fragment + hand-derived transpose),
  with and without the depth channel;
- the binning backward alone (straight-through codecs, the record
  gather's backward), card against CPU;
- a kernel-boundary case at 1M splats, 512x384.

Two comparisons per render case:

1. **kernel vs plain version** (forward images AND kernel-boundary record
   gradients, 1e-3; this replaces the JAX tool's compiled vs interpret):
   the records are built once on the card and fed to the kernels and,
   copied to the CPU, to their plain versions, which compute the same
   function; the images are assembled from each side's tile blocks.  The
   pipeline's hard thresholds (1e-4 exit, min_alpha, the 0.999 clamp, the
   support box) are discrete decisions fed by transcendentals whose last
   ulp differs between the card and the host's libm, so the gate is on
   error MASS (p99.9 / share over the bar, plus a 60x cap), never the
   elementwise max alone.
2. **kernel vs the untiled oracle** (forward images, 5e-3; this replaces
   compiled vs the XLA backend): the port's ``reference_render`` for 3D,
   ``surfel.render_2d`` for 2D, on the card.  The XLA backend shared the
   tiled path's binning, and with it the pairs the aux capacity drops and
   the record codecs' rounding; the oracle drops and rounds nothing, so
   the render held against it carries float32 records at a capacity that
   holds every pair (``ORACLE_AUX``) and must report no overflow.  The
   codecs themselves are held by comparison 1 and by the CPU tests against
   the JAX package's binning.

End-to-end gradients through the whole render on the card are checked for
finiteness only, as in the JAX tool.

Usage:  python -m gaussiansplats3d_tpu_torch.tools.gpu_parity
Exits 2 without a CUDA device, 1 (with the failure list) on divergence,
0 after printing "GPU kernel parity: OK".
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

FIELDS = ("means", "scales", "quats", "colors", "sh")
# aux capacity (a multiple of N) of the render held against the oracle:
# enough for every pair of build_scene's view
ORACLE_AUX = 4.0


def build_scene(device="cpu"):
    """6k splats (SH1), some scaled way up so single splats span many tiles
    (aux path + early exit), plus near-opaque colours for the exit
    threshold; drawn on the CPU from fixed seeds, then moved to
    ``device``."""
    import gaussiansplats3d_tpu_torch as gt
    gen = torch.Generator(device="cpu")
    splats = gt.random_splats(gen.manual_seed(11), 6000, sh_degree=1,
                              device="cpu")
    big = torch.rand((6000, 1), generator=gen.manual_seed(12)) < 0.02
    scales = torch.where(big, splats.scales * 20.0, splats.scales)
    colors = splats.colors.clone()
    colors[:, 3] = torch.clamp(colors[:, 3] * 2.0, 0.0, 0.98)
    splats = dataclasses.replace(splats, scales=scales, colors=colors)
    return dataclasses.replace(splats, **{
        f: getattr(splats, f).to(device) for f in FIELDS})


def _camera(aspect):
    import gaussiansplats3d_tpu_torch as gt
    return gt.Camera.look_at((2.2, 1.4, 2.2), (0, 0, 0), fov_y_deg=60,
                             aspect=aspect, device="cuda")


def _build_records(cfg, splats, cam):
    """Sorted records through the real pipeline, built once so both sides
    of a comparison see the same bits: (records, starts, counts)."""
    with torch.no_grad():
        if cfg.render_mode_2d:
            from ..render.surfel import bin_sort_surfels, project_surfels
            recs, starts, counts, _, _ = bin_sort_surfels(
                project_surfels(splats, cam, cfg), cfg)
            return recs, starts, counts
        from ..render.binning import bin_sort_records
        from ..render.projection import project_splats
        q = bin_sort_records(project_splats(splats, cam, cfg), cfg)
        return q.records, q.tile_starts, q.tile_counts


def _kernel_outputs(cfg, records, starts, counts, plain=False):
    """The compositor's tile blocks ``chans [T, NC + 1, P]`` (alpha last)
    and the record gradients of a scalar loss through ONLY the compositor
    (the kernel boundary): mean of chans^2 in 3D (alpha row included),
    mean of colors^2 plus mean of log T in 2D.  The kernels for CUDA
    tensors and the plain versions for CPU tensors, or the plain versions
    on any device with ``plain``."""
    from ..render import cuda_rasterize as cr
    from ..render import cuda_surfel as cs
    from ..render.surfel import chans_from_colors_logt
    ids = torch.arange(cfg.num_tiles, dtype=torch.int32,
                       device=records.device)
    args = (records, starts, counts, ids)
    if cfg.render_mode_2d:
        fwd = cs.composite_surfel_fwd_torch if plain else \
            cs.composite_surfel_fwd
        bwd = cs.composite_surfel_bwd_torch if plain else \
            cs.composite_surfel_bwd
        col, logt, exit_k = fwd(*args, cfg)
        gcol = 2.0 * col / col.numel()
        glogt = torch.full_like(logt, 1.0 / logt.numel())
        return (chans_from_colors_logt(col, logt),
                bwd(*args, logt, exit_k, gcol, glogt, cfg))
    fwd = cr.composite_fwd_torch if plain else cr.composite_fwd
    bwd = cr.composite_bwd_torch if plain else cr.composite_bwd
    chans, logt, exit_k = fwd(*args, cfg)
    return chans, bwd(*args, logt, exit_k, 2.0 * chans / chans.numel(), cfg)


def _np(x):
    return x.detach().cpu().double().numpy()


def run(cfg_kwargs, label):
    """One render case at 320x240 on the scene of :func:`build_scene`."""
    import gaussiansplats3d_tpu_torch as gt
    from ..render.pipeline import assemble_image
    from ..render.surfel import render_2d
    splats = build_scene("cuda")
    cam = _camera(320 / 240)
    cfg = gt.RenderConfig(width=320, height=240, sh_degree=1, **cfg_kwargs)
    oracle = render_2d if cfg.render_mode_2d else gt.reference_render

    # Records built once on the card, fed to the kernels and (copied to the
    # CPU) to their plain versions: images from the tile blocks, and the
    # kernel-boundary gradients.  Whole renders on the two devices would
    # also compare the projection, whose last bits (the quantized depth
    # that orders the pairs) may differ between the card and the host.
    records = _build_records(cfg, splats, cam)
    outs, grads = {}, {}
    for key, recs in (("gpu", records),
                      ("plain", tuple(x.cpu() for x in records))):
        chans, grads[key] = _kernel_outputs(cfg, *recs)
        outs[key] = assemble_image(chans.detach(), cfg)
    with torch.no_grad():
        # The oracle composites every pair in float32, while at the default
        # aux capacity the tiled path drops about a quarter of this scene's
        # pairs (the big splats') and mixed/packed records round them: the
        # cross-check renders float32 records at a capacity that holds every
        # pair and must report no overflow.
        outs["gpu_all"] = gt.render(splats, cam, cfg.replace(
            aux_multiplier=ORACLE_AUX, record_precision="f32"),
            return_aux=True)
        outs["oracle"] = oracle(splats, cam, cfg)

    # End-to-end gradients on the card: finiteness only (the projection
    # chain's numerics on the 20x-scaled splats are the CPU tests' matter).
    s = gt.SplatData(*(getattr(splats, f).detach().clone()
                       .requires_grad_(True) for f in FIELDS))
    out = gt.render(s, cam, cfg)
    loss = (out["color"] ** 2).mean() + out["alpha"].mean()
    if cfg.return_depth:
        loss = loss + 1e-3 * (out["depth"] ** 2).mean()
    loss.backward()

    channels = ("color", "alpha") + (("depth",) if cfg.return_depth
                                     else ())
    failures = []
    # 1. kernel vs plain version: the same function, tight bar
    for key in channels:
        _mass_gate(failures, label, f"gpu-plain fwd {key}",
                   np.abs(_np(outs["gpu"][key]) - _np(outs["plain"][key])),
                   1e-3)
    a, b = _np(grads["gpu"]), _np(grads["plain"])
    scale = max(np.abs(b).max(), 1e-10)
    _mass_gate(failures, label, "gpu-plain bwd records",
               np.abs(a - b) / scale, 1e-3)
    for f in FIELDS:
        if not bool(torch.isfinite(getattr(s, f).grad).all()):
            failures.append(f"{label}/gpu-e2e/bwd/{f}: non-finite")
    # 2. kernel vs the untiled oracle: forward semantics cross-check
    overflow = int(outs["gpu_all"]["overflow"])
    if overflow:
        failures.append(f"{label}/gpu-oracle: {overflow} pairs dropped at "
                        f"aux_multiplier {ORACLE_AUX}")
    for key in channels:
        _mass_gate(failures, label, f"gpu-oracle fwd {key}",
                   np.abs(_np(outs["gpu_all"][key])
                          - _np(outs["oracle"][key])), 5e-3)
    return failures


def _mass_gate(failures, label, what, err, bar):
    p999 = float(np.quantile(err, 0.999))
    frac = float((err > bar).mean())
    mx = float(err.max())
    print(f"[{label}] {what:22s} max {mx:9.3e}  p99.9 {p999:9.3e}  "
          f"frac>{bar:g} {frac:.1e}")
    if not np.isfinite(err).all():
        failures.append(f"{label}/{what}: non-finite")
    elif p999 > bar or frac > 1e-3 or mx > 60 * bar:
        failures.append(f"{label}/{what}: p99.9 {p999:.3e} frac {frac:.1e} "
                        f"max {mx:.3e}")


def run_binning_backward(precision, label):
    """Card-vs-CPU parity of bin_sort_records' BACKWARD alone:
    records-level cotangents in, projected-splat gradients out (the
    straight-through codecs and the record gather's backward), bypassing
    the projection chain.  The projection is computed once on the card and
    copied, so both sides see the same bits; cotangent weights are an
    integer hash (no transcendentals), so the only legitimate divergence is
    float32 reassociation in the gather's sums."""
    import gaussiansplats3d_tpu_torch as gt
    from ..render.binning import bin_sort_records
    from ..render.projection import project_splats

    splats = build_scene("cuda")
    cam = _camera(320 / 240)
    cfg = gt.RenderConfig(width=320, height=240, sh_degree=1,
                          record_precision=precision)
    with torch.no_grad():
        proj = project_splats(splats, cam, cfg)
    diff_names = ("xs", "ys", "conic_a", "conic_b", "conic_c", "col_r",
                  "col_g", "col_b", "opacity")

    def grads(p):
        pq = dataclasses.replace(p, **{
            nm: getattr(p, nm).detach().clone().requires_grad_(True)
            for nm in diff_names})
        q = bin_sort_records(pq, cfg)
        slot = torch.arange(q.capacity, dtype=torch.int64,
                            device=q.records.device)
        acc = 0.0
        for i in range(len(diff_names)):
            h = (slot * 2654435761 + i * 97) & 0xFFFFFFFF
            w = ((h >> 16) & 0x3FF).to(torch.float32) / 512.0 - 1.0
            acc = acc + (q.records[i] * w).sum()
        return torch.autograd.grad(acc, [getattr(pq, nm)
                                         for nm in diff_names])

    proj_c = dataclasses.replace(proj, **{
        f.name: getattr(proj, f.name).cpu()
        for f in dataclasses.fields(proj)})
    g_gpu, g_cpu = grads(proj), grads(proj_c)
    failures = []
    for name, a, b in zip(diff_names, g_gpu, g_cpu):
        a, b = _np(a), _np(b)
        scale = max(np.abs(b).max(), 1e-10)
        _mass_gate(failures, label, f"gpu-cpu binbwd {name}",
                   np.abs(a - b) / scale, 1e-3)
    return failures


def run_at_scale(label="at-scale"):
    """Kernel-boundary forward and backward parity at 1M splats, 512x384:
    the early-exit bookkeeping and the chunk windows at real chunk counts
    (the 6k-splat cases reach a few hundred chunks).  The plain versions
    run on the card here."""
    import gaussiansplats3d_tpu_torch as gt
    gen = torch.Generator(device="cuda").manual_seed(21)
    splats = gt.random_splats(gen, 1_000_000, sh_degree=0, device="cuda")
    colors = splats.colors.clone()
    colors[:, 3] = torch.clamp(colors[:, 3] * 1.5, 0.0, 0.95)
    splats = dataclasses.replace(splats, scales=splats.scales * 2.0,
                                 colors=colors)
    cam = _camera(512 / 384)
    cfg = gt.RenderConfig(width=512, height=384, sh_degree=0)
    records = _build_records(cfg, splats, cam)
    print(f"[{label}] pairs={int(records[2].long().sum())}")
    out_k, g_k = _kernel_outputs(cfg, *records)
    out_p, g_p = _kernel_outputs(cfg, *records, plain=True)

    failures = []
    _mass_gate(failures, label, "gpu-plain fwd chans",
               np.abs(_np(out_k) - _np(out_p)), 1e-3)
    a, b = _np(g_k), _np(g_p)
    scale = max(np.abs(b).max(), 1e-10)
    _mass_gate(failures, label, "gpu-plain bwd records",
               np.abs(a - b) / scale, 1e-3)
    return failures


def main():
    if not torch.cuda.is_available():
        print("ERROR: no CUDA device — this gate must run on the card (the "
              "CPU tests cover the plain versions).")
        return 2
    failures = run({}, "rgb")
    failures += run({"return_depth": True}, "rgb+depth")
    # packed record precision: the u16/f16/u8 record codecs through the
    # kernels
    failures += run({"record_precision": "packed"}, "rgb+packed")
    # 2DGS surfel kernels (B3/B4): ray-plane fragment + hand-derived
    # transpose, with and without the 4-wide depth-channel layout.
    failures += run({"render_mode_2d": True}, "2d")
    failures += run({"render_mode_2d": True, "return_depth": True},
                    "2d+depth")
    # binning backward alone, card vs CPU, for each codec mode
    failures += run_binning_backward("mixed", "binbwd-mixed")
    failures += run_binning_backward("f32", "binbwd-f32")
    # kernel-boundary case at real chunk counts
    failures += run_at_scale()
    if failures:
        print("PARITY FAILURES:\n  " + "\n  ".join(failures))
        return 1
    print("GPU kernel parity: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
