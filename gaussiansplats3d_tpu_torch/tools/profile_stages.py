"""Per-stage profile of the tiled 3D render pipeline (counterpart of the
JAX package's ``tools/profile_stages.py``).

Times each pipeline stage in isolation (its inputs computed beforehand on
the device) plus the whole forward and forward+backward, so the gap
between the stage sum and the end-to-end number is visible.  The
equivalent of the reference's per-sort timing instrumentation
(src/worker/SortWorker.js:33,76-78 and the info panel,
Viewer.js:1804-1822), extended to the backward pass the reference does
not have.  On a CUDA device every time is taken with CUDA events after a
warm-up call (mean of 5); with ``--cpu`` with the host clock.

The JAX tool's "bwd alignment sort" times the alignment of the binning
backward; the port's counterpart is the record gather's backward
(``render/binning.py::gather_bwd``, ``csrc/gather_bwd.cu`` on a CUDA
device), and the line in its place times it alone: a cotangent of ones
on every record row and slot, un-sorted by the binning's own permutation
and reduced by its slot layout into N splats.

Usage:
    python -m gaussiansplats3d_tpu_torch.tools.profile_stages [N] [options]
    --sh D           SH degree (default 1)
    --precision P    record_precision (default mixed)
    --fwd-only       skip the backward stages
    --scale S        splat scale multiplier (default 0.15, bench-like)
    --width/--height/--lanes/--aux/--tile   RenderConfig fields
    --cpu            run on the CPU (plain PyTorch kernels)
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from .kernel_bench import bench_scene, timeit

# the differentiable record rows and the projected fields they come from
_DIFF = ("xs", "ys", "conic_a", "conic_b", "conic_c", "col_r", "col_g",
         "col_b", "opacity")


def gather_residuals(proj, cfg):
    """The sort's permutation and the slot layout that
    ``bin_sort_records(proj, cfg)`` hands the record gather
    (``binning._Gather``), from one call."""
    from ..render import binning
    got = []
    apply = binning._Gather.apply

    def capture(fields, src, perm, layout):
        got.append((perm, layout))
        return apply(fields, src, perm, layout)

    binning._Gather.apply = capture
    try:
        with torch.no_grad():
            binning.bin_sort_records(proj, cfg)
    finally:
        del binning._Gather.apply
    return got[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=float, default=2_000_000)
    ap.add_argument("--sh", type=int, default=1)
    ap.add_argument("--precision", default="mixed")
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--scale", type=float, default=0.15)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--aux", type=float, default=0.25)
    ap.add_argument("--tile", type=int, default=32)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch kernels)")
    args = ap.parse_args(argv)
    n = int(args.n)
    device = torch.device("cpu" if args.cpu else "cuda")

    import gaussiansplats3d_tpu_torch as gt
    from ..render import binning
    from ..render.binning import bin_sort_records
    from ..render.pipeline import assemble_image, composite_sorted, render
    from ..render.projection import project_splats

    cfg = gt.RenderConfig(width=args.width, height=args.height,
                          sh_degree=args.sh, sort_bits=16,
                          record_precision=args.precision,
                          lanes=args.lanes, aux_multiplier=args.aux,
                          tile_size=args.tile)
    splats, cam = bench_scene(n, args.sh, cfg, device, scale=args.scale)

    def ms(fn):
        return timeit(fn, device)

    print(f"N={n} SH{args.sh} {args.width}x{args.height} "
          f"precision={args.precision} lanes={cfg.lanes} "
          f"aux={cfg.aux_multiplier} tile={cfg.tile_size} device={device}",
          flush=True)

    # --- forward stages ---------------------------------------------------
    with torch.no_grad():
        proj = project_splats(splats, cam, cfg)
        t_proj = ms(lambda: project_splats(splats, cam, cfg))
        print(f"  project fwd          {t_proj:8.3f} ms", flush=True)

        pairs = bin_sort_records(proj, cfg)
        t_sort = ms(lambda: bin_sort_records(proj, cfg))
        s_cap = pairs.capacity
        print(f"  bin_sort_records fwd {t_sort:8.3f} ms   (S={s_cap}, "
              f"pairs={int(pairs.total_pairs)}, "
              f"overflow={int(pairs.overflow)})", flush=True)

        chans = composite_sorted(cfg, pairs)
        t_comp = ms(lambda: composite_sorted(cfg, pairs))
        print(f"  composite fwd        {t_comp:8.3f} ms", flush=True)

        t_asm = ms(lambda: assemble_image(chans, cfg))
        print(f"  assemble             {t_asm:8.3f} ms", flush=True)

        t_fwd = ms(lambda: render(splats, cam, cfg)["color"])
    stage_sum = t_proj + t_sort + t_comp + t_asm
    print(f"  FWD total            {t_fwd:8.3f} ms   (stage sum "
          f"{stage_sum:.3f}, gap {t_fwd - stage_sum:+.3f})", flush=True)
    if args.fwd_only:
        return 0

    # --- backward stages --------------------------------------------------
    # compositor bwd alone (the gradient with respect to the records)
    rec_leaf = pairs.records.detach().requires_grad_(True)
    pairs_leaf = dataclasses.replace(pairs, records=rec_leaf)

    def comp_grad():
        ch = composite_sorted(cfg, pairs_leaf)
        return torch.autograd.grad((ch * ch).sum(), rec_leaf)

    t_comp_bwd = ms(comp_grad) - t_comp
    print(f"  composite bwd        {t_comp_bwd:8.3f} ms   (grad - fwd)",
          flush=True)

    # the record gather's backward alone, on this binning's permutation
    # and slot layout
    perm, layout = gather_residuals(proj, cfg)
    g_rec = torch.ones((pairs.records.shape[0], s_cap), device=device)
    t_gather = ms(lambda: binning.gather_bwd(g_rec, perm, layout))
    print(f"  bwd gather_bwd       {t_gather:8.3f} ms   "
          f"({g_rec.shape[0]} f32 rows @ S={s_cap} into N={n})", flush=True)

    # binning bwd total (straight-through codecs + the gather's
    # backward), from the records to the projected fields
    pq = dataclasses.replace(proj, **{
        f: getattr(proj, f).detach().requires_grad_(True) for f in _DIFF})
    leaves = [getattr(pq, f) for f in _DIFF]

    def sort_grad():
        q = bin_sort_records(pq, cfg)
        return torch.autograd.grad(q.records[:len(_DIFF)].sum(), leaves)

    t_sort_bwd = ms(sort_grad) - t_sort
    print(f"  bin_sort bwd         {t_sort_bwd:8.3f} ms   (grad - fwd)",
          flush=True)

    # projection bwd
    fields = [s.detach().requires_grad_(True) for s in
              (splats.means, splats.scales, splats.quats, splats.colors,
               splats.sh)]
    s_leaf = gt.SplatData(*fields)

    def proj_grad():
        p = project_splats(s_leaf, cam, cfg)
        loss = (p.mean2d.sum() + p.conic.sum() + p.color.sum()
                + p.opacity.sum())
        return torch.autograd.grad(loss, fields, allow_unused=True)

    t_proj_bwd = ms(proj_grad) - t_proj
    print(f"  project bwd          {t_proj_bwd:8.3f} ms   (grad - fwd)",
          flush=True)

    def full_grad():
        img = render(s_leaf, cam, cfg)["color"]
        return torch.autograd.grad((img * img).mean(), fields)

    t_grad = ms(full_grad)
    bwd_sum = t_fwd + t_comp_bwd + t_sort_bwd + t_proj_bwd
    print(f"  FWD+BWD total        {t_grad:8.3f} ms   (stage sum "
          f"{bwd_sum:.3f}, gap {t_grad - bwd_sum:+.3f})", flush=True)
    print(f"  => {n / t_grad / 1e3:.3f} Msplats/s fwd+bwd", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
