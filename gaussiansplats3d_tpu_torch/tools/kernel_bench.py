"""Ablation bench for the tile compositor: kernel B5, its plain PyTorch
version, and the command that times it (counterpart of the JAX package's
``tools/kernel_bench.py``).

Builds the bench workload (random scene -> projection -> binning) and
times kernel VARIANTS that each remove one piece of the forward compositor
— the early exit, the transmittance scan, the colour blend, the fragment
math — to isolate what the kernel is bound by; then the real forward (B1)
and backward (B2) alone on the same records.  Several variants compute
wrong colours on purpose; only their timings matter.

    python -m gaussiansplats3d_tpu_torch.tools.kernel_bench [N] [--tile 32]
        [--sh 1] [--cpu]

**B5 replaces** ``gaussiansplats3d_tpu/tools/kernel_bench.py::
build_variant`` (the Pallas kernel ``kernel`` launched by ``run``).  The
kernel source is ``csrc/kernel_bench.cu``, the variant a template
parameter, on B1's layout (``csrc/composite_fwd.cu``), so that the
variants split today's B1: one block a tile of ``warp_cull::warps(ts) *
32`` threads (512 at tile 32), each holding 2 pixels of its warp's 8 x 8
patch, at sides 33-64 a thread-block cluster of 4 blocks of 512, one a
32 x 32 quadrant, that take B1's exit vote over the cluster, and at sides
of 65 or more one block of 512 that walks the tile's 32 x 32 sub-tiles as
B1 does, each variant with its own vote points (so any side the JAX tool
takes launches); each
128-pair chunk staged in shared memory, culled per warp
against its patch (``warp_cull.cuh``), the kept pairs walked in order
through B1's fragment (``gauss_fragment.cuh``), and a vote after each
chunk.  ``full`` is B1 less its log-T sum and its alpha channel: an
exclusive PRODUCT prefix of 1 - alpha for the weights, T = max(T * prod,
exp(-80)) at the end of each chunk, no per-chunk floor; its outputs are
colours, T itself and exit_k.  The JAX tool's ``mxu_scan_2`` and
``mxu_scan_3`` computed the prefix in log space on the TPU's matrix unit
through bf16 limbs (the digit is the number of limb passes, a TPU
precision knob); they are one variant here, ``log_scan``, the same
log-space prefix in float32 with no limbs.  It is worth having beside
``full`` because B1 accumulates T in log space: the two side by side show
what that choice costs on the card.

**What bounds it on the H100**: as B1, arithmetic: the box tests and the
exp of the visits in the box, and at each chunk's vote the wait for the
warp with the most kept pairs.  The kernel takes B1's design against that
(the per-warp cull, a pair's fields read once for two pixels, the running
product, the tile's exit), so the variants split today's B1.  A variant
that never exits (``no_exit``, ``no_scan``, ``dma_only``) stages every
chunk of the window where ``full`` stops at its exit, so its time is held
against ``full``'s at the mean exit_k each prints.

**Plain version** (:func:`composite_variant_torch`): the same functions in
PyTorch, tiles in lockstep groups over the same chunk windows and exits, on
the in-box pair-pixel entries of each chunk (render/cuda_rasterize.py's
helpers), the prefix as a float64 run sum of log(1 - alpha) per pixel (the
product and the log-space prefix are the same function).  The wrapper uses
it for CPU tensors only; for CUDA tensors it launches B5 or raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

import torch

from ..core.types import RenderConfig
from ..render import cuda_rasterize as cr
from ..render import launch
from ..render.launch import F32, I64, INT, PTR
from ..utils import metrics

VARIANTS = ("full", "log_scan", "exit_every4", "no_exit", "no_scan",
            "no_matmul", "dma_only", "grid_only")
"""The variants, in the order of the kernel's ``Variant`` enum."""
NC = 3
# T floor of the forward the bench clones (pallas_rasterize._T_FLOOR)
_T_FLOOR = math.exp(-80.0)

LAUNCHES = "b5.launches"
"""The counter (``utils.metrics``) of the launches of the CUDA kernel B5
made by :func:`variant_cuda` (the plain version does not count)."""


def reset_launches() -> None:
    metrics.reset(LAUNCHES)


_B5 = launch.Kernel("kernel_bench", "kernel_bench_variant",
                    (INT, PTR, I64) + (PTR,) * 3 + (INT,) * 3 + (F32,) * 3
                    + (PTR,) * 4, LAUNCHES)


def _check(records, starts, counts, ids, cfg: RenderConfig, variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (one of {VARIANTS})")
    cr.check_inputs(records, starts, counts, ids, cfg)
    if records.shape[0] != NC + 8:
        raise ValueError(f"B5 takes NC = {NC} records [{NC + 8}, S], got "
                         f"{tuple(records.shape)}")


def variant_cuda(records, tile_starts, tile_counts, tile_ids,
                 cfg: RenderConfig, variant: str):
    """Launch B5's ``variant`` on the current stream; inputs as B1's
    (``cuda_rasterize.composite_fwd``) with NC = 3, all on one CUDA device.
    Returns ``(colors [T, P, 3], t [T, P, 1], exit_k [T] int32)``."""
    _check(records, tile_starts, tile_counts, tile_ids, cfg, variant)
    launch.check_cuda_launch(records, "variant_cuda")
    t = tile_starts.shape[0]
    p = cfg.tile_size * cfg.tile_size
    dev = records.device
    colors = torch.empty((t, p, NC), dtype=torch.float32, device=dev)
    trans = torch.empty((t, p, 1), dtype=torch.float32, device=dev)
    exit_k = torch.empty((t,), dtype=torch.int32, device=dev)
    _B5(dev, VARIANTS.index(variant), records.data_ptr(), records.shape[1],
        tile_starts.data_ptr(), tile_counts.data_ptr(), tile_ids.data_ptr(),
        t, cfg.tile_size, cfg.tiles_x, cfg.min_alpha, _T_FLOOR, cr.EXIT_T,
        colors.data_ptr(), trans.data_ptr(), exit_k.data_ptr(),
        what=f" ({variant})")
    return colors, trans, exit_k


def composite_variant_torch(records, tile_starts, tile_counts, tile_ids,
                            cfg: RenderConfig, variant: str):
    """The plain PyTorch version of B5's ``variant``, on any device: the
    same chunk windows, exits and outputs.  Tiles go
    ``cuda_rasterize.GROUP_SIZE`` at a time, each group's chunk loop in
    lockstep, over the chunk's in-box pair-pixel entries."""
    _check(records, tile_starts, tile_counts, tile_ids, cfg, variant)
    s = records.shape[1]
    t = tile_starts.shape[0]
    p = cfg.tile_size * cfg.tile_size
    dev = records.device
    chunk = cr.CHUNK
    colors = torch.zeros((t, p, NC), dtype=torch.float32, device=dev)
    trans_out = torch.zeros((t, p, 1), dtype=torch.float32, device=dev)
    starts_all = tile_starts.long()
    counts_all = tile_counts.long()
    chunks_all = torch.div(starts_all % chunk + counts_all + chunk - 1,
                           chunk, rounding_mode="floor")
    if variant == "grid_only":
        return colors, trans_out, chunks_all.to(torch.int32)
    exit_k = torch.zeros((t,), dtype=torch.int32, device=dev)
    lane = torch.arange(chunk, device=dev)
    for g0 in range(0, t, cr.GROUP_SIZE):
        g1 = min(g0 + cr.GROUP_SIZE, t)
        n_g = g1 - g0
        start, count = starts_all[g0:g1], counts_all[g0:g1]
        num_chunks = chunks_all[g0:g1]
        x0, y0 = cr.tile_origins(tile_ids[g0:g1].long(), cfg)
        start_chunk = torch.div(start, chunk, rounding_mode="floor")
        trans = torch.ones((n_g * p,), dtype=torch.float32, device=dev)
        col = torch.zeros((NC, n_g * p), dtype=torch.float32, device=dev)
        k_done = torch.zeros_like(start)
        active = num_chunks > 0
        k = 0
        while bool(active.any()):
            gpos = (start_chunk + k)[:, None] * chunk + lane[None, :]
            rec = records[:, torch.clamp(gpos, max=s - 1)]       # [NF, G, C]
            if variant == "dma_only":
                # lane 0's x, whether or not it is in the window
                x_lane0 = torch.where(active, rec[0, :, 0],
                                      torch.zeros_like(rec[0, :, 0]))
                col = col + x_lane0.repeat_interleave(p)[None, :]
            else:
                window = (gpos >= start[:, None]) & (
                    gpos < (start + count)[:, None]) & active[:, None]
                # only the tiles with a pair in this chunk (order kept, so
                # the entries stay grouped by pixel)
                sel = window.any(dim=1).nonzero(as_tuple=True)[0]
                ent = cr.chunk_pairs(rec[:, sel], window[sel], x0[sel],
                                     y0[sel], NC, cfg)
                seg = sel[ent["tile"]] * p + (ent["seg"] - ent["tile"] * p)
                alpha = ent["alpha"]
                if variant == "no_scan":
                    w = alpha * trans[seg]
                else:
                    excl, _, seg_u, total = cr.seg_scan(
                        torch.log1p(-alpha), seg)
                    w = alpha * (torch.exp(excl) * trans[seg])
                    csum = torch.zeros_like(trans)
                    csum[seg_u] = total
                    trans = torch.clamp(trans * torch.exp(csum),
                                        min=_T_FLOOR)
                if variant == "no_matmul":
                    # the weights of the chunk's lanes 0..2, no colour
                    m = ent["lane"] < NC
                    col.index_put_((ent["lane"][m], seg[m]), w[m],
                                   accumulate=True)
                else:
                    col.index_add_(1, seg, ent["rec"][5:5 + NC] * w)
            k += 1
            k_done = torch.where(active, torch.full_like(k_done, k), k_done)
            active = active & (k < num_chunks)
            if variant != "no_exit":
                alive = trans.view(n_g, p).amax(dim=1) > cr.EXIT_T
                if variant == "exit_every4" and k % 4:
                    alive = torch.ones_like(alive)
                active = active & alive
        colors[g0:g1] = col.view(NC, n_g, p).permute(1, 2, 0)
        trans_out[g0:g1] = trans.view(n_g, p, 1)
        exit_k[g0:g1] = k_done.to(torch.int32)
    return colors, trans_out, exit_k


def build_variant(cfg: RenderConfig, variant: str):
    """A compositor-forward clone with one piece ablated: a callable
    ``(records [11, S], tile_starts, tile_counts, tile_ids) -> (colors
    [T, P, 3], t [T, P, 1], exit_k [T] int32)`` that launches B5 for CUDA
    tensors and runs the plain version for CPU tensors.  Records carry NC =
    3 channels; ``variant`` is one of :data:`VARIANTS`."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (one of {VARIANTS})")

    def run(records, tile_starts, tile_counts, tile_ids):
        return launch.dispatch(records, variant_cuda,
                               composite_variant_torch)(
            records, tile_starts, tile_counts, tile_ids, cfg, variant)

    return run


def timeit(fn, device: torch.device, iters: int = 5) -> float:
    """Mean milliseconds of ``fn()`` after one warm-up call: CUDA events on
    a CUDA device, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize(device)
        return t0.elapsed_time(t1) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def bench_scene(n: int, sh_degree: int, cfg: RenderConfig, device,
                scale: float = 0.15):
    """bench.py's scene: random splats (seed 0) in [-2, 2]^3, scales x
    ``scale``, the camera at (4.5, 2.5, 4.5) on the origin."""
    import gaussiansplats3d_tpu_torch as gt
    gen = torch.Generator(device=device).manual_seed(0)
    splats = gt.random_splats(gen, n, sh_degree=sh_degree, extent=2.0,
                              device=device)
    splats = dataclasses.replace(splats, scales=splats.scales * scale)
    cam = gt.Camera.look_at((4.5, 2.5, 4.5), (0.0, 0.0, 0.0),
                            fov_y_deg=60.0, aspect=cfg.width / cfg.height,
                            device=device)
    return splats, cam


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=float, default=2_000_000)
    ap.add_argument("--tile", type=int, default=32)
    ap.add_argument("--sh", type=int, default=1)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch versions)")
    args = ap.parse_args(argv)
    n = int(args.n)
    device = torch.device("cpu" if args.cpu else "cuda")

    from ..render.binning import bin_sort_records
    from ..render.projection import project_splats

    cfg = RenderConfig(width=1920, height=1080, sh_degree=args.sh,
                       tile_size=args.tile)
    splats, cam = bench_scene(n, args.sh, cfg, device)
    with torch.no_grad():
        pairs = bin_sort_records(project_splats(splats, cam, cfg), cfg)
    records, starts, counts = (pairs.records, pairs.tile_starts,
                               pairs.tile_counts)
    ids = torch.arange(cfg.num_tiles, dtype=torch.int32, device=device)
    print(f"N={n} tile={args.tile} pairs={int(pairs.total_pairs)} "
          f"S={pairs.capacity} tiles={cfg.num_tiles} device={device}",
          flush=True)

    for variant in VARIANTS:
        fn = build_variant(cfg, variant)
        ms = timeit(lambda: fn(records, starts, counts, ids), device)
        out = fn(records, starts, counts, ids)
        mean_exit = float(out[2].double().mean())
        print(f"  {variant:12s} {ms:9.3f} ms   (mean exit_k {mean_exit:.2f})",
              flush=True)

    # the real kernels alone: B1, then B2 on B1's residuals with gchans 0.1
    chans, logt, exit_k = cr.composite_fwd(records, starts, counts, ids, cfg)
    gchans = torch.full_like(chans, 0.1)
    ms = timeit(lambda: cr.composite_fwd(records, starts, counts, ids, cfg),
                device)
    print(f"  REAL fwd (B1) {ms:9.3f} ms", flush=True)
    ms = timeit(lambda: cr.composite_bwd(records, starts, counts, ids, logt,
                                         exit_k, gchans, cfg), device)
    print(f"  REAL bwd (B2) {ms:9.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
