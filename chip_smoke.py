#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gaussiansplats3d_tpu_torch) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises on failure (nonzero exit, no result line):

1. the card and the toolchain: nvidia-smi's name and power limit,
   torch.version.cuda, nvcc --version; every CUDA kernel of the port is
   built from csrc/ with nvcc for sm_90a (one nvcc per source, started
   together), and ptxas' registers / shared memory / spills are printed;
   beside them the native scene decoders (csrc/ingest.cpp) with g++,
   whose failure fails the phase, and the library must load;
2. every kernel against its plain PyTorch version, on the card, at the
   shapes the main paths give it (the port's own binning of the main-path
   scene, in each configuration of phases 3 and 5), by error mass; then
   each one's time (CUDA events), its plain version's time and its bound,
   from the work this run's data needs, and for each of B1-B4 how many of
   the pair-warp visits its per-warp cull keeps (the plain mirror,
   cuda_rasterize.kept_pair_warps).  B2's cotangent is that of
   mean(color^2) at B1's chans.  Then the record gather's backward
   (csrc/gather_bwd.cu) at the benchmark's sizes, the garden (5M splats,
   SH 2, aux 1.5) and the truck in 2D (1M surfels), with the cotangent
   of bench.py's step and a random one: against its plain version and
   index_add_, bit equal across two calls, its ms beside index_add_'s
   and its bound;
3. the serving path: render() of 2M random splats (seeded, the JAX
   package's bench.py scene), SH degree 1, 1920x1080, tile 32, sort_bits
   16, under torch.no_grad(), with the default record precision ('mixed')
   and with the serving mode ('packed', forward_only, aux_multiplier 0.3 as
   bench.py serves it), RENDERS times each; the launch counters are zeroed
   just before and read just after: B1 once a render, B2 and the record
   gather's backward never;
4. a stage breakdown of one render (CUDA events) and a torch.profiler
   view of it: device time, the device's idle share, the top kernels;
5. the training path, bench.py's step (_grad_step_msplats): the gradient
   of mean(color^2) with respect to all five SplatData fields at the same
   scene, in 'mixed' and in train-packed ('packed', gradients on), a
   warm-up and STEPS timed steps each; counters zeroed just before and read
   just after: B1 and B2 once a step, the record gather's backward's two
   kernels once (as in phase 6's Adam steps, phase 8's 2D steps and phase
   11's sharded steps; the {"gather_bwd": ...} line has each path's
   reading); every gradient finite and nonzero;
   median step time, Msplats/s as bench.py computes it, peak memory; a
   stage breakdown of the forward and the backward and a torch.profiler
   view of one step;
6. a few Adam steps through make_train_step at that size; the fit gate of
   tests/test_training.py on the card (300 splats, 64x64, 3 views, 150
   Adam steps at 2e-3, >= 25 dB); a short train_scene run with a densify;
7. correctness at a small size: the CUDA render against the port's
   untiled oracle on the card and against the CPU render (plain
   versions), images and the gradients of the five fields;
8. the 2DGS surfel mode (render_mode_2d) at the same scene and size,
   'mixed': B3 and B4 against their plain versions on the run's own surfel
   records, and again with the depth channel (NC = 4) at N_DEPTH_2D
   splats, each with its time, its plain version's time and its bound
   from the visits that pass each cut; 2D serving (render() under no_grad,
   RENDERS times: B3 once a render, B1, B2 and B4 never) with a stage
   breakdown and a profiler view; 2D training (bench.py's step in 2D,
   STEPS steps: B3 and B4 once a step, B1 and B2 never; every gradient
   finite and nonzero but scales[:, 2], which surfels never read and which
   must be exactly 0) with a profiler view; a few Adam steps of
   make_train_step in 2D at 2M and a small 2D fit whose loss must fall;
   the 2D render at a small size against the port's render_2d oracle on
   the card and against the CPU, images and gradients;
9. the tools: B5 (tools/kernel_bench.py, the compositor ablation bench)
   launched 0 times by phases 3-8; every B5 variant against its plain
   version on the render-mixed records, with its time, its plain
   version's time, mean exit_k and share of `full`, the `full` variant's
   bound and the pair-warp visits its cull keeps, and B1's time on the
   same records beside `full`'s; then
   each tool's entry point with the counters zeroed just before and read
   just after: kernel_bench.main() at its default size (2M, SH1, 1080p:
   the ablation, then B1 and B2 alone), profile_stages.main() (same
   scene), gpu_parity.main() (must return 0) and bench_configs' accept1-3
   at full size (the reference-bytes runs at N_REF_BYTES splats);
10. the viewer slice at BASELINE.json config 5's shape (multi-scene dynamic
   composition, 4K stereo) on one card: a Viewer at 3840x2160, SH1, over
   three scenes, 3.5M splats (S0 the 2M scene above, in memory; S1 1M
   seeded splats written by save_ksplat, level 1, and added by path with a
   position, rotation and scale; S2 500k seeded splats written as a binary
   INRIA .ply and streamed in by add_splat_scene_progressive, with partial
   frames); every frame against a direct render() (render_2d_tiled in 2D)
   of the viewer's own concatenated splats with the same transforms, scene
   indices, opacities, visibility and fade, by error mass; the counters
   zeroed just before each viewer step and read just after: B1 once a 3D
   frame, twice a stereo pair, B3 once a 2D frame, nothing on an OnChange
   repeat or a sub-epsilon move or under RenderMode.Never; the reveal fade
   run to its end on the frame host arithmetic predicts; dynamic changes
   of S1's position, S2's opacity and S0's visibility; picking through
   the image centre (sphere and ellipsoid) against the port's raycaster
   on CPU copies; render_scene (B1 once a frame) and create_ksplat (bytes
   equal to save_ksplat's); B1 and B3 against their plain versions, with
   their times and bounds, on the records of a 4K viewer frame (3D and
   2D) and of render_scene's 1280x720 frame; the viewer's overhead over
   render(), the stereo pair, load-to-first-frame, the progressive load's
   snapshots and times, picking and peak memory.  The decode counters
   (io/native.py) are zeroed around S1's add_splat_scene and S2's
   progressive load: every decode there must run native; S2's stream then
   runs through a ProgressiveLoader alone twice, with the native decoders
   and with GS_NATIVE=0, each split into the buffer copies for the
   header, the header parses, the decodes and the rest.  The kernels
   line's launches of each viewer path are the sums of the counters'
   readings;
11. the multi-GPU slice on one card (the host has one H100, and NCCL
   takes one rank a GPU, so the world has one rank): (a) the NCCL process
   group at world size 1 (parallel.initialize_distributed) and a 1x1
   make_mesh; sharded_render of the 2M scene under both routes and both
   slab modes against render() by error mass (B1 once a render), and the
   sharded training step in 3D 'mixed' (B1 and B2 once a step) and in 2D
   (B3 and B4), its first loss against the single-device step's on the
   same parameters; (b) a (1, 4) decomposition of the same scene at tile
   16 (1080 px is 68 rows of 16) on one card, slab by slab through
   sharded.slab_rows and sharded.render_slab, banded and interleaved, in
   3D and 2D: the stitched slabs against render_tiles' chans, the forward
   kernel counted once a slab, B1 then B2 (B3 then B4) against their plain
   versions on every slab's records, each slab's kernel ms beside the
   unsharded kernel's and the slabs' pairs; (c) BASELINE.json config 4 on
   one card: 16M splats (bench.py's scene, torch.Generator seed 0), SH0,
   1920x1080, train-packed through make_train_step on the 1x1 mesh, a
   warm-up and 3 timed steps (B1 and B2 once a step): finite loss and
   gradients, overflow, median step ms, Msplats/s and peak memory, then
   B1 and B2 against their plain versions on the records its step bins
   (sharded.slab_rows and render_slab at 1x1); (d) a save_checkpoint /
   load_checkpoint round trip of the 2M state; (e) scaling_bench.main,
   whose 1x1 shape runs in the one-rank world (the others are skipped,
   and it says so), then B1 and B2 against their plain versions on its
   1x1 step's records.  Each path's launches are the
   counters' readings around its steps;
12. the native scene decoders at full size: S1's 1M .ksplat at levels 0,
   1 and 2, S2's 500k .ply, accept2's 1M .splat and accept3's 5M SH2
   .ksplat (tools/bench_configs.py's scenes), each written from its seeded
   scene and decoded natively and with GS_NATIVE=0 (the decode counters
   checked each time): both host times, and per field the error mass of
   native against numpy (max and p99.9 of |d|, the share over 1e-6);
   raises on any |d| over 1e-6 and on any difference in colors or
   opacities;
13. the main path at tile 64 (the same scene, 1920x1080 in 510 tiles):
   B1-B5 hold a tile of side 33-64 as a thread-block cluster of four 32 x
   32 blocks.  B1, B2 and B5's `full` on the render-mixed records, B3 and
   B4 on the 2d-mixed ones, each kernel on every tile against its plain
   version on every T64_PLAIN_EVERY-th tile by the bars of phase 2 (B2 and
   B4 compared on those tiles' window slots), with its time, the plain
   version's, its bound from this run's work on every tile and the card's
   cudaOccupancyMaxActiveClusters; then phases 3, 5 and 8's render and
   step at tile 64 (main_path, train_path, main_path_2d, train_path_2d:
   both configurations of each, their counters and checks; B5 launched 0
   times), each median beside the tile-32 one of this run, and the
   torch.profiler views of phases 4 and 5 at tile 64.  The kernels
   line's entries gain per_tile["64"]: the kernel's tile-64 ms, its
   tile-32 ms, plain ms and tiles, bound, largest difference, clusters and
   the tile-64 paths' launches;
14. the same at tile 128 (1920x1080 in 135 tiles): one block a tile walks
   its 4 x 4 sub-tiles of 32 x 32.  Beside phase 13's checks, for B1 and
   B3 on the compared tiles the walk's bookkeeping from the plain versions
   (cuda_rasterize.walk_exits): how many sub-tiles ran a second pass, the
   mean of the sub-tiles' own exits beside the mean tile exit, and the
   tile's exit_k the largest of its sub-tiles' own.  The kernels line's
   entries gain per_tile["128"], with the kernel's tile-32 and tile-64 ms
   of this run (no clusters: None).

Prints a {"native": ...} line (the build, phase 10's loads, phase 12), a
{"kernels": [...]} line, a {"gather_bwd": ...} line, and last {"ok": true,
"device": ...}.
It has no CPU mode: without a CUDA device it exits 1.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

N_SPLATS = 2_000_000
WIDTH, HEIGHT = 1920, 1080
SH_DEGREE = 1
SEED = 0
RENDERS = 5
STEPS = 5
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores and
# HBM3 bandwidth, at the full 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float32 operations B1's function needs (an FMA counts two).  Per pair
# visited in a tile, not per pixel: clip the pair's rx/ry box to the tile
# (cx -+ rx, cy -+ ry and their max/min with the tile's edges); the pixels
# outside the clipped box need nothing more.
OPS_PAIR_TILE = 8
# Per pair-pixel visit, by how far it gets through the cut-offs: inside the
# box, dx, dy and g = a dx^2 + 2b dx dy + c dy^2 (7 mul, 2 add), g <= 8;
OPS_IN_BOX = 12
# inside the g cut-off: -0.5 g, exp, * opacity, alpha >= min_alpha;
OPS_IN_CUTOFF = 4
# contributing: the 0.999 clamp, w = alpha T, T -= w, then one FMA for each
# of the NC channels and the alpha row (2 each).
OPS_BLEND_BASE = 3
# B2 replays the same visits as B1 (chunks < exit_k).  Its first pass
# recomputes each chunk's log-transmittance sum: B1's tiers up to the
# cut-offs, then, per contributing visit, the clamp, log1p and the add.
OPS_B2_REPLAY = 3
# The sweep repeats the tiers; per contributing visit it then does (an FMA
# counts two): clamp, log1p, the running sum (3); T = exp(chunk_log - rest
# + logt) and w = alpha T (4); d_alpha = T cg - S / max(1 - alpha, 1e-6)
# and its two gate tests (7); S += w cg (2); d_quad (2); d_mean (10);
# d_conic (7); d_opa and its test (2); the alpha row of cg (1) = 38; then
# per channel the FMA of cg and d_chan = w g (3), and the NC + 6 adds that
# sum the terms over the tile's pixels.
OPS_B2_GRAD_BASE = 38 + 6
OPS_B2_GRAD_PER_CHANNEL = 3 + 1
# per pixel and replayed chunk: logt_before = logt_after - max(sum, floor)
OPS_B2_CHUNK = 2
# pairs a step of the work count evaluates at every pixel of their tile
WORK_PAIRS_PER_STEP = 1 << 15
# Kernel-vs-plain bars, by error mass: p99.9 of |d| and the share of
# elements over 1e-2; exit_k equal on this share of tiles.  B2: per record
# row, |d| normalised by the row's max |plain|.
BAR_P999 = {"chans": 1e-3, "logt": 1e-3, "grad": 1e-3}
BAR_OVER = 1e-3
BAR_EXIT_AGREE = 0.99
# The fit gate of tests/test_training.py::test_fit_psnr_gate
FIT_PSNR_DB = 25.0
# Splats of the 2D check with the depth channel (B3/B4's NC = 4 variant)
N_DEPTH_2D = 500_000
# float32 operations B3's function needs (an FMA counts two): per pair
# visited in a tile, the clip of its box (OPS_PAIR_TILE); per pair-pixel
# visit, by how far it gets through the surfel fragment's cuts: inside the
# box, dx, dy (2), k and l (12), p = k x l (9), |p.z| test (1), s = p.xy /
# p.z (2), rho3d (3), rho2d (4), the comparison (1), depth (4), its test (1);
SURF_OPS_IN_BOX = 39
# past the |p.z| and depth cuts: -0.5 rho, exp, * opacity, the 0.99 clamp,
# the min_alpha test;
SURF_OPS_PAST_CUTS = 5
# contributing: w = alpha exp(chunk_log) T (3), chunk_log += log1p (2), then
# one FMA for each of the NC channels (2 each).
SURF_OPS_BLEND_BASE = 5
# B4 walks B3's tiers twice (the chunk sum's recompute and the sweep).  Per
# contributing visit: the recompute's log1p and add (2); the sweep's log1p
# and running sum (2), T = exp(chunk_log - rest + logt) (3), w (1), d_alpha
# with its gate, 1 - alpha and two divisions (8), S += w cg (2), d_rho (3),
# d_su/d_sv or d_dx/d_dy (4), 1 / p.z (1), d_p (6), d_k and d_l (18), the 9
# T terms (18), the center (2), the opacity (2) = 72, and the 12 adds that
# sum the T, center and opacity terms over the tile's pixels; per channel
# the FMA of cg (2), w gcol (2) and its add (1).
OPS_B4_GRAD_BASE = 72 + 12
OPS_B4_GRAD_PER_CHANNEL = 5
# float32 operations of B5's `full` variant per contributing visit: the
# clamp, w = alpha excl T (2), excl *= 1 - alpha (2), and one FMA for each
# of the three colours (2 each); per pixel and chunk: T = max(T excl, floor)
OPS_B5_BLEND = 5 + 2 * 3
OPS_B5_CHUNK = 2
# Splats of bench_configs' reference-bytes runs here: the reference writer
# is per-splat Python (host time, ~75 us a splat), so 1M would take minutes
N_REF_BYTES = 200_000
# Phase 10, the viewer slice, at BASELINE.json config 5's shape (multi-scene
# dynamic composition, 4K stereo) on one card: S0 is the 2M scene above,
# S1 a 1M .ksplat added by path, S2 a 500k binary .ply loaded progressively.
VIEW_W, VIEW_H = 3840, 2160
N_S1 = 1_000_000
N_S2 = 500_000
# S2 renders a partial frame at its first snapshot and every this many after
PARTIAL_EVERY = 10
# The reveal fade's rate multiplier: at 0.012 x 12.5 a frame the fade
# completes (1 - (1 - 0.15)^k > 0.99) within 29 frames of a final build,
# inside the 40 frames the phase allows it.
FADE_MULTIPLIER = 12.5
MAX_FADE_FRAMES = 40
# OnChange gating: a camera move under the reference's 1e-4 epsilon reuses
# the cached frame, one over it renders.
SMALL_MOVE, LARGE_MOVE = 5e-5, 1e-3
# Phase 11, the multi-GPU slice on one card (the host has one H100): the
# routes and slab modes of parallel/sharded.py; sharded renders timed per
# combination; the (1, 4) decomposition's tile side (1080 px is 68 rows of
# 16, 17 a slab; 34 rows of 32 do not divide by 4); BASELINE.json config 4
ROUTES = ("gather", "a2a")
SLAB_MODES = ("banded", "interleaved")
SHARDED_RENDERS = 3
SLAB_SHARDS = 4
SLAB_TILE = 16
# At tile 16 about N pairs of this scene are big splats' (4 tiles or more):
# aux slots for all of them, so that neither the whole frame nor a slab
# drops pairs and the stitched slabs can equal the whole frame
SLAB_AUX_MULTIPLIER = 1.5
N_CONFIG4 = 16_000_000
# scaling_bench's command line: its 200k scene at 512x256, SH1, tile 16
SCALING_ARGV = ["200000", "--meshes", "1x1,2x1,2x2,4x2", "--iters", "3"]
CONFIG4_STEPS = 3
# Phase 12, the native scene decoders at full size: S1 at levels 0-2, S2,
# accept2's .splat and accept3's .ksplat (tools/bench_configs.py), each
# decoded natively and in numpy; native may differ from numpy by the last
# bits of exp, sqrt and divisions, never by more than this, and colors and
# opacities not at all
N_ACCEPT2, N_ACCEPT3 = 1_000_000, 5_000_000
NATIVE_ATOL = 1e-6
DECODE_REPS = 2
# Phase 13: the tile side of its main path (B1-B5 hold a tile of 33-64 as a
# cluster of four 32 x 32 blocks), and the share of its 510 tiles the plain
# versions run on (every 8th: the plain B4 takes ~7.5 s on all 2,040 tiles
# of 32); the kernels run on every tile.
TILE_64 = 64
T64_PLAIN_EVERY = 8
# Phase 14: the same at tile 128 (one block a tile walks its 4 x 4
# sub-tiles of 32 x 32), 135 tiles, the plain versions on every 8th.
TILE_128 = 128
T128_PLAIN_EVERY = 8


# what the {"native": ...} line reports: the build (phase 1), the viewer's
# loads (phase 10) and the decoders at full size (phase 12)
NATIVE = {}


def log(*a):
    print(*a, flush=True)


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def error_mass(a, b, bar=1e-2):
    """(max |d|, p99.9 |d|, share of |d| > bar) over all elements."""
    d = (a.double() - b.double()).abs().flatten()
    if not bool(torch.isfinite(d).all()):
        raise AssertionError("non-finite difference")
    srt = torch.sort(d).values
    p999 = float(srt[min(int(0.999 * d.numel()), d.numel() - 1)])
    return float(srt[-1]), p999, float((d > bar).double().mean())


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def toolchain(gt_build):
    log(sh(["nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader"]).splitlines()[0])
    nvcc = gt_build.nvcc_path()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}")
    log(f"nvcc {nvcc}: " + sh([nvcc, "--version"]).splitlines()[-1])
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton not installed")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        # the native decoders' g++ build beside the nvcc builds
        host = pool.submit(lambda: (gt_build.build_host("ingest"),
                                    time.perf_counter() - t0))
        gt_build.build_all()
        log(f"built {len(gt_build.KERNELS)} kernel(s) in "
            f"{time.perf_counter() - t0:.1f} s")
        lib, host_s = host.result()    # raises if g++ failed
    from gaussiansplats3d_tpu_torch.io import native
    if native.get_lib() is None:
        raise RuntimeError(f"native decoders: {native.status()}")
    log(f"built the native decoders {lib.name} ({gt_build.gxx_identity()}, "
        f"{' '.join(gt_build.HOST_FLAGS)}) in {host_s:.1f} s; "
        f"{native.status()}")
    NATIVE["build_s"], NATIVE["library"] = host_s, lib.name
    NATIVE["gxx"] = gt_build.gxx_identity()
    for name in gt_build.KERNELS:
        for line in gt_build.ptxas_report(name).splitlines():
            if ("registers" in line or "spill" in line
                    or "Function properties" in line):
                log(f"  ptxas {name}: {line.strip()}")


def make_scene(gt, device):
    """bench.py's scene: random splats in [-2, 2]^3 at scan-like sizes (a
    few pixels on screen), the camera at (4.5, 2.5, 4.5) looking at the
    origin."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    splats = gt.random_splats(gen, N_SPLATS, sh_degree=SH_DEGREE, extent=2.0,
                              device=device)
    splats.scales = splats.scales * 0.15
    cam = gt.Camera.look_at((4.5, 2.5, 4.5), (0.0, 0.0, 0.0), fov_y_deg=60.0,
                            aspect=WIDTH / HEIGHT, device=device)
    cfg = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=SH_DEGREE,
                          sort_bits=16)
    return splats, cam, cfg


def visited_slots(chunk, starts, counts, exit_k, cfg):
    """The (tile, slot) of every window pair in chunks < exit_k (each is
    visited at every pixel of its tile), and how many there are."""
    dev = starts.device
    start = starts.long()
    end = torch.minimum(start + counts.long(),
                        (start // chunk + exit_k.long()) * chunk)
    n_done = torch.clamp(end - start, min=0)
    total = int(n_done.sum())
    tiles = torch.arange(cfg.num_tiles, device=dev)
    tile = torch.repeat_interleave(tiles, n_done, output_size=total)
    first = torch.cumsum(n_done, 0) - n_done
    slot = start[tile] + torch.arange(total, device=dev) - first[tile]
    return tile, slot, total


def visit_counts(cr, pairs, exit_k, cfg):
    """The pairs each tile visits before its exit (the window's pairs in
    chunks < exit_k), their pair-pixel visits (at every pixel of the tile),
    how many of those pass the rx/ry box, the g <= 8 cut-off and min_alpha
    (the plain version's masks); and the pairs visited."""
    dev = pairs.records.device
    ts = cfg.tile_size
    tile, slot, total = visited_slots(cr.CHUNK, pairs.tile_starts,
                                      pairs.tile_counts, exit_k, cfg)
    pix = torch.arange(ts, device=dev, dtype=torch.float32) + 0.5
    nc = pairs.records.shape[0] - 8
    counts = {"pairs": total, "visits": total * ts * ts, "in_box": 0,
              "in_cutoff": 0, "contributing": 0}
    for i in range(0, total, WORK_PAIRS_PER_STEP):
        rec = pairs.records[:, slot[i:i + WORK_PAIRS_PER_STEP]]
        t_i = tile[i:i + WORK_PAIRS_PER_STEP]
        x0 = ((t_i % cfg.tiles_x) * ts).float()
        y0 = torch.div(t_i, cfg.tiles_x, rounding_mode="floor").float() * ts
        dx = (x0[:, None] + pix[None, :]) - rec[0][:, None]        # [B, ts]
        dy = (y0[:, None] + pix[None, :]) - rec[1][:, None]
        in_box = ((dy.abs() <= rec[7 + nc][:, None])[:, :, None]
                  & (dx.abs() <= rec[6 + nc][:, None])[:, None, :])
        dx, dy = dx[:, None, :], dy[:, :, None]                 # [B, y, x]
        g = (rec[2][:, None, None] * dx * dx
             + 2.0 * rec[3][:, None, None] * dx * dy
             + rec[4][:, None, None] * dy * dy)
        in_cut = in_box & (g <= cr.GAUSSIAN_CUTOFF)
        alpha = rec[5 + nc][:, None, None] * torch.exp(-0.5 * g)
        counts["in_box"] += int(in_box.sum())
        counts["in_cutoff"] += int(in_cut.sum())
        counts["contributing"] += int((in_cut & (alpha >= cfg.min_alpha))
                                      .sum())
    return counts, total


def tier_ops(counts):
    """float32 operations of B1's evaluation of alpha: the box's clip per
    pair visited, then the tiers each in-box visit walks up to the
    cut-offs."""
    return (counts["pairs"] * OPS_PAIR_TILE + counts["in_box"] * OPS_IN_BOX
            + counts["in_cutoff"] * OPS_IN_CUTOFF)


def b1_work(cr, pairs, exit_k, cfg):
    """What B1's function needs on these records (visit_counts), as
    float32 operations and bytes."""
    counts, total = visit_counts(cr, pairs, exit_k, cfg)
    nc = pairs.records.shape[0] - 8
    ops = (tier_ops(counts)
           + counts["contributing"] * (OPS_BLEND_BASE + 2 * (nc + 1)))
    p, t = cfg.tile_size ** 2, cfg.num_tiles
    # records of the pairs composited, read once; starts, counts and ids;
    # chans, logt and exit_k written once
    nbytes = (total * (nc + 8) * 4 + 3 * t * 4 + t * (nc + 1) * p * 4
              + t * p * 4 + t * 4)
    counts.update(cull_counts(pairs.records, (0, 1, nc + 6, nc + 7),
                              cr.CHUNK, pairs.tile_starts, pairs.tile_counts,
                              exit_k, cfg))
    return counts, ops, nbytes


def cull_counts(recs, rows, chunk, starts, counts, exit_k, cfg):
    """The pair-warp visits a compositor's per-warp cull leaves
    (cuda_rasterize.kept_pair_warps, the plain mirror of warp_cull.cuh):
    every pair composited or replayed (chunks < exit_k) against every warp
    of its tile, and how many of those the cull keeps.  ``rows``: the
    records' centre x, y and box rx, ry rows."""
    from gaussiansplats3d_tpu_torch.render import cuda_rasterize as cr
    tile, slot, total = visited_slots(chunk, starts, counts, exit_k, cfg)
    warps = cr.warp_rects(cfg).shape[0]
    kept = 0
    for i in range(0, total, WORK_PAIRS_PER_STEP):
        sl = slot[i:i + WORK_PAIRS_PER_STEP]
        x, y, rx, ry = (recs[r][sl] for r in rows)
        kept += int(cr.kept_pair_warps(x, y, rx, ry,
                                       tile[i:i + WORK_PAIRS_PER_STEP],
                                       cfg).sum())
    return {"pair_warps": total * warps, "kept_pair_warps": kept}


def b2_work(cr, pairs, exit_k, cfg):
    """What B2's function needs on these records: the same visits as B1,
    walked twice (the chunk sum's recompute and the sweep), and the
    gradient terms of the contributing visits summed over the pixels."""
    counts, total = visit_counts(cr, pairs, exit_k, cfg)
    nc = pairs.records.shape[0] - 8
    p, t = cfg.tile_size ** 2, cfg.num_tiles
    ops = (2 * tier_ops(counts)
           + counts["contributing"] * (OPS_B2_REPLAY + OPS_B2_GRAD_BASE
                                       + OPS_B2_GRAD_PER_CHANNEL * nc)
           + int(exit_k.long().sum()) * p * OPS_B2_CHUNK)
    # records of the pairs replayed, gchans and logt read once; starts,
    # counts, ids and exit_k; the [NC + 8, S] gradient written once
    nbytes = (total * (nc + 8) * 4 + t * (nc + 1) * p * 4 + t * p * 4
              + 4 * t * 4 + pairs.records.numel() * 4)
    counts.update(cull_counts(pairs.records, (0, 1, nc + 6, nc + 7),
                              cr.CHUNK, pairs.tile_starts, pairs.tile_counts,
                              exit_k, cfg))
    return counts, ops, nbytes


def bound_of(ops, nbytes):
    """(bound ms, 'operations' or 'bytes', ops ms, bytes ms) on the
    published H100 peaks."""
    ops_ms = ops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops_ms, bytes_ms)


def compare_forward(kernel, name, outputs, ref, exit_k, num_tiles):
    """A compositor forward against its plain version: the channels and
    log T by error mass, exit_k per tile.  ``outputs``: [(field, kernel's,
    plain's, p99.9 bar)]; raises past a bar.  Returns the errors."""
    err = {}
    for field, a, b, bar in outputs:
        mx, p999, over = error_mass(a, b)
        err[field] = {"max_abs": mx, "p999": p999, "over_1e-2": over}
        log(f"{kernel} vs plain, {name}, {field}: max_abs {mx:.3e}  p99.9 "
            f"{p999:.3e}  share over 1e-2 {over:.3e}")
        if not (p999 <= bar and over <= BAR_OVER):
            raise AssertionError(f"{kernel} disagrees with its plain version"
                                 f" on {name} {field}: {err[field]}")
    agree = float((exit_k == ref).double().mean())
    err["exit_k_agree"] = agree
    log(f"{kernel} vs plain, {name}, exit_k: equal on {agree:.6f} of "
        f"{num_tiles} tiles")
    if agree < BAR_EXIT_AGREE:
        raise AssertionError(f"{kernel} exit_k agrees on only {agree} "
                             f"({name})")
    return err


def compare_grad_rows(kernel, name, grad, ref):
    """A compositor backward against its plain version, per record row,
    |d| normalised by the row's max |plain|; the last two rows (rx, ry)
    and rows whose plain gradient is 0 must be exactly 0.  Raises past a
    bar; returns the rows compared."""
    if not bool(torch.isfinite(grad).all()):
        raise AssertionError(f"{kernel} gave non-finite gradients on {name}")
    nf = grad.shape[0]
    rows = []
    for r in range(nf):
        scale = float(ref[r].abs().max())
        if r >= nf - 2 or scale == 0.0:      # rx, ry: no gradient
            if float(grad[r].abs().max()) != 0.0:
                raise AssertionError(f"{kernel} row {r} should be 0 "
                                     f"({name})")
            continue
        mx, p999, over = error_mass(grad[r] / scale, ref[r] / scale)
        rows.append({"row": r, "max_abs": float((grad[r] - ref[r]).abs()
                                                 .max()),
                     "max_norm": mx, "p999_norm": p999, "over_1e-2": over,
                     "row_scale": scale})
        log(f"{kernel} vs plain, {name}, row {r}: normalised max {mx:.3e}  "
            f"p99.9 {p999:.3e}  share over 1e-2 {over:.3e}  (row max "
            f"|plain| {scale:.3e})")
        if not (p999 <= BAR_P999["grad"] and over <= BAR_OVER):
            raise AssertionError(f"{kernel} disagrees with its plain version"
                                 f" on {name} row {r}: {rows[-1]}")
    return rows


def check_b1(cr, splats, cam, name, cfg, scene=None):
    """B1 against its plain version on the records of one main-path
    configuration; its time, the plain version's time and the bound.
    ``scene``: project_splats' scene inputs (transforms, scene indices,
    opacities, visibility, fade), as a viewer frame passes them."""
    from gaussiansplats3d_tpu_torch.render.binning import bin_sort_records
    from gaussiansplats3d_tpu_torch.render.projection import project_splats
    with torch.no_grad():
        pairs = bin_sort_records(
            project_splats(splats, cam, cfg, **(scene or {})), cfg)
    dev = splats.device
    ids = torch.arange(cfg.num_tiles, dtype=torch.int32, device=dev)
    args = (pairs.records, pairs.tile_starts, pairs.tile_counts, ids, cfg)
    chans, logt, exit_k = cr.composite_fwd_cuda(*args)
    torch.cuda.synchronize()
    ref = cr.composite_fwd_torch(*args)
    torch.cuda.synchronize()
    err = compare_forward(
        "B1", name, [("chans", chans, ref[0], BAR_P999["chans"]),
                     ("logt", logt, ref[1], BAR_P999["logt"])],
        ref[2], exit_k, cfg.num_tiles)

    ms = cuda_ms(lambda: cr.composite_fwd_cuda(*args), reps=10)
    plain_ms = cuda_ms(lambda: cr.composite_fwd_torch(*args), reps=2)
    counts, ops, nbytes = b1_work(cr, pairs, exit_k, cfg)
    bound_ms, bound_by, ops_ms, bytes_ms = bound_of(ops, nbytes)
    log(f"B1 {name}: time {ms:.3f} ms  plain {plain_ms:.3f} ms  bound "
        f"{bound_ms:.4f} ms by {bound_by} (ops bound {ops_ms:.4f} ms: "
        f"{ops} float32 operations; bytes bound {bytes_ms:.4f} ms: {nbytes}"
        f" bytes); pairs visited {counts['pairs']}, pair-pixel visits "
        f"before exit {counts['visits']}, in "
        f"box {counts['in_box']}, in cut-off {counts['in_cutoff']}, "
        f"contributing {counts['contributing']}; pair-warp visits "
        f"{counts['pair_warps']}, kept by the cull "
        f"{counts['kept_pair_warps']}; mean exit_k "
        f"{float(exit_k.double().mean()):.2f}, pairs in windows "
        f"{int(pairs.tile_counts.long().sum())}")
    return {"max_abs_err": max(err["chans"]["max_abs"],
                               err["logt"]["max_abs"]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "errors": err, "work": counts,
            "operations": ops, "bytes": nbytes}


def check_b1_all(cr, splats, cam, cfg):
    """check_b1 on every configuration the serving and training paths
    drive (mixed, packed+forward_only, train-packed).  The kernels-line
    entry takes its times and bound from the default configuration and its
    max_abs_err from the worst configuration."""
    configs = dict(configs_of(cfg) + train_configs_of(cfg))
    per_config = {name: check_b1(cr, splats, cam, name, c)
                  for name, c in configs.items()}
    main = per_config["mixed"]
    return {"name": "composite_fwd", "route": "cuda",
            "source": "gaussiansplats3d_tpu_torch/csrc/composite_fwd.cu",
            "replaces": "gaussiansplats3d_tpu/render/pallas_rasterize.py:362",
            "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in per_config.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "per_config": per_config}


def color_loss_cotangent(chans, cfg):
    """The cotangent of mean(color^2) at chans [T, NC + 1, P], through
    the port's own image assembly."""
    from gaussiansplats3d_tpu_torch.render import pipeline
    leaf = chans.detach().requires_grad_(True)
    img = pipeline.assemble_image(leaf, cfg)["color"]
    (g,) = torch.autograd.grad((img * img).mean(), leaf)
    return g.contiguous()


def check_b2(cr, splats, cam, name, cfg):
    """B2 against its plain version on the records of one training
    configuration, with B1's residuals and the cotangent of mean(color^2);
    its time, the plain version's time and the bound."""
    from gaussiansplats3d_tpu_torch.render.binning import bin_sort_records
    from gaussiansplats3d_tpu_torch.render.projection import project_splats
    dev = splats.device
    with torch.no_grad():
        pairs = bin_sort_records(project_splats(splats, cam, cfg), cfg)
        ids = torch.arange(cfg.num_tiles, dtype=torch.int32, device=dev)
        args = (pairs.records, pairs.tile_starts, pairs.tile_counts, ids)
        chans, logt, exit_k = cr.composite_fwd_cuda(*args, cfg)
    args = args + (logt, exit_k, color_loss_cotangent(chans, cfg), cfg)
    grad = cr.composite_bwd_cuda(*args)
    torch.cuda.synchronize()
    ref = cr.composite_bwd_torch(*args)
    torch.cuda.synchronize()
    nf = grad.shape[0]
    rows = compare_grad_rows("B2", name, grad, ref)
    if len(rows) != nf - 2:
        raise AssertionError(f"B2 on {name}: a record row has no gradient")
    ms = cuda_ms(lambda: cr.composite_bwd_cuda(*args), reps=10)
    plain_ms = cuda_ms(lambda: cr.composite_bwd_torch(*args), reps=2)
    counts, ops, nbytes = b2_work(cr, pairs, exit_k, cfg)
    bound_ms, bound_by, ops_ms, bytes_ms = bound_of(ops, nbytes)
    log(f"B2 {name}: time {ms:.3f} ms  plain {plain_ms:.3f} ms  bound "
        f"{bound_ms:.4f} ms by {bound_by} (ops bound {ops_ms:.4f} ms: "
        f"{ops} float32 operations; bytes bound {bytes_ms:.4f} ms: {nbytes}"
        f" bytes); pairs replayed {counts['pairs']}, visits replayed "
        f"{counts['visits']}, in box "
        f"{counts['in_box']}, in cut-off {counts['in_cutoff']}, "
        f"contributing {counts['contributing']}; pair-warp visits "
        f"{counts['pair_warps']}, kept by the cull "
        f"{counts['kept_pair_warps']}; chunks replayed "
        f"{int(exit_k.long().sum())}")
    return {"max_abs_err": max(r["max_abs"] for r in rows), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "rows": rows, "work": counts,
            "operations": ops, "bytes": nbytes}


def check_b2_all(cr, splats, cam, cfg):
    """check_b2 on every training configuration.  The kernels-line entry
    takes its times and bound from the default configuration and its
    max_abs_err from the worst configuration."""
    per_config = {name: check_b2(cr, splats, cam, name, c)
                  for name, c in train_configs_of(cfg)}
    main = per_config["mixed"]
    return {"name": "composite_bwd", "route": "cuda",
            "source": "gaussiansplats3d_tpu_torch/csrc/composite_bwd.cu",
            "replaces": "gaussiansplats3d_tpu/render/pallas_rasterize.py:494",
            "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in per_config.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "per_config": per_config}


# the record gather's backward (csrc/gather_bwd.cu) at the benchmark's
# sizes: the garden (5M splats, SH 2, 1080p, aux 1.5) and the truck in 2D
# (1M surfels, SH 1, 800 x 600, the default aux 0.25), 'mixed' records
GATHER_SCENES = (("garden", 5_000_000, 2, 1920, 1080, 1.5, False),
                 ("truck-2d", 1_000_000, 1, 800, 600, 0.25, True))
GATHER_REPS = 20
GATHER_RTOL = 1e-6


def gather_inputs(gt, name, n, sh, width, height, aux, mode_2d, device):
    """One backward of bench.py's step (mean(color^2)) through render() on
    a scene of the benchmark's size: the record gather's (src, perm,
    layout) and the cotangent its backward received (B2's or B4's)."""
    from gaussiansplats3d_tpu_torch.render import binning
    gen = torch.Generator(device=device).manual_seed(SEED)
    splats = gt.random_splats(gen, n, sh_degree=sh, extent=2.0,
                              device=device)
    splats.scales = splats.scales * 0.15
    cam = gt.Camera.look_at((4.5, 2.5, 4.5), (0.0, 0.0, 0.0),
                            fov_y_deg=60.0, aspect=width / height,
                            device=device)
    cfg = gt.RenderConfig(width=width, height=height, sh_degree=sh,
                          sort_bits=16, aux_multiplier=aux,
                          render_mode_2d=mode_2d)
    calls, cots = [], []
    apply, bwd = binning._Gather.apply, binning.gather_bwd

    def recording_apply(fields, src, perm, layout):
        calls.append((src, perm, layout))
        return apply(fields, src, perm, layout)

    def recording_bwd(g, perm, layout):
        cots.append(g)
        return bwd(g, perm, layout)

    binning._Gather.apply, binning.gather_bwd = recording_apply, \
        recording_bwd
    try:
        grad_step(gt, grad_splats(gt, splats), cam, cfg)
    finally:
        del binning._Gather.apply
        binning.gather_bwd = bwd
    (src, perm, layout), = calls
    g, = cots
    return src, perm, layout, g


def check_gather_bwd(gt, device):
    """csrc/gather_bwd.cu on each of GATHER_SCENES, with the real
    cotangent of its step and with a random one: against its plain
    version (on the card) and against index_add_ in float64, |d| <=
    GATHER_RTOL times the same sums of |cotangent|; two calls bit equal;
    the tail's slots as the layout says; 2 launches a call; inside guard
    zones (tests/torch_gather.py::guarded_gather_bwd) every guard as it
    was, no NaN and the same bits, so nothing is read or written out of
    bounds and no row is read before it is written.  Then its ms
    alone beside index_add_'s (the library_ms yardstick: autograd's
    backward of index_select), the plain version's and the bytes bound
    (the cotangent, perm and the table read once, d written once)."""
    from gaussiansplats3d_tpu_torch.render import binning
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_gather import guarded_gather_bwd
    out = {}
    for name, n, sh, width, height, aux, mode_2d in GATHER_SCENES:
        src, perm, layout, g_real = gather_inputs(
            gt, name, n, sh, width, height, aux, mode_2d, device)
        f, s = g_real.shape
        gen = torch.Generator(device=device).manual_seed(SEED)
        g_rand = torch.randn((f, s), generator=gen, device=device)
        kept = min(int(layout.covered), layout.aux_cap)
        tail_want = layout.aux_cap - kept + layout.pad
        res = {"splats": n, "rows": f, "slots": s, "lanes": layout.lanes,
               "aux_cap": layout.aux_cap, "covered": int(layout.covered),
               "pad": layout.pad, "tail_slots": tail_want}
        for kind, g in (("real", g_real), ("random", g_rand)):
            before = launch_count(binning.LAUNCHES)
            d1, t1 = binning.gather_bwd_cuda(g, perm, layout)
            d2, _ = binning.gather_bwd_cuda(g, perm, layout)
            torch.cuda.synchronize()
            launches = launch_count(binning.LAUNCHES) - before
            if launches != 4:
                raise AssertionError(f"gather_bwd {name}: {launches} "
                                     f"launches in 2 calls")
            if not torch.equal(d1.view(torch.int32), d2.view(torch.int32)):
                raise AssertionError(f"gather_bwd {name} {kind}: two calls "
                                     f"differ")
            if int(t1) != tail_want:
                raise AssertionError(f"gather_bwd {name}: tail {int(t1)} "
                                     f"slots, the layout says {tail_want}")
            d_g, t_g, intact = guarded_gather_bwd(g, perm, layout)
            if not (intact and int(t_g) == tail_want
                    and torch.equal(d_g.view(torch.int32),
                                    d1.view(torch.int32))):
                raise AssertionError(
                    f"gather_bwd {name} {kind}: inside guard zones, guards "
                    f"intact {intact}, NaN {bool(torch.isnan(d_g).any())}, "
                    f"the same bits {torch.equal(d_g, d1)}")
            del d_g
            res["launches_per_call"] = launches // 2
            plain, _ = binning.gather_bwd_torch(g, perm, layout)
            g64 = g.double()
            ref = g64.new_zeros((f, n)).index_add_(1, src, g64)
            scale = g64.abs().new_zeros((f, n)).index_add_(1, src,
                                                           g64.abs())
            del g64
            errs = {}
            for who, d in (("kernel", d1), ("plain", plain)):
                rel = ((d.double() - ref).abs()
                       / torch.clamp(scale, min=1e-300))
                errs[who] = float(rel.max())
                if errs[who] > GATHER_RTOL:
                    raise AssertionError(f"gather_bwd {name} {kind}: {who} "
                                         f"off index_add_ by {errs[who]} "
                                         f"of the sums of |g|")
            res[kind] = {"max_rel_err": errs,
                         "kernel_vs_plain_max_abs": float(
                             (d1 - plain).abs().max()),
                         "splat0_kernel": float(d1[:, 0].abs().sum()),
                         "splat0_ref": float(ref[:, 0].abs().sum())}
            del ref, scale, plain, d1, d2
        g = g_real
        res["ms"] = cuda_ms(lambda: binning.gather_bwd_cuda(g, perm, layout),
                            GATHER_REPS)
        res["library_ms"] = cuda_ms(
            lambda: g.new_zeros((f, n)).index_add_(1, src, g), 3)
        res["plain_ms"] = cuda_ms(
            lambda: binning.gather_bwd_torch(g, perm, layout), 3)
        b_cap = layout.offs_c.shape[0]
        nbytes = 4 * f * s + 8 * s + 8 * n + 16 * b_cap + 4 * f * n
        res["bytes"] = nbytes
        res["bound_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
        log(f"gather_bwd {name}: {f} x {s} slots onto {n} splats (tail "
            f"{tail_want} slots): {res['ms']:.3f} ms alone, index_add_ "
            f"{res['library_ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, "
            f"bound {res['bound_ms']:.4f} ms (bytes); max rel err real "
            f"{res['real']['max_rel_err']}, random "
            f"{res['random']['max_rel_err']}")
        out[name] = res
        del src, perm, layout, g_real, g_rand, g
        torch.cuda.empty_cache()
    return {"name": "gather_bwd", "route": "cuda",
            "source": "gaussiansplats3d_tpu_torch/csrc/gather_bwd.cu",
            "replaces": "index_add_ (autograd's index_select backward); the "
                        "JAX package's _expand_sort_bwd, "
                        "gaussiansplats3d_tpu/render/binning.py:699",
            "launches_per_call": sorted({r["launches_per_call"]
                                         for r in out.values()}),
            "per_scene": out}


def train_configs_of(cfg):
    """The two configurations the training path is driven in, as bench.py
    times them: the default record precision, and train-packed (packed
    records with gradients on)."""
    return [("mixed", cfg),
            ("train-packed", cfg.replace(record_precision="packed"))]


def configs_of(cfg):
    """The two configurations the main path is driven in: the default
    record precision, and the serving mode as bench.py configures it
    (packed records, forward only, aux capacity 0.3 N)."""
    return [("mixed", cfg),
            ("packed+forward_only",
             cfg.replace(record_precision="packed", forward_only=True,
                         aux_multiplier=0.3))]


def main_path(gt, cr, splats, cam, cfg):
    """RENDERS renders per configuration through render(), with the launch
    counters zeroed just before and read just after: B1 once a render, the
    record gather's backward never.  A render's enqueue
    time is the host's time until render() returns (it waits for nothing
    on the device); when it is close to the wall time, the host bounds
    the frame."""
    configs = configs_of(cfg)
    with torch.no_grad():
        for _, c in configs:                       # warm-up, not counted
            gt.render(splats, cam, c)
        torch.cuda.synchronize()
        results = {}
        cr.reset_launches()
        for name, c in configs:
            torch.cuda.reset_peak_memory_stats()
            before = launch_count(cr.LAUNCHES)
            zero_gather()
            times, enqueue = [], []
            for _ in range(RENDERS):
                t0 = time.perf_counter()
                out = gt.render(splats, cam, c, return_aux=True)
                enqueue.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            launches = launch_count(cr.LAUNCHES) - before
            gather_launches(f"render {name} tile {c.tile_size}", 0)
            color, alpha = out["color"], out["alpha"]
            if color.shape != (HEIGHT, WIDTH, 3) or alpha.shape != (HEIGHT,
                                                                    WIDTH):
                raise AssertionError(f"image shapes {color.shape} "
                                     f"{alpha.shape}")
            if not bool(torch.isfinite(color).all()):
                raise AssertionError("non-finite color")
            amin, amax = float(alpha.min()), float(alpha.max())
            if not (amin >= 0.0 and amax <= 1.0 + 1e-5):
                raise AssertionError(f"alpha outside [0, 1]: {amin} {amax}")
            res = {"median_ms": float(np.median(times)), "times_ms": times,
                   "enqueue_median_ms": float(np.median(enqueue)),
                   "num_pairs": int(out["num_pairs"]),
                   "overflow": int(out["overflow"]),
                   "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                   "launches": launches, "alpha_mean": float(alpha.mean()),
                   "alpha_range": [amin, amax]}
            results[name] = res
            log(f"main path {name}: median {res['median_ms']:.2f} ms over "
                f"{RENDERS} renders ({', '.join(f'{x:.2f}' for x in times)}"
                f"), enqueue median {res['enqueue_median_ms']:.2f} ms"
                f"; num_pairs {res['num_pairs']} overflow {res['overflow']}"
                f"; peak memory {res['peak_mem_bytes'] / 2**30:.2f} GiB; "
                f"B1 launches {launches}; alpha mean {res['alpha_mean']:.4f}")
            if launches != RENDERS:
                raise AssertionError(f"B1 launched {launches} times in "
                                     f"{RENDERS} renders of {name}")
        total = launch_count(cr.LAUNCHES)
    if total != RENDERS * len(configs):
        raise AssertionError(f"B1 launched {total} times on the main path")
    if launch_count(cr.BWD_LAUNCHES) != 0:
        raise AssertionError(f"B2 launched "
                             f"{launch_count(cr.BWD_LAUNCHES)} times on the "
                             f"forward path")
    return results, total


def stage_breakdown(splats, cam, cfg):
    """Milliseconds of each stage of one render in each configuration,
    stage by stage (CUDA events)."""
    from gaussiansplats3d_tpu_torch.render import pipeline
    from gaussiansplats3d_tpu_torch.render.binning import bin_sort_records
    from gaussiansplats3d_tpu_torch.render.projection import project_splats
    out = {}
    for name, c in configs_of(cfg):
        with torch.no_grad():
            proj = project_splats(splats, cam, c)
            pairs = bin_sort_records(proj, c)
            chans = pipeline.composite_sorted(c, pairs)
            stages = {
                "project_splats": cuda_ms(
                    lambda: project_splats(splats, cam, c), 3),
                "bin_sort_records": cuda_ms(
                    lambda: bin_sort_records(proj, c), 3),
                "composite_sorted": cuda_ms(
                    lambda: pipeline.composite_sorted(c, pairs), 3),
                "assemble_image": cuda_ms(
                    lambda: pipeline.assemble_image(chans, c), 3),
            }
        log(f"stages {name} (ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
        out[name] = stages
    return out


def profile_render(gt, splats, cam, cfg, wall_ms, reps=3):
    """torch.profiler over `reps` default renders: device time per render,
    the device's idle share against the unprofiled median wall time, and
    the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                gt.render(splats, cam, cfg)
            torch.cuda.synchronize()
    # device-side events only (kernels, copies): the CPU ops that launched
    # them carry the same time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    if dev_ms == 0.0:
        log("profiler saw no device time: idle share not measured")
        return None
    launches = sum(e.count for e in kernels) / reps
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = [{"name": e.key[:70], "per_render": e.count / reps,
            "ms_per_render": e.self_device_time_total / 1e3 / reps}
           for e in kernels[:8]]
    idle = max(0.0, 1.0 - dev_ms / wall_ms)
    log(f"profile: device {dev_ms:.3f} ms per render, {launches:.0f} device "
        f"ops per render, idle share {idle:.3f} of the {wall_ms:.2f} ms "
        f"median render")
    for k in top:
        log(f"  {k['ms_per_render']:8.3f} ms  x{k['per_render']:.0f}  "
            f"{k['name']}")
    return {"device_ms": dev_ms, "device_ops": launches, "idle_share": idle,
            "top": top}


FIELDS = ("means", "scales", "quats", "colors", "sh")


def grad_splats(gt, splats):
    """Leaf copies of the scene's five fields that take gradients."""
    return gt.SplatData(*(getattr(splats, f).detach().clone()
                          .requires_grad_(True) for f in FIELDS))


def grad_step(gt, s, cam, cfg):
    """bench.py's step: the gradient of mean(color^2) with respect to
    every field of ``s`` (left in each field's .grad)."""
    for f in FIELDS:
        getattr(s, f).grad = None
    img = gt.render(s, cam, cfg)["color"]
    (img * img).mean().backward()


def train_path(gt, cr, splats, cam, cfg):
    """STEPS timed steps per training configuration after a warm-up, with
    the launch counters zeroed just before and read just after: B1 and B2
    once a step, the record gather's backward's 2 kernels once.  Msplats/s as bench.py computes it (N / step s / 1e6),
    from the median step."""
    s = grad_splats(gt, splats)
    configs = train_configs_of(cfg)
    for _, c in configs:                           # warm-up, not counted
        grad_step(gt, s, cam, c)
    torch.cuda.synchronize()
    results = {}
    cr.reset_launches()
    for name, c in configs:
        torch.cuda.reset_peak_memory_stats()
        before = (launch_count(cr.LAUNCHES), launch_count(cr.BWD_LAUNCHES))
        zero_gather()
        times = []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            grad_step(gt, s, cam, c)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = (launch_count(cr.LAUNCHES) - before[0],
                    launch_count(cr.BWD_LAUNCHES) - before[1])
        gather_n = gather_launches(f"train_step {name} tile {c.tile_size}",
                                   2 * STEPS)
        grads = {}
        for f in FIELDS:
            g = getattr(s, f).grad
            if g is None or not bool(torch.isfinite(g).all()) \
                    or float(g.abs().max()) == 0.0:
                raise AssertionError(f"gradient of {f} is missing, "
                                     f"non-finite or zero ({name})")
            grads[f] = float(g.abs().max())
        med = float(np.median(times))
        res = {"median_ms": med, "times_ms": times,
               "msplats_per_s": N_SPLATS / (med / 1e3) / 1e6,
               "msplats_per_s_mean": N_SPLATS / (float(np.mean(times)) / 1e3)
               / 1e6,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "launches_b1": launches[0], "launches_b2": launches[1],
               "launches_gather_bwd": gather_n, "grad_max_abs": grads}
        results[name] = res
        log(f"train step {name}: median {med:.2f} ms over {STEPS} steps "
            f"({', '.join(f'{x:.2f}' for x in times)}); "
            f"{res['msplats_per_s']:.3f} Msplats/s (mean-based "
            f"{res['msplats_per_s_mean']:.3f}); peak memory "
            f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; B1 launches "
            f"{launches[0]}, B2 launches {launches[1]}, gather_bwd launches "
            f"{gather_n}; max |grad| "
            + ", ".join(f"{k} {v:.3e}" for k, v in grads.items()))
        if launches != (STEPS, STEPS):
            raise AssertionError(f"{launches} launches of (B1, B2) in "
                                 f"{STEPS} steps of {name}")
    total = (launch_count(cr.LAUNCHES), launch_count(cr.BWD_LAUNCHES))
    if total != (STEPS * len(configs),) * 2:
        raise AssertionError(f"(B1, B2) launched {total} times on the "
                             f"training path")
    return results, total


def train_stage_breakdown(gt, cr, splats, cam, cfg):
    """Milliseconds of each stage of one training step in each training
    configuration, stage by stage (CUDA events): the forward stages, then
    the backward cut at the records (assembly + B2, B2 alone) and at the
    projected fields (the gather's backward and codecs), then the
    projection's backward."""
    from gaussiansplats3d_tpu_torch.render import pipeline
    from gaussiansplats3d_tpu_torch.render.binning import bin_sort_records
    from gaussiansplats3d_tpu_torch.render.projection import project_splats
    diff = ("xs", "ys", "conic_a", "conic_b", "conic_c", "col_r", "col_g",
            "col_b", "opacity", "depth")
    s = grad_splats(gt, splats)
    out = {}
    for name, c in train_configs_of(cfg):
        proj = project_splats(s, cam, c)
        pq = dataclasses.replace(proj, **{
            f: getattr(proj, f).detach().requires_grad_(True) for f in diff})
        pairs = bin_sort_records(pq, c)
        rec_leaf = pairs.records.detach().requires_grad_(True)
        pairs_leaf = dataclasses.replace(pairs, records=rec_leaf)
        chans = pipeline.composite_sorted(c, pairs_leaf)
        img = pipeline.assemble_image(chans, c)["color"]
        loss = (img * img).mean()
        (g_rec,) = torch.autograd.grad(loss, rec_leaf, retain_graph=True)
        g_pq = torch.autograd.grad(pairs.records, [getattr(pq, f)
                                                   for f in diff],
                                   g_rec, retain_graph=True,
                                   allow_unused=True)
        used = [(getattr(proj, f), g) for f, g in zip(diff, g_pq)
                if g is not None]
        ids = torch.arange(c.num_tiles, dtype=torch.int32,
                           device=splats.device)
        b2_args = (pairs.records.detach(), pairs.tile_starts,
                   pairs.tile_counts, ids)
        with torch.no_grad():
            _, logt, exit_k = cr.composite_fwd_cuda(*b2_args, c)
        b2_args += (logt, exit_k, color_loss_cotangent(chans, c), c)
        fields = [getattr(s, f) for f in FIELDS]

        def fwd_assemble():
            im = pipeline.assemble_image(chans, c)["color"]
            return (im * im).mean()

        stages = {
            "fwd project_splats": cuda_ms(
                lambda: project_splats(s, cam, c), 3),
            "fwd bin_sort_records": cuda_ms(
                lambda: bin_sort_records(pq, c), 3),
            "fwd composite_sorted (B1)": cuda_ms(
                lambda: pipeline.composite_sorted(c, pairs_leaf), 3),
            "fwd assemble_image + loss": cuda_ms(fwd_assemble, 3),
            "bwd assembly + B2 (to the records)": cuda_ms(
                lambda: torch.autograd.grad(loss, rec_leaf,
                                            retain_graph=True), 3),
            "bwd B2 alone": cuda_ms(
                lambda: cr.composite_bwd_cuda(*b2_args), 3),
            "bwd gather + codecs (to the projected fields)": cuda_ms(
                lambda: torch.autograd.grad(
                    pairs.records, [getattr(pq, f) for f in diff], g_rec,
                    retain_graph=True, allow_unused=True), 3),
            "bwd project_splats (to the five fields)": cuda_ms(
                lambda: torch.autograd.grad(
                    [u for u, _ in used], fields, [g for _, g in used],
                    retain_graph=True, allow_unused=True), 3),
            "whole step (grad_step)": cuda_ms(
                lambda: grad_step(gt, s, cam, c), 3),
        }
        log(f"train stages {name} (ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
        out[name] = stages
        del proj, pq, pairs, rec_leaf, pairs_leaf, chans, img, loss, used
    return out


def profile_fn(name, fn, wall_ms):
    """torch.profiler over one call of fn (which ends in nothing waiting):
    device time, the device's idle share against the unprofiled median
    wall time, the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if dev_ms == 0.0:
        log("profiler saw no device time: idle share not measured")
        return None
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = [{"name": e.key[:70], "count": e.count,
            "ms": e.self_device_time_total / 1e3} for e in kernels[:10]]
    idle = max(0.0, 1.0 - dev_ms / wall_ms)
    log(f"profile {name}: device {dev_ms:.3f} ms, "
        f"{sum(e.count for e in kernels)} device ops, idle share {idle:.3f} "
        f"of the {wall_ms:.2f} ms median step")
    for k in top:
        log(f"  {k['ms']:8.3f} ms  x{k['count']}  {k['name']}")
    return {"device_ms": dev_ms, "idle_share": idle, "top": top}


def profile_step(gt, splats, cam, cfg, wall_ms):
    """profile_fn over one default training step, after a warm-up."""
    s = grad_splats(gt, splats)
    grad_step(gt, s, cam, cfg)                      # warm-up
    torch.cuda.synchronize()
    return profile_fn("train step", lambda: grad_step(gt, s, cam, cfg),
                      wall_ms)


def adam_steps(cr, splats, cam, cfg, steps=3):
    """A few Adam steps through make_train_step at the main path's size,
    towards a black image: finite losses that fall, the compositor's
    forward and backward kernels once a step (``cr``: the module of B1 and
    B2, or of B3 and B4 for a 2D cfg), the record gather's backward's 2
    kernels once."""
    from gaussiansplats3d_tpu_torch.parallel import train
    state = train.TrainState.create(splats, train.adam(1e-3))
    step = train.make_train_step(cfg, None, train.adam(1e-3))
    tiles, mask = train.image_to_tile_blocks(
        torch.zeros((HEIGHT, WIDTH, 3), device=splats.device), cfg)
    cr.reset_launches()
    zero_gather()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, cam, tiles, mask)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
        if not (np.isfinite(losses[-1]) and float(m["grad_norm"]) > 0.0):
            raise AssertionError(f"make_train_step: loss {losses[-1]}, "
                                 f"grad_norm {float(m['grad_norm'])}")
    launches = (launch_count(cr.LAUNCHES), launch_count(cr.BWD_LAUNCHES))
    gather_n = gather_launches(
        f"make_train_step{' 2d' if cfg.render_mode_2d else ''}", 2 * steps)
    log(f"make_train_step at 2M{' in 2D' if cfg.render_mode_2d else ''}: "
        f"losses {losses}, step ms {[round(t, 2) for t in times]}, "
        f"(forward, backward kernel) launches {launches}, gather_bwd "
        f"launches {gather_n}")
    if launches != (steps, steps) or not losses[-1] < losses[0]:
        raise AssertionError("make_train_step did not train")
    return {"losses": losses, "times_ms": times}


def fit_scene(n, seed):
    """tests/torch_port_common.scene_arrays: random_splats' distributions
    drawn with numpy (SH degree 0)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, (n, 3))
    scales = rng.uniform(0.005, 0.05, (n, 3))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    colors = np.concatenate([rng.uniform(0.0, 1.0, (n, 3)),
                             rng.uniform(0.3, 1.0, (n, 1))], axis=1)
    return [a.astype(np.float32) for a in
            (means, scales, quats, colors, np.zeros((n, 0, 3)))]


def fit_gate(gt, device):
    """tests/test_training.py::test_fit_psnr_gate on the card, on the
    scene of the port's CPU test (tests/test_torch_training.py): recover
    a perturbed 300-splat scene to >= 25 dB over 3 views in 150 Adam steps
    (lr 2e-3)."""
    from gaussiansplats3d_tpu_torch.parallel import train
    from gaussiansplats3d_tpu_torch.render.pipeline import (render_batch,
                                                            stack_cameras)
    from gaussiansplats3d_tpu_torch.utils.image_metrics import psnr
    arrays = fit_scene(300, 55)
    truth = gt.SplatData.from_numpy(*arrays, device=device)
    cfg = gt.RenderConfig(width=64, height=64, sort_bits=14)
    cams = stack_cameras([
        gt.Camera.look_at(eye, (0, 0, 0), fov_y_deg=60.0, device=device)
        for eye in ((2.0, 1.0, 2.0), (-2.0, 1.2, 1.8), (0.5, 2.4, -1.8))])
    with torch.no_grad():
        targets = render_batch(truth, cams, cfg)["color"]
    rng = np.random.default_rng(56)
    init = gt.SplatData.from_numpy(
        arrays[0] + 0.03 * rng.normal(size=arrays[0].shape), *arrays[1:3],
        np.clip(arrays[3] + 0.15 * rng.normal(size=arrays[3].shape),
                0.01, 1.0), arrays[4], device=device)
    params = train.SplatParams.from_splats(init)
    opt = train.adam(2e-3)(params.parameters())
    t0 = time.perf_counter()
    for _ in range(150):
        opt.zero_grad()
        out = render_batch(params.to_splats(), cams, cfg)["color"]
        torch.mean((out - targets) ** 2).backward()
        opt.step()
    with torch.no_grad():
        final = render_batch(params.to_splats(), cams, cfg)["color"]
    p = float(psnr(final, targets))
    log(f"fit gate on the card: {p:.2f} dB after 150 steps "
        f"({time.perf_counter() - t0:.1f} s)")
    if not p >= FIT_PSNR_DB:
        raise AssertionError(f"fit PSNR {p:.2f} dB < {FIT_PSNR_DB} dB")
    return p


def train_scene_run():
    """A short run of the trainer's CLI on the card, one densify step."""
    from gaussiansplats3d_tpu_torch.tools import train_scene
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_scene.main(["--views", "4", "--iters", "40", "--init",
                               "3000", "--densify-every", "20",
                               "--log-every", "20"])
    text = buf.getvalue()
    for line in text.strip().splitlines():
        log(f"  train_scene: {line}")
    log(f"train_scene: exit {rc} in {time.perf_counter() - t0:.1f} s")
    if rc != 0 or "on cuda" not in text or "final psnr" not in text:
        raise AssertionError("train_scene did not run on the card")


def small_gradients(gt, device):
    """At 3000 splats, 256x192, f32 records, with a depth channel: the
    gradients of mean(color^2) + mean(depth^2) with respect to the five
    fields, on the card against the CPU render, by error mass normalised
    by each field's max |CPU| (p99.9 <= 1e-3, <= 0.1% over 1e-2)."""
    cfg = gt.RenderConfig(width=256, height=192, sh_degree=SH_DEGREE,
                          record_precision="f32", return_depth=True)
    grads = {}
    for dev in (device, "cpu"):
        gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
        s = gt.random_splats(gen, 3000, sh_degree=SH_DEGREE, device="cpu")
        s = gt.SplatData(*(getattr(s, f).to(dev).requires_grad_(True)
                           for f in FIELDS))
        cam = gt.Camera.look_at((2.5, 1.5, 2.5), (0, 0, 0), fov_y_deg=60.0,
                                aspect=256 / 192, device=dev)
        out = gt.render(s, cam, cfg)
        ((out["color"] ** 2).mean() + (out["depth"] ** 2).mean()).backward()
        grads[str(dev)] = {f: getattr(s, f).grad.cpu() for f in FIELDS}
    for f in FIELDS:
        ref = grads["cpu"][f]
        scale = float(ref.abs().max())
        _, p999, over = error_mass(grads[str(device)][f] / scale, ref / scale)
        log(f"small gradients vs cpu {f}: p99.9 {p999:.3e} share over 1e-2 "
            f"{over:.3e} (max |cpu| {scale:.3e})")
        if not (p999 <= 1e-3 and over <= 1e-3):
            raise AssertionError(f"small gradient {f} vs cpu")


def small_correctness(gt, device):
    """At 3000 splats, 256x192, with a depth channel (B1's NC = 4 variant):
    the CUDA render against the port's untiled oracle on the card and the
    CPU render, by error mass (p99.9 <= 1e-3, <= 0.1% over 1e-2)."""
    cfg = gt.RenderConfig(width=256, height=192, sh_degree=SH_DEGREE,
                          return_depth=True)
    outs = {}
    for dev in (device, "cpu"):
        gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
        s = gt.random_splats(gen, 3000, sh_degree=SH_DEGREE, device="cpu")
        s = gt.SplatData(*(x.to(dev) for x in (s.means, s.scales, s.quats,
                                                s.colors, s.sh)))
        cam = gt.Camera.look_at((2.5, 1.5, 2.5), (0, 0, 0), fov_y_deg=60.0,
                                aspect=256 / 192, device=dev)
        with torch.no_grad():
            outs[str(dev)] = gt.render(s, cam, cfg)
            if dev == device:
                oracle = gt.reference_render(s, cam, cfg.replace(
                    return_depth=False))
    got = outs[str(device)]
    for ref_name, ref, keys in (("oracle", oracle, ("color", "alpha")),
                                ("cpu", outs["cpu"],
                                 ("color", "alpha", "depth"))):
        for k in keys:
            _, p999, over = error_mass(got[k].cpu(), ref[k].cpu())
            log(f"small render vs {ref_name} {k}: p99.9 {p999:.3e} share "
                f"over 1e-2 {over:.3e}")
            if not (p999 <= 1e-3 and over <= 1e-3):
                raise AssertionError(f"small render {k} vs {ref_name}")


# --- the 2DGS surfel mode ----------------------------------------------------

def surfel_inputs(splats, cam, cfg, scene=None):
    """The surfel compositor's inputs on the port's own projection and
    binning: ((records, starts, counts, tile ids), overflow).  ``scene``:
    project_surfels' scene inputs, as a 2D viewer frame passes them."""
    from gaussiansplats3d_tpu_torch.render.surfel import (bin_sort_surfels,
                                                          project_surfels)
    with torch.no_grad():
        recs, starts, counts, _, overflow = bin_sort_surfels(
            project_surfels(splats, cam, cfg, **(scene or {})), cfg)
    ids = torch.arange(cfg.num_tiles, dtype=torch.int32,
                       device=splats.device)
    return (recs, starts, counts, ids), int(overflow)


def surfel_visit_counts(cs, args, exit_k, cfg):
    """The pairs each tile visits before its exit, their pair-pixel visits,
    how many of those pass the rx/ry box, the |p.z| and depth cuts, and
    min_alpha (the plain version's arithmetic); and the pairs visited."""
    recs, starts, counts, _ = args
    dev = recs.device
    ts = cfg.tile_size
    tile, slot, total = visited_slots(cs.CHUNK, starts, counts, exit_k, cfg)
    pix = torch.arange(ts, device=dev, dtype=torch.float32) + 0.5
    nc = recs.shape[0] - 14
    out = {"pairs": total, "visits": total * ts * ts, "in_box": 0,
           "past_cuts": 0, "contributing": 0}
    step = WORK_PAIRS_PER_STEP // 4
    for i in range(0, total, step):
        r = recs[:, slot[i:i + step]]
        t_i = tile[i:i + step]
        x0 = ((t_i % cfg.tiles_x) * ts).float()
        y0 = torch.div(t_i, cfg.tiles_x, rounding_mode="floor").float() * ts
        px = (x0[:, None] + pix[None, :])[:, None, :]              # [B, 1, x]
        py = (y0[:, None] + pix[None, :])[:, :, None]              # [B, y, 1]
        f = [v[:, None, None] for v in r]
        in_box = (((px - f[9]).abs() <= f[12 + nc])
                  & ((py - f[10]).abs() <= f[13 + nc]))
        k = [px * f[2 + 3 * j] - f[3 * j] for j in range(3)]
        l_ = [py * f[2 + 3 * j] - f[1 + 3 * j] for j in range(3)]
        p0 = k[1] * l_[2] - k[2] * l_[1]
        p1 = k[2] * l_[0] - k[0] * l_[2]
        p2 = k[0] * l_[1] - k[1] * l_[0]
        tiny = p2.abs() < 1e-12
        sp2 = torch.where(tiny, torch.full_like(p2, 1e-12), p2)
        su, sv = p0 / sp2, p1 / sp2
        rho3d = su * su + sv * sv
        rho2d = 2.0 * ((px - f[9]) ** 2 + (py - f[10]) ** 2)
        depth = torch.where(rho3d <= rho2d, su * f[2] + sv * f[5] + f[8],
                            f[8].expand_as(su))
        past = in_box & ~tiny & ~(depth < cs.NEAR_N)
        alpha = cs.surfel_alpha(f[:9], f[9], f[10], f[11 + nc], f[12 + nc],
                                f[13 + nc], px, py, cfg.min_alpha)
        out["in_box"] += int(in_box.sum())
        out["past_cuts"] += int(past.sum())
        out["contributing"] += int((alpha > 0.0).sum())
    return out, total


def surfel_tier_ops(counts):
    """float32 operations of B3's evaluation of alpha: the box's clip per
    pair visited, then the tiers each in-box visit walks up to the cuts."""
    return (counts["pairs"] * OPS_PAIR_TILE
            + counts["in_box"] * SURF_OPS_IN_BOX
            + counts["past_cuts"] * SURF_OPS_PAST_CUTS)


def b3_work(cs, args, exit_k, cfg):
    """What B3's function needs on these records, as float32 operations
    and bytes."""
    counts, total = surfel_visit_counts(cs, args, exit_k, cfg)
    nc = args[0].shape[0] - 14
    ops = (surfel_tier_ops(counts)
           + counts["contributing"] * (SURF_OPS_BLEND_BASE + 2 * nc))
    p, t = cfg.tile_size ** 2, cfg.num_tiles
    # records of the pairs composited, read once; starts, counts and ids;
    # colors, logt and exit_k written once
    nbytes = (total * (nc + 14) * 4 + 3 * t * 4 + t * p * nc * 4 + t * p * 4
              + t * 4)
    counts.update(cull_counts(args[0], (9, 10, nc + 12, nc + 13),
                              cs.CHUNK, args[1], args[2], exit_k, cfg))
    return counts, ops, nbytes


def b4_work(cs, args, exit_k, cfg):
    """What B4's function needs on these records: B3's visits walked twice
    (the chunk sum's recompute and the sweep), and the gradient terms of
    the contributing visits summed over the pixels."""
    counts, total = surfel_visit_counts(cs, args, exit_k, cfg)
    nc = args[0].shape[0] - 14
    p, t = cfg.tile_size ** 2, cfg.num_tiles
    ops = (2 * surfel_tier_ops(counts)
           + counts["contributing"] * (OPS_B4_GRAD_BASE
                                       + OPS_B4_GRAD_PER_CHANNEL * nc)
           + int(exit_k.long().sum()) * p * OPS_B2_CHUNK)
    # records of the pairs replayed, gcol, glogt and logt read once; starts,
    # counts, ids and exit_k; the [NC + 14, S] gradient written once
    nbytes = (total * (nc + 14) * 4 + t * p * nc * 4 + 2 * t * p * 4
              + 4 * t * 4 + args[0].numel() * 4)
    counts.update(cull_counts(args[0], (9, 10, nc + 12, nc + 13),
                              cs.CHUNK, args[1], args[2], exit_k, cfg))
    return counts, ops, nbytes


def surfel_cotangents(colors, logt, cfg):
    """The cotangents (gcol, glogt) of mean(color^2) + mean(alpha^2) (+
    mean(depth^2) with a depth channel) at the surfel compositor's
    outputs, through the port's own assembly: the alpha term reaches logt,
    as a background does, so B4's glogt term is exercised."""
    from gaussiansplats3d_tpu_torch.render import pipeline, surfel
    c = colors.detach().requires_grad_(True)
    lt = logt.detach().requires_grad_(True)
    out = pipeline.assemble_image(surfel.chans_from_colors_logt(c, lt), cfg)
    loss = sum((v ** 2).mean() for k, v in out.items()
               if k in ("color", "alpha", "depth"))
    gc, gl = torch.autograd.grad(loss, (c, lt))
    return gc.contiguous(), gl.contiguous()


def check_b3(cs, splats, cam, name, cfg, scene=None):
    """B3 against its plain version on the surfel records of one 2D
    configuration; its time, the plain version's time and the bound.
    ``scene`` as surfel_inputs takes it."""
    args, overflow = surfel_inputs(splats, cam, cfg, scene)
    colors, logt, exit_k = cs.composite_surfel_fwd_cuda(*args, cfg)
    torch.cuda.synchronize()
    ref = cs.composite_surfel_fwd_torch(*args, cfg)
    torch.cuda.synchronize()
    err = compare_forward(
        "B3", name, [("colors", colors, ref[0], BAR_P999["chans"]),
                     ("logt", logt, ref[1], BAR_P999["logt"])],
        ref[2], exit_k, cfg.num_tiles)
    ms = cuda_ms(lambda: cs.composite_surfel_fwd_cuda(*args, cfg), reps=10)
    plain_ms = cuda_ms(lambda: cs.composite_surfel_fwd_torch(*args, cfg),
                       reps=2)
    counts, ops, nbytes = b3_work(cs, args, exit_k, cfg)
    bound_ms, bound_by, ops_ms, bytes_ms = bound_of(ops, nbytes)
    log(f"B3 {name}: time {ms:.3f} ms  plain {plain_ms:.3f} ms  bound "
        f"{bound_ms:.4f} ms by {bound_by} (ops bound {ops_ms:.4f} ms: "
        f"{ops} float32 operations; bytes bound {bytes_ms:.4f} ms: {nbytes}"
        f" bytes); pairs visited {counts['pairs']}, pair-pixel visits "
        f"before exit {counts['visits']}, in "
        f"box {counts['in_box']}, past the cuts {counts['past_cuts']}, "
        f"contributing {counts['contributing']}; pair-warp visits "
        f"{counts['pair_warps']}, kept by the cull "
        f"{counts['kept_pair_warps']}; mean exit_k "
        f"{float(exit_k.double().mean()):.2f}, pairs in windows "
        f"{int(args[2].long().sum())}, overflow {overflow}")
    return {"max_abs_err": max(err["colors"]["max_abs"],
                               err["logt"]["max_abs"]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "errors": err, "work": counts,
            "operations": ops, "bytes": nbytes, "overflow": overflow}


def check_b4(cs, splats, cam, name, cfg):
    """B4 against its plain version on the surfel records of one 2D
    configuration, with B3's residuals and the cotangents of
    surfel_cotangents (glogt nonzero); its time, the plain version's time
    and the bound."""
    args, _ = surfel_inputs(splats, cam, cfg)
    with torch.no_grad():
        colors, logt, exit_k = cs.composite_surfel_fwd_cuda(*args, cfg)
    gcol, glogt = surfel_cotangents(colors, logt, cfg)
    if float(glogt.abs().max()) == 0.0:
        raise AssertionError("glogt is 0: B4's glogt term is not exercised")
    bargs = args + (logt, exit_k, gcol, glogt, cfg)
    grad = cs.composite_surfel_bwd_cuda(*bargs)
    torch.cuda.synchronize()
    ref = cs.composite_surfel_bwd_torch(*bargs)
    torch.cuda.synchronize()
    nf = grad.shape[0]
    rows = compare_grad_rows("B4", name, grad, ref)
    # T reaches alpha only where rho3d <= rho2d: a scene of sub-pixel
    # surfels may give its rows none (small_2d covers them on the card);
    # the center, channels and opacity always have a gradient
    with_grad = {r["row"] for r in rows}
    if not set(range(9, nf - 2)) <= with_grad:
        raise AssertionError(f"B4 on {name}: a center, channel or opacity "
                             f"row has no gradient")
    log(f"B4 {name}: {len(with_grad & set(range(9)))} of the 9 T rows have "
        f"a gradient")
    ms = cuda_ms(lambda: cs.composite_surfel_bwd_cuda(*bargs), reps=10)
    plain_ms = cuda_ms(lambda: cs.composite_surfel_bwd_torch(*bargs), reps=2)
    counts, ops, nbytes = b4_work(cs, args, exit_k, cfg)
    bound_ms, bound_by, ops_ms, bytes_ms = bound_of(ops, nbytes)
    log(f"B4 {name}: time {ms:.3f} ms  plain {plain_ms:.3f} ms  bound "
        f"{bound_ms:.4f} ms by {bound_by} (ops bound {ops_ms:.4f} ms: "
        f"{ops} float32 operations; bytes bound {bytes_ms:.4f} ms: {nbytes}"
        f" bytes); pairs replayed {counts['pairs']}, visits replayed "
        f"{counts['visits']}, in box "
        f"{counts['in_box']}, past the cuts {counts['past_cuts']}, "
        f"contributing {counts['contributing']}; pair-warp visits "
        f"{counts['pair_warps']}, kept by the cull "
        f"{counts['kept_pair_warps']}; chunks replayed "
        f"{int(exit_k.long().sum())}")
    return {"max_abs_err": max(r["max_abs"] for r in rows), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "rows": rows, "work": counts,
            "operations": ops, "bytes": nbytes}


def configs_2d(splats, cfg):
    """The 2D kernel checks' configurations: bench.py's scene in
    render_mode_2d with the default record precision, and with the depth
    channel (NC = 4) on the first N_DEPTH_2D splats."""
    from gaussiansplats3d_tpu_torch.io.optimize import take_splats
    c2d = cfg.replace(render_mode_2d=True)
    return [("2d-mixed", c2d, splats),
            ("2d-depth", c2d.replace(return_depth=True),
             take_splats(splats, slice(0, N_DEPTH_2D)))]


def check_b3_b4_all(cs, splats, cam, cfg):
    """check_b3 and check_b4 on both 2D configurations.  Each kernels-line
    entry takes its times and bound from the 2d-mixed configuration and
    its max_abs_err from the worst one."""
    entries = []
    for name, check, src, line in (
            ("surfel_fwd", check_b3, "surfel_fwd.cu", 130),
            ("surfel_bwd", check_b4, "surfel_bwd.cu", 232)):
        per_config = {n: check(cs, s, cam, n, c)
                      for n, c, s in configs_2d(splats, cfg)}
        main = per_config["2d-mixed"]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"gaussiansplats3d_tpu_torch/csrc/{src}",
            "replaces": f"gaussiansplats3d_tpu/render/pallas_surfel.py:{line}",
            "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in per_config.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "per_config": per_config})
    return entries


def launch_count(name: str) -> int:
    """A kernel's launches so far: its counter in the program's registry
    (``utils.metrics``; ``cuda_rasterize.LAUNCHES`` and the like)."""
    from gaussiansplats3d_tpu_torch.utils import metrics
    return metrics.total(name)


# path -> launches of the record gather's backward read there, for the
# {"gather_bwd": ...} line
GATHER_LAUNCHES = {}


def zero_gather():
    """Zero the record gather's backward's launch counter
    (``binning.LAUNCHES``, 2 a backward)."""
    from gaussiansplats3d_tpu_torch.render import binning
    from gaussiansplats3d_tpu_torch.utils import metrics
    metrics.reset(binning.LAUNCHES)


def gather_launches(path, expect):
    """The record gather's backward's launches since zero_gather(), added
    to GATHER_LAUNCHES under ``path``; raises unless ``expect``."""
    from gaussiansplats3d_tpu_torch.render import binning
    n = launch_count(binning.LAUNCHES)
    GATHER_LAUNCHES[path] = GATHER_LAUNCHES.get(path, 0) + n
    if n != expect:
        raise AssertionError(f"{path}: the record gather's backward "
                             f"launched {n} kernels, expected {expect}")
    return n


def kernel_launches(cr, cs):
    """(B1, B2, B3, B4) launch counts."""
    return tuple(launch_count(name) for name in (
        cr.LAUNCHES, cr.BWD_LAUNCHES, cs.LAUNCHES, cs.BWD_LAUNCHES))


def reset_all(cr, cs):
    cr.reset_launches()
    cs.reset_launches()


def main_path_2d(gt, cr, cs, splats, cam, cfg):
    """2D serving: RENDERS renders through render() under no_grad, the
    counters zeroed just before and read just after: B3 once a render, B1,
    B2, B4 and the record gather's backward never."""
    with torch.no_grad():
        gt.render(splats, cam, cfg)                 # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all(cr, cs)
        zero_gather()
        times, enqueue = [], []
        for _ in range(RENDERS):
            t0 = time.perf_counter()
            out = gt.render(splats, cam, cfg, return_aux=True)
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = kernel_launches(cr, cs)
        gather_launches(f"render_2d tile {cfg.tile_size}", 0)
    color, alpha = out["color"], out["alpha"]
    if color.shape != (HEIGHT, WIDTH, 3) or alpha.shape != (HEIGHT, WIDTH):
        raise AssertionError(f"2D image shapes {color.shape} {alpha.shape}")
    if not bool(torch.isfinite(color).all()):
        raise AssertionError("non-finite 2D color")
    amin, amax = float(alpha.min()), float(alpha.max())
    if not (amin >= 0.0 and amax <= 1.0 + 1e-5 and amax > 0.5):
        raise AssertionError(f"2D alpha range {amin} {amax}")
    res = {"median_ms": float(np.median(times)), "times_ms": times,
           "enqueue_median_ms": float(np.median(enqueue)),
           "num_pairs": int(out["num_pairs"]),
           "overflow": int(out["overflow"]),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches_b1_b2_b3_b4": launches,
           "alpha_mean": float(alpha.mean()), "alpha_range": [amin, amax]}
    log(f"2D main path: median {res['median_ms']:.2f} ms over {RENDERS} "
        f"renders ({', '.join(f'{x:.2f}' for x in times)}), enqueue median "
        f"{res['enqueue_median_ms']:.2f} ms; num_pairs {res['num_pairs']} "
        f"overflow {res['overflow']}; peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; (B1, B2, B3, B4) "
        f"launches {launches}; alpha mean {res['alpha_mean']:.4f}")
    if res["overflow"]:
        log(f"2D main path: overflow {res['overflow']} pairs dropped at the "
            f"default aux_multiplier {cfg.aux_multiplier}")
    if launches != (0, 0, RENDERS, 0):
        raise AssertionError(f"(B1, B2, B3, B4) launched {launches} times "
                             f"in {RENDERS} 2D renders")
    return res


def stage_breakdown_2d(splats, cam, cfg):
    """Milliseconds of each stage of one 2D render (CUDA events)."""
    from gaussiansplats3d_tpu_torch.render import pipeline, surfel
    with torch.no_grad():
        sp = surfel.project_surfels(splats, cam, cfg)
        binned = surfel.bin_sort_surfels(sp, cfg)
        comp = surfel.composite_surfels_sorted(cfg, *binned[:3], 0,
                                               cfg.num_tiles)
        stages = {
            "project_surfels": cuda_ms(
                lambda: surfel.project_surfels(splats, cam, cfg), 3),
            "bin_sort_surfels": cuda_ms(
                lambda: surfel.bin_sort_surfels(sp, cfg), 3),
            "composite_surfels_sorted (B3)": cuda_ms(
                lambda: surfel.composite_surfels_sorted(
                    cfg, *binned[:3], 0, cfg.num_tiles), 3),
            "assembly": cuda_ms(lambda: pipeline.assemble_image(
                surfel.chans_from_colors_logt(*comp), cfg), 3),
        }
    log("stages 2d (ms): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in stages.items()))
    return stages


def train_path_2d(gt, cr, cs, splats, cam, cfg):
    """bench.py's step in 2D: STEPS timed steps after a warm-up, the
    counters zeroed just before and read just after: B3 and B4 once a
    step, the record gather's backward's 2 kernels once, B1 and B2 never.
    Every gradient finite and nonzero but
    scales[:, 2], which surfels never read: exactly 0."""
    s = grad_splats(gt, splats)
    grad_step(gt, s, cam, cfg)                      # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all(cr, cs)
    zero_gather()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        grad_step(gt, s, cam, cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = kernel_launches(cr, cs)
    gather_n = gather_launches(f"train_step_2d tile {cfg.tile_size}",
                               2 * STEPS)
    grads = {}
    for f in FIELDS:
        g = getattr(s, f).grad
        if g is not None and f == "scales":
            if float(g[:, 2].abs().max()) != 0.0:
                raise AssertionError("2D: scales[:, 2] has a gradient")
            g = g[:, :2]
        if g is None or not bool(torch.isfinite(g).all()) \
                or float(g.abs().max()) == 0.0:
            raise AssertionError(f"2D gradient of {f} is missing, "
                                 f"non-finite or zero")
        grads[f] = float(g.abs().max())
    med = float(np.median(times))
    res = {"median_ms": med, "times_ms": times,
           "msplats_per_s": N_SPLATS / (med / 1e3) / 1e6,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches_b1_b2_b3_b4": launches,
           "launches_gather_bwd": gather_n, "grad_max_abs": grads}
    log(f"2D train step: median {med:.2f} ms over {STEPS} steps "
        f"({', '.join(f'{x:.2f}' for x in times)}); "
        f"{res['msplats_per_s']:.3f} Msplats/s; peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; (B1, B2, B3, B4) "
        f"launches {launches}, gather_bwd launches {gather_n}; max |grad| "
        + ", ".join(f"{k} {v:.3e}" for k, v in grads.items())
        + "; scales[:, 2] exactly 0")
    if launches != (0, 0, STEPS, STEPS):
        raise AssertionError(f"(B1, B2, B3, B4) launched {launches} times "
                             f"in {STEPS} 2D steps")
    return res


def fit_2d(gt, cs, device, steps=11):
    """A small 2D fit through make_train_step, as tests/test_sharded.py's
    test_train_step_2d_surfel_reduces_loss: flat surfels (scales[:, 2] =
    1e-6), 64x64, 256 splats, Adam at 2e-2 towards another scene's
    render; the loss must fall below 0.9 of the first step's, B3 and B4
    once a step."""
    from gaussiansplats3d_tpu_torch.parallel import train

    def flat(seed):
        arrays = fit_scene(256, seed)
        arrays[1][:, 2] = 1e-6
        return gt.SplatData.from_numpy(*arrays, device=device)

    cfg = gt.RenderConfig(width=64, height=64, sort_bits=14,
                          render_mode_2d=True)
    cam = gt.Camera.look_at((2.4, 1.5, 2.2), (0, 0, 0), fov_y_deg=60.0,
                            device=device)
    with torch.no_grad():
        target = gt.render(flat(11), cam, cfg)["color"]
    tiles, mask = train.image_to_tile_blocks(target, cfg)
    state = train.TrainState.create(flat(12), train.adam(2e-2))
    step = train.make_train_step(cfg, None, train.adam(2e-2))
    cs.reset_launches()
    losses = []
    for _ in range(steps):
        state, m = step(state, cam, tiles, mask)
        losses.append(float(m["loss"]))
    launches = (launch_count(cs.LAUNCHES), launch_count(cs.BWD_LAUNCHES))
    log(f"2D fit (64x64, 256 surfels, {steps} Adam steps): losses "
        f"{[round(v, 6) for v in losses]}, (B3, B4) launches {launches}")
    if not (np.isfinite(losses).all() and losses[-1] < 0.9 * losses[0]):
        raise AssertionError(f"2D fit did not reduce the loss: {losses}")
    if launches != (steps, steps):
        raise AssertionError(f"2D fit launched (B3, B4) {launches} times")
    return losses


def small_2d(gt, device):
    """At 3000 splats, 256x192, 2D with the depth channel and f32 records:
    the CUDA render against the port's render_2d oracle on the card and
    against the CPU render (images), and the gradients of mean(color^2) +
    mean(depth^2) over a background against the CPU's (each field
    normalised by its max |CPU|), by error mass (p99.9 <= 1e-3, <= 0.1%
    over 1e-2)."""
    from gaussiansplats3d_tpu_torch.render.surfel import render_2d
    cfg = gt.RenderConfig(width=256, height=192, sh_degree=SH_DEGREE,
                          return_depth=True, render_mode_2d=True,
                          record_precision="f32", background=(0.2, 0.3, 0.4))
    outs, grads = {}, {}
    for dev in (device, "cpu"):
        gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
        s = gt.random_splats(gen, 3000, sh_degree=SH_DEGREE, device="cpu")
        s = gt.SplatData(*(getattr(s, f).to(dev).requires_grad_(True)
                           for f in FIELDS))
        cam = gt.Camera.look_at((2.5, 1.5, 2.5), (0, 0, 0), fov_y_deg=60.0,
                                aspect=256 / 192, device=dev)
        out = gt.render(s, cam, cfg)
        ((out["color"] ** 2).mean() + (out["depth"] ** 2).mean()).backward()
        outs[str(dev)] = {k: v.detach().cpu() for k, v in out.items()}
        grads[str(dev)] = {f: getattr(s, f).grad.cpu() for f in FIELDS}
        if dev == device:
            with torch.no_grad():
                oracle = {k: v.cpu() for k, v in render_2d(s, cam,
                                                           cfg).items()}
    got = outs[str(device)]
    for ref_name, ref in (("oracle", oracle), ("cpu", outs["cpu"])):
        for k in ("color", "alpha", "depth"):
            _, p999, over = error_mass(got[k], ref[k])
            log(f"small 2D render vs {ref_name} {k}: p99.9 {p999:.3e} share "
                f"over 1e-2 {over:.3e}")
            if not (p999 <= 1e-3 and over <= 1e-3):
                raise AssertionError(f"small 2D render {k} vs {ref_name}")
    for f in FIELDS:
        ref = grads["cpu"][f]
        scale = float(ref.abs().max())
        _, p999, over = error_mass(grads[str(device)][f] / scale, ref / scale)
        log(f"small 2D gradients vs cpu {f}: p99.9 {p999:.3e} share over "
            f"1e-2 {over:.3e} (max |cpu| {scale:.3e})")
        if not (p999 <= 1e-3 and over <= 1e-3):
            raise AssertionError(f"small 2D gradient {f} vs cpu")


# --- the tools slice ---------------------------------------------------------

def b5_work(cr, pairs, exit_k, cfg):
    """What B5's `full` variant needs on these records: B1's tiers up to
    the cut-offs on the visits before its exit, then per contributing visit
    the clamp, w = alpha excl T, excl *= 1 - alpha and the three colour
    FMAs, and per pixel and chunk T = max(T excl, floor); and, as for B1,
    the pair-warp visits its per-warp cull keeps (cull_counts)."""
    counts, total = visit_counts(cr, pairs, exit_k, cfg)
    p, t = cfg.tile_size ** 2, cfg.num_tiles
    ops = (tier_ops(counts) + counts["contributing"] * OPS_B5_BLEND
           + int(exit_k.long().sum()) * p * OPS_B5_CHUNK)
    # records of the pairs composited, read once; starts, counts and ids;
    # colors [T, P, 3], t [T, P] and exit_k written once
    nbytes = (total * 11 * 4 + 3 * t * 4 + t * p * 3 * 4 + t * p * 4
              + t * 4)
    counts.update(cull_counts(pairs.records, (0, 1, 9, 10), cr.CHUNK,
                              pairs.tile_starts, pairs.tile_counts, exit_k,
                              cfg))
    return counts, ops, nbytes


def timed_once(fn):
    """(fn(), its milliseconds on the card by CUDA events) for one call."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def check_b5_all(kb, cr, splats, cam, cfg):
    """Every variant of B5 against its plain version on the render-mixed
    records: colors and T by error mass, each normalised by the plain
    version's max (p99.9 <= 1e-3, <= 0.1% over 1e-2), exit_k equal on >=
    99% of tiles; each variant's time (CUDA events), its plain version's
    time (one call) and its mean exit_k; `full`'s bound from the work its
    data needs and the pair-warp visits its cull keeps; B1's time on the
    same records beside `full`'s.  Launches made here are comparisons, not
    the path's."""
    from gaussiansplats3d_tpu_torch.render.binning import bin_sort_records
    from gaussiansplats3d_tpu_torch.render.projection import project_splats
    with torch.no_grad():
        pairs = bin_sort_records(project_splats(splats, cam, cfg), cfg)
    ids = torch.arange(cfg.num_tiles, dtype=torch.int32,
                       device=splats.device)
    args = (pairs.records, pairs.tile_starts, pairs.tile_counts, ids, cfg)
    variants = {}
    for v in kb.VARIANTS:
        colors, trans, exit_k = kb.variant_cuda(*args, v)
        torch.cuda.synchronize()
        ref, plain_ms = timed_once(
            lambda: kb.composite_variant_torch(*args, v))
        err = {}
        for field, a, b in (("colors", colors, ref[0]),
                            ("t", trans, ref[1])):
            scale = max(float(b.abs().max()), 1e-30)
            mx, p999, over = error_mass(a / scale, b / scale)
            err[field] = {"max_abs": float((a - b).abs().max()),
                          "max_norm": mx, "p999_norm": p999,
                          "over_1e-2": over, "scale": scale}
            if not (p999 <= BAR_P999["chans"] and over <= BAR_OVER):
                raise AssertionError(f"B5 {v} disagrees with its plain "
                                     f"version on {field}: {err[field]}")
        agree = float((exit_k == ref[2]).double().mean())
        if agree < BAR_EXIT_AGREE:
            raise AssertionError(f"B5 {v} exit_k agrees on only {agree}")
        ms = cuda_ms(lambda: kb.variant_cuda(*args, v), reps=10)
        mean_exit = float(exit_k.double().mean())
        # VARIANTS starts with `full`
        share = ms / variants["full"]["ms"] if variants else 1.0
        variants[v] = {"ms": ms, "plain_ms": plain_ms,
                       "mean_exit_k": mean_exit, "exit_k_agree": agree,
                       "share_of_full": share, "errors": err}
        log(f"B5 {v:12s}: time {ms:.3f} ms ({share:.3f} of full)  plain "
            f"{plain_ms:.1f} ms  mean "
            f"exit_k {mean_exit:.3f}  exit_k equal on {agree:.6f}; colors "
            f"p99.9 {err['colors']['p999_norm']:.3e} (of max "
            f"{err['colors']['scale']:.3e}), t p99.9 "
            f"{err['t']['p999_norm']:.3e}")
        if v == "full":
            counts, ops, nbytes = b5_work(cr, pairs, exit_k, cfg)
            bound = bound_of(ops, nbytes)
    full = variants["full"]
    # B1 on the same records, in the same phase: the kernel B5 splits
    b1_ms = cuda_ms(lambda: cr.composite_fwd_cuda(*args), reps=10)
    kept_share = counts["kept_pair_warps"] / max(counts["pair_warps"], 1)
    log(f"B5 full: bound {bound[0]:.4f} ms by {bound[1]} (ops bound "
        f"{bound[2]:.4f} ms: {ops} float32 operations; bytes bound "
        f"{bound[3]:.4f} ms: {nbytes} bytes); pairs visited "
        f"{counts['pairs']}, in box {counts['in_box']}, in cut-off "
        f"{counts['in_cutoff']}, contributing {counts['contributing']}; "
        f"pair-warp visits {counts['pair_warps']}, kept by the cull "
        f"{counts['kept_pair_warps']} ({kept_share:.4f})")
    log(f"B5 full {full['ms']:.3f} ms beside B1 on the same records "
        f"{b1_ms:.3f} ms ({full['ms'] / b1_ms:.3f} of B1)")
    return {"name": "kernel_bench", "route": "cuda",
            "source": "gaussiansplats3d_tpu_torch/csrc/kernel_bench.cu",
            "replaces": "gaussiansplats3d_tpu/tools/kernel_bench.py:45",
            "launches": None,
            "max_abs_err": max(e["max_abs"] for r in variants.values()
                               for e in r["errors"].values()),
            "ms": full["ms"], "plain_ms": full["plain_ms"],
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "variants": variants, "work": counts, "operations": ops,
            "bytes": nbytes, "kept_pair_warp_share": kept_share,
            "b1_ms_same_records": b1_ms}


def all_launches(cr, cs, kb):
    """(B1, B2, B3, B4, B5) launch counts."""
    return kernel_launches(cr, cs) + (launch_count(kb.LAUNCHES),)


def tool_path(name, fn, cr, cs, kb):
    """Drive one tool with every counter zeroed just before and read just
    after; its standard output is logged.  Returns (fn's result, (B1..B5)
    launches, seconds)."""
    reset_all(cr, cs)
    kb.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = fn()
    secs = time.perf_counter() - t0
    launches = all_launches(cr, cs, kb)
    for line in buf.getvalue().strip().splitlines():
        log(f"  {name}: {line}")
    log(f"{name}: {secs:.1f} s; (B1, B2, B3, B4, B5) launches {launches}")
    return result, launches, secs, buf.getvalue()


def tools_slice(cr, cs, kb):
    """The tools' entry points on the card, each with the counters zeroed
    just before and read just after: kernel_bench (B5 on every variant,
    then B1 and B2 alone), profile_stages (B1, B2), gpu_parity (B1-B4;
    must return 0), bench_configs (accept1-3 at full size; the
    reference-bytes runs at N_REF_BYTES)."""
    from gaussiansplats3d_tpu_torch.tools import (bench_configs, gpu_parity,
                                                  kernel_bench,
                                                  profile_stages)
    out = {}
    rc, launches, secs, text = tool_path(
        "kernel_bench", lambda: kernel_bench.main([]), cr, cs, kb)
    for v in kb.VARIANTS:
        if f"  {v} " not in text:
            raise AssertionError(f"kernel_bench printed no line for {v}")
    if rc != 0 or "REAL fwd" not in text or "REAL bwd" not in text:
        raise AssertionError("kernel_bench did not run to its end")
    if launches[4] == 0 or launches[0] == 0 or launches[1] == 0:
        raise AssertionError(f"kernel_bench launched (B1..B5) {launches}")
    out["kernel_bench"] = {"launches": launches, "seconds": secs,
                           "lines": text.strip().splitlines()}

    rc, launches, secs, text = tool_path(
        "profile_stages", lambda: profile_stages.main([]), cr, cs, kb)
    if rc != 0 or "Msplats/s" not in text:
        raise AssertionError("profile_stages did not run to its end")
    if launches[0] == 0 or launches[1] == 0 or launches[4] != 0:
        raise AssertionError(f"profile_stages launched (B1..B5) {launches}")
    out["profile_stages"] = {"launches": launches, "seconds": secs,
                             "lines": text.strip().splitlines()}

    rc, launches, secs, text = tool_path(
        "gpu_parity", gpu_parity.main, cr, cs, kb)
    if rc != 0 or "GPU kernel parity: OK" not in text:
        raise AssertionError(f"gpu_parity returned {rc}")
    if 0 in launches[:4] or launches[4] != 0:
        raise AssertionError(f"gpu_parity launched (B1..B5) {launches}")
    out["gpu_parity"] = {"launches": launches, "seconds": secs}

    recs, launches, secs, text = tool_path(
        "bench_configs", lambda: bench_configs.run_all(
            ref_splats=N_REF_BYTES), cr, cs, kb)
    names = [r["config"] for r in recs]
    if not (recs[0]["oracle_ok"] and all(r.get("ok", True) for r in recs)
            and names[:3] == ["accept1_oracle", "accept2_truck_shaped",
                              "accept3_garden_shaped"]):
        raise AssertionError(f"bench_configs: {recs}")
    if launches[0] == 0 or launches[1] == 0 or launches[4] != 0:
        raise AssertionError(f"bench_configs launched (B1..B5) {launches}")
    out["bench_configs"] = {"launches": launches, "seconds": secs,
                            "records": recs}
    return out


def viewer_splats(gt, n, seed, device):
    """n random splats from `seed`, SH1, in [-1.5, 1.5]^3 at bench.py's
    scan-like sizes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s = gt.random_splats(gen, n, sh_degree=SH_DEGREE, extent=1.5,
                         device=device)
    s.scales = s.scales * 0.15
    return s


def frame_fade(v):
    """The fade state the viewer's last frame drew: None once the fade is
    complete or in Instant mode."""
    from gaussiansplats3d_tpu_torch.viewer import SceneRevealMode
    vr = v.visible_region
    if vr.complete or v.scene_reveal_mode == SceneRevealMode.Instant:
        return None
    return vr.center.copy(), float(vr.fade_start_radius)


def direct_inputs(v):
    """What the viewer's frame draws, built by this script from its scenes:
    the viewer's own concatenated splats, each scene's transform composed
    from its position, rotation and scale, the scene index of every splat,
    the opacities and visibility, and the fade."""
    from gaussiansplats3d_tpu_torch.core import math3d
    splats, _ = v._concat()
    scenes = [v.get_splat_scene(i) for i in range(v.scene_count)]
    dev = v.device
    sizes = torch.tensor([s.num_splats for s in scenes], device=dev)
    return splats, {
        "transforms": torch.stack([math3d.compose_transform(
            s.position, s.quaternion, s.scale, device="cpu")
            for s in scenes]).to(dev),
        "scene_indices": torch.repeat_interleave(
            torch.arange(len(scenes), dtype=torch.int32, device=dev), sizes),
        "scene_opacities": torch.tensor([s.opacity for s in scenes],
                                        device=dev),
        "scene_visibility": torch.tensor([s.visible for s in scenes],
                                         device=dev),
        "fade_params": frame_fade(v)}


def direct_render(gt, v, cam):
    """render() (render_2d_tiled in 2D) of direct_inputs at `cam`."""
    from gaussiansplats3d_tpu_torch.render import pipeline
    splats, kw = direct_inputs(v)
    if v.config.render_mode_2d:
        kw.pop("fade_params")
        return pipeline.render_2d_tiled(splats, cam, v.config, **kw)
    return gt.render(splats, cam, v.config, **kw)


class ViewerChecks:
    """Every phase-10 frame against its direct render; the largest
    difference seen."""

    def __init__(self, gt):
        self.gt = gt
        self.frames = 0
        self.max_abs = 0.0
        self.worst_p999 = 0.0

    def check(self, name, v, out, cam=None):
        cam = cam if cam is not None else v._current_camera(None)
        with torch.no_grad():
            ref = direct_render(self.gt, v, cam)
        for key in ("color", "alpha"):
            mx, p999, over = error_mass(out[key], ref[key])
            self.max_abs = max(self.max_abs, mx)
            self.worst_p999 = max(self.worst_p999, p999)
            if not (p999 <= BAR_P999["chans"] and over <= BAR_OVER):
                raise AssertionError(f"viewer frame {name} differs from its "
                                     f"direct render in {key}: max {mx} "
                                     f"p99.9 {p999} over {over}")
        self.frames += 1
        return ref


# (B1, B2, B3, B4, B5) launches of one 3D viewer frame, a stereo pair and
# one 2D viewer frame
ONE_3D = (1, 0, 0, 0, 0)
PAIR_3D = (2, 0, 0, 0, 0)
ONE_2D = (0, 0, 1, 0, 0)


class Tally:
    """The counters of B1-B5 around each viewer step: zeroed just before,
    read (after a synchronize) just after, and the readings summed per
    viewer path for the kernels line."""

    def __init__(self, cr, cs, kb):
        self.cr, self.cs, self.kb = cr, cs, kb
        self.by_path = {}

    def add(self, path, launches):
        old = self.by_path.get(path, (0,) * 5)
        self.by_path[path] = tuple(a + b for a, b in zip(old, launches))

    def __call__(self, path, fn, expect, name):
        """fn(), its launches added to `path`; raises unless (B1, ..., B5)
        == expect."""
        reset_all(self.cr, self.cs)
        self.kb.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = all_launches(self.cr, self.cs, self.kb)
        self.add(path, launches)
        if launches != expect:
            raise AssertionError(f"{name}: (B1, B2, B3, B4, B5) launched "
                                 f"{launches}, expected {expect}")
        return out


def wall_ms(fn):
    """(fn(), host milliseconds until it and the device are done)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_diff(a, b):
    return float((a["color"] - b["color"]).abs().max())


def predicted_fade_frames(vr):
    """Frames until the reveal fade completes from its current state, by
    host arithmetic on fade.py's constants (a final build: the fast
    rate)."""
    from gaussiansplats3d_tpu_torch.viewer import fade
    rate = fade.SCENE_FADEIN_RATE_FAST * vr.fade_in_rate_multiplier
    start, k = vr.fade_start_radius, 0
    while True:
        k += 1
        start += (vr.radius - start) * rate
        if start / vr.buffer_radius > fade.FADE_COMPLETE_PERCENT:
            return k


def load_scenes(gt, tally, v, s0, tmp, chk):
    """S0 in memory, S1 by path, S2 progressively; the load timings, S2's
    partial frames, every decode native."""
    from gaussiansplats3d_tpu_torch import io as gio
    from gaussiansplats3d_tpu_torch.io import native
    res = {}
    v.add_splat_scene(s0)
    out = tally("viewer_3d", v.render, ONE_3D, "viewer S0 frame")
    chk.check("S0", v, out)

    s1 = viewer_splats(gt, N_S1, SEED + 1, v.device)
    s1_path = os.path.join(tmp, "s1.ksplat")
    t0 = time.perf_counter()
    gio.save_ksplat(s1, s1_path, compression_level=1)
    res["s1_write_s"] = time.perf_counter() - t0
    del s1
    torch.cuda.synchronize()
    native.reset_counts()
    t0 = time.perf_counter()
    v.add_splat_scene(s1_path, position=(3.2, 0.0, 0.0),
                      rotation=(0.0, 0.38268343, 0.0, 0.92387953),
                      scale=(0.8, 0.8, 0.8))
    res["s1_add_ms"] = (time.perf_counter() - t0) * 1e3
    out = tally("viewer_3d", v.render, ONE_3D, "viewer S0+S1 frame")
    res["s1_load_to_first_frame_ms"] = (time.perf_counter() - t0) * 1e3
    res["s1_decodes"] = expect_decodes("S1's add_splat_scene", "ksplat",
                                       "native")
    chk.check("S0+S1", v, out)

    s2_path = os.path.join(tmp, "s2.ply")
    gio.save_ply(viewer_splats(gt, N_S2, SEED + 2, v.device), s2_path)
    snaps, partial = [0], {"frames": 0, "check_s": 0.0}
    native.reset_counts()
    t0 = time.perf_counter()

    def on_update(scene, fraction):
        snaps[0] += 1
        if (snaps[0] - 1) % PARTIAL_EVERY:
            return
        out = tally("viewer_3d", v.render, ONE_3D,
                    f"S2 partial frame at {fraction:.3f}")
        if partial["frames"] == 0:
            partial["first_ms"] = (time.perf_counter() - t0) * 1e3
            partial["first_splats"] = scene.num_splats
        partial["frames"] += 1
        t1 = time.perf_counter()
        chk.check(f"S2 partial at {fraction:.3f}", v, out)
        partial["check_s"] += time.perf_counter() - t1

    s2 = v.add_splat_scene_progressive(s2_path, on_update=on_update,
                                       position=(-3.2, 0.0, 0.0))
    out = tally("viewer_3d", v.render, ONE_3D, "viewer S2 final frame")
    res["s2_final_frame_ms"] = ((time.perf_counter() - t0)
                                - partial["check_s"]) * 1e3
    res["s2_decodes"] = expect_decodes("S2's progressive load", "ply",
                                       "native")
    chk.check("S2 final", v, out)
    if s2.num_splats != N_S2 or partial["frames"] == 0:
        raise AssertionError(f"S2 has {s2.num_splats} splats and "
                             f"{partial['frames']} partial frames")
    # the same stream through a ProgressiveLoader alone, on each decode
    # path: what of S2's load is the host's fetch, copies and decodes
    res["s2_stream"] = {p: stream_split(s2_path, v.device, p)
                        for p in ("native", "numpy")}
    res["s2_stream_decode_ms"] = res["s2_stream"]["native"]["total_ms"]
    res.update({"s2_snapshots": snaps[0],
                "s2_partial_frames": partial["frames"],
                "s2_first_partial_frame_ms": partial["first_ms"],
                "s2_first_partial_splats": partial["first_splats"],
                "s2_file_bytes": os.path.getsize(s2_path)})
    log(f"viewer loads: S1 ({N_S1} splats, .ksplat level 1) written in "
        f"{res['s1_write_s']:.2f} s, added in {res['s1_add_ms']:.1f} ms, "
        f"load to first frame {res['s1_load_to_first_frame_ms']:.1f} ms; "
        f"S2 ({N_S2} splats, {res['s2_file_bytes']} B .ply) "
        f"{res['s2_snapshots']} snapshots, first partial frame "
        f"({res['s2_first_partial_splats']} splats) at "
        f"{res['s2_first_partial_frame_ms']:.1f} ms, final frame at "
        f"{res['s2_final_frame_ms']:.1f} ms ({partial['frames']} partial "
        f"frames; {partial['check_s']:.2f} s of their checks left out); "
        f"every decode native (S1 {res['s1_decodes']['ksplat']}, S2 "
        f"{res['s2_decodes']['ply']})")
    for p, r in res["s2_stream"].items():
        log(f"S2's stream through a ProgressiveLoader alone, {p} decodes: "
            f"{r['total_ms']:.1f} ms = buffer copies for the header "
            f"{r['copy_ms']:.1f} + header parses {r['header_ms']:.1f} "
            f"({r['header_calls']} calls) + decodes with the upload "
            f"{r['decode_ms']:.1f} ({r['decode_calls']} calls) + the rest "
            f"(reads, feeds, the snapshots' own copies) {r['rest_ms']:.1f}")
    NATIVE["viewer"] = {k: res[k] for k in (
        "s1_load_to_first_frame_ms", "s2_first_partial_frame_ms",
        "s2_final_frame_ms", "s2_stream", "s1_decodes", "s2_decodes")}
    return res, s1_path, s2_path


def expect_decodes(what, fmt, path):
    """The decode counters since their last reset; raises unless `fmt` was
    decoded, and every decode took `path` ('native' or 'numpy')."""
    from gaussiansplats3d_tpu_torch.io import native
    counts = native.decode_counts()
    other = "numpy" if path == "native" else "native"
    if counts[fmt][path] == 0 or any(c[other] for c in counts.values()):
        raise AssertionError(f"{what}: decodes {counts}, expected every one "
                             f"{path} ({native.status()})")
    return counts


@contextlib.contextmanager
def time_calls(**targets):
    """Within the block every call of each target, name=(owner, attribute),
    adds its host ms and one call to spent[name] = [ms, calls]."""
    spent = {k: [0.0, 0] for k in targets}
    saved = []
    for key, (owner, attr) in targets.items():
        orig = getattr(owner, attr)

        def wrap(*a, _orig=orig, _key=key, **kw):
            t0 = time.perf_counter()
            try:
                return _orig(*a, **kw)
            finally:
                spent[_key][0] += (time.perf_counter() - t0) * 1e3
                spent[_key][1] += 1
        saved.append((owner, attr, orig))
        setattr(owner, attr, wrap)
    try:
        yield spent
    finally:
        for owner, attr, orig in saved:
            setattr(owner, attr, orig)


@contextlib.contextmanager
def decode_path(path):
    """GS_NATIVE for the block: the native decoders or the numpy ones."""
    old = os.environ.get("GS_NATIVE")
    os.environ["GS_NATIVE"] = "1" if path == "native" else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["GS_NATIVE"]
        else:
            os.environ["GS_NATIVE"] = old


def stream_split(path, device, decoder):
    """A .ply streamed through a ProgressiveLoader alone (fetch's 256 KiB
    chunks, a snapshot tried after each) with `decoder`'s decodes, split
    by host clock into the buffer copies made to read the header
    (ProgressiveLoader._ply_stream_info less the parse), the header
    parses (ply.streamable_ply_info), the decodes with their upload
    (ply.parse_ply_inria_v1, the final one too) and the rest."""
    from gaussiansplats3d_tpu_torch.io import fetch, ply
    from gaussiansplats3d_tpu_torch.io import native
    from gaussiansplats3d_tpu_torch.io.progressive import ProgressiveLoader
    loader = ProgressiveLoader.for_path(path, device=device)
    snaps = [0]

    def feed(_pct, _label, chunk, _total):
        loader.feed(chunk)
        snaps[0] += loader.snapshot() is not None

    native.reset_counts()
    with decode_path(decoder), time_calls(
            info=(ProgressiveLoader, "_ply_stream_info"),
            header=(ply, "streamable_ply_info"),
            decode=(ply, "parse_ply_inria_v1")) as spent:
        _, total = wall_ms(lambda: (fetch.fetch_with_progress(path, feed),
                                    loader.finalize()))
    expect_decodes(f"S2's stream, {decoder}", "ply", decoder)
    return {"total_ms": total, "snapshots": snaps[0],
            "copy_ms": spent["info"][0] - spent["header"][0],
            "header_ms": spent["header"][0], "header_calls": spent["header"][1],
            "decode_ms": spent["decode"][0], "decode_calls": spent["decode"][1],
            "rest_ms": total - spent["info"][0] - spent["decode"][0]}


def run_fade(tally, v, chk):
    """The reveal fade to its end: one frame a tick, each checked; it must
    end on the frame host arithmetic predicts, within MAX_FADE_FRAMES."""
    vr = v.visible_region
    predicted = predicted_fade_frames(vr)
    if predicted > MAX_FADE_FRAMES:
        raise AssertionError(f"the fade needs {predicted} frames")
    frames = 0
    while not vr.complete:
        if frames == MAX_FADE_FRAMES:
            raise AssertionError("the fade did not complete")
        out = tally("viewer_3d", v.render, ONE_3D, "fade frame")
        frames += 1
        chk.check(f"fade frame {frames}", v, out)
    if frames != predicted:
        raise AssertionError(f"the fade completed after {frames} frames, "
                             f"host arithmetic predicts {predicted}")
    if vr.tick(v.scene_reveal_mode) is not None:
        raise AssertionError("tick returned a fade after completion")
    log(f"viewer fade: completed on frame {frames} as predicted (rate "
        f"multiplier {FADE_MULTIPLIER})")
    return frames


def dynamic_frames(tally, v, chk):
    """Change S1's position, S2's opacity and S0's visibility between
    frames: each re-renders (B1 once), differs from the frame before and
    equals its direct render; then the scenes go back."""
    s0, s1, s2 = (v.get_splat_scene(i) for i in range(3))
    changes = (("S1 moved", s1, "position", (3.2, 0.6, -0.4)),
               ("S2 opacity 0.5", s2, "opacity", 0.5),
               ("S0 hidden", s0, "visible", False))
    olds = [getattr(scene, attr) for _, scene, attr, _ in changes]
    prev = tally("viewer_3d", v.render, ONE_3D, "before changes")
    chk.check("before changes", v, prev)
    for name, scene, attr, value in changes:
        setattr(scene, attr, value)
        out = tally("viewer_3d", v.render, ONE_3D, name)
        chk.check(name, v, out)
        if max_diff(out, prev) <= 1e-3:
            raise AssertionError(f"{name}: the frame did not change")
        prev = out
    for (_, scene, attr, _), old in zip(changes, olds):
        setattr(scene, attr, old)
    return ["before changes"] + [name for name, *_ in changes]


def viewer_timings(gt, tally, v, chk):
    """Viewer.render against render() on the same inputs, median of
    RENDERS each (RenderMode.Always, fade complete), and the stereo pair;
    every timed viewer frame and pair counted."""
    cam = v._current_camera(None)
    splats, kw = direct_inputs(v)
    with torch.no_grad():
        direct = [wall_ms(lambda: gt.render(splats, cam, v.config, **kw))
                  for _ in range(RENDERS)]
    viewer = [tally("viewer_3d", lambda: wall_ms(v.render), ONE_3D,
                    "timed viewer frame") for _ in range(RENDERS)]
    chk.check("timed viewer frame", v, viewer[-1][0])
    stereo = [tally("viewer_stereo",
                    lambda: wall_ms(lambda: v.render_stereo(0.064)), PAIR_3D,
                    "timed stereo pair") for _ in range(RENDERS)]
    res = {"viewer_ms": [t for _, t in viewer],
           "direct_ms": [t for _, t in direct],
           "stereo_ms": [t for _, t in stereo]}
    for k in list(res):
        res[k.replace("_ms", "_median_ms")] = float(np.median(res[k]))
    res["viewer_overhead_ms"] = (res["viewer_median_ms"]
                                 - res["direct_median_ms"])
    log(f"viewer timings at {VIEW_W}x{VIEW_H}: Viewer.render median "
        f"{res['viewer_median_ms']:.2f} ms ("
        f"{', '.join(f'{x:.2f}' for x in res['viewer_ms'])}), render() "
        f"median {res['direct_median_ms']:.2f} ms ("
        f"{', '.join(f'{x:.2f}' for x in res['direct_ms'])}): overhead "
        f"{res['viewer_overhead_ms']:.2f} ms; render_stereo median "
        f"{res['stereo_median_ms']:.2f} ms")
    return res


def stereo_check(tally, v, chk, eye_separation=0.064):
    """One counted stereo pair (B1 twice), each eye against its direct
    render at the eye's camera; the eyes differ."""
    gt = chk.gt
    pair = tally("viewer_stereo", lambda: v.render_stereo(eye_separation),
                 PAIR_3D, "stereo pair")
    cam = v._current_camera(None)
    right = torch.linalg.inv(cam.view)[:3, 0]
    for sign, eye in ((-0.5, "left"), (0.5, "right")):
        offset = right * (sign * eye_separation)
        t = torch.eye(4, device=cam.view.device)
        t[:3, 3] = -offset
        chk.check(f"stereo {eye}", v, pair[eye],
                  gt.Camera(view=cam.view @ t, proj=cam.proj,
                            cam_pos=cam.cam_pos + offset))
    d = max_diff(pair["left"], pair["right"])
    if d <= 1e-3:
        raise AssertionError(f"the stereo eyes do not differ ({d})")
    return d


def gating(tally, v, chk):
    """RenderMode.OnChange after the fade: a forced frame renders, a repeat
    and a sub-epsilon camera move reuse it, a move over the epsilon
    renders; RenderMode.Never renders nothing.  Returns each step's B1
    launches."""
    from gaussiansplats3d_tpu_torch.viewer import RenderMode
    v.render_mode = RenderMode.OnChange
    base = np.asarray(v.camera.position, np.float64).copy()
    steps = []

    def step(name, expect, move=None):
        if move is not None:
            v.camera.position = base + np.array([move, 0.0, 0.0])
        out = tally("viewer_3d", v.render, (expect, 0, 0, 0, 0), name)
        if expect:
            chk.check(name, v, out)
        steps.append((name, expect))

    v.force_render_next_frame()
    step("OnChange forced", 1)
    step("OnChange repeat", 0)
    step(f"OnChange {SMALL_MOVE} move", 0, SMALL_MOVE)
    step(f"OnChange {LARGE_MOVE} move", 1, SMALL_MOVE + LARGE_MOVE)
    v.render_mode = RenderMode.Never
    step("Never", 0)
    step("Never after a move", 0, 0.0)
    v.camera.position = base
    v.render_mode = RenderMode.Always
    log("viewer gating: " + ", ".join(f"{n} {e}" for n, e in steps))
    return steps


def viewer_b1(cr, v):
    """check_b1 on the records of the viewer's 4K frame: its concatenated
    splats, its camera and its scene inputs (fade complete)."""
    splats, kw = direct_inputs(v)
    return check_b1(cr, splats, v._current_camera(None), "viewer-4k",
                    v.config, kw)


def render_scene_b1(cr, s1_path, device):
    """check_b1 on the records of render_scene's first frame: the Viewer
    the tool builds for viewer_tools' arguments (its defaults: 1280x720,
    camera (3, 2, 3) at the origin, the reveal fade on), S1's .ksplat,
    one frame drawn."""
    from gaussiansplats3d_tpu_torch.viewer import Viewer
    v = Viewer(width=1280, height=720,
               max_spherical_harmonics_degree=SH_DEGREE,
               initial_camera_position=(3.0, 2.0, 3.0), device=device)
    v.add_splat_scene(s1_path)
    with torch.no_grad():
        v.render()
    splats, kw = direct_inputs(v)
    out = check_b1(cr, splats, v._current_camera(None), "render-scene-720p",
                   v.config, kw)
    v.dispose()
    return out


def viewer_2d(tally, v, chk):
    """A 2D viewer over the same three scenes: B3 once a frame, B1 never;
    its frame against render_2d_tiled, a timed frame, then check_b3 on the
    records of its frame.  Returns (frame ms, check_b3's result)."""
    from gaussiansplats3d_tpu_torch.viewer import (SceneRevealMode,
                                                   SplatRenderMode, Viewer)
    v2 = Viewer(width=VIEW_W, height=VIEW_H,
                max_spherical_harmonics_degree=SH_DEGREE,
                initial_camera_position=tuple(v.camera.position),
                splat_render_mode=SplatRenderMode.TwoD,
                scene_reveal_mode=SceneRevealMode.Instant, device=v.device)
    for i in range(v.scene_count):
        v2.add_splat_scene(v.get_splat_scene(i))
    out = tally("viewer_2d", v2.render, ONE_2D, "2D viewer frame")
    chk.check("2D", v2, out)
    _, ms = tally("viewer_2d", lambda: wall_ms(v2.render), ONE_2D,
                  "timed 2D viewer frame")
    splats, kw = direct_inputs(v2)
    kw.pop("fade_params")
    b3 = check_b3(tally.cs, splats, v2._current_camera(None), "viewer-2d-4k",
                  v2.config, kw)
    v2.dispose()
    log(f"viewer 2D frame: {ms:.2f} ms, alpha mean "
        f"{float(out['alpha'].mean()):.4f}")
    return ms, b3


def picking(v):
    """raycast through the image centre in sphere and ellipsoid mode,
    against the port's raycaster on CPU copies of the same splats,
    transforms, scene indices and ray."""
    from gaussiansplats3d_tpu_torch.viewer.raycaster import Ray, Raycaster
    cam = v._current_camera(None)
    x, y = VIEW_W / 2, VIEW_H / 2
    ray = Ray.from_camera_and_screen(cam, x, y, VIEW_W, VIEW_H)
    splats, kw = direct_inputs(v)
    cpu = splats.to("cpu")
    ray_cpu = Ray(ray.origin.cpu(), ray.direction.cpu())
    res = {}
    for ellipsoid in (False, True):
        v.raycaster.ellipsoid = ellipsoid
        hit, ms = wall_ms(lambda: v.raycast(x, y))
        ref = Raycaster(ellipsoid).intersect(
            ray_cpu, cpu, kw["transforms"].cpu(), kw["scene_indices"].cpu())
        mode = "ellipsoid" if ellipsoid else "sphere"
        if hit is None or ref is None:
            raise AssertionError(f"raycast ({mode}) missed: {hit} {ref}")
        if ((hit.splat_index, hit.scene_index)
                != (ref.splat_index, ref.scene_index)
                or abs(hit.t - ref.t) > 1e-4 * abs(ref.t)):
            raise AssertionError(f"raycast ({mode}) {hit} against the CPU's "
                                 f"{ref}")
        res[mode] = {"ms": ms, "splat_index": hit.splat_index,
                     "scene_index": hit.scene_index, "t": hit.t,
                     "t_cpu": ref.t}
        log(f"viewer raycast ({mode}): {ms:.2f} ms, splat "
            f"{hit.splat_index} of scene {hit.scene_index} at t {hit.t:.6f}"
            f" (CPU {ref.t:.6f})")
    v.raycaster.ellipsoid = False
    return res


def viewer_tools(tally, s1_path, s2_path, tmp):
    """render_scene on S1's .ksplat (B1 once a frame) and create_ksplat of
    S2's .ply at level 2, whose bytes must equal save_ksplat's of the same
    load with the tool's settings."""
    from gaussiansplats3d_tpu_torch import io as gio
    from gaussiansplats3d_tpu_torch.tools import create_ksplat, render_scene
    frames = 8
    out_png = os.path.join(tmp, "frame.png")
    rc, launches, secs, text = tool_path(
        "render_scene", lambda: render_scene.main(
            [s1_path, out_png, "--sh", "1", "--frames", str(frames)]),
        tally.cr, tally.cs, tally.kb)
    tally.add("render_scene", launches)
    written = [p for p in os.listdir(tmp) if p.startswith("frame_")]
    if rc != 0 or launches != (frames, 0, 0, 0, 0) or len(written) != frames:
        raise AssertionError(f"render_scene returned {rc}, launched "
                             f"{launches}, wrote {len(written)} frames")
    out_ks = os.path.join(tmp, "s2.ksplat")
    rc, ck_launches, ck_secs, _ = tool_path(
        "create_ksplat", lambda: create_ksplat.main([s2_path, out_ks, "2"]),
        tally.cr, tally.cs, tally.kb)
    tally.add("create_ksplat", ck_launches)
    ref_ks = os.path.join(tmp, "s2_ref.ksplat")
    gio.save_ksplat(gio.load(s2_path, device="cpu"), ref_ks,
                    compression_level=2, minimum_alpha=1)
    with open(out_ks, "rb") as a, open(ref_ks, "rb") as b:
        same = a.read() == b.read()
    if rc != 0 or any(ck_launches) or not same:
        raise AssertionError(f"create_ksplat returned {rc}, launched "
                             f"{ck_launches}, bytes equal {same}")
    return {"render_scene": {"launches": launches, "seconds": secs,
                             "frames": frames},
            "create_ksplat": {"seconds": ck_secs,
                              "bytes": os.path.getsize(out_ks)}}


def viewer_slice(gt, cr, cs, kb, s0, device):
    """Phase 10 (see the module docstring).  Returns its results and the
    (B1, ..., B5) launches of each viewer path, summed from the counters'
    readings."""
    from gaussiansplats3d_tpu_torch.viewer import Viewer
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    chk = ViewerChecks(gt)
    tally = Tally(cr, cs, kb)
    v = Viewer(width=VIEW_W, height=VIEW_H,
               max_spherical_harmonics_degree=SH_DEGREE,
               initial_camera_position=(0.0, 3.0, 9.0),
               scene_fade_in_rate_multiplier=FADE_MULTIPLIER, device=device)
    step_s = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        step_s[name] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        res, s1_path, s2_path = timed(
            "loads", lambda: load_scenes(gt, tally, v, s0, tmp, chk))
        res["splats"] = sum(v.get_splat_scene(i).num_splats
                            for i in range(v.scene_count))
        res["fade_frames"] = timed("fade", lambda: run_fade(tally, v, chk))
        res["dynamic"] = timed("dynamic",
                               lambda: dynamic_frames(tally, v, chk))
        res["timings"] = timed(
            "timings", lambda: viewer_timings(gt, tally, v, chk))
        res["stereo_eye_diff"] = timed(
            "stereo", lambda: stereo_check(tally, v, chk))
        res["gating"] = timed("gating", lambda: gating(tally, v, chk))
        res["b1_4k"] = timed("B1 at 4K", lambda: viewer_b1(cr, v))
        res["frame_2d_ms"], res["b3_4k"] = timed(
            "2d and B3 at 4K", lambda: viewer_2d(tally, v, chk))
        res["raycast"] = timed("picking", lambda: picking(v))
        res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        res["tools"] = timed("tools", lambda: viewer_tools(
            tally, s1_path, s2_path, tmp))
        res["b1_render_scene"] = timed(
            "B1 at render_scene's frame",
            lambda: render_scene_b1(cr, s1_path, device))
    v.dispose()
    res["frames_checked"] = chk.frames
    res["max_abs_diff_vs_direct"] = chk.max_abs
    res["seconds"] = time.perf_counter() - t_phase
    res["step_seconds"] = step_s
    res["launches_by_path"] = tally.by_path
    log("viewer slice steps (s): "
        + ", ".join(f"{k} {x:.2f}" for k, x in step_s.items()))
    log(f"viewer slice: {res['splats']} splats at {VIEW_W}x{VIEW_H}; "
        f"{chk.frames} frames against their direct renders, largest "
        f"|difference| {chk.max_abs:.3e} (worst p99.9 {chk.worst_p999:.3e})"
        f"; peak memory {res['peak_mem_bytes'] / 2**30:.2f} GiB; "
        f"{res['seconds']:.1f} s; (B1, B2, B3, B4, B5) launches read per "
        f"path {tally.by_path}")
    return res, tally.by_path


# --- phase 11: the multi-GPU slice on one card ------------------------------

def sharded_renders(gt, par, tally, mesh, splats, cam, cfg):
    """(a) sharded_render of the 2M scene on the 1x1 NCCL mesh under both
    routes and both slab modes against render(): B1 once a render."""
    with torch.no_grad():
        ref = gt.render(splats, cam, cfg)
        out = {}
        for route in ROUTES:
            sp = par.device_put_sharded_splats(splats, mesh, route)
            for mode in SLAB_MODES:
                name = f"{route}/{mode}"
                par.sharded_render(mesh, sp, cam, cfg, route=route,
                                   slab_mode=mode)       # warm-up
                times = []
                for _ in range(SHARDED_RENDERS):
                    img, ms = tally("sharded_render", lambda: wall_ms(
                        lambda: par.sharded_render(mesh, sp, cam, cfg,
                                                   route=route,
                                                   slab_mode=mode)),
                        (1, 0, 0, 0, 0), f"sharded_render {name}")
                    times.append(ms)
                errs = {k: error_mass(img[k], ref[k])
                        for k in ("color", "alpha")}
                log(f"sharded_render 1x1 {name}: median "
                    f"{float(np.median(times)):.2f} ms ({times}); against "
                    f"render(): " + ", ".join(
                        f"{k} max {e[0]:.3e} p99.9 {e[1]:.3e} over 1e-2 "
                        f"{e[2]:.3e}" for k, e in errs.items())
                    + f"; overflow {int(img['overflow'])}")
                for k, (_, p999, over) in errs.items():
                    if not (p999 <= BAR_P999["chans"] and over <= BAR_OVER):
                        raise AssertionError(f"sharded_render {name} {k} "
                                             f"differs from render()")
                if int(img["overflow"]) != 0:
                    raise AssertionError(f"sharded_render {name} dropped "
                                         f"{int(img['overflow'])}")
                out[name] = {"median_ms": float(np.median(times)),
                             "times_ms": times,
                             "max_abs_vs_render": max(e[0] for e in
                                                      errs.values())}
        render_ms = [wall_ms(lambda: gt.render(splats, cam, cfg))[1]
                     for _ in range(SHARDED_RENDERS)]
    out["render_median_ms"] = float(np.median(render_ms))
    log(f"render() beside them: median {out['render_median_ms']:.2f} ms")
    return out


def sharded_steps(par, tally, mesh, splats, cam, cfg):
    """(a) the sharded training step on the 1x1 mesh, 3D 'mixed' (B1 and
    B2 once a step) and 2D (B3 and B4), the record gather's backward's 2
    kernels once a step, its first loss against the
    single-device step's on the same parameters.  Returns the results and
    the 3D state for the checkpoint."""
    from gaussiansplats3d_tpu_torch.parallel import train
    tiles, mask = train.image_to_tile_blocks(
        torch.zeros((HEIGHT, WIDTH, 3), device=splats.device), cfg)
    out, state3d = {}, None
    for name, c, expect in (("3d-mixed", cfg, (1, 1, 0, 0, 0)),
                            ("2d", cfg.replace(render_mode_2d=True),
                             (0, 0, 1, 1, 0))):
        single = train.TrainState.create(splats, train.adam(1e-3))
        _, m1 = train.make_train_step(c, None, train.adam(1e-3))(
            single, cam, tiles, mask)
        del single
        state = train.TrainState.create(
            par.device_put_sharded_splats(splats, mesh), train.adam(1e-3))
        step = par.make_train_step(c, mesh, train.adam(1e-3))
        losses, times = [], []
        zero_gather()
        for _ in range(STEPS):
            (state, m), ms = tally(f"sharded_train_step_{name}",
                                   lambda: wall_ms(lambda: step(
                                       state, cam, tiles, mask)),
                                   expect, f"sharded step {name}")
            losses.append(float(m["loss"]))
            times.append(ms)
        # one slab a step on the 1x1 mesh: one gather
        gather_launches(f"sharded_train_step_{name}", 2 * STEPS)
        rel = abs(losses[0] - float(m1["loss"])) / abs(float(m1["loss"]))
        log(f"sharded train step 1x1 {name}: losses {losses}, median "
            f"{float(np.median(times)):.2f} ms ({[round(t, 2) for t in times]}"
            f"); first loss {losses[0]!r} against the single-device step's "
            f"{float(m1['loss'])!r}: relative {rel:.3e}")
        if not (np.all(np.isfinite(losses)) and rel <= 1e-5
                and losses[-1] < losses[0]):
            raise AssertionError(f"sharded step {name}: losses {losses}, "
                                 f"single-device {float(m1['loss'])}")
        out[name] = {"losses": losses, "median_ms": float(np.median(times)),
                     "times_ms": times, "first_loss_rel_vs_single": rel}
        if name == "3d-mixed":
            out[name]["profile"] = profile_fn(
                f"sharded step 1x1 {name}",
                lambda: step(state, cam, tiles, mask),
                out[name]["median_ms"])
            state3d = state
    return out, state3d


def slab_kernels(kmod, surfel):
    """(forward, backward, plain forward, plain backward) of B1/B2 or
    B3/B4."""
    if surfel:
        return (kmod.composite_surfel_fwd_cuda, kmod.composite_surfel_bwd_cuda,
                kmod.composite_surfel_fwd_torch,
                kmod.composite_surfel_bwd_torch)
    return (kmod.composite_fwd_cuda, kmod.composite_bwd_cuda,
            kmod.composite_fwd_torch, kmod.composite_bwd_torch)


def slab_forward(kmod, surfel, slab, cfg):
    """A compositor forward on one slab's records against its plain
    version: (the kernel's outputs, its largest difference)."""
    fwd, _, plain, _ = slab_kernels(kmod, surfel)
    args = (slab.records, slab.tile_starts, slab.tile_counts, slab.tile_ids,
            cfg)
    outs = fwd(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    err = compare_forward("B3" if surfel else "B1", "slab",
                          [("chans", outs[0], ref[0], BAR_P999["chans"]),
                           ("logt", outs[1], ref[1], BAR_P999["logt"])],
                          ref[2], outs[2], slab.tile_ids.shape[0])
    return outs, max(err["chans"]["max_abs"], err["logt"]["max_abs"])


def slab_backward(kmod, surfel, bargs):
    """A compositor backward on one slab's records against its plain
    version: its largest difference."""
    _, bwd, _, plain = slab_kernels(kmod, surfel)
    grad = bwd(*bargs)
    torch.cuda.synchronize()
    rows = compare_grad_rows("B4" if surfel else "B2", "slab", grad,
                             plain(*bargs))
    return max(r["max_abs"] for r in rows)


def whole_frame(kmod, surfel, splats, cam, cfg):
    """The whole frame at ``cfg``: the unsharded kernels' arguments
    (forward, backward) on its records, and render_tiles' chans."""
    from gaussiansplats3d_tpu_torch.render.pipeline import render_tiles
    fwd = slab_kernels(kmod, surfel)[0]
    if surfel:
        args, _ = surfel_inputs(splats, cam, cfg)
        outs = fwd(*args, cfg)
        cots = surfel_cotangents(outs[0], outs[1], cfg)
    else:
        from gaussiansplats3d_tpu_torch.render.binning import bin_sort_records
        from gaussiansplats3d_tpu_torch.render.projection import (
            project_splats)
        with torch.no_grad():
            pairs = bin_sort_records(project_splats(splats, cam, cfg), cfg)
        ids = torch.arange(cfg.num_tiles, dtype=torch.int32,
                           device=splats.device)
        args = (pairs.records, pairs.tile_starts, pairs.tile_counts, ids)
        outs = fwd(*args, cfg)
        cots = (color_loss_cotangent(outs[0], cfg),)
    with torch.no_grad():
        whole, _, overflow = render_tiles(splats, cam, cfg)
    if int(overflow) != 0:
        raise AssertionError(f"the whole frame at tile {cfg.tile_size} "
                             f"dropped {int(overflow)} pairs")
    return args + (cfg,), args + (outs[1], outs[2]) + cots + (cfg,), whole


def kernel_window(kmod, surfel, whole_args, slab_args, reps=20):
    """The kernels' ms in one window on the card: the whole frame's
    forward and backward, each slab's, and the slabs' back to back."""
    fwd, bwd = slab_kernels(kmod, surfel)[:2]
    out = {}
    for d, k, whole_a in (("fwd", fwd, whole_args[0]),
                          ("bwd", bwd, whole_args[1])):
        args = [a[0] if d == "fwd" else a[1] for a in slab_args]
        out[f"whole_{d}_ms"] = cuda_ms(lambda: k(*whole_a), reps)
        out[f"{d}_ms"] = [cuda_ms(lambda a=a: k(*a), reps) for a in args]
        out[f"{d}_sum_ms"] = cuda_ms(lambda: [k(*a) for a in args], reps)
    return out


def slab_decomposition(par, tally, kmod, surfel, splats, cam, cfg):
    """(b) a (1, SLAB_SHARDS) decomposition on one card through the
    factored slab function (sharded.render_slab): for each slab mode, each
    slab's rows as one splat shard routes them, its binning and composite
    (counted: the forward kernel once a slab), the forward and backward
    kernels against their plain versions on its records; the stitched
    slabs against render_tiles' chans; then in one window on the card
    (kernel_window) each slab's kernel ms, the four slabs back to back
    and the whole frame's; slab pairs."""
    from gaussiansplats3d_tpu_torch.parallel import sharded
    from gaussiansplats3d_tpu_torch.render.projection import project_splats
    from gaussiansplats3d_tpu_torch.render.surfel import project_surfels
    t = SLAB_SHARDS
    tag = "2d" if surfel else "3d"
    whole_args = whole_frame(kmod, surfel, splats, cam, cfg)
    whole = whole_args[2]
    with torch.no_grad():
        proj = (project_surfels if surfel else project_splats)(splats, cam,
                                                               cfg)
        d = proj.depth[proj.mask]
        bounds = (d.min(), d.max())
    out = {"fwd_max_abs_err": 0.0, "bwd_max_abs_err": 0.0}
    expect = (0, 0, 1, 0, 0) if surfel else (1, 0, 0, 0, 0)
    for mode in SLAB_MODES:
        ecap = par.default_exchange_capacity(
            cfg, splats.num_splats, t,
            alpha=4.0 if mode == "interleaved" else 3.0)
        slabs = []
        for j in range(t):
            with torch.no_grad():
                slabs.append(tally(
                    f"slabs_1x{t}_{tag}",
                    lambda: sharded.render_slab(
                        cfg, *sharded.slab_rows(cfg, proj, j, t, mode, ecap),
                        j, t, mode, bounds),
                    expect, f"slab {j} {mode} {tag}"))
        if any(int(s.overflow) for s in slabs):
            raise AssertionError(f"a slab ({tag} {mode}) dropped pairs")
        stitched = torch.cat([s.chans for s in slabs])
        if mode == "interleaved":
            stitched = sharded.deinterleave_tile_order(stitched, t,
                                                       cfg.tiles_x)
        mx, p999, over = error_mass(stitched, whole)
        log(f"slabs 1x{t} {tag} {mode}: stitched chans against "
            f"render_tiles': max {mx:.3e} p99.9 {p999:.3e} over 1e-2 "
            f"{over:.3e}")
        if not (p999 <= BAR_P999["chans"] and over <= BAR_OVER):
            raise AssertionError(f"stitched slabs ({tag} {mode}) differ "
                                 f"from render_tiles")
        fwd = [slab_forward(kmod, surfel, s, cfg) for s in slabs]
        # the backward's cotangents: those of the whole image's loss at
        # the stitched kernel outputs, cut back into the slabs
        if surfel:
            col = torch.cat([f[0][0] for f in fwd])
            lt = torch.cat([f[0][1] for f in fwd])
            if mode == "interleaved":
                col, lt = (sharded.deinterleave_tile_order(x, t, cfg.tiles_x)
                           for x in (col, lt))
            cots = surfel_cotangents(col, lt, cfg)
        else:
            ch = torch.cat([f[0][0] for f in fwd])
            if mode == "interleaved":
                ch = sharded.deinterleave_tile_order(ch, t, cfg.tiles_x)
            cots = (color_loss_cotangent(ch, cfg),)
        if mode == "interleaved":
            cots = tuple(sharded.interleave_tile_order(c, t, cfg.tiles_x)
                         for c in cots)
        lt_n = slabs[0].chans.shape[0]
        slab_args = []
        for j, (s, f) in enumerate(zip(slabs, fwd)):
            a = (s.records, s.tile_starts, s.tile_counts, s.tile_ids)
            slab_args.append((a + (cfg,), a + (f[0][1], f[0][2]) + tuple(
                c[j * lt_n:(j + 1) * lt_n].contiguous() for c in cots)
                + (cfg,)))
        bwd_err = [slab_backward(kmod, surfel, a[1]) for a in slab_args]
        pairs = [int(s.total_pairs - s.overflow) for s in slabs]
        res = kernel_window(kmod, surfel, whole_args, slab_args)
        res.update({"slab_pairs": pairs,
                    "pairs_max_over_mean": max(pairs) / max(np.mean(pairs),
                                                            1.0),
                    "exchange_capacity": ecap, "stitched_max_abs": mx})
        out["fwd_max_abs_err"] = max([out["fwd_max_abs_err"]]
                                     + [f[1] for f in fwd])
        out["bwd_max_abs_err"] = max([out["bwd_max_abs_err"]] + bwd_err)
        out[mode] = res
        log(f"slabs 1x{t} {tag} {mode}: forward kernel ms "
            f"{[round(x, 3) for x in res['fwd_ms']]} (back to back "
            f"{res['fwd_sum_ms']:.3f}, the whole frame's "
            f"{res['whole_fwd_ms']:.3f}); backward ms "
            f"{[round(x, 3) for x in res['bwd_ms']]} (back to back "
            f"{res['bwd_sum_ms']:.3f}, the whole frame's "
            f"{res['whole_bwd_ms']:.3f}); slab pairs {pairs}, max/mean "
            f"{res['pairs_max_over_mean']:.3f}")
    return out


def config4(par, tally, mesh, device):
    """(c) BASELINE.json config 4 on one card: 16M splats (bench.py's
    scene), SH0, 1920x1080, train-packed through make_train_step on the
    1x1 mesh; a warm-up and CONFIG4_STEPS timed steps (B1 and B2 once a
    step, the record gather's backward's 2 kernels once), finite loss and gradients, overflow, ms, Msplats/s, peak
    memory."""
    import gaussiansplats3d_tpu_torch as gt
    from gaussiansplats3d_tpu_torch.parallel import train
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(SEED)
    splats = gt.random_splats(gen, N_CONFIG4, sh_degree=0, extent=2.0,
                              device=device)
    splats.scales = splats.scales * 0.15
    cam = gt.Camera.look_at((4.5, 2.5, 4.5), (0.0, 0.0, 0.0), fov_y_deg=60.0,
                            aspect=WIDTH / HEIGHT, device=device)
    cfg = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=0,
                          sort_bits=16, record_precision="packed")
    state = train.TrainState.create(
        par.device_put_sharded_splats(splats, mesh), train.adam(1e-3))
    del splats
    step = par.make_train_step(cfg, mesh, train.adam(1e-3))
    tiles, mask = train.image_to_tile_blocks(
        torch.zeros((HEIGHT, WIDTH, 3), device=device), cfg)
    state, _ = step(state, cam, tiles, mask)             # warm-up
    torch.cuda.synchronize()
    losses, times = [], []
    zero_gather()
    for _ in range(CONFIG4_STEPS):
        (state, m), ms = tally("config4_train_step", lambda: wall_ms(
            lambda: step(state, cam, tiles, mask)), (1, 1, 0, 0, 0),
            "config 4 step")
        losses.append(float(m["loss"]))
        times.append(ms)
    gather_launches("config4_train_step", 2 * CONFIG4_STEPS)
    finite = all(bool(torch.isfinite(p.grad).all())
                 for p in state.params.parameters())
    peak = torch.cuda.max_memory_allocated()
    profile = profile_fn("config 4 step", lambda: step(state, cam, tiles,
                                                       mask),
                         float(np.median(times)))
    with torch.no_grad():
        splats = state.params.to_splats()
        _, stats = par.sharded_render_tiles(mesh, splats, cam, cfg,
                                            return_stats=True)
    med = float(np.median(times))
    res = {"n": N_CONFIG4, "losses": losses, "times_ms": times,
           "median_ms": med, "msplats_per_s": N_CONFIG4 / med / 1e3,
           "peak_mem_bytes": peak, "overflow": int(stats["overflow"]),
           "profile": profile,
           "exchange_capacity": stats["exchange_capacity"],
           "slab_pairs": stats["slab_pairs"].tolist()}
    del state
    res["kernels"] = path_kernels(par, tally.cr, splats, cam, cfg,
                                  res["exchange_capacity"], "config 4")
    log(f"config 4 ({N_CONFIG4:,} splats, SH0, {WIDTH}x{HEIGHT}, "
        f"train-packed, 1x1 mesh): step ms "
        f"{[round(t, 2) for t in times]}, median {med:.2f} = "
        f"{res['msplats_per_s']:.3f} Msplats/s; losses {losses}; gradients "
        f"finite {finite}; overflow {res['overflow']}; pairs "
        f"{res['slab_pairs']}; exchange capacity {res['exchange_capacity']};"
        f" peak memory {peak / 2**30:.2f} GiB")
    if not (finite and np.all(np.isfinite(losses))):
        raise AssertionError("config 4: non-finite loss or gradients")
    return res


def path_kernels(par, cr, splats, cam, cfg, ecap, name):
    """B1 then B2 against their plain versions on the records a 1x1 mesh
    step of a path bins (sharded.slab_rows, then sharded.render_slab,
    under no_grad, with the step's exchange capacity), B2 with B1's
    residuals and the cotangent of mean(color^2); each kernel's ms on
    them.  Returns the largest differences, the ms and the pairs."""
    from gaussiansplats3d_tpu_torch.parallel import sharded
    from gaussiansplats3d_tpu_torch.render.projection import project_splats
    t0 = time.perf_counter()
    with torch.no_grad():
        proj = project_splats(splats, cam, cfg)
        d = proj.depth[proj.mask]
        slab = sharded.render_slab(
            cfg, *sharded.slab_rows(cfg, proj, 0, 1, "banded", ecap), 0, 1,
            "banded", (d.min(), d.max()))
        del proj, d
    if int(slab.overflow):
        raise AssertionError(f"{name}: the records dropped "
                             f"{int(slab.overflow)} pairs")
    outs, fwd_err = slab_forward(cr, False, slab, cfg)
    a = (slab.records, slab.tile_starts, slab.tile_counts, slab.tile_ids)
    bargs = a + (outs[1], outs[2], color_loss_cotangent(outs[0], cfg), cfg)
    bwd_err = slab_backward(cr, False, bargs)
    res = {"fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_err,
           "pairs": int(slab.total_pairs), "tiles": int(a[1].shape[0]),
           "fwd_ms": cuda_ms(lambda: cr.composite_fwd_cuda(*a, cfg), 5),
           "bwd_ms": cuda_ms(lambda: cr.composite_bwd_cuda(*bargs), 5),
           "seconds": time.perf_counter() - t0}
    log(f"{name}: B1 and B2 against their plain versions on its step's "
        f"records ({res['pairs']:,} pairs over {res['tiles']} tiles of "
        f"{cfg.tile_size}): largest differences {fwd_err:.3e} (B1), "
        f"{bwd_err:.3e} (B2); kernel ms {res['fwd_ms']:.3f} (B1), "
        f"{res['bwd_ms']:.3f} (B2); {res['seconds']:.1f} s")
    return res


def scaling_kernels(par, cr, scaling_bench, report, device):
    """(e) B1 and B2 against their plain versions on the records of
    scaling_bench's 1x1 step (its scene, at its exchange capacity)."""
    args = scaling_bench.parse_args(SCALING_ARGV)
    cfg, splats, cam = scaling_bench.bench_scene(args, device)
    row = report["results"][0]
    if row["mesh"] != "1x1":
        raise AssertionError(f"scaling_bench's first row is {row['mesh']}")
    return path_kernels(par, cr, splats, cam, cfg,
                        row["exchange_records_per_device"],
                        "scaling_bench 1x1")


def checkpoint_round_trip(par, mesh, state):
    """(d) save_checkpoint and load_checkpoint of the 2M state on the
    card, under the 1x1 mesh: the same parameters, moments and step."""
    from gaussiansplats3d_tpu_torch.parallel import train
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        par.save_checkpoint(state, prefix, mesh=mesh)
        t1 = time.perf_counter()
        back = par.load_checkpoint(prefix, train.adam(1e-3), mesh=mesh)
        t2 = time.perf_counter()
        sizes = {f: os.path.getsize(prefix + f)
                 for f in (".ksplat", ".opt.npz")}
    same = back.step == state.step
    for f in train.SplatParams.FIELDS:
        a, b = getattr(state.params, f), getattr(back.params, f)
        sa, sb = state.opt_state.state[a], back.opt_state.state[b]
        same &= (torch.equal(a, b) and set(sa) == set(sb)
                 and all(torch.equal(sa[k].cpu(), sb[k].cpu()) for k in sa))
    log(f"checkpoint of the 2M state: save {t1 - t0:.2f} s, load "
        f"{t2 - t1:.2f} s, {sizes}; equal {same}")
    if not same:
        raise AssertionError("checkpoint round trip changed the state")
    return {"save_s": t1 - t0, "load_s": t2 - t1, "bytes": sizes}


def multi_gpu_slice(gt, cr, cs, kb, splats, cam, cfg, device):
    """Phase 11 (see the module docstring).  Returns its results, the
    (B1, ..., B5) launches of each path summed from the counters'
    readings, and the slab checks' largest kernel differences."""
    from gaussiansplats3d_tpu_torch import parallel as par
    from gaussiansplats3d_tpu_torch.tools import scaling_bench
    t_phase = time.perf_counter()
    tally = Tally(cr, cs, kb)
    step_s = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        step_s[name] = time.perf_counter() - t0
        return out

    store = tempfile.TemporaryDirectory()
    if par.initialize_distributed(f"file://{store.name}/store", 1, 0,
                                  device="cuda"):
        raise AssertionError("a world of one rank reported more")
    try:
        mesh = par.make_mesh("cuda", 1, 1)
        res = {"renders": timed("renders", lambda: sharded_renders(
            gt, par, tally, mesh, splats, cam, cfg))}
        res["steps"], state = timed("steps", lambda: sharded_steps(
            par, tally, mesh, splats, cam, cfg))
        cfg_b = cfg.replace(tile_size=SLAB_TILE,
                            aux_multiplier=SLAB_AUX_MULTIPLIER)
        res["slabs_3d"] = timed("slabs 3d", lambda: slab_decomposition(
            par, tally, cr, False, splats, cam, cfg_b))
        res["slabs_2d"] = timed("slabs 2d", lambda: slab_decomposition(
            par, tally, cs, True, splats, cam,
            cfg_b.replace(render_mode_2d=True)))
        res["checkpoint"] = timed("checkpoint", lambda: checkpoint_round_trip(
            par, mesh, state))
        del state
        res["config4"] = timed("config 4", lambda: config4(
            par, tally, mesh, device))
        (_, launches, secs, text) = timed("scaling_bench", lambda: tool_path(
            "scaling_bench", lambda: scaling_bench.main(SCALING_ARGV),
            cr, cs, kb))
        tally.add("scaling_bench", launches)
        if launches != (5, 4, 0, 0, 0) or "2x2: skipped" not in text:
            raise AssertionError(f"scaling_bench: launches {launches}")
        res["scaling_bench"] = json.loads(
            [ln for ln in text.splitlines()
             if ln.startswith('{"metric"')][-1])
        res["scaling_bench"]["kernels"] = timed(
            "scaling_bench kernels", lambda: scaling_kernels(
                par, cr, scaling_bench, res["scaling_bench"], device))
    finally:
        torch.distributed.destroy_process_group()
        store.cleanup()
    res["seconds"] = time.perf_counter() - t_phase
    res["step_seconds"] = step_s
    res["launches_by_path"] = tally.by_path
    log("multi-GPU slice steps (s): "
        + ", ".join(f"{k} {x:.2f}" for k, x in step_s.items()))
    log(f"multi-GPU slice: {res['seconds']:.1f} s; (B1, B2, B3, B4, B5) "
        f"launches read per path {tally.by_path}")
    return res, tally.by_path


# --- phases 13 and 14: the main path at tiles 64 and 128 --------------------

def plain_subset(args, every):
    """Every ``every``-th tile of a compositor's (records, starts, counts,
    ids): the tiles the plain version runs on, and their indices."""
    sel = torch.arange(0, args[1].shape[0], every, device=args[1].device)
    return (args[0],) + tuple(a[sel].contiguous() for a in args[1:4]), sel


def window_mask(starts, counts, capacity):
    """[capacity] bool: the slots of the windows [start, start + count)."""
    n = counts.long()
    total = int(n.sum())
    first = torch.cumsum(n, 0) - n
    tile = torch.repeat_interleave(torch.arange(n.shape[0],
                                                device=n.device), n,
                                   output_size=total)
    slot = starts.long()[tile] + torch.arange(total, device=n.device) \
        - first[tile]
    mask = torch.zeros(capacity, dtype=torch.bool, device=n.device)
    mask[slot] = True
    return mask


def tile_entry(name, side, ms, plain_ms, plain_tiles, work, max_abs,
               clusters):
    """A kernel's record at tile ``side``: its time on every tile, the
    plain version's on the subset, the bound from this run's work on every
    tile, the largest difference and, at sides 33-64, the card's
    cudaOccupancyMaxActiveClusters (None above 64: no cluster)."""
    counts, ops, nbytes = work
    bound_ms, bound_by, ops_ms, bytes_ms = bound_of(ops, nbytes)
    log(f"{name} tile {side}: time {ms:.3f} ms  plain {plain_ms:.1f} ms "
        f"on {plain_tiles} tiles  bound {bound_ms:.4f} ms by {bound_by} "
        f"(ops {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms); pairs "
        f"{counts['pairs']}, in box {counts['in_box']}, contributing "
        f"{counts['contributing']}; pair-warp visits {counts['pair_warps']},"
        f" kept {counts['kept_pair_warps']}; max |d| {max_abs:.3e}; "
        f"max active clusters {clusters}")
    return {"ms": ms, "plain_ms": plain_ms, "plain_tiles": plain_tiles,
            "bound_ms": bound_ms, "bound_by": bound_by, "work": counts,
            "operations": ops, "bytes": nbytes, "max_abs_err": max_abs,
            "max_active_clusters": clusters}


def clusters_of(gt_build, name, arg, cfg):
    """cudaOccupancyMaxActiveClusters of kernel ``name``'s cluster form at
    sides 33-64; None above 64, where one block holds a tile."""
    if cfg.tile_size > TILE_64:
        return None
    return gt_build.max_active_clusters(name, arg)


def walk_stats(cr, kernel, fwd_torch, sub, exit_k, cfg):
    """Above 64, the walk's bookkeeping on the compared tiles
    (cuda_rasterize.walk_exits, from the plain version): the sub-tiles
    that ran a second pass, the mean of the sub-tiles' own exits beside
    the mean tile exit; raises unless the tile's exit_k is the largest of
    its sub-tiles' own on >= BAR_EXIT_AGREE of them."""
    k_sub, second = cr.walk_exits(fwd_torch, *sub, cfg)
    k_sub, second = k_sub.long(), second.long()
    agree = float((k_sub.amax(dim=1) == exit_k.long()).double().mean())
    res = {"sub_tiles": int(k_sub.numel()),
           "second_passes": int(second.sum()),
           "second_pass_share": float(second.sum()) / k_sub.numel(),
           "mean_k_sub": float(k_sub.double().mean()),
           "mean_exit_k": float(exit_k.double().mean()),
           "exit_is_max_k_sub": agree}
    log(f"{kernel} walk at tile {cfg.tile_size}, {exit_k.shape[0]} tiles: "
        f"{res['second_passes']} of {res['sub_tiles']} sub-tiles ran a "
        f"second pass; mean own exit {res['mean_k_sub']:.2f}, mean tile exit "
        f"{res['mean_exit_k']:.2f}; exit_k = max own exit on {agree:.4f}")
    if agree < BAR_EXIT_AGREE:
        raise AssertionError(f"{kernel}: the tile's exit is its sub-tiles' "
                             f"largest on only {agree}")
    return res


def tile_gaussians(gt_build, cr, kb, splats, cam, cfg, every):
    """B1, B2 and B5's `full` at ``cfg``'s tile side on the render-mixed
    records: the kernels on every tile, their plain versions on every
    ``every``-th (B2's gradient compared on those tiles' window slots, each
    written by its tile alone), by the bars of phase 2."""
    from gaussiansplats3d_tpu_torch.render.binning import bin_sort_records
    from gaussiansplats3d_tpu_torch.render.projection import project_splats
    with torch.no_grad():
        pairs = bin_sort_records(project_splats(splats, cam, cfg), cfg)
    ids = torch.arange(cfg.num_tiles, dtype=torch.int32,
                       device=splats.device)
    args = (pairs.records, pairs.tile_starts, pairs.tile_counts, ids)
    sub, sel = plain_subset(args, every)
    n_sub = int(sel.shape[0])
    side = cfg.tile_size
    name = f"tile-{side}"
    out = {}

    chans, logt, exit_k = cr.composite_fwd_cuda(*args, cfg)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(lambda: cr.composite_fwd_torch(*sub, cfg))
    err = compare_forward(
        "B1", name, [("chans", chans[sel], ref[0], BAR_P999["chans"]),
                     ("logt", logt[sel], ref[1], BAR_P999["logt"])],
        ref[2], exit_k[sel], n_sub)
    ms = cuda_ms(lambda: cr.composite_fwd_cuda(*args, cfg), reps=10)
    out["composite_fwd"] = tile_entry(
        "B1", side, ms, plain_ms, n_sub, b1_work(cr, pairs, exit_k, cfg),
        max(err["chans"]["max_abs"], err["logt"]["max_abs"]),
        clusters_of(gt_build, "composite_fwd", 3, cfg))
    out["composite_fwd"]["mean_exit_k"] = float(exit_k.double().mean())
    if side > TILE_64:
        out["composite_fwd"]["walk"] = walk_stats(
            cr, "B1", cr.composite_fwd_torch, sub, exit_k[sel], cfg)

    gch = color_loss_cotangent(chans, cfg)
    bargs = args + (logt, exit_k, gch, cfg)
    grad = cr.composite_bwd_cuda(*bargs)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(lambda: cr.composite_bwd_torch(
        *sub, logt[sel].contiguous(), exit_k[sel].contiguous(),
        gch[sel].contiguous(), cfg))
    mask = window_mask(sub[1], sub[2], grad.shape[1])
    rows = compare_grad_rows("B2", name, grad[:, mask], ref[:, mask])
    if len(rows) != grad.shape[0] - 2:
        raise AssertionError(f"B2 on {name}: a record row has no gradient")
    ms = cuda_ms(lambda: cr.composite_bwd_cuda(*bargs), reps=10)
    out["composite_bwd"] = tile_entry(
        "B2", side, ms, plain_ms, n_sub, b2_work(cr, pairs, exit_k, cfg),
        max(r["max_abs"] for r in rows),
        clusters_of(gt_build, "composite_bwd", 3, cfg))

    colors, trans, exit_k = kb.variant_cuda(*args, cfg, "full")
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(lambda: kb.composite_variant_torch(
        *sub, cfg, "full"))
    max_abs = 0.0
    for field, a, b in (("colors", colors[sel], ref[0]),
                        ("t", trans[sel], ref[1])):
        scale = max(float(b.abs().max()), 1e-30)
        mx, p999, over = error_mass(a / scale, b / scale)
        log(f"B5 full vs plain, {name}, {field}: normalised max {mx:.3e}  "
            f"p99.9 {p999:.3e}  share over 1e-2 {over:.3e}")
        if not (p999 <= BAR_P999["chans"] and over <= BAR_OVER):
            raise AssertionError(f"B5 full disagrees with its plain version"
                                 f" on {name} {field}")
        max_abs = max(max_abs, float((a - b).abs().max()))
    agree = float((exit_k[sel] == ref[2]).double().mean())
    if agree < BAR_EXIT_AGREE:
        raise AssertionError(f"B5 full exit_k agrees on only {agree} "
                             f"({name})")
    ms = cuda_ms(lambda: kb.variant_cuda(*args, cfg, "full"), reps=10)
    out["kernel_bench"] = tile_entry(
        "B5 full", side, ms, plain_ms, n_sub,
        b5_work(cr, pairs, exit_k, cfg), max_abs,
        clusters_of(gt_build, "kernel_bench", 0, cfg))
    return out


def tile_surfels(gt_build, cr, cs, splats, cam, cfg, every):
    """B3 and B4 at ``cfg``'s tile side on the 2d-mixed records, as
    tile_gaussians."""
    args, overflow = surfel_inputs(splats, cam, cfg)
    sub, sel = plain_subset(args, every)
    n_sub = int(sel.shape[0])
    side = cfg.tile_size
    name = f"2d tile-{side}"
    out = {}
    colors, logt, exit_k = cs.composite_surfel_fwd_cuda(*args, cfg)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(
        lambda: cs.composite_surfel_fwd_torch(*sub, cfg))
    err = compare_forward(
        "B3", name, [("colors", colors[sel], ref[0], BAR_P999["chans"]),
                     ("logt", logt[sel], ref[1], BAR_P999["logt"])],
        ref[2], exit_k[sel], n_sub)
    ms = cuda_ms(lambda: cs.composite_surfel_fwd_cuda(*args, cfg), reps=10)
    out["surfel_fwd"] = tile_entry(
        "B3", side, ms, plain_ms, n_sub, b3_work(cs, args, exit_k, cfg),
        max(err["colors"]["max_abs"], err["logt"]["max_abs"]),
        clusters_of(gt_build, "surfel_fwd", 3, cfg))
    out["surfel_fwd"]["overflow"] = overflow
    if side > TILE_64:
        out["surfel_fwd"]["walk"] = walk_stats(
            cr, "B3", cs.composite_surfel_fwd_torch, sub, exit_k[sel], cfg)

    gcol, glogt = surfel_cotangents(colors, logt, cfg)
    bargs = args + (logt, exit_k, gcol, glogt, cfg)
    grad = cs.composite_surfel_bwd_cuda(*bargs)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(lambda: cs.composite_surfel_bwd_torch(
        *sub, logt[sel].contiguous(), exit_k[sel].contiguous(),
        gcol[sel].contiguous(), glogt[sel].contiguous(), cfg))
    mask = window_mask(sub[1], sub[2], grad.shape[1])
    rows = compare_grad_rows("B4", name, grad[:, mask], ref[:, mask])
    if not set(range(9, grad.shape[0] - 2)) <= {r["row"] for r in rows}:
        raise AssertionError(f"B4 on {name}: a center, channel or opacity "
                             f"row has no gradient")
    ms = cuda_ms(lambda: cs.composite_surfel_bwd_cuda(*bargs), reps=10)
    out["surfel_bwd"] = tile_entry(
        "B4", side, ms, plain_ms, n_sub, b4_work(cs, args, exit_k, cfg),
        max(r["max_abs"] for r in rows),
        clusters_of(gt_build, "surfel_bwd", 3, cfg))
    return out


def tile_slice(gt, gt_build, cr, cs, kb, splats, cam, cfg, t32, side,
               every, phase):
    """Phases 13 and 14: the main path at tile ``side`` (64: B1-B5 hold
    each tile as a cluster of four 32 x 32 blocks; 128: one block a tile
    walks its 32 x 32 sub-tiles): B1, B2 and B5's `full`, then B3 and B4,
    against their plain versions on every ``every``-th tile
    (tile_gaussians, tile_surfels); then the render and the step in 3D and
    2D through render() by the functions of phases 3, 5 and 8, each with
    its counters, beside the tile-32 medians of this run (``t32``: path ->
    configuration -> ms).  Returns the kernels' records and the (B1, ...,
    B5) launches of each path."""
    t_phase = time.perf_counter()
    cfgt = cfg.replace(tile_size=side)
    cfgt_2d = cfgt.replace(render_mode_2d=True)
    log(f"phase {phase}: tile {side}, {cfgt.num_tiles} tiles "
        f"({cfgt.tiles_x} x {cfgt.tiles_y}); the plain versions on every "
        f"{every}th")
    kernels = tile_gaussians(gt_build, cr, kb, splats, cam, cfgt, every)
    kernels.update(tile_surfels(gt_build, cr, cs, splats, cam, cfgt_2d,
                                every))
    kb.reset_launches()
    cs.reset_launches()
    runs, render_b1 = main_path(gt, cr, splats, cam, cfgt)
    steps, (step_b1, step_b2) = train_path(gt, cr, splats, cam, cfgt)
    if (launch_count(cs.LAUNCHES), launch_count(cs.BWD_LAUNCHES)) != (0, 0):
        raise AssertionError(f"B3 or B4 launched on a 3D path at tile {side}")
    run2d = main_path_2d(gt, cr, cs, splats, cam, cfgt_2d)
    step2d = train_path_2d(gt, cr, cs, splats, cam, cfgt_2d)
    # device time, idle share and top kernels at this side, as phases 4
    # and 5 read them at tile 32
    profiles = {"render": profile_render(gt, splats, cam, cfgt,
                                         runs["mixed"]["median_ms"]),
                "train_step": profile_step(gt, splats, cam, cfgt,
                                           steps["mixed"]["median_ms"])}
    if launch_count(kb.LAUNCHES) != 0:
        raise AssertionError(f"B5 launched {launch_count(kb.LAUNCHES)} "
                             f"times on the tile-{side} paths")
    medians = {"render": {k: r["median_ms"] for k, r in runs.items()},
               "train_step": {k: r["median_ms"] for k, r in steps.items()},
               "render_2d": {"2d-mixed": run2d["median_ms"]},
               "train_step_2d": {"2d-mixed": step2d["median_ms"]}}
    for path, by_config in medians.items():
        for c, ms in by_config.items():
            log(f"tile {side} {path} {c}: median {ms:.2f} ms; tile 32 in "
                f"this run {t32[path][c]:.2f} ms")
    seconds = time.perf_counter() - t_phase
    log(f"phase {phase} (tile {side}): {seconds:.1f} s")
    launches = {
        f"tile-{side} render": (render_b1, 0, 0, 0, 0),
        f"tile-{side} train_step": (step_b1, step_b2, 0, 0, 0),
        f"tile-{side} render_2d": run2d["launches_b1_b2_b3_b4"] + (0,),
        f"tile-{side} train_step_2d": step2d["launches_b1_b2_b3_b4"] + (0,)}
    return {"kernels": kernels, "median_ms": medians, "seconds": seconds,
            "tile_32_median_ms": t32, "profiles": profiles}, launches


# --- phase 12: the native scene decoders at full size -----------------------
def decode_timed(gio, data, fmt, decoder):
    """(SplatData on the CPU, host ms of each of DECODE_REPS decodes of the
    whole buffer by `decoder`, every decode checked to take that path)."""
    from gaussiansplats3d_tpu_torch.io import native
    times = []
    with decode_path(decoder):
        for _ in range(DECODE_REPS):
            native.reset_counts()
            t0 = time.perf_counter()
            out = gio.parse(data, fmt, device="cpu")
            times.append((time.perf_counter() - t0) * 1e3)
            expect_decodes(f"{fmt.value} decode", fmt.value, decoder)
    return out, times


def native_vs_numpy(name, data, fmt, device):
    """One file decoded both ways: each way's times, and per field the
    native decode's error mass against the numpy one (max, p99.9 of |d|,
    share over NATIVE_ATOL), by comparison on the card.  Raises past
    NATIVE_ATOL, or on any difference in colors or opacities (a flipped
    1/255 step of the quantization)."""
    from gaussiansplats3d_tpu_torch import io as gio
    nat, nat_ms = decode_timed(gio, data, fmt, "native")
    ref, ref_ms = decode_timed(gio, data, fmt, "numpy")
    rec = {"file": name, "format": fmt.name, "splats": nat.num_splats,
           "bytes": len(data), "native_ms": nat_ms, "numpy_ms": ref_ms,
           "speedup": min(ref_ms) / min(nat_ms), "fields": {}}
    if nat.num_splats != ref.num_splats:
        raise AssertionError(f"{name}: {nat.num_splats} splats native, "
                             f"{ref.num_splats} numpy")
    for f in FIELDS:
        a, b = getattr(nat, f).to(device), getattr(ref, f).to(device)
        if a.shape != b.shape:
            raise AssertionError(f"{name} {f}: shapes {tuple(a.shape)} and "
                                 f"{tuple(b.shape)}")
        if a.numel() == 0:
            continue
        mx, p999, over = error_mass(a, b, bar=NATIVE_ATOL)
        rec["fields"][f] = {"max_abs": mx, "p999_abs": p999,
                            f"share_over_{NATIVE_ATOL:g}": over}
        if mx > NATIVE_ATOL or (f == "colors" and mx > 0):
            raise AssertionError(f"{name} {f}: native against numpy, max "
                                 f"|d| {mx:.3e}, p99.9 {p999:.3e}, share "
                                 f"over {NATIVE_ATOL:g} {over:.3e}")
    log(f"{name} ({rec['splats']} splats, {len(data)} B): native "
        + "/".join(f"{t:.1f}" for t in nat_ms) + " ms, numpy "
        + "/".join(f"{t:.1f}" for t in ref_ms)
        + f" ms ({rec['speedup']:.1f}x); native - numpy: " + ", ".join(
            f"{f} max {r['max_abs']:.2e} p99.9 {r['p999_abs']:.2e} over "
            f"{r[f'share_over_{NATIVE_ATOL:g}']:.2e}"
            for f, r in rec["fields"].items()))
    return rec


def native_decoders(gt, device):
    """Phase 12 (see the module docstring): S1's 1M .ksplat at levels 0, 1
    and 2, S2's 500k .ply, accept2's 1M .splat and accept3's 5M SH2
    .ksplat, each written from its seeded scene and decoded both ways."""
    from gaussiansplats3d_tpu_torch import io as gio
    from gaussiansplats3d_tpu_torch.io.formats import scene_format_from_path
    from gaussiansplats3d_tpu_torch.tools import bench_configs
    t_phase = time.perf_counter()
    s1 = viewer_splats(gt, N_S1, SEED + 1, device)
    files = [(f"S1 .ksplat level {lv}", "s1.ksplat",
              lambda p, lv=lv: gio.save_ksplat(s1, p, compression_level=lv))
             for lv in (0, 1, 2)]
    files += [
        ("S2 .ply", "s2.ply", lambda p: gio.save_ply(
            viewer_splats(gt, N_S2, SEED + 2, device), p)),
        ("accept2 .splat", "accept2.splat", lambda p: gt.save(
            bench_configs._scene(N_ACCEPT2, 1, device), p)),
        ("accept3 .ksplat", "accept3.ksplat", lambda p: gt.save(
            bench_configs._scene(N_ACCEPT3, 2, device), p))]
    recs = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, fname, write in files:
            path = os.path.join(tmp, fname)
            write(path)
            with open(path, "rb") as f:
                data = f.read()
            os.remove(path)
            recs.append(native_vs_numpy(name, data,
                                        scene_format_from_path(path), device))
    seconds = time.perf_counter() - t_phase
    log(f"native decoders at full size: {len(recs)} files, each within "
        f"{NATIVE_ATOL:g} of numpy with colors and opacities equal; "
        f"{seconds:.1f} s")
    return recs, seconds


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import gaussiansplats3d_tpu_torch as gt
    from gaussiansplats3d_tpu_torch import _build
    from gaussiansplats3d_tpu_torch.render import cuda_rasterize as cr
    from gaussiansplats3d_tpu_torch.render import cuda_surfel as cs
    from gaussiansplats3d_tpu_torch.tools import kernel_bench as kb

    device = torch.device("cuda")
    toolchain(_build)
    splats, cam, cfg = make_scene(gt, device)
    b1 = check_b1_all(cr, splats, cam, cfg)
    b2 = check_b2_all(cr, splats, cam, cfg)
    gather = check_gather_bwd(gt, device)
    cs.reset_launches()
    runs, launches = main_path(gt, cr, splats, cam, cfg)
    b1["main_path"] = runs
    b1["stages_ms"] = stage_breakdown(splats, cam, cfg)
    b1["profile"] = profile_render(gt, splats, cam, cfg,
                                   runs["mixed"]["median_ms"])
    steps, (train_b1, train_b2) = train_path(gt, cr, splats, cam, cfg)
    b1["launches"] = launches + train_b1
    b1["launches_by_path"] = {"render": launches, "train_step": train_b1}
    b2["launches"] = train_b2
    b2["launches_by_path"] = {"train_step": train_b2}
    b2["launches_per_step"] = train_b2 / (STEPS * len(steps))
    b2["train_path"] = steps
    b2["stages_ms"] = train_stage_breakdown(gt, cr, splats, cam, cfg)
    b2["profile"] = profile_step(gt, splats, cam, cfg,
                                 steps["mixed"]["median_ms"])
    b2["adam_steps"] = adam_steps(cr, splats, cam, cfg)
    b2["fit_psnr_db"] = fit_gate(gt, device)
    train_scene_run()
    small_correctness(gt, device)
    small_gradients(gt, device)
    if (launch_count(cs.LAUNCHES), launch_count(cs.BWD_LAUNCHES)) != (0, 0):
        raise AssertionError("B3 or B4 launched on a 3D path")

    cfg2d = cfg.replace(render_mode_2d=True)
    b3, b4 = check_b3_b4_all(cs, splats, cam, cfg)
    run2d = main_path_2d(gt, cr, cs, splats, cam, cfg2d)
    b3["main_path"] = run2d
    b3["stages_ms"] = stage_breakdown_2d(splats, cam, cfg2d)
    b3["profile"] = profile_render(gt, splats, cam, cfg2d,
                                   run2d["median_ms"])
    step2d = train_path_2d(gt, cr, cs, splats, cam, cfg2d)
    b3["launches"] = run2d["launches_b1_b2_b3_b4"][2] \
        + step2d["launches_b1_b2_b3_b4"][2]
    b3["launches_by_path"] = {
        "render_2d": run2d["launches_b1_b2_b3_b4"][2],
        "train_step_2d": step2d["launches_b1_b2_b3_b4"][2]}
    b4["launches"] = step2d["launches_b1_b2_b3_b4"][3]
    b4["launches_by_path"] = {"train_step_2d": b4["launches"]}
    b4["train_path"] = step2d
    b4["profile"] = profile_step(gt, splats, cam, cfg2d,
                                 step2d["median_ms"])
    b4["adam_steps"] = adam_steps(cs, splats, cam, cfg2d)
    b4["fit_2d_losses"] = fit_2d(gt, cs, device)
    small_2d(gt, device)

    # the tools slice: every render and train path above ran B5 0 times
    if launch_count(kb.LAUNCHES) != 0:
        raise AssertionError(f"B5 launched {launch_count(kb.LAUNCHES)} "
                             f"times on the render and train paths")
    b5 = check_b5_all(kb, cr, splats, cam, cfg)
    tools = tools_slice(cr, cs, kb)
    b5["launches"] = tools["kernel_bench"]["launches"][4]
    b5["launches_by_path"] = {"render and train paths": 0,
                              **{k: v["launches"][4]
                                 for k, v in tools.items()}}
    for i, entry in enumerate((b1, b2, b3, b4)):
        entry["tool_launches"] = {k: v["launches"][i]
                                  for k, v in tools.items()}
    b5["tools_seconds"] = {k: v["seconds"] for k, v in tools.items()}
    b5["bench_configs"] = tools["bench_configs"]["records"]

    viewer, by_path = viewer_slice(gt, cr, cs, kb, splats, device)
    b1["viewer"] = viewer
    for i, entry in ((0, b1), (2, b3)):
        paths = {p: n[i] for p, n in by_path.items() if n[i]}
        entry["launches"] += sum(paths.values())
        entry["launches_by_path"].update(paths)
    b5["launches_by_path"]["viewer paths"] = sum(n[4]
                                                 for n in by_path.values())
    # the kernels at the viewer paths' records beside the 1080p ones
    for entry, name, key in ((b1, "viewer-4k", "b1_4k"),
                             (b1, "render-scene-720p", "b1_render_scene"),
                             (b3, "viewer-2d-4k", "b3_4k")):
        entry["per_config"][name] = viewer[key]
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   viewer[key]["max_abs_err"])
    sharded, sh_paths = multi_gpu_slice(gt, cr, cs, kb, splats, cam, cfg,
                                        device)
    b1["multi_gpu"] = sharded
    for i, entry in enumerate((b1, b2, b3, b4)):
        paths = {p: n[i] for p, n in sh_paths.items() if n[i]}
        entry["launches"] += sum(paths.values())
        entry["launches_by_path"].update(paths)
    b5["launches_by_path"]["multi-GPU paths"] = sum(n[4] for n in
                                                    sh_paths.values())
    # the kernels on the (1, 4) slabs' records, config 4's and
    # scaling_bench's, beside the whole frame's
    for entry, rec, err in (
            (b1, sharded["slabs_3d"], "fwd_max_abs_err"),
            (b2, sharded["slabs_3d"], "bwd_max_abs_err"),
            (b3, sharded["slabs_2d"], "fwd_max_abs_err"),
            (b4, sharded["slabs_2d"], "bwd_max_abs_err"),
            (b1, sharded["config4"]["kernels"], "fwd_max_abs_err"),
            (b2, sharded["config4"]["kernels"], "bwd_max_abs_err"),
            (b1, sharded["scaling_bench"]["kernels"], "fwd_max_abs_err"),
            (b2, sharded["scaling_bench"]["kernels"], "bwd_max_abs_err")):
        entry["max_abs_err"] = max(entry["max_abs_err"], rec[err])
    NATIVE["decoders"], NATIVE["phase12_seconds"] = native_decoders(
        gt, device)
    t32 = {"render": {k: r["median_ms"] for k, r in runs.items()},
           "train_step": {k: r["median_ms"] for k, r in steps.items()},
           "render_2d": {"2d-mixed": run2d["median_ms"]},
           "train_step_2d": {"2d-mixed": step2d["median_ms"]}}
    for entry in (b1, b2, b3, b4, b5):
        entry["per_tile"] = {}
    for side, every, phase in ((TILE_64, T64_PLAIN_EVERY, 13),
                               (TILE_128, T128_PLAIN_EVERY, 14)):
        res, paths_t = tile_slice(gt, _build, cr, cs, kb, splats, cam, cfg,
                                  t32, side, every, phase)
        for i, entry in enumerate((b1, b2, b3, b4, b5)):
            rec = res["kernels"][entry["name"]]
            rec["launches"] = {p: n[i] for p, n in paths_t.items()}
            rec["ms_tile_32"] = entry["ms"]
            if side != TILE_64:
                rec["ms_tile_64"] = entry["per_tile"][str(TILE_64)]["ms"]
            entry["per_tile"][str(side)] = rec
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       rec["max_abs_err"])
            paths = {p: n[i] for p, n in paths_t.items() if n[i]}
            entry["launches"] += sum(paths.values())
            entry["launches_by_path"].update(paths)
        b1[f"tile_{side}_median_ms"] = res["median_ms"]
        b1[f"tile_{side}_profiles"] = res["profiles"]
        b1[f"tile_{side}_seconds"] = res["seconds"]
    log(json.dumps({"native": NATIVE}))
    log(json.dumps({"kernels": [b1, b2, b3, b4, b5]}))
    gather["launches_by_path"] = GATHER_LAUNCHES
    log(json.dumps({"gather_bwd": gather}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
