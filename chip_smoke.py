#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gaussiansplats3d_tpu_torch) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises on failure (nonzero exit, no result line):

1. the card and the toolchain: nvidia-smi's name and power limit,
   torch.version.cuda, nvcc --version; every CUDA kernel of the port is
   built from csrc/ with nvcc for sm_90a (one nvcc per source, started
   together), and ptxas' registers / shared memory / spills are printed;
2. every kernel against its plain PyTorch version, on the card, at the
   shapes the main paths give it (the port's own binning of the main-path
   scene, in each configuration of phases 3 and 5), by error mass; then
   each one's time (CUDA events), its plain version's time and its bound,
   from the work this run's data needs.  B2's cotangent is that of
   mean(color^2) at B1's chans;
3. the serving path: render() of 2M random splats (seeded, the JAX
   package's bench.py scene), SH degree 1, 1920x1080, tile 32, sort_bits
   16, under torch.no_grad(), with the default record precision ('mixed')
   and with the serving mode ('packed', forward_only, aux_multiplier 0.3 as
   bench.py serves it), RENDERS times each; the launch counters are zeroed
   just before and read just after: B1 once a render, B2 never;
4. a stage breakdown of one render (CUDA events) and a torch.profiler
   view of it: device time, the device's idle share, the top kernels;
5. the training path, bench.py's step (_grad_step_msplats): the gradient
   of mean(color^2) with respect to all five SplatData fields at the same
   scene, in 'mixed' and in train-packed ('packed', gradients on), a
   warm-up and STEPS timed steps each; counters zeroed just before and read
   just after: B1 and B2 once a step; every gradient finite and nonzero;
   median step time, Msplats/s as bench.py computes it, peak memory; a
   stage breakdown of the forward and the backward and a torch.profiler
   view of one step;
6. a few Adam steps through make_train_step at that size; the fit gate of
   tests/test_training.py on the card (300 splats, 64x64, 3 views, 150
   Adam steps at 2e-3, >= 25 dB); a short train_scene run with a densify;
7. correctness at a small size: the CUDA render against the port's
   untiled oracle on the card and against the CPU render (plain
   versions), images and the gradients of the five fields.

Prints a {"kernels": [...]} line, and last {"ok": true, "device": ...}.
It has no CPU mode: without a CUDA device it exits 1.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

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
# float32 operations B1's function needs per pair-pixel visit, by how far
# the visit gets through the cut-offs (an FMA counts two):
# every visit: dx, dy, |dx| <= rx, |dy| <= ry;
OPS_VISIT = 4
# inside the rx/ry box: g = a dx^2 + 2b dx dy + c dy^2 (7 mul, 2 add), g <= 8;
OPS_IN_BOX = 10
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
BAR_P999 = {"chans": 1e-3, "logt": 1e-2, "grad": 1e-3}
BAR_OVER = 1e-3
BAR_EXIT_AGREE = 0.99
# The fit gate of tests/test_training.py::test_fit_psnr_gate
FIT_PSNR_DB = 25.0


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
    gt_build.build_all()
    log(f"built {len(gt_build.KERNELS)} kernel(s) in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in gt_build.KERNELS:
        for line in gt_build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
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


def visit_counts(cr, pairs, exit_k, cfg):
    """The pair-pixel visits of each tile before its exit (the window's
    pairs in chunks < exit_k, at every pixel of the tile), how many of them
    pass the rx/ry box, the g <= 8 cut-off and min_alpha (the plain
    version's masks), and the pairs visited."""
    dev = pairs.records.device
    ts = cfg.tile_size
    start = pairs.tile_starts.long()
    end = torch.minimum(start + pairs.tile_counts.long(),
                        (start // cr.CHUNK + exit_k.long()) * cr.CHUNK)
    n_done = torch.clamp(end - start, min=0)
    total = int(n_done.sum())
    tiles = torch.arange(cfg.num_tiles, device=dev)
    tile = torch.repeat_interleave(tiles, n_done, output_size=total)
    first = torch.cumsum(n_done, 0) - n_done
    slot = start[tile] + torch.arange(total, device=dev) - first[tile]
    pix = torch.arange(ts, device=dev, dtype=torch.float32) + 0.5
    nc = pairs.records.shape[0] - 8
    counts = {"visits": total * ts * ts, "in_box": 0, "in_cutoff": 0,
              "contributing": 0}
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
    """float32 operations of the tiers every visit walks up to the cut-offs
    (B1's evaluation of alpha)."""
    return (counts["visits"] * OPS_VISIT + counts["in_box"] * OPS_IN_BOX
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
    return counts, ops, nbytes


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
    return counts, ops, nbytes


def bound_of(ops, nbytes):
    """(bound ms, 'operations' or 'bytes', ops ms, bytes ms) on the
    published H100 peaks."""
    ops_ms = ops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops_ms, bytes_ms)


def check_b1(cr, splats, cam, name, cfg):
    """B1 against its plain version on the records of one main-path
    configuration; its time, the plain version's time and the bound."""
    from gaussiansplats3d_tpu_torch.render.binning import bin_sort_records
    from gaussiansplats3d_tpu_torch.render.projection import project_splats
    with torch.no_grad():
        pairs = bin_sort_records(project_splats(splats, cam, cfg), cfg)
    dev = splats.device
    ids = torch.arange(cfg.num_tiles, dtype=torch.int32, device=dev)
    args = (pairs.records, pairs.tile_starts, pairs.tile_counts, ids, cfg)
    chans, logt, exit_k = cr.composite_fwd_cuda(*args)
    torch.cuda.synchronize()
    ref = cr.composite_fwd_torch(*args)
    torch.cuda.synchronize()
    err = {}
    for field, a, b in (("chans", chans, ref[0]), ("logt", logt, ref[1])):
        mx, p999, over = error_mass(a, b)
        err[field] = {"max_abs": mx, "p999": p999, "over_1e-2": over}
        log(f"B1 vs plain, {name}, {field}: max_abs {mx:.3e}  p99.9 "
            f"{p999:.3e}  share over 1e-2 {over:.3e}")
        if not (p999 <= BAR_P999[field] and over <= BAR_OVER):
            raise AssertionError(f"B1 disagrees with its plain version on "
                                 f"{name} {field}: {err[field]}")
    agree = float((exit_k == ref[2]).double().mean())
    err["exit_k_agree"] = agree
    log(f"B1 vs plain, {name}, exit_k: equal on {agree:.6f} of "
        f"{cfg.num_tiles} tiles")
    if agree < BAR_EXIT_AGREE:
        raise AssertionError(f"exit_k agrees on only {agree} ({name})")

    ms = cuda_ms(lambda: cr.composite_fwd_cuda(*args), reps=10)
    plain_ms = cuda_ms(lambda: cr.composite_fwd_torch(*args), reps=2)
    counts, ops, nbytes = b1_work(cr, pairs, exit_k, cfg)
    bound_ms, bound_by, ops_ms, bytes_ms = bound_of(ops, nbytes)
    log(f"B1 {name}: time {ms:.3f} ms  plain {plain_ms:.3f} ms  bound "
        f"{bound_ms:.4f} ms by {bound_by} (ops bound {ops_ms:.4f} ms: "
        f"{ops} float32 operations; bytes bound {bytes_ms:.4f} ms: {nbytes}"
        f" bytes); pair-pixel visits before exit {counts['visits']}, in "
        f"box {counts['in_box']}, in cut-off {counts['in_cutoff']}, "
        f"contributing {counts['contributing']}; mean exit_k "
        f"{float(exit_k.double().mean()):.2f}, pairs in windows "
        f"{int(pairs.tile_counts.long().sum())}")
    return {"max_abs_err": max(err["chans"]["max_abs"],
                               err["logt"]["max_abs"]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "errors": err, "work": counts,
            "operations": ops, "bytes": nbytes}


def check_b1_all(cr, splats, cam, cfg):
    """check_b1 on every main-path configuration.  The kernels-line entry
    takes its times and bound from the default configuration and its
    max_abs_err from the worst configuration."""
    per_config = {name: check_b1(cr, splats, cam, name, c)
                  for name, c in configs_of(cfg)}
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
    if not bool(torch.isfinite(grad).all()):
        raise AssertionError(f"B2 gave non-finite gradients on {name}")
    nf = grad.shape[0]
    rows = []
    for r in range(nf):
        scale = float(ref[r].abs().max())
        if r >= nf - 2 or scale == 0.0:      # rx, ry: no gradient
            if float(grad[r].abs().max()) != 0.0:
                raise AssertionError(f"B2 row {r} should be 0 ({name})")
            continue
        mx, p999, over = error_mass(grad[r] / scale, ref[r] / scale)
        rows.append({"row": r, "max_abs": float((grad[r] - ref[r]).abs()
                                                 .max()),
                     "max_norm": mx, "p999_norm": p999, "over_1e-2": over,
                     "row_scale": scale})
        log(f"B2 vs plain, {name}, row {r}: normalised max {mx:.3e}  p99.9 "
            f"{p999:.3e}  share over 1e-2 {over:.3e}  (row max |plain| "
            f"{scale:.3e})")
        if not (p999 <= BAR_P999["grad"] and over <= BAR_OVER):
            raise AssertionError(f"B2 disagrees with its plain version on "
                                 f"{name} row {r}: {rows[-1]}")
    if len(rows) != nf - 2:
        raise AssertionError(f"B2 on {name}: a record row has no gradient")
    ms = cuda_ms(lambda: cr.composite_bwd_cuda(*args), reps=10)
    plain_ms = cuda_ms(lambda: cr.composite_bwd_torch(*args), reps=2)
    counts, ops, nbytes = b2_work(cr, pairs, exit_k, cfg)
    bound_ms, bound_by, ops_ms, bytes_ms = bound_of(ops, nbytes)
    log(f"B2 {name}: time {ms:.3f} ms  plain {plain_ms:.3f} ms  bound "
        f"{bound_ms:.4f} ms by {bound_by} (ops bound {ops_ms:.4f} ms: "
        f"{ops} float32 operations; bytes bound {bytes_ms:.4f} ms: {nbytes}"
        f" bytes); visits replayed {counts['visits']}, in box "
        f"{counts['in_box']}, in cut-off {counts['in_cutoff']}, "
        f"contributing {counts['contributing']}; chunks replayed "
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
    counter zeroed just before and read just after.  A render's enqueue
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
            before = cr.launches
            times, enqueue = [], []
            for _ in range(RENDERS):
                t0 = time.perf_counter()
                out = gt.render(splats, cam, c, return_aux=True)
                enqueue.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            launches = cr.launches - before
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
        total = cr.launches
    if total != RENDERS * len(configs):
        raise AssertionError(f"B1 launched {total} times on the main path")
    if cr.bwd_launches != 0:
        raise AssertionError(f"B2 launched {cr.bwd_launches} times on the "
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
    once a step.  Msplats/s as bench.py computes it (N / step s / 1e6),
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
        before = (cr.launches, cr.bwd_launches)
        times = []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            grad_step(gt, s, cam, c)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = (cr.launches - before[0], cr.bwd_launches - before[1])
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
               "grad_max_abs": grads}
        results[name] = res
        log(f"train step {name}: median {med:.2f} ms over {STEPS} steps "
            f"({', '.join(f'{x:.2f}' for x in times)}); "
            f"{res['msplats_per_s']:.3f} Msplats/s (mean-based "
            f"{res['msplats_per_s_mean']:.3f}); peak memory "
            f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; B1 launches "
            f"{launches[0]}, B2 launches {launches[1]}; max |grad| "
            + ", ".join(f"{k} {v:.3e}" for k, v in grads.items()))
        if launches != (STEPS, STEPS):
            raise AssertionError(f"{launches} launches of (B1, B2) in "
                                 f"{STEPS} steps of {name}")
    total = (cr.launches, cr.bwd_launches)
    if total != (STEPS * len(configs),) * 2:
        raise AssertionError(f"(B1, B2) launched {total} times on the "
                             f"training path")
    return results, total


def train_stage_breakdown(gt, cr, splats, cam, cfg):
    """Milliseconds of each stage of one training step in each training
    configuration, stage by stage (CUDA events): the forward stages, then
    the backward cut at the records (assembly + B2, B2 alone) and at the
    projected fields (the gather's scatter-add and codecs), then the
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


def profile_step(gt, splats, cam, cfg, wall_ms):
    """torch.profiler over one default training step: device time, the
    device's idle share against the unprofiled median step, the kernels
    that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    s = grad_splats(gt, splats)
    grad_step(gt, s, cam, cfg)                      # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        grad_step(gt, s, cam, cfg)
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
    log(f"profile train step: device {dev_ms:.3f} ms, "
        f"{sum(e.count for e in kernels)} device ops, idle share {idle:.3f} "
        f"of the {wall_ms:.2f} ms median step")
    for k in top:
        log(f"  {k['ms']:8.3f} ms  x{k['count']}  {k['name']}")
    return {"device_ms": dev_ms, "idle_share": idle, "top": top}


def adam_steps(cr, splats, cam, cfg, steps=3):
    """A few Adam steps through make_train_step at the main path's size,
    towards a black image: finite losses that fall, B1 and B2 once a
    step."""
    from gaussiansplats3d_tpu_torch.parallel import train
    state = train.TrainState.create(splats, train.adam(1e-3))
    step = train.make_train_step(cfg, None, train.adam(1e-3))
    tiles, mask = train.image_to_tile_blocks(
        torch.zeros((HEIGHT, WIDTH, 3), device=splats.device), cfg)
    cr.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, cam, tiles, mask)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
        if not (np.isfinite(losses[-1]) and float(m["grad_norm"]) > 0.0):
            raise AssertionError(f"make_train_step: loss {losses[-1]}, "
                                 f"grad_norm {float(m['grad_norm'])}")
    launches = (cr.launches, cr.bwd_launches)
    log(f"make_train_step at 2M: losses {losses}, step ms "
        f"{[round(t, 2) for t in times]}, (B1, B2) launches {launches}")
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import gaussiansplats3d_tpu_torch as gt
    from gaussiansplats3d_tpu_torch import _build
    from gaussiansplats3d_tpu_torch.render import cuda_rasterize as cr

    device = torch.device("cuda")
    toolchain(_build)
    splats, cam, cfg = make_scene(gt, device)
    b1 = check_b1_all(cr, splats, cam, cfg)
    b2 = check_b2_all(cr, splats, cam, cfg)
    runs, launches = main_path(gt, cr, splats, cam, cfg)
    b1["main_path"] = runs
    b1["stages_ms"] = stage_breakdown(splats, cam, cfg)
    b1["profile"] = profile_render(gt, splats, cam, cfg,
                                   runs["mixed"]["median_ms"])
    steps, (train_b1, train_b2) = train_path(gt, cr, splats, cam, cfg)
    b1["launches"] = launches + train_b1
    b1["launches_by_path"] = {"render": launches, "train_step": train_b1}
    b2["launches"] = train_b2
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
    log(json.dumps({"kernels": [b1, b2]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
