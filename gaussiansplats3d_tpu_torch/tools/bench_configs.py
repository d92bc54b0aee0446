"""BASELINE.md acceptance-config runner (counterpart of the JAX package's
``tools/bench_configs.py``).

Exercises the acceptance configs end to end — synthetic scenes written and
re-ingested through the real container formats, rendered through the public
API, with forward and forward+backward times printed as JSON lines:

    1. 10k splats, SH deg 0, 256x256        (.ply ingest, oracle-checked)
    2. truck-shaped: 1M, SH deg 1, 800x600  (.splat ingest)
    3. garden-shaped: 5M, SH deg 2, 1080p   (.ksplat ingest)

(The real truck/garden captures are not redistributable; these match their
splat counts, SH degrees and resolutions — BASELINE.md "Acceptance
configs" 1-3.)  Then config 3's variant over reference-written bytes: a
.ksplat at 1M splats, levels 1 and 2, from tests/reference_ksplat_writer.py
(a transcription of the reference's writer, not part of either package),
read by our reader and checked against our writer's round trip by PSNR.

On a CUDA device the times are CUDA events after a warm-up (mean of 3);
with ``--cpu`` the host clock.  accept1's oracle gate is by error mass
(p99.9 of |d| <= 1e-3 and <= 0.1% of elements over 1e-2), never the
elementwise max, which is reported beside it.

Usage:  python -m gaussiansplats3d_tpu_torch.tools.bench_configs
            [--small] [--cpu] [--tile 32]

--small shrinks counts 100x (a smoke run); --cpu runs on the CPU with the
plain PyTorch kernels; --tile sets every config's tile side (any side >=
1, on a CUDA device too).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..constants import DEFAULT_TILE_SIZE
from .kernel_bench import timeit

FIELDS = ("means", "scales", "quats", "colors", "sh")
# accept1's oracle gate, by error mass
ORACLE_P999 = 1e-3
ORACLE_BAR = 1e-2
ORACLE_OVER = 1e-3


def _scene(n, sh_degree, device, key=0):
    import gaussiansplats3d_tpu_torch as gt
    gen = torch.Generator(device=device).manual_seed(key)
    splats = gt.random_splats(gen, n, sh_degree=sh_degree, extent=2.0,
                              device=device)
    return dataclasses.replace(splats, scales=splats.scales * 0.15)


def _camera(width, height, device):
    import gaussiansplats3d_tpu_torch as gt
    return gt.Camera.look_at((4.5, 2.5, 4.5), (0.0, 0.0, 0.0),
                             fov_y_deg=60.0, aspect=width / height,
                             device=device)


def run_config(name, n, sh_degree, width, height, ext, tmpdir,
               check_oracle=False, backward=True, device="cuda",
               tile_size=DEFAULT_TILE_SIZE):
    import gaussiansplats3d_tpu_torch as gt
    device = torch.device(device)
    splats = _scene(n, sh_degree, device)
    path = os.path.join(tmpdir, f"{name}.{ext}")
    gt.save(splats, path)
    loaded = gt.load(path, device=device)

    # clamp to what the container actually carries (.splat stores no SH) —
    # the reference clamps maxSphericalHarmonicsDegree the same way
    # (Viewer.js caps to the loaded buffer's degree).
    # sh holds [N, K, 3] REST coefficients: K = 3/8/15 for degree 1/2/3
    sh_avail = {0: 0, 3: 1, 8: 2, 15: 3}.get(loaded.sh.shape[1], 0)
    eff_degree = min(sh_degree, sh_avail)
    cfg = gt.RenderConfig(width=width, height=height, sh_degree=eff_degree,
                          sort_bits=16, tile_size=tile_size)
    camera = _camera(width, height, device)

    def fwd():
        with torch.no_grad():
            return gt.render(loaded, camera, cfg)["color"]

    t_fwd = timeit(fwd, device, iters=3)
    rec = {"config": name, "splats": n, "sh_degree": eff_degree,
           "resolution": f"{width}x{height}", "format": ext,
           "fwd_ms": t_fwd}

    if backward:
        leaves = [getattr(loaded, f).detach().requires_grad_(True)
                  for f in FIELDS]
        s = gt.SplatData(*leaves)

        def fwd_bwd():
            img = gt.render(s, camera, cfg)["color"]
            return torch.autograd.grad((img ** 2).mean(), leaves,
                                       allow_unused=True)

        t_fb = timeit(fwd_bwd, device, iters=3)
        rec["fwd_bwd_ms"] = t_fb
        rec["fwd_bwd_msplats_per_s"] = n / t_fb / 1e3

    if check_oracle:
        with torch.no_grad():
            ref = gt.reference_render(loaded, camera, cfg)["color"]
        d = (fwd() - ref).abs().double().flatten()
        p999 = float(torch.quantile(d.cpu(), 0.999))
        over = float((d > ORACLE_BAR).double().mean())
        rec["max_err_vs_oracle"] = float(d.max())
        rec["p999_err_vs_oracle"] = p999
        rec["share_over_1e-2_vs_oracle"] = over
        rec["oracle_ok"] = bool(p999 <= ORACLE_P999 and over <= ORACLE_OVER)

    print(json.dumps(rec), flush=True)
    return rec


def run_reference_bytes(tmpdir, n, level, sh_degree=1, device="cuda",
                        tile_size=DEFAULT_TILE_SIZE):
    """Config-3 variant over REFERENCE-WRITTEN bytes at scale.

    Generates an n-splat `.ksplat` through the transcription of the
    reference's writer (tests/reference_ksplat_writer, a port of
    src/loaders/SplatBuffer.js:1050-1326), ingests it with our reader,
    renders it, and PSNR-checks against the same splats round-tripped
    through OUR writer — so the run exercises reference-layout bytes at
    real scale, not 200-splat fixtures.  The writer is per-splat Python:
    its time is the host's, not the port's.
    """
    import gaussiansplats3d_tpu_torch as gt

    sys.path.insert(0, os.path.join(os.path.dirname(__file__),
                                    "..", "..", "tests"))
    import reference_ksplat_writer as ref

    device = torch.device(device)
    rng = np.random.default_rng(level)
    k = {0: 0, 1: 9, 2: 24}[sh_degree]
    rows = np.zeros((n, 14 + k), np.float32)
    rows[:, 0:3] = rng.uniform(-2.0, 2.0, (n, 3))
    rows[:, 3:6] = rng.uniform(0.002, 0.02, (n, 3))
    q = rng.normal(size=(n, 4))
    rows[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    rows[:, 10:13] = rng.uniform(0.0, 255.0, (n, 3))
    rows[:, 13] = rng.uniform(80.0, 255.0, n)
    if k:
        rows[:, 14:] = rng.normal(0.0, 0.2, (n, k))

    t0 = time.perf_counter()
    data = ref.write_ksplat([list(rows)], minimum_alpha=1,
                            compression_level=level)
    t_write = time.perf_counter() - t0
    path = os.path.join(tmpdir, f"refbytes_l{level}.ksplat")
    with open(path, "wb") as f:
        f.write(data)

    t0 = time.perf_counter()
    loaded = gt.load(path, device=device)
    t_load = time.perf_counter() - t0
    if loaded.num_splats != n:
        raise AssertionError(f"read {loaded.num_splats} of {n} splats")

    ours_path = os.path.join(tmpdir, f"ourbytes_l{level}.ksplat")
    gt.save(loaded, ours_path, compression_level=level)
    reloaded = gt.load(ours_path, device=device)

    cfg = gt.RenderConfig(width=800, height=600, sh_degree=sh_degree,
                          sort_bits=16, tile_size=tile_size)
    camera = _camera(800, 600, device)
    with torch.no_grad():
        img_ref = gt.render(loaded, camera, cfg)["color"]
        img_ours = gt.render(reloaded, camera, cfg)["color"]
    mse = float(((img_ref - img_ours) ** 2).double().mean())
    psnr = -10.0 * np.log10(mse + 1e-12)
    rec = {"config": f"accept3_reference_bytes_l{level}", "splats": n,
           "compression_level": level, "sh_degree": sh_degree,
           "ref_write_s": t_write, "load_s": t_load,
           "psnr_vs_our_writer_db": psnr,
           "ok": bool(psnr > 40.0)}
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise AssertionError(f"reference bytes disagree: {rec}")
    return rec


def run_all(small=False, device="cuda", ref_splats=None,
            tile_size=DEFAULT_TILE_SIZE):
    """Every config of :func:`main` at tile side ``tile_size``;
    ``ref_splats`` overrides the count of the reference-bytes runs
    (default 1M, 10k with ``small``).  Returns the records."""
    div = 100 if small else 1
    ref_n = 1_000_000 // div if ref_splats is None else ref_splats
    kw = dict(device=device, tile_size=tile_size)
    with tempfile.TemporaryDirectory() as tmpdir:
        recs = [
            run_config("accept1_oracle", 10_000 // div, 0, 256, 256, "ply",
                       tmpdir, check_oracle=True, **kw),
            run_config("accept2_truck_shaped", 1_000_000 // div, 1, 800,
                       600, "splat", tmpdir, **kw),
            run_config("accept3_garden_shaped", 5_000_000 // div, 2, 1920,
                       1080, "ksplat", tmpdir, **kw),
            # reference-layout bytes at scale (levels 1 and 2)
            run_reference_bytes(tmpdir, ref_n, 1, **kw),
            run_reference_bytes(tmpdir, ref_n, 2, **kw),
        ]
    if not recs[0]["oracle_ok"]:
        raise AssertionError(f"accept1 disagrees with the oracle: {recs[0]}")
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="shrink the splat counts 100x")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch versions)")
    ap.add_argument("--tile", type=int, default=DEFAULT_TILE_SIZE)
    args = ap.parse_args(argv)
    run_all(small=args.small, device="cpu" if args.cpu else "cuda",
            tile_size=args.tile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
