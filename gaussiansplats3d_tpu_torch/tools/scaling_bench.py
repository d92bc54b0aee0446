"""Scaling harness of the sharded training step (counterpart of the JAX
package's ``tools/scaling_bench.py``; BASELINE.md metric 3: >= 80%
splats/s efficiency from one device to many).

Runs the sharded forward + backward train step (``parallel.train.
make_train_step`` over a ``(splat_shards x tile_shards)`` mesh) for every
requested mesh shape on the ranks of a torch.distributed world and
reports, per shape:

- ms a step and Msplats/s (a scaling measurement only on one GPU a rank;
  CPU ranks share one host, so there only the volume columns mean
  anything);
- the efficiency against the first shape;
- each rank's work volumes as the pipeline sized them: the exchange
  capacity (``stats["exchange_capacity"]``), the rows gathered and the
  wire bytes, the pair-sort slots (``binning.slot_layout_for``), each
  slab's pairs and the overflow;
- with ``--chip-ms-proj`` and ``--chip-ms-rest``, the analytic efficiency
  of :func:`predict_efficiency`.

``--assert-volumes`` checks the O(alpha N / tile_shards) contract: the
rows each rank gathers shrink with the tile axis and never track N.

The world: under ``torchrun`` (``torchrun --nproc_per_node=<gpus> -m
gaussiansplats3d_tpu_torch.tools.scaling_bench ...``) the ranks are
torchrun's; otherwise the tool spawns as many ranks as the largest shape
needs (``--cpu``: gloo ranks on the CPU; else one NCCL rank a GPU, as many
as the host has).  A shape that needs more ranks than the world has is
skipped and said so; on a host with one GPU only ``1x1`` runs.  Each
shape runs on the world's first ``s * t`` ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_shape(splats, camera, cfg, splat_shards, tile_shards, iters,
              route="gather", slab_mode="banded", device_type="cuda"):
    """One shape's row on its ranks (None on a rank outside it).  Every
    rank of the world calls this: the mesh's groups are made
    collectively."""
    from ..parallel.mesh import make_mesh, mesh_device
    from ..parallel.sharded import (device_put_sharded_splats,
                                    sharded_render_tiles)
    from ..parallel.train import (TrainState, adam, image_to_tile_blocks,
                                  make_train_step)
    from ..render.binning import slot_layout_for

    d = splat_shards * tile_shards
    mesh = make_mesh(device_type, splat_shards, tile_shards,
                     ranks=range(d))
    if mesh.get_coordinate() is None:
        return None
    dev = mesh_device(mesh)
    n = splats.num_splats
    sharded = device_put_sharded_splats(splats, mesh, route=route)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    target_tiles, tile_mask = image_to_tile_blocks(target, cfg)
    state = TrainState.create(sharded, adam(1e-3))
    step = make_train_step(cfg, mesh, adam(1e-3), route=route,
                           slab_mode=slab_mode)
    state, metrics = step(state, camera, target_tiles, tile_mask)
    float(metrics["loss"])
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step(state, camera, target_tiles, tile_mask)
    float(metrics["loss"])
    _sync(dev)
    ms = (time.perf_counter() - t0) / iters * 1000.0
    with torch.no_grad():
        _, stats = sharded_render_tiles(mesh, sharded, camera, cfg,
                                        return_stats=True, route=route,
                                        slab_mode=slab_mode)
    gathered = int(stats["gathered_records"])
    lanes, aux, pad = slot_layout_for(cfg, gathered)
    return {
        "mesh": f"{splat_shards}x{tile_shards}",
        "route": route,
        "slab_mode": slab_mode,
        "devices": d,
        "ms_per_step": round(ms, 3),
        "msplats_per_s": round(n / ms / 1e3, 3),
        "exchange_records_per_device": int(stats["exchange_capacity"]),
        "exchange_wire_ops": int(stats["exchange_wire_ops"]),
        "exchange_mb_per_device": round(
            stats["exchange_fwd_mb_per_device"], 3),
        "exchange_bwd_mb_per_device": round(
            stats["exchange_bwd_mb_per_device"], 3),
        "gathered_records_per_device": gathered,
        "sort_slots_per_device": lanes * gathered + aux + pad,
        "slab_pairs": stats["slab_pairs"].tolist(),
        "overflow": int(stats["overflow"]),
    }


def predict_efficiency(results, n, t_proj_1, t_rest_1, gbps):
    """Analytic efficiency of each (s x t) shape, D = s t devices:

        T_pred = t_proj_1 / s (or / D under a2a)   splat-parallel stages
               + t_rest_1 / t                      slab sort + composite
               + T_comm                            collectives at `gbps`

    T_comm: the exchange's all-gather receives (s - 1) / s of the wire
    bytes (forward + backward MB), a2a's all-to-all ~1/s of them twice
    more; under gather the parameter gradients' all-reduce over the tile
    axis moves (t - 1) / t of 12 float32 fields of the n / s local splats.
    ``t_proj_1`` / ``t_rest_1`` are one device's measured stage ms for this
    scene; ``gbps`` maps a name to a per-device collective rate (1 GB/s ==
    1 MB/ms).  eff = (t_proj_1 + t_rest_1) / (D T_pred)."""
    t1 = t_proj_1 + t_rest_1
    for r in results:
        s, t = (int(x) for x in r["mesh"].split("x"))
        d = s * t
        wire = r["exchange_mb_per_device"] + r["exchange_bwd_mb_per_device"]
        out = {}
        for name, bw in gbps.items():
            if r.get("route") == "a2a":
                comm = ((s - 1) / s * wire + 2 * (t - 1) / t * wire / s) / bw
                t_pred = t_proj_1 / d + t_rest_1 / t + comm
            else:
                comm = ((s - 1) / s * wire / bw
                        + (t - 1) / t * (12 * 4 * (n / s) / 1e6) / bw)
                t_pred = t_proj_1 / s + t_rest_1 / t + comm
            out[f"predicted_ms_{name}"] = round(t_pred, 3)
            out[f"predicted_eff_{name}"] = round(t1 / (d * t_pred), 3)
        r.update(out)
    return results


def assert_volumes(results, n):
    """The O(alpha N / tile_shards) contract on the gather rows: the rows a
    rank gathers stay under 3 N / t (plus the capacity's rounding) and
    shrink ~t-fold with the tile axis; no shape drops anything."""
    by_tiles = {}
    for r in results:
        if r["route"] == "gather":
            by_tiles.setdefault(int(r["mesh"].split("x")[1]), []).append(r)
    for t, rs in by_tiles.items():
        for r in rs:
            if r["gathered_records_per_device"] > (
                    3.0 * n / t + 128 * (r["devices"] + 1)):
                raise AssertionError(f"gathered rows over 3 N / t: {r}")
    ts = sorted(by_tiles)
    for a, b in zip(ts, ts[1:]):
        ga = by_tiles[a][0]["gathered_records_per_device"]
        gb = by_tiles[b][0]["gathered_records_per_device"]
        if ga / max(gb, 1) <= 0.8 * (b / a):
            raise AssertionError(
                f"gathered rows should shrink ~{b / a}x from tile_shards="
                f"{a} to {b}; got {ga} -> {gb}")
    for r in results:
        if r["overflow"] != 0:       # drops would fake a speedup
            raise AssertionError(f"overflow at {r['mesh']}: {r}")


def _parser():
    ap = argparse.ArgumentParser(
        description="Scaling of the sharded train step over mesh shapes.")
    ap.add_argument("n", nargs="?", type=float, default=200_000)
    ap.add_argument("--meshes", default="1x1,2x1,2x2,4x2",
                    help="comma-separated SPLATxTILE shapes")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--tile", type=int, default=16)
    ap.add_argument("--sh", type=int, default=1)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--assert-volumes", action="store_true")
    ap.add_argument("--chip-ms-proj", type=float, default=None,
                    help="one device's projection fwd+bwd ms for this scene "
                         "(enables the predicted-efficiency columns)")
    ap.add_argument("--chip-ms-rest", type=float, default=None,
                    help="one device's sort+composite+assemble fwd+bwd ms")
    ap.add_argument("--gbps", default="nvlink:450",
                    help="per-device collective rates (GB/s) to predict "
                         "at, name:value pairs")
    ap.add_argument("--route", default="gather",
                    choices=["gather", "a2a", "both"])
    ap.add_argument("--slab-mode", default="banded",
                    choices=["banded", "interleaved"])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (plain kernels)")
    return ap


def parse_args(argv):
    """The bench's arguments from the command line's words ``argv``."""
    return _parser().parse_args(list(argv))


def _shapes(spec):
    shapes = []
    for tok in spec.split(","):
        s, t = tok.strip().split("x")
        shapes.append((int(s), int(t)))
    return shapes


def bench_scene(args, device):
    """``(cfg, splats, camera)`` of the bench for parsed ``args`` (see
    :func:`parse_args`) on ``device``: bench.py's scene, ``args.n`` splats
    random in [-2, 2]^3 with scales x0.15 from ``torch.Generator`` seed 0,
    seen from (4.5, 2.5, 4.5)."""
    from ..core.types import Camera, RenderConfig, random_splats

    cfg = RenderConfig(width=args.width, height=args.height,
                       sh_degree=args.sh, tile_size=args.tile, sort_bits=16)
    gen = torch.Generator(device=device).manual_seed(0)
    splats = random_splats(gen, int(args.n), sh_degree=args.sh, extent=2.0,
                           device=device)
    splats.scales = splats.scales * 0.15
    camera = Camera.look_at((4.5, 2.5, 4.5), (0.0, 0.0, 0.0),
                            fov_y_deg=60.0, aspect=cfg.width / cfg.height,
                            device=device)
    return cfg, splats, camera


def run(args):
    """Every rank of an initialised world: run the shapes that fit; rank 0
    prints and returns the report (other ranks return None)."""
    device_type = "cpu" if args.cpu else "cuda"
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    n = int(args.n)
    shapes = _shapes(args.meshes)
    fit = [st for st in shapes if st[0] * st[1] <= world]
    cfg, splats, camera = bench_scene(args, dev)
    name = (torch.cuda.get_device_name(dev) if device_type == "cuda"
            else "cpu")
    if rank == 0:
        print(f"N={n} {args.width}x{args.height} SH{args.sh} "
              f"tile={args.tile} platform={device_type} device={name} "
              f"ranks={world}", flush=True)
        for st in shapes:
            if st not in fit:
                print(f"  {st[0]}x{st[1]}: skipped, needs {st[0] * st[1]} "
                      f"ranks and this world has {world}", flush=True)
        if device_type == "cpu":
            print("(CPU ranks share one host: the ms columns are not a "
                  "scaling measurement; the volume columns are)", flush=True)
    routes = ["gather", "a2a"] if args.route == "both" else [args.route]
    results = []
    for s, t in fit:
        for route in routes:
            if route == "a2a" and t == 1 and len(routes) > 1:
                continue    # t = 1 a2a is gather
            r = run_shape(splats, camera, cfg, s, t, args.iters, route,
                          args.slab_mode, device_type)
            if rank == 0:
                results.append(r)
                print(f"  {r['mesh']:>5s}/{r['route']:<6s} "
                      f"{r['ms_per_step']:9.3f} ms/step "
                      f"{r['msplats_per_s']:9.3f} Msplats/s  exch/dev "
                      f"{r['exchange_records_per_device']} rec "
                      f"({r['exchange_mb_per_device']} MB)  sort slots/dev "
                      f"{r['sort_slots_per_device']}  overflow "
                      f"{r['overflow']}", flush=True)
    if rank != 0:
        return None
    base = results[0]
    for r in results:
        speedup = r["msplats_per_s"] / max(base["msplats_per_s"], 1e-9)
        r["efficiency_vs_base"] = round(
            speedup * base["devices"] / r["devices"], 3)
    model = None
    if args.chip_ms_proj is not None and args.chip_ms_rest is not None:
        gbps = {tok.split(":")[0]: float(tok.split(":")[1])
                for tok in args.gbps.split(",")}
        predict_efficiency(results, n, args.chip_ms_proj,
                           args.chip_ms_rest, gbps)
        model = {"chip_ms_proj": args.chip_ms_proj,
                 "chip_ms_rest": args.chip_ms_rest, "gbps": gbps,
                 "formula": "see scaling_bench.predict_efficiency"}
    report = {"metric": "scaling_bench", "n": n, "platform": device_type,
              "device": name, "ranks": world, "model": model,
              "results": results}
    print(json.dumps(report), flush=True)
    if args.assert_volumes:
        assert_volumes(results, n)
        print("volume asserts OK", flush=True)
    return report


def _spawned_rank(rank, world, store, argv):
    from ..parallel.distributed import initialize_distributed
    args = parse_args(argv)
    if args.cpu:
        torch.set_num_threads(1)
    initialize_distributed(store, world, rank,
                           device="cpu" if args.cpu else "cuda")
    try:
        run(args)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    """Run the shapes in the world that exists (an initialised process
    group, or torchrun's environment); else spawn the ranks."""
    from ..parallel.distributed import initialize_distributed
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("scaling_bench: no CUDA device (--cpu runs gloo ranks)",
              file=sys.stderr)
        return 2
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        initialize_distributed(device=device)
        run(args)
        return 0
    world = max(s * t for s, t in _shapes(args.meshes))
    if device == "cuda" and world > torch.cuda.device_count():
        print(f"scaling_bench: this host has {torch.cuda.device_count()} "
              f"GPU(s); spawning that many ranks", flush=True)
        world = torch.cuda.device_count()
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(target=_spawned_rank,
                             args=(r, world, store, argv))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=3600)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        print(f"scaling_bench: ranks exited with {codes}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
