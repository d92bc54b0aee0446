"""End-to-end training CLI: fit splats to multi-view renders (the
counterpart of the JAX package's ``tools/train_scene.py``).

1. build a synthetic ground-truth scene (or load any supported file),
2. render K orbit views of it as training targets,
3. initialize a smaller random splat set,
4. run the train step (``parallel.train``) with periodic densify/prune
   (``parallel.heuristics``), rebuilding the Adam moments after each,
5. report loss / PSNR / splat-count curves and optionally save the fitted
   scene as ``.ksplat``.

Usage:
    python -m gaussiansplats3d_tpu_torch.tools.train_scene \\
        [--scene file.(ply|splat|ksplat|spz)] [--views 8] [--iters 300] \\
        [--init 5000] [--width 256] [--height 256] [--densify-every 100] \\
        [--save fitted.ksplat] [--cpu]

Runs on the GPU unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

import gaussiansplats3d_tpu_torch as gt
from ..parallel.heuristics import (
    DensifyConfig,
    DensifyState,
    densify_and_prune,
    num_alive,
)
from ..parallel.train import (
    TrainState,
    adam,
    image_to_tile_blocks,
    make_train_step,
)
from ..utils.image_metrics import psnr, ssim


def orbit_cameras(k: int, radius: float, height: float, aspect: float,
                  device):
    cams = []
    for i in range(k):
        a = 2.0 * math.pi * i / k
        eye = (radius * math.cos(a), height, radius * math.sin(a))
        cams.append(gt.Camera.look_at(eye, (0.0, 0.0, 0.0), fov_y_deg=60.0,
                                      aspect=aspect, device=device))
    return cams


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default=None,
                    help="ground-truth scene file (default: synthetic)")
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--init", type=int, default=5000,
                    help="initial random splat count")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--sh-degree", type=int, default=0)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--densify-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--save", default=None, help="write fitted .ksplat")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch kernels)")
    args = ap.parse_args(argv)

    device = torch.device("cpu" if args.cpu else "cuda")
    gen = torch.Generator(device=device)
    if args.scene:
        truth = gt.load(args.scene, device=device).with_sh_degree(
            args.sh_degree)
    else:
        truth = gt.random_splats(gen.manual_seed(0), 20000,
                                 sh_degree=args.sh_degree, device=device)
    cfg = gt.RenderConfig(width=args.width, height=args.height,
                          sh_degree=args.sh_degree)
    cams = orbit_cameras(args.views, 2.6, 1.4, args.width / args.height,
                         device)

    def render(splats, cam):
        with torch.no_grad():
            return gt.render(splats, cam, cfg)["color"]

    print(f"rendering {args.views} target views of {truth.num_splats} "
          f"ground-truth splats on {device}...", flush=True)
    targets = [render(truth, c) for c in cams]
    tile_targets = [image_to_tile_blocks(t, cfg) for t in targets]

    init = gt.random_splats(gen.manual_seed(1), args.init,
                            sh_degree=args.sh_degree, device=device)
    optimizer = adam(args.lr)
    state = TrainState.create(init, optimizer)
    step = make_train_step(cfg, None, optimizer)

    def mean_grads(params, cam, target):
        params.zero_grad(set_to_none=True)
        img = gt.render(params.to_splats(), cam, cfg)["color"]
        torch.mean((img - target) ** 2).backward()
        return params.means.grad.detach().clone()

    for it in range(args.iters):
        cam = cams[it % args.views]
        tiles, mask = tile_targets[it % args.views]
        state, metrics = step(state, cam, tiles, mask)
        if args.densify_every and (it + 1) % args.densify_every == 0 \
                and it + 1 < args.iters:
            # 3DGS adaptive-density step: accumulate the positional
            # gradient of the photometric loss over the orbit views, then
            # clone/split into dead slots + prune (static N) and rebuild
            # the optimizer moments for the new parameters.
            dstate = DensifyState.create(state.params.num_splats, device)
            for v in range(args.views):
                dstate = dstate.update(
                    mean_grads(state.params, cams[v], targets[v]))
            params, _ = densify_and_prune(state.params, dstate,
                                          gen.manual_seed(it),
                                          DensifyConfig())
            state = TrainState(params=params, opt_state=None,
                               step=state.step)
        if (it + 1) % args.log_every == 0 or it == 0:
            img = render(state.params.to_splats(), cams[0])
            p = float(psnr(img, targets[0]))
            alive = int(num_alive(state.params))
            print(f"iter {it + 1:5d}  loss {float(metrics['loss']):.5f}  "
                  f"psnr(view0) {p:6.2f} dB  alive {alive}", flush=True)

    img = render(state.params.to_splats(), cams[0])
    print(f"final psnr(view0): {float(psnr(img, targets[0])):.2f} dB  "
          f"ssim(view0): {float(ssim(img, targets[0])):.4f}", flush=True)
    if args.save:
        gt.save(state.params.to_splats(), args.save)
        print(f"saved {args.save}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
