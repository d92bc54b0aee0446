"""One rank of the sharded tests' gloo groups (tests/test_torch_sharded.py).

Run as ``python tests/torch_sharded_worker.py RANK WORLD SHAPE STORE OUT``
(SHAPE ``2x2`` or ``1x4``, STORE a ``file://`` rendezvous, OUT a
directory): the rank joins the group, runs every case of the shape on the
CPU with its own shards, and rank 0 writes what the cases gathered to
``OUT/results.npz`` (and the checkpoint and the scaling report beside it).
It imports torch and the port only, never JAX or the test module.
"""

import contextlib
import io
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import gaussiansplats3d_tpu_torch as gt  # noqa: E402
from gaussiansplats3d_tpu_torch import parallel as par  # noqa: E402
from gaussiansplats3d_tpu_torch.parallel import sharded as sh  # noqa: E402
from gaussiansplats3d_tpu_torch.parallel import train as tr  # noqa: E402
from torch_scenes import scene_arrays  # noqa: E402

FIELDS = ("means", "scales", "quats", "colors", "sh")
CFG = gt.RenderConfig(width=128, height=128, sh_degree=1, sort_bits=20,
                      tile_size=16, background=(0.05, 0.1, 0.15))
EYE = (2.2, 1.4, 2.0)
ROUTES = ("gather", "a2a")
SLAB_MODES = ("banded", "interleaved")
LR = 2e-2
TRAIN_STEPS = 11


def camera(eye=EYE):
    return gt.Camera.look_at(eye, (0, 0, 0), fov_y_deg=60, aspect=1.0,
                             device="cpu")


def scene(n, seed, flat=False, big_every=0):
    """The test scenes (the parent builds the same ones)."""
    means, scales, quats, colors, shc = scene_arrays(n, sh_degree=1,
                                                     seed=seed)
    if flat:
        scales[:, 2] = 1e-6
    if big_every:
        scales[np.arange(n) % big_every == 0] *= 6.0
    return gt.SplatData.from_numpy(means, scales, quats, colors, shc,
                                   device="cpu")


def stereo_scene():
    """Two 300-splat scenes, per-scene transforms, opacities and
    visibility: (splats, scene_indices, transforms, opacities, vis)."""
    a, b = scene(300, 1), scene(300, 2)
    splats = gt.SplatData.concatenate([a, b])
    idx = torch.repeat_interleave(torch.arange(2, dtype=torch.int32),
                                  torch.tensor([300, 300]))
    tfs = torch.eye(4).repeat(2, 1, 1)
    tfs[0, 0, 3], tfs[1, 0, 3] = 0.5, -0.5
    return (splats, idx, tfs, torch.tensor([1.0, 0.4]),
            torch.tensor([True, True]))


class Run:
    def __init__(self, mesh, out):
        self.mesh = mesh
        self.out = out
        self.rank = torch.distributed.get_rank()
        self.saved = {}

    def save(self, key, value):
        if self.rank == 0:
            self.saved[key] = (value.detach().numpy()
                               if isinstance(value, torch.Tensor)
                               else np.asarray(value))

    def render(self, key, splats, cfg, route, mode, cam=None, **kw):
        sp = par.device_put_sharded_splats(splats, self.mesh, route)
        if "scene_indices" in kw:
            kw["scene_indices"] = sh.local_rows(kw["scene_indices"],
                                                self.mesh, route)
        with torch.no_grad():
            out = par.sharded_render(self.mesh, sp, cam or camera(), cfg,
                                     route=route, slab_mode=mode, **kw)
        for k in ("color", "alpha", "depth", "overflow"):
            if k in out:
                self.save(f"{key}/{k}", out[k])

    def grad(self, key, splats, cfg, route, mode):
        """Gradients of mean(color^2) of the sharded image, gathered to
        the whole splat array (padding cut)."""
        sp = par.device_put_sharded_splats(splats, self.mesh, route)
        for f in FIELDS:
            getattr(sp, f).requires_grad_(True)
        out = par.sharded_render(self.mesh, sp, camera(), cfg, route=route,
                                 slab_mode=mode)
        (out["color"] ** 2).mean().backward()
        for f in FIELDS:
            g = sh.gather_rows(getattr(sp, f).grad, self.mesh, route)
            self.save(f"{key}/{f}", g[:splats.num_splats])
            self.save(f"{key}/pad/{f}", g[splats.num_splats:])

    def train(self, key, route, mode):
        target = gt.render(scene(256, 11), camera(), CFG)["color"]
        tiles, mask = tr.image_to_tile_blocks(target, CFG)
        state = tr.TrainState.create(
            par.device_put_sharded_splats(scene(256, 12), self.mesh, route),
            tr.adam(LR))
        step = par.make_train_step(CFG, self.mesh, tr.adam(LR), route=route,
                                   slab_mode=mode)
        losses, norms = [], []
        for _ in range(TRAIN_STEPS):
            state, m = step(state, camera(), tiles, mask)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        self.save(f"{key}/losses", losses)
        self.save(f"{key}/grad_norms", norms)
        return state

    def checkpoint(self, state, route):
        """Save under the mesh, load it back on every rank: the ranks'
        states must come back equal."""
        prefix = os.path.join(self.out, "ckpt")
        par.save_checkpoint(state, prefix, compression_level=1,
                            mesh=self.mesh, route=route)
        back = par.load_checkpoint(prefix, tr.adam(LR), mesh=self.mesh,
                                   route=route)
        same = back.step == state.step
        for f in tr.SplatParams.FIELDS:
            a, b = getattr(state.params, f), getattr(back.params, f)
            same &= torch.equal(a, b)
            sa, sb = state.opt_state.state[a], back.opt_state.state[b]
            same &= set(sa) == set(sb)
            same &= all(torch.equal(sa[k].cpu(), sb[k].cpu()) for k in sa)
        ok = torch.tensor([int(same)])
        torch.distributed.all_reduce(ok, op=torch.distributed.ReduceOp.MIN)
        self.save("ckpt/equal", int(ok))

    def scaling(self):
        from gaussiansplats3d_tpu_torch.tools import scaling_bench
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = scaling_bench.main(
                ["4000", "--meshes", "1x1,2x1,1x2,2x2", "--width", "128",
                 "--height", "64", "--tile", "16", "--iters", "1", "--cpu",
                 "--assert-volumes"])
        if self.rank == 0:
            text = buf.getvalue()
            assert code == 0 and "volume asserts OK" in text, text
            report = [ln for ln in text.splitlines()
                      if ln.startswith('{"metric"')]
            with open(os.path.join(self.out, "scaling.json"), "w") as f:
                f.write(report[-1])


def run_cases(shape, out):
    s, t = (int(x) for x in shape.split("x"))
    mesh = par.make_mesh("cpu", s, t)
    r = Run(mesh, out)
    for route in ROUTES:
        for mode in SLAB_MODES:
            r.render(f"render/{route}/{mode}", scene(512, 3), CFG, route,
                     mode)
            r.grad(f"grad/{route}/{mode}", scene(300, 4), CFG, route, mode)
    cfg2d = CFG.replace(render_mode_2d=True)
    r.render("render2d/gather/banded", scene(400, 5, flat=True), cfg2d,
             "gather", "banded")
    r.render("render2d/a2a/interleaved", scene(400, 5, flat=True), cfg2d,
             "a2a", "interleaved")
    packed = CFG.replace(record_precision="packed", forward_only=True)
    r.render("packed/gather/banded", scene(400, 9, big_every=7), packed,
             "gather", "banded")
    r.render("packed/a2a/interleaved", scene(400, 9, big_every=7), packed,
             "a2a", "interleaved")
    r.render("depth/gather/banded", scene(400, 6),
             CFG.replace(return_depth=True), "gather", "banded")
    splats, idx, tfs, opac, vis = stereo_scene()
    for eye, dx in (("left", -0.15), ("right", 0.15)):
        r.render(f"stereo/{eye}", splats, CFG, "gather", "interleaved",
                 cam=camera((EYE[0] + dx, EYE[1], EYE[2])), transforms=tfs,
                 scene_indices=idx, scene_opacities=opac,
                 scene_visibility=vis)
    if shape == "2x2":
        sp = par.device_put_sharded_splats(scene(2048, 7), mesh, "gather")
        with torch.no_grad():
            _, stats = par.sharded_render_tiles(mesh, sp, camera(), CFG,
                                                exchange_capacity=128,
                                                return_stats=True)
        for k, v in stats.items():
            r.save(f"tight/{k}", v)
        state = r.train("train/gather/banded", "gather", "banded")
        r.checkpoint(state, "gather")
        r.scaling()
    else:
        r.train("train/a2a/interleaved", "a2a", "interleaved")
    if r.rank == 0:
        np.savez(os.path.join(out, "results.npz"), **r.saved)


def main():
    rank, world, shape, store, out = sys.argv[1:6]
    torch.set_num_threads(1)
    par.initialize_distributed(store, int(world), int(rank), device="cpu")
    try:
        run_cases(shape, out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
