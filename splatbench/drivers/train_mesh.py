"""Traffic kind ``train_mesh``: the ``train`` traffic (``drivers/train.py``)
on a ``(splat, tile)`` mesh of devices, one process a device.

The configuration's ``mesh`` block names the mesh: ``splat_shards`` x
``tile_shards`` ranks, and the ``route`` and ``slab_mode`` of the program's
``make_train_step`` (the exchange's capacity is the program's own).  Rank 0 is the benchmark's own process.  It builds the kernels,
spawns ranks 1.. as ``python drivers/train_mesh.py`` (one a GPU, rank r on
GPU r), and every rank starts the process group itself (NCCL on the card,
gloo on the CPU; a ``file://`` rendezvous in a fresh temporary directory)
with a bounded timeout, before the program's ``initialize_distributed``
keeps that world; so a collective that hangs ends the run with a non-zero
exit.  Rank 0 watches the others: one that exits early ends the run
(every rank killed and reaped, exit 3 on the card); a rank whose parent is
gone exits.  Rank 0 reaps its ranks on every exit path.

Every rank draws the scene from the mix's ``scene_seed`` and the targets
from ``--seed`` on its own device, keeps its rows of the parameters (the
layout of the program's ``device_put_sharded_splats``, ``local_rows``),
builds the program's ``make_train_step(cfg, mesh, adam(lr), route,
slab_mode)`` and runs the ``check_steps`` and the warm-up in the same
order.  Then ranks 1.. follow rank 0's commands over a gloo group of their
own: the next ``BATCH`` steps of the window (each rank takes the views from
the seeded order that every rank holds, so the hosts meet once a batch and
not once a step), the steps of the traced window, the slab of a view for
the readers, and the end, where every rank's step count is compared.  The
profiler and the spans are read on rank 0 alone.

Check: as ``train``, on the mesh's numbers: the loss of each check step
(the mesh's loss, summed over the tile group), the first gradient's norm
per field from Adam's first moment and each field's change after the last
check step, the moments and the parameters gathered over the splat group
(``gather_rows``); the reference is ``reference/mesh.py``.

End to end: ``train_msplats_per_s`` = N (the whole scene) x steps in the
window / the window's seconds on rank 0's clock / 1e6: the whole mesh's
rate.  The window runs whole batches, so it ends up to a batch after its
seconds.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from datetime import timedelta
from pathlib import Path

if __name__ == "__main__":      # a spawned rank: the checkout's packages
    sys.path[:0] = [p for p in os.environ.get("SPLATBENCH_PATH", "")
                    .split(os.pathsep) if p]

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from splatbench import harness, program, scene, work  # noqa: E402
from splatbench.reference import mesh as mesh_ref  # noqa: E402
from splatbench.reference import render as ref  # noqa: E402

single = harness.load_module(Path(__file__).resolve().parent / "train.py",
                             "driver.train")

COLLECTIVE_S = 120      # the data collectives' timeout: a hang ends the run
CONTROL_S = 1800        # ranks 1.. wait this long for rank 0's next command
REAP_S = 60             # rank 0 waits this long for ranks to exit
STEPS, RECORDS, FREE = 1, 2, 3
BATCH = 8               # steps of the window a command runs
# Faults planted on every rank (``ctx.fault``), to show that the check
# catches them: the tile group's all-reduce left out; the loss over the
# first half of each slab's tiles; the loss scaled by 1.01; the last rank
# raising at its first step.
FAULTS = ("no_allreduce", "half_batch", "altered", "raise")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def mesh_shape(config: dict) -> tuple:
    m = config["mesh"]
    return int(m["splat_shards"]), int(m["tile_shards"])


@contextlib.contextmanager
def plant(gt, name):
    """A fault of :data:`FAULTS` patched into this rank's program."""
    tp = program.train_parts(gt)
    sharded = importlib.import_module(gt.__name__ + ".parallel.sharded")
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "no_allreduce":
        class Local:
            @staticmethod
            def apply(group, *fields):
                return fields
        patch(sharded, "_ReplicatedOverTile", Local)
    elif name in ("half_batch", "altered"):
        error_sum = tp._error_sum

        def faulty(chans, target_tiles, tile_mask, cfg):
            if name == "altered":
                return error_sum(chans, target_tiles, tile_mask, cfg) * 1.01
            h = chans.shape[0] // 2
            return error_sum(chans[:h], target_tiles[:h], tile_mask[:h], cfg)
        patch(tp, "_error_sum", faulty)
    elif name not in (None, "raise"):
        raise ValueError(f"no fault {name!r}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


class Member:
    """One rank's part: its process group, mesh, shard, state and steps."""

    def __init__(self, cell: dict, seed: int, device, gt, rank: int,
                 world: int, store: str, fault=None):
        self.config, self.mix = cell["config"], cell["mix"]
        self.gt, self.rank, self.world, self.fault = gt, rank, world, fault
        self.s, self.t = mesh_shape(self.config)
        m = self.config["mesh"]
        self.route, self.slab_mode = m["route"], m["slab_mode"]
        self.split = {}
        self.faults = contextlib.ExitStack()
        self.faults.enter_context(plant(gt, fault))
        # the ranks share the host's cores; on the CPU one thread a rank,
        # so that no reduction's order depends on the threads' timing (the
        # check's Adam steps turn such rounding into a visible gap)
        self._threads = torch.get_num_threads()
        torch.set_num_threads(1 if device.type == "cpu" else
                              max(1, (os.cpu_count() or 1) // world))
        t0 = time.perf_counter()
        if device.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            device = torch.device("cuda", torch.cuda.current_device())
        self.dev = device
        par = importlib.import_module(gt.__name__ + ".parallel")
        self.sharded = importlib.import_module(gt.__name__
                                               + ".parallel.sharded")
        # every group of the run (the mesh's too, which the program makes
        # with the default timeout) gives up after COLLECTIVE_S
        c10d = dist.distributed_c10d
        self._timeouts = (c10d.default_pg_timeout,
                          c10d.default_pg_nccl_timeout)
        c10d.default_pg_timeout = c10d.default_pg_nccl_timeout = \
            timedelta(seconds=COLLECTIVE_S)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=store, world_size=world,
                                rank=rank,
                                timeout=timedelta(seconds=COLLECTIVE_S))
        par.initialize_distributed(device=device.type)
        self.ctl = dist.new_group(backend="gloo",
                                  timeout=timedelta(seconds=CONTROL_S))
        self.mesh = par.make_mesh(device.type, self.s, self.t)
        self.coord = tuple(int(c) for c in self.mesh.get_coordinate())
        self.split["group_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        config, mix = self.config, self.mix
        self.cfg = program.render_config(gt, config, mix)
        p0 = single.fixed_scene(config, mix, device)
        self.n = p0["means"].shape[0]
        if self.n % self.shard_count():
            raise harness.BenchError(f"{self.n} splats do not split into "
                                     f"{self.shard_count()} shards")
        self.views = scene.ring_views(config, mix)
        self.cams = [program.camera(gt, v, device) for v in self.views]
        self.targets = scene.draw_targets(config, mix, seed, device)
        tp = program.train_parts(gt)
        blocks = [tp.image_to_tile_blocks(self.targets[i], self.cfg)
                  for i in range(len(self.views))]
        self.tiles = [b[0] for b in blocks]
        self.mask = blocks[0][1]
        self.order = scene.view_order(len(self.views), seed,
                                      int(mix["max_steps"]))
        self.next_step = 0
        params = tp.SplatParams(**{
            f: self.sharded.local_rows(p0[f], self.mesh, self.route).clone()
            for f in scene.FIELDS})
        self.opt = tp.adam(float(mix["lr"]))
        self.state = tp.TrainState(params=params,
                                   opt_state=self.opt(params.parameters()))
        self.step_fn = tp.make_train_step(
            self.cfg, self.mesh, self.opt, route=self.route,
            slab_mode=self.slab_mode)
        self.sync()
        self.split["scene_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._check_steps(p0)
        del p0
        for _ in range(int(mix["warmup_steps"])):
            self.step()
        self.sync()
        self.split["warmup_s"] = time.perf_counter() - t0

    def shard_count(self) -> int:
        return self.s * self.t if self.route == "a2a" else self.s

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def step(self, view=None):
        if view is None:
            view = self.order[self.next_step % len(self.order)]
            self.next_step += 1
        if self.fault == "raise" and self.rank == self.world - 1:
            raise RuntimeError("planted fault: this rank raises")
        _, m = self.step_fn(self.state, self.cams[view], self.tiles[view],
                            self.mask)
        return m["loss"]

    def gathered(self, x):
        """Every shard's rows of ``x`` (on every rank of the splat group)."""
        if x.numel() == 0:      # SH 0's coefficients: nothing to send
            return x.new_zeros((self.n,) + tuple(x.shape[1:]))
        return self.sharded.gather_rows(x, self.mesh, self.route)[:self.n]

    def _check_steps(self, p0):
        """The first steps, which the reference follows."""
        count = int(self.mix["check_steps"])
        self.check_views = self.order[:count]
        losses = []
        fields = dict(zip(scene.FIELDS, self.state.params.parameters()))
        for k in range(count):
            losses.append(self.step())
            if k == 0:
                st = self.state.opt_state.state
                self.grad_norms = {
                    f: float(torch.linalg.norm(self.gathered(
                        st[p]["exp_avg"]).double())) / (1.0 - single.B1)
                    for f, p in fields.items()}
        self.losses = [float(v) for v in losses]
        self.change_norms = {
            f: float(torch.linalg.norm((self.gathered(p.detach())
                                        - p0[f]).double()))
            for f, p in fields.items()}

    def slab_records(self, view: int):
        """This rank's slab of a view as its compositors see it (current
        parameters, no gradient), by the program's own ``slab_pass``, the
        step's render up to the slab: (records, starts, counts, exit_k,
        splats of the shard in view).  A collective: every rank calls
        it."""
        gt, cfg = self.gt, self.cfg
        with torch.no_grad():
            proj, slab, _, _ = self.sharded.slab_pass(
                self.mesh, self.state.params.to_splats(), self.cams[view],
                cfg, route=self.route, slab_mode=self.slab_mode)
            cr = importlib.import_module(gt.__name__
                                         + ".render.cuda_rasterize")
            exit_k = cr.composite_fwd(slab.records, slab.tile_starts,
                                      slab.tile_counts, slab.tile_ids,
                                      cfg)[2]
        return (slab.records, slab.tile_starts, slab.tile_counts, exit_k,
                int(proj.mask.sum()))

    def command(self, cmd: int = 0, arg: int = 0) -> tuple:
        """Rank 0 sends (cmd, arg); every other rank receives it."""
        x = torch.tensor([cmd, arg], dtype=torch.int64)
        dist.broadcast(x, src=0, group=self.ctl)
        return int(x[0]), int(x[1])

    def ends(self) -> list:
        """Every rank's (peak device memory in bytes, steps taken): a
        collective."""
        mine = torch.tensor([torch.cuda.max_memory_allocated()
                             if self.dev.type == "cuda" else 0,
                             self.next_step])
        out = [torch.zeros_like(mine) for _ in range(self.world)]
        dist.all_gather(out, mine, group=self.ctl)
        return [(int(x[0]), int(x[1])) for x in out]

    def close(self):
        dist.destroy_process_group()
        c10d = dist.distributed_c10d
        c10d.default_pg_timeout, c10d.default_pg_nccl_timeout = \
            self._timeouts
        torch.set_num_threads(self._threads)
        self.faults.close()

    def serve(self):
        """Ranks 1..: follow rank 0's commands until the end."""
        while True:
            cmd, arg = self.command()
            if cmd == STEPS:
                for _ in range(arg):
                    self.step()
            elif cmd == RECORDS:
                self.slab_records(arg)
            elif cmd == FREE:
                self.ends()
                return


class Run:
    kind = "train"

    def __init__(self, ctx):
        c = ctx.cell
        self.ctx, self.cell = ctx, c
        self.config, self.mix = c["config"], c["mix"]
        gt, dev = ctx.gt, ctx.device
        self.gt = gt
        s, t = mesh_shape(self.config)
        self.world = s * t
        self.fault = getattr(ctx, "fault", None)
        self.split = {"build_s": self._build() if dev.type == "cuda"
                      else 0.0}
        self.procs, self.tmp, self._ended = [], None, False
        atexit.register(self._reap)
        try:
            self._spawn(ctx)
            self.m = Member(c, ctx.seed, dev, gt, 0, self.world,
                            f"file://{self.tmp}/store", self.fault)
        except BaseException:
            self._reap()
            if dist.is_initialized():
                dist.destroy_process_group()
            raise
        self.dev, self.n, self.cfg = self.m.dev, self.m.n, self.m.cfg
        self.views, self.targets = self.m.views, self.m.targets
        self.split.update(self.m.split)
        self._work = {}

    def _build(self) -> float:
        t0 = time.perf_counter()
        program.build(self.gt, self.config, "train")
        b = importlib.import_module(self.gt.__name__ + "._build")
        if (b.CSRC / "gather_bwd.cu").exists():
            b.build("gather_bwd")
        return time.perf_counter() - t0

    def _spawn(self, ctx):
        """Ranks 1.. as processes of their own, and the watch over them."""
        self.tmp = tempfile.mkdtemp(prefix="splatbench-mesh-")
        cell_file = os.path.join(self.tmp, "cell.json")
        with open(cell_file, "w") as f:
            json.dump(self.cell, f)
        roots = [str(Path(self.gt.__file__).resolve().parents[1]),
                 str(Path(harness.__file__).resolve().parents[1])]
        env = dict(os.environ, SPLATBENCH_PATH=os.pathsep.join(roots))
        for r in range(1, self.world):
            out = open(os.path.join(self.tmp, f"rank{r}.log"), "w")
            cmd = [sys.executable, str(Path(__file__).resolve()),
                   "--cell", cell_file, "--seed", str(ctx.seed), "--rank",
                   str(r), "--world", str(self.world), "--store",
                   f"file://{self.tmp}/store", "--device", ctx.device.type,
                   "--program", self.gt.__name__]
            if self.fault:
                cmd += ["--fault", self.fault]
            self.procs.append(subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT, env=env,
                cwd=os.getcwd()))
            out.close()
        log(f"ranks 1-{self.world - 1}: pids "
            f"{' '.join(str(p.pid) for p in self.procs)}")
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        """A rank that exits before the end ends the run."""
        while not self._ended:
            if any(p.poll() not in (None, 0) for p in self.procs) \
                    and not self._ended:
                self._reap()
                if self.ctx.device.type == "cuda":
                    # an NCCL collective of rank 0 waits on the dead rank
                    # until its timeout: end the run now
                    os._exit(3)
                return
            time.sleep(0.25)

    def _tail(self, r: int) -> str:
        try:
            with open(os.path.join(self.tmp, f"rank{r}.log")) as f:
                return f.read()[-4000:]
        except OSError:
            return ""

    def _reap(self):
        """Kill what still runs of ranks 1.., wait for them, say why those
        that failed ended, and remove the rendezvous directory."""
        self._ended = True
        failed = [r for r, p in enumerate(self.procs, 1)
                  if p.poll() not in (None, 0)]
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=REAP_S)
            except subprocess.TimeoutExpired:
                pass
        for r in failed:
            log(f"rank {r} exited with {self.procs[r - 1].returncode} "
                f"before the end:\n{self._tail(r)}")
        if self.tmp:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None
        atexit.unregister(self._reap)

    @property
    def state(self):
        """Rank 0's training state (its shard of the parameters)."""
        return self.m.state

    def steps(self, count: int) -> list:
        """The next ``count`` steps on every rank: one command."""
        self.m.command(STEPS, count)
        return [self.m.step() for _ in range(count)]

    def window(self, seconds: float) -> dict:
        losses = []
        self.m.sync()
        t0 = time.perf_counter()
        while True:
            losses += self.steps(BATCH)
            if time.perf_counter() - t0 >= seconds:
                break
        self.m.sync()
        t1 = time.perf_counter()
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        steps = len(losses)
        return {"t0": t0, "t1": t1, "attempted": steps, "failed": failed,
                "metrics": {"train_msplats_per_s":
                            self.n * steps / (t1 - t0) / 1e6}}

    def traced(self, trace_mod):
        first = self.m.next_step
        count = int(self.mix["trace_steps"])
        tr = trace_mod.profile(lambda: self.steps(count))
        self.traced_views = [self.m.order[(first + k) % len(self.m.order)]
                             for k in range(count)]
        return tr

    def slab_ops(self, view: int):
        """Counted float32 operations of rank 0's part of a step on a view
        (``work.py``): B1 and B2 on its slab's records, and the projection
        of its shard's splats in view, forward and backward.  None off a
        banded mesh (rank 0's local tile ids are global ones on banded
        slab 0 alone)."""
        if self.m.slab_mode != "banded" or self.m.coord[1] != 0 or \
                not hasattr(self.m.sharded, "slab_pass"):
            return None
        if view not in self._work:
            self.m.command(RECORDS, view)
            recs, starts, counts, exit_k, in_view = self.m.slab_records(view)
            cfg = self.cfg
            geom = (cfg.tile_size, cfg.tiles_x, starts.shape[0])
            ops = sum(fn(recs, starts, counts, exit_k, geom,
                         cfg.min_alpha)[0]
                      for fn in (work.b1_work, work.b2_work))
            del recs
            self._work[view] = ops + work.projection_ops(
                in_view, cfg.sh_degree, cfg.render_mode_2d, True)
        return self._work[view]

    def free(self):
        m = self.m
        m.command(FREE)
        self._ended = True
        ends = m.ends()
        peaks = [p for p, _ in ends]
        log(f"peak device memory by rank, GiB: "
            f"{[round(p / 2 ** 30, 3) for p in peaks]}")
        self.split["rank_peak_bytes"] = peaks
        m.close()
        for p in self.procs:
            try:
                p.wait(timeout=REAP_S)
            except subprocess.TimeoutExpired:
                log(f"rank pid {p.pid} did not exit; killed")
        bad = [p.returncode for p in self.procs if p.returncode != 0]
        self._reap()
        if bad:
            raise harness.BenchError(f"ranks ended with {bad}")
        if len({n for _, n in ends}) != 1:
            raise harness.BenchError(f"the ranks took different numbers of "
                                     f"steps: {[n for _, n in ends]}")
        del m.state, m.step_fn, m.tiles, m.mask
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self) -> dict:
        """The mesh reference's check steps from the same inputs, against
        the program's (``train``'s gaps)."""
        m = self.m
        s = ref.settings(self.config, self.mix)
        p0 = single.fixed_scene(self.config, self.mix, self.dev)
        with ref.no_tf32():
            r = mesh_ref.train(p0, [self.views[i] for i in m.check_views],
                               [self.targets[i] for i in m.check_views], s,
                               float(self.mix["lr"]), m.t)
        del p0
        return single.gaps(m.losses, m.grad_norms, m.change_norms, r)


def control(ctx, dt) -> dict:
    """The control: the mesh reference in ``dt`` put in the program's
    place, over the same check steps, against the reference in float32."""
    config, mix = ctx.cell["config"], ctx.cell["mix"]
    _, t = mesh_shape(config)
    s = ref.settings(config, mix)
    p0 = single.fixed_scene(config, mix, ctx.device)
    views = scene.ring_views(config, mix)
    targets = scene.draw_targets(config, mix, ctx.seed, ctx.device)
    order = scene.view_order(len(views), ctx.seed, int(mix["check_steps"]))
    cams, tgts = [views[i] for i in order], [targets[i] for i in order]
    lr = float(mix["lr"])
    with ref.no_tf32():
        r = mesh_ref.train(p0, cams, tgts, s, lr, t)
        lo = mesh_ref.train(p0, cams, tgts, s, lr, t, dt)
    return single.gaps(lo["losses"], lo["grad_norms"], lo["change_norms"],
                       r)


def _watch_parent():
    """A spawned rank whose parent (rank 0) is gone exits."""
    parent = os.getppid()
    while True:
        if os.getppid() != parent:
            os._exit(1)
        time.sleep(0.5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one spawned rank of a "
                                 "train_mesh cell")
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--program", default=harness.PROGRAM)
    ap.add_argument("--fault", choices=FAULTS)
    a = ap.parse_args(argv)
    threading.Thread(target=_watch_parent, daemon=True).start()
    with open(a.cell) as f:
        cell = json.load(f)
    harness.set_caches()
    gt = program.load(a.program)
    m = Member(cell, a.seed, torch.device(a.device), gt, a.rank, a.world,
               a.store, a.fault)
    m.serve()
    m.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
