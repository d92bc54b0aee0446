"""Traffic kind ``train``: a user fitting a scene from captured views.

Set-up draws the scene from the mix's ``scene_seed`` and a smooth target
image per view from ``--seed``, takes the ``views`` cameras of the ring
(one fixed set, which the seed only orders), and so gives every seed the
same splats to fit and the same work in another order; it builds one training
state (the program's ``SplatParams`` and ``adam(lr)``) and drives it
through ``check_steps`` steps of the program's own step on distinct
views; those steps are what the reference checks (each step's loss, the
first gradient's norm per field from Adam's first moment, and each
field's change after the last check step).  The same state then warms up
and runs the window: one step after another, each on the next view of a
seeded sequence that takes every view once in each run of ``views``
steps.

End to end: ``train_msplats_per_s`` = N x steps in the window / the
window's seconds / 1e6, the window closed by ``synchronize()``.
"""

from __future__ import annotations

import time

import torch

from splatbench import harness, program, scene
from splatbench.reference import render as ref

B1 = 0.9        # Adam's first-moment decay: the first moment after one
                # step is (1 - B1) x the first gradient


class Run:
    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx
        c = ctx.cell
        self.config, self.mix = c["config"], c["mix"]
        gt, dev = ctx.gt, ctx.device
        self.gt, self.dev = gt, dev
        self.split = {"build_s": program.build(gt, self.config, "train")
                      if dev.type == "cuda" else 0.0}
        t0 = time.perf_counter()
        self.cfg = program.render_config(gt, self.config, self.mix)
        p0 = fixed_scene(self.config, self.mix, dev)
        self.n = p0["means"].shape[0]
        self.views = scene.ring_views(self.config, self.mix)
        self.cams = [program.camera(gt, v, dev) for v in self.views]
        self.targets = scene.draw_targets(self.config, self.mix, ctx.seed,
                                          dev)
        self._sync()
        self.split["inputs_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        tp = program.train_parts(gt)
        blocks = [tp.image_to_tile_blocks(self.targets[i], self.cfg)
                  for i in range(len(self.views))]
        self.tiles = [b[0] for b in blocks]
        self.mask = blocks[0][1]
        self._sync()
        self.split["tiles_s"] = time.perf_counter() - t1
        self.order = scene.view_order(len(self.views), ctx.seed,
                                      int(self.mix["max_steps"]))
        self.next_step = 0
        params = tp.SplatParams(**{k: p0[k].clone() for k in scene.FIELDS})
        self.opt = tp.adam(float(self.mix["lr"]))
        self.state = tp.TrainState(params=params,
                                   opt_state=self.opt(params.parameters()))
        self.step_fn = tp.make_train_step(self.cfg, None, self.opt)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.split["scene_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._check_steps(p0)
        del p0
        for _ in range(int(self.mix["warmup_steps"])):
            self.step()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.split["warmup_s"] = time.perf_counter() - t0

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def step(self):
        i = self.order[self.next_step % len(self.order)]
        self.next_step += 1
        _, m = self.step_fn(self.state, self.cams[i], self.tiles[i],
                            self.mask)
        return m["loss"]

    def _params(self):
        return dict(zip(scene.FIELDS, self.state.params.parameters()))

    def _check_steps(self, p0):
        """The first steps, which the reference follows."""
        n = int(self.mix["check_steps"])
        self.check_views = self.order[:n]
        losses = []
        for k in range(n):
            losses.append(self.step())
            if k == 0:
                st = self.state.opt_state.state
                self.grad_norms = {
                    f: (float(torch.linalg.norm(st[p]["exp_avg"].double()))
                        / (1.0 - B1) if "exp_avg" in st.get(p, {}) else 0.0)
                    for f, p in self._params().items()}
        self.losses = [float(v) for v in losses]
        self.change_norms = {
            f: float(torch.linalg.norm((p.detach() - p0[f]).double()))
            for f, p in self._params().items()}

    def window(self, seconds: float) -> dict:
        losses = []
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        while True:
            losses.append(self.step())
            if time.perf_counter() - t0 >= seconds:
                break
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        steps = len(losses)
        return {"t0": t0, "t1": t1, "attempted": steps, "failed": failed,
                "metrics": {"train_msplats_per_s":
                            self.n * steps / (t1 - t0) / 1e6}}

    def traced(self, trace_mod):
        first = self.next_step
        count = int(self.mix["trace_steps"])
        tr = trace_mod.profile(lambda: [self.step() for _ in range(count)])
        self.traced_views = [self.order[(first + k) % len(self.order)]
                             for k in range(count)]
        return tr

    def splats(self):
        return self.state.params.to_splats()

    def free(self):
        del self.state, self.step_fn, self.tiles, self.mask
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self) -> dict:
        """The reference's check steps from the same inputs, against the
        program's: the worst gaps over steps (loss) and over fields
        (gradient and change norms)."""
        s = ref.settings(self.config, self.mix)
        p0 = fixed_scene(self.config, self.mix, self.dev)
        with ref.no_tf32():
            r = ref.train(p0, [self.views[i] for i in self.check_views],
                          [self.targets[i] for i in self.check_views], s,
                          float(self.mix["lr"]))
        del p0
        return gaps(self.losses, self.grad_norms, self.change_norms, r)


def fixed_scene(config: dict, mix: dict, device) -> dict:
    """The splats every seed fits: drawn from the mix's ``scene_seed``, as
    the scene a user fits is one scene whatever the views' order and
    targets.  A seed's own scene changed the step's work (0.6% in the
    rate on an H100), which a bound of the rate would have to cover."""
    return scene.draw_params(config, int(mix["scene_seed"]), device)


def gaps(losses, grad_norms, change_norms, r) -> dict:
    """The numbers compared.  Each field's gap of norms is taken against
    the reference's norm of that field or of the median field, whichever
    is larger; fields whose reference gradient is under a thousandth of
    the median field's (round-off moves them under Adam) are left out of
    the change."""
    loss_gap = harness.worst(*(abs(a - b) / max(abs(b), 1e-30)
                               for a, b in zip(losses, r["losses"])))
    rg, rc = r["grad_norms"], r["change_norms"]
    med_g = sorted(rg.values())[len(rg) // 2]
    med_c = sorted(rc.values())[len(rc) // 2]
    grad_gap = harness.worst(*(abs(grad_norms[f] - rg[f])
                               / max(rg[f], med_g, 1e-30) for f in rg))
    moved = [f for f in rc if rg[f] >= 1e-3 * med_g]
    change_gap = harness.worst(*(abs(change_norms[f] - rc[f])
                                 / max(rc[f], med_c, 1e-30) for f in moved))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def control(ctx, dt) -> dict:
    """The control: the reference in ``dt`` put in the program's place,
    over the same check steps, against the reference in float32."""
    config, mix = ctx.cell["config"], ctx.cell["mix"]
    s = ref.settings(config, mix)
    p0 = fixed_scene(config, mix, ctx.device)
    views = scene.ring_views(config, mix)
    targets = scene.draw_targets(config, mix, ctx.seed, ctx.device)
    order = scene.view_order(len(views), ctx.seed, int(mix["check_steps"]))
    cams, tgts = [views[i] for i in order], [targets[i] for i in order]
    lr = float(mix["lr"])
    with ref.no_tf32():
        r = ref.train(p0, cams, tgts, s, lr)
        lo = ref.train(p0, cams, tgts, s, lr, dt)
    return gaps(lo["losses"], lo["grad_norms"], lo["change_norms"], r)
