"""Traffic kind ``orbit``: a viewer moving its camera around a scene.

Closed loop, one frame at a time under ``no_grad``: each frame calls the
program's ``render()`` with the next camera of a seeded orbit
(``scene.Orbit``) and waits for it (``synchronize()``), as a viewer that
presents every frame.  The cameras are made before the window, on the
device.  A frame's time runs from its ``render()`` call to the end of its
work on the device (CUDA events on either side).

End to end: ``frames_per_s`` = frames in the window / its seconds;
``frame_ms_p95`` = the 95th percentile of every frame's time.

Correctness: ``sample_frames`` frames of the window, drawn from the seed
(reservoir sampling), are kept and, after the window, compared with the
reference's render of the same cameras.
"""

from __future__ import annotations

import random
import time

import torch

from splatbench import harness, program, scene
from splatbench.reference import render as ref


class Run:
    kind = "orbit"

    def __init__(self, ctx):
        self.ctx = ctx
        c = ctx.cell
        self.config, self.mix = c["config"], c["mix"]
        gt, dev = ctx.gt, ctx.device
        self.gt, self.dev = gt, dev
        self.split = {"build_s": program.build(gt, self.config, "orbit")
                      if dev.type == "cuda" else 0.0}
        t0 = time.perf_counter()
        self.cfg = program.render_config(gt, self.config, self.mix)
        p = scene.draw_params(self.config, ctx.seed, dev)
        self.n = p["means"].shape[0]
        self.data = program.splat_data(gt, p)
        del p
        self._sync()
        self.split["inputs_s"] = time.perf_counter() - t0
        path = scene.Orbit(self.config, self.mix, ctx.seed)
        self.poses = [path.next() for _ in range(int(self.mix["max_frames"]))]
        views = torch.stack([c["view"] for c in self.poses]).to(dev)
        projs = torch.stack([c["proj"] for c in self.poses]).to(dev)
        pos = torch.stack([c["cam_pos"] for c in self.poses]).to(dev)
        self.cams = [gt.Camera(view=views[i], proj=projs[i], cam_pos=pos[i])
                     for i in range(len(self.poses))]
        self.next_frame = 0
        self.rng = random.Random(int(ctx.seed))
        self.kept = []                   # (frame index, color, alpha)
        self.seen = 0
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.split["scene_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(int(self.mix["warmup_frames"])):
                self.frame(keep=False)
        self.split["warmup_s"] = time.perf_counter() - t0

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def frame(self, keep=True, events=None):
        i = self.next_frame % len(self.cams)
        self.next_frame += 1
        if events is not None:
            events[0].record()
        out = self.gt.render(self.data, self.cams[i], self.cfg)
        if events is not None:
            events[1].record()
        self._sync()
        if keep:
            # reservoir sampling of the frames the window produces
            k = int(self.mix["sample_frames"])
            if len(self.kept) < k:
                self.kept.append((i, out["color"].clone(),
                                  out["alpha"].clone()))
            else:
                j = self.rng.randrange(self.seen + 1)
                if j < k:
                    self.kept[j] = (i, out["color"].clone(),
                                    out["alpha"].clone())
            self.seen += 1
        return out

    def window(self, seconds: float) -> dict:
        cuda = self.dev.type == "cuda"
        events = []
        host_ms = []
        with torch.no_grad():
            self._sync()
            t0 = time.perf_counter()
            while True:
                ev = ((torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) if cuda
                      else None)
                f0 = time.perf_counter()
                self.frame(events=ev)
                host_ms.append((time.perf_counter() - f0) * 1e3)
                events.append(ev)
                if time.perf_counter() - t0 >= seconds:
                    break
            self._sync()
            t1 = time.perf_counter()
        ms = ([a.elapsed_time(b) for a, b in events] if cuda else host_ms)
        return {"t0": t0, "t1": t1, "attempted": len(ms), "failed": 0,
                "metrics": {"frames_per_s": len(ms) / (t1 - t0),
                            "frame_ms_p95": harness.quantile(ms, 95)}}

    def traced(self, trace_mod):
        first = self.next_frame
        count = int(self.mix["trace_frames"])

        def frames():
            with torch.no_grad():
                for _ in range(count):
                    self.frame()
        tr = trace_mod.profile(frames)
        self.traced_views = [(first + k) % len(self.cams)
                             for k in range(count)]
        return tr

    def splats(self):
        return self.data

    def free(self):
        del self.data
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self) -> dict:
        """Each kept frame against the reference's render of its camera:
        the worst frame's RMS difference of colour and of alpha."""
        s = ref.settings(self.config, self.mix)
        p = scene.draw_params(self.config, self.ctx.seed, self.dev)
        color_rms, alpha_rms = 0.0, 0.0
        with ref.no_tf32():
            for i, color, alpha in self.kept:
                out = ref.render(p, self.poses[i], s)
                dc = (color.double() - out["color"].double())
                da = (alpha.double() - out["alpha"].double())
                color_rms = harness.worst(color_rms,
                                          float(dc.pow(2).mean().sqrt()))
                alpha_rms = harness.worst(alpha_rms,
                                          float(da.pow(2).mean().sqrt()))
        if not self.kept:
            return {}
        return {"color_rms": color_rms, "alpha_rms": alpha_rms}


def control(ctx, dt) -> dict:
    """The control: the reference in ``dt`` put in the program's place, on
    ``sample_frames`` frames of the seed's orbit, against the reference in
    float32."""
    config, mix = ctx.cell["config"], ctx.cell["mix"]
    s = ref.settings(config, mix)
    p = scene.draw_params(config, ctx.seed, ctx.device)
    rng = random.Random(int(ctx.seed))
    picked = set(rng.sample(range(int(mix["max_frames"])),
                            int(mix["sample_frames"])))
    path = scene.Orbit(config, mix, ctx.seed)
    poses = [pose for i, pose in
             ((i, path.next()) for i in range(max(picked) + 1))
             if i in picked]
    color_rms = alpha_rms = 0.0
    with ref.no_tf32():
        for pose in poses:
            hi = ref.render(p, pose, s)
            lo = ref.render(p, pose, s, dt)
            dc = lo["color"].double() - hi["color"].double()
            da = lo["alpha"].double() - hi["alpha"].double()
            color_rms = harness.worst(color_rms,
                                      float(dc.pow(2).mean().sqrt()))
            alpha_rms = harness.worst(alpha_rms,
                                      float(da.pow(2).mean().sqrt()))
    return {"color_rms": color_rms, "alpha_rms": alpha_rms}
