"""Faults planted in the program under test, to show that the comparison
that decides ``correct`` catches them (``tests/test_splatbench_check.py``
on the CPU, ``readings.py --fault`` on the card).  Each patches the
program's own module for the duration of a ``with`` block:

- ``unchanged``: the training step renders and takes its loss but returns
  the state unchanged (no gradient reaches the optimizer, no update);
- ``half_batch``: the training loss leaves out the second half of the
  tiles and takes its mean over the rest;
- ``altered``: the answer is altered where it is produced: the training
  loss scaled by 1.01, or each rendered frame's colour by 0.98.
"""

from __future__ import annotations

import contextlib

from splatbench import program

NAMES = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def plant(gt, name: str, kind: str):
    tp = program.train_parts(gt)
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "unchanged" and kind == "train":
        def make_step(cfg, mesh, optimizer, **kw):
            def step(state, camera, target_tiles, tile_mask):
                chans, _, _ = tp.render_tiles(state.params.to_splats(),
                                              camera, cfg)
                loss = tp.tile_loss(chans, target_tiles, tile_mask, cfg)
                return state, {"loss": loss.detach(),
                               "grad_norm": loss.detach() * 0.0}
            return step
        patch(tp, "make_train_step", make_step)
    elif name == "half_batch" and kind == "train":
        loss_fn = tp.tile_loss

        def half(chans, target_tiles, tile_mask, cfg):
            h = chans.shape[0] // 2
            return loss_fn(chans[:h], target_tiles[:h], tile_mask[:h], cfg)
        patch(tp, "tile_loss", half)
    elif name == "altered" and kind == "train":
        loss_fn = tp.tile_loss

        def scaled(*args):
            return loss_fn(*args) * 1.01
        patch(tp, "tile_loss", scaled)
    elif name == "altered" and kind == "orbit":
        render = gt.render

        def dimmed(*args, **kw):
            out = render(*args, **kw)
            out["color"] = out["color"] * 0.98
            return out
        patch(gt, "render", dimmed)
    else:
        raise ValueError(f"no fault {name!r} for {kind} traffic")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
