"""The plain-PyTorch reference of training over a ``(splat, tile)`` mesh:
what one step of the sharded program computes, stated from its definition
on top of the single-device reference (``render.py``), which it uses as it
is.  It imports neither the program nor the JAX package.

The mesh's semantics, for ``tile_shards`` banded slabs of whole tile rows
(slab j: GL tile rows [j r, (j + 1) r), r = tiles_y / tile_shards):

1. The loss is the single-device loss: the mean squared error over every
   pixel and channel of the image.
2. Each slab's record cotangents (one per splat and differentiable record
   row) come from that slab's pixels alone.  A slab bins its splats' tile
   rects clipped to its rows, so the slot order of depth ties (lane, then
   splat id) is that of the clipped rect.
3. On the wire back to the splat shards, every record row but the centre's
   x and y is rounded to bfloat16 (round to nearest even); x and y stay
   float32.  Each slab's rounded cotangents then run through the
   projection's backward alone.
4. The slabs' parameter gradients are summed in float32 (the tile group's
   all-reduce), then Adam steps.

``slabs`` and ``wire`` leave parts out, for the tests that show a check
can tell: ``slabs=[0]`` is the sum without the tile all-reduce (the
gradient slab 0's ranks hold), ``wire=False`` keeps every cotangent in
float32.
"""

from __future__ import annotations

import torch

from splatbench.reference import render as ref

EXACT = ("x", "y")              # record rows that cross the wire in float32


def slab_bounds(s: dict, tile_shards: int) -> list:
    """(first tile row, end tile row, first GL pixel row, end GL pixel row)
    of each banded slab."""
    tiles_y = -(-s["height"] // s["tile"])
    if tiles_y % tile_shards:
        raise ValueError(f"{tiles_y} tile rows do not split into "
                         f"{tile_shards} slabs")
    r = tiles_y // tile_shards
    return [(j * r, (j + 1) * r, min(j * r * s["tile"], s["height"]),
             min((j + 1) * r * s["tile"], s["height"]))
            for j in range(tile_shards)]


def _slab_frame(rec: dict, s: dict, ty_lo: int, ty_hi: int):
    """The reference's frame of the records with each tile rect clipped to
    the tile rows [ty_lo, ty_hi), as the slab's binning clips it."""
    fr = ref.Frame(rec, s)
    ty1 = fr.ty0 + fr.ht - 1
    ty0 = torch.clamp(fr.ty0, ty_lo, ty_hi - 1)
    fr.ty0, fr.ht = ty0, torch.clamp(ty1, ty_lo, ty_hi - 1) - ty0 + 1
    return fr


def _wire(g: torch.Tensor) -> torch.Tensor:
    return g.to(torch.bfloat16).to(g.dtype)


def loss_and_grads(p: dict, cam: dict, target: torch.Tensor, s: dict,
                   tile_shards: int, dt=torch.float32, wire: bool = True,
                   slabs=None):
    """The loss of the render against ``target`` [H, W, 3] (row 0 at the
    top) and, per field of ``p``, the sum over ``slabs`` (default: every
    slab) of each slab's parameter gradient (float32)."""
    acc = ref._accumulator(dt)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
    f = ref.project(leaves, cam, s, dt)
    diff_keys = [k for k, v in f.items()
                 if torch.is_tensor(v) and v.requires_grad]
    h = s["height"]
    inv = 1.0 / (h * s["width"] * 3)
    loss = 0.0
    grads = {k: torch.zeros_like(v, dtype=torch.float32)
             for k, v in p.items()}
    for j, (ty_lo, ty_hi, g0, g1) in enumerate(slab_bounds(s, tile_shards)):
        rec = {k: (f[k].detach().requires_grad_(True) if k in diff_keys
                   else f[k]) for k in f}
        fr = _slab_frame(rec, s, ty_lo, ty_hi)
        for b0, b1 in fr.blocks():
            r0, r1 = max(b0, g0), min(b1, g1)
            if r1 <= r0:
                continue
            sid, px, py = fr.live(r0, r1, acc)
            c, _ = fr.composite(sid, px, py, r0, r1, acc)
            tgt = target[h - r1:h - r0].flip(0).to(acc)
            part = ((c - tgt) ** 2).sum() * inv
            part.backward()
            loss += float(part.detach())
        if slabs is not None and j not in slabs:
            continue
        cots = []
        for k in diff_keys:
            g = rec[k].grad if rec[k].grad is not None \
                else torch.zeros_like(rec[k])
            cots.append(g if k in EXACT or not wire else _wire(g))
        pg = torch.autograd.grad([f[k] for k in diff_keys],
                                 list(leaves.values()), cots,
                                 retain_graph=True, allow_unused=True)
        for k, g in zip(leaves, pg):
            if g is not None:
                grads[k] += g.float()
    return loss, grads


def train(p0: dict, cams: list, targets: list, s: dict, lr: float,
          tile_shards: int, dt=torch.float32, wire: bool = True, slabs=None,
          keep: bool = False):
    """Steps of the mesh's training from ``p0``, one per (camera, target),
    with the reference's Adam: each step's loss, each field's first
    gradient norm and, after the last step, each field's change from
    ``p0`` (norms in float64).  With ``keep``, also every step's
    gradients (``grads``) and the last parameters (``params``)."""
    params = {k: v.clone() for k, v in p0.items()}
    opt = ref.Adam(params, lr)
    losses, first, kept = [], None, []
    for cam, tgt in zip(cams, targets):
        loss, grads = loss_and_grads(params, cam, tgt, s, tile_shards, dt,
                                     wire, slabs)
        losses.append(loss)
        if first is None:
            first = {k: float(torch.linalg.norm(g.double()))
                     for k, g in grads.items()}
        opt.step(params, grads)
        if keep:
            kept.append(grads)
        del grads
    change = {k: float(torch.linalg.norm((params[k] - p0[k]).double()))
              for k in p0}
    out = {"losses": losses, "grad_norms": first, "change_norms": change}
    if keep:
        out.update(grads=kept, params=params)
    return out
