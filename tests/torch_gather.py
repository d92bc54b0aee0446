"""The record gather of the port's binning (render/binning.py::_Gather)
for the tests of its backward: the arguments that a binning call hands
it, captured, a binning over random rects, the reference gradient of
``index_select`` (autograd's ``index_add_``), and the kernel run inside
guard zones.  Torch only, so that the card tests import no JAX."""

import dataclasses

import torch

import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu_torch.render import binning


def capture_gathers(monkeypatch):
    """From now on every ``binning._Gather.apply`` appends ``(src, perm,
    layout)`` to the returned list and runs as before."""
    calls = []
    apply = binning._Gather.apply

    def recording(fields, src, perm, layout):
        calls.append((src, perm, layout))
        return apply(fields, src, perm, layout)

    monkeypatch.setattr(binning._Gather, "apply", recording)
    return calls


def random_rects(n, cfg, seed, device="cpu"):
    """Rects of 1-4 x 1-4 tiles at random places of ``cfg``'s grid (cut at
    its edges) for n splats, a tenth culled, and random depth keys:
    ``(tx0, ty0, wt, ht, counts, depth_q)``, int64."""
    gen = torch.Generator().manual_seed(seed)
    tx0 = torch.randint(0, cfg.tiles_x, (n,), generator=gen)
    ty0 = torch.randint(0, cfg.tiles_y, (n,), generator=gen)
    wt = torch.minimum(torch.randint(1, 5, (n,), generator=gen),
                       cfg.tiles_x - tx0)
    ht = torch.minimum(torch.randint(1, 5, (n,), generator=gen),
                       cfg.tiles_y - ty0)
    culled = torch.rand(n, generator=gen) < 0.1
    counts = torch.where(culled, torch.zeros_like(wt), wt * ht)
    depth_q = torch.randint(0, 1 << cfg.sort_bits, (n,), generator=gen)
    return tuple(t.to(device) for t in (tx0, ty0, wt, ht, counts, depth_q))


def random_gather(monkeypatch, f, n, seed, device="cpu", **cfg_kw):
    """``expand_sort`` over :func:`random_rects` on a 128 x 96 image at
    tile 16 (``cfg_kw`` more settings): returns ``(src, perm, layout)``."""
    cfg = gt.RenderConfig(width=128, height=96, tile_size=16, **cfg_kw)
    calls = capture_gathers(monkeypatch)
    fields = list(torch.zeros((f, n), device=device))
    with torch.no_grad():
        binning.expand_sort(cfg, *random_rects(n, cfg, seed, device), fields,
                            opa_row=f - 1, carry_slot=True)
    return calls[-1]


def index_add_grad(g, src, n):
    """The gradient of ``index_select(1, src)`` for the cotangent g, in
    float64 (the reference), and the same sums of |g| (the scale of its
    rounding): ``(ref, scale)``, both [F, n]."""
    g64 = g.double()
    zeros = g64.new_zeros((g.shape[0], n))
    return (zeros.index_add(1, src, g64),
            zeros.index_add(1, src, g64.abs()))


def tail_slots(layout):
    """How many slots the tail folds into splat 0: the aux slots past the
    table's coverage and the pad."""
    kept = 0 if layout.dest is None else min(int(layout.covered),
                                             layout.aux_cap)
    return layout.aux_cap - kept + layout.pad


def guarded_gather_bwd(g, perm, layout, guard=4096):
    """csrc/gather_bwd.cu (``binning.launch_gather_bwd``) with each buffer
    it reads or writes inside a larger one, ``guard`` elements on each
    side: NaN around the cotangent and the float buffers, which start all
    NaN (a row read before it is written, or a read past an edge, puts NaN
    in d); 0 around perm (a read past it sends a NaN cotangent to splat
    0); aux_cap around the table's counts.  Returns ``(d, tail, whether
    every guard is as it was)``: a write out of bounds changes a guard."""
    f, s = g.shape
    n, dev = layout.n, g.device
    width = binning.row_width(f)
    rows = layout.lanes * n + layout.aux_cap
    bufs = []

    def inside(src, numel, dtype, fill):
        buf = torch.full((numel + 2 * guard,), fill, dtype=dtype,
                         device=dev)
        bufs.append((buf, fill))
        view = buf[guard:guard + numel]
        if src is not None:
            view.copy_(src.reshape(-1))
        return view

    nan = float("nan")
    g_in = inside(g, f * s, torch.float32, nan).view(f, s)
    perm_in = inside(perm, s, torch.int64, 0)
    if layout.dest is not None:
        b_cap = layout.offs_c.shape[0]
        layout = dataclasses.replace(
            layout,
            offs_c=inside(layout.offs_c, b_cap, torch.int64, 0),
            counts_c=inside(layout.counts_c, b_cap, torch.int64,
                            layout.aux_cap))
    aligned = inside(None, rows * width, torch.float32, nan)
    partials = inside(None, binning._BWD_PARTIAL_ROWS * width,
                      torch.float32, nan)
    d = inside(None, f * n, torch.float32, nan).view(f, n)
    tail = inside(None, 1, torch.int64, -1).view(())
    binning.launch_gather_bwd(g_in, perm_in, layout,
                              aligned.view(rows, width),
                              partials.view(-1, width), d, tail)
    torch.cuda.synchronize()

    def same(x, fill):
        return bool(torch.isnan(x).all()) if fill != fill \
            else bool((x == fill).all())

    intact = all(same(buf[:guard], fill) and same(buf[-guard:], fill)
                 for buf, fill in bufs)
    return d, tail, intact
