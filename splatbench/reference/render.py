"""The plain-PyTorch reference of the render that the benchmark checks the
program against: 3D Gaussians (EWA splatting) and 2DGS surfels, forward
and, through autograd, backward.

It is written from the render's definition (the reference viewer's
shaders, as ``tests/independent_oracle.py`` ports them, and the record
contract the configuration states) and shares no code with the program:
it imports neither the program nor the JAX package.  It works per pixel,
not per tile:

1. Per splat: the projection, the colour from SH, the opacity, the support
   box (rx, ry) and the depth key, then the record codecs that the
   configuration's ``record_precision`` states (straight-through for
   gradients).
2. Per fragment (a splat and a pixel centre inside its box), in blocks of
   image rows: alpha, cut below ``min_alpha``, outside the Gaussian's
   g <= 8 ellipse (3D) or the surfel's near depth (2D).
3. Per pixel: the fragments in front-to-back order, by the quantised depth
   bucket, ties broken by the pair's slot as the configuration's binning
   lays it out (lane, then splat id; a serving mix's ``forward_only`` only
   drops that tie-breaker from the program's sort key, whose sort keeps
   slot order on ties); the transmittance as a float64 run
   sum of log(1 - alpha); colour = sum of alpha T c.  No tile exit: a
   pixel's fragments behind T < 1e-7 are left out, which moves a pixel by
   less than 1e-7.

Every float32 operation of the forward pass can be asked for in another
dtype (``dt``) to serve as the control: the per-pixel sums then run in
float32.
"""

from __future__ import annotations

import contextlib
import math

import torch

SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
CLIP_FACTOR = 1.2           # clip-space cull at 1.2 w
GAUSS_CUTOFF = 8.0          # d^T Sigma^-1 d <= 8 (sqrt(8) sigma)
ALPHA_CLAMP_3D = 0.999
ALPHA_MAX_2D = 0.99
NEAR_2D = 0.2               # the surfel's ray-plane depth floor
EIGEN_GUARD = 0.1           # max(0.1, discriminant) in the lambda2 cull
MAX_BOX = 4095.9375         # the largest half-extent on the 1/16-px grid
LIVE_T = 1e-7               # fragments behind this transmittance are dropped
FRAGMENT_BUDGET = 1 << 25   # fragments a block of rows holds at most
PX_OFFSET = 1024.0          # packed positions: +-1024 px off-screen
RAD_LOG = 255.0 / math.log2(4097.0)
COLOR_U8 = 127.5            # packed colour step 1/127.5 over [0, 2]


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products in float32, not TF32, while the reference
    runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def settings(config: dict, mix: dict) -> dict:
    """What the reference reads of a configuration and a traffic mix."""
    r = config["render"]
    return {"width": int(config["width"]), "height": int(config["height"]),
            "sh_degree": int(config["sh_degree"]),
            "mode_2d": bool(config["render_mode_2d"]),
            "tile": int(r["tile_size"]), "lanes": int(r["lanes"]),
            "sort_bits": int(r["sort_bits"]),
            "min_alpha": float(r["min_alpha"]),
            "kernel_2d": float(r["kernel_2d_size"]),
            "max_ext": float(r["max_screen_space_splat_size"]),
            "background": tuple(float(b) for b in r["background"]),
            "precision": mix["record_precision"]}


# --- per splat ---------------------------------------------------------------

def _normalize(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def _rotation(q):
    """[N, 3, 3] rotation of (x, y, z, w) quaternions (normalised here)."""
    q = _normalize(q)
    x, y, z, w = q.unbind(-1)
    rows = [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]
    return torch.stack(rows, -1).reshape(-1, 3, 3)


def _sh_color(rgb, sh, dirs, degree):
    if degree == 0:
        return rgb
    if degree > 2:
        raise ValueError("the reference evaluates SH degrees 0-2")
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    c = rgb + SH_C1 * (-sh[:, 0] * y + sh[:, 1] * z - sh[:, 2] * x)
    if degree >= 2:
        c = c + (SH_C2[0] * x * y * sh[:, 3] + SH_C2[1] * y * z * sh[:, 4]
                 + SH_C2[2] * (2.0 * z * z - x * x - y * y) * sh[:, 5]
                 + SH_C2[3] * x * z * sh[:, 6]
                 + SH_C2[4] * (x * x - y * y) * sh[:, 7])
    return torch.clamp(c, 0.0, 1.0)


def _grid16(r, cap):
    """Clamp to ``cap``, then round UP to the 1/16-px grid."""
    r = torch.clamp(r, max=cap)
    return torch.clamp(torch.ceil(r * 16.0) / 16.0, max=MAX_BOX)


def _clip(means, cam, dt):
    view = cam["view"].to(means.device, dt)
    proj = cam["proj"].to(means.device, dt)
    v = means @ view[:3, :3].T + view[:3, 3]
    clip = v @ proj[:, :3].T + proj[:, 3]
    cx, cy, cz, cw = clip.unbind(-1)
    lim = CLIP_FACTOR * cw
    visible = ((cz >= -lim) & (cx >= -lim) & (cx <= lim) & (cy >= -lim)
               & (cy <= lim))
    return v, (cx, cy, cz, cw), visible


def project_3d(p: dict, cam: dict, s: dict, dt):
    """Per-splat screen quantities of the 3D Gaussians (GL pixels, y up)."""
    means = p["means"].to(dt)
    scales = torch.exp(p["log_scales"].to(dt))
    opa = torch.sigmoid(p["logit_opacity"].to(dt))
    w, h = s["width"], s["height"]
    v, (cx, cy, cz, cw), visible = _clip(means, cam, dt)
    safe_w = torch.where(cw.abs() < 1e-9, torch.full_like(cw, 1e-9), cw)
    xs = (cx / safe_w + 1.0) * (0.5 * w)
    ys = (cy / safe_w + 1.0) * (0.5 * h)
    proj = cam["proj"].to(means.device, dt)
    fx, fy = proj[0, 0] * (0.5 * w), proj[1, 1] * (0.5 * h)
    vx, vy, vz = v.unbind(-1)
    z = torch.where(vz.abs() < 1e-6, torch.full_like(vz, 1e-6), vz)
    rot_v = cam["view"].to(means.device, dt)[:3, :3]
    # rows of J W: the pixel x and y gradients of the view-space point
    ju = ((fx / z)[:, None] * rot_v[0]
          + (-fx * vx / (z * z))[:, None] * rot_v[2])
    jv = ((fy / z)[:, None] * rot_v[1]
          + (-fy * vy / (z * z))[:, None] * rot_v[2])
    m = _rotation(p["quats"].to(dt)) * scales[:, None, :]      # R diag(s)
    tu = torch.einsum("nij,ni->nj", m, ju)                    # (R S)^T u
    tv = torch.einsum("nij,ni->nj", m, jv)
    a = (tu * tu).sum(-1) + s["kernel_2d"]
    b = (tu * tv).sum(-1)
    c = (tv * tv).sum(-1) + s["kernel_2d"]
    det = a * c - b * b
    half = 0.5 * (a + c)
    lam2 = half - torch.sqrt(torch.clamp(half * half - det, min=EIGEN_GUARD))
    inv = torch.where(det != 0.0, 1.0 / det, torch.zeros_like(det))
    dirs = _normalize(means - cam["cam_pos"].to(means.device, dt))
    color = _sh_color(p["rgb"].to(dt), p["sh"].to(dt), dirs, s["sh_degree"])
    visible = visible & (lam2 > 0.0) & (opa >= s["min_alpha"])
    zero = torch.zeros_like(opa)
    opa = torch.where(visible, opa, zero)
    # the support box: the AABB of the g = min(8, 2 ln(opa / min_alpha))
    # ellipse, gradient-free
    od = opa.detach()
    g_eff = torch.clamp(2.0 * torch.log(torch.clamp(od, min=s["min_alpha"])
                                        / s["min_alpha"]), 0.0, GAUSS_CUTOFF)
    rf = torch.sqrt(g_eff)
    rx = _grid16(rf * torch.sqrt(torch.clamp(a.detach(), min=0.0)),
                 s["max_ext"])
    ry = _grid16(rf * torch.sqrt(torch.clamp(c.detach(), min=0.0)),
                 s["max_ext"])
    return {"x": xs, "y": ys, "ca": c * inv, "cb": -b * inv, "cc": a * inv,
            "r": color[:, 0], "g": color[:, 1], "b": color[:, 2], "opa": opa,
            "depth": cz.detach(), "rx": torch.where(visible, rx, zero),
            "ry": torch.where(visible, ry, zero), "mask": visible}


SURFEL_T = ("t00", "t01", "t02", "t10", "t11", "t12", "t20", "t21", "t22")


def _pixel_matrix(cam: dict, s: dict, dev, dt):
    """B = (proj view)^T ndc2pix, [4, 3], with ndc2pix = [[W/2, 0, 0],
    [0, H/2, 0], [0, 0, 0], [W/2, H/2, 1]], in ``dt`` as the definition
    computes it: the clip matrix a ``dt`` product, and each column of B a
    dot product whose zero terms add nothing and whose row-3 term is
    fused onto the row-0 (row-1) product, one rounding (the JAX package's
    product on the CPU; taken here in float64, where it is exact)."""
    m = cam["proj"].to(dev, dt) @ cam["view"].to(dev, dt)

    def fused(row, scale):
        return ((m[row] * scale).double() + m[3].double() * scale).to(dt)

    return torch.stack([fused(0, s["width"] / 2.0),
                        fused(1, s["height"] / 2.0), m[3]], dim=-1)


def project_2d(p: dict, cam: dict, s: dict, dt):
    """Per-surfel quantities: the homography T (row-major; Tu, Tv, Tw are
    its columns) from tangent-plane (u, v, 1) to homogeneous GL pixels,
    the screen centre and the 3-sigma support box.

    Every quantity is the definition's (the reference viewer's
    SplatMaterial2D shader, as the JAX package writes it) and is taken in
    ``dt`` term by term in the definition's order.  That order matters:
    the box's extent is a difference of near-equal squares
    (cx^2 - tmp), which float32 rounds to a noise that is as large as
    the extent for a surfel under a pixel, and the configuration states
    float32 arithmetic."""
    dev = p["means"].device
    means = p["means"].to(dt)
    scales = torch.exp(p["log_scales"].to(dt))
    opa = torch.sigmoid(p["logit_opacity"].to(dt))
    _, (_, _, cz, _), visible = _clip(means, cam, dt)
    bm = _pixel_matrix(cam, s, dev, dt)
    rot = _rotation(p["quats"].to(dt))
    l0 = rot[:, :, 0] * scales[:, 0:1]
    l1 = rot[:, :, 1] * scales[:, 1:2]
    rows = []
    for a, homog in ((l0, False), (l1, False), (means, True)):
        for j in range(3):
            v = a[:, 0] * bm[0, j] + a[:, 1] * bm[1, j] + a[:, 2] * bm[2, j]
            rows.append(v + bm[3, j] if homog else v)
    t = dict(zip(SURFEL_T, rows))
    dist = t["t02"] * t["t02"] + t["t12"] * t["t12"] - t["t22"] * t["t22"]
    ok = dist.abs() >= 1e-5
    inv = 1.0 / torch.where(ok, dist, torch.ones_like(dist))
    cxp = (inv * t["t00"] * t["t02"] + inv * t["t10"] * t["t12"]
           + (-inv) * t["t20"] * t["t22"])
    cyp = (inv * t["t01"] * t["t02"] + inv * t["t11"] * t["t12"]
           + (-inv) * t["t21"] * t["t22"])
    # the box is gradient-free
    th = {k: v.detach() for k, v in t.items()}
    inv_h, cx_h, cy_h = inv.detach(), cxp.detach(), cyp.detach()
    tmp_x = (inv_h * th["t00"] * th["t00"] + inv_h * th["t10"] * th["t10"]
             + (-inv_h) * th["t20"] * th["t20"])
    tmp_y = (inv_h * th["t01"] * th["t01"] + inv_h * th["t11"] * th["t11"]
             + (-inv_h) * th["t21"] * th["t21"])
    ext_x = torch.sqrt(torch.clamp(cx_h * cx_h - tmp_x, min=1e-4))
    ext_y = torch.sqrt(torch.clamp(cy_h * cy_h - tmp_y, min=1e-4))
    rx = _grid16(3.0 * ext_x, s["max_ext"])
    ry = _grid16(3.0 * ext_y, s["max_ext"])
    dirs = _normalize(means - cam["cam_pos"].to(dev, dt))
    color = _sh_color(p["rgb"].to(dt), p["sh"].to(dt), dirs, s["sh_degree"])
    visible = visible & ok & (opa >= s["min_alpha"])
    zero = torch.zeros_like(opa)
    out = dict(t)
    out.update({"x": cxp, "y": cyp, "r": color[:, 0], "g": color[:, 1],
                "b": color[:, 2], "opa": torch.where(visible, opa, zero),
                "depth": cz.detach(), "rx": torch.where(visible, rx, zero),
                "ry": torch.where(visible, ry, zero), "mask": visible})
    return out


# --- record codecs (straight-through) ----------------------------------------

def _st(v, q):
    """``q``'s value forward, ``v``'s gradient backward."""
    return v + (q - v).detach()


def _f16(v):
    return _st(v, v.detach().half().to(v.dtype))


def _u8(v, scale):
    q = torch.clamp(torch.round(v.detach() * scale), 0.0, 255.0)
    return _st(v, (q / scale).to(v.dtype))


def _px(v, scale):
    q = torch.clamp((v.detach() + PX_OFFSET) * scale, 0.0, 65535.0).floor()
    return _st(v, (q / scale - PX_OFFSET).to(v.dtype))


def _rad_u8(r):
    """Log-radius code, rounded UP (the box only grows)."""
    rd = r.double()
    code = torch.clamp(torch.ceil((torch.log2(1.0 + torch.clamp(rd, min=0.0))
                                   - 1e-6) * RAD_LOG), 0.0, 255.0)
    return (torch.exp2(code / RAD_LOG) - 1.0).to(r.dtype)


def apply_codecs(f: dict, s: dict) -> dict:
    """The record precision's rounding: ``mixed`` rounds colour and opacity
    through float16; ``packed`` (3D) puts positions on a 1/16-px grid
    (1/8 px past ~2K), the conic through float16, colour and opacity
    through 8 bits and the box through an 8-bit log code."""
    prec = s["precision"]
    out = dict(f)
    if prec == "f32":
        return out
    if prec == "mixed" or s["mode_2d"]:
        for k in ("r", "g", "b", "opa"):
            out[k] = _f16(f[k])
        return out
    span = max(s["width"], s["height"]) + 2.0 * PX_OFFSET
    scale = 16.0 if span * 16.0 <= 65536.0 else 8.0
    out["x"], out["y"] = _px(f["x"], scale), _px(f["y"], scale)
    for k in ("ca", "cb", "cc"):
        out[k] = _f16(f[k])
    for k in ("r", "g", "b"):
        out[k] = _u8(f[k], COLOR_U8)
    out["opa"] = _u8(f["opa"], 255.0)
    out["rx"], out["ry"] = _rad_u8(f["rx"]), _rad_u8(f["ry"])
    return out


# --- per fragment ------------------------------------------------------------

def _order_keys(f: dict, s: dict):
    """Per splat: the quantised depth bucket and the rect of tiles the
    binning gives it (for the slot order of ties)."""
    mask = f["mask"]
    depth = f["depth"].float()
    big = 3.0e38
    dmin = torch.where(mask, depth, torch.full_like(depth, big)).min()
    dmax = torch.where(mask, depth, torch.full_like(depth, -big)).max()
    span = torch.clamp(dmax - dmin, min=1e-20)
    nb = (1 << s["sort_bits"]) - 1
    q = torch.floor((torch.where(mask, depth, dmin) - dmin)
                    * torch.div(torch.full_like(span, nb), span)).long()
    q = torch.clamp(q, 0, nb)
    ts = float(s["tile"])
    tiles_x = -(-s["width"] // s["tile"])
    tiles_y = -(-s["height"] // s["tile"])
    x, y = f["x"].detach().float(), f["y"].detach().float()
    rx, ry = f["rx"].float(), f["ry"].float()

    def tile_of(v):
        return torch.clamp(torch.floor(v / ts), -2.0 ** 30, 2.0 ** 30).long()

    tx0 = torch.clamp(tile_of(x - rx), 0, tiles_x - 1)
    tx1 = torch.clamp(tile_of(x + rx), 0, tiles_x - 1)
    ty0 = torch.clamp(tile_of(y - ry), 0, tiles_y - 1)
    ty1 = torch.clamp(tile_of(y + ry), 0, tiles_y - 1)
    return q, tx0, ty0, tx1 - tx0 + 1, ty1 - ty0 + 1


def _lane(tx, ty, tx0, ty0, wt, ht, lanes):
    """The slot group of a splat's pair in tile (tx, ty): lane k for a
    splat whose rect the lanes cover, ``lanes`` for the others (aux)."""
    counts = wt * ht
    first = (tx == tx0) & (ty == ty0)
    if lanes == 1:
        return torch.where(counts == 1, 0, 1)
    if lanes == 2:
        small = (counts >= 1) & (counts <= 2)
        return torch.where(small, torch.where(first, 0, 1), 2)
    small = (wt <= 2) & (ht <= 2)
    return torch.where(small, (tx - tx0) + 2 * (ty - ty0), 4)


def _alpha_3d(f, sid, px, py, s):
    dt = f["x"].dtype
    dx = (px.to(dt) + 0.5) - f["x"][sid]
    dy = (py.to(dt) + 0.5) - f["y"][sid]
    g = (f["ca"][sid] * dx * dx + 2.0 * f["cb"][sid] * dx * dy
         + f["cc"][sid] * dy * dy)
    alpha = f["opa"][sid] * torch.exp(-0.5 * g)
    keep = ((g <= GAUSS_CUTOFF) & (alpha >= s["min_alpha"])
            & (dx.abs() <= f["rx"][sid]) & (dy.abs() <= f["ry"][sid]))
    return torch.where(keep, torch.clamp(alpha, max=ALPHA_CLAMP_3D),
                       torch.zeros_like(alpha)), keep


def _alpha_2d(f, sid, px, py, s):
    dt = f["x"].dtype
    pxc, pyc = px.to(dt) + 0.5, py.to(dt) + 0.5
    t = [f[k][sid] for k in SURFEL_T]
    k0, k1, k2 = pxc * t[2] - t[0], pxc * t[5] - t[3], pxc * t[8] - t[6]
    l0, l1, l2 = pyc * t[2] - t[1], pyc * t[5] - t[4], pyc * t[8] - t[7]
    p0 = k1 * l2 - k2 * l1
    p1 = k2 * l0 - k0 * l2
    p2 = k0 * l1 - k1 * l0
    tiny = p2.abs() < 1e-12
    p2s = torch.where(tiny, torch.full_like(p2, 1e-12), p2)
    su, sv = p0 / p2s, p1 / p2s
    rho3 = su * su + sv * sv
    dx, dy = pxc - f["x"][sid], pyc - f["y"][sid]
    rho2 = 2.0 * (dx * dx + dy * dy)
    use3 = rho3 <= rho2
    rho = torch.where(use3, rho3, rho2)
    depth = torch.where(use3, su * t[2] + sv * t[5] + t[8], t[8])
    alpha = torch.clamp(f["opa"][sid] * torch.exp(-0.5 * rho),
                        max=ALPHA_MAX_2D)
    keep = (~tiny & (depth >= NEAR_2D) & (alpha >= s["min_alpha"])
            & (dx.abs() <= f["rx"][sid]) & (dy.abs() <= f["ry"][sid]))
    return torch.where(keep, alpha, torch.zeros_like(alpha)), keep


def _pixel_ranges(f, s):
    """Per splat, the pixel columns and rows whose centres may lie in its
    box (a 1e-3 px margin for rounding; the exact test is per fragment)."""
    x, y = f["x"].detach().float(), f["y"].detach().float()
    rx, ry = f["rx"].float(), f["ry"].float()
    w, h = s["width"], s["height"]
    x0 = torch.clamp(torch.ceil(x - rx - 0.5 - 1e-3), 0, w).long()
    x1 = torch.clamp(torch.floor(x + rx - 0.5 + 1e-3), -1, w - 1).long()
    y0 = torch.clamp(torch.ceil(y - ry - 0.5 - 1e-3), 0, h).long()
    y1 = torch.clamp(torch.floor(y + ry - 0.5 + 1e-3), -1, h - 1).long()
    ok = f["mask"] & (x1 >= x0) & (y1 >= y0)
    return x0, x1, y0, y1, ok


def _row_blocks(ranges, h):
    """Blocks of image rows [r0, r1) holding at most FRAGMENT_BUDGET
    candidate fragments each (one row may exceed it alone)."""
    x0, x1, y0, y1, ok = ranges
    nx = torch.where(ok, x1 - x0 + 1, torch.zeros_like(x0))
    per_row = torch.zeros(h + 1, dtype=torch.int64, device=x0.device)
    per_row.index_add_(0, torch.clamp(y0, max=h), nx)
    per_row.index_add_(0, torch.clamp(y1 + 1, max=h), -nx)
    rows = torch.cumsum(per_row, 0)[:h].tolist()
    blocks, start, acc = [], 0, 0
    for r, n in enumerate(rows):
        if acc and acc + n > FRAGMENT_BUDGET:
            blocks.append((start, r))
            start, acc = r, 0
        acc += n
    blocks.append((start, h))
    return blocks


def _expand(ranges, r0, r1):
    """The candidate fragments (splat id, pixel x, pixel y) of rows
    [r0, r1)."""
    x0, x1, y0, y1, ok = ranges
    sel = torch.nonzero(ok & (y0 < r1) & (y1 >= r0)).squeeze(1)
    nx = (x1 - x0 + 1)[sel]
    ylo = torch.clamp(y0[sel], min=r0)
    ny = torch.clamp(torch.clamp(y1[sel], max=r1 - 1) - ylo + 1, min=0)
    cnt = nx * ny
    total = int(cnt.sum())
    owner = torch.repeat_interleave(torch.arange(sel.shape[0],
                                                 device=sel.device),
                                    cnt, output_size=total)
    k = torch.arange(total, device=sel.device) - (torch.cumsum(cnt, 0)
                                                  - cnt)[owner]
    nxo = nx[owner]
    return sel[owner], x0[sel][owner] + k % nxo, ylo[owner] + k // nxo


def _runs(pix):
    """Index of the first entry of each entry's run of equal ``pix``."""
    idx = torch.arange(pix.shape[0], device=pix.device)
    first = torch.ones_like(pix, dtype=torch.bool)
    first[1:] = pix[1:] != pix[:-1]
    return torch.cummax(torch.where(first, idx, torch.zeros_like(idx)),
                        0).values


def _transmittance(alpha, pix, acc):
    """T in front of each fragment: exp of the run sum of log(1 - alpha)
    before it, taken in ``acc``."""
    logw = torch.log1p(-alpha.to(acc))
    excl = torch.cumsum(logw, 0) - logw
    return torch.exp(excl - excl[_runs(pix)])


class Frame:
    """One view's per-splat records and the order of its fragments."""

    def __init__(self, f: dict, s: dict):
        self.f, self.s = f, s
        self.alpha_fn = _alpha_2d if s["mode_2d"] else _alpha_3d
        self.q, self.tx0, self.ty0, self.wt, self.ht = _order_keys(f, s)
        self.ranges = _pixel_ranges(f, s)
        self.n = f["x"].shape[0]
        self.tie_bits = max(1, (self.n * (s["lanes"] + 1)).bit_length())
        self.pix_shift = s["sort_bits"] + self.tie_bits
        npix = s["width"] * s["height"]
        if npix.bit_length() + self.pix_shift > 63:
            raise ValueError("fragment sort key exceeds 63 bits")

    def blocks(self):
        return _row_blocks(self.ranges, self.s["height"])

    def live(self, r0, r1, acc):
        """The block's fragments that add to a pixel, in front-to-back
        order per pixel: (splat id, x, y), without gradients."""
        s, f = self.s, self.f
        with torch.no_grad():
            sid, px, py = _expand(self.ranges, r0, r1)
            alpha, keep = self.alpha_fn(f, sid, px, py, s)
            sid, px, py, alpha = sid[keep], px[keep], py[keep], alpha[keep]
            ts = s["tile"]
            lane = _lane(px // ts, py // ts, self.tx0[sid], self.ty0[sid],
                         self.wt[sid], self.ht[sid], s["lanes"])
            pix = py * s["width"] + px
            key = ((pix << self.pix_shift) | (self.q[sid] << self.tie_bits)
                   | (lane * self.n + sid))
            order = torch.argsort(key)
            sid, px, py, alpha = sid[order], px[order], py[order], alpha[order]
            trans = _transmittance(alpha, pix[order], acc)
            live = trans >= LIVE_T
            return sid[live], px[live], py[live]

    def composite(self, sid, px, py, r0, r1, acc):
        """[rows, W, 3] colour and [rows, W] alpha of rows [r0, r1) (GL
        rows, bottom first), differentiable in the records."""
        s, f = self.s, self.f
        w = s["width"]
        alpha, _ = self.alpha_fn(f, sid, px, py, s)
        pix = (py - r0) * w + px
        wgt = alpha.to(acc) * _transmittance(alpha, pix, acc)
        npix = (r1 - r0) * w
        chans = torch.stack([f["r"][sid], f["g"][sid], f["b"][sid]],
                            -1).to(acc)
        col = torch.zeros((npix, 3), dtype=acc, device=alpha.device)
        col = col.index_add(0, pix, chans * wgt[:, None])
        a = torch.zeros(npix, dtype=acc, device=alpha.device).index_add(
            0, pix, wgt)
        bg = torch.tensor(s["background"], dtype=acc, device=alpha.device)
        col = col + (1.0 - a)[:, None] * bg
        return col.reshape(r1 - r0, w, 3), a.reshape(r1 - r0, w)


def _accumulator(dt):
    return torch.float64 if dt in (torch.float32, torch.float64) \
        else torch.float32


def project(p: dict, cam: dict, s: dict, dt=torch.float32) -> dict:
    f = (project_2d if s["mode_2d"] else project_3d)(p, cam, s, dt)
    return apply_codecs(f, s)


def render(p: dict, cam: dict, s: dict, dt=torch.float32):
    """``{"color": [H, W, 3], "alpha": [H, W]}`` float32, row 0 at the top,
    without gradients."""
    acc = _accumulator(dt)
    with torch.no_grad():
        fr = Frame(project(p, cam, s, dt), s)
        h, w = s["height"], s["width"]
        color = torch.empty((h, w, 3), dtype=torch.float32,
                            device=p["means"].device)
        alpha = torch.empty((h, w), dtype=torch.float32,
                            device=p["means"].device)
        for r0, r1 in fr.blocks():
            sid, px, py = fr.live(r0, r1, acc)
            c, a = fr.composite(sid, px, py, r0, r1, acc)
            # GL row y is image row h - 1 - y
            color[h - r1:h - r0] = c.flip(0).float()
            alpha[h - r1:h - r0] = a.flip(0).float()
    return {"color": color, "alpha": alpha}


def loss_and_grads(p: dict, cam: dict, target: torch.Tensor, s: dict,
                   dt=torch.float32):
    """The mean squared error of the render against ``target`` [H, W, 3]
    (row 0 at the top) over every pixel and channel, and its gradient with
    respect to every field of ``p`` (float32 leaves).  The per-pixel part
    runs block by block, each block's backward into leaf copies of the
    per-splat records; then one backward through the projection."""
    acc = _accumulator(dt)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
    f = project(leaves, cam, s, dt)
    diff_keys = [k for k, v in f.items()
                 if torch.is_tensor(v) and v.requires_grad]
    rec = {k: (f[k].detach().requires_grad_(True) if k in diff_keys
               else f[k]) for k in f}
    fr = Frame(rec, s)
    h, w = s["height"], s["width"]
    inv = 1.0 / (h * w * 3)
    loss = 0.0
    for r0, r1 in fr.blocks():
        sid, px, py = fr.live(r0, r1, acc)
        c, _ = fr.composite(sid, px, py, r0, r1, acc)
        tgt = target[h - r1:h - r0].flip(0).to(acc)
        part = ((c - tgt) ** 2).sum() * inv
        part.backward()
        loss += float(part.detach())
    grads_out = [rec[k].grad if rec[k].grad is not None
                 else torch.zeros_like(rec[k]) for k in diff_keys]
    torch.autograd.backward([f[k] for k in diff_keys], grads_out)
    grads = {k: (leaves[k].grad if leaves[k].grad is not None
                 else torch.zeros_like(leaves[k])).float()
             for k in p}
    return loss, grads


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8), written out."""

    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: dict, grads: dict):
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            params[k] = params[k] - self.lr * (self.m[k] / bc1) / (
                torch.sqrt(self.v[k] / bc2) + self.eps)


def train(p0: dict, cams: list, targets: list, s: dict, lr: float,
          dt=torch.float32):
    """Steps of the reference training from ``p0``, one per (camera,
    target): each step's loss, each field's first gradient norm and, after
    the last step, each field's change from ``p0`` (norms in float64)."""
    params = {k: v.clone() for k, v in p0.items()}
    opt = Adam(params, lr)
    losses, first = [], None
    for cam, tgt in zip(cams, targets):
        loss, grads = loss_and_grads(params, cam, tgt, s, dt)
        losses.append(loss)
        if first is None:
            first = {k: float(torch.linalg.norm(g.double()))
                     for k, g in grads.items()}
        opt.step(params, grads)
        del grads
    change = {k: float(torch.linalg.norm((params[k] - p0[k]).double()))
              for k in p0}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
