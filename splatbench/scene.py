"""The benchmark's inputs, drawn from ``--seed``: the scene's parameters,
the cameras and the training targets.

Everything here is plain PyTorch and imports nothing of the program, so
the program and the reference are handed the same tensors.  The scene is
drawn on the device in a few large calls; the camera poses, which are a
few dozen numbers, are drawn on the host from the same seed.

Parameters are the training form: ``means``, ``log_scales``, ``quats``
(x, y, z, w, unnormalised), ``rgb``, ``logit_opacity``, ``sh`` [N, K, 3].
"""

from __future__ import annotations

import math

import torch

SH_COEFFS = {0: 0, 1: 3, 2: 8, 3: 15}
FIELDS = ("means", "log_scales", "quats", "rgb", "logit_opacity", "sh")


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def draw_params(config: dict, seed: int, device) -> dict:
    """The scene of ``config["scene"]`` as training parameters on
    ``device``: means uniform in [-extent, extent]^3, scales uniform in
    [scale_lo, scale_hi] * extent * scale_mult, quaternions normalised
    Gaussians, rgb uniform in [0, 1], opacity uniform in [opacity_lo,
    opacity_hi], SH coefficients sh_std * N(0, 1).  Two calls to the
    generator: one uniform block, one normal block."""
    sc = config["scene"]
    n = int(config["splats"])
    k = SH_COEFFS[int(config["sh_degree"])]
    gen = _gen(seed, device)
    u = torch.rand((n, 10), generator=gen, device=device)
    g = torch.randn((n, 4 + 3 * k), generator=gen, device=device)
    ext = float(sc["extent"])
    means = u[:, 0:3] * (2.0 * ext) - ext
    lo, hi = sc["scale_lo"], sc["scale_hi"]
    scales = (u[:, 3:6] * (hi - lo) + lo) * (ext * sc["scale_mult"])
    rgb = u[:, 6:9].clone()
    olo, ohi = sc["opacity_lo"], sc["opacity_hi"]
    opacity = u[:, 9] * (ohi - olo) + olo
    quats = g[:, 0:4]
    quats = quats / torch.clamp(torch.linalg.norm(quats, dim=1,
                                                  keepdim=True), min=1e-12)
    sh = (g[:, 4:] * float(sc["sh_std"])).reshape(n, k, 3)
    return {"means": means.contiguous(), "log_scales": torch.log(scales),
            "quats": quats.contiguous(), "rgb": rgb,
            "logit_opacity": torch.log(opacity / (1.0 - opacity)),
            "sh": sh.contiguous()}


# --- cameras ---------------------------------------------------------------

def look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """World -> camera matrix (float64, nested lists) of a camera at
    ``eye`` looking at ``target``, down its local -Z axis."""
    def sub(a, b):
        return [a[i] - b[i] for i in range(3)]

    def cross(a, b):
        return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0]]

    def unit(a):
        n = math.sqrt(sum(x * x for x in a))
        return [x / n for x in a]

    z = unit(sub(eye, target))
    x = unit(cross(list(up), z))
    y = cross(z, x)
    view = [x + [-sum(x[i] * eye[i] for i in range(3))],
            y + [-sum(y[i] * eye[i] for i in range(3))],
            z + [-sum(z[i] * eye[i] for i in range(3))],
            [0.0, 0.0, 0.0, 1.0]]
    return view


def perspective(fov_y_deg: float, aspect: float, near: float, far: float):
    """GL perspective projection (float64, nested lists)."""
    f = 1.0 / math.tan(math.radians(fov_y_deg) / 2.0)
    return [[f / aspect, 0.0, 0.0, 0.0], [0.0, f, 0.0, 0.0],
            [0.0, 0.0, (far + near) / (near - far),
             2.0 * far * near / (near - far)],
            [0.0, 0.0, -1.0, 0.0]]


def orbit_eye(radius: float, elevation_deg: float, azimuth_deg: float):
    e, a = math.radians(elevation_deg), math.radians(azimuth_deg)
    return [radius * math.cos(e) * math.cos(a), radius * math.sin(e),
            radius * math.cos(e) * math.sin(a)]


def camera_of(config: dict, eye) -> dict:
    """A camera as float32 tensors on the CPU: ``view`` [4, 4], ``proj``
    [4, 4], ``cam_pos`` [3], looking at the origin."""
    cam = config["camera"]
    proj = perspective(cam["fov_y_deg"], config["width"] / config["height"],
                       cam["near"], cam["far"])
    return {"view": torch.tensor(look_at(eye), dtype=torch.float32),
            "proj": torch.tensor(proj, dtype=torch.float32),
            "cam_pos": torch.tensor(eye, dtype=torch.float32),
            "eye": tuple(eye)}


def ring_views(config: dict, params: dict) -> list:
    """``params["views"]`` training views on a ring around the origin.
    Every seed gets the same views: radii, elevations and azimuths
    stratified over ``params["radius"]``, ``params["elevation_deg"]`` and
    the full turn, paired in one fixed order.  The seed orders them
    (``view_order``) and draws the scene and the targets, so every seed
    trains on the same amount of work."""
    n = int(params["views"])
    gen = torch.Generator().manual_seed(0)
    r0, r1 = params["radius"]
    e0, e1 = params["elevation_deg"]
    radii = [r0 + (r1 - r0) * (i + 0.5) / n for i in range(n)]
    elev = [e0 + (e1 - e0) * (i + 0.5) / n for i in range(n)]
    azim = [360.0 * (i + 0.5) / n for i in range(n)]
    pe = torch.randperm(n, generator=gen).tolist()
    pa = torch.randperm(n, generator=gen).tolist()
    return [camera_of(config, orbit_eye(radii[i], elev[pe[i]], azim[pa[i]]))
            for i in range(n)]


def view_order(num_views: int, seed: int, count: int) -> list:
    """Which view each of ``count`` steps takes: a new permutation of the
    views every ``num_views`` steps, so any window of that many steps
    takes each view once and the first steps take distinct views."""
    gen = torch.Generator().manual_seed(int(seed) + 1)
    out = []
    while len(out) < count:
        out += torch.randperm(num_views, generator=gen).tolist()
    return out[:count]


class Orbit:
    """A viewer's camera path: the azimuth advances by a step drawn
    uniformly from ``params["azimuth_step_deg"]`` each frame; the radius
    and the elevation swing sinusoidally over their ranges with periods of
    ``radius_period`` and ``elevation_period`` frames, from phases drawn
    from the seed (so every seed sweeps the same ranges)."""

    def __init__(self, config: dict, params: dict, seed: int):
        self.config = config
        self.p = params
        self.gen = torch.Generator().manual_seed(int(seed) + 2)
        ph = torch.rand(3, generator=self.gen, dtype=torch.float64).tolist()
        self.r_phase, self.e_phase = ph[0], ph[1]
        self.azimuth = ph[2] * 360.0
        self.frame = 0

    def pose(self, i: int):
        p = self.p
        r0, r1 = p["radius"]
        e0, e1 = p["elevation_deg"]
        r = r0 + (r1 - r0) * 0.5 * (1.0 + math.sin(
            2.0 * math.pi * (i / p["radius_period"] + self.r_phase)))
        e = e0 + (e1 - e0) * 0.5 * (1.0 + math.sin(
            2.0 * math.pi * (i / p["elevation_period"] + self.e_phase)))
        return r, e

    def next(self) -> dict:
        a0, a1 = self.p["azimuth_step_deg"]
        step = a0 + (a1 - a0) * float(torch.rand(
            1, generator=self.gen, dtype=torch.float64))
        self.azimuth = (self.azimuth + step) % 360.0
        r, e = self.pose(self.frame)
        self.frame += 1
        return camera_of(self.config, orbit_eye(r, e, self.azimuth))


# --- targets ---------------------------------------------------------------

def draw_targets(config: dict, params: dict, seed: int, device):
    """One smooth target image [H, W, 3] per view, row 0 at the top: a
    coarse grid of uniform colours (``params["target_grid"]`` rows and
    columns) drawn from the seed and bilinearly upsampled, in one call.
    Returns [V, H, W, 3] float32."""
    gh, gw = params["target_grid"]
    gen = _gen(int(seed) + 3, device)
    coarse = torch.rand((int(params["views"]), 3, gh, gw), generator=gen,
                        device=device)
    img = torch.nn.functional.interpolate(
        coarse, size=(config["height"], config["width"]), mode="bilinear",
        align_corners=True)
    return img.permute(0, 2, 3, 1).contiguous()
