"""Scene-composition helpers: depth compositing + overlays (counterpart of
the JAX package's ``viewer/helpers.py``; torch on the image's or camera's
device).

The functional analogue of the reference's SceneHelper
(src/SceneHelper.js):

- The reference renders splats into an offscreen target, then draws a
  full-screen quad that alpha-blends the splat color while writing the
  splat depth to ``gl_FragDepth`` (SceneHelper.js:38-91,
  ``setupRenderTargetCopyObjects``) so ordinary depth-tested meshes
  composite correctly with the splat scene.  :func:`composite_with_depth`
  is the same operation as a pure image-space function over the render's
  ``color``/``alpha``/``depth`` channels (``RenderConfig.return_depth``).
- The reference's focus marker is a camera-facing anti-aliased ring drawn
  at the raycast hit on double-click (SceneHelper.js:146-197 +
  ``buildFocusMarkerMaterial`` :355-430: radius 0.06 * viewport height,
  line width 0.0005 * h, ~5 px alpha falloff, animated opacity).
  :func:`focus_marker_overlay` reproduces the fragment math;
  :func:`apply_overlay` blends it (the marker renders with depth test
  off, exactly like the reference's material).
- The control-plane renderable (SceneHelper.js:199-247: translucent
  white plane + green up-arrow, depth test off) is
  :func:`control_plane_overlay`.  The remaining debug spheres
  (createDebugMeshes :268-281) are browser-DOM-only chrome.
"""

from __future__ import annotations

import torch

from ..core.types import Camera


def composite_with_depth(splat_out: dict, other_color: torch.Tensor,
                         other_depth: torch.Tensor) -> dict:
    """Depth-composite a splat render with other (opaque) 3D content.

    Per pixel, mirrors the reference's render order (SceneHelper.js:38-91:
    splat quad writes its depth, later meshes depth-test against it):
    where the other content is closer than the splat surface it occludes
    the splats; otherwise the splat scene alpha-blends OVER it.

    Args:
      splat_out: dict from ``render(..., cfg.return_depth=True)`` —
        ``color`` [H, W, 3], ``alpha`` [H, W], ``depth`` [H, W]
        (0 where no splat was hit).
      other_color: [H, W, 3] opaque content color.
      other_depth: [H, W] its depth in the same units as ``depth``
        (+inf where empty).

    Returns dict with merged ``color`` [H, W, 3] and ``depth`` [H, W]
    (the nearer of the two surfaces per pixel) for further chaining.
    """
    s_color = splat_out["color"]
    s_alpha = splat_out["alpha"]
    s_depth = splat_out["depth"]
    hit = s_alpha > 1e-6
    s_d = torch.where(hit, s_depth, torch.full_like(s_depth, float("inf")))
    splat_in_front = hit & (s_d <= other_depth)
    a = s_alpha[..., None]
    over = s_color + (1.0 - a) * other_color     # color is premultiplied
    color = torch.where(splat_in_front[..., None], over, other_color)
    depth = torch.minimum(s_d, other_depth)
    return {"color": color, "depth": depth}


def _vec(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def project_to_screen(camera: Camera, position, width: int, height: int):
    """World position -> raster pixel coordinates (x right, y DOWN, centers
    at +0.5 — matching ``assemble_image``'s row flip) plus clip w."""
    dev = camera.view.device
    p = _vec(position, dev)
    vh = camera.view @ torch.cat([p, torch.ones(1, device=dev)])
    ch = camera.proj @ vh
    w = ch[3]
    ndc = ch[:2] / torch.where(w.abs() < 1e-12,
                               torch.full_like(w, 1e-12), w)
    x = (ndc[0] * 0.5 + 0.5) * width
    y = (1.0 - (ndc[1] * 0.5 + 0.5)) * height
    return torch.stack([x, y]), w


def _pixel_grid(height, width, device):
    """(yy, xx) [H, W] pixel-centre coordinates."""
    return torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device) + 0.5,
        torch.arange(width, dtype=torch.float32, device=device) + 0.5,
        indexing="ij")


def _rgba(color, alpha):
    rgb = _vec(color, alpha.device).expand(*alpha.shape, 3)
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def focus_marker_overlay(camera: Camera, position, width: int, height: int,
                         opacity: float = 1.0,
                         color=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """RGBA overlay [H, W, 4] with the reference's focus-marker ring.

    Fragment math from SceneHelper.buildFocusMarkerMaterial
    (SceneHelper.js:387-413): ring radius ``0.06 * h`` px, line width
    ``0.0005 * h``, alpha = 1 - clamp((|r - radius| - lw) / 5, 0, 1),
    scaled by the animated ``opacity`` uniform.  Behind-camera positions
    produce a fully transparent overlay.
    """
    center, w = project_to_screen(camera, position, width, height)
    yy, xx = _pixel_grid(height, width, center.device)
    r = torch.sqrt((xx - center[0]) ** 2 + (yy - center[1]) ** 2)
    radius = 0.06 * height
    line_width = 0.0005 * height
    rad_diff = (r - radius).abs() - line_width
    alpha = 1.0 - torch.clamp(rad_diff / 5.0, 0.0, 1.0)
    alpha = alpha * float(opacity) * (w > 0.0)
    return _rgba(color, alpha)


def apply_overlay(color_img: torch.Tensor, overlay_rgba: torch.Tensor
                  ) -> torch.Tensor:
    """Alpha-blend an RGBA overlay over a color image (depth test off,
    like the reference's marker material)."""
    a = overlay_rgba[..., 3:4]
    return overlay_rgba[..., :3] * a + color_img * (1.0 - a)


_CURSOR_WORLD_SCALE = 0.1   # SceneHelper.js:114 meshCursor.scale


def mesh_cursor_overlay(camera: Camera, position, width: int, height: int,
                        color=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """RGBA overlay with the reference's mesh cursor at a raycast hit.

    The reference's cursor is four inward-pointing cones around the hit,
    always facing the camera, at fixed world scale 0.1
    (SceneHelper.js:93-145 ``setupMeshCursor`` /
    ``positionAndOrientMeshCursor``).  Camera-facing at constant world
    size means it reads as a flat screen-space glyph whose pixel size
    tracks the projected world scale — which is exactly how it is drawn
    here: four inward triangles at the projected hit, sized by projecting
    the 0.1-world-unit cursor extent.  Behind-camera hits are transparent.
    """
    center, w = project_to_screen(camera, position, width, height)
    # projected pixel size of the cursor's ~0.175-world-unit arm reach
    # (cone tip at 1.75 * scale from center along each axis)
    p = _vec(position, center.device)
    right = torch.linalg.inv(camera.view)[:3, 0]
    edge, _ = project_to_screen(camera, p + right * (_CURSOR_WORLD_SCALE
                                                     * 1.75),
                                width, height)
    r = torch.clamp(torch.linalg.norm(edge - center), min=2.0)

    yy, xx = _pixel_grid(height, width, center.device)
    dx = xx - center[0]
    dy = yy - center[1]

    def arrow(u, v):
        """Inward triangle along unit direction (u, v): tip at 0.25 r,
        base at r, half-width r / 3."""
        along = dx * u + dy * v            # distance toward the base
        across = (dx * -v + dy * u).abs()
        frac = (along - 0.25 * r) / (0.75 * r)
        return ((frac >= 0.0) & (frac <= 1.0)
                & (across <= frac * (r / 3.0)))

    inside = (arrow(1.0, 0.0) | arrow(-1.0, 0.0)
              | arrow(0.0, 1.0) | arrow(0.0, -1.0))
    alpha = inside.to(torch.float32) * (w > 0.0)
    return _rgba(color, alpha)


def control_plane_overlay(camera: Camera, position, up,
                          width: int, height: int) -> torch.Tensor:
    """RGBA overlay with the reference's control-plane renderable.

    SceneHelper.setupControlPlane (SceneHelper.js:199-247): a 1x1
    world-unit double-sided white plane at 0.6 opacity, oriented
    perpendicular to ``up`` (the plane's normal), plus a green up-arrow of
    length 0.5 from its center — depth test off, so it is drawn as a
    screen overlay like the cursor/focus marker.  Rasterized here by
    projecting the quad corners and arrow segment and testing pixels in
    screen space; behind-camera geometry is transparent.
    """
    dev = camera.view.device
    p = _vec(position, dev)
    upv = _vec(up, dev)
    upv = upv / torch.clamp(torch.linalg.norm(upv), min=1e-12)
    # plane basis perpendicular to up (setFromUnitVectors semantics)
    ref = _vec((0.0, 1.0, 0.0) if abs(float(upv[1])) < 0.9
               else (1.0, 0.0, 0.0), dev)
    bx = torch.linalg.cross(upv, ref)
    bx = bx / torch.clamp(torch.linalg.norm(bx), min=1e-12)
    bz = torch.linalg.cross(bx, upv)

    corners = [p + 0.5 * (sx * bx + sz * bz)
               for sx, sz in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
    proj = [project_to_screen(camera, c, width, height) for c in corners]
    pts = torch.stack([pc for pc, _ in proj])            # [4, 2]
    ws = torch.stack([pw for _, pw in proj])

    yy, xx = _pixel_grid(height, width, dev)

    def halfplane(a, b):
        return ((b[0] - a[0]) * (yy - a[1]) - (b[1] - a[1]) * (xx - a[0]))

    edges = torch.stack([halfplane(pts[i], pts[(i + 1) % 4])
                         for i in range(4)])
    # double-sided: inside if consistently left OR right of every edge
    inside = (edges >= 0.0).all(dim=0) | (edges <= 0.0).all(dim=0)
    plane_alpha = inside.to(torch.float32) * 0.6 * (ws > 0.0).all()

    # green up-arrow: segment p -> p + 0.5 * up, width from the reference's
    # 0.01-world-unit shaft radius
    a2, wa = project_to_screen(camera, p, width, height)
    b2, wb = project_to_screen(camera, p + 0.5 * upv, width, height)
    e2, _ = project_to_screen(camera, p + 0.01 * bx, width, height)
    half_w = torch.clamp(torch.linalg.norm(e2 - a2), min=1.0)
    d = b2 - a2
    seg_len2 = torch.clamp(torch.sum(d * d), min=1e-12)
    t = torch.clamp(((xx - a2[0]) * d[0] + (yy - a2[1]) * d[1]) / seg_len2,
                    0.0, 1.0)
    px_ = a2[0] + t * d[0]
    py_ = a2[1] + t * d[1]
    dist = torch.sqrt((xx - px_) ** 2 + (yy - py_) ** 2)
    arrow_alpha = ((dist <= half_w).to(torch.float32) * (wa > 0)
                   * (wb > 0))

    white = _vec((1.0, 1.0, 1.0), dev)
    green = _vec((0.0, 0xDD / 255.0, 0.0), dev)
    rgb = torch.where(arrow_alpha[..., None] > 0.0, green, white)
    alpha = torch.maximum(plane_alpha, arrow_alpha)
    return torch.cat([rgb, alpha[..., None]], dim=-1)
