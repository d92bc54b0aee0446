"""Headless InfoPanel: the reference's debug-info aggregation as data
(counterpart of the JAX package's ``viewer/info_panel.py``).

The reference's InfoPanel (src/ui/InfoPanel.js:12-147) is a DOM table
updated once per frame from Viewer.update (src/Viewer.js:1804-1822) with: camera position /
look-at / up, projection mode, cursor position, FPS, render window,
rendered-splat count (+ percent of total), last sort time, focal
adjustment, splat scale and point-cloud mode.  There is no DOM here, so
the panel is a pure aggregator: :meth:`update` gathers the same rows
from a :class:`~gaussiansplats3d_tpu_torch.viewer.viewer.Viewer`, a camera
and an optional :class:`~gaussiansplats3d_tpu_torch.utils.metrics.FrameStats`,
returning a dict; :meth:`format_text` renders the reference's
label-value table as plain text (for terminals, logs or overlays).

Row mapping notes: the reference's ``splatRenderCount`` is the number of
splats its sort included this frame; the tiled pipeline's analogue is
the pair count actually composited (``FrameStats.num_pairs``, reported
next to the total splat count), and its single-threaded ``lastSortTime``
maps to the whole on-device frame time (the sort is fused into the
render here).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.types import Camera
from ..utils.metrics import FrameStats


def _vec3(v) -> str:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    a = np.asarray(v, np.float64).reshape(-1)[:3]
    return ", ".join(f"{x:.5f}" for x in a)


class InfoPanel:
    """Aggregates the reference InfoPanel's per-frame rows as data."""

    LABELS = {
        "cameraPosition": "Camera position",
        "cameraLookAt": "Camera look-at",
        "cameraUp": "Camera up",
        "orthographicCamera": "Camera mode",
        "cursorPosition": "Cursor position",
        "fps": "FPS",
        "renderWindow": "Render window",
        "renderSplatCount": "Splat render count",
        "sortTime": "Sort time",
        "focalAdjustment": "Focal adjustment",
        "splatScale": "Splat scale",
        "pointCloudMode": "Point cloud mode",
    }

    def __init__(self):
        self.rows: dict = {}
        self.visible = False           # show/hide parity (no DOM to hide)

    def set_visibility(self, visible: bool) -> None:
        self.visible = bool(visible)

    def update(self, viewer, camera: Optional[Camera] = None,
               stats: Optional[FrameStats] = None,
               look_at=None, cursor_position=None) -> dict:
        """Gather the panel rows; returns {key: formatted string}.

        ``look_at`` defaults to the viewer's orbit-controls target when
        present (the reference reads it off its OrbitControls);
        ``cursor_position`` is the raycast hit under the mesh cursor
        (``None`` renders as the reference's 'N/A').
        """
        cam = camera if camera is not None else viewer._current_camera(None)
        cfg = viewer.config
        view = cam.view.detach().cpu().numpy().astype(np.float64)
        # camera basis rows in world space: view rotation transposed
        up = view[:3, :3].T @ np.array([0.0, 1.0, 0.0])
        if look_at is None:
            # the Viewer embeds its OrbitCamera as .camera (viewer.py);
            # its .target is the reference's OrbitControls look-at
            look_at = getattr(getattr(viewer, "camera", None),
                              "target", None)

        rows = {
            "cameraPosition": _vec3(cam.cam_pos),
            "cameraLookAt": _vec3(look_at) if look_at is not None else "N/A",
            "cameraUp": _vec3(up),
            "orthographicCamera": ("Orthographic" if cfg.orthographic
                                   else "Perspective"),
            "cursorPosition": (_vec3(cursor_position)
                               if cursor_position is not None else "N/A"),
            "renderWindow": f"{cfg.width} x {cfg.height}",
            "focalAdjustment": f"{cfg.focal_adjustment:.3f}",
            "splatScale": f"{cfg.splat_scale:.3f}",
            "pointCloudMode": f"{bool(cfg.point_cloud_mode)}",
        }
        total = sum(s.splats.num_splats for s in viewer._scenes)
        if stats is not None and stats.wall_ms > 0:
            rows["fps"] = f"{1000.0 / stats.wall_ms:.0f}"
            pct = (100.0 * stats.num_pairs / max(total, 1))
            rows["renderSplatCount"] = (
                f"{stats.num_pairs} pairs over {total} splats "
                f"({pct:.2f}%)")
            rows["sortTime"] = f"{stats.wall_ms:.3f} ms (fused frame)"
        else:
            rows["fps"] = "N/A"
            rows["renderSplatCount"] = f"{total} splats"
            rows["sortTime"] = "N/A"
        self.rows = rows
        return rows

    def format_text(self) -> str:
        """The reference's label: value table, as plain text."""
        width = max(len(v) for v in self.LABELS.values())
        return "\n".join(f"{self.LABELS[k].ljust(width)} : {self.rows[k]}"
                         for k in self.LABELS if k in self.rows)
