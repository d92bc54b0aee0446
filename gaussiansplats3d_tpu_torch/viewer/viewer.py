"""The Viewer: scene lifecycle + offscreen rendering (counterpart of the JAX
package's ``viewer/viewer.py``).

API parity with the reference Viewer (src/Viewer.js):
`add_splat_scene` / `add_splat_scenes` (:736, :973), `remove_splat_scene(s)`
(:1322-1429), `get_splat_scene`, scene transforms/opacity/visibility
(dynamic mode, SplatMaterial.js:129-147), raycast picking (:550-581),
orthographic + perspective cameras, 2D/3D splat render modes, point-cloud
mode, render gating (`RenderMode`, shouldRender :1561-1597) — re-imagined
headless: `render()` returns image tensors instead of driving a WebGL
canvas, and the camera is either an embedded OrbitCamera or any `Camera`
you pass.

The splats live on the viewer's ``device`` (``cuda`` unless given
``device="cpu"``); every frame goes through ``render.pipeline.render``, so
on a CUDA device it launches the compositor kernel (B1 in 3D, B3 in 2D)
and never a plain version.  The scene transforms, the render key and the
camera-change gate are host values.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..constants import MAX_SCENES
from ..core.types import Camera, RenderConfig, SplatData
from ..io.optimize import optimize_splat_data as _optimize, take_splats
from ..render.pipeline import render as render_pipeline
from .enums import RenderMode, SceneRevealMode, SplatRenderMode
from .fade import VisibleRegion
from .orbit import OrbitCamera
from .raycaster import Hit, Ray, Raycaster
from .scene import SplatScene

SceneSource = Union[str, SplatData, SplatScene]

# Per-component camera-change epsilon on position and orientation
# quaternion — the reference's shouldRender gate
# (src/Viewer.js:1561-1597, changeEpsilon = 0.0001).
CAMERA_CHANGE_EPSILON = 1e-4


def _rotation_to_quat(m: np.ndarray) -> np.ndarray:
    """3x3 rotation -> quaternion (x, y, z, w), Shepperd's method, in
    numpy: the OnChange gate runs it on every frame, where
    ``math3d.rotmat_to_quat`` would add a dozen small CPU tensor ops."""
    t = np.trace(m)
    if t > 0.0:
        s = np.sqrt(t + 1.0) * 2.0
        return np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 0.0)) * 2.0
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / max(s, 1e-20)
    q[k] = (m[k, i] + m[i, k]) / max(s, 1e-20)
    q[3] = (m[k, j] - m[j, k]) / max(s, 1e-20)
    return q


class Viewer:
    def __init__(self,
                 width: int = 800,
                 height: int = 600,
                 camera_up: Sequence[float] = (0.0, 1.0, 0.0),
                 initial_camera_position: Sequence[float] = (0.0, 1.0, 5.0),
                 initial_camera_lookat: Sequence[float] = (0.0, 0.0, 0.0),
                 fov_y_deg: float = 60.0,
                 max_spherical_harmonics_degree: int = 0,
                 splat_render_mode: SplatRenderMode = SplatRenderMode.ThreeD,
                 render_mode: RenderMode = RenderMode.Always,
                 antialiased: bool = False,
                 kernel_2d_size: float = 0.3,
                 splat_scale: float = 1.0,
                 max_screen_space_splat_size: float = 1024.0,
                 point_cloud_mode: bool = False,
                 splat_sort_distance_map_precision: int = 16,
                 background: Sequence[float] = (0.0, 0.0, 0.0),
                 backend: str = "auto",
                 use_orthographic_camera: bool = False,
                 ortho_half_height: float = 2.0,
                 scene_reveal_mode: SceneRevealMode = SceneRevealMode.Default,
                 scene_fade_in_rate_multiplier: float = 1.0,
                 focal_adjustment: float = 1.0,
                 log_level=None,
                 device="cuda"):
        self.config = RenderConfig(
            width=width, height=height,
            sh_degree=max_spherical_harmonics_degree,
            kernel_2d_size=kernel_2d_size,
            antialiased=antialiased,
            splat_scale=splat_scale,
            max_screen_space_splat_size=max_screen_space_splat_size,
            point_cloud_mode=point_cloud_mode,
            render_mode_2d=(splat_render_mode == SplatRenderMode.TwoD),
            orthographic=use_orthographic_camera,
            sort_bits=splat_sort_distance_map_precision,
            background=tuple(background),
            backend=backend,
            focal_adjustment=focal_adjustment,
        )
        if log_level is not None:
            from ..utils.logging import set_log_level
            set_log_level(log_level)
        self.device = torch.device(device)
        self.render_mode = render_mode
        self.camera = OrbitCamera(
            position=initial_camera_position, target=initial_camera_lookat,
            up=camera_up, fov_y_deg=fov_y_deg, aspect=width / height)
        self.use_orthographic_camera = use_orthographic_camera
        self.ortho_half_height = ortho_half_height
        self.raycaster = Raycaster()
        self.scene_reveal_mode = scene_reveal_mode
        self.visible_region = VisibleRegion(scene_fade_in_rate_multiplier)
        self._scenes: List[SplatScene] = []
        self._concat_cache = None
        self._last_frame = None
        self._last_cam_sig = None      # (position [3], quaternion [4])
        self._render_next_frame = False
        self._disposed = False

    # ------------------------------------------------------------------
    # scene lifecycle
    # ------------------------------------------------------------------
    @property
    def scene_count(self) -> int:
        return len(self._scenes)

    def get_splat_scene(self, index: int) -> SplatScene:
        return self._scenes[index]

    def add_splat_scene(self, source: SceneSource,
                        position: Optional[Sequence[float]] = None,
                        rotation: Optional[Sequence[float]] = None,
                        scale: Optional[Sequence[float]] = None,
                        opacity: float = 1.0,
                        visible: bool = True,
                        splat_alpha_removal_threshold: int = 1,
                        sh_degree: Optional[int] = None,
                        format=None,
                        headers: Optional[dict] = None,
                        on_progress=None,
                        optimize_splat_data: bool = False) -> SplatScene:
        """Add a scene from a file path or URL, SplatData, or SplatScene.

        splat_alpha_removal_threshold: u8 opacity cutoff applied at load,
        like the reference's per-scene option (Viewer.js:714-735).
        ``format`` (a SceneFormat) overrides extension sniffing, ``headers``
        adds HTTP request headers, ``on_progress`` streams download progress,
        and ``optimize_splat_data`` reorders splats for locality
        (io.optimize, the reference's optimizeSplatData pipeline) — all
        per-scene options of the reference's addSplatScene.  Splats given
        on another device move to the viewer's.
        """
        self._check_disposed()
        if len(self._scenes) >= MAX_SCENES:
            raise ValueError(f"cannot exceed {MAX_SCENES} scenes")
        if isinstance(source, SplatScene):
            scene = source
        else:
            if isinstance(source, str):
                from .. import io as gio
                splats = gio.load(
                    source,
                    sh_degree if sh_degree is not None
                    else self.config.sh_degree,
                    on_progress=on_progress, format=format, headers=headers,
                    device=self.device)
            else:
                splats = source.to(self.device)
            if optimize_splat_data:
                sections = _optimize(
                    splats,
                    alpha_removal_threshold=splat_alpha_removal_threshold)
                splats = (sections[0] if len(sections) == 1
                          else SplatData.concatenate(sections))
            if splat_alpha_removal_threshold > 1:
                keep = (splats.colors[:, 3] * 255.0
                        >= splat_alpha_removal_threshold)
                splats = take_splats(splats, torch.nonzero(keep)[:, 0])
            scene = SplatScene(splats, position=position, rotation=rotation,
                               scale=scale, opacity=opacity, visible=visible)
        self._scenes.append(scene)
        self.visible_region.update_region(scene.splats.means,
                                          final_build=True)
        self._concat_cache = None
        return scene

    def add_splat_scenes(self, sources: Sequence[SceneSource],
                         **common_kwargs) -> List[SplatScene]:
        return [self.add_splat_scene(s, **common_kwargs) for s in sources]

    def add_splat_scene_progressive(self, path: str,
                                    on_update=None,
                                    sh_degree: Optional[int] = None,
                                    abort_event=None,
                                    **scene_kwargs) -> SplatScene:
        """Stream a scene file, growing the scene as sections arrive.

        The progressive-load parity surface (KSplatLoader.js:119-180,
        PlyLoader.js:89-291): for valid-prefix formats (.ksplat/.splat and
        binary INRIA .ply) the scene's splats are re-assigned with each
        decoded prefix — every reassignment bumps the scene version, so the
        next ``render()`` shows the partial scene with the reveal fade
        tracking the growing visible region.  ``on_update(scene,
        fraction)`` fires per snapshot.  Buffered formats (ascii .ply,
        .spz) decode once at the end.
        """
        self._check_disposed()
        from ..io.fetch import fetch_with_progress
        from ..io.progressive import ProgressiveLoader

        loader = ProgressiveLoader.for_path(path, device=self.device)
        scene_holder = [None]

        def on_chunk(pct, _label, chunk, _total):
            loader.feed(chunk)
            snap = loader.snapshot()
            if snap is None or snap.num_splats == 0:
                return
            if sh_degree is not None and snap.sh_degree > sh_degree:
                snap = snap.with_sh_degree(sh_degree)
            if scene_holder[0] is None:
                scene_holder[0] = SplatScene(snap, **scene_kwargs)
                self._scenes.append(scene_holder[0])
            else:
                scene_holder[0].splats = snap
            self.visible_region.update_region(snap.means, final_build=False)
            self._concat_cache = None
            if on_update is not None:
                on_update(scene_holder[0], (pct or 0.0) / 100.0)

        fetch_with_progress(path, on_chunk, abort_event)
        final = loader.finalize()
        if sh_degree is not None and final.sh_degree > sh_degree:
            final = final.with_sh_degree(sh_degree)
        if scene_holder[0] is None:
            scene_holder[0] = SplatScene(final, **scene_kwargs)
            self._scenes.append(scene_holder[0])
        else:
            scene_holder[0].splats = final
        self.visible_region.update_region(final.means, final_build=True)
        self._concat_cache = None
        return scene_holder[0]

    def remove_splat_scene(self, index: int) -> None:
        self._check_disposed()
        del self._scenes[index]
        self._concat_cache = None

    def remove_splat_scenes(self, indexes: Sequence[int]) -> None:
        for i in sorted(indexes, reverse=True):
            del self._scenes[i]
        self._concat_cache = None

    def dispose(self) -> None:
        """Release scene data (Viewer.js:1464)."""
        self._scenes.clear()
        self._concat_cache = None
        self._last_frame = None
        self._disposed = True

    def _check_disposed(self):
        if self._disposed:
            raise RuntimeError("viewer has been disposed")

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------
    def _concat(self):
        """(all scenes' splats in one SplatData, int32 scene index a
        splat), rebuilt when a scene's splats change."""
        versions = tuple(s.splats_version for s in self._scenes)
        if self._concat_cache is None or self._concat_cache[0] != versions:
            if not self._scenes:
                raise ValueError("no scenes added")
            splats = SplatData.concatenate(
                [s.splats for s in self._scenes])
            sizes = torch.tensor([s.num_splats for s in self._scenes],
                                 device=self.device)
            scene_indices = torch.repeat_interleave(
                torch.arange(len(self._scenes), dtype=torch.int32,
                             device=self.device), sizes,
                output_size=splats.num_splats)
            self._concat_cache = (versions, splats, scene_indices)
        return self._concat_cache[1], self._concat_cache[2]

    def _transforms(self) -> torch.Tensor:
        """[S, 4, 4] scene transforms on the viewer's device."""
        return torch.stack([s.transform for s in self._scenes]).to(
            self.device)

    def _current_camera(self, camera: Optional[Camera]) -> Camera:
        if camera is not None:
            return camera
        self.camera.aspect = self.config.width / self.config.height
        if self.use_orthographic_camera:
            return Camera.orthographic(
                tuple(self.camera.position), tuple(self.camera.target),
                tuple(self.camera.up), half_height=self.ortho_half_height,
                aspect=self.camera.aspect, device=self.device)
        return self.camera.camera(self.device)

    def force_render_next_frame(self) -> None:
        """Bypass OnChange gating for the next render() call
        (forceRenderNextFrame parity, Viewer.js:1557-1559)."""
        self._render_next_frame = True

    def _camera_changed(self, cam: Camera) -> bool:
        """Epsilon-gated camera-change test (Viewer.js:1561-1597): any
        position or orientation-quaternion component moving by more than
        CAMERA_CHANGE_EPSILON since the LAST OBSERVED camera counts as a
        change (the reference updates its last-camera snapshot every
        shouldRender call, so sub-epsilon drift never re-renders)."""
        pos = cam.cam_pos.detach().cpu().numpy().astype(np.float64)
        view = cam.view.detach().cpu().numpy().astype(np.float64)
        quat = _rotation_to_quat(view[:3, :3].T)
        sig = (pos, quat)
        if self._last_cam_sig is None:
            self._last_cam_sig = sig
            return True
        lp, lq = self._last_cam_sig
        self._last_cam_sig = sig
        # quaternion double cover: q and -q are the same orientation
        dq = min(float(np.max(np.abs(quat - lq))),
                 float(np.max(np.abs(quat + lq))))
        return (float(np.max(np.abs(pos - lp))) > CAMERA_CHANGE_EPSILON
                or dq > CAMERA_CHANGE_EPSILON)

    def render(self, camera: Optional[Camera] = None,
               return_aux: bool = False):
        """Render the composed scenes.  Returns {'color', 'alpha', ...}.

        With RenderMode.OnChange, returns the cached frame unless the
        scenes changed or the camera moved beyond the reference's
        per-component epsilon (shouldRender parity, Viewer.js:1561-1597 —
        sub-epsilon camera jitter reuses the cached frame); with
        RenderMode.Never, always returns the cached frame (or raises if
        nothing was rendered yet).
        """
        self._check_disposed()
        cam = self._current_camera(camera)
        # scene-reveal fade: advance one frame per render call; a changing
        # fade radius keeps the frame key "dirty" (visibleRegionChanging
        # forces shouldRender in the reference, Viewer.js:1561-1597)
        fade = self.visible_region.tick(self.scene_reveal_mode)
        # return_aux is part of the key: a cached no-aux frame must not be
        # handed to a caller expecting num_pairs/overflow
        scene_key = (
            return_aux,
            None if fade is None else (tuple(fade[0]), fade[1]),
            tuple((s.splats_version, tuple(s.position), tuple(s.quaternion),
                   tuple(s.scale), s.opacity, s.visible)
                  for s in self._scenes))
        cam_changed = self._camera_changed(cam)
        if self.render_mode == RenderMode.Never and self._last_frame:
            return self._last_frame[1]
        if (self.render_mode == RenderMode.OnChange
                and self._last_frame is not None
                and self._last_frame[0] == scene_key
                and not cam_changed
                and not self._render_next_frame):
            return self._last_frame[1]
        self._render_next_frame = False

        splats, scene_indices = self._concat()
        out = render_pipeline(
            splats, cam, self.config,
            transforms=self._transforms(),
            scene_indices=scene_indices,
            scene_opacities=torch.tensor(
                [s.opacity for s in self._scenes], dtype=torch.float32,
                device=self.device),
            scene_visibility=torch.tensor(
                [s.visible for s in self._scenes], dtype=torch.bool,
                device=self.device),
            fade_params=fade,
            return_aux=return_aux)
        self._last_frame = (scene_key, out)
        return out

    def render_stereo(self, eye_separation: float = 0.064,
                      camera: Optional[Camera] = None):
        """Left/right eye pair (WebXR stereo parity, Viewer.js:679-687).
        Each eye's view is the camera's view translated along the camera's
        right axis, which comes from the view's float32 inverse on the
        device."""
        cam = self._current_camera(camera)
        right = torch.linalg.inv(cam.view)[:3, 0]
        outs = []
        for sign in (-0.5, 0.5):
            offset = right * (sign * eye_separation)
            # translate the world by -offset in camera space
            t = torch.eye(4, dtype=cam.view.dtype, device=cam.view.device)
            t[:3, 3] = -offset
            cam_eye = Camera(view=cam.view @ t, proj=cam.proj,
                             cam_pos=cam.cam_pos + offset)
            outs.append(self.render(camera=cam_eye))
        return {"left": outs[0], "right": outs[1]}

    # ------------------------------------------------------------------
    # picking
    # ------------------------------------------------------------------
    def raycast(self, screen_x: float, screen_y: float,
                camera: Optional[Camera] = None) -> Optional[Hit]:
        """Pick the closest splat under a raster-space pixel
        (checkForFocalPointChange parity, Viewer.js:550-581)."""
        self._check_disposed()
        cam = self._current_camera(camera)
        ray = Ray.from_camera_and_screen(cam, screen_x, screen_y,
                                         self.config.width,
                                         self.config.height)
        splats, scene_indices = self._concat()
        return self.raycaster.intersect(ray, splats, self._transforms(),
                                        scene_indices)

    def look_at_hit(self, hit: Hit) -> None:
        """Move the orbit target to a picked point (focal-point change)."""
        self.camera.set_target(hit.point)
