"""Offscreen scene renderer CLI — the counterpart of the JAX package's
``tools/render_scene.py`` and the analogue of the reference's demo pages
(demo/*.html): load a scene file into a ``Viewer``, orbit the camera, write
PNG frames (PPM where PIL is missing).

    python -m gaussiansplats3d_tpu_torch.tools.render_scene scene.ksplat \\
        out.png [--width 1280] [--height 720] [--sh 2] [--frames 1] \\
        [--orbit-degrees 360] [--camera 3,2,3] [--target 0,0,0] \\
        [--mode 2d] [--cpu]

Runs on the GPU unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import sys


def _vec(s):
    return tuple(float(x) for x in s.split(","))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene")
    ap.add_argument("out")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--sh", type=int, default=2)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--orbit-degrees", type=float, default=360.0)
    ap.add_argument("--camera", type=_vec, default=(3.0, 2.0, 3.0))
    ap.add_argument("--target", type=_vec, default=(0.0, 0.0, 0.0))
    ap.add_argument("--up", type=_vec, default=(0.0, 1.0, 0.0))
    ap.add_argument("--background", type=_vec, default=(0.0, 0.0, 0.0))
    ap.add_argument("--mode", choices=["3d", "2d", "points"], default="3d")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..utils.metrics import timed_render
    from ..viewer import SplatRenderMode, Viewer

    viewer = Viewer(
        width=args.width, height=args.height,
        max_spherical_harmonics_degree=args.sh,
        initial_camera_position=args.camera,
        initial_camera_lookat=args.target,
        camera_up=args.up,
        background=args.background,
        splat_render_mode=(SplatRenderMode.TwoD if args.mode == "2d"
                           else SplatRenderMode.ThreeD),
        point_cloud_mode=(args.mode == "points"),
        device="cpu" if args.cpu else "cuda")
    scene = viewer.add_splat_scene(args.scene)
    print(f"loaded {scene.num_splats} splats "
          f"(SH degree {scene.splats.sh_degree})")

    try:
        from PIL import Image
    except ImportError:
        Image = None

    step = math.radians(args.orbit_degrees) / max(args.frames, 1)
    for f in range(args.frames):
        out, stats = timed_render(viewer.render)
        img = (np.clip(out["color"].cpu().numpy(), 0, 1) * 255
               ).astype(np.uint8)
        path = args.out if args.frames == 1 else \
            args.out.replace(".png", f"_{f:04d}.png")
        if Image is not None:
            Image.fromarray(img).save(path)
        else:  # raw PPM fallback
            with open(path.replace(".png", ".ppm"), "wb") as fh:
                fh.write(f"P6 {img.shape[1]} {img.shape[0]} 255\n".encode())
                fh.write(img.tobytes())
        print(f"frame {f}: {stats.wall_ms:.1f} ms -> {path}")
        viewer.camera.rotate(step, 0.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
