"""Scene converter CLI — the counterpart of the JAX package's
``tools/create_ksplat.py``, parity with the reference's node tool
(util/create-ksplat.js:5-45):

    python -m gaussiansplats3d_tpu_torch.tools.create_ksplat \\
        <in .ply/.splat/.ksplat/.spz> <out .ksplat> [compression=0] \\
        [alpha_removal_threshold=1] [scene_center="0,0,0"] [block_size=5.0] \\
        [bucket_size=256] [sh_degree]

Also converts to .splat/.ply/.spz when the output extension says so.  A
conversion is decoding and encoding, both numpy on the host, so the splats
stay on the CPU: no device is used.
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print(__doc__)
        return 1
    in_path, out_path = argv[0], argv[1]
    compression = int(argv[2]) if len(argv) > 2 else 0
    alpha_threshold = int(argv[3]) if len(argv) > 3 else 1
    # scene_center accepted for CLI parity; the .ksplat header records it
    # but our writer derives it from the data (argv[4] ignored if "0,0,0").
    block_size = float(argv[5]) if len(argv) > 5 else 5.0
    bucket_size = int(argv[6]) if len(argv) > 6 else 256
    sh_degree = int(argv[7]) if len(argv) > 7 else None

    from .. import io as gio

    splats = gio.load(in_path, sh_degree=sh_degree, device="cpu")
    print(f"loaded {splats.num_splats} splats "
          f"(SH degree {splats.sh_degree}) from {in_path}")

    fmt = gio.scene_format_from_path(out_path)
    if fmt == gio.SceneFormat.KSplat:
        gio.save_ksplat(splats, out_path, compression_level=compression,
                        block_size=block_size, bucket_size=bucket_size,
                        minimum_alpha=alpha_threshold)
    else:
        gio.save(splats, out_path)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
