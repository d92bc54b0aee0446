"""The port stands alone: importing it, its viewer, its progressive
loader, URL fetch and native decoders, its multi-device layer, and its
render_scene, create_ksplat and scaling_bench tools loads neither JAX nor
the JAX package (checked in a fresh interpreter, since this test process
has imported both)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import json, sys
import gaussiansplats3d_tpu_torch
import gaussiansplats3d_tpu_torch.viewer
import gaussiansplats3d_tpu_torch.io.progressive
import gaussiansplats3d_tpu_torch.io.fetch
import gaussiansplats3d_tpu_torch.io.native
import gaussiansplats3d_tpu_torch.tools.render_scene
import gaussiansplats3d_tpu_torch.tools.create_ksplat
import gaussiansplats3d_tpu_torch.parallel
import gaussiansplats3d_tpu_torch.tools.scaling_bench
print(json.dumps(sorted(m for m in sys.modules
                        if m in ("jax", "gaussiansplats3d_tpu")
                        or m.startswith(("jax.", "gaussiansplats3d_tpu.")))))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert loaded == []
