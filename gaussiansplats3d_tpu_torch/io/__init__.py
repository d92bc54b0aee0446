"""Scene ingest / export: .ply, .splat, .ksplat, .spz readers and writers
(counterpart of the JAX package's ``io/``).

Decoding is host-side: ``.splat``, INRIA v1 binary ``.ply`` and ``.ksplat``
sections through the multithreaded C++ decoders of ``native`` (built with
g++ at first use; ``GS_NATIVE=0`` turns them off), else and for the other
dialects vectorized NumPy (copies of the JAX package's numpy paths; the
equivalent of the reference's streaming loaders in src/loaders/); every
decoder builds numpy arrays and moves them to the device once, at the
end, as the port's ``SplatData`` (``device`` defaults to ``cuda``, as
every constructor of the port).  Writers take a ``SplatData`` on any
device.  :func:`load` reads paths and http(s)/file URLs (``fetch``),
``progressive`` decodes growing prefixes of a stream, and
``optimize_splat_data`` reorders and sections a scene.
"""

from .formats import (  # noqa: F401
    SceneFormat,
    load,
    parse,
    save,
    scene_format_from_path,
)
from .fetch import AbortedError, fetch_with_progress  # noqa: F401
from .ksplat import (  # noqa: F401
    load_ksplat,
    save_ksplat,
    serialize_ksplat_sections,
)
from .optimize import optimize_splat_data  # noqa: F401
from .ply import load_ply, save_ply  # noqa: F401
from .splat import load_splat, save_splat  # noqa: F401
from .spz import load_spz, save_spz  # noqa: F401
