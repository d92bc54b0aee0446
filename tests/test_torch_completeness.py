"""The module port is complete: every public top-level function, class and
constant of every module of the JAX package (gaussiansplats3d_tpu/), and
every name its ``__init__`` modules re-export, has a counterpart in the
port (gaussiansplats3d_tpu_torch/) or an entry in the tables below that
names its counterpart or gives the reason it has none.

A counterpart has the same name in the module of the same path, or in the
module MODULES maps the JAX module to, or the name RENAMED gives.  The
tables must not outlive what they cover: an entry whose name resolves
without it, or that names no JAX name, fails.  Both packages are read with
``ast``; neither is imported.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "gaussiansplats3d_tpu")
PORT = os.path.join(ROOT, "gaussiansplats3d_tpu_torch")

# JAX module -> the port module that holds its counterparts
MODULES = {
    "render/pallas_rasterize.py": "render/cuda_rasterize.py",   # B1, B2
    "render/pallas_surfel.py": "render/cuda_surfel.py",         # B3, B4
    # the pure-JAX scan backends: the kernels' plain PyTorch versions
    "render/rasterize.py": "render/cuda_rasterize.py",
    "render/rasterize_surfel.py": "render/cuda_surfel.py",
    "tools/tpu_parity.py": "tools/gpu_parity.py",
}

# (JAX module, name) -> "port module::name" ("::Class.method" for a method)
RENAMED = {
    ("render/pallas_surfel.py", "composite_surfel_tiles_pallas"):
        "render/cuda_surfel.py::composite_surfel_tiles",
    ("render/rasterize.py", "rasterize_pairs"):
        "render/cuda_rasterize.py::composite_fwd_torch",
    ("render/rasterize_surfel.py", "SURFEL_RECORD_WIDTH"):
        "render/cuda_surfel.py::RECORD_ROWS",
    ("render/pipeline.py", "chans_from_colors_logt"):
        "render/surfel.py::chans_from_colors_logt",
    ("render/pipeline.py", "resolve_backend"):
        "core/types.py::RenderConfig.check_backend",
    ("render/surfel.py", "render_2d_tiled"):
        "render/pipeline.py::render_2d_tiled",
}

_TPU_RECORD = ("TPU workaround dropped by ROADMAP rule (the lane-padded, "
               "field-major record of the Pallas kernel); {} reads "
               "binning's records as they are")
EXEMPT = {
    ("render/binning.py", "SMALL_K"):
        "read nowhere in the JAX package; the port's lane count is "
        "RenderConfig.lanes, as the JAX package's binning uses it",
    ("render/binning.py", "expand_sort_fwdonly"):
        "TPU workaround dropped by ROADMAP rule (one fewer operand on "
        "XLA's sort when no gradient follows); the port's "
        "binning.expand_sort drops that operand under cfg.forward_only",
    ("render/pallas_rasterize.py", "RECORD_WIDTH"): _TPU_RECORD.format("B1"),
    ("render/pallas_rasterize.py", "pack_records"): _TPU_RECORD.format("B1"),
    ("render/pallas_rasterize.py", "pack_records_flat"):
        _TPU_RECORD.format("B1"),
    ("render/pallas_surfel.py", "SURFEL_RECORD_WIDTH"):
        _TPU_RECORD.format("B3"),
    ("render/pallas_surfel.py", "pack_surfel_records"):
        _TPU_RECORD.format("B3"),
}


def _modules(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if f.endswith(".py"))


def _tree(root, rel):
    with open(os.path.join(root, rel)) as f:
        return ast.parse(f.read())


def _defined(tree):
    """Top-level functions, classes and assigned names."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return out


def _imported(tree):
    return {(a.asname or a.name).split(".")[0] for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom))
            for a in node.names}


def public_names(rel):
    """What a user of the JAX module reaches: its public definitions, and
    in an ``__init__`` its re-exports too."""
    tree = _tree(JAX, rel)
    names = _defined(tree)
    if rel.endswith("__init__.py"):
        names |= _imported(tree)
    return {n for n in names if not n.startswith("_")}


def port_names(rel):
    tree = _tree(PORT, rel)
    return _defined(tree) | _imported(tree)


def resolves(target):
    """Whether "module::name" (or "module::Class.method") is in the port."""
    rel, name = target.split("::")
    if not os.path.exists(os.path.join(PORT, rel)):
        return False
    tree = _tree(PORT, rel)
    if "." not in name:
        return name in port_names(rel)
    cls, meth = name.split(".")
    return any(isinstance(n, ast.ClassDef) and n.name == cls
               and any(isinstance(m, ast.FunctionDef) and m.name == meth
                       for m in n.body) for n in tree.body)


def counterpart_module(rel):
    return MODULES.get(rel, rel)


@pytest.mark.parametrize("rel", _modules(JAX))
def test_every_public_name_has_a_counterpart(rel):
    """Each public name of the JAX module: the same name in its port
    module, a RENAMED counterpart that exists, or an EXEMPT reason."""
    port_rel = counterpart_module(rel)
    assert os.path.exists(os.path.join(PORT, port_rel)), (
        f"{rel} has no port module {port_rel}")
    have = port_names(port_rel)
    missing = []
    for name in sorted(public_names(rel)):
        if name in have or (rel, name) in EXEMPT:
            continue
        target = RENAMED.get((rel, name))
        if target is None or not resolves(target):
            missing.append(name if target is None else f"{name}->{target}")
    assert not missing, f"{rel}: no counterpart in {port_rel}: {missing}"


def test_the_tables_cover_only_what_is_missing():
    """Every table entry names a JAX public name that has no same-named
    counterpart; every exemption gives a reason; every mapped module
    exists on both sides and has no port module of its own path."""
    for rel, port_rel in MODULES.items():
        assert os.path.exists(os.path.join(JAX, rel)), rel
        assert os.path.exists(os.path.join(PORT, port_rel)), port_rel
        assert not os.path.exists(os.path.join(PORT, rel)), rel
    for (rel, name), entry in list(RENAMED.items()) + list(EXEMPT.items()):
        assert name in public_names(rel), (rel, name)
        assert name not in port_names(counterpart_module(rel)), (
            f"{rel}::{name} resolves without its table entry")
        assert entry.strip(), (rel, name)
    assert not set(RENAMED) & set(EXEMPT)

