"""The port's native scene decoders (gaussiansplats3d_tpu_torch/io/native.py,
csrc/ingest.cpp) against its numpy decoders and against the JAX package's
native decoders, on the same bytes; the progressive loader on both paths;
the library's build.

- Port native against port numpy (GS_NATIVE=0): every field within 1e-6
  (exp, sqrt and the divisions round differently in the last place),
  colors and opacities equal, for .splat, .ply at SH 0-2 with SH
  truncation and a prefix clamp, and .ksplat at levels 0-2 with a partial
  bucket, two sections and a watermark prefix.
- Port native against the JAX package's native decode: bit for bit (the
  same C++ and flags), but .ply colors, which the port quantizes in numpy
  on both paths (bit for bit against the JAX numpy decode instead).
- The build: GS_NATIVE=0 builds nothing, four processes building into one
  fresh directory all load a working library, an edited source gets a new
  library name, a failed build is reported by ``native.status``.

Every test decides at run time whether the library loads (``get_lib()``)
and skips inside the test if it does not.  The JAX package's library is
its own get_lib()'s, or, where that does not load (its shared build races
between xdist workers at collection), the same source built by its own
_build into a private directory (``jax_native``): those cases skip only
where no g++ exists.  Inputs are made with numpy from
a seed.  The file takes ~15 s serially on a CPU; the decoders start one
thread per 4,096 splats, up to the host's cores, so the 9,000-splat
scenes here use two or three.
"""

import contextlib
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu.io import ksplat as ks_j
from gaussiansplats3d_tpu.io import native as native_j
from gaussiansplats3d_tpu.io import ply as ply_j
from gaussiansplats3d_tpu.io import splat as splat_j
from gaussiansplats3d_tpu_torch import _build
from gaussiansplats3d_tpu_torch.io import ksplat as ks_t
from gaussiansplats3d_tpu_torch.io import native
from gaussiansplats3d_tpu_torch.io import ply as ply_t
from gaussiansplats3d_tpu_torch.io import splat as splat_t
from gaussiansplats3d_tpu_torch.io.progressive import ProgressiveLoader

from torch_port_common import scene_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("means", "scales", "quats", "colors", "sh")
N = 9000            # > 2 x 4096: the decoders' threads split the rows
ATOL = 1e-6


def needs_lib():
    if native.get_lib() is None:
        pytest.skip(f"native decoders unavailable: {native.status()}")


@pytest.fixture(scope="module")
def jax_native_private(tmp_path_factory):
    """The JAX package's native library built apart from its shared
    native/build/, or None where its own get_lib() loads (nothing to do)
    or no g++ exists.  get_lib() builds into one path that every xdist
    worker links at collection; a failed link deletes another worker's
    file and get_lib() then caches None.  So here the package's own
    _build, with its _LIB pointed into a private directory, compiles its
    own native/ingest.cpp, and its own get_lib() loads the result; the
    package's files are not touched."""
    if native_j.get_lib() is not None or shutil.which("g++") is None:
        return None
    lib = tmp_path_factory.mktemp("jax_native") / "libgsingest.so"
    with pytest.MonkeyPatch.context() as m:
        m.setattr(native_j, "_LIB", str(lib))
        m.setattr(native_j, "_lib", None)
        m.setattr(native_j, "_tried", False)
        return native_j.get_lib()


@pytest.fixture
def jax_native(jax_native_private, monkeypatch):
    """The JAX package's native decoders for one test: its get_lib()'s
    library, else the private build's (native_j._lib and _tried patched
    for the test's duration); a skip only where neither loads."""
    if jax_native_private is not None:
        monkeypatch.setattr(native_j, "_lib", jax_native_private)
        monkeypatch.setattr(native_j, "_tried", True)
    if native_j.get_lib() is None:
        pytest.skip("the JAX package's native library does not load")


@contextlib.contextmanager
def numpy_only(monkeypatch):
    with monkeypatch.context() as m:
        m.setenv("GS_NATIVE", "0")
        yield


def port_splats(n=N, sh_degree=2, seed=3):
    return gt.SplatData.from_numpy(*scene_arrays(n, sh_degree=sh_degree,
                                                 seed=seed, extent=2.0),
                                   device="cpu")


# (case, serialize(port SplatData) -> bytes, port decode, JAX decode)
CASES = {
    "splat": (lambda s: splat_t.serialize_splat(s.with_sh_degree(0)),
              lambda b: splat_t.parse_splat(b, device="cpu"),
              splat_j.parse_splat),
    **{f"ply_sh{d}": (
        (lambda d: lambda s: ply_t.serialize_ply(s.with_sh_degree(d)))(d),
        lambda b: ply_t.parse_ply(b, device="cpu"), ply_j.parse_ply)
       for d in (0, 1, 2)},
    "ply_sh2_truncated_to_1": (
        ply_t.serialize_ply,
        lambda b: ply_t.parse_ply(b, sh_degree=1, device="cpu"),
        lambda b: ply_j.parse_ply(b, sh_degree=1)),
    "ply_sh2_truncated_to_0": (
        ply_t.serialize_ply,
        lambda b: ply_t.parse_ply(b, sh_degree=0, device="cpu"),
        lambda b: ply_j.parse_ply(b, sh_degree=0)),
    "ply_prefix_clamp": (
        ply_t.serialize_ply,
        lambda b: ply_t.parse_ply_inria_v1(b, max_splats=5123,
                                           device="cpu"),
        lambda b: ply_j.parse_ply_inria_v1(b, max_splats=5123)),
    **{f"ksplat_l{lv}": (
        (lambda lv: lambda s: ks_t.serialize_ksplat(
            s, compression_level=lv))(lv),
        lambda b: ks_t.parse_ksplat(b, device="cpu"), ks_j.parse_ksplat)
       for lv in (0, 1, 2)},
    "ksplat_l1_two_sections_sh1": (
        lambda s: ks_t.serialize_ksplat(s.with_sh_degree(1),
                                        compression_level=1,
                                        section_size=5000),
        lambda b: ks_t.parse_ksplat(b, device="cpu"), ks_j.parse_ksplat),
    # the watermark cuts the second section's records mid-row
    "ksplat_l2_watermark_prefix": (
        lambda s: ks_t.serialize_ksplat(s, compression_level=2,
                                        section_size=5000),
        lambda b: ks_t.parse_ksplat(b, max_bytes=len(b) - 40_017,
                                    device="cpu"),
        lambda b: ks_j.parse_ksplat(b, max_bytes=len(b) - 40_017)),
}


def decode_both_ways(case, monkeypatch):
    """(bytes, the port's native decode, its numpy decode, the decode
    counts of each)."""
    ser, dec, _ = CASES[case]
    data = ser(port_splats())
    native.reset_counts()
    nat = dec(data)
    nat_counts = native.decode_counts()
    native.reset_counts()
    with numpy_only(monkeypatch):
        ref = dec(data)
    return data, nat, ref, nat_counts, native.decode_counts()


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_matches_numpy(case, monkeypatch):
    """The native decode within 1e-6 of the numpy one, colors and
    opacities equal, every decode on the path it names."""
    needs_lib()
    data, nat, ref, nat_counts, ref_counts = decode_both_ways(case,
                                                              monkeypatch)
    fmt = case.split("_")[0]
    assert nat_counts[fmt]["native"] >= 1 and nat_counts[fmt]["numpy"] == 0
    assert ref_counts[fmt]["numpy"] >= 1 and ref_counts[fmt]["native"] == 0
    assert nat.num_splats == ref.num_splats > 0
    for f in FIELDS:
        x, y = getattr(nat, f).numpy(), getattr(ref, f).numpy()
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape, f
        np.testing.assert_allclose(x, y, rtol=0, atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(nat.colors.numpy(), ref.colors.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_bit_equal_to_the_jax_native_decode(case, monkeypatch,
                                                   jax_native):
    """The same bytes through the JAX package's native decoder: the same
    float32 bits; .ply colors equal the JAX numpy decode's instead."""
    needs_lib()
    ser, dec_t, dec_j = CASES[case]
    data = ser(port_splats())
    ours, theirs = dec_t(data), dec_j(data)
    for f in FIELDS:
        if case.startswith("ply") and f == "colors":
            with numpy_only(monkeypatch):
                want = np.asarray(dec_j(data).colors)
        else:
            want = np.asarray(getattr(theirs, f))
        got = getattr(ours, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=f)


def test_ply_colors_hold_at_quantization_edges(monkeypatch):
    """Opacities and colors a few ulps from a multiple of 1/255, where
    floor(x * 255) flips on the last bit of exp or of a contracted
    multiply-add: the native decode's colors still equal the numpy
    decode's (both quantize in numpy), and every other field is within
    1e-6."""
    needs_lib()
    rng = np.random.default_rng(11)
    means, scales, quats, _, sh = scene_arrays(20_000, sh_degree=1, seed=11)
    colors = (rng.integers(0, 256, (20_000, 4)) / 255.0
              + rng.uniform(-3e-7, 3e-7, (20_000, 4)))
    colors = np.clip(colors, 1e-6, 1.0).astype(np.float32)
    data = ply_t.serialize_ply(gt.SplatData.from_numpy(
        means, scales, quats, colors, sh, device="cpu"))
    nat = ply_t.parse_ply(data, device="cpu")
    with numpy_only(monkeypatch):
        ref = ply_t.parse_ply(data, device="cpu")
    np.testing.assert_array_equal(nat.colors.numpy(), ref.colors.numpy())
    for f in ("means", "scales", "quats", "sh"):
        np.testing.assert_allclose(getattr(nat, f).numpy(),
                                   getattr(ref, f).numpy(), rtol=0,
                                   atol=ATOL, err_msg=f)


@pytest.mark.parametrize("ext,kw", [("splat", {}), ("ply", {}),
                                    ("ksplat", {"compression_level": 1,
                                                "section_size": 4000})])
def test_progressive_snapshots_native_match_numpy(tmp_path, monkeypatch,
                                                  ext, kw):
    """The same byte prefixes through a ProgressiveLoader on each path:
    the same snapshots at the same prefixes, their contents within 1e-6
    and their colors equal."""
    needs_lib()
    path = str(tmp_path / f"s.{ext}")
    gt.save(port_splats(sh_degree=0 if ext == "splat" else 1), path, **kw)
    data = open(path, "rb").read()
    cuts = sorted({100, len(data) // 5, len(data) // 3, len(data) // 2,
                   len(data) - 7, len(data)})

    def stream():
        loader, fed, snaps = ProgressiveLoader.for_path(
            path, min_new_splats=1000, device="cpu"), 0, []
        for cut in cuts:
            loader.feed(data[fed:cut])
            fed = cut
            snaps.append(loader.snapshot())
        return snaps + [loader.finalize()]

    nat = stream()
    with numpy_only(monkeypatch):
        ref = stream()
    assert [s is None for s in nat] == [s is None for s in ref]
    assert sum(s is not None for s in nat) >= 4
    for a, b in zip(nat, ref):
        if a is None:
            continue
        assert a.num_splats == b.num_splats
        for f in FIELDS:
            np.testing.assert_allclose(getattr(a, f).numpy(),
                                       getattr(b, f).numpy(), rtol=0,
                                       atol=ATOL, err_msg=f)
        np.testing.assert_array_equal(a.colors.numpy(), b.colors.numpy())
    assert nat[-1].num_splats == N


def test_bindings_refuse_what_would_read_out_of_bounds():
    """The ctypes bindings check sizes before they pass pointers: a short
    vertex block, an offset past the row, too few SH offsets, short
    section records, a bucket past the centers."""
    needs_lib()
    fo = list(range(0, 56, 4))                      # 14 f32 fields
    ok = native.parse_ply_inria_v1_native(np.zeros(10 * 56, np.uint8), 10,
                                          56, fo, [], 0, 1)
    assert ok[0].shape == (10, 3)
    bad = [(np.zeros(9 * 56, np.uint8), fo, [], 0, 1),
           (np.zeros(10 * 56, np.uint8), fo[:-1] + [56], [], 0, 1),
           (np.zeros(10 * 56, np.uint8), fo, [0] * 8, 3, 3)]
    for block, offs, sh_offs, k, cpc in bad:
        with pytest.raises(ValueError):
            native.parse_ply_inria_v1_native(block, 10, 56, offs, sh_offs,
                                             k, cpc)
    centers = np.zeros((2, 3), np.float32)
    args = (1e-3, 32767, -1.0, 1.0)       # sfac, range, SH min and max
    assert native.parse_ksplat_section_native(
        np.zeros(4 * 24, np.uint8), 4, 1, 0, [0, 0, 1, 1], centers,
        *args)[0].shape == (4, 3)
    for rows, bucket_of in ((np.zeros(3 * 24, np.uint8), [0, 0, 1, 1]),
                            (np.zeros(4 * 24, np.uint8), [0, 0, 1, 2]),
                            (np.zeros(4 * 24, np.uint8), [0, 0, 1])):
        with pytest.raises(ValueError):
            native.parse_ksplat_section_native(rows, 4, 1, 0, bucket_of,
                                               centers, *args)


def test_gs_native_0_builds_nothing(tmp_path, monkeypatch):
    """GS_NATIVE=0: no library and no build, the reason in status(), and
    every decode counted on the numpy path."""
    monkeypatch.setenv("GS_NATIVE", "0")
    build_dir = tmp_path / "build"
    assert native.get_lib(build_dir) is None
    assert not build_dir.exists()
    assert "GS_NATIVE=0" in native.status(build_dir)
    native.reset_counts()
    splat_t.parse_splat(splat_t.serialize_splat(port_splats(300, 0)),
                        device="cpu")
    assert native.decode_counts()["splat"] == {"native": 0, "numpy": 1}


def test_four_processes_build_one_library(tmp_path):
    """Four processes that build into one fresh directory at once: each
    loads a working library (its native decode equals its numpy one
    within 1e-6), all load the same file, and no private file is left."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    build_dir = tmp_path / "build"
    script = (
        "import os, sys, numpy as np\n"
        "from pathlib import Path\n"
        "from gaussiansplats3d_tpu_torch import _build\n"
        "_build.BUILD_DIR = Path(sys.argv[1])\n"
        "import gaussiansplats3d_tpu_torch as gt\n"
        "from gaussiansplats3d_tpu_torch.io import native, splat\n"
        "rng = np.random.default_rng(0)\n"
        "rows = rng.integers(0, 256, (5000, 32), dtype=np.uint8)\n"
        "rows[:, :24] = rng.normal(size=(5000, 6)).astype('<f4')"
        ".view(np.uint8)\n"
        "data = rows.tobytes()\n"
        "a = splat.parse_splat(data, device='cpu')\n"
        "assert native.decode_counts()['splat']['native'] == 1, "
        "native.status()\n"
        "os.environ['GS_NATIVE'] = '0'\n"
        "b = splat.parse_splat(data, device='cpu')\n"
        "for f in ('means', 'scales', 'quats', 'colors'):\n"
        "    d = float((getattr(a, f) - getattr(b, f)).abs().max())\n"
        "    assert d <= 1e-6, (f, d)\n"
        "os.environ['GS_NATIVE'] = '1'\n"
        "print(native.status())\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("GS_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(build_dir)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    loaded = {out.strip().splitlines()[-1] for out, _ in outs}
    libs = sorted(os.listdir(build_dir))
    assert len(loaded) == 1 and len(libs) == 1, (loaded, libs)
    assert loaded == {f"loaded {build_dir / libs[0]}"}


def test_edited_source_gets_a_new_library(tmp_path):
    """The library's name hashes its source: a copy of csrc/ingest.cpp
    names the library the port builds; an edited copy another, which
    builds and loads."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(_build.CSRC / "ingest.cpp", src / "ingest.cpp")
    build_dir = tmp_path / "build"
    same = _build.host_lib_path("ingest", build_dir, src)
    assert same.name == _build.host_lib_path("ingest").name
    with open(src / "ingest.cpp", "a") as f:
        f.write("// edited\n")
    edited = _build.host_lib_path("ingest", build_dir, src)
    assert edited.name != same.name
    assert _build.build_host("ingest", build_dir, src) == edited
    import ctypes
    assert hasattr(ctypes.CDLL(str(edited)), "gs_parse_ksplat_section")


def test_failed_build_is_reported(tmp_path, monkeypatch):
    """A source that does not compile: get_lib() gives None, status() holds
    the compiler's error, and build_host raises with it."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "ingest.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.delenv("GS_NATIVE", raising=False)
    build_dir = tmp_path / "build"
    assert native.get_lib(build_dir) is None
    assert native.status(build_dir).startswith("unavailable")
    if shutil.which("g++") is not None:
        assert "g++ failed" in native.status(build_dir)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            _build.build_host("ingest", build_dir)
    assert not list(build_dir.glob("*.tmp"))


def test_ingest_source_is_the_jax_packages():
    """The port's csrc/ingest.cpp is the JAX package's native/ingest.cpp
    but its comments: the same C ABI and the same code."""
    def code(path):
        text = open(path).read()
        return [ln for ln in (re.sub(r"//.*", "", x).rstrip()
                              for x in text.splitlines()) if ln]
    ours = code(_build.CSRC / "ingest.cpp")
    assert ours == code(os.path.join(ROOT, "native", "ingest.cpp"))
    for fn in ("gs_parse_splat", "gs_parse_ply_inria_v1",
               "gs_parse_ksplat_section"):
        assert any(ln.startswith(f"int {fn}(") for ln in ours), fn
