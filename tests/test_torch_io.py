"""Scene-file IO of the port (gaussiansplats3d_tpu_torch/io) against the JAX
package's: the same bytes decode to the same float32 bits (both packages
pinned to their numpy decoders with GS_NATIVE=0, which also keeps these
tests from building the native libraries; tests/test_torch_native.py
holds the native decoders), and the same arrays encode to the same
bytes (.spz: the same gzip payload and header but its timestamp), for
.ply (INRIA v1, v2 and PlayCanvas), .splat, .ksplat at compression levels
0/1/2 and SH degrees 0/1/2, and .spz; bytes of the reference's writer
(tests/reference_ksplat_writer.py) decode as the JAX reader decodes them;
dispatch, SH truncation and the errors match.  No tolerance: bit for bit."""

import dataclasses
import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussiansplats3d_tpu as gs
import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu.io import formats as fmt_j
from gaussiansplats3d_tpu.io import ksplat as ks_j
from gaussiansplats3d_tpu.io import ply as ply_j
from gaussiansplats3d_tpu.io import splat as splat_j
from gaussiansplats3d_tpu.io import spz as spz_j
from gaussiansplats3d_tpu_torch.io import formats as fmt_t
from gaussiansplats3d_tpu_torch.io import ksplat as ks_t
from gaussiansplats3d_tpu_torch.io import ply as ply_t
from gaussiansplats3d_tpu_torch.io import splat as splat_t
from gaussiansplats3d_tpu_torch.io import spz as spz_t
# tests/ is on sys.path (as for torch_port_common); a package named
# ``tests`` elsewhere on the path must not shadow these
import reference_ksplat_writer as ref
from test_ply_variants import build_inria_v2_ply, build_playcanvas_ply

from torch_port_common import scene_arrays

FIELDS = ("means", "scales", "quats", "colors", "sh")


@pytest.fixture(autouse=True)
def numpy_decoders(monkeypatch):
    """Both packages on their numpy decoders, not their native libraries
    (both read GS_NATIVE)."""
    monkeypatch.setenv("GS_NATIVE", "0")


def scenes(n=257, sh_degree=2, seed=5):
    """The same splats for both packages: (JAX SplatData, port SplatData on
    the CPU)."""
    arrays = scene_arrays(n, sh_degree=sh_degree, seed=seed)
    return (gs.SplatData(*(jnp.asarray(a) for a in arrays)),
            gt.SplatData.from_numpy(*arrays, device="cpu"))


def assert_same_bits(a_j, b_t):
    """Every field: float32, same shape, same bits."""
    for f in FIELDS:
        x = np.asarray(getattr(a_j, f))
        y = getattr(b_t, f).numpy()
        assert x.dtype == y.dtype == np.float32, f
        assert x.shape == y.shape, f
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32),
                                      err_msg=f)


def strided(splats):
    """The port's SplatData with every field a non-contiguous view of the
    same values."""
    def view(a):
        wide = torch.zeros(a.shape[:-1] + (a.shape[-1] * 2,), dtype=a.dtype)
        wide[..., ::2] = a
        v = wide[..., ::2]
        assert not v.is_contiguous() or v.numel() == 0
        return v
    return dataclasses.replace(splats, **{f: view(getattr(splats, f))
                                          for f in FIELDS})


WRITERS = {
    "ply": (ply_j.serialize_ply, ply_t.serialize_ply, ply_j.parse_ply,
            ply_t.parse_ply),
    "splat": (splat_j.serialize_splat, splat_t.serialize_splat,
              splat_j.parse_splat, splat_t.parse_splat),
    "spz": (spz_j.serialize_spz, spz_t.serialize_spz, spz_j.parse_spz,
            spz_t.parse_spz),
    **{f"ksplat{lv}": (
        lambda s, lv=lv: ks_j.serialize_ksplat(s, compression_level=lv),
        lambda s, lv=lv: ks_t.serialize_ksplat(s, compression_level=lv),
        ks_j.parse_ksplat, ks_t.parse_ksplat) for lv in (0, 1, 2)},
}


def same_bytes(name, a, b):
    if name == "spz":
        # gzip's header carries the time of writing (bytes 4-7)
        assert gzip.decompress(a) == gzip.decompress(b)
        a, b = a[:4] + a[8:], b[:4] + b[8:]
    assert a == b


@pytest.mark.parametrize("sh_degree", [0, 1, 2])
@pytest.mark.parametrize("name", list(WRITERS))
def test_writers_and_readers_match_jax(name, sh_degree):
    """Byte-identical files from the same arrays (also from non-contiguous
    tensors), and bit-identical arrays from those bytes."""
    write_j, write_t, parse_j, parse_t = WRITERS[name]
    s_j, s_t = scenes(sh_degree=sh_degree, seed=5 + sh_degree)
    data = write_j(s_j)
    same_bytes(name, write_t(s_t), data)
    same_bytes(name, write_t(strided(s_t)), data)
    assert_same_bits(parse_j(data), parse_t(data, device="cpu"))


@pytest.mark.parametrize("level", [0, 1, 2])
def test_multi_section_ksplat_and_prefix_decode_match_jax(level):
    """section_size splits the scene into sections (the JAX package slices
    with jax.tree.map, the port with tensor slices): the same bytes; a
    byte prefix decodes to the same splats (max_bytes)."""
    s_j, s_t = scenes(n=700, sh_degree=1, seed=9)
    kw = dict(compression_level=level, section_size=256)
    data = ks_j.serialize_ksplat(s_j, **kw)
    assert data == ks_t.serialize_ksplat(s_t, **kw)
    header = ks_t.parse_ksplat_header(data)
    assert header.section_count == 3
    assert_same_bits(ks_j.parse_ksplat(data),
                     ks_t.parse_ksplat(data, device="cpu"))
    headers = ks_t.HEADER_BYTES + 3 * ks_t.SECTION_HEADER_BYTES
    for cut in (headers + 1000, len(data) // 2, len(data) - 1):
        assert_same_bits(ks_j.parse_ksplat(data, max_bytes=cut),
                         ks_t.parse_ksplat(data, max_bytes=cut,
                                           device="cpu"))
    assert (_error(lambda: ks_t.parse_ksplat(data, max_bytes=headers - 1))
            == _error(lambda: ks_j.parse_ksplat(data,
                                                max_bytes=headers - 1)))
    # minimum_alpha filters the same splats
    assert (ks_j.serialize_ksplat(s_j, minimum_alpha=128)
            == ks_t.serialize_ksplat(s_t, minimum_alpha=128))


def _ply_variant_buffers():
    rng = np.random.default_rng(1)
    n = 300
    means = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(-5, -2, (n, 3))).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rgb_dc = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    op_logit = rng.uniform(-3, 3, n).astype(np.float32)
    sh = rng.uniform(-0.5, 0.5, (n, 3, 3)).astype(np.float32)
    rgba = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    sh8 = rng.uniform(-0.5, 0.5, (n, 8, 3)).astype(np.float32)
    ascii_ply = ("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                 "property float y\nproperty float z\nproperty uchar red\n"
                 "property uchar green\nproperty uchar blue\nend_header\n"
                 "0 0 0 255 0 0\n1 0.5 -1 0 128 0\n-1 2 3 7 7 200\n"
                 ).encode()
    return {
        "inria_v2": build_inria_v2_ply(means, scales, q, rgb_dc, op_logit,
                                       sh),
        "playcanvas": build_playcanvas_ply(means, np.log(scales), q, rgba,
                                           sh8),
        "pointcloud_ascii": ascii_ply,
    }


@pytest.mark.parametrize("sh_degree", [None, 1])
@pytest.mark.parametrize("variant", ["inria_v2", "playcanvas",
                                     "pointcloud_ascii"])
def test_ply_variants_decode_like_jax(variant, sh_degree):
    buf = _ply_variant_buffers()[variant]
    assert ply_t.detect_ply_variant(buf) == ply_j.detect_ply_variant(buf)
    assert_same_bits(ply_j.parse_ply(buf, sh_degree),
                     ply_t.parse_ply(buf, sh_degree, device="cpu"))


def reference_rows(n, sh_degree, seed):
    """UncompressedSplatArray rows for the reference writer (colors 0-255,
    quats w-first), as tests/test_format_interchange.py makes them."""
    rng = np.random.RandomState(seed)
    n_sh = {0: 0, 1: 9, 2: 24}[sh_degree]
    rows = []
    for _ in range(n):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        rows.append(list(rng.uniform(-2, 2, 3))
                    + list(rng.uniform(0.01, 0.3, 3)) + list(q) + list(rng.uniform(0, 255, 3))
                    + [rng.uniform(30, 255)]
                    + list(rng.uniform(-1.2, 1.2, n_sh)))
    return rows


@pytest.mark.parametrize("level,sh_degree", [(0, 0), (0, 2), (1, 1),
                                             (1, 2), (2, 1), (2, 2)])
def test_reference_writer_bytes_decode_like_jax(level, sh_degree):
    """The reference writer's .ksplat bytes (as in
    tests/test_format_interchange.py); its .splat and .spz too."""
    rows = reference_rows(40, sh_degree, seed=level * 10 + sh_degree)
    data = ref.write_ksplat([rows], minimum_alpha=1,
                            compression_level=level)
    got = ks_t.parse_ksplat(data, device="cpu")
    assert got.num_splats == 40
    assert_same_bits(ks_j.parse_ksplat(data), got)
    if level == 0:
        data = ref.write_splat(rows)
        assert_same_bits(splat_j.parse_splat(data),
                         splat_t.parse_splat(data, device="cpu"))
        clamped = [r[:14] + [min(max(v, -0.99), 0.99) for v in r[14:]]
                   for r in rows]
        data = ref.write_spz(clamped, sh_degree=sh_degree)
        assert_same_bits(spz_j.parse_spz(data),
                         spz_t.parse_spz(data, device="cpu"))


@pytest.mark.parametrize("ext", ["ply", "splat", "ksplat", "spz"])
def test_load_save_dispatch_and_sh_truncation(tmp_path, ext):
    s_j, s_t = scenes(n=100, sh_degree=2, seed=3)
    p_j, p_t = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
    gs.save(s_j, p_j)
    gt.save(s_t, p_t)
    with open(p_j, "rb") as a, open(p_t, "rb") as b:
        same_bytes("spz" if ext == "spz" else ext, b.read(), a.read())
    assert fmt_t.scene_format_from_path(p_t).value == ext
    for deg in (None, 0, 1):
        assert_same_bits(gs.load(p_j, sh_degree=deg),
                         gt.load(p_t, sh_degree=deg, device="cpu"))
    with open(p_t, "rb") as f:
        data = f.read()
    fmt = fmt_t.SceneFormat(ext)
    assert_same_bits(fmt_j.parse(data, fmt_j.SceneFormat(ext), 1),
                     fmt_t.parse(data, fmt, 1, device="cpu"))


def test_with_sh_degree_and_zeros_match_jax():
    s_j, s_t = scenes(n=50, sh_degree=1, seed=4)
    for deg in (0, 1, 2, 3):
        assert_same_bits(s_j.with_sh_degree(deg), s_t.with_sh_degree(deg))
    assert s_t.with_sh_degree(1) is s_t
    assert_same_bits(gs.SplatData.zeros(7, 2),
                     gt.SplatData.zeros(7, 2, device="cpu"))


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_errors_match_jax(tmp_path):
    s_j, s_t = scenes(n=20, sh_degree=0, seed=2)
    good = ks_j.serialize_ksplat(s_j)
    bad_version = bytearray(good)
    bad_version[0] = 1
    bad_level = bytearray(good)
    np.frombuffer(bad_level, "<u2", 11, 0)[10] = 3
    spz = bytearray(gzip.decompress(spz_j.serialize_spz(s_j)))
    bad_magic = gzip.compress(b"XXXX" + bytes(spz[4:]))
    spz[4] = 3
    bad_spz_version = gzip.compress(bytes(spz))
    cases = [
        (splat_j.parse_splat, splat_t.parse_splat, (b"\0" * 33,)),
        (ks_j.parse_ksplat, ks_t.parse_ksplat, (bytes(bad_version),)),
        (ks_j.parse_ksplat, ks_t.parse_ksplat, (bytes(bad_level),)),
        (spz_j.parse_spz, spz_t.parse_spz, (bad_magic,)),
        (spz_j.parse_spz, spz_t.parse_spz, (bad_spz_version,)),
        (ply_j.parse_ply, ply_t.parse_ply, (b"not a ply",)),
        (fmt_j.scene_format_from_path, fmt_t.scene_format_from_path,
         ("scene.obj",)),
    ]
    for fj, ft, args in cases:
        assert _error(lambda: ft(*args)) == _error(lambda: fj(*args))
    assert (_error(lambda: ks_t.serialize_ksplat(s_t, compression_level=3))
            == _error(lambda: ks_j.serialize_ksplat(s_j,
                                                    compression_level=3)))
    # a URL that names no file: the same fetch error (a file:// URL, so
    # nothing leaves the machine)
    missing = (tmp_path / "missing.ply").as_uri()
    errs = []
    for load in (gs.load, lambda p: gt.load(p, device="cpu")):
        with pytest.raises(OSError) as e:
            load(missing)
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]
