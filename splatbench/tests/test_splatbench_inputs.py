"""The inputs repeat exactly from a seed, and every seed gets the same
sizes of work in another order."""

import json
import math

import pytest
import torch

from conftest import ROOT
from splatbench import scene

CONFIG = json.loads((ROOT / "splatbench/configs/garden-3dgs.json")
                    .read_text())
CONFIG = dict(CONFIG, splats=500, width=64, height=48)
TRAIN = json.loads((ROOT / "splatbench/traffic/train.json").read_text())
ORBIT = json.loads((ROOT / "splatbench/traffic/orbit.json").read_text())
SEEDS = [1, 2 ** 31 + 12345, 2 ** 40 + 7]


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("seed", SEEDS)
def test_scene_repeats_from_the_seed(seed):
    a = scene.draw_params(CONFIG, seed, "cpu")
    b = scene.draw_params(CONFIG, seed, "cpu")
    assert _same(a, b)
    assert set(a) == set(scene.FIELDS)
    assert a["sh"].shape == (500, 8, 3)
    c = scene.draw_params(CONFIG, seed + 1, "cpu")
    assert not torch.equal(a["means"], c["means"])
    assert float(a["means"].abs().max()) <= CONFIG["scene"]["extent"]


@pytest.mark.parametrize("seed", SEEDS)
def test_views_and_targets_repeat_from_the_seed(seed):
    va = scene.ring_views(CONFIG, TRAIN)
    vb = scene.ring_views(CONFIG, TRAIN)
    assert len(va) == TRAIN["views"]
    for x, y in zip(va, vb):
        assert torch.equal(x["view"], y["view"]) and x["eye"] == y["eye"]
    ta = scene.draw_targets(CONFIG, TRAIN, seed, "cpu")
    assert torch.equal(ta, scene.draw_targets(CONFIG, TRAIN, seed, "cpu"))
    assert ta.shape == (TRAIN["views"], 48, 64, 3)
    assert scene.view_order(32, seed, 100) == scene.view_order(32, seed, 100)


def test_every_seed_gets_the_same_radii_and_elevations():
    """The views are one fixed set, stratified in radius, elevation and
    azimuth: the seed changes only their order (``view_order``)."""
    views = scene.ring_views(CONFIG, TRAIN)
    n = TRAIN["views"]
    r = sorted(sum(e * e for e in v["eye"]) ** 0.5 for v in views)
    (r0, r1), (e0, e1) = TRAIN["radius"], TRAIN["elevation_deg"]
    assert r == pytest.approx([r0 + (r1 - r0) * (i + 0.5) / n
                               for i in range(n)])
    el = sorted(math.degrees(math.asin(v["eye"][1] / rv))
                for v, rv in zip(views, (sum(e * e for e in v["eye"]) ** 0.5
                                         for v in views)))
    assert el == pytest.approx([e0 + (e1 - e0) * (i + 0.5) / n
                                for i in range(n)])
    az = sorted(math.degrees(math.atan2(v["eye"][2], v["eye"][0])) % 360.0
                for v in views)
    assert az == pytest.approx([360.0 * (i + 0.5) / n for i in range(n)])
    orders = [scene.view_order(n, s, n) for s in SEEDS]
    assert all(sorted(o) == list(range(n)) for o in orders)
    assert orders[0] != orders[1]


def test_view_order_takes_every_view_once_per_run():
    order = scene.view_order(32, 99, 32 * 5)
    for k in range(5):
        assert sorted(order[32 * k:32 * (k + 1)]) == list(range(32))
    assert len(set(order[:3])) == 3


@pytest.mark.parametrize("seed", SEEDS)
def test_orbit_repeats_and_sweeps_its_ranges(seed):
    a = scene.Orbit(CONFIG, ORBIT, seed)
    b = scene.Orbit(CONFIG, ORBIT, seed)
    cams = [a.next() for _ in range(600)]
    assert all(x["eye"] == b.next()["eye"] for x in cams)
    r = [sum(e * e for e in c["eye"]) ** 0.5 for c in cams]
    lo, hi = ORBIT["radius"]
    assert lo - 1e-9 <= min(r) < lo + 0.05 and hi - 0.05 < max(r) <= hi + 1e-9
