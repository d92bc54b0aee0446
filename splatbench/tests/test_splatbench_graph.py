"""The reader of the training step's CUDA graph, ``graph_replays.train.2d``,
on a fake registry of the program's counters: the share of the traced
steps that a replay served, and None where the program counts no graph
or no binning, off the card, or in a cell of another kind."""

import math
import sys
import types
from types import SimpleNamespace

import pytest

from splatbench import harness

METRIC = "graph_replays.train.2d"


def _probe(kind="train", on_card=True):
    return SimpleNamespace(kind=kind, on_card=on_card, run=SimpleNamespace(
        gt=SimpleNamespace(__name__="gprog")))


@pytest.fixture
def registry(monkeypatch):
    reg = types.ModuleType("gprog.utils.metrics")
    monkeypatch.setitem(sys.modules, "gprog.utils.metrics", reg)
    return reg


@pytest.mark.parametrize("replays,eager,want", [
    (4, 0, 100.0), (3, 1, 75.0), (0, 4, 0.0)])
def test_reads_the_share_of_replayed_steps(registry, replays, eager, want):
    registry.totals = lambda: {"bin.calls": 4, "train.graph.replays": replays,
                               "train.graph.eager": eager,
                               "train.graph.captures": 1}
    assert math.isclose(harness.reader(METRIC).read(_probe()), want)


def test_reads_none_without_the_counters(registry):
    # a program that bins but counts no graph (the parent of the graph)
    registry.totals = lambda: {"bin.calls": 4, "bin.slots": 1000}
    assert harness.reader(METRIC).read(_probe()) is None
    # no binning counted, off the card, or an orbit cell
    registry.totals = lambda: {"train.graph.replays": 4}
    assert harness.reader(METRIC).read(_probe()) is None
    registry.totals = lambda: {"bin.calls": 4, "train.graph.replays": 4}
    assert harness.reader(METRIC).read(_probe(on_card=False)) is None
    assert harness.reader(METRIC).read(_probe(kind="orbit")) is None
    # a registry without totals
    del registry.totals
    assert harness.reader(METRIC).read(_probe()) is None
