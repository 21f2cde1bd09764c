"""The benchmark's own count of the graph's work and the rooflines'
arithmetic."""

import json
from pathlib import Path

import pytest

from benchmark.harness import work
from benchmark.reference import tflite

ROOT = Path(__file__).resolve().parents[2]


def _load(kind, name):
    with open(ROOT / "benchmark" / kind / f"{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("config,macs", [("face56", 1_029_000),
                                         ("face448", 65_856_000)])
def test_macs_per_frame(config, macs):
    cfg = _load("configs", config)
    g = work.graph_of(cfg, ROOT)
    assert tflite.macs_per_frame(g) == macs == cfg["macs_per_frame"]


def test_bytes_and_bounds_face56():
    cfg, tr = _load("configs", "face56"), _load("traffic", "arena2")
    w = work.per_frame(cfg, tr, work.graph_of(cfg, ROOT))
    assert w["preprocess"] == {"bytes": 25_088 + 9_408, "macs": 0}
    assert w["net"] == {"bytes": 9_408 + 882, "macs": 1_029_000}
    assert w["head"]["bytes"] == 882 + 16 * 21 + 4
    # the net at 56 is bound by its bytes: 10,290 B over 3.35 TB/s is more
    # than 2 x 1,029,000 operations over 1,979 TOPS
    assert work.bound_s(w["net"]) == pytest.approx(10_290 / 3.35e12)
    assert 65536 * work.bound_s(w["net"]) == pytest.approx(0.2013e-3,
                                                           rel=1e-3)
    assert 65536 * work.bound_s(w["preprocess"]) == pytest.approx(
        0.6749e-3, rel=1e-3)


def test_bytes_and_bounds_face448():
    cfg, tr = _load("configs", "face448"), _load("traffic", "tiled2")
    w = work.per_frame(cfg, tr, work.graph_of(cfg, ROOT))
    assert "preprocess" not in w            # an int8 entry
    assert w["net"]["bytes"] == 448 * 448 * 3 + 56 * 56 * 18
    assert 1024 * work.bound_s(w["net"]) == pytest.approx(0.2013e-3,
                                                          rel=1e-3)


def test_bound_takes_the_larger_term():
    assert work.bound_s({"bytes": 0, "macs": 1e9}) == pytest.approx(
        2e9 / 1.979e15)
    assert work.bound_s({"bytes": 3.35e12, "macs": 1}) == pytest.approx(1.0)


def test_every_op_kind_priced_at_one_peak():
    """A depthwise MAC costs what a conv MAC costs: a layer that runs its
    depthwise taps on the tensor cores cannot read over 100%."""
    g = tflite.read(ROOT / "benchmark/data/yoloface_corpus_int8.tflite")
    dw = sum(1 for op in g["ops"] if op["name"] == "DEPTHWISE_CONV_2D")
    assert dw == 7
    w = {"bytes": 0, "macs": tflite.macs_per_frame(g)}
    assert work.bound_s(w) == pytest.approx(2 * 1_029_000 / work.INT8_OPS_S)
