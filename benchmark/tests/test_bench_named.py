"""The modules that configurations, traffic files and metrics name, and
the harness's pieces that a configuration without a head leaves out."""

import json
from pathlib import Path

import pytest
import torch

from benchmark.harness import cell, check, frames, named, work

ROOT = Path(__file__).resolve().parents[2]


def _config(name):
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_a_missing_module_names_itself():
    with pytest.raises(SystemExit, match="no frames module 'rgb888'"):
        named.module("frames", "rgb888")


def test_modules_load_once():
    assert named.module("frames", "int8") is named.module("frames", "int8")


def test_int8_frames_at_448_repeat_each_pixel():
    f = frames._augment(frames.base_frames("cpu"), 3,
                        torch.Generator().manual_seed(5), "cpu")
    x = named.module("frames", "int8").convert(f, {"input_hw": [448, 448]})
    from benchmark.reference.int8 import rgb565_to_int8
    x56 = rgb565_to_int8(f)
    assert torch.equal(x, x56.repeat_interleave(8, 1).repeat_interleave(8, 2))


def test_int8_frames_at_a_size_that_is_no_multiple_of_56():
    f = frames._augment(frames.base_frames("cpu"), 2,
                        torch.Generator().manual_seed(6), "cpu")
    x = named.module("frames", "int8").convert(f, {"input_hw": [416, 416]})
    from benchmark.reference.int8 import rgb565_to_int8
    x56 = rgb565_to_int8(f)
    assert x.shape == (2, 416, 416, 3) and x.dtype == torch.int8
    assert torch.equal(x[:, 0, 0], x56[:, 0, 0])
    assert torch.equal(x[:, -1, -1], x56[:, -1, -1])


@pytest.mark.parametrize("traffic", ["arena2", "tiled2"])
def test_pool_from_the_seed(traffic):
    s = cell.spec({"arena2": "face56.arena2.b65536",
                   "tiled2": "face448.tiled2.b1024"}[traffic])
    a = frames.make_pool(s["traffic"], s["config"], 2**33 + 1, "cpu", 2)
    b = frames.make_pool(s["traffic"], s["config"], 2**33 + 1, "cpu", 2)
    c = frames.make_pool(s["traffic"], s["config"], 2**33 + 2, "cpu", 2)
    assert len(a) == frames.POOL
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    assert [x.shape for x in a] == [x.shape for x in c]
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_a_config_without_decode_checks_the_head_tensor_alone():
    cfg = _config("face56")
    del cfg["decode"]
    graph = work.graph_of(cfg, ROOT)
    x = frames.make_pool({"frames": "int8", "batch": 4}, cfg, 3, "cpu")[0]
    ref = check.Reference(cfg, graph, "fast2", "cpu")(x)
    assert set(ref) == {"y"}
    values = check.compare({"y": ref["y"].clone()}, ref)
    assert values == {"head_bytes_differ": 0}
    assert check.detections_seen(ref) == (0, 0)
    w = work.per_frame(cfg, {"frames": "int8"}, graph)
    assert set(w) == {"net"}
    ctx = cell.Context(work=w, trace=None)
    assert named.module("metrics", "head_roofline").read(ctx) is None
