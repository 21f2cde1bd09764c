"""The benchmark's frozen reference against the JAX package's outputs
stored in ``benchmark/data/golden.npz`` (copied from the port's golden
file), read as numpy."""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import head, tflite
from benchmark.reference.int8 import rgb565_to_int8
from benchmark.reference.net import Net

DATA = Path(__file__).resolve().parents[1] / "data"
TFLITE = DATA / "yoloface_corpus_int8.tflite"
HEAD56 = {"grid": 7, "stride": 8, "anchors": [[9, 14], [12, 17], [22, 21]],
          "conf_threshold": 0.7, "iou_threshold": 0.5, "max_detections": 16}


@pytest.fixture(scope="module")
def golden():
    with np.load(DATA / "golden.npz") as d:
        return {k: d[k] for k in d.files}


@pytest.fixture(scope="module")
def graph():
    return tflite.read(TFLITE)


def frames448():
    """The JAX golden file's 448 frames: numpy seed 448."""
    rng = np.random.default_rng(448)
    return rng.integers(-128, 128, (2, 448, 448, 3),
                        dtype=np.int64).astype(np.int8)


def _x56(golden):
    return rgb565_to_int8(torch.from_numpy(
        golden["frames"].astype(np.int32)).to(torch.uint16))


@pytest.mark.parametrize("bits,key", [("fast2", "head"),
                                      ("exact", "head_exact")])
def test_head_tensor_matches_jax(golden, graph, bits, key):
    y = Net(graph, bits)(_x56(golden))
    np.testing.assert_array_equal(y.numpy(), golden[key])


@pytest.mark.parametrize("bits,prefix", [("fast2", ""), ("exact", "exact_")])
def test_detections_match_jax(golden, graph, bits, prefix):
    y = Net(graph, bits)(_x56(golden))
    out = graph["tensors"][graph["outputs"][0]]
    d = head.detect(y, scale=out["scales"][0], zero_point=out["zps"][0],
                    head=HEAD56)
    np.testing.assert_array_equal(d["valid"].numpy(), golden[prefix + "valid"])
    np.testing.assert_array_equal(d["count"].numpy(), golden[prefix + "count"])
    # torch's and XLA's CPU exp differ by an ulp on a few inputs: boxes
    # within 3e-5 px, scores within 5e-7 (about 8 ulp)
    np.testing.assert_allclose(d["boxes"].numpy(), golden[prefix + "boxes"],
                               rtol=0, atol=3e-5)
    np.testing.assert_allclose(d["scores"].numpy(),
                               golden[prefix + "scores"], rtol=0, atol=5e-7)


@pytest.mark.parametrize("bits,key", [("fast2", "head448"),
                                      ("exact", "head448_exact")])
def test_448_head_matches_jax(golden, graph, bits, key):
    x = frames448()
    assert hashlib.sha256(x.tobytes()).hexdigest() == str(
        golden["frames448_sha256"])
    y = Net(tflite.retarget(graph, 8), bits)(torch.from_numpy(x), block=1)
    np.testing.assert_array_equal(y.numpy(), golden[key])


def test_int4_control_changes_the_head(golden, graph):
    x = _x56(golden)
    y8 = Net(graph, "fast2")(x)
    y4 = Net(graph, "fast2", weight_bits=4)(x)
    assert int((y8 != y4).sum()) > 0


def test_reader_shapes(graph):
    t = graph["tensors"]
    assert t[graph["inputs"][0]]["shape"] == (1, 56, 56, 3)
    assert t[graph["outputs"][0]]["shape"] == (1, 7, 7, 18)
    assert len(graph["ops"]) == 54
    g448 = tflite.retarget(graph, 8)
    assert g448["tensors"][g448["outputs"][0]]["shape"] == (1, 56, 56, 18)
