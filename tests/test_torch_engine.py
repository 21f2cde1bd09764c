"""The port's ``fast`` and ``fast2`` engines against the JAX engine, bit for
bit (tolerance 0) on every tensor: the corpus graph and fuzz seed 4."""

import os

import numpy as np
import pytest
import torch

from test_tiled_fuzz import _int8_graph
from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.runtime.engine import Int8Engine as JaxEngine
from yoloface_tpu_torch.convert import graph_from_jax
from yoloface_tpu_torch.graph.ir import GraphDef, OpDef, QParams, TensorDef
from yoloface_tpu_torch.runtime.engine import Int8Engine

torch.set_num_threads(1)
CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "checkpoints", "yoloface_corpus_int8.tflite")
SEED4_OPS = {"CONV_2D", "LEAKY_RELU", "PAD", "MAX_POOL_2D", "QUANTIZE",
             "CONCATENATION"}


@pytest.fixture(scope="module")
def corpus():
    return jax_load_tflite(CORPUS)


def _frames(seed, n, shape):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n,) + shape, dtype=np.int64)
    return x.astype(np.int8)


@pytest.mark.parametrize("mode,n_tensors", [("fast", 55), ("fast2", 38)])
def test_corpus_every_tensor_equals_jax(corpus, mode, n_tensors):
    x = _frames(0, 4, (56, 56, 3))
    want = JaxEngine(corpus, mode).run_with_intermediates(x)
    got = Int8Engine(graph_from_jax(corpus), mode).run_with_intermediates(x)
    assert sorted(got) == sorted(want) and len(got) == n_tensors
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"t{k}")


@pytest.mark.parametrize("mode", ["fast", "fast2"])
def test_fuzz_seed4_equals_jax(mode):
    jg, rng = _int8_graph(4)
    # every op of seed 4 lies in the slice: the case cannot pass by skipping
    assert {op.opname for op in jg.ops} == SEED4_OPS
    x = rng.integers(-128, 128, (3, 14, 14, 3), dtype=np.int64).astype(np.int8)
    want = JaxEngine(jg, mode).run_with_intermediates(x)
    got = Int8Engine(graph_from_jax(jg), mode).run_with_intermediates(x)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"t{k}")


@pytest.mark.parametrize("n", [1, 7])
def test_ragged_batches(corpus, n):
    x = _frames(n, n, (56, 56, 3))
    want = np.asarray(JaxEngine(corpus, "fast2")(x))
    got = Int8Engine(graph_from_jax(corpus), "fast2")(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def _tiny_graph(opname):
    q = QParams((0.05,), (3,))
    tensors = [TensorDef(0, "in", (1, 4, 4, 2), np.dtype(np.int8), q),
               TensorDef(1, "out", (1, 4, 4, 2), np.dtype(np.int8), q)]
    return GraphDef(tensors, [OpDef(0, opname, [0], [1], {})], [0], [1])


@pytest.mark.parametrize("mode", ["fast", "fast2", "arena2"])
def test_unknown_op_raises(mode):
    with pytest.raises(NotImplementedError, match="LOGISTIC"):
        Int8Engine(_tiny_graph("LOGISTIC"), mode)


def test_bad_mode_and_input_rejected(corpus):
    g = graph_from_jax(corpus)
    with pytest.raises(ValueError, match="mode"):
        Int8Engine(g, "pallas_mxu2")
    eng = Int8Engine(g, "fast2")
    with pytest.raises(ValueError, match="int8"):
        eng(torch.zeros((1, 56, 56, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="expected input"):
        eng(torch.zeros((1, 28, 28, 3), dtype=torch.int8))
