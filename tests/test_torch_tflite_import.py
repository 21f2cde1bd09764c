"""The port's TFLite loader and ``convert.graph_from_jax`` both give the JAX
loader's GraphDef on the corpus graph, field by field."""

import os

import numpy as np
import pytest
import torch

from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu_torch.convert import graph_from_jax
from yoloface_tpu_torch.io.tflite_import import load_tflite

torch.set_num_threads(1)
CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "checkpoints", "yoloface_corpus_int8.tflite")


def assert_graph_equal(a, b):
    assert (a.inputs, a.outputs, a.name, a.description) == \
        (b.inputs, b.outputs, b.name, b.description)
    assert len(a.tensors) == len(b.tensors)
    for ta, tb in zip(a.tensors, b.tensors):
        assert (ta.index, ta.name, tuple(ta.shape), np.dtype(ta.dtype)) == \
            (tb.index, tb.name, tuple(tb.shape), np.dtype(tb.dtype))
        qa, qb = ta.qparams, tb.qparams
        assert (qa is None) == (qb is None), ta.name
        if qa is not None:
            assert (qa.scales, qa.zero_points, qa.quantized_dimension) == \
                (qb.scales, qb.zero_points, qb.quantized_dimension)
        assert (ta.data is None) == (tb.data is None), ta.name
        if ta.data is not None:
            assert ta.data.dtype == tb.data.dtype
            np.testing.assert_array_equal(ta.data, tb.data)
    assert len(a.ops) == len(b.ops)
    for oa, ob in zip(a.ops, b.ops):
        assert (oa.index, oa.opname, list(oa.inputs), list(oa.outputs),
                oa.attrs) == (ob.index, ob.opname, list(ob.inputs),
                              list(ob.outputs), ob.attrs)


@pytest.fixture(scope="module")
def jax_graph():
    return jax_load_tflite(CORPUS)


def test_port_loader_equals_jax_loader(jax_graph):
    g = load_tflite(CORPUS)
    assert_graph_equal(g, jax_graph)
    assert len(g.ops) == 54


def test_graph_from_jax_equals_jax_loader(jax_graph):
    g = graph_from_jax(jax_graph)
    assert_graph_equal(g, jax_graph)
    # a copy: the port's constants do not share memory with the JAX graph's
    w = next(t for t in g.tensors if t.data is not None)
    assert not np.shares_memory(w.data, jax_graph.tensor(w.index).data)


@pytest.mark.parametrize("blob,msg", [(b"TFL", "too small"),
                                      (b"\0\0\0\0XXXX", "identifier")])
def test_port_loader_rejects_non_tflite(blob, msg):
    with pytest.raises(ValueError, match=msg):
        load_tflite(blob)
