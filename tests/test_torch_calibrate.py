"""The port's PTQ calibration, weight import and float engine against the
JAX package (CPU), on the corpus template
(``checkpoints/yoloface_corpus_int8.tflite``).

The numpy parts (BN folding, the template's dequantized weights, the
qparams, the int8 graph from given ranges) are JAX's code and must be
bit-equal.  The float forward runs float32 convolutions in another
summation order: every tensor is held to 1e-5 of its scale (measured
1.1e-6), the observed ranges to 1e-5 of theirs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloface_tpu.io.tflite_import import load_tflite as jload
from yoloface_tpu.models import import_weights as jimport
from yoloface_tpu.models.yoloface import YoloFace as JYoloFace
from yoloface_tpu.quantize import calibrate as jcal
from yoloface_tpu.runtime.float_engine import FloatEngine as JFloatEngine
from yoloface_tpu_torch.convert import graph_from_jax
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.models import import_weights
from yoloface_tpu_torch.models.convert import state_dict_from_flax
from yoloface_tpu_torch.models.yoloface import YoloFace
from yoloface_tpu_torch.quantize import calibrate as cal
from yoloface_tpu_torch.runtime.engine import Int8Engine
from yoloface_tpu_torch.runtime.float_engine import FloatEngine

torch.set_num_threads(2)
CORPUS = "checkpoints/yoloface_corpus_int8.tflite"


@pytest.fixture(scope="module")
def templates():
    return jload(CORPUS), load_tflite(CORPUS)


@pytest.fixture(scope="module")
def rep():
    from yoloface_tpu_torch.examples.train_synthetic import make_batch
    return make_batch(np.random.default_rng(123), 16)[0]


def _trained_like_variables(seed=0):
    """JAX init with BN scales, shifts and statistics moved, as after
    training."""
    v = jax.tree.map(np.array, dict(JYoloFace().init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 56, 56, 3)), train=True)))
    rng = np.random.default_rng(seed)
    for path, arr in jax.tree_util.tree_leaves_with_path(v):
        key = jax.tree_util.keystr(path)
        if "var" in key:
            arr[...] = rng.uniform(0.3, 2.0, arr.shape)
        elif "mean" in key or "bias" in key:
            arr[...] = rng.normal(0, 0.3, arr.shape)
        elif "scale" in key:
            arr[...] = rng.uniform(0.5, 1.5, arr.shape)
    return v


def _qparams(q, f32):
    if q is None or not f32:
        return q
    return (tuple(np.float32(q.scales)), q.zero_points,
            q.quantized_dimension)


def _assert_graphs_equal(a, b, f32_scales=False):
    """Field for field, constants bit for bit; with ``f32_scales`` the
    scales as a .tflite file holds them (float32)."""
    assert len(a.tensors) == len(b.tensors) and len(a.ops) == len(b.ops)
    for t1, t2 in zip(a.tensors, b.tensors):
        assert (t1.index, t1.name, tuple(t1.shape), np.dtype(t1.dtype),
                _qparams(t1.qparams, f32_scales)) == (
            t2.index, t2.name, tuple(t2.shape), np.dtype(t2.dtype),
            _qparams(t2.qparams, f32_scales)), t1.name
        assert (t1.data is None) == (t2.data is None), t1.name
        if t1.data is not None:
            assert t1.data.dtype == t2.data.dtype, t1.name
            np.testing.assert_array_equal(t1.data, t2.data, err_msg=t1.name)
    for o1, o2 in zip(a.ops, b.ops):
        assert dataclasses.asdict(o1) == dataclasses.asdict(o2)
    assert (a.inputs, a.outputs, a.name, a.description) == \
        (b.inputs, b.outputs, b.name, b.description)


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_fold_batchnorm_is_bit_equal():
    v = _trained_like_variables()
    a, b = cal.fold_batchnorm(v), jcal.fold_batchnorm(v)
    assert sorted(a) == sorted(b) == sorted(cal.FLAX_TO_TEMPLATE_OP)
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def test_template_weights_are_bit_equal(templates):
    jt, pt = templates
    a = import_weights.dequantize_template_weights(pt)
    b = jimport.dequantize_template_weights(jt)
    assert sorted(a) == sorted(b)
    for k in a:
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y)
    _assert_trees_equal(import_weights.variables_from_template(pt),
                        jax.tree.map(np.asarray,
                                     jimport.variables_from_template(jt)))


def test_float_forward_matches_jax_on_every_tensor(templates, rep):
    jt, pt = templates
    w = jimport.dequantize_template_weights(jt)
    want = jcal.float_forward(jt, w, rep[:8])
    got = cal.float_forward(pt, w, rep[:8], device="cpu")
    assert sorted(got) == sorted(want) and len(got) == 1 + len(pt.ops)
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        assert float(np.abs(a - b).max()) <= 1e-5 * max(
            1.0, float(np.abs(b).max())), k


def test_float_forward_fq_hook_sees_jax_s_tensors(templates, rep):
    """The QAT insertion point: the hook gets (tensor index, NHWC value) on
    the input and every op output, and its result is what flows on."""
    jt, pt = templates
    w = jimport.dequantize_template_weights(jt)
    seen = []

    def fq(i, v):
        seen.append((i, tuple(v.shape)))
        return torch.clamp(v, -2.0, 2.0)

    want = jcal.float_forward(jt, w, rep[:2],
                              fq=lambda i, v: jnp.clip(v, -2.0, 2.0))
    got = cal.float_forward(pt, w, rep[:2], fq=fq, device="cpu")
    assert seen == [(k, tuple(np.asarray(want[k]).shape)) for k in want]
    out = pt.outputs[0]
    np.testing.assert_allclose(got[out].numpy(), np.asarray(want[out]),
                               rtol=0, atol=1e-5 * 2.0)


@pytest.mark.parametrize("observer", ["minmax", "percentile", "ema"])
def test_observed_ranges_match_jax(templates, rep, observer):
    jt, pt = templates
    w = jimport.dequantize_template_weights(jt)
    want = jcal.observe_ranges(jt, w, rep, batch=8, observer=observer)
    got = cal.observe_ranges(pt, w, rep, batch=8, observer=observer,
                             device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(1.0, abs(want[k][0]), abs(want[k][1]))
        assert abs(got[k][0] - want[k][0]) <= 1e-5 * scale, k
        assert abs(got[k][1] - want[k][1]) <= 1e-5 * scale, k


def test_int8_graph_from_the_same_ranges_is_equal(templates, rep):
    """build_int8_graph on JAX's ranges and the same folded weights: the
    port's graph equals JAX's field for field."""
    jt, pt = templates
    weights = jcal.fold_batchnorm(_trained_like_variables(1))
    ranges = jcal.observe_ranges(jt, weights, rep)
    _assert_graphs_equal(cal.build_int8_graph(pt, weights, ranges),
                         graph_from_jax(jcal.build_int8_graph(jt, weights,
                                                              ranges)))
    for lo, hi in [(0.0, 1.0), (-1.0, 1.0), (0.5, 1.5), (-0.3, 0.7),
                   (-7.25, 0.0), (2.0, 2.0)]:
        assert dataclasses.astuple(cal.choose_qparams(lo, hi)) == \
            dataclasses.astuple(jcal.choose_qparams(lo, hi))
    wq = np.random.default_rng(0).normal(0, 0.2, (24, 3, 3, 12))
    for axis in (0, 3):
        q1, p1 = cal.quantize_weights_per_channel(wq, axis)
        q2, p2 = jcal.quantize_weights_per_channel(wq, axis)
        np.testing.assert_array_equal(q1, q2)
        assert dataclasses.astuple(p1) == dataclasses.astuple(p2)


def test_calibrate_matches_jax_and_takes_each_form(templates, rep):
    """calibrate from the same variables: the weights are bit-equal (they
    do not depend on the ranges), scales within 1e-5, zero points within 1
    (a range at a rounding edge) and biases within 1; the same graph from
    Flax variables, the port's state dict and a YoloFace."""
    jt, pt = templates
    v = _trained_like_variables(2)
    want = graph_from_jax(jcal.calibrate(v, rep, jt))
    got = cal.calibrate(v, rep, pt, device="cpu")
    model = YoloFace()
    model.load_state_dict(state_dict_from_flax(v))
    _assert_graphs_equal(got, cal.calibrate(model.state_dict(), rep, pt,
                                            device="cpu"))
    _assert_graphs_equal(got, cal.calibrate(model, rep, pt, device="cpu"))
    for t1, t2 in zip(got.tensors, want.tensors):
        if t1.qparams is not None:
            np.testing.assert_allclose(t1.qparams.scales, t2.qparams.scales,
                                       rtol=1e-5, err_msg=t1.name)
            assert np.abs(np.subtract(t1.qparams.zero_points,
                                      t2.qparams.zero_points)).max() <= 1
        if t1.data is not None:
            d = np.abs(t1.data.astype(np.int64) - t2.data.astype(np.int64))
            assert d.max() <= (1 if t1.data.dtype == np.int32 else 0), \
                t1.name


def _float_graph(jt):
    """A float32 graph of the corpus topology: the template's dequantized
    weights as constants, no qparams (the reference fp32 .tflite is not in
    the repository)."""
    import copy
    g = copy.deepcopy(jt)
    w = jimport.dequantize_template_weights(jt)
    for t in g.tensors:
        t.qparams = None
        if t.dtype != np.dtype(np.int32) or t.data is None:
            t.dtype = np.dtype(np.float32)
    for op in g.ops:
        if op.index in w:
            g.tensors[op.inputs[1]].data = w[op.index][0]
            g.tensors[op.inputs[2]].data = w[op.index][1]
            g.tensors[op.inputs[2]].dtype = np.dtype(np.float32)
    return g


def test_float_engine_matches_jax(templates, rep):
    jt, _ = templates
    jg = _float_graph(jt)
    pg = graph_from_jax(jg)
    x = rep[:4]
    want = np.asarray(JFloatEngine(jg)(x))
    eng = FloatEngine(pg, device="cpu")
    got = eng(x)
    assert got.shape == want.shape == (4, 7, 7, 18)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * max(
        1.0, float(np.abs(want).max()))
    inter = eng.run_with_intermediates(x)
    want_inter = JFloatEngine(jg).run_with_intermediates(x)
    assert sorted(inter) == sorted(want_inter)
    # the errors JAX raises
    with pytest.raises(ValueError, match="float32 graph"):
        FloatEngine(load_tflite(CORPUS), device="cpu")
    with pytest.raises(ValueError, match="full-int8"):
        Int8Engine(pg, "exact", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FloatEngine(pg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cal.calibrate(_trained_like_variables(), rep, load_tflite(CORPUS))
