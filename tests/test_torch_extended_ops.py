"""The extended op surface of the port against the JAX package on the CPU,
bit for bit (tolerance 0): AVERAGE_POOL_2D, FULLY_CONNECTED, SOFTMAX and
RESHAPE in the base modes (``exact``, ``fast``, ``fast2``) on the graphs of
tests/test_extended_ops.py, the average pool also in the arena and tiled
modes (whole frame and in strips); numpy input, ``quantize_input`` and
``dequantize_output``; what ``convert.graph_from_jax`` carries across;
and the PAD -> AVERAGE_POOL_2D graph, which the arena and tiled modes
refuse.

SOFTMAX runs in float32 with ``exp`` on both sides.  Torch's and XLA's
CPU ``exp`` differ by an ulp on some inputs (ROADMAP "Watch ``exp``"), so
``test_softmax_every_output_equals_jax`` counts the int8 outputs that
differ over 4,000 random rows at four input quantizations: none do."""

import functools

import numpy as np
import pytest
import torch

from yoloface_tpu.graph import ir as jir
from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.ops import int8_ref as jax_ops
from yoloface_tpu.runtime.engine import Int8Engine as JaxEngine
from yoloface_tpu_torch.convert import graph_from_jax
from yoloface_tpu_torch.graph import ir
from yoloface_tpu_torch.kernels import arena, tiled
from yoloface_tpu_torch.ops import int8_ref
from yoloface_tpu_torch.runtime.engine import (ARENA_BITS, MODES,
                                               TILED_BITS, Int8Engine)
from test_torch_engine import CORPUS

torch.set_num_threads(1)
BASE = ("exact", "fast", "fast2")
KERNEL = {**ARENA_BITS, **TILED_BITS}


def _int8(seed, shape):
    return np.random.default_rng(seed).integers(
        -128, 128, shape, dtype=np.int64).astype(np.int8)


def one_op_graph(m, opname, attrs, in_shape, out_shape, in_q, out_q):
    """tests/test_extended_ops.py's one-op graph in the IR module ``m``."""
    i8 = np.dtype(np.int8)
    tensors = [m.TensorDef(0, "in", in_shape, i8, m.QParams(*in_q)),
               m.TensorDef(1, "out", out_shape, i8, m.QParams(*out_q))]
    return m.GraphDef(tensors, [m.OpDef(0, opname, [0], [1], attrs)],
                      [0], [1])


def _pool_attrs(fh, fw, stride, pad):
    return {"padding": pad, "stride_w": stride, "stride_h": stride,
            "filter_w": fw, "filter_h": fh, "activation": "NONE"}


def _pool_out(h, fh, stride, pad):
    return -(-h // stride) if pad == "SAME" else (h - fh) // stride + 1


# tests/test_extended_ops.py:37 (8x8x4) and :197 (12x12x8)
POOLS = [(3, 3, 2, "SAME", 8, 4), (2, 2, 2, "VALID", 8, 4),
         (3, 3, 1, "SAME", 8, 4), (4, 2, 2, "SAME", 8, 4),
         (3, 3, 2, "SAME", 12, 8), (2, 2, 2, "VALID", 12, 8)]


def _pool_graph(m, fh, fw, stride, pad, h, c):
    ow = _pool_out(h, fw, stride, pad)
    oh = _pool_out(h, fh, stride, pad)
    q = ((0.07,), (-5,)) if h == 8 else ((0.05,), (3,))
    return one_op_graph(m, "AVERAGE_POOL_2D", _pool_attrs(fh, fw, stride, pad),
                        (1, h, h, c), (1, oh, ow, c), q, q)


@functools.lru_cache(maxsize=None)
def _pool_case(k, bits):
    """(port graph, input, the JAX engine's output) of pool case ``k``."""
    fh, fw, stride, pad, h, c = POOLS[k]
    x = _int8(fh * 10 + fw + h, (2, h, h, c))
    want = np.asarray(JaxEngine(_pool_graph(jir, *POOLS[k]), bits)(x))
    return _pool_graph(ir, *POOLS[k]), x, want


@pytest.mark.parametrize("k", range(len(POOLS)))
@pytest.mark.parametrize("mode", BASE)
def test_avgpool_base_modes_equal_jax(k, mode):
    g, x, want = _pool_case(k, mode)
    got = Int8Engine(g, mode, device="cpu")(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", range(len(POOLS)))
@pytest.mark.parametrize("mode", list(KERNEL))
def test_avgpool_kernel_modes_equal_jax(k, mode):
    """The AVGPOOL op of the arena and tiled programs: through the engine
    (whole frame) and, for the tiled modes, in strips of a row or two,
    where the edge strips count only the taps inside the image."""
    g, x, want = _pool_case(k, KERNEL[mode])
    eng = Int8Engine(g, mode, device="cpu")
    assert arena.AVGPOOL in eng.arena.stages[0].descs[:, arena.F["code"]]
    np.testing.assert_array_equal(eng(x).numpy(), want)
    if mode in TILED_BITS:
        budget = 256 if x.shape[1] == 8 else 768
        plan = tiled.TiledPlan(g, budget, TILED_BITS[mode])
        (sec,) = plan.stages
        assert sec.strips >= 2
        got = plan.run_stages(torch.from_numpy(x))[g.outputs[0]]
        np.testing.assert_array_equal(got.numpy(), want)


def _pad_pool_graph(m):
    """PAD (zero-point 40) -> AVERAGE_POOL_2D 2x2 stride 2: TFLite counts
    the PAD's cells as taps holding 40."""
    q = m.QParams((0.05,), (40,))
    i8 = np.dtype(np.int8)
    pads = np.array([[0, 0], [1, 1], [1, 1], [0, 0]], np.int32)
    tensors = [m.TensorDef(0, "in", (1, 6, 6, 2), i8, q),
               m.TensorDef(1, "pads", (4, 2), np.dtype(np.int32), None, pads),
               m.TensorDef(2, "padded", (1, 8, 8, 2), i8, q),
               m.TensorDef(3, "out", (1, 4, 4, 2), i8, q)]
    ops = [m.OpDef(0, "PAD", [0, 1], [2], {}),
           m.OpDef(1, "AVERAGE_POOL_2D", [2], [3],
                   _pool_attrs(2, 2, 2, "VALID"))]
    return m.GraphDef(tensors, ops, [0], [3])


@pytest.mark.parametrize("mode", MODES)
def test_pad_into_avgpool(mode):
    """A PAD into an average pool: the base modes equal the JAX engine (the
    border means take the PAD's zero-point as taps); every other mode
    refuses the graph, since no window fill gives those bits (JAX's arena
    absorbs the PAD and reads its cells as fill 0 outside the tap count,
    ROADMAP section C)."""
    x = _int8(3, (2, 6, 6, 2))
    g = _pad_pool_graph(ir)
    if mode not in BASE:
        with pytest.raises(NotImplementedError, match="PAD|AVERAGE_POOL_2D"):
            Int8Engine(g, mode, device="cpu")
        return
    want = np.asarray(JaxEngine(_pad_pool_graph(jir), mode)(x))
    got = Int8Engine(g, mode, device="cpu")(x).numpy()
    np.testing.assert_array_equal(got, want)
    corner = (40 * 3 + x[:, 0, 0].astype(np.int64) + 2) // 4   # x + 3 pads
    assert (np.abs(got[:, 0, 0] - corner) <= 1).all()


def _fc_graph(m, seed, k, co, per_channel):
    """tests/test_extended_ops.py's FULLY_CONNECTED graphs (:125, :164)."""
    rng = np.random.default_rng(seed)
    lim, blim = (90, 500) if not per_channel else (100, 300)
    w = rng.integers(-lim, lim, (co, k), dtype=np.int64).astype(np.int8)
    b = rng.integers(-blim, blim, co).astype(np.int32)
    if per_channel:
        scales = tuple(float(s) for s in rng.uniform(0.01, 0.05, co))
        in_q, out_q = m.QParams((0.06,), (-2,)), m.QParams((0.2,), (5,))
        w_q = m.QParams(scales, (0,) * co, 0)
        b_q = m.QParams(tuple(0.06 * s for s in scales), (0,) * co, 0)
    else:
        in_q, out_q = m.QParams((0.05,), (4,)), m.QParams((0.11,), (-7,))
        w_q, b_q = m.QParams((0.02,), (0,)), m.QParams((0.05 * 0.02,), (0,))
    i8 = np.dtype(np.int8)
    tensors = [m.TensorDef(0, "in", (1, k), i8, in_q),
               m.TensorDef(1, "w", (co, k), i8, w_q, data=w),
               m.TensorDef(2, "b", (co,), np.dtype(np.int32), b_q, data=b),
               m.TensorDef(3, "out", (1, co), i8, out_q)]
    return m.GraphDef(tensors, [m.OpDef(0, "FULLY_CONNECTED", [0, 1, 2], [3],
                                        {"activation": "NONE"})], [0], [3])


@pytest.mark.parametrize("case", [(11, 24, 10, False), (13, 16, 6, True)])
@pytest.mark.parametrize("mode", BASE)
def test_fully_connected_equals_jax(case, mode):
    """Exact bits (an int64 MBQM) in every mode, per-tensor and
    per-channel weights."""
    x = _int8(case[0] + 1, (5, case[1]))
    want = np.asarray(JaxEngine(_fc_graph(jir, *case), mode)(x))
    got = Int8Engine(_fc_graph(ir, *case), mode, device="cpu")(x)
    np.testing.assert_array_equal(got.numpy(), want)


def _softmax_graph(m):
    i8 = np.dtype(np.int8)
    return m.GraphDef(
        [m.TensorDef(0, "in", (1, 16), i8, m.QParams((0.1,), (2,))),
         m.TensorDef(1, "out", (1, 16), i8, m.QParams((1.0 / 256,), (-128,)))],
        [m.OpDef(0, "SOFTMAX", [0], [1], {"beta": 1.0})], [0], [1])


@pytest.mark.parametrize("mode", BASE)
def test_softmax_equals_jax_fuzzed(mode):
    """tests/test_extended_ops.py:150's ten fuzzed rows, through both
    engines."""
    rng = np.random.default_rng(12)
    x = rng.integers(-128, 128, (10, 16), dtype=np.int64).astype(np.int8)
    want = np.asarray(JaxEngine(_softmax_graph(jir), mode)(x))
    got = Int8Engine(_softmax_graph(ir), mode, device="cpu")(x)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scale,zp,n", [(0.1, 2, 16), (0.05, -3, 10),
                                        (0.2, 0, 100), (0.3, 5, 1000)])
def test_softmax_every_output_equals_jax(scale, zp, n):
    """4,000 random rows of ``n`` logits: no int8 output differs."""
    x = _int8(n, (4000, n))
    want = np.asarray(jax_ops.softmax_int8(x, input_scale=scale,
                                           input_zp=zp))
    got = int8_ref.softmax_int8(torch.from_numpy(x), input_scale=scale,
                                input_zp=zp)
    assert int((got.numpy() != want).sum()) == 0


def _reshape_head(m):
    """tests/test_extended_ops.py's classifier tail: AVERAGE_POOL_2D 8x8 ->
    RESHAPE -> LOGISTIC, then a plain RESHAPE back to 4-D (:85, :99)."""
    q = m.QParams((0.04,), (-3,))
    i8 = np.dtype(np.int8)
    tensors = [m.TensorDef(0, "in", (1, 8, 8, 16), i8, q),
               m.TensorDef(1, "pooled", (1, 1, 1, 16), i8, q),
               m.TensorDef(2, "flat", (1, 16), i8, q),
               m.TensorDef(3, "probs", (1, 16), i8,
                           m.QParams((1.0 / 256,), (-128,))),
               m.TensorDef(4, "grid", (1, 2, 2, 4), i8,
                           m.QParams((1.0 / 256,), (-128,)))]
    ops = [m.OpDef(0, "AVERAGE_POOL_2D", [0], [1],
                   _pool_attrs(8, 8, 1, "VALID")),
           m.OpDef(1, "RESHAPE", [1], [2], {"new_shape": [1, 16]}),
           m.OpDef(2, "LOGISTIC", [2], [3], {}),
           m.OpDef(3, "RESHAPE", [3], [4], {"new_shape": [1, 2, 2, 4]})]
    return m.GraphDef(tensors, ops, [0], [4])


@pytest.mark.parametrize("mode", BASE)
def test_reshape_classifier_head_equals_jax(mode):
    x = _int8(9, (3, 8, 8, 16))
    want = JaxEngine(_reshape_head(jir), mode).run_with_intermediates(x)
    got = Int8Engine(_reshape_head(ir), mode,
                     device="cpu").run_with_intermediates(x)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3, 4]
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=f"t{k}")


@pytest.fixture(scope="module")
def corpus():
    g = jax_load_tflite(CORPUS)
    x = _int8(4, (2, 56, 56, 3))
    return g, x, np.asarray(JaxEngine(g, "exact")(x))


@pytest.mark.parametrize("mode", MODES)
def test_numpy_input_every_mode(corpus, mode):
    """``Int8Engine(g, mode)(np_int8)`` takes numpy as the JAX engine does,
    onto the engine's device, and gives the tensor the tensor input
    gives."""
    jg, x, want = corpus
    eng = Int8Engine(graph_from_jax(jg), mode, device="cpu")
    y = eng(x)
    assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
    np.testing.assert_array_equal(y.numpy(), eng(torch.from_numpy(x)).numpy())
    if mode.endswith("exact"):
        np.testing.assert_array_equal(y.numpy(), want)
    with pytest.raises(ValueError, match="int8"):
        eng(x.astype(np.uint8))


def test_quantize_dequantize_equal_jax(corpus):
    """``input_qparams``, ``quantize_input`` and ``dequantize_output`` under
    JAX's names, with its float32 bits (tests/test_keras_export.py:101)."""
    jg, _, want = corpus
    jeng = JaxEngine(jg, "exact")
    eng = Int8Engine(graph_from_jax(jg), "exact", device="cpu")
    assert eng.input_qparams == graph_from_jax(jg).tensor(
        jg.inputs[0]).qparams
    f = np.random.default_rng(1).uniform(-0.2, 1.2, (2, 56, 56, 3))
    f = f.astype(np.float32)
    q = eng.quantize_input(f)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jeng.quantize_input(f)))
    y = eng(q)
    np.testing.assert_array_equal(
        eng.dequantize_output(y).numpy(),
        np.asarray(jeng.dequantize_output(np.asarray(jeng(np.asarray(q))))))
    np.testing.assert_array_equal(eng.dequantize_output(want).numpy(),
                                  np.asarray(jeng.dequantize_output(want)))


@pytest.mark.parametrize("graph", ["avgpool", "fully connected", "softmax"])
def test_graph_from_jax_carries_extended_ops(graph):
    """AVERAGE_POOL_2D's attributes, FULLY_CONNECTED's weight and bias
    tensors (with per-channel qparams) and SOFTMAX's beta come across."""
    jg = {"avgpool": lambda: _pool_graph(jir, *POOLS[3]),
          "fully connected": lambda: _fc_graph(jir, 13, 16, 6, True),
          "softmax": lambda: _softmax_graph(jir)}[graph]()
    g = graph_from_jax(jg)
    assert [(o.opname, o.inputs, o.outputs, o.attrs) for o in g.ops] == \
        [(o.opname, o.inputs, o.outputs, o.attrs) for o in jg.ops]
    for a, b in zip(g.tensors, jg.tensors):
        assert a.shape == tuple(b.shape) and a.dtype == b.dtype
        assert (a.data is None) == (b.data is None)
        if a.data is not None:
            np.testing.assert_array_equal(a.data, b.data)
        assert a.qparams.scales == tuple(b.qparams.scales)
        assert a.qparams.quantized_dimension == b.qparams.quantized_dimension
