"""The port's TensorFlow converter chain against the JAX package (CPU).

The corpus weights (``variables_from_template``) go through the port's
chain (``quantize/tf_convert.checkpoint_to_int8_tflite``: Keras h5, frozen
pb, the TFLite converter with the reference's settings) and through
JAX's, composed from its parts, with the same seeded representative set
(``tools/make_torch_port_golden.converted_rep``).  The two .tflite files
are equal byte for byte, so op for op, weight for weight and qparam for
qparam, and equal to the graph committed as
``tests/data/yoloface_converted_int8.tflite``.  On that graph the port's
``exact`` equals TFLite's ``BUILTIN_REF`` kernels, every base mode equals
JAX's engine of its bits (the golden keys, recomputed here), and every
kernel mode's plain path equals its base engine, bit for bit."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from yoloface_tpu.io import keras_export as jke  # noqa: E402
from yoloface_tpu.io.tflite_import import load_tflite as jload  # noqa: E402
from yoloface_tpu.quantize import tf_convert as jtc  # noqa: E402
from yoloface_tpu.runtime.engine import Int8Engine as JEngine  # noqa: E402
from yoloface_tpu_torch.graph.retarget import retarget_spatial  # noqa: E402
from yoloface_tpu_torch.io.tflite_import import load_tflite  # noqa: E402
from yoloface_tpu_torch.models.import_weights import (  # noqa: E402
    variables_from_template)
from yoloface_tpu_torch.quantize import tf_convert as tc  # noqa: E402
from yoloface_tpu_torch.runtime.engine import (  # noqa: E402
    KERNEL_MODES, Int8Engine)

from test_torch_calibrate import _assert_graphs_equal  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")
# tests/test_tf_convert.py:35-38
JAX_OPS = {"ADD", "CONCATENATION", "CONV_2D", "DEPTHWISE_CONV_2D",
           "LEAKY_RELU", "MAX_POOL_2D", "PAD"}


def _golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _golden_tool()


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(the port chain's .tflite path, JAX's) from the same weights and
    representative set."""
    d = str(tmp_path_factory.mktemp("tfconv"))
    v = variables_from_template(load_tflite(CORPUS))
    rep = TOOL.converted_rep()
    ours = tc.checkpoint_to_int8_tflite(
        v, os.path.join(d, "port.tflite"), d,
        rep_dataset=tc.rep_dataset_from_arrays(rep))
    jd = os.path.join(d, "jax")
    os.makedirs(jd)
    jke.export_h5(v["params"], v["batch_stats"], os.path.join(jd, "y.h5"))
    jke.h5_to_frozen_pb(os.path.join(jd, "y.h5"), os.path.join(jd, "m.pb"))
    theirs = os.path.join(jd, "jax.tflite")
    with open(theirs, "wb") as f:
        f.write(jtc.quantize_frozen_pb(
            os.path.join(jd, "m.pb"),
            rep_dataset=tc.rep_dataset_from_arrays(rep)))
    return ours, theirs


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_chain_equals_jax_and_the_committed_graph(converted):
    ours, theirs = converted
    assert _bytes(ours) == _bytes(theirs)
    _assert_graphs_equal(load_tflite(ours), load_tflite(theirs))
    assert _bytes(ours) == _bytes(TOOL.CONVERTED)


def test_op_set_and_concat_qparams():
    g = load_tflite(TOOL.CONVERTED)
    assert {op.opname for op in g.ops} == JAX_OPS
    assert len(g.ops) == 51
    assert g.tensor(g.inputs[0]).dtype == np.dtype(np.int8)
    cats = [op for op in g.ops if op.opname == "CONCATENATION"]
    assert len(cats) == 2
    for op in cats:
        q = g.tensor(op.outputs[0]).qparams
        for i in op.inputs:
            assert g.tensor(i).qparams == q


def test_exact_equals_builtin_ref():
    x = np.random.default_rng(1).integers(
        -128, 128, (2, 56, 56, 3), dtype=np.int64).astype(np.int8)
    y = Int8Engine(load_tflite(TOOL.CONVERTED), "exact", device="cpu")(
        x).numpy()
    it = tf.lite.Interpreter(
        model_path=TOOL.CONVERTED,
        experimental_op_resolver_type=(
            tf.lite.experimental.OpResolverType.BUILTIN_REF))
    it.allocate_tensors()
    for i in range(2):
        it.set_tensor(it.get_input_details()[0]["index"], x[i:i + 1])
        it.invoke()
        np.testing.assert_array_equal(
            y[i:i + 1], it.get_tensor(it.get_output_details()[0]["index"]))


@pytest.mark.parametrize("bits", ["fast2", "fast", "exact"])
def test_base_modes_equal_jax_and_golden(bits):
    x = TOOL.converted_frames()
    gold = np.load(GOLDEN)
    assert str(gold["converted_frames_sha256"]) == TOOL.sha256(x)
    want = np.asarray(JEngine(jload(TOOL.CONVERTED), bits)(x))
    np.testing.assert_array_equal(gold[f"converted_{bits}"], want)
    got = Int8Engine(load_tflite(TOOL.CONVERTED), bits, device="cpu")(x)
    np.testing.assert_array_equal(got.numpy(), want)


BASE = {"arena2": "fast2", "arena": "fast", "arena_exact": "exact",
        "tiled2": "fast2", "tiled": "fast", "tiled_exact": "exact",
        "fused": "fast", "fused_exact": "exact", "perop": "fast",
        "perop_exact": "exact"}


@pytest.mark.parametrize("mode", sorted(KERNEL_MODES))
def test_kernel_modes_plain_equal_base(mode):
    x = TOOL.converted_frames()
    g = load_tflite(TOOL.CONVERTED)
    got = Int8Engine(g, mode, device="cpu")(x)
    want = Int8Engine(g, BASE[mode], device="cpu")(x)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.load(GOLDEN)[f"converted_{BASE[mode]}"])


def test_448_retarget_against_golden():
    """The converted graph's 448 retarget in the base modes against the
    golden JAX outputs (what the card's tiled2 / tiled_exact are held
    to)."""
    g = retarget_spatial(load_tflite(TOOL.CONVERTED), 8)
    x = TOOL.frames448()[:1]
    gold = np.load(GOLDEN)
    for bits in ("fast2", "exact"):
        got = Int8Engine(g, bits, device="cpu")(x)
        np.testing.assert_array_equal(got.numpy(),
                                      gold[f"converted448_{bits}"][:1])


def test_rep_dataset_from_dir_equals_jax(tmp_path):
    import cv2
    rng = np.random.default_rng(4)
    for k in range(3):
        cv2.imwrite(str(tmp_path / f"im{k}.png"),
                    rng.integers(0, 256, (70, 90, 3), dtype=np.uint8))
    (tmp_path / "notes.txt").write_text("not an image")
    ours = list(tc.rep_dataset_from_dir(str(tmp_path))())
    theirs = list(jtc.rep_dataset_from_dir(str(tmp_path))())
    assert len(ours) == len(theirs) == 3
    for (a,), (b,) in zip(ours, theirs):
        assert a.shape == (1, 56, 56, 3) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    arr = list(tc.rep_dataset_from_arrays(np.stack(
        [a[0] for (a,) in ours]))())
    for (a,), (b,) in zip(arr, ours):
        np.testing.assert_array_equal(a, b)


def test_quantize_needs_a_representative_set(tmp_path):
    with pytest.raises(ValueError, match="rep_dataset or rep_dir"):
        tc.quantize_frozen_pb(str(tmp_path / "missing.pb"))


def test_without_tensorflow_raises_naming_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="TensorFlow"):
        tc.quantize_frozen_pb(str(tmp_path / "m.pb"), rep_dir=str(tmp_path))
