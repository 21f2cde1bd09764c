"""The port's ONNX exporter and evaluator against the JAX package (CPU).

``io/onnx_export.py`` is a copy: for the same graph and weights it writes
JAX's bytes, and ``parse_model`` reads them back to the same structure;
a graph with an op the exporter does not emit (the op-surface graph's
RELU6 and RESIZE, the v3-tiny FPN's RESIZE) is refused by both with the
same error.  ``io/onnx_eval.py`` runs the model in torch: against JAX's
evaluator on the same bytes and inputs within ``rtol = atol =
EVAL_TOL`` (float32 convolutions summed in another order; measured: at
most 1.7e-5 on outputs up to 6.4 in magnitude), against
the port's ``float_forward`` within JAX's own ``1e-4``
(tests/test_onnx_export.py) with equal decoded detections."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from yoloface_tpu.io import onnx_eval as jeval
from yoloface_tpu.io import onnx_export as jexport
from yoloface_tpu_torch.io import onnx_eval, onnx_export
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.models.import_weights import (
    dequantize_template_weights)
from yoloface_tpu_torch.quantize.calibrate import float_forward

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
SHIPPED = os.path.join(REPO, "checkpoints", "yoloface_corpus.onnx")
FPN = os.path.join(REPO, "tests", "data", "v3tiny_fpn_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")
EVAL_TOL = 1e-5          # the port's evaluator against JAX's, rtol = atol
FLOAT_TOL = 1e-4         # against float_forward (JAX's test's bound)


def _golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _golden_tool()


def onnx_surface_graph():
    """Every op the exporter emits, in the port's IR (numpy seed 3): an
    absorbed top-left PAD into a 3x3 stride-2 VALID conv, LEAKY, a SAME
    depthwise 3x3 stride 2, a 1x1 conv read by RELU and LOGISTIC, their
    ADD, a QUANTIZE (Identity), a SAME 3x3 average pool (the edge windows
    count their taps), a SAME 3x3 stride-2 max-pool, a concat and a 1x1
    head: int8 [N,15,15,3] -> [N,4,4,6]."""
    b = TOOL.GraphMaker(3)
    act, op = b.act, b.op
    x = act(15, 3, 0.05, -3)
    p0 = b.pad(x, [[0, 0], [1, 0], [1, 0], [0, 0]], act(16, 3, 0.05, -3))
    c0 = b.conv(p0, 8, (3, 3), 2, "VALID", act(7, 8, 0.09, 6))
    l0 = op("LEAKY_RELU", [c0], act(7, 8, 0.07, -20), alpha=0.1)
    d0 = b.conv(l0, 8, (3, 3), 2, "SAME", act(4, 8, 0.06, 2), depthwise=True)
    c1 = b.conv(d0, 8, (1, 1), 1, "SAME", act(4, 8, 0.08, -5))
    r0 = op("RELU", [c1], act(4, 8, 0.08, -5))
    s0 = op("LOGISTIC", [c1], act(4, 8, 1.0 / 256.0, -128))
    a0 = op("ADD", [r0, s0], act(4, 8, 0.09, 4))
    q0 = op("QUANTIZE", [a0], act(4, 8, 0.11, -30))
    ap = op("AVERAGE_POOL_2D", [q0], act(4, 8, 0.11, -30), padding="SAME",
            stride_h=1, stride_w=1, filter_h=3, filter_w=3,
            activation="NONE")
    mp = op("MAX_POOL_2D", [l0], act(4, 8, 0.07, -20), padding="SAME",
            stride_h=2, stride_w=2, filter_h=3, filter_w=3,
            activation="NONE")
    cat = op("CONCATENATION", [ap, mp], act(4, 16, 0.11, -30), axis=3,
             activation="NONE")
    out = b.conv(cat, 6, (1, 1), 1, "SAME", act(4, 6, 0.1, 0))
    return b.graph([x], [out], "onnx_surface")


def _both(g):
    """(the port's bytes, JAX's bytes) of the graph's dequantized
    weights."""
    w = dequantize_template_weights(g)
    return (onnx_export.export_onnx(g, w),
            jexport.export_onnx(TOOL.jax_graph(g), w), w)


@pytest.fixture(scope="module")
def corpus():
    g = load_tflite(CORPUS)
    ours, theirs, w = _both(g)
    return g, ours, theirs, w


def _eval_inputs(seed, n, c, hw):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, c, hw, hw)).astype(np.float32)


def test_corpus_bytes_equal_jax(corpus):
    g, ours, theirs, _ = corpus
    assert ours == theirs
    m, jm = onnx_export.parse_model(ours), jexport.parse_model(theirs)
    assert [n["op_type"] for n in m["nodes"]] == \
        [n["op_type"] for n in jm["nodes"]]
    assert m["inputs"] == jm["inputs"] and m["outputs"] == jm["outputs"]
    assert (m["ir_version"], m["opset"]) == (8, 13)
    for name, (dims, data) in jm["initializers"].items():
        assert m["initializers"][name][0] == dims
        np.testing.assert_array_equal(m["initializers"][name][1], data)
    for n, jn in zip(m["nodes"], jm["nodes"]):
        assert (n["inputs"], n["outputs"], n["name"]) == \
            (jn["inputs"], jn["outputs"], jn["name"])
        assert n["attrs"] == jn["attrs"]


def test_weights_as_tensors_write_the_same_bytes(corpus):
    g, ours, _, w = corpus
    tw = {k: tuple(torch.from_numpy(a) for a in v) for k, v in w.items()}
    assert onnx_export.export_onnx(g, tw) == ours


def test_surface_bytes_equal_jax():
    ours, theirs, _ = _both(onnx_surface_graph())
    assert ours == theirs
    ops = [n["op_type"] for n in onnx_export.parse_model(ours)["nodes"]]
    assert set(ops) == {"Conv", "LeakyRelu", "Relu", "Sigmoid", "Add",
                        "Identity", "AveragePool", "MaxPool", "Concat"}


@pytest.mark.parametrize("name", ["op_surface", "v3tiny_fpn"])
def test_unexported_ops_refused_as_jax_does(name):
    g = (TOOL.surface_graph() if name == "op_surface" else load_tflite(FPN))
    w = dequantize_template_weights(g)
    with pytest.raises(NotImplementedError) as ours:
        onnx_export.export_onnx(g, w)
    with pytest.raises(NotImplementedError) as theirs:
        jexport.export_onnx(TOOL.jax_graph(g), w)
    assert str(ours.value) == str(theirs.value)


def test_parse_model_reads_the_shipped_onnx_as_jax():
    with open(SHIPPED, "rb") as f:
        buf = f.read()
    m, jm = onnx_export.parse_model(buf), jexport.parse_model(buf)
    assert [(n["op_type"], n["inputs"], n["outputs"], n["attrs"])
            for n in m["nodes"]] == [(n["op_type"], n["inputs"],
                                      n["outputs"], n["attrs"])
                                     for n in jm["nodes"]]
    assert sorted(m["initializers"]) == sorted(jm["initializers"])


@pytest.mark.parametrize("which", ["corpus", "surface", "shipped"])
def test_evaluator_equals_jax(corpus, which):
    if which == "corpus":
        buf = corpus[1]
    elif which == "surface":
        buf = _both(onnx_surface_graph())[0]
    else:
        with open(SHIPPED, "rb") as f:
            buf = f.read()
    hw = 15 if which == "surface" else 56
    x = _eval_inputs(5, 4, 3, hw)
    got = onnx_eval.OnnxEvaluator(buf, device="cpu")(x)
    want = np.asarray(jeval.OnnxEvaluator(buf)(x))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=EVAL_TOL, atol=EVAL_TOL)


def test_shipped_onnx_against_golden():
    """The shipped .onnx on the golden file's inputs against JAX's
    evaluator output stored there (what the card checks without jax)."""
    with open(SHIPPED, "rb") as f:
        got = onnx_eval.OnnxEvaluator(f.read(), device="cpu")(
            TOOL.onnx_inputs())
    want = np.load(GOLDEN)["onnx_corpus_eval"]
    np.testing.assert_allclose(got, want, rtol=EVAL_TOL, atol=EVAL_TOL)


def _float_decode(head_nhwc, conf_threshold=0.7):
    """tests/test_onnx_export.py's float decode (the reference's
    tflite_prediction.py:46-57) in numpy."""
    anchors = np.array([[9.0, 14.0], [12.0, 17.0], [22.0, 21.0]])
    t = head_nhwc.reshape(-1, 7, 7, 3, 6).transpose(0, 3, 1, 2, 4)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    rows = np.arange(7.0).reshape(1, 1, 7, 1)
    cols = np.arange(7.0).reshape(1, 1, 1, 7)
    cx = (sig(t[..., 0]) + cols) * 8.0
    cy = (sig(t[..., 1]) + rows) * 8.0
    w = np.exp(t[..., 2]) * anchors[:, 0].reshape(1, 3, 1, 1)
    h = np.exp(t[..., 3]) * anchors[:, 1].reshape(1, 3, 1, 1)
    conf = sig(t[..., 4])
    keep = conf >= conf_threshold
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return [(np.argwhere(keep[i]), boxes[i][keep[i]], conf[i][keep[i]])
            for i in range(head_nhwc.shape[0])]


def test_evaluator_matches_float_forward(corpus):
    """The exported corpus model, run by the evaluator, against the port's
    float executor on the same weights: the head within 1e-4 and the same
    decoded detections (tests/test_onnx_export.py's check) on the golden
    frames' 56x56 inputs (faces, so detections exist)."""
    from yoloface_tpu_torch.pipeline.preprocess import rgb565_to_int8_input
    g, buf, _, w = corpus
    x8 = rgb565_to_int8_input(torch.from_numpy(np.load(GOLDEN)["frames"]))
    x = (x8.numpy().astype(np.float32) + 128.0) / 255.0
    got = onnx_eval.OnnxEvaluator(buf, device="cpu")(
        x.transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1)
    want = float_forward(g, w, x, device="cpu")[g.outputs[0]].numpy()
    np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    dets = 0
    for (gi, gb, gc), (wi, wb, wc) in zip(_float_decode(got),
                                          _float_decode(want)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gb, wb, atol=0.05)
        np.testing.assert_allclose(gc, wc, atol=1e-3)
        dets += len(gi)
    assert dets > 0


def test_average_pool_counts_valid_taps():
    """count_include_pad=0: an all-ones input averages to exactly 1 at the
    edges too; with count_include_pad=1 the corners see 4 of 9 taps."""
    x = torch.ones((1, 2, 5, 5))
    pads = (1, 1, 1, 1)
    valid = onnx_eval._pool(x, "AveragePool", (3, 3), (1, 1), pads, 0)
    assert torch.equal(valid, torch.ones_like(valid))
    full = onnx_eval._pool(x, "AveragePool", (3, 3), (1, 1), pads, 1)
    assert float(full[0, 0, 0, 0]) == pytest.approx(4 / 9)
    mx = onnx_eval._pool(-x, "MaxPool", (3, 3), (2, 2), pads)
    assert torch.equal(mx, -torch.ones((1, 2, 3, 3)))


def test_unknown_op_raises():
    m = {"inputs": ["x"], "outputs": ["y"], "nodes": [
        {"op_type": "Gemm", "inputs": ["x"], "outputs": ["y"],
         "attrs": {}}]}
    with pytest.raises(NotImplementedError, match="Gemm"):
        onnx_eval._run(m, {}, torch.zeros(1))


def test_evaluator_defaults_to_the_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        onnx_eval.OnnxEvaluator(corpus[1])


def test_evaluator_keeps_the_callers_tf32_flags(corpus):
    cudnn = torch.backends.cudnn.allow_tf32
    onnx_eval.OnnxEvaluator(corpus[1], device="cpu").evaluate(
        _eval_inputs(1, 1, 3, 56))
    assert torch.backends.cudnn.allow_tf32 == cudnn


def test_new_modules_import_without_tensorflow_or_cv2():
    """The interchange and multi-device modules import where TensorFlow
    and cv2 are absent (the card's machine): both blocked, every module
    imports, and neither is loaded."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "sys.modules['tensorflow'] = None\n"
        "sys.modules['cv2'] = None\n"
        "import importlib\n"
        "for m in ('io.onnx_export', 'io.onnx_eval', 'io.keras_export',\n"
        "          'quantize.tf_convert', 'parallel.mesh',\n"
        "          'parallel.spatial', 'parallel.dryrun',\n"
        "          'parallel.dcn_smoke', 'train.trainer'):\n"
        "    importlib.import_module('yoloface_tpu_torch.' + m)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
