"""The port's multi-head detection (``pipeline/head.py::detect_multihead``)
against the JAX package's on the CPU.

On the two-headed v3-tiny FPN (``tests/data/v3tiny_fpn_int8.tflite``), with
the head configurations and arguments of ``tests/test_darknet_ptq.py``
(``tools/make_torch_port_golden.FPN_HEADS``, ``FPN_DETECT``), in each of
the three bit semantics: validity and counts exactly, boxes within
``BOX_ATOL`` and scores within ``SCORE_ATOL`` (``pipeline/head.py``: the
last ulps of two ``exp`` implementations).  The heads come from the port's
engine, held bit for bit against JAX's engine of the same bits first; the
kernel modes (their plain versions here) serve the same detections, and
the golden file's keys agree."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.pipeline import head as jhead
from yoloface_tpu.runtime.engine import Int8Engine as JaxEngine
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.pipeline import head as thead
from yoloface_tpu_torch.runtime.engine import KERNEL_MODES, Int8Engine

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _load("make_torch_port_golden",
             os.path.join(REPO, "tools", "make_torch_port_golden.py"))
FPN = TOOL.tflite_path("v3tiny_fpn")
BITS = ("fast2", "fast", "exact")
FRAMES = {   # the golden frames, and test_darknet_ptq.py's three
    "golden": lambda: TOOL.tflite_frames("v3tiny_fpn"),
    "ptq test": lambda: np.random.default_rng(21).integers(
        -128, 128, (3, 32, 32, 3), dtype=np.int64).astype(np.int8)}


@pytest.fixture(scope="module")
def fpn():
    """(the port's FPN graph, JAX's, each head's (scale, zero-point))."""
    g = load_tflite(FPN)
    return g, jax_load_tflite(FPN), [
        (g.tensor(o).qparams.scale, g.tensor(o).qparams.zero_point)
        for o in g.outputs]


def _args(qs, cfg_cls):
    return dict(scales=[s for s, _ in qs], zero_points=[z for _, z in qs],
                **TOOL.FPN_DETECT), [
        cfg_cls(grid=grid, stride=stride, anchors=anchors)
        for grid, stride, anchors in TOOL.FPN_HEADS]


def _close(got, want):
    """Validity and counts exactly; boxes and scores within the head's
    stated tolerance."""
    boxes, scores, valid = (t.numpy() for t in got)
    jboxes, jscores, jvalid = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(valid.sum(1), jvalid.sum(1))
    np.testing.assert_allclose(boxes, jboxes, rtol=0, atol=thead.BOX_ATOL)
    np.testing.assert_allclose(scores, jscores, rtol=0,
                               atol=thead.SCORE_ATOL)
    assert boxes.dtype == np.float32 and valid.dtype == bool


@pytest.mark.parametrize("frames", sorted(FRAMES))
@pytest.mark.parametrize("bits", BITS)
def test_detect_multihead_equals_jax(fpn, bits, frames):
    g, jg, qs = fpn
    x = FRAMES[frames]()
    heads = Int8Engine(g, bits, device="cpu")(x)
    jheads = JaxEngine(jg, bits)(x)
    for y, jy in zip(heads, jheads):
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    kw, cfgs = _args(qs, thead.HeadConfig)
    jkw, jcfgs = _args(qs, jhead.HeadConfig)
    got = thead.detect_multihead(heads, cfgs, **kw)
    want = jhead.detect_multihead(jheads, jcfgs, **jkw)
    _close(got, want)
    # candidates pooled across heads: 4*4*3 + 8*8*3 = 240 cells ranked
    assert got[1].shape == (len(x), 16) and got[2].any()


@pytest.mark.parametrize("conf,max_det", [(0.4, 8), (0.7, 16), (0.5, 40)])
def test_detect_multihead_arguments_equal_jax(fpn, conf, max_det):
    """Other thresholds and capacities give JAX's detections."""
    g, jg, qs = fpn
    x = FRAMES["ptq test"]()
    heads = [y.numpy() for y in Int8Engine(g, "exact", device="cpu")(x)]
    kw, cfgs = _args(qs, thead.HeadConfig)
    jkw, jcfgs = _args(qs, jhead.HeadConfig)
    for d in (kw, jkw):
        d.update(conf_threshold=conf, max_detections=max_det,
                 iou_threshold=0.3)
    _close(thead.detect_multihead(heads, cfgs, **kw),
           jhead.detect_multihead(heads, jcfgs, **jkw))


@pytest.mark.parametrize("mode", ["arena2", "arena_exact", "perop",
                                  "perop_exact", "fused", "tiled2"])
def test_kernel_modes_serve_the_golden_detections(fpn, mode):
    """The FPN through a kernel mode (its plain version on the CPU), then
    ``detect_multihead``, gives the golden file's JAX detections of the
    mode's bits."""
    g, _, qs = fpn
    gold = np.load(GOLDEN)
    bits = KERNEL_MODES[mode]
    heads = Int8Engine(g, mode, device="cpu")(
        torch.from_numpy(TOOL.tflite_frames("v3tiny_fpn")))
    kw, cfgs = _args(qs, thead.HeadConfig)
    got = thead.detect_multihead(heads, cfgs, **kw)
    _close(got, [gold[TOOL.multihead_key(bits, part)]
                 for part in TOOL.MULTIHEAD_PARTS])


def test_golden_multihead_keys_equal_recomputed_jax_side():
    gold = np.load(GOLDEN)
    want = TOOL.jax_outputs_multihead()
    assert sorted(want) == sorted(TOOL.KEYS_MULTIHEAD)
    for k, v in want.items():
        np.testing.assert_array_equal(v, gold[k], err_msg=k)
