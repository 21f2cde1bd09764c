"""The port's serving pipeline (``arena2``, CPU: every kernel's plain
version) against JAX ``FacePipeline(Int8Engine(g, "fast2"))`` with the
staged head, on RGB565 frames; the golden file of the card check; and
chip_smoke.py's refusal to run without a card.

Tolerance: the int8 head tensor, validity and counts are exact; boxes
within ``BOX_ATOL`` and scores within ``SCORE_ATOL`` (pipeline/head.py),
because torch's and XLA's CPU ``exp`` differ by one ulp on some inputs."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.pipeline import preprocess as jpre
from yoloface_tpu.pipeline.e2e import FacePipeline as JaxPipeline
from yoloface_tpu.pipeline.head import HeadConfig as JaxHeadConfig
from yoloface_tpu.runtime.engine import Int8Engine as JaxEngine
from yoloface_tpu_torch.pipeline import head as thead
from yoloface_tpu_torch.pipeline.e2e import load_pipeline

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")


@pytest.fixture(scope="module")
def jax_pipe():
    eng = JaxEngine(jax_load_tflite(CORPUS), "fast2")
    return JaxPipeline(eng, JaxHeadConfig(use_fused_head=False,
                                          use_pallas_topk=False))


@pytest.fixture(scope="module")
def port_pipe():
    return load_pipeline(CORPUS, mode="arena2", device="cpu")


def assert_detections_close(got, want):
    for k in ("valid", "count"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0,
                               atol=thead.BOX_ATOL)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=thead.SCORE_ATOL)


@pytest.mark.parametrize("n", [1, 7])
def test_rgb565_pipeline_equals_jax(jax_pipe, port_pipe, n):
    rng = np.random.default_rng(40 + n)
    frames = rng.integers(0, 1 << 16, (n, 112, 112),
                          dtype=np.int64).astype(np.uint16)
    got = port_pipe.detect_rgb565(frames)
    assert got["boxes"].shape == (n, 16, 4) and got["count"].shape == (n,)
    assert_detections_close(got, jax_pipe.detect_rgb565(frames))
    head = port_pipe.engine(port_pipe.preprocess(frames))
    np.testing.assert_array_equal(
        head.numpy(),
        np.asarray(jax_pipe.engine(jpre.rgb565_to_int8_input(frames))))


def _golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_golden_file_equals_recomputed_jax_side():
    gold = dict(np.load(GOLDEN))
    tool = _golden_tool()
    np.testing.assert_array_equal(tool.golden_frames(), gold["frames"])
    want = tool.jax_outputs(gold["frames"])
    assert sorted(want) == sorted(k for k in gold if k != "frames")
    for k, v in want.items():
        np.testing.assert_array_equal(v, gold[k], err_msg=k)
    assert gold["count"].sum() >= 7       # faces on seven of the frames


def test_port_on_golden_frames(port_pipe):
    gold = dict(np.load(GOLDEN))
    head = port_pipe.engine(port_pipe.preprocess(gold["frames"]))
    np.testing.assert_array_equal(head.numpy(), gold["head"])
    assert_detections_close(port_pipe.detect_rgb565(gold["frames"]), gold)


def test_chip_smoke_refuses_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
