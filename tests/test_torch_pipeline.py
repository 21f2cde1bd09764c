"""The port's serving pipeline (CPU: every kernel's plain version) against
the JAX one on RGB565 frames: ``arena2`` against
``FacePipeline(Int8Engine(g, "fast2"))`` with the staged head, and
``arena_exact`` against ``FacePipeline(Int8Engine(g, "exact"))`` with the
fused head and with the staged head ranked by the top-K kernel (Pallas in
interpret mode on the JAX side); the golden file of the card check; and
chip_smoke.py's refusal to run without a card.

Tolerance: the int8 head tensor, validity and counts are exact; boxes
within ``BOX_ATOL`` and scores within ``SCORE_ATOL`` (pipeline/head.py),
because torch's and XLA's CPU ``exp`` differ by one ulp on some inputs."""

import hashlib
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
from yoloface_tpu_torch.pipeline.e2e import FacePipeline, load_pipeline

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")
# sha256 of the fast2 arrays as the golden file first shipped them; later
# keys are added beside them, never by rewriting these
FAST2_DIGESTS = {
    "frames": "4ba1c2fb9d6e1c20619ca3dfdb58870f934873bed8a3bed6b13ba4b2521b7d35",
    "head": "2ffbe0058c11f5cf7c5c1ba7e2543f835f30c950c3e63b297d4af918fa5be302",
    "boxes": "dd4b99c645a292dc7606da4977fca76a15f83a3a69fa9e1406dcd484f897dc08",
    "scores": "787e14e3395dfa1beb150edf8197cad06a94090f35364babcdb56d962df775dd",
    "valid": "bb8a3673cbc05806bda2255c007a9e8e5706e4931f415204d1c71ff6edf9f492",
    "count": "3d4eb0cc14057ebaa5552aa709b9f6109f5dcfd570d93bfdd73d65e5973168f9",
}
EXACT_KEYS = ("head_exact", "exact_boxes", "exact_scores", "exact_valid",
              "exact_count")
# the 448 family's keys; tests/test_torch_tiled.py pins and recomputes them
KEYS448 = ("head448", "head448_exact", "frames448_sha256")
# the fused family's op-surface keys; tests/test_torch_fused.py recomputes them
KEYS_SURFACE = ("surface_fast0", "surface_fast1", "surface_exact0",
                "surface_exact1", "surface_frames_sha256")


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
    assert sorted(want) == sorted(k for k in gold if k not in
                                  ("frames",) + KEYS448 + KEYS_SURFACE
                                  + tool.KEYS_SURFACE_FAST2
                                  + tool.KEYS_TFLITE)
    for k, v in want.items():
        np.testing.assert_array_equal(v, gold[k], err_msg=k)
    assert gold["count"].sum() >= 7       # faces on seven of the frames


def test_golden_fast2_keys_unchanged():
    gold = np.load(GOLDEN)
    tool = _golden_tool()
    assert sorted(gold.files) == sorted([*FAST2_DIGESTS, *EXACT_KEYS,
                                         "head_fast", *KEYS448,
                                         *KEYS_SURFACE,
                                         *tool.KEYS_SURFACE_FAST2,
                                         *tool.KEYS_TFLITE])
    for k, digest in FAST2_DIGESTS.items():
        assert hashlib.sha256(gold[k].tobytes()).hexdigest() == digest, k


@pytest.fixture(scope="module")
def exact_frames():
    """The golden frames (faces on seven) and three random ones."""
    rng = np.random.default_rng(44)
    extra = rng.integers(0, 1 << 16, (3, 112, 112), dtype=np.int64)
    return np.concatenate([np.load(GOLDEN)["frames"],
                           extra.astype(np.uint16)])


@pytest.fixture(scope="module")
def exact_engine():
    return load_pipeline(CORPUS, mode="arena_exact", device="cpu").engine


@pytest.mark.parametrize("fused", [True, False])
def test_rgb565_arena_exact_equals_jax_exact(exact_frames, exact_engine,
                                             fused):
    jcfg = JaxHeadConfig(use_fused_head=fused)
    jpipe = JaxPipeline(JaxEngine(jax_load_tflite(CORPUS), "exact"), jcfg)
    exact_pipe = FacePipeline(exact_engine,
                              thead.HeadConfig(use_fused_head=fused))
    want = {k: np.asarray(v) for k, v in
            jpipe.detect_rgb565(exact_frames).items()}
    got = exact_pipe.detect_rgb565(exact_frames)
    assert_detections_close(got, want)
    assert got["count"].sum() >= 6
    head = exact_pipe.engine(exact_pipe.preprocess(exact_frames))
    np.testing.assert_array_equal(
        head.numpy(),
        np.asarray(jpipe.engine(jpre.rgb565_to_int8_input(exact_frames))))


def test_arena_exact_on_golden_frames(exact_engine):
    gold = dict(np.load(GOLDEN))
    exact_pipe = FacePipeline(exact_engine,
                              thead.HeadConfig(use_fused_head=False))
    head = exact_pipe.engine(exact_pipe.preprocess(gold["frames"]))
    np.testing.assert_array_equal(head.numpy(), gold["head_exact"])
    got = exact_pipe.detect_rgb565(gold["frames"])
    assert_detections_close(got, {k: gold["exact_" + k] for k in
                                  ("boxes", "scores", "valid", "count")})


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
