"""The port's detection CLI (``python -m yoloface_tpu_torch.detect``)
against the JAX package's (``yoloface_tpu.detect``), both loading
``checkpoints/yoloface_corpus_int8.tflite``, on images written with cv2
into a temporary directory: the 8 golden frames as 112x112 PNGs (faces on
seven) and one of them enlarged to 200x150 (boxes scaled back to the
image).  The image, batch-dir and video modes give equal reports: the
same inputs, names and face counts, boxes and scores within the head's
tolerance (``BOX_ATOL``, times the image's scale for ``box_image``, and
``SCORE_ATOL``), since torch's and XLA's CPU ``exp`` differ by an ulp.
The port runs on the CPU (``--device cpu``: every kernel's plain
version); its default mode ``arena_exact`` has the bits of JAX's default
``exact``.  JAX's mode names map through ``detect.JAX_MODES``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from yoloface_tpu import detect as jdetect
from yoloface_tpu_torch import detect
from yoloface_tpu_torch.pipeline import head as thead
from yoloface_tpu_torch.runtime.engine import MODES

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")


def _rgb(frames):
    p = frames.astype(np.int32)
    return np.stack([(p >> 11) << 3, ((p >> 5) & 63) << 2, (p & 31) << 3],
                    -1).astype(np.uint8)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A directory of the golden frames as PNGs and one enlarged copy."""
    import cv2
    path = tmp_path_factory.mktemp("imgs")
    rgb = _rgb(np.load(GOLDEN)["frames"])
    for i, im in enumerate(rgb):
        cv2.imwrite(str(path / f"frame_{i}.png"),
                    cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    big = cv2.resize(rgb[0], (200, 150), interpolation=cv2.INTER_LINEAR)
    cv2.imwrite(str(path / "wide.png"), cv2.cvtColor(big, cv2.COLOR_RGB2BGR))
    return path


def _run(main, args, tmp_path, tag):
    report = tmp_path / f"{tag}.json"
    assert main([*args, "--report", str(report)]) == 0
    return json.loads(report.read_text())


def _port(args, tmp_path, tag="port"):
    return _run(detect.main, ["--device", "cpu", "--tflite", CORPUS, *args],
                tmp_path, tag)


def _jax(args, tmp_path, tag="jax"):
    return _run(jdetect.main, ["--tflite", CORPUS, *args], tmp_path, tag)


def assert_reports_close(got, want):
    assert (got["inputs"], got["faces"]) == (want["inputs"], want["faces"])
    assert list(got["detections"]) == list(want["detections"])
    for name, recs in want["detections"].items():
        mine = got["detections"][name]
        assert len(mine) == len(recs), name
        for a, b in zip(mine, recs):
            np.testing.assert_allclose(a["box_net"], b["box_net"], rtol=0,
                                       atol=thead.BOX_ATOL)
            scale = max(abs(y) / max(abs(x), 1e-9) for x, y in
                        zip(b["box_net"], b["box_image"]) if x) if any(
                b["box_net"]) else 1.0
            np.testing.assert_allclose(a["box_image"], b["box_image"],
                                       rtol=0,
                                       atol=thead.BOX_ATOL * max(scale, 1))
            assert abs(a["confidence"] - b["confidence"]) <= \
                thead.SCORE_ATOL


@pytest.mark.parametrize("name", ["frame_0.png", "frame_1.png", "wide.png"])
def test_image_mode_equals_jax(images, tmp_path, name, capsys):
    args = ["--image", str(images / name)]
    got = _port(args, tmp_path)
    out = capsys.readouterr().out
    want = _jax(args, tmp_path)
    assert out == capsys.readouterr().out     # the same text report
    assert_reports_close(got, want)
    assert got["inputs"] == 1
    assert (got["faces"] >= 1) == (name != "frame_1.png")


def test_batch_dir_mode_equals_jax(images, tmp_path):
    args = ["--batch-dir", str(images)]
    got, want = _port(args, tmp_path), _jax(args, tmp_path)
    assert_reports_close(got, want)
    assert got["inputs"] == 9 and got["faces"] >= 8


def test_video_mode_equals_jax(images, tmp_path):
    """A short MJPG clip of the golden frames, frame by frame."""
    import cv2
    vid = str(tmp_path / "faces.avi")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"MJPG"), 5, (112, 112))
    for im in _rgb(np.load(GOLDEN)["frames"])[:4]:
        w.write(cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    w.release()
    args = ["--video", vid]
    got, want = _port(args, tmp_path), _jax(args, tmp_path)
    assert_reports_close(got, want)
    assert got["inputs"] == 4 and list(got["detections"]) == [
        f"frame_{i}" for i in range(4)]


@pytest.mark.parametrize("conf,iou", [(0.5, 0.3), (0.9, 0.5)])
def test_thresholds_equal_jax(images, tmp_path, conf, iou):
    args = ["--batch-dir", str(images), "--conf", str(conf), "--iou",
            str(iou)]
    assert_reports_close(_port(args, tmp_path), _jax(args, tmp_path))


def test_retarget_equals_jax(images, tmp_path):
    """``--retarget 2``: the retargeted graph at 112 px, grid 14."""
    args = ["--image", str(images / "wide.png"), "--retarget", "2"]
    assert_reports_close(_port(args, tmp_path), _jax(args, tmp_path))


@pytest.mark.parametrize("jax_mode,port", sorted(detect.JAX_MODES.items()))
def test_jax_mode_names_map(jax_mode, port):
    """Each JAX mode name maps to the port mode of the same bits (README's
    table); the port's own names and the plain modes keep theirs."""
    bits = {"arena": "fast", "arena2": "fast2", "arena_exact": "exact",
            "fused": "fast", "fused_exact": "exact", "perop": "fast",
            "perop_exact": "exact", "tiled": "fast", "tiled2": "fast2",
            "tiled_exact": "exact"}
    jax_bits = ("fast2" if jax_mode.endswith("2") else
                "exact" if jax_mode.endswith("exact") else "fast")
    assert detect.port_mode(jax_mode) == port and port in MODES
    assert bits[port] == jax_bits
    for mode in MODES:
        assert detect.port_mode(mode) == mode


@pytest.mark.parametrize("jax_mode", ["pallas_mxu2", "pallas_exact",
                                      "fast2"])
def test_jax_mode_name_runs_its_port_mode(images, tmp_path, jax_mode):
    """``--mode <JAX name>`` gives the report of the port mode it maps to,
    and that of JAX's XLA mode of the same bits (``fast2`` for
    ``pallas_mxu2``, ``exact`` for ``pallas_exact``: JAX's interpret mode
    of the Pallas kernels takes minutes here)."""
    args = ["--batch-dir", str(images)]
    got = _port([*args, "--mode", jax_mode], tmp_path, "a")
    same = _port([*args, "--mode", detect.port_mode(jax_mode)], tmp_path,
                 "b")
    assert got == same
    xla = "fast2" if jax_mode.endswith("2") else "exact"
    assert_reports_close(got, _jax([*args, "--mode", xla], tmp_path))


def test_save_vis_writes_the_annotated_image(images, tmp_path):
    import cv2
    vis = tmp_path / "vis"
    got = _port(["--image", str(images / "wide.png"), "--save-vis",
                 str(vis)], tmp_path)
    img = cv2.imread(str(vis / "wide.png"))
    assert got["faces"] >= 1 and img is not None and img.shape == (150, 200,
                                                                   3)


def test_an_input_is_required():
    with pytest.raises(SystemExit):
        detect.main(["--device", "cpu"])


def test_default_device_is_the_card(images):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        detect.main(["--image", str(images / "frame_0.png")])


def test_cli_runs_as_a_module(images):
    res = subprocess.run(
        [sys.executable, "-m", "yoloface_tpu_torch.detect", "--device", "cpu",
         "--tflite", CORPUS, "--image", str(images / "frame_0.png")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "frame_0.png: 1 face(s)" in res.stdout
    assert res.stdout.strip().endswith("total: 1 face(s) in 1 input(s)")


_NO_CV2 = """
import sys
sys.modules["cv2"] = None            # as on a machine without OpenCV
import numpy as np
from yoloface_tpu_torch import detect
from yoloface_tpu_torch.pipeline.preprocess import rgb565_to_int8_input
import torch
frames = np.load(sys.argv[1])["frames"]
x = rgb565_to_int8_input(torch.from_numpy(frames)).numpy()
pipe = detect.load(detect.DEFAULT_TFLITE, device="cpu")
rep = detect.summarize(detect.detect_arrays(
    pipe, x, [f"frame_{i}" for i in range(len(x))]))
print("FACES", rep["faces"])
try:
    detect.main(["--device", "cpu", "--image", "x.png"])
except ImportError as e:
    print("IMPORT", e)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "yoloface_tpu")]
assert not bad, bad
"""


def test_run_and_report_need_no_cv2():
    """``detect_arrays`` and ``summarize`` run without cv2 (the golden
    frames' int8 inputs through the default ``arena_exact``: JAX
    ``exact``'s face count); the image modes raise an ImportError that
    names cv2."""
    res = subprocess.run([sys.executable, "-c", _NO_CV2, GOLDEN], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    faces = int(res.stdout.split("FACES ")[1].split()[0])
    assert faces == int(np.load(GOLDEN)["exact_count"].sum())
    assert "IMPORT" in res.stdout and "cv2" in res.stdout.split("IMPORT")[1]
