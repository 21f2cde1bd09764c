"""The port's host side (``yoloface_tpu_torch/host/``) against the JAX
package's: the protocol encoder and parser, the camera streamers (the
port's ``arena2`` on the CPU against the JAX streamer around
``Int8Engine(g, "fast2")`` with the staged head, the twin that
tests/test_torch_pipeline.py holds ``arena2`` against, on the same
source), the multi-camera streamer, the monitor (from text, a file, a
socket and its live sources) and the GUI's pure functions and headless
fallback.

The protocol text prints each box coordinate truncated to an integer and
each score to two places.  The head's boxes and scores are held to
``BOX_ATOL``/``SCORE_ATOL`` against JAX (torch's and XLA's CPU ``exp``
differ by an ulp), so a line whose JAX box coordinate or score lies
within that tolerance of a rounding edge may differ by one unit there:
``streamer.protocol_diff`` allows exactly that and counts such lines.  The JAX
streamers run with ``use_native=False``: JAX's native module runs
``make -C native``, which rewrites the tracked library."""

import dataclasses
import io
import json
import os
import re
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from yoloface_tpu.host import gui as jgui
from yoloface_tpu.host import monitor as jmonitor
from yoloface_tpu.host import protocol as jprotocol
from yoloface_tpu.host import streamer as jstreamer
from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.pipeline.e2e import FacePipeline as JaxPipeline
from yoloface_tpu.pipeline.head import HeadConfig as JaxHeadConfig
from yoloface_tpu.runtime.engine import Int8Engine as JaxEngine
from yoloface_tpu_torch.host import gui, monitor, native, protocol, streamer
from yoloface_tpu_torch.pipeline.e2e import load_pipeline
from yoloface_tpu_torch.runtime import profiler

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def port_pipe():
    return load_pipeline(CORPUS, mode="arena2", device="cpu")


@pytest.fixture(scope="module")
def jax_pipe():
    return JaxPipeline(JaxEngine(jax_load_tflite(CORPUS), "fast2"),
                       JaxHeadConfig(use_fused_head=False,
                                     use_pallas_topk=False))


def frames_text(texts, det, first: int = 0) -> int:
    """``streamer.protocol_diff`` over frames: ``texts`` (port, JAX)
    pairs, ``det`` JAX's detections of frames ``first``.. -> the edge
    lines."""
    return sum(streamer.protocol_diff(g, w, det["boxes"][i],
                                      det["scores"][i], det["valid"][i])
               for i, (g, w) in enumerate(texts, first))


# --------------------------------------------------------------------------
# protocol
# --------------------------------------------------------------------------
def test_protocol_module_is_the_jax_package_s():
    """The encoder and parser are a copy of the JAX module, byte for byte,
    so the wire format cannot drift."""
    with open(protocol.__file__, "rb") as a, open(jprotocol.__file__,
                                                  "rb") as b:
        assert a.read() == b.read()


def test_encode_matches_firmware_format():
    text = protocol.encode_frame(7, np.array([[10.0, 12.0, 30.0, 40.0]]),
                                 np.array([0.93]), np.array([True]))
    assert text == (
        "=== Frame 7 ===\r\n" + "-" * 40 + "\r\n"
        + "[Face 1] BBox: [20, 24, 60, 80], Conf: 0.93\r\n"
        + "-" * 40 + "\r\n" + "[INFO] Total faces detected: 1\r\n")


def test_encode_frame_equals_jax_on_seeded_detections():
    rng = np.random.default_rng(7)
    for n in range(1, 31):
        k = int(rng.integers(0, 17))
        boxes = rng.uniform(-2, 58, (k, 4)).astype(np.float32)
        scores = rng.uniform(0, 1, k).astype(np.float32)
        valid = rng.random(k) < 0.5
        for scale in (1, 2):
            assert protocol.encode_frame(n, boxes, scores, valid, scale) \
                == jprotocol.encode_frame(n, boxes, scores, valid, scale)


def test_roundtrip_encode_parse():
    boxes = np.array([[5.0, 6.0, 20.0, 25.0], [30.0, 30.0, 50.0, 52.0],
                      [0.0, 0.0, 0.0, 0.0]])
    valid = np.array([True, True, False])
    text = protocol.encode_frame(3, boxes, np.array([0.88, 0.71, 0.0]),
                                 valid)
    frame = protocol.parse_frame(text.split("\r\n"))
    assert (frame.number, frame.total, len(frame.faces)) == (3, 2, 2)
    assert frame.faces[0].x1 == 10 and frame.faces[0].confidence == 0.88
    assert frame.faces[1].width == 40
    assert dataclasses.asdict(frame) == dataclasses.asdict(
        jprotocol.parse_frame(text.split("\r\n")))


@pytest.mark.parametrize("chunk", [1, 7, 17, 4096])
def test_stream_parser_partial_chunks(chunk):
    """Arbitrary chunk boundaries and noise lines give the frames JAX's
    parser gives."""
    boxes = np.array([[5.0, 6.0, 20.0, 25.0], [1.0, 2.0, 9.0, 9.5]])
    text = "".join("noise line\r\n" + protocol.encode_frame(
        i + 1, boxes, np.array([0.9, 0.55]), np.array([True, i % 2 == 0]))
        for i in range(4))
    ours, theirs = protocol.StreamParser(), jprotocol.StreamParser()
    a, b = [], []
    for i in range(0, len(text), chunk):
        a.extend(ours.feed(text[i:i + chunk]))
        b.extend(theirs.feed(text[i:i + chunk]))
    assert [f.number for f in a] == [1, 2, 3, 4]
    assert [f.total for f in a] == [2, 1, 2, 1]
    assert [(f.number, f.total, [vars(x) for x in f.faces]) for f in a] == \
        [(f.number, f.total, [vars(x) for x in f.faces]) for f in b]


def test_protocol_diff_allows_only_a_rounding_edge():
    """A box coordinate or score one unit off passes only where the
    reference value lies within the head's tolerance of the edge."""
    valid = np.array([True])
    want = protocol.encode_frame(1, np.array([[10.0, 12.0, 30.0, 40.0]]),
                                 np.array([0.925]), valid)
    near = np.array([[10.0, 12.0 - 1e-5, 30.0, 40.0]], np.float32)
    off = protocol.encode_frame(1, np.array([[10.0, 11.0, 30.0, 40.0]]),
                                np.array([0.92]), valid)
    assert streamer.protocol_diff(want, want, near, [0.925], valid) == 0
    assert streamer.protocol_diff(off, want, near,
                                  np.array([0.925], np.float32), valid) == 1
    with pytest.raises(AssertionError):        # 12.5 is no edge
        streamer.protocol_diff(off, want, [[10.0, 12.5, 30.0, 40.0]],
                               [0.925], valid)
    with pytest.raises(AssertionError):        # 0.9 is no score edge
        streamer.protocol_diff(off, want, near, [0.9], valid)
    with pytest.raises(AssertionError):        # a face more
        streamer.protocol_diff(want, protocol.encode_frame(
            1, np.zeros((1, 4)), [0.5], [False]), near, [0.925], valid)


def test_overlaps_of_device_activities():
    acts = [("Memcpy HtoD (Pinned -> Device)", 0.0, 10.0),
            ("arena_stage_kernel<false>", 5.0, 20.0),
            ("detect_head_kernel", 20.0, 22.0),
            ("Memcpy HtoD (Pinned -> Device)", 21.0, 30.0)]
    assert profiler.overlaps(acts, "Memcpy HtoD", "arena_stage") == [
        ("Memcpy HtoD (Pinned -> Device)", "arena_stage_kernel<false>", 5.0)]
    assert profiler.overlaps(acts, "Memcpy DtoH", "arena_stage") == []


# --------------------------------------------------------------------------
# camera streamer
# --------------------------------------------------------------------------
def test_synthetic_frames_equal_jax():
    ours, theirs = (streamer.synthetic_frames(3, seed=4),
                    jstreamer.synthetic_frames(3, seed=4))
    for _ in range(4):
        a, b = next(ours), next(theirs)
        assert a.dtype == b.dtype == np.uint16 and a.shape == (3, 112, 112)
        np.testing.assert_array_equal(a, b)


def _write_images(frames, path):
    """The RGB565 frames as 112x112 PNGs (each 5/6/5 field shifted back to
    8 bits, so encoding them again gives the frame)."""
    import cv2
    os.makedirs(path, exist_ok=True)
    p = frames.astype(np.int32)
    rgb = np.stack([(p >> 11) << 3, ((p >> 5) & 63) << 2, (p & 31) << 3],
                   -1).astype(np.uint8)
    for i, im in enumerate(rgb):
        cv2.imwrite(os.path.join(path, f"frame_{i}.png"),
                    cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    return path


def test_directory_frames_equal_jax(gold, tmp_path):
    path = _write_images(gold["frames"], str(tmp_path / "imgs"))
    ours, theirs = (streamer.directory_frames(path, 5),
                    jstreamer.directory_frames(path, 5))
    for k in range(3):
        a = next(ours)
        np.testing.assert_array_equal(a, next(theirs))
    np.testing.assert_array_equal(
        np.concatenate([next(streamer.directory_frames(path, 8))]),
        gold["frames"])


def _cycle(batch):
    while True:
        yield batch


@pytest.mark.parametrize("use_native", [True, False])
def test_camera_streamer_equals_jax_on_the_golden_frames(
        gold, port_pipe, jax_pipe, use_native):
    """Two batches of the 8 golden frames through the port's streamer
    (``arena2`` on the CPU; the native ring or the Python queue) and the
    JAX streamer (``fast2``, staged head): the same stats counts and the
    same protocol text, frames numbered 1-16; the first 8 frames' text is
    the golden file's ``protocol_fast2``."""
    if use_native and not native.available():
        pytest.skip(f"no native build here: {native.build_error}")
    frames = gold["frames"]
    ours, theirs = [], []
    a = streamer.CameraStreamer(port_pipe, _cycle(frames),
                                use_native=use_native).run(
        2, on_frame=ours.append)
    b = jstreamer.CameraStreamer(jax_pipe, _cycle(frames),
                                 use_native=False).run(
        2, on_frame=theirs.append)
    assert a["native_ring"] is use_native and b["native_ring"] is False
    assert set(a) == set(b)
    assert (a["frames"], a["faces"]) == (b["frames"], b["faces"]) == \
        (16, 2 * int(gold["count"].sum()))
    det = {k: np.concatenate([gold[k]] * 2) for k in ("boxes", "scores",
                                                      "valid")}
    edge = frames_text(zip(ours, theirs), det)
    golden = re.split(r"(?==== Frame )", str(gold["protocol_fast2"]))[1:]
    assert len(golden) == 8
    edge += frames_text(zip(ours[:8], golden), det)
    assert "".join(theirs[:8]) == str(gold["protocol_fast2"])
    print(f"protocol lines at a rounding edge: {edge}")


def test_golden_protocol_keys_equal_recomputed_jax_side(gold):
    """``protocol_fast2`` and ``protocol_exact`` are what the JAX streamer
    gives on the golden frames now, and the text of the golden arrays."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    want = tool.jax_outputs_protocol()
    assert sorted(want) == sorted(tool.KEYS_PROTOCOL)
    for k, v in want.items():
        assert str(v) == str(gold[k]), k
    for prefix, key in (("", "protocol_fast2"), ("exact_", "protocol_exact")):
        assert str(gold[key]) == "".join(jprotocol.encode_frame(
            i + 1, gold[prefix + "boxes"][i], gold[prefix + "scores"][i],
            gold[prefix + "valid"][i]) for i in range(8))


def test_camera_streamer_synthetic_equals_jax(port_pipe, jax_pipe):
    ours, theirs = [], []
    a = streamer.CameraStreamer(port_pipe, streamer.synthetic_frames(4)).run(
        3, on_frame=ours.append)
    b = jstreamer.CameraStreamer(jax_pipe, jstreamer.synthetic_frames(4),
                                 use_native=False).run(
        3, on_frame=theirs.append)
    assert (a["frames"], a["faces"]) == (b["frames"], b["faces"])
    assert a["frames"] == 12 and len(ours) == len(theirs) == 12
    src = jstreamer.synthetic_frames(4)
    det = jax_pipe.detect_rgb565(np.concatenate([next(src)
                                                 for _ in range(3)]))
    frames_text(zip(ours, theirs), {k: np.asarray(v)
                                    for k, v in det.items()})


def test_camera_streamer_counts_without_text(gold, port_pipe):
    """Without protocol text the faces are summed with numpy: the same
    counts as the per-frame loop."""
    frames = gold["frames"]
    a = streamer.CameraStreamer(port_pipe, _cycle(frames)).run(
        3, emit_protocol=False)
    b = streamer.CameraStreamer(port_pipe, _cycle(frames)).run(
        3, on_frame=lambda t: None)
    assert (a["frames"], a["faces"]) == (b["frames"], b["faces"]) == \
        (24, 3 * int(gold["count"].sum()))


def test_camera_streamer_passes_other_shapes_through(gold, port_pipe,
                                                     jax_pipe):
    """A batch of another shape than the first (the ring's) bypasses the
    ring and the slots, in order, as JAX's does."""
    frames = gold["frames"]
    batches = [frames, frames[:3], frames[2:], frames]
    ours, theirs = [], []
    a = streamer.CameraStreamer(port_pipe, iter(batches)).run(
        5, on_frame=ours.append)
    b = jstreamer.CameraStreamer(jax_pipe, iter(batches),
                                 use_native=False).run(
        5, on_frame=theirs.append)
    c = gold["count"]
    assert (a["frames"], a["faces"]) == (b["frames"], b["faces"]) == \
        (25, int(2 * c.sum() + c[:3].sum() + c[2:].sum()))
    det = {k: np.concatenate([gold[k][:8], gold[k][:3], gold[k][2:],
                              gold[k][:8]]) for k in ("boxes", "scores",
                                                      "valid")}
    frames_text(zip(ours, theirs), det)


def test_camera_streamer_on_an_empty_source(port_pipe):
    stats = streamer.CameraStreamer(port_pipe, iter([])).run(3)
    assert stats["frames"] == stats["faces"] == 0


class _Recorder:
    """A CPU pipeline stand-in that logs each dispatch by the batch's
    first pixel and answers with no detections."""

    device = torch.device("cpu")

    def __init__(self, log):
        self.log = log

    def detect_rgb565_device(self, frames):
        self.log.append(("dispatch", int(frames[0, 0, 0])))
        n = frames.shape[0]
        return {"boxes": torch.zeros(n, 16, 4), "scores": torch.zeros(n, 16),
                "valid": torch.zeros(n, 16, dtype=torch.bool),
                "count": torch.zeros(n, dtype=torch.int32)}


@pytest.mark.parametrize("use_native", [True, False])
def test_one_deep_pipelining_order(use_native):
    """Batch k+1 is dispatched before batch k's detections are drained,
    and every frame is drained once, in order."""
    if use_native and not native.available():
        pytest.skip(f"no native build here: {native.build_error}")
    log = []
    batches = (np.full((3, 112, 112), k, np.uint16) for k in range(5))
    stats = streamer.CameraStreamer(_Recorder(log), batches,
                                    use_native=use_native).run(
        5, on_frame=lambda t: log.append(("frame", int(t.split()[2]))))
    assert stats["frames"] == 15
    order = [e for e in log if e[0] == "dispatch" or e[1] % 3 == 1]
    assert order == [("dispatch", 0), ("dispatch", 1), ("frame", 1),
                     ("dispatch", 2), ("frame", 4), ("dispatch", 3),
                     ("frame", 7), ("dispatch", 4), ("frame", 10),
                     ("frame", 13)]
    assert [e[1] for e in log if e[0] == "frame"] == list(range(1, 16))


@pytest.mark.parametrize("use_native", [True, False])
def test_streamer_threads_end_after_run(port_pipe, use_native):
    """After ``run`` the producer and the stager end, though the source
    is endless and the queue was full (``_put`` rechecks ``_stop``)."""
    if use_native and not native.available():
        pytest.skip(f"no native build here: {native.build_error}")
    st = streamer.CameraStreamer(port_pipe, streamer.synthetic_frames(2),
                                 use_native=use_native)
    st.run(2)
    for t in (st._producer, st._stager):
        t.join(timeout=10)
        assert not t.is_alive()


@pytest.mark.parametrize("use_native", [True, False])
def test_multicamera_streamer_equals_jax(gold, port_pipe, jax_pipe,
                                         use_native):
    """Three cameras of golden frames through the scheduler into one
    pipeline: per-stream counts, per-stream order, and each (stream, seq)
    frame's protocol text equal the JAX streamer's."""
    if use_native and not native.available():
        pytest.skip(f"no native build here: {native.build_error}")
    frames = gold["frames"]

    def camera(s):
        for k in range(6):
            yield frames[(s + k) % 8]

    def run(cls, pipe, **kw):
        lines = []
        stats = cls(pipe, [camera(s) for s in range(3)], batch=6, **kw).run(
            3, on_frame=lambda sid, seq, text: lines.append(
                (sid, seq, text)))
        return stats, lines

    a, ours = run(streamer.MultiCameraStreamer, port_pipe,
                  use_native=use_native)
    b, theirs = run(jstreamer.MultiCameraStreamer, jax_pipe,
                    use_native=False)
    assert a["native"] is use_native
    assert (a["batches"], a["frames"]) == (b["batches"], b["frames"]) == \
        (3, 18)
    assert a["frames_per_stream"] == b["frames_per_stream"] == [6, 6, 6]
    assert a["faces_per_stream"] == b["faces_per_stream"]
    for s in range(3):
        assert [q for sid, q, _ in ours if sid == s] == list(range(6))
    want = {(sid, seq): t for sid, seq, t in theirs}
    for sid, seq, text in ours:
        i = (sid + seq) % 8
        streamer.protocol_diff(text, want[(sid, seq)], gold["boxes"][i],
                               gold["scores"][i], gold["valid"][i])


# --------------------------------------------------------------------------
# monitor
# --------------------------------------------------------------------------
def _text(n):
    boxes = np.array([[5.0, 6.0, 20.0, 25.0]])
    return "".join(protocol.encode_frame(i + 1, boxes, np.array([0.9]),
                                         np.array([True]))
                   for i in range(n))


def test_monitor_state_and_render_equal_jax():
    ours, theirs = monitor.MonitorState(5), jmonitor.MonitorState(5)
    for i in range(8):
        t = _text(1).replace("Frame 1", f"Frame {i + 1}")
        ours.update(protocol.parse_frame(t.split("\r\n")))
        theirs.update(jprotocol.parse_frame(t.split("\r\n")))
    assert (ours.frames, ours.total_faces, len(ours.history)) == (8, 8, 5)
    assert ours.render() == theirs.render()
    assert ours.ascii_canvas() == theirs.ascii_canvas()
    assert ours.summary() == theirs.summary() == {
        "frames": 8, "total_faces": 8, "avg_faces": 1.0}


def test_run_monitor_from_text_equals_jax():
    a, b = io.StringIO(), io.StringIO()
    sa = monitor.run_monitor([_text(4)], render_every=2, out=a,
                             draw_canvas=True)
    sb = jmonitor.run_monitor([_text(4)], render_every=2, out=b,
                              draw_canvas=True)
    assert sa.frames == sb.frames == 4
    assert a.getvalue() == b.getvalue() and "Frame 4" in a.getvalue()


def test_run_monitor_save_png(tmp_path):
    import cv2
    png_dir = tmp_path / "dash"
    state = monitor.run_monitor([_text(4)], render_every=2,
                                out=io.StringIO(), save_png=str(png_dir))
    assert state.frames == 4
    pngs = sorted(png_dir.glob("frame_*.png"))
    assert [p.name for p in pngs] == ["frame_00002.png", "frame_00004.png"]
    img = cv2.imread(str(pngs[-1]))
    assert img is not None and img.shape[0] > 100 and img.std() > 1.0


def test_monitor_socket_source():
    """Protocol text over a local TCP socket, a frame split across two
    segments, reaches the monitor through ``socket_stream``."""
    payload = _text(3).encode()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def produce():
        conn, _ = srv.accept()
        conn.sendall(payload[:len(payload) // 2])
        conn.sendall(payload[len(payload) // 2:])
        conn.close()
        srv.close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    out = io.StringIO()
    state = monitor.run_monitor(
        monitor.socket_stream("127.0.0.1", port, timeout=10.0), out=out)
    t.join(5.0)
    assert not t.is_alive()
    assert (state.frames, state.total_faces) == (3, 3)
    assert "Frame 3" in out.getvalue()


def test_monitor_main_file_source(tmp_path, capsys):
    text = tmp_path / "frames.txt"
    text.write_text(_text(5), newline="")
    cfg = tmp_path / "cfg.json"
    monitor.main(["--config", str(cfg), "--source", "file", "--file",
                  str(text), "--render-every", "5"])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1].split(": ", 1)[1]) == {
        "frames": 5, "total_faces": 5, "avg_faces": 1.0}
    saved = json.loads(cfg.read_text())
    assert saved["source"] == "file" and saved["tflite"] == CORPUS


def test_monitor_live_dataset_source_on_the_cpu(gold, tmp_path, capsys):
    """``--source dataset --device cpu``: the golden frames as images
    through the port's ``CameraStreamer`` in ``arena_exact``; the session
    counts JAX ``exact``'s faces (the golden ``exact_count``)."""
    path = _write_images(gold["frames"], str(tmp_path / "imgs"))
    monitor.main(["--config", str(tmp_path / "cfg.json"), "--source",
                  "dataset", "--dataset", path, "--device", "cpu",
                  "--batches", "1", "--batch-size", "8",
                  "--render-every", "8"])
    lines = capsys.readouterr().out.strip().splitlines()
    stats = json.loads(lines[-2].split(": ", 1)[1])
    summary = json.loads(lines[-1].split(": ", 1)[1])
    assert stats["frames"] == summary["frames"] == 8
    assert stats["faces"] == summary["total_faces"] == \
        int(gold["exact_count"].sum())


def test_monitor_synthetic_runs_as_a_module(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "yoloface_tpu_torch.host.monitor", "--source",
         "synthetic", "--device", "cpu", "--batches", "2", "--config",
         str(tmp_path / "cfg.json")], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    stats = json.loads(lines[-2].split(": ", 1)[1])
    assert stats["frames"] == 16
    assert stats["native_ring"] is native.available()
    assert json.loads(lines[-1].split(": ", 1)[1])["frames"] == 16


def test_monitor_live_source_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        monitor.main(["--config", str(tmp_path / "cfg.json"), "--source",
                      "synthetic", "--batches", "1"])


# --------------------------------------------------------------------------
# GUI
# --------------------------------------------------------------------------
def test_gui_geometry_pure_functions():
    assert gui.DISPLAY == 112
    assert gui.box_px(protocol.Face(1, 0, 0, 112, 112, 0.9), 336) == \
        (0, 0, 336, 336)
    assert gui.box_px(protocol.Face(2, 28, 56, 84, 112, 0.5), 336) == \
        (84, 168, 252, 336)
    assert gui.chart_points([], 100, 50) == []
    pts = gui.chart_points([0, 1, 2, 4], 100, 50, pad=8)
    xs, ys = [p[0] for p in pts], [p[1] for p in pts]
    assert xs == sorted(xs) and xs[0] == 8 and xs[-1] == 92
    assert ys[0] == 42 and ys[-1] == 8
    rng = np.random.default_rng(9)
    for n in (1, 2, 50):
        hist = rng.integers(0, 6, n).tolist()
        assert gui.chart_points(hist, 420, 220) == \
            jgui.chart_points(hist, 420, 220)
        f = protocol.Face(1, *rng.integers(0, 113, 4).tolist(), 0.5)
        assert gui.box_px(f, 336) == jgui.box_px(f, 336)


def test_gui_headless_fallback(capsys, tmp_path, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    assert gui.run_gui(config_path=str(tmp_path / "cfg.json")) is False
    assert "falling back" in capsys.readouterr().out


def test_monitor_gui_flag_falls_back_to_the_terminal_loop(
        tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    text = tmp_path / "frames.txt"
    text.write_text(_text(2), newline="")
    monitor.main(["--gui", "--config", str(tmp_path / "cfg.json"),
                  "--source", "file", "--file", str(text)])
    out = capsys.readouterr().out
    assert "falling back" in out
    assert json.loads(out.strip().splitlines()[-1].split(": ", 1)[1])[
        "frames"] == 2
