"""The system under test of a configuration whose ``program`` is
``face_pipeline``: the port's serving pipeline and the entry that the
window drives.

This module and its like under ``benchmark/programs/`` are the only ones
of the benchmark that import ``yoloface_tpu_torch`` (the PyTorch and CUDA
port).  It loads the configuration's int8 ``.tflite`` (``graph``) with the
port's reader, retargets it where the configuration asks
(``graph/retarget.retarget_spatial``), and serves it through
``FacePipeline(Int8Engine(graph, mode), HeadConfig(**decode))``; the
traffic names the mode and the entry (``detect_rgb565_device``,
``detect_int8_device``).  A forward hook on the engine hands back, beside
each batch's detections, the engine's int8 input (the preprocess kernel's
output on an RGB565 entry) and its int8 head tensor, so that the check
sees what the timed path itself produced.
"""

from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


class Program:
    def __init__(self, config: dict, traffic: dict, device):
        from yoloface_tpu_torch.graph.retarget import retarget_spatial
        from yoloface_tpu_torch.io.tflite_import import load_tflite
        from yoloface_tpu_torch.pipeline.e2e import FacePipeline
        from yoloface_tpu_torch.pipeline.head import HeadConfig
        from yoloface_tpu_torch.runtime.engine import Int8Engine

        g = config["graph"]
        graph = load_tflite(str(ROOT / g["file"]))
        if g["retarget"] != 1:
            graph = retarget_spatial(graph, g["retarget"])
        d = config["decode"]
        head = HeadConfig(grid=d["grid"], stride=d["stride"],
                          anchors=tuple(tuple(a) for a in d["anchors"]),
                          conf_threshold=d["conf_threshold"],
                          iou_threshold=d["iou_threshold"],
                          max_detections=d["max_detections"])
        self.pipe = FacePipeline(Int8Engine(graph, traffic["mode"], device),
                                 head)
        self.entry = getattr(self.pipe, traffic["entry"])
        self.capture = {}
        self.pipe.engine.register_forward_hook(self._hook)

    def _hook(self, module, args, output):
        self.capture["x"], self.capture["y"] = args[0], output

    def __call__(self, frames) -> dict:
        """The entry on one batch: its detections (``dets``), the engine's
        int8 input (``x``) and its int8 head tensor (``y``)."""
        self.capture = {}
        self.capture["dets"] = self.entry(frames)
        return self.capture

    @staticmethod
    def build_seconds() -> dict:
        """The port's CUDA libraries that this process built, by name, and
        the seconds each build took (none where they were cached)."""
        from yoloface_tpu_torch.kernels import _build
        return dict(_build.build_seconds)
