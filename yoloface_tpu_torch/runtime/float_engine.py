"""FP32 graph engine: runs float TFLite graphs in torch.

The counterpart of ``yoloface_tpu.runtime.float_engine``: the importer's
IR of a float32 graph (the reference's ``yoloface.tflite`` family),
interpreted by the float executor that also backs PTQ calibration
(:func:`yoloface_tpu_torch.quantize.calibrate.float_forward`), with TF32
off.  On the card unless the caller passes ``device="cpu"``; without a
card the default raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from yoloface_tpu_torch.core.precision import device_or_raise
from yoloface_tpu_torch.graph.ir import GraphDef
from yoloface_tpu_torch.quantize.calibrate import (device_weights,
                                                   float_forward)


class FloatEngine:
    """Executes a float32 TFLite graph (conv weights as constants)."""

    def __init__(self, graph: GraphDef, device="cuda"):
        in_t = graph.tensor(graph.inputs[0])
        if in_t.dtype != np.dtype(np.float32):
            raise ValueError(
                f"FloatEngine requires a float32 graph; input tensor "
                f"{in_t.name!r} is {in_t.dtype}. Use Int8Engine for "
                f"quantized graphs.")
        self.device = device_or_raise(device, "FloatEngine")
        self.graph = graph
        self.input_idx = graph.inputs[0]
        self.output_idx = graph.outputs[0]
        self.input_shape = tuple(in_t.shape[1:])
        # weights dict in the float_forward convention, on the device once
        weights: Dict[int, tuple] = {}
        for op in graph.ops:
            if op.opname in ("CONV_2D", "DEPTHWISE_CONV_2D"):
                w = graph.tensor(op.inputs[1]).data
                b = (graph.tensor(op.inputs[2]).data
                     if len(op.inputs) > 2 and op.inputs[2] >= 0
                     else np.zeros(w.shape[0] if op.opname == "CONV_2D"
                                   else w.shape[3], np.float32))
                weights[op.index] = (np.asarray(w, np.float32),
                                     np.asarray(b, np.float32))
        self.weights = device_weights(weights, self.device)

    @torch.no_grad()
    def __call__(self, x) -> torch.Tensor:
        """float32 frames [N,56,56,3] in [0,1] (numpy or a tensor) -> raw
        head [N,7,7,18] on the engine's device."""
        env = float_forward(self.graph, self.weights, x, device=self.device)
        return env[self.output_idx]

    @torch.no_grad()
    def run_with_intermediates(self, x) -> Dict[int, np.ndarray]:
        env = float_forward(self.graph, self.weights, x, device=self.device)
        return {k: v.cpu().numpy() for k, v in env.items()}
