"""Minimal ONNX evaluator: executes the emitted float ModelProto in torch.

The counterpart of ``yoloface_tpu.io.onnx_eval``.  The reference *runs*
its exported onnx artifact through onnxruntime
(`yoloface/pytorch/onnx_prediction.py:33-37`); this module closes that
loop without onnxruntime, with a small interpreter over the op set the
exporter emits: Conv (grouped too), MaxPool, AveragePool, LeakyRelu, Relu,
Sigmoid, Add, Concat and Identity.  Any other op raises
``NotImplementedError``.  Input is the structural parse of
:func:`yoloface_tpu_torch.io.onnx_export.parse_model`; the layout is NCHW
float32, as in the emitted graph.

The arithmetic is JAX's ``lax`` calls, op for op:

  * ONNX pads are asymmetric ``(top, left, bottom, right)``: the input is
    padded explicitly (zeros for Conv, ``-inf`` for MaxPool, zeros for the
    sums of AveragePool), then the window runs unpadded;
  * AveragePool with ``count_include_pad=0`` divides each window's sum by
    its count of taps inside the image (a window sum over ones), with 1 by
    the kernel's size;
  * convolutions run without TF32 (``core.precision.full_f32``), as JAX
    asks for ``Precision.HIGHEST``.

The evaluator runs on the card unless the caller passes ``device="cpu"``.
These are stock torch ops: JAX computes this module with ``lax`` outside any
Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from yoloface_tpu_torch.core.precision import device_or_raise, full_f32


def _pad(x: torch.Tensor, pads, value: float) -> torch.Tensor:
    pt, pl, pb, pr = pads
    if not any(pads):
        return x
    return F.pad(x, (pl, pr, pt, pb), value=value)


def _conv(x, w, b, strides, pads, group):
    # pads is ONNX (top, left, bottom, right)
    out = F.conv2d(_pad(x, pads, 0.0), w, None, tuple(strides), 0, 1, group)
    return out + b.reshape(1, -1, 1, 1)


def _pool(x, kind, kernel, strides, pads, count_include_pad=0):
    kernel, strides = tuple(kernel), tuple(strides)
    if kind == "MaxPool":
        return F.max_pool2d(_pad(x, pads, -math.inf), kernel, strides)
    # AveragePool: window sums over the zero-padded input
    summed = F.avg_pool2d(_pad(x, pads, 0.0), kernel, strides,
                          divisor_override=1)
    if count_include_pad:
        return summed / float(np.prod(kernel))
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    counts = F.avg_pool2d(_pad(ones, pads, 0.0), kernel, strides,
                          divisor_override=1)
    return summed / counts


def _run(parsed: dict, inits: Dict[str, torch.Tensor], x) -> torch.Tensor:
    env: Dict[str, torch.Tensor] = dict(inits)
    env[parsed["inputs"][0]] = x
    for n in parsed["nodes"]:
        op = n["op_type"]
        a = n["attrs"]

        def ints(name, default=None):
            if name in a:
                return tuple(int(v) for v in a[name]["ints"])
            return default

        ins = [env[i] for i in n["inputs"]]
        if op == "Conv":
            out = _conv(ins[0], ins[1],
                        ins[2] if len(ins) > 2 else
                        torch.zeros((ins[1].shape[0],), dtype=ins[1].dtype,
                                    device=ins[1].device),
                        ints("strides", (1, 1)),
                        ints("pads", (0, 0, 0, 0)),
                        int(a["group"]["i"]) if "group" in a else 1)
        elif op in ("MaxPool", "AveragePool"):
            out = _pool(ins[0], op, ints("kernel_shape"),
                        ints("strides", (1, 1)), ints("pads", (0, 0, 0, 0)),
                        int(a["count_include_pad"].get("i", 0))
                        if "count_include_pad" in a else 0)
        elif op == "LeakyRelu":
            alpha = float(a["alpha"]["f"]) if "alpha" in a else 0.01
            out = torch.where(ins[0] >= 0, ins[0], alpha * ins[0])
        elif op == "Relu":
            out = torch.clamp(ins[0], min=0)
        elif op == "Sigmoid":
            out = torch.sigmoid(ins[0])
        elif op == "Add":
            out = ins[0] + ins[1]
        elif op == "Concat":
            out = torch.cat(ins, dim=int(a["axis"]["i"]))
        elif op == "Identity":
            out = ins[0]
        else:
            raise NotImplementedError(f"onnx eval: op {op}")
        env[n["outputs"][0]] = out
    return env[parsed["outputs"][0]]


class OnnxEvaluator:
    """Executes a parsed ONNX model (NCHW float32) on ``device``.

    ``ev = OnnxEvaluator(model_bytes); y = ev(x_nchw)`` -> numpy, as the
    JAX evaluator returns; ``ev.evaluate(x)`` keeps the device's tensor.
    """

    def __init__(self, model_bytes: bytes, device="cuda"):
        from yoloface_tpu_torch.io.onnx_export import parse_model
        self.device = device_or_raise(device, "OnnxEvaluator")
        self.parsed = parse_model(model_bytes)
        self.inits = {k: torch.from_numpy(np.array(v[1], np.float32)).to(
            self.device) for k, v in self.parsed["initializers"].items()}

    @torch.no_grad()
    def evaluate(self, x_nchw) -> torch.Tensor:
        """float32 NCHW input (numpy or a tensor) -> the graph's output on
        the evaluator's device."""
        if isinstance(x_nchw, np.ndarray):
            x_nchw = torch.from_numpy(np.ascontiguousarray(x_nchw))
        x = x_nchw.to(self.device, torch.float32)
        with full_f32():
            return _run(self.parsed, self.inits, x)

    def __call__(self, x_nchw) -> np.ndarray:
        return self.evaluate(x_nchw).cpu().numpy()
