"""Post-training int8 quantization with representative-dataset calibration.

The counterpart of ``yoloface_tpu.quantize.calibrate`` (the reference's
PTQ flow, `yoloface/tflite/tflite_quantize.py`):

  1. fold BatchNorm into conv weights and biases (float64 numpy, JAX's
     code as it is);
  2. interpret the template graph's topology (the imported int8 graph,
     which fixes op order, PAD placement and the QUANTIZE-before-CONCAT
     structure) in float32 torch over the representative images, on the
     card by default, recording each activation tensor's range;
  3. choose TFLite-style quantization parameters (asymmetric per-tensor
     int8 activations with zero-point nudging; symmetric per-channel
     weights, absmax/127; int32 biases at s_in * s_w[c]);
  4. emit a fresh :class:`GraphDef` that runs on any ``Int8Engine`` mode.

Steps 1, 3 and 4 are numpy copies of JAX's.  ``float_forward`` keeps
JAX's NHWC tensors at its edges and its ``fq`` hook (the QAT
fake-quantization insertion point); inside, the convolutions run NCHW
with TF32 off (``core.precision.full_f32``: JAX asks for
``Precision.HIGHEST``).  ``calibrate`` takes JAX's Flax variables, the
port's state dict or a ``YoloFace``.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yoloface_tpu_torch.core.precision import device_or_raise, full_f32
from yoloface_tpu_torch.graph.ir import GraphDef, QParams
from yoloface_tpu_torch.ops.int8_ref import _same_pad_amounts


# --------------------------------------------------------------------------
# 1. BatchNorm folding (Flax params -> float conv weights per template op)
# --------------------------------------------------------------------------
# Flax module path of the conv feeding each template CONV/DW op index
# (template = the imported yoloface_int8.tflite graph; op indices from its
# 54-op schedule, see tests/test_parity_int8.py graph dump).
FLAX_TO_TEMPLATE_OP = {
    1: "conv1", 3: "conv2/dw", 5: "conv2/pw", 6: "conv3",
    10: "conv4/dw", 12: "conv4/pw", 13: "conv5", 15: "conv6/dw",
    17: "conv6/pw", 19: "conv7", 23: "conv8", 27: "conv9/dw",
    29: "conv9/pw", 30: "conv10", 32: "conv11/dw", 34: "conv11/pw",
    36: "conv12", 38: "conv13/dw", 40: "conv13/pw", 42: "conv14",
    47: "conv15", 49: "conv16/dw", 51: "conv16/pw", 53: "conv17",
}


def _get_path(tree, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def fold_batchnorm(variables, eps: float = 1e-5) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Flax YoloFace variables -> {template op index: (w_ohwi f32, bias f32)}.

    Folding: w' = w * gamma / sqrt(var + eps); b' = beta - mean * gamma /
    sqrt(var + eps).  Depthwise kernels (flax HWIO with I=1, O=C after
    feature_group_count=C) are emitted in the TFLite [1,Kh,Kw,C] layout;
    standard convs as [Co,Kh,Kw,Ci] (OHWI).
    """
    params = variables["params"]
    stats = variables["batch_stats"]
    out = {}
    for op_idx, path in FLAX_TO_TEMPLATE_OP.items():
        mod = _get_path(params, path)
        bn_s = _get_path(stats, path)["bn"]
        kernel = np.asarray(mod["conv"]["kernel"], np.float64)  # HWIO
        gamma = np.asarray(mod["bn"]["scale"], np.float64)
        beta = np.asarray(mod["bn"]["bias"], np.float64)
        mean = np.asarray(bn_s["mean"], np.float64)
        var = np.asarray(bn_s["var"], np.float64)
        mult = gamma / np.sqrt(var + eps)
        folded = kernel * mult  # scales output channels (last dim of HWIO)
        bias = beta - mean * mult
        if path.endswith("dw"):
            w = folded.transpose(2, 0, 1, 3)   # HWIO [3,3,1,C] -> [1,3,3,C]
        else:
            w = folded.transpose(3, 0, 1, 2)   # HWIO -> OHWI
        out[op_idx] = (np.ascontiguousarray(w, dtype=np.float32),
                       bias.astype(np.float32))
    return out


# --------------------------------------------------------------------------
# 2. float-domain interpretation of the template graph, recording ranges
# --------------------------------------------------------------------------
# NHWC axis -> NCHW axis
_NCHW_AXIS = {0: 0, 1: 2, 2: 3, 3: 1}


def device_weights(weights, device) -> Dict[int, Tuple[torch.Tensor, ...]]:
    """{op index: (w, b)} in TFLite layouts (numpy or tensors) -> float32
    tensors on ``device``."""
    out = {}
    for k, (w, b) in weights.items():
        out[k] = tuple(torch.as_tensor(np.asarray(v, np.float32)
                                       if isinstance(v, np.ndarray) else v,
                                       dtype=torch.float32, device=device)
                       for v in (w, b))
    return out


def _pad_hw(x: torch.Tensor, ph, pw, value: float = 0.0) -> torch.Tensor:
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (int(pw[0]), int(pw[1]), int(ph[0]), int(ph[1])),
                 value=value)


def _forward_nchw(template: GraphDef, weights, x: torch.Tensor,
                  alpha: float, fq) -> Dict[int, torch.Tensor]:
    """``float_forward``'s env with NCHW tensors."""
    if fq is not None:
        x = fq(template.inputs[0], x)
    env: Dict[int, torch.Tensor] = {template.inputs[0]: x}
    for op in template.ops:
        o = op.outputs[0]
        name = op.opname
        if name == "PAD":
            p = template.tensor(op.inputs[1]).data.astype(int)
            if p[0].any() or p[3].any():
                raise NotImplementedError("PAD of the batch or channels")
            env[o] = _pad_hw(env[op.inputs[0]], tuple(p[1]), tuple(p[2]))
        elif name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            x = env[op.inputs[0]]
            w, b = weights[op.index]
            stride = (op.attrs["stride_h"], op.attrs["stride_w"])
            if op.attrs["padding"] == "SAME":
                # kh/kw sit at dims 1,2 in both OHWI and [1,Kh,Kw,C]
                x = _pad_hw(x, _same_pad_amounts(x.shape[2], stride[0],
                                                 w.shape[1]),
                            _same_pad_amounts(x.shape[3], stride[1],
                                              w.shape[2]))
            if name == "CONV_2D":
                acc = F.conv2d(x, w.permute(0, 3, 1, 2), b, stride)
            else:       # [1,Kh,Kw,C] -> [C,1,Kh,Kw], one group a channel
                acc = F.conv2d(x, w.permute(3, 0, 1, 2), b, stride,
                               groups=w.shape[3])
            env[o] = acc
        elif name == "LEAKY_RELU":
            v = env[op.inputs[0]]
            env[o] = torch.where(v >= 0, v, v * alpha)
        elif name == "MAX_POOL_2D":
            x = env[op.inputs[0]]
            fh, fw = op.attrs["filter_h"], op.attrs["filter_w"]
            sh, sw = op.attrs["stride_h"], op.attrs["stride_w"]
            if op.attrs["padding"] == "SAME":
                x = _pad_hw(x, _same_pad_amounts(x.shape[2], sh, fh),
                            _same_pad_amounts(x.shape[3], sw, fw),
                            -float("inf"))
            env[o] = F.max_pool2d(x, (fh, fw), (sh, sw))
        elif name == "ADD":
            env[o] = env[op.inputs[0]] + env[op.inputs[1]]
        elif name == "QUANTIZE":
            env[o] = env[op.inputs[0]]
        elif name == "CONCATENATION":
            env[o] = torch.cat([env[i] for i in op.inputs],
                               _NCHW_AXIS[op.attrs["axis"] % 4])
        elif name == "RELU":
            env[o] = torch.clamp(env[op.inputs[0]], min=0.0)
        elif name == "RESIZE_NEAREST_NEIGHBOR":
            x = env[op.inputs[0]]
            oh, ow = template.tensor(o).shape[1:3]
            env[o] = x.repeat_interleave(oh // x.shape[2], 2) \
                      .repeat_interleave(ow // x.shape[3], 3)
        else:
            raise NotImplementedError(name)
        if fq is not None:
            env[o] = fq(o, env[o])
    return env


def float_forward(template: GraphDef, weights, x_f32, alpha: float = 0.1,
                  fq: Optional[Callable] = None, device="cuda"
                  ) -> Dict[int, torch.Tensor]:
    """Run the template topology in float32 -> the env of every tensor,
    NHWC (views of NCHW storage), on ``device``.

    x_f32: [N,56,56,3] in the converter's input domain ([0,1] after /255),
    numpy or a tensor.  weights: {op index: (w, b)} in the TFLite layouts
    (OHWI, depthwise [1,Kh,Kw,C]), numpy or tensors.  QUANTIZE ops are
    identity in float; PAD pads with 0.0 (the Keras graph zero-pads the raw
    float feature maps).  fq: optional ``(tensor_idx, value) -> value``
    hook on the input and every op output (the QAT fake-quantization
    insertion point), given NHWC values as in JAX; None = plain float.
    """
    device = device_or_raise(device, "float_forward")
    x = torch.as_tensor(np.asarray(x_f32, np.float32)
                        if isinstance(x_f32, np.ndarray) else x_f32,
                        dtype=torch.float32, device=device)
    nchw_fq = None if fq is None else (
        lambda i, v: fq(i, v.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))
    with full_f32():
        env = _forward_nchw(template, device_weights(weights, device),
                            x.permute(0, 3, 1, 2), alpha, nchw_fq)
    return {k: v.permute(0, 2, 3, 1) for k, v in env.items()}


def observe_ranges(template: GraphDef, weights, rep_images,
                   batch: int = 8, observer: str = "minmax",
                   percentile: float = 99.9, ema_decay: float = 0.9,
                   device="cuda") -> Dict[int, Tuple[float, float]]:
    """Per-tensor activation ranges over the representative images (the
    TFLite quantizer's statistics pass, tflite_quantize.py:29-58).

    observer: "minmax" (global min/max, what TFLite PTQ does; the parity
    default), "percentile" (lo = P(100-p), hi = P(p), linear
    interpolation as ``jnp.percentile``) or "ema" (a moving average of
    per-batch min/max).  Each batch's ranges come to the host in one
    copy.
    """
    device = device_or_raise(device, "observe_ranges")
    w = device_weights(weights, device)
    ranges: Dict[int, Tuple[float, float]] = {}
    rep = np.asarray(rep_images, np.float32)
    q = torch.tensor([(100.0 - percentile) / 100.0, percentile / 100.0],
                     device=device)
    for i in range(0, len(rep), batch):
        x = torch.from_numpy(rep[i:i + batch]).to(device)
        with torch.no_grad(), full_f32():
            env = _forward_nchw(template, w, x.permute(0, 3, 1, 2), 0.1,
                                None)
            keys = list(env)
            if observer == "percentile":
                stats = torch.stack([torch.quantile(env[k].reshape(-1), q)
                                     for k in keys])
            else:
                stats = torch.stack([torch.stack([env[k].min(),
                                                  env[k].max()])
                                     for k in keys])
        for k, (lo, hi) in zip(keys, stats.cpu().tolist()):
            if k not in ranges:
                ranges[k] = (lo, hi)
            elif observer == "ema":
                d = ema_decay
                ranges[k] = (d * ranges[k][0] + (1 - d) * lo,
                             d * ranges[k][1] + (1 - d) * hi)
            else:   # minmax and percentile aggregate by envelope
                ranges[k] = (min(ranges[k][0], lo), max(ranges[k][1], hi))
    return ranges


# --------------------------------------------------------------------------
# 3. TFLite-style quantization parameter choice
# --------------------------------------------------------------------------
def choose_qparams(rmin: float, rmax: float,
                   qmin: int = -128, qmax: int = 127) -> QParams:
    """Asymmetric per-tensor int8 params with zero-point nudging (port of
    TFLite's ChooseQuantizationParams): zero must be exactly representable."""
    rmin = min(rmin, 0.0)
    rmax = max(rmax, 0.0)
    if rmax == rmin:
        return QParams((1.0,), (0,))
    scale = (rmax - rmin) / (qmax - qmin)
    zp_real = qmin - rmin / scale
    zp = int(np.clip(round(zp_real), qmin, qmax))
    return QParams((float(scale),), (zp,))


def quantize_weights_per_channel(w: np.ndarray, channel_axis: int
                                 ) -> Tuple[np.ndarray, QParams]:
    """Symmetric per-channel int8 (TFLite weight scheme): scale=absmax/127."""
    sw = np.moveaxis(w, channel_axis, 0).reshape(w.shape[channel_axis], -1)
    absmax = np.abs(sw).max(axis=1)
    absmax = np.where(absmax == 0, 1e-8, absmax)
    scales = (absmax / 127.0).astype(np.float64)
    shape = [1] * w.ndim
    shape[channel_axis] = -1
    q = np.clip(np.round(w / scales.reshape(shape)), -127, 127).astype(np.int8)
    return q, QParams(tuple(scales), tuple([0] * len(scales)), channel_axis)


# --------------------------------------------------------------------------
# 4. assemble the quantized GraphDef
# --------------------------------------------------------------------------
def derive_act_qparams(template: GraphDef, ranges,
                       input_qparams: Optional[QParams] = None
                       ) -> Dict[int, QParams]:
    """Activation qparams from observed ranges + the converter's structural
    sharing rules:
      * PAD output shares its input's qparams;
      * CONCATENATION inputs (the QUANTIZE outputs) share the concat
        output's qparams (that is why the converter inserted them);
      * MAX_POOL / RESIZE_NEAREST / RELU outputs share input qparams
        (TFLite requires same in/out quantization for those ops).
    Shared with the QAT fake-quant simulation (quantize/qat.py) so the
    training-time grid IS the deployment grid."""
    act_q: Dict[int, QParams] = {}
    for ti, (lo, hi) in ranges.items():
        act_q[ti] = choose_qparams(lo, hi)
    act_q[template.inputs[0]] = (input_qparams
                                 or QParams((1.0 / 255.0,), (-128,)))
    for op in template.ops:
        if op.opname == "PAD":
            act_q[op.outputs[0]] = act_q[op.inputs[0]]
    for op in template.ops:
        if op.opname == "CONCATENATION":
            for i in op.inputs:
                act_q[i] = act_q[op.outputs[0]]
    for op in template.ops:
        if op.opname in ("MAX_POOL_2D", "RESIZE_NEAREST_NEIGHBOR", "RELU"):
            act_q[op.outputs[0]] = act_q[op.inputs[0]]
    return act_q


def build_int8_graph(template: GraphDef, weights, ranges,
                     input_qparams: Optional[QParams] = None) -> GraphDef:
    """New GraphDef: template topology + fresh weights/activation qparams."""
    g = copy.deepcopy(template)
    act_q = derive_act_qparams(template, ranges, input_qparams)

    for ti, q in act_q.items():
        g.tensors[ti].qparams = q

    # weights + biases
    for op in g.ops:
        if op.opname not in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            continue
        w_f, b_f = weights[op.index]
        channel_axis = 0 if op.opname == "CONV_2D" else 3
        q, wq = quantize_weights_per_channel(w_f, channel_axis)
        w_t = g.tensors[op.inputs[1]]
        w_t.data = q
        w_t.qparams = wq
        w_t.shape = tuple(q.shape)
        s_in = act_q[op.inputs[0]].scale
        bias_scales = s_in * np.asarray(wq.scales, np.float64)
        b_t = g.tensors[op.inputs[2]]
        b_t.data = np.round(np.asarray(b_f, np.float64)
                            / bias_scales).astype(np.int32)
        b_t.qparams = QParams(tuple(bias_scales),
                              tuple([0] * len(bias_scales)), 0)
    g.description = "calibrated by yoloface_tpu.quantize"
    return g


def _flax_variables(variables):
    """Flax variables, the port's state dict or a ``YoloFace`` -> Flax
    variables as numpy."""
    from yoloface_tpu_torch.models.convert import flax_from_state_dict
    if isinstance(variables, torch.nn.Module) or "params" not in variables:
        return flax_from_state_dict(variables)
    return variables


def calibrate(variables, rep_images, template: GraphDef,
              observer: str = "minmax", device="cuda",
              **observer_kw) -> GraphDef:
    """Model weights (Flax variables, the port's state dict or a
    ``YoloFace``) + representative images -> int8 GraphDef."""
    weights = fold_batchnorm(_flax_variables(variables))
    ranges = observe_ranges(template, weights, rep_images,
                            observer=observer, device=device, **observer_kw)
    return build_int8_graph(template, weights, ranges)


def calibrate_from_weights(weights, rep_images, template: GraphDef,
                           observer: str = "minmax", device="cuda",
                           **observer_kw) -> GraphDef:
    """Same, from pre-folded float weights {op_index: (w, b)}."""
    ranges = observe_ranges(template, weights, rep_images,
                            observer=observer, device=device, **observer_kw)
    return build_int8_graph(template, weights, ranges)
