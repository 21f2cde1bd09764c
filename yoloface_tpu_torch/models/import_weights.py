"""Import pretrained weights into the YoloFace model (numpy).

A copy of ``yoloface_tpu.models.import_weights`` that gives the same Flax
variables as numpy; ``models.convert.state_dict_from_flax`` turns them
into the port's state dict.  On a machine without flax this is how float
weights come from ``checkpoints/yoloface_corpus_int8.tflite``.

Two sources:
  * an int8 TFLite graph (the shipped ``yoloface_int8.tflite``) — weights
    are dequantized per-channel and installed with identity BatchNorm
    (conv bias carried in BN beta), giving the FP32 "twin" of the deployed
    model.  This replaces the reference's missing ``yoloface-50k.weights``
    Darknet checkpoint as the source of pretrained weights;
  * a Darknet ``.weights`` stream (see :mod:`yoloface_tpu_torch.io.darknet`).

The mapping is the exact inverse of
:func:`yoloface_tpu_torch.quantize.calibrate.fold_batchnorm`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from yoloface_tpu_torch.graph.ir import GraphDef
from yoloface_tpu_torch.quantize.calibrate import FLAX_TO_TEMPLATE_OP


def _set_path(tree: Dict, path: str, leaf: Dict):
    node = tree
    parts = path.split("/")
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = leaf


def dequantize_template_weights(template: GraphDef,
                                ) -> Dict[int, tuple]:
    """{conv op index: (w_float, bias_float)} from an int8 graph, in the
    TFLite layouts (OHWI / [1,Kh,Kw,C])."""
    out = {}
    for op in template.ops:
        if op.opname not in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            continue
        w_t = template.tensor(op.inputs[1])
        b_t = template.tensor(op.inputs[2])
        axis = w_t.qparams.quantized_dimension
        scales = np.asarray(w_t.qparams.scales, np.float64)
        shape = [1] * w_t.data.ndim
        shape[axis] = -1
        w = w_t.data.astype(np.float64) * scales.reshape(shape)
        b = b_t.data.astype(np.float64) * np.asarray(
            b_t.qparams.scales, np.float64)
        out[op.index] = (w.astype(np.float32), b.astype(np.float32))
    return out


def variables_from_template(template: GraphDef, eps: float = 1e-5):
    """Build Flax YoloFace variables carrying the dequantized template
    weights: BN configured as identity (gamma=1, mean=0, var=1-eps) with
    the conv bias in beta, so apply(train=False) reproduces the folded
    float network exactly."""
    weights = dequantize_template_weights(template)
    params: Dict = {}
    stats: Dict = {}
    for op_idx, path in FLAX_TO_TEMPLATE_OP.items():
        w, b = weights[op_idx]
        if path.endswith("dw"):
            kernel = w.transpose(1, 2, 0, 3)      # [1,3,3,C] -> HWIO [3,3,1,C]
        else:
            kernel = w.transpose(1, 2, 3, 0)      # OHWI -> HWIO
        c = b.shape[0]
        _set_path(params, path, {
            "conv": {"kernel": np.asarray(kernel, np.float32)},
            "bn": {"scale": np.ones(c, np.float32),
                   "bias": np.asarray(b, np.float32)},
        })
        _set_path(stats, path, {
            "bn": {"mean": np.zeros(c, np.float32),
                   "var": np.full(c, 1.0 - eps, np.float32)},
        })
    return {"params": params, "batch_stats": stats}
