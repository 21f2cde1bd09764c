"""Spatial retargeting of fully-convolutional int8 graphs (numpy only).

A copy of ``yoloface_tpu.graph.retarget.retarget_spatial``: that package
imports jax as soon as any of its modules is imported.  The yoloface family
is fully convolutional, so the same weights run at any input resolution
that keeps the pooling alignments (multiples of 56):

  * activation tensors scale their H, W dims by ``factor``;
  * constants (weights, biases, PAD parameter tensors) are untouched --
    darknet top-left pads stay 1 px, strides stay 2; an absorbed PAD's
    declared output shape is scaled too, so it no longer equals its input
    plus the pads (the lowerings read the pads, not that shape);
  * SAME paddings are re-derived from the new shapes at lowering time;
  * per-tensor quantization parameters ride along unchanged;
  * the size constant of RESIZE_NEAREST_NEIGHBOR is rewritten to
    ``factor`` times the old size.

At ``factor`` 8 the corpus model takes 448x448x3 frames to a 56x56x18
output, 65,856,000 MACs a frame: the 448 family.
"""

from __future__ import annotations

import dataclasses
from typing import Set

from yoloface_tpu_torch.graph.ir import GraphDef

_SPATIAL_OPS = {
    "CONV_2D", "DEPTHWISE_CONV_2D", "MAX_POOL_2D", "AVERAGE_POOL_2D",
    "PAD", "ADD", "CONCATENATION", "LEAKY_RELU", "QUANTIZE", "RELU",
    "RELU6", "LOGISTIC", "MUL", "SUB", "RESIZE_NEAREST_NEIGHBOR",
}


def retarget_spatial(graph: GraphDef, factor: int) -> GraphDef:
    """Clone ``graph`` with every activation's H, W scaled by ``factor``.

    Only fully-convolutional graphs are supported: an op outside the
    known spatially-covariant set (e.g. FULLY_CONNECTED, RESHAPE with a
    baked shape) raises, because its semantics do not scale.
    """
    if factor < 1 or int(factor) != factor:
        raise ValueError(f"factor must be a positive integer, got {factor}")
    for op in graph.ops:
        if op.opname not in _SPATIAL_OPS:
            raise NotImplementedError(
                f"retarget_spatial: op {op.opname} (#{op.index}) is not "
                "spatially covariant; only fully-convolutional graphs "
                "can be retargeted")

    # activations = non-const tensors referenced by ops / graph io
    referenced: Set[int] = set(graph.inputs) | set(graph.outputs)
    for op in graph.ops:
        referenced.update(i for i in op.inputs if i >= 0)
        referenced.update(op.outputs)

    tensors = []
    for t in graph.tensors:
        if (t.index in referenced and not t.is_const
                and len(t.shape) == 4):
            n, h, w, c = t.shape
            t = dataclasses.replace(
                t, shape=(n, h * factor, w * factor, c))
        tensors.append(t)
    ops = [dataclasses.replace(o, inputs=list(o.inputs),
                               outputs=list(o.outputs), attrs=dict(o.attrs))
           for o in graph.ops]

    # RESIZE_NEAREST_NEIGHBOR carries its output H,W as a (2,) int32 const
    # second input; rewrite it to factor*old so an exported flatbuffer
    # resizes to the new resolution
    size_idx: Set[int] = {op.inputs[1] for op in ops
                          if op.opname == "RESIZE_NEAREST_NEIGHBOR"}
    for i, t in enumerate(tensors):
        if t.index in size_idx and t.is_const:
            tensors[i] = dataclasses.replace(
                t, data=(t.data * factor).astype(t.data.dtype))
    return GraphDef(tensors=tensors, ops=ops,
                    inputs=list(graph.inputs), outputs=list(graph.outputs),
                    name=f"{graph.name}@{factor}x",
                    description=graph.description)
