"""Turn a ``yoloface_tpu`` GraphDef into the port's own, field by field.

Both packages then compute on the same weights and quantization constants
in the parity tests.  Only attributes are read; nothing of ``yoloface_tpu``
is imported.
"""

from __future__ import annotations

import numpy as np

from yoloface_tpu_torch.graph.ir import GraphDef, OpDef, QParams, TensorDef


def _qparams(q) -> QParams | None:
    if q is None:
        return None
    return QParams(tuple(float(s) for s in q.scales),
                   tuple(int(z) for z in q.zero_points),
                   int(q.quantized_dimension))


def graph_from_jax(g) -> GraphDef:
    """A ``yoloface_tpu.graph.ir.GraphDef`` (or anything with its fields)
    -> the port's ``GraphDef``.  Constant data is copied."""
    tensors = [
        TensorDef(int(t.index), str(t.name), tuple(int(d) for d in t.shape),
                  np.dtype(t.dtype), _qparams(t.qparams),
                  None if t.data is None else np.array(t.data, copy=True))
        for t in g.tensors]
    ops = [OpDef(int(op.index), str(op.opname), [int(i) for i in op.inputs],
                 [int(o) for o in op.outputs], dict(op.attrs))
           for op in g.ops]
    return GraphDef(tensors, ops, [int(i) for i in g.inputs],
                    [int(o) for o in g.outputs], g.name, g.description)
