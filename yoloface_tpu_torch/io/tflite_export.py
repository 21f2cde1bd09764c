"""TFLite flatbuffer exporter: GraphDef -> ``.tflite`` bytes.

The counterpart of ``yoloface_tpu.io.tflite_export`` (the reference's
converters, `yoloface/tflite/tflite_quantize.py`): a calibrated int8
GraphDef from :mod:`yoloface_tpu_torch.quantize.calibrate` serializes to a
standard TFLite flatbuffer that reads back through the port's importer and
JAX's to the graph that was written and runs in the stock
``tf.lite.Interpreter``.

Without the ``flatbuffers`` package: the port's own
:class:`~yoloface_tpu_torch.io.flatbuf.Builder` takes the same calls in the
same order as JAX's exporter makes on ``flatbuffers.Builder``, so the bytes
are JAX's.  Field slot ids follow the public TFLite ``schema.fbs``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from yoloface_tpu_torch.graph.ir import GraphDef, OpDef
from yoloface_tpu_torch.io.flatbuf import Builder

# schema.fbs enum values
_BUILTIN_CODE = {
    "ADD": 0, "CONCATENATION": 2, "CONV_2D": 3, "DEPTHWISE_CONV_2D": 4,
    "MAX_POOL_2D": 17, "PAD": 34, "LEAKY_RELU": 98, "QUANTIZE": 114,
    "AVERAGE_POOL_2D": 1, "RESHAPE": 22, "LOGISTIC": 14,
    "RELU": 19, "RELU_N1_TO_1": 20, "RELU6": 21,
    "FULLY_CONNECTED": 9, "SOFTMAX": 25,
    "RESIZE_NEAREST_NEIGHBOR": 97,
}
_OPTIONS_TYPE = {   # BuiltinOptions union discriminants
    "CONV_2D": 1, "DEPTHWISE_CONV_2D": 2, "MAX_POOL_2D": 5,
    "AVERAGE_POOL_2D": 5, "CONCATENATION": 10, "ADD": 11, "PAD": 22,
    "LEAKY_RELU": 75, "QUANTIZE": 89, "RESHAPE": 17,
    "FULLY_CONNECTED": 8, "SOFTMAX": 9,
    "RESIZE_NEAREST_NEIGHBOR": 74,
}
_OP_VERSION = {"CONV_2D": 3, "DEPTHWISE_CONV_2D": 3, "ADD": 2,
               "MAX_POOL_2D": 2, "CONCATENATION": 2, "PAD": 2,
               "LEAKY_RELU": 2, "QUANTIZE": 2, "FULLY_CONNECTED": 4,
               "SOFTMAX": 2}
_DTYPE_CODE = {np.dtype(np.float32): 0, np.dtype(np.int32): 2,
               np.dtype(np.uint8): 3, np.dtype(np.int64): 4,
               np.dtype(np.int8): 9}
_PADDING = {"SAME": 0, "VALID": 1}
_ACTIVATION = {"NONE": 0, "RELU": 1, "RELU_N1_TO_1": 2, "RELU6": 3,
               "TANH": 4, "SIGN_BIT": 5}


def _vector(b: Builder, kind: str, size: int, vals) -> int:
    b.start_vector(size, len(vals), size)
    for v in reversed(list(vals)):
        b.prepend(kind, float(v) if kind == "f32" else int(v))
    return b.end_vector()


def _vec_i32(b: Builder, vals) -> int:
    return _vector(b, "i32", 4, vals)


def _vec_i64(b: Builder, vals) -> int:
    return _vector(b, "i64", 8, vals)


def _vec_f32(b: Builder, vals) -> int:
    return _vector(b, "f32", 4, vals)


def _vec_offsets(b: Builder, offs) -> int:
    b.start_vector(4, len(offs), 4)
    for o in reversed(list(offs)):
        b.prepend_offset(o)
    return b.end_vector()


_SLOT_CONVERT = {"i8": int, "i32": int, "u32": int, "f32": float}


def _table(b: Builder, slots: List[tuple]) -> int:
    """slots: (slot_id, kind, value[, default]) — kind in
    {i8,i32,u32,f32,off}."""
    b.start_object(max(s[0] for s in slots) + 1 if slots else 0)
    for slot in slots:
        sid, kind, val = slot[0], slot[1], slot[2]
        default = slot[3] if len(slot) > 3 else 0
        if kind == "off":
            b.prepend_offset_slot(sid, val)
        elif kind in _SLOT_CONVERT:
            b.prepend_slot(sid, kind, _SLOT_CONVERT[kind](val), default)
        else:
            raise ValueError(kind)
    return b.end_object()


def _builtin_options(b: Builder, op: OpDef) -> int:
    a = op.attrs
    name = op.opname
    if name == "CONV_2D":
        return _table(b, [
            (0, "i8", _PADDING[a["padding"]]),
            (1, "i32", a["stride_w"]), (2, "i32", a["stride_h"]),
            (3, "i8", _ACTIVATION[a["activation"]]),
            (4, "i32", a.get("dilation_w", 1), 1),
            (5, "i32", a.get("dilation_h", 1), 1)])
    if name == "DEPTHWISE_CONV_2D":
        return _table(b, [
            (0, "i8", _PADDING[a["padding"]]),
            (1, "i32", a["stride_w"]), (2, "i32", a["stride_h"]),
            (3, "i32", a.get("depth_multiplier", 1)),
            (4, "i8", _ACTIVATION[a["activation"]]),
            (5, "i32", a.get("dilation_w", 1), 1),
            (6, "i32", a.get("dilation_h", 1), 1)])
    if name in ("MAX_POOL_2D", "AVERAGE_POOL_2D"):
        return _table(b, [
            (0, "i8", _PADDING[a["padding"]]),
            (1, "i32", a["stride_w"]), (2, "i32", a["stride_h"]),
            (3, "i32", a["filter_w"]), (4, "i32", a["filter_h"]),
            (5, "i8", _ACTIVATION[a["activation"]])])
    if name == "CONCATENATION":
        return _table(b, [(0, "i32", a["axis"]),
                          (1, "i8", _ACTIVATION[a["activation"]])])
    if name == "ADD":
        return _table(b, [(0, "i8", _ACTIVATION[a["activation"]])])
    if name == "LEAKY_RELU":
        return _table(b, [(0, "f32", a["alpha"])])
    if name in ("PAD", "QUANTIZE"):
        return _table(b, [])
    if name == "RESHAPE":
        shape_off = _vec_i32(b, a["new_shape"])
        return _table(b, [(0, "off", shape_off)])
    if name == "FULLY_CONNECTED":
        return _table(b, [(0, "i8", _ACTIVATION[a.get("activation",
                                                      "NONE")])])
    if name == "SOFTMAX":
        return _table(b, [(0, "f32", a.get("beta", 1.0))])
    if name == "RESIZE_NEAREST_NEIGHBOR":
        return _table(b, [(0, "i8", 1 if a.get("align_corners") else 0, 0),
                          (1, "i8",
                           1 if a.get("half_pixel_centers") else 0, 0)])
    return None  # ops without a builtin-options table (LOGISTIC, RELU, ...)


def export_tflite(graph: GraphDef) -> bytes:
    b = Builder(1024 * 1024)

    # ---- buffers: index 0 empty; constants get their own buffer ----------
    tensor_buffer_idx: Dict[int, int] = {}
    buffer_offsets: List[int] = []

    def make_buffer(data_off) -> int:
        return _table(b, [(0, "off", data_off)] if data_off else [])

    # buffer 0 (empty, by convention)
    empty_buf = _table(b, [])
    buffer_offsets.append(empty_buf)
    for t in graph.tensors:
        if t.is_const:
            data = np.ascontiguousarray(t.data)
            off = b.create_bytes(data.tobytes())
            buffer_offsets.append(make_buffer(off))
            tensor_buffer_idx[t.index] = len(buffer_offsets) - 1
        else:
            tensor_buffer_idx[t.index] = 0

    # ---- tensors ---------------------------------------------------------
    tensor_offsets: List[int] = []
    for t in graph.tensors:
        name_off = b.create_string(t.name)
        shape_off = _vec_i32(b, t.shape)
        q_off = 0
        if t.qparams is not None:
            scales_off = _vec_f32(b, t.qparams.scales)
            zps_off = _vec_i64(b, t.qparams.zero_points)
            q_off = _table(b, [
                (2, "off", scales_off), (3, "off", zps_off),
                (6, "i32", t.qparams.quantized_dimension)])
        slots = [(0, "off", shape_off),
                 (1, "i8", _DTYPE_CODE[np.dtype(t.dtype)]),
                 (2, "u32", tensor_buffer_idx[t.index]),
                 (3, "off", name_off)]
        if q_off:
            slots.append((4, "off", q_off))
        tensor_offsets.append(_table(b, slots))

    # ---- operator codes --------------------------------------------------
    opnames = sorted({op.opname for op in graph.ops})
    opcode_index = {n: i for i, n in enumerate(opnames)}
    opcode_offsets = []
    for n in opnames:
        code = _BUILTIN_CODE[n]
        slots = [(2, "i32", _OP_VERSION.get(n, 1), 1),
                 (3, "i32", code)]
        if code <= 127:
            slots.insert(0, (0, "i8", code))
        opcode_offsets.append(_table(b, slots))

    # ---- operators -------------------------------------------------------
    operator_offsets = []
    for op in graph.ops:
        inputs_off = _vec_i32(b, op.inputs)
        outputs_off = _vec_i32(b, op.outputs)
        opts_off = _builtin_options(b, op)
        slots = [(0, "u32", opcode_index[op.opname]),
                 (1, "off", inputs_off), (2, "off", outputs_off)]
        if opts_off is not None:
            slots += [(3, "i8", _OPTIONS_TYPE.get(op.opname, 0)),
                      (4, "off", opts_off)]
        operator_offsets.append(_table(b, slots))

    # ---- subgraph / model ------------------------------------------------
    tensors_vec = _vec_offsets(b, tensor_offsets)
    sg_inputs = _vec_i32(b, graph.inputs)
    sg_outputs = _vec_i32(b, graph.outputs)
    operators_vec = _vec_offsets(b, operator_offsets)
    sg_name = b.create_string(graph.name)
    subgraph = _table(b, [
        (0, "off", tensors_vec), (1, "off", sg_inputs),
        (2, "off", sg_outputs), (3, "off", operators_vec),
        (4, "off", sg_name)])
    subgraphs_vec = _vec_offsets(b, [subgraph])
    opcodes_vec = _vec_offsets(b, opcode_offsets)
    buffers_vec = _vec_offsets(b, buffer_offsets)
    # JAX's default description, so an export is byte for byte JAX's
    desc = b.create_string(graph.description
                           or "exported by yoloface_tpu.io.tflite_export")
    model = _table(b, [
        (0, "u32", 3),                       # schema version
        (1, "off", opcodes_vec), (2, "off", subgraphs_vec),
        (3, "off", desc), (4, "off", buffers_vec)])
    return b.finish(model, b"TFL3")


def save_tflite(graph: GraphDef, path: str) -> None:
    with open(path, "wb") as f:
        f.write(export_tflite(graph))
