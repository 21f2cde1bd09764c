"""Standalone TFLite flatbuffer importer → :class:`~yoloface_tpu_torch.graph.ir.GraphDef`.

Reads ``.tflite`` files (such as ``checkpoints/yoloface_corpus_int8.tflite``)
without TensorFlow or generated flatbuffer bindings.  A copy of
``yoloface_tpu.io.tflite_import`` that builds the port's own ``GraphDef``.
Field ids below follow the public TFLite ``schema.fbs`` (stable since
schema v3).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List

import numpy as np

from yoloface_tpu_torch.graph.ir import GraphDef, OpDef, QParams, TensorDef
from yoloface_tpu_torch.io.flatbuf import Table, root_table

# schema.fbs: enum BuiltinOperator (subset is enough for this model family;
# unknown codes fall back to "BUILTIN_<code>").
BUILTIN_OPS: Dict[int, str] = {
    0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION", 3: "CONV_2D",
    4: "DEPTHWISE_CONV_2D", 9: "FULLY_CONNECTED", 14: "LOGISTIC",
    17: "MAX_POOL_2D", 18: "MUL", 22: "RESHAPE", 25: "SOFTMAX",
    19: "RELU", 20: "RELU_N1_TO_1", 21: "RELU6", 28: "TANH", 34: "PAD",
    45: "RESIZE_BILINEAR", 47: "SPACE_TO_DEPTH", 49: "SQUEEZE",
    53: "STRIDED_SLICE", 73: "LOG", 76: "SQRT", 77: "RSQRT",
    83: "PACK", 87: "LOGICAL_OR", 97: "RESIZE_NEAREST_NEIGHBOR",
    98: "LEAKY_RELU", 114: "QUANTIZE", 6: "DEQUANTIZE",
}

# schema.fbs: enum TensorType
TENSOR_DTYPES: Dict[int, np.dtype] = {
    0: np.dtype(np.float32), 1: np.dtype(np.float16), 2: np.dtype(np.int32),
    3: np.dtype(np.uint8), 4: np.dtype(np.int64), 6: np.dtype(np.bool_),
    7: np.dtype(np.int16), 9: np.dtype(np.int8), 10: np.dtype(np.float64),
    13: np.dtype(np.uint32),
}

_PADDING = {0: "SAME", 1: "VALID"}
_ACTIVATION = {0: "NONE", 1: "RELU", 2: "RELU_N1_TO_1", 3: "RELU6",
               4: "TANH", 5: "SIGN_BIT"}


def _conv2d_options(t: Table) -> Dict[str, Any]:
    return {
        "padding": _PADDING[t.scalar(0, "i8", 0)],
        "stride_w": t.scalar(1, "i32", 0),
        "stride_h": t.scalar(2, "i32", 0),
        "activation": _ACTIVATION[t.scalar(3, "i8", 0)],
        "dilation_w": t.scalar(4, "i32", 1),
        "dilation_h": t.scalar(5, "i32", 1),
    }


def _depthwise_options(t: Table) -> Dict[str, Any]:
    return {
        "padding": _PADDING[t.scalar(0, "i8", 0)],
        "stride_w": t.scalar(1, "i32", 0),
        "stride_h": t.scalar(2, "i32", 0),
        "depth_multiplier": t.scalar(3, "i32", 0),
        "activation": _ACTIVATION[t.scalar(4, "i8", 0)],
        "dilation_w": t.scalar(5, "i32", 1),
        "dilation_h": t.scalar(6, "i32", 1),
    }


def _pool2d_options(t: Table) -> Dict[str, Any]:
    return {
        "padding": _PADDING[t.scalar(0, "i8", 0)],
        "stride_w": t.scalar(1, "i32", 0),
        "stride_h": t.scalar(2, "i32", 0),
        "filter_w": t.scalar(3, "i32", 0),
        "filter_h": t.scalar(4, "i32", 0),
        "activation": _ACTIVATION[t.scalar(5, "i8", 0)],
    }


def _concat_options(t: Table) -> Dict[str, Any]:
    return {"axis": t.scalar(0, "i32", 0),
            "activation": _ACTIVATION[t.scalar(1, "i8", 0)]}


def _add_options(t: Table) -> Dict[str, Any]:
    return {"activation": _ACTIVATION[t.scalar(0, "i8", 0)]}


def _leaky_relu_options(t: Table) -> Dict[str, Any]:
    return {"alpha": t.scalar(0, "f32", 0.0)}


def _reshape_options(t: Table) -> Dict[str, Any]:
    return {"new_shape": t.scalar_vector(0, "i32")}


def _fc_options(t: Table) -> Dict[str, Any]:
    return {"activation": _ACTIVATION[t.scalar(0, "i8", 0)]}


def _softmax_options(t: Table) -> Dict[str, Any]:
    return {"beta": t.scalar(0, "f32", 1.0)}


def _resize_nn_options(t: Table) -> Dict[str, Any]:
    return {"align_corners": bool(t.scalar(0, "u8", 0)),
            "half_pixel_centers": bool(t.scalar(1, "u8", 0))}


# Operator.builtin_options is a union; the option-table parser to use is
# keyed by the *resolved op name* (sufficient here — each of these ops has a
# unique options table).
_OPTION_PARSERS = {
    "RESIZE_NEAREST_NEIGHBOR": _resize_nn_options,
    "CONV_2D": _conv2d_options,
    "DEPTHWISE_CONV_2D": _depthwise_options,
    "MAX_POOL_2D": _pool2d_options,
    "AVERAGE_POOL_2D": _pool2d_options,
    "CONCATENATION": _concat_options,
    "ADD": _add_options,
    "LEAKY_RELU": _leaky_relu_options,
    "RESHAPE": _reshape_options,
    "FULLY_CONNECTED": _fc_options,
    "SOFTMAX": _softmax_options,
}


def _read_qparams(qt: Table) -> QParams | None:
    if qt is None:
        return None
    scales = qt.scalar_vector(2, "f32")
    zps = qt.scalar_vector(3, "i64")
    if not scales:
        return None
    qdim = qt.scalar(6, "i32", 0)
    return QParams(tuple(float(s) for s in scales),
                   tuple(int(z) for z in zps), qdim)


def load_tflite(path_or_bytes) -> GraphDef:
    """Parse a .tflite file into a GraphDef (first subgraph)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()

    if len(buf) < 8:
        raise ValueError("not a TFLite flatbuffer: file too small")
    if buf[4:8] != b"TFL3":
        raise ValueError(
            f"not a TFLite flatbuffer: file identifier {buf[4:8]!r} "
            f"(expected b'TFL3')")
    try:
        return _parse(buf)
    except (struct.error, IndexError, KeyError, UnicodeDecodeError) as e:
        raise ValueError(f"malformed TFLite flatbuffer: {e}") from e


def _parse(buf: bytes) -> GraphDef:
    model = root_table(buf)
    # Model: version(0) operator_codes(1) subgraphs(2) description(3) buffers(4)
    version = model.scalar(0, "u32", 0)
    if version != 3:
        raise ValueError(f"unsupported tflite schema version {version}")

    opcodes: List[str] = []
    for oc in model.table_vector(1):
        # OperatorCode: deprecated_builtin_code(0,i8) custom_code(1)
        # version(2) builtin_code(3,i32); real code = max of old/new fields.
        code = max(oc.scalar(0, "i8", 0), oc.scalar(3, "i32", 0))
        custom = oc.string(1)
        opcodes.append(custom if custom else
                       BUILTIN_OPS.get(code, f"BUILTIN_{code}"))

    buffers = model.table_vector(4)  # Buffer: data(0, [ubyte])
    description = model.string(3) or ""

    subgraphs = model.table_vector(2)
    if not subgraphs:
        raise ValueError("tflite model has no subgraphs")
    sg = subgraphs[0]

    # SubGraph: tensors(0) inputs(1) outputs(2) operators(3) name(4)
    tensors: List[TensorDef] = []
    for ti, tt in enumerate(sg.table_vector(0)):
        # Tensor: shape(0) type(1,i8) buffer(2,u32) name(3) quantization(4)
        shape = tuple(tt.scalar_vector(0, "i32"))
        dtype = TENSOR_DTYPES[tt.scalar(1, "i8", 0)]
        buf_idx = tt.scalar(2, "u32", 0)
        name = tt.string(3) or f"tensor_{ti}"
        qparams = _read_qparams(tt.table(4))
        data = None
        if buf_idx < len(buffers):
            raw = buffers[buf_idx].bytes_vector(0)
            if raw:
                data = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
        tensors.append(TensorDef(ti, name, shape, dtype, qparams, data))

    ops: List[OpDef] = []
    for oi, ot in enumerate(sg.table_vector(3)):
        # Operator: opcode_index(0,u32) inputs(1) outputs(2)
        # builtin_options_type(3,u8) builtin_options(4)
        opname = opcodes[ot.scalar(0, "u32", 0)]
        inputs = ot.scalar_vector(1, "i32")
        outputs = ot.scalar_vector(2, "i32")
        attrs: Dict[str, Any] = {}
        parser = _OPTION_PARSERS.get(opname)
        if parser is not None:
            opt_table = ot.table(4)
            if opt_table is not None:
                attrs = parser(opt_table)
        ops.append(OpDef(oi, opname, list(inputs), list(outputs), attrs))

    return GraphDef(
        tensors=tensors,
        ops=ops,
        inputs=list(sg.scalar_vector(1, "i32")),
        outputs=list(sg.scalar_vector(2, "i32")),
        name=sg.string(4) or "main",
        description=description,
    )
