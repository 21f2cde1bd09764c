"""Dependency-free ONNX export of the float yoloface graph.

The counterpart of ``yoloface_tpu.io.onnx_export``, a copy (numpy only):
for the same graph and weights ``export_onnx`` writes the JAX package's
bytes, and ``parse_model`` reads them back to the same structure.

The reference exports its trained float model to ONNX with
``torch.onnx.export`` (`yoloface/pytorch/train.py:355-396`) and serves it
through onnxruntime (`onnx_prediction.py:33-37`).  Neither ``onnx`` nor
``onnxruntime`` is needed here: this module writes the protobuf wire format
itself (as ``io/flatbuf.py`` writes TFLite) and ships a structural reader
(:func:`parse_model`) so tests can verify the emitted bytes without the
onnx package.  The emitted file is a standard opset-13 float ModelProto
(NCHW) that onnxruntime can execute wherever it is installed;
``io/onnx_eval.OnnxEvaluator`` runs it in torch.

Input: a GraphDef template (the deployed int8 topology) plus float weights
``{op_index: (w, b)}`` in TFLite layout (numpy, or tensors on any device)
-- the pair the calibration flow uses (``quantize/calibrate.py::
float_forward``) -- so a trained ``YoloFace`` exports via
``fold_batchnorm(flax_from_state_dict(model))`` and the shipped graph via
``models/import_weights.dequantize_template_weights``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from yoloface_tpu_torch.graph.ir import GraphDef
from yoloface_tpu_torch.ops.int8_ref import _same_pad_amounts

# --------------------------------------------------------------------------
# protobuf wire-format primitives (wire types: 0 varint, 2 len-delimited,
# 5 fixed32)
# --------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def fv(field: int, value: int) -> bytes:
    """varint field"""
    return _key(field, 0) + _varint(value)


def fb(field: int, payload: bytes) -> bytes:
    """length-delimited field (submessage / string / bytes)"""
    return _key(field, 2) + _varint(len(payload)) + payload


def fs(field: int, s: str) -> bytes:
    return fb(field, s.encode("utf-8"))


def ff(field: int, x: float) -> bytes:
    """fixed32 float field"""
    return _key(field, 5) + struct.pack("<f", float(x))


# --------------------------------------------------------------------------
# ONNX message builders
# --------------------------------------------------------------------------
FLOAT = 1           # TensorProto.DataType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_INTS = 1, 2, 3, 7


def attr_i(name: str, v: int) -> bytes:
    return fb(5, fs(1, name) + fv(3, v) + fv(20, ATTR_INT))


def attr_f(name: str, v: float) -> bytes:
    return fb(5, fs(1, name) + ff(2, v) + fv(20, ATTR_FLOAT))


def attr_ints(name: str, vals) -> bytes:
    # AttributeProto.ints is field 8 (field 7 is the repeated float
    # 'floats'); verified against the reference yoloface-50k.onnx, whose
    # 'strides' attribute encodes its values with key 0x40 = field 8.
    return fb(5, fs(1, name) + b"".join(fv(8, int(v)) for v in vals)
              + fv(20, ATTR_INTS))


def node(op_type: str, inputs: List[str], outputs: List[str],
         name: str, *attrs: bytes) -> bytes:
    return fb(1, b"".join(fs(1, i) for i in inputs)
              + b"".join(fs(2, o) for o in outputs)
              + fs(3, name) + fs(4, op_type) + b"".join(attrs))


def _numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):                    # a torch tensor
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(_numpy(arr), dtype=np.float32)
    return fb(5, b"".join(fv(1, d) for d in arr.shape) + fv(2, FLOAT)
              + fs(8, name) + fb(9, arr.tobytes()))


def value_info(name: str, shape) -> bytes:
    dims = b"".join(fb(1, fv(1, int(d))) for d in shape)
    ttype = fv(1, FLOAT) + fb(2, dims)
    return fs(1, name) + fb(2, fb(1, ttype))


# --------------------------------------------------------------------------
# GraphDef (+ float weights) -> ONNX ModelProto bytes
# --------------------------------------------------------------------------
def export_onnx(graph: GraphDef, weights: Dict[int, Tuple[np.ndarray,
                                                          np.ndarray]],
                opset: int = 13) -> bytes:
    """Emit a float NCHW ONNX model of the (fully-convolutional) graph.

    ``weights[op_index] = (w, b)`` in TFLite layout ([Co,kh,kw,Ci] conv /
    [1,kh,kw,C] depthwise); QUANTIZE ops become Identity.
    """
    t = graph.tensor

    def tname(i: int) -> str:
        return f"t{i}"

    nodes: List[bytes] = []
    inits: List[bytes] = []

    # PAD producers absorbed into consumer Conv pads (darknet top-left)
    pad_of: Dict[int, Tuple[int, int, int, int]] = {}
    for op in graph.ops:
        if op.opname == "PAD":
            p = t(op.inputs[1]).data.astype(int)
            # TFLite pad spec rows: [batch, H, W, C] -> (top, left, bot, rt)
            pad_of[op.outputs[0]] = (int(p[1][0]), int(p[2][0]),
                                     int(p[1][1]), int(p[2][1]))

    def conv_pads(op, x_idx, kh, kw) -> Tuple[Tuple[int, int, int, int], int]:
        """(t, l, b, r) pads and the true input tensor index."""
        if x_idx in pad_of:
            src = next(p for p in graph.ops
                       if p.outputs and p.outputs[0] == x_idx)
            return pad_of[x_idx], src.inputs[0]
        if op.attrs.get("padding") == "SAME":
            in_h, in_w = t(x_idx).shape[1], t(x_idx).shape[2]
            (pl, pr) = _same_pad_amounts(in_w, op.attrs["stride_w"], kw)
            (pt, pb) = _same_pad_amounts(in_h, op.attrs["stride_h"], kh)
            return (pt, pl, pb, pr), x_idx
        return (0, 0, 0, 0), x_idx

    for op in graph.ops:
        name = op.opname
        nm = f"{name.lower()}_{op.index}"
        out = tname(op.outputs[0])

        if name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            w, b = (_numpy(a) for a in weights[op.index])
            if name == "CONV_2D":
                wt = np.transpose(w, (0, 3, 1, 2))        # [Co,Ci,kh,kw]
                group = 1
            else:
                wt = np.transpose(w, (3, 0, 1, 2))        # [C,1,kh,kw]
                group = wt.shape[0]
            kh, kw = wt.shape[2], wt.shape[3]
            (pt, pl, pb, pr), x_idx = conv_pads(op, op.inputs[0], kh, kw)
            inits.append(tensor(f"{nm}_w", wt))
            inits.append(tensor(f"{nm}_b", np.asarray(b, np.float32)))
            attrs = [attr_ints("strides", (op.attrs["stride_h"],
                                           op.attrs["stride_w"])),
                     attr_ints("pads", (pt, pl, pb, pr)),
                     attr_ints("kernel_shape", (kh, kw))]
            if group > 1:
                attrs.append(attr_i("group", group))
            nodes.append(node("Conv", [tname(x_idx), f"{nm}_w", f"{nm}_b"],
                              [out], nm, *attrs))
        elif name == "PAD":
            continue                       # absorbed into consumers
        elif name in ("MAX_POOL_2D", "AVERAGE_POOL_2D"):
            kh, kw = op.attrs["filter_h"], op.attrs["filter_w"]
            (pt, pl, pb, pr), x_idx = conv_pads(op, op.inputs[0], kh, kw)
            onnx_op = ("MaxPool" if name == "MAX_POOL_2D"
                       else "AveragePool")
            attrs = [attr_ints("kernel_shape", (kh, kw)),
                     attr_ints("strides", (op.attrs["stride_h"],
                                           op.attrs["stride_w"])),
                     attr_ints("pads", (pt, pl, pb, pr))]
            if onnx_op == "AveragePool":
                attrs.append(attr_i("count_include_pad", 0))
            nodes.append(node(onnx_op, [tname(x_idx)], [out], nm, *attrs))
        elif name == "LEAKY_RELU":
            nodes.append(node("LeakyRelu", [tname(op.inputs[0])], [out],
                              nm, attr_f("alpha", op.attrs["alpha"])))
        elif name == "RELU":
            nodes.append(node("Relu", [tname(op.inputs[0])], [out], nm))
        elif name == "LOGISTIC":
            nodes.append(node("Sigmoid", [tname(op.inputs[0])], [out], nm))
        elif name == "ADD":
            nodes.append(node("Add", [tname(op.inputs[0]),
                                      tname(op.inputs[1])], [out], nm))
        elif name == "CONCATENATION":
            nodes.append(node("Concat", [tname(i) for i in op.inputs],
                              [out], nm, attr_i("axis", 1)))   # NCHW C
        elif name == "QUANTIZE":
            nodes.append(node("Identity", [tname(op.inputs[0])], [out], nm))
        else:
            raise NotImplementedError(f"onnx export: op {name}")

    def nchw(shape):
        n, h, w, c = shape
        return (n, c, h, w)

    gin = graph.inputs[0]
    gout = graph.outputs[0]
    gproto = (b"".join(nodes) + fs(2, "yoloface")
              + b"".join(inits)
              + fb(11, value_info(tname(gin), nchw(t(gin).shape)))
              + fb(12, value_info(tname(gout), nchw(t(gout).shape))))
    model = (fv(1, 8)                          # ir_version
             + fs(2, "yoloface_tpu")           # producer_name
             + fb(8, fs(1, "") + fv(2, opset))  # opset_import
             + fb(7, gproto))
    return model


def save_onnx(graph: GraphDef, weights, path: str) -> None:
    with open(path, "wb") as f:
        f.write(export_onnx(graph, weights))


# --------------------------------------------------------------------------
# structural reader (self-check without the onnx package)
# --------------------------------------------------------------------------
def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field, wire, value) where value is int (wire 0/5) or bytes."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def parse_model(buf: bytes) -> dict:
    """Minimal structural parse: nodes (op_type, inputs, outputs, attrs),
    initializers (name -> (dims, raw float32)), graph io names."""
    out = {"ir_version": None, "opset": None, "nodes": [],
           "initializers": {}, "inputs": [], "outputs": []}
    for field, _, v in _fields(buf):
        if field == 1:
            out["ir_version"] = v
        elif field == 8:
            for f2, _, v2 in _fields(v):
                if f2 == 2:
                    out["opset"] = v2
        elif field == 7:
            for f2, _, v2 in _fields(v):
                if f2 == 1:                      # NodeProto
                    nd = {"op_type": None, "name": None, "inputs": [],
                          "outputs": [], "attrs": {}}
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            nd["inputs"].append(v3.decode())
                        elif f3 == 2:
                            nd["outputs"].append(v3.decode())
                        elif f3 == 3:
                            nd["name"] = v3.decode()
                        elif f3 == 4:
                            nd["op_type"] = v3.decode()
                        elif f3 == 5:            # AttributeProto
                            a = {"ints": []}
                            for f4, w4, v4 in _fields(v3):
                                if f4 == 1:
                                    a["name"] = v4.decode()
                                elif f4 == 2:
                                    a["f"] = v4
                                elif f4 == 3:
                                    a["i"] = v4
                                elif f4 == 8:
                                    a["ints"].append(v4)
                            nd["attrs"][a["name"]] = a
                    out["nodes"].append(nd)
                elif f2 == 5:                    # TensorProto
                    dims, nm, raw = [], None, b""
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            dims.append(v3)
                        elif f3 == 8:
                            nm = v3.decode()
                        elif f3 == 9:
                            raw = v3
                    out["initializers"][nm] = (
                        tuple(dims),
                        np.frombuffer(raw, np.float32).reshape(dims))
                elif f2 in (11, 12):
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            key = "inputs" if f2 == 11 else "outputs"
                            out[key].append(v3.decode())
    return out
