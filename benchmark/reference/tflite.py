"""A plain reader of int8 ``.tflite`` files, and the spatial retarget.

The benchmark's own copy: it imports nothing of the program.  It reads the
first subgraph of a TFLite flatbuffer (schema v3 field ids, as in the
public ``schema.fbs``) into plain dictionaries: each tensor's shape,
dtype, per-tensor or per-channel scales and zero points and constant
data; each op's name, inputs, outputs and options.  ``retarget`` scales
every 4-d activation's height and width, which is how the same weights
run at 448 x 448 (a fully convolutional graph keeps its weights, strides
and pads; SAME pads are derived from the new shapes when the op runs).
"""

from __future__ import annotations

import copy
import struct

import numpy as np

OPS = {0: "ADD", 2: "CONCATENATION", 3: "CONV_2D", 4: "DEPTHWISE_CONV_2D",
       17: "MAX_POOL_2D", 34: "PAD", 98: "LEAKY_RELU", 114: "QUANTIZE"}
DTYPES = {0: np.float32, 2: np.int32, 3: np.uint8, 4: np.int64, 9: np.int8}
PADDING = {0: "SAME", 1: "VALID"}


class _Table:
    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_len = struct.unpack_from("<H", buf, self.vt)[0]

    def _field(self, i):
        off = 4 + 2 * i
        if off >= self.vt_len:
            return None
        rel = struct.unpack_from("<H", self.buf, self.vt + off)[0]
        return self.pos + rel if rel else None

    def _deref(self, p):
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def scalar(self, i, fmt, default=0):
        p = self._field(i)
        return default if p is None else struct.unpack_from(
            "<" + fmt, self.buf, p)[0]

    def table(self, i):
        p = self._field(i)
        return None if p is None else _Table(self.buf, self._deref(p))

    def _vector(self, i):
        p = self._field(i)
        if p is None:
            return 0, 0
        v = self._deref(p)
        return v + 4, struct.unpack_from("<I", self.buf, v)[0]

    def scalars(self, i, fmt):
        start, n = self._vector(i)
        size = struct.calcsize(fmt)
        return [struct.unpack_from("<" + fmt, self.buf, start + k * size)[0]
                for k in range(n)]

    def raw(self, i):
        start, n = self._vector(i)
        return self.buf[start:start + n]

    def tables(self, i):
        start, n = self._vector(i)
        return [_Table(self.buf, self._deref(start + 4 * k))
                for k in range(n)]


def _options(name, t):
    if t is None:
        return {}
    if name == "CONV_2D":
        return {"padding": PADDING[t.scalar(0, "b")],
                "stride": (t.scalar(2, "i"), t.scalar(1, "i"))}
    if name == "DEPTHWISE_CONV_2D":
        return {"padding": PADDING[t.scalar(0, "b")],
                "stride": (t.scalar(2, "i"), t.scalar(1, "i"))}
    if name == "MAX_POOL_2D":
        return {"padding": PADDING[t.scalar(0, "b")],
                "stride": (t.scalar(2, "i"), t.scalar(1, "i")),
                "filter": (t.scalar(4, "i"), t.scalar(3, "i"))}
    if name == "CONCATENATION":
        return {"axis": t.scalar(0, "i")}
    if name == "LEAKY_RELU":
        return {"alpha": t.scalar(0, "f")}
    return {}


def read(path) -> dict:
    """``{"tensors": [...], "ops": [...], "inputs": [...], "outputs":
    [...]}`` of the file's first subgraph.  A tensor is a dict with
    ``shape``, ``dtype``, ``scales``, ``zps`` and ``data`` (None for an
    activation); an op a dict with ``name``, ``inputs``, ``outputs`` and
    its options."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[4:8] != b"TFL3":
        raise ValueError(f"{path}: not a TFLite flatbuffer")
    model = _Table(buf, struct.unpack_from("<I", buf, 0)[0])
    codes = [max(oc.scalar(0, "b"), oc.scalar(3, "i"))
             for oc in model.tables(1)]
    buffers = model.tables(4)
    sg = model.tables(2)[0]
    tensors = []
    for tt in sg.tables(0):
        shape = tuple(tt.scalars(0, "i"))
        dtype = np.dtype(DTYPES[tt.scalar(1, "b")])
        q = tt.table(4)
        scales = tuple(q.scalars(2, "f")) if q is not None else ()
        zps = tuple(q.scalars(3, "q")) if q is not None else ()
        raw = buffers[tt.scalar(2, "I")].raw(0)
        data = (np.frombuffer(raw, dtype).reshape(shape).copy()
                if raw else None)
        tensors.append({"shape": shape, "dtype": dtype, "scales": scales,
                        "zps": zps, "data": data})
    ops = []
    for ot in sg.tables(3):
        code = codes[ot.scalar(0, "I")]
        if code not in OPS:
            raise NotImplementedError(f"op code {code} in {path}")
        name = OPS[code]
        ops.append({"name": name, "inputs": ot.scalars(1, "i"),
                    "outputs": ot.scalars(2, "i"),
                    **_options(name, ot.table(4))})
    return {"tensors": tensors, "ops": ops, "inputs": sg.scalars(1, "i"),
            "outputs": sg.scalars(2, "i")}


def retarget(graph: dict, factor: int) -> dict:
    """``graph`` with every 4-d activation's H and W times ``factor``."""
    g = copy.deepcopy(graph)
    for t in g["tensors"]:
        if t["data"] is None and len(t["shape"]) == 4:
            n, h, w, c = t["shape"]
            t["shape"] = (n, h * factor, w * factor, c)
    return g


def macs_per_frame(graph: dict) -> int:
    """Multiply-adds of one frame: every weight element once an output
    pixel of its (depthwise) conv."""
    macs = 0
    for op in graph["ops"]:
        if op["name"] in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            w = graph["tensors"][op["inputs"][1]]["shape"]
            _, oh, ow, _ = graph["tensors"][op["outputs"][0]]["shape"]
            macs += int(np.prod(w)) * oh * ow
    return macs
