"""Minimal, dependency-free FlatBuffers reader.

A generic cursor over a flatbuffer binary: just enough of the wire format
(tables + vtables, vectors, strings, scalars, structs) to read TFLite model
files without the generated schema bindings.  Used by
:mod:`yoloface_tpu_torch.io.tflite_import`.

Wire format recap:
  * root: uint32 offset at byte 0 to the root table.
  * table: int32 soffset to its vtable (``vtable_pos = table_pos - soffset``).
  * vtable: uint16 vtable_size, uint16 table_size, then one uint16 per field
    (offset of the field relative to the table position; 0 = absent).
  * vector: uint32 length followed by packed elements.
  * string: uint32 length followed by utf-8 bytes.
"""

from __future__ import annotations

import struct
from typing import Optional

__all__ = ["Table", "root_table"]

_U8 = struct.Struct("<B")
_I8 = struct.Struct("<b")
_U16 = struct.Struct("<H")
_I16 = struct.Struct("<h")
_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")

_SCALAR = {
    "u8": _U8, "i8": _I8, "u16": _U16, "i16": _I16,
    "u32": _U32, "i32": _I32, "u64": _U64, "i64": _I64,
    "f32": _F32, "f64": _F64,
}


class Table:
    """A lazy view of one flatbuffer table."""

    __slots__ = ("buf", "pos", "_vtable", "_vtable_len")

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        soffset = _I32.unpack_from(buf, pos)[0]
        self._vtable = pos - soffset
        self._vtable_len = _U16.unpack_from(buf, self._vtable)[0]

    # -- field addressing ---------------------------------------------------
    def _field_pos(self, field_id: int) -> Optional[int]:
        """Absolute position of field ``field_id``; None if absent."""
        vt_off = 4 + 2 * field_id
        if vt_off >= self._vtable_len:
            return None
        rel = _U16.unpack_from(self.buf, self._vtable + vt_off)[0]
        if rel == 0:
            return None
        return self.pos + rel

    def _indirect(self, pos: int) -> int:
        return pos + _U32.unpack_from(self.buf, pos)[0]

    # -- scalar fields ------------------------------------------------------
    def scalar(self, field_id: int, kind: str, default=0):
        p = self._field_pos(field_id)
        if p is None:
            return default
        return _SCALAR[kind].unpack_from(self.buf, p)[0]

    # -- offset fields ------------------------------------------------------
    def table(self, field_id: int) -> Optional["Table"]:
        p = self._field_pos(field_id)
        if p is None:
            return None
        return Table(self.buf, self._indirect(p))

    def string(self, field_id: int) -> Optional[str]:
        p = self._field_pos(field_id)
        if p is None:
            return None
        vpos = self._indirect(p)
        n = _U32.unpack_from(self.buf, vpos)[0]
        return self.buf[vpos + 4 : vpos + 4 + n].decode("utf-8")

    # -- vector fields ------------------------------------------------------
    def _vector(self, field_id: int):
        """(element_start, length) of a vector field; None if absent."""
        p = self._field_pos(field_id)
        if p is None:
            return None
        vpos = self._indirect(p)
        n = _U32.unpack_from(self.buf, vpos)[0]
        return vpos + 4, n

    def vector_len(self, field_id: int) -> int:
        v = self._vector(field_id)
        return 0 if v is None else v[1]

    def scalar_vector(self, field_id: int, kind: str) -> list:
        v = self._vector(field_id)
        if v is None:
            return []
        start, n = v
        st = _SCALAR[kind]
        return [st.unpack_from(self.buf, start + i * st.size)[0] for i in range(n)]

    def bytes_vector(self, field_id: int) -> bytes:
        """A [ubyte] vector as raw bytes (zero-copy slice)."""
        v = self._vector(field_id)
        if v is None:
            return b""
        start, n = v
        return self.buf[start : start + n]

    def table_vector(self, field_id: int) -> list:
        v = self._vector(field_id)
        if v is None:
            return []
        start, n = v
        out = []
        for i in range(n):
            epos = start + 4 * i
            out.append(Table(self.buf, self._indirect(epos)))
        return out


def root_table(buf: bytes) -> Table:
    return Table(buf, _U32.unpack_from(buf, 0)[0])
