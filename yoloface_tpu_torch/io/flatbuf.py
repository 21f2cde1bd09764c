"""Minimal, dependency-free FlatBuffers reader and writer.

A generic cursor over a flatbuffer binary: just enough of the wire format
(tables + vtables, vectors, strings, scalars, structs) to read TFLite model
files without the generated schema bindings.  Used by
:mod:`yoloface_tpu_torch.io.tflite_import`.  ``Builder`` writes one, back to
front, with the ``flatbuffers`` package's algorithm (alignment, vtable
sharing, trailing-default trimming), so the same calls give the same bytes;
used by :mod:`yoloface_tpu_torch.io.tflite_export`.

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

__all__ = ["Builder", "Table", "root_table"]

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


class Builder:
    """Builds a flatbuffer back to front, as ``flatbuffers.Builder`` does.

    Offsets are counted from the end of the buffer.  ``prepend_slot``
    skips a scalar equal to its default and ``end_object`` shares a vtable
    with an earlier table of the same layout, so a field left at its
    default takes no bytes.
    """

    def __init__(self, size: int = 1024):
        self.buf = bytearray(size)
        self.head = size
        self.minalign = 1
        self._vtable: Optional[list] = None
        self._object_end = 0
        self._vtables: dict = {}
        self._vector_len = 0

    def offset(self) -> int:
        return len(self.buf) - self.head

    def _prep(self, size: int, additional: int) -> None:
        """Align so that ``size`` bytes land aligned after ``additional``
        more bytes are written, growing the buffer as needed."""
        self.minalign = max(self.minalign, size)
        align = (-(len(self.buf) - self.head + additional)) & (size - 1)
        while self.head < align + size + additional:
            old = len(self.buf)
            grown = bytearray(max(2 * old, 1))
            grown[len(grown) - old:] = self.buf
            self.head += len(grown) - old
            self.buf = grown
        self.head -= align
        self.buf[self.head:self.head + align] = bytes(align)

    def _place(self, st: struct.Struct, value) -> None:
        self.head -= st.size
        st.pack_into(self.buf, self.head, value)

    def prepend(self, kind: str, value) -> None:
        st = _SCALAR[kind]
        self._prep(st.size, 0)
        self._place(st, value)

    def prepend_offset(self, off: int) -> None:
        """A uoffset to ``off``, relative to where it is written."""
        self._prep(4, 0)
        self._place(_U32, self.offset() - off + 4)

    # -- tables -------------------------------------------------------------
    def start_object(self, num_fields: int) -> None:
        self._vtable = [0] * num_fields
        self._object_end = self.offset()

    def prepend_slot(self, field_id: int, kind: str, value, default=0):
        if value != default:
            self.prepend(kind, value)
            self._vtable[field_id] = self.offset()

    def prepend_offset_slot(self, field_id: int, off: int) -> None:
        if off != 0:
            self.prepend_offset(off)
            self._vtable[field_id] = self.offset()

    def end_object(self) -> int:
        self.prepend("i32", 0)              # the vtable soffset, set below
        obj = self.offset()
        fields = [obj - f if f else 0 for f in self._vtable]
        while fields and fields[-1] == 0:   # trailing defaults take no slot
            fields.pop()
        key = (tuple(fields), obj - self._object_end)
        vt = self._vtables.get(key)
        if vt is None:
            for f in reversed(fields):
                self.prepend("u16", f)
            self.prepend("u16", obj - self._object_end)
            self.prepend("u16", (len(fields) + 2) * 2)
            _I32.pack_into(self.buf, len(self.buf) - obj,
                           self.offset() - obj)
            self._vtables[key] = self.offset()
        else:                               # point at the earlier vtable
            self.head = len(self.buf) - obj
            _I32.pack_into(self.buf, self.head, vt - obj)
        self._vtable = None
        return obj

    # -- vectors and strings -------------------------------------------------
    def start_vector(self, elem_size: int, n: int, alignment: int) -> None:
        self._vector_len = n
        self._prep(4, elem_size * n)
        self._prep(alignment, elem_size * n)

    def end_vector(self) -> int:
        self._place(_U32, self._vector_len)
        return self.offset()

    def create_bytes(self, data: bytes, terminator: bool = False) -> int:
        self._prep(4, len(data) + terminator)
        if terminator:
            self._place(_U8, 0)
        self.head -= len(data)
        self.buf[self.head:self.head + len(data)] = data
        self._vector_len = len(data)
        return self.end_vector()

    def create_string(self, s: str) -> int:
        return self.create_bytes(s.encode("utf-8"), terminator=True)

    def finish(self, root: int, file_identifier: bytes) -> bytes:
        self._prep(self.minalign, 8)
        self._prep(4, 4)
        for byte in reversed(file_identifier):
            self._place(_U8, byte)
        self.prepend_offset(root)
        return bytes(self.buf[self.head:])
