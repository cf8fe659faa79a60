"""Thrift compact protocol: the reader and writer of Parquet's metadata.

Copied from spark_rapids_tpu/io/parquet_device.py:_Compact (:64, the
reader of page headers) and io/parquet_encode_device.py:_CompactWriter
(:256, the footer writer), so the port reads `FileMetaData` as well as
`PageHeader` without pyarrow. The reader returns a struct as
{field id: value}; nested structs recurse, lists become Python lists,
integers ints, binary and strings bytes. One change from the copy: list
elements of type bool take one byte each, as the protocol writes them (the
reference's reader took none; Parquet's metadata has no such list).
"""

from __future__ import annotations

from typing import List


class Compact:
    """TCompactProtocol reader over `buf` from `pos`."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        out = shift = 0
        while True:
            if shift > 63:
                raise ValueError("malformed varint")
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def struct(self) -> dict:
        out = {}
        fid = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            if b == 0:
                return out
            delta = b >> 4
            ftype = b & 0x0F
            fid = fid + delta if delta else self.zigzag()
            out[fid] = self._value(ftype)

    def _value(self, ftype: int, in_list: bool = False):
        if ftype in (1, 2):
            if in_list:                 # list bools: one byte each
                v = self.buf[self.pos]
                self.pos += 1
                return v == 1
            return ftype == 1
        if ftype == 3:
            v = self.buf[self.pos]
            self.pos += 1
            return v - 256 if v > 127 else v
        if ftype in (4, 5, 6):
            return self.zigzag()
        if ftype == 7:
            v = self.buf[self.pos:self.pos + 8]
            self.pos += 8
            return v
        if ftype == 8:
            n = self.varint()
            v = self.buf[self.pos:self.pos + n]
            self.pos += n
            return bytes(v)
        if ftype in (9, 10):
            b = self.buf[self.pos]
            self.pos += 1
            n = b >> 4
            et = b & 0x0F
            if n == 15:
                n = self.varint()
            if n > len(self.buf) - self.pos:
                raise ValueError("malformed thrift list length")
            return [self._value(et, True) for _ in range(n)]
        if ftype == 12:
            return self.struct()
        raise ValueError(f"unsupported thrift compact type {ftype}")


def uvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def zigzag(v: int) -> bytes:
    return uvarint((v << 1) ^ (v >> 63))


class CompactWriter:
    """TCompactProtocol writer (just enough for Parquet's metadata)."""

    def __init__(self):
        self.buf = bytearray()
        self._fid_stack: List[int] = []
        self.last_fid = 0

    def _field_header(self, fid: int, ftype: int):
        delta = fid - self.last_fid
        if 0 < delta <= 15:
            self.buf.append((delta << 4) | ftype)
        else:
            self.buf.append(ftype)
            self.buf += zigzag(fid)
        self.last_fid = fid

    def i32(self, fid: int, v: int):
        self._field_header(fid, 5)
        self.buf += zigzag(v)

    def i64(self, fid: int, v: int):
        self._field_header(fid, 6)
        self.buf += zigzag(v)

    def string(self, fid: int, s: str):
        self._field_header(fid, 8)
        b = s.encode("utf-8")
        self.buf += uvarint(len(b)) + b

    def begin_struct(self, fid: int):
        self._field_header(fid, 12)
        self._fid_stack.append(self.last_fid)
        self.last_fid = 0

    def begin_element_struct(self):
        """A struct that is a list element: no field header byte."""
        self._fid_stack.append(self.last_fid)
        self.last_fid = 0

    def end_struct(self):
        self.buf.append(0)
        self.last_fid = self._fid_stack.pop()

    def list_header(self, fid: int, etype: int, n: int):
        self._field_header(fid, 9)
        if n < 15:
            self.buf.append((n << 4) | etype)
        else:
            self.buf.append(0xF0 | etype)
            self.buf += uvarint(n)

    def stop(self) -> bytes:
        self.buf.append(0)
        return bytes(self.buf)
