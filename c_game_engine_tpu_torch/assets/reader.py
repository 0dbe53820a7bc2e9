"""Little-endian cursor reader/writer for `.g*` payloads (counterpart of
c_game_engine_tpu/assets/reader.py).

The reference's DataReader/DataWriter semantics: all integers
little-endian, `size_t` = u64, strings = u64 byte count (including the
NUL) + bytes.
"""

from __future__ import annotations

import struct


class PayloadError(ValueError):
    pass


class Reader:
    __slots__ = ("data", "off")

    def __init__(self, data: bytes, off: int = 0):
        self.data = data
        self.off = off

    def _unpack(self, fmt: str):
        s = struct.Struct(fmt)
        if self.off + s.size > len(self.data):
            raise PayloadError("payload overrun")
        v = s.unpack_from(self.data, self.off)[0]
        self.off += s.size
        return v

    def u8(self) -> int:
        return self._unpack("<B")

    def u16(self) -> int:
        return self._unpack("<H")

    def u32(self) -> int:
        return self._unpack("<I")

    def i32(self) -> int:
        return self._unpack("<i")

    def u64(self) -> int:
        return self._unpack("<Q")

    def f32(self) -> float:
        return self._unpack("<f")

    def f64(self) -> float:
        return self._unpack("<d")

    def raw(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise PayloadError("payload overrun")
        b = self.data[self.off : self.off + n]
        self.off += n
        return b

    def string(self) -> str:
        n = self.u64()
        return self.raw(n).split(b"\x00", 1)[0].decode("utf-8", "replace")

    def skip(self, n: int) -> None:
        if self.off + n > len(self.data):
            raise PayloadError("payload overrun")
        self.off += n

    def remaining(self) -> int:
        return len(self.data) - self.off


class Writer:
    __slots__ = ("parts",)

    def __init__(self):
        self.parts: list[bytes] = []

    def _pack(self, fmt: str, v):
        self.parts.append(struct.pack(fmt, v))
        return self

    def u8(self, v):
        return self._pack("<B", v)

    def u16(self, v):
        return self._pack("<H", v)

    def u32(self, v):
        return self._pack("<I", v)

    def i32(self, v):
        return self._pack("<i", v)

    def u64(self, v):
        return self._pack("<Q", v)

    def f32(self, v):
        return self._pack("<f", v)

    def f64(self, v):
        return self._pack("<d", v)

    def raw(self, b: bytes):
        self.parts.append(bytes(b))
        return self

    def string(self, s: str):
        b = s.encode("utf-8") + b"\x00"
        self.u64(len(b))
        return self.raw(b)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)
