"""The subset of MessagePack that the wire protocol speaks — the port's
own encoder and decoder, so the daemon and its clients need no
``msgpack`` package.

:func:`packb` gives the same bytes as ``msgpack.packb(obj,
use_bin_type=True, default=...)`` for every payload the protocol sends:
nil, bool, int of every width (the smallest encoding; non-negative ints
unsigned), float (always float64), str (UTF-8, str8 included), bin
(``bytes``, ``bytearray``, ``memoryview``), array (``list``, ``tuple``)
and map (``dict``, in insertion order). Any other object goes through
``default`` once, as msgpack does: the hook's result is packed, and the
same unknown object coming back from it raises ``TypeError``; nesting
deeper than msgpack's 511 levels raises ``ValueError``.
Subclasses count as their base type (``numpy.float64`` is a float).

:func:`unpackb` reads what ``msgpack.unpackb(body, raw=False,
strict_map_key=False, object_hook=...)`` reads — also float32 and the
ext family's lengths, which the protocol never sends — and calls
``object_hook`` on every map once its items are decoded."""

from __future__ import annotations

import struct
from typing import Any, Callable, List, Optional

_DOUBLE = struct.Struct(">d")
_FLOAT = struct.Struct(">f")
_U8 = struct.Struct(">B")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_I8 = struct.Struct(">b")
_I16 = struct.Struct(">h")
_I32 = struct.Struct(">i")
_I64 = struct.Struct(">q")


def _pack_int(v: int, out: List[bytes]) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(_U8.pack(v))
        elif v <= 0xFF:
            out.append(b"\xcc" + _U8.pack(v))
        elif v <= 0xFFFF:
            out.append(b"\xcd" + _U16.pack(v))
        elif v <= 0xFFFFFFFF:
            out.append(b"\xce" + _U32.pack(v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _U64.pack(v))
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(_I8.pack(v))
    elif v >= -0x80:
        out.append(b"\xd0" + _I8.pack(v))
    elif v >= -0x8000:
        out.append(b"\xd1" + _I16.pack(v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + _I32.pack(v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + _I64.pack(v))
    else:
        raise OverflowError("Integer value out of range")


def _pack_bin(b, out: List[bytes]) -> None:
    n = len(b)
    if n <= 0xFF:
        out.append(b"\xc4" + _U8.pack(n))
    elif n <= 0xFFFF:
        out.append(b"\xc5" + _U16.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(b"\xc6" + _U32.pack(n))
    else:
        raise ValueError("bin is too large")
    out.append(bytes(b))


#: msgpack's nesting bound (``DEFAULT_RECURSE_LIMIT``)
_RECURSE_LIMIT = 511


def _pack(obj: Any, out: List[bytes], default: Optional[Callable],
          limit: int = _RECURSE_LIMIT) -> None:
    if limit < 0:
        raise ValueError("recursion limit exceeded.")
    default_used = False
    while True:
        if obj is None:
            out.append(b"\xc0")
        elif obj is True:
            out.append(b"\xc3")
        elif obj is False:
            out.append(b"\xc2")
        elif isinstance(obj, int):
            _pack_int(int(obj), out)
        elif isinstance(obj, float):
            out.append(b"\xcb" + _DOUBLE.pack(obj))
        elif isinstance(obj, (bytes, bytearray)):
            _pack_bin(obj, out)
        elif isinstance(obj, str):
            b = obj.encode("utf-8")
            n = len(b)
            if n < 32:
                out.append(_U8.pack(0xA0 | n))
            elif n <= 0xFF:
                out.append(b"\xd9" + _U8.pack(n))
            elif n <= 0xFFFF:
                out.append(b"\xda" + _U16.pack(n))
            elif n <= 0xFFFFFFFF:
                out.append(b"\xdb" + _U32.pack(n))
            else:
                raise ValueError("unicode string is too large")
            out.append(b)
        elif isinstance(obj, dict):
            n = len(obj)
            if n < 16:
                out.append(_U8.pack(0x80 | n))
            elif n <= 0xFFFF:
                out.append(b"\xde" + _U16.pack(n))
            else:
                out.append(b"\xdf" + _U32.pack(n))
            for k, v in obj.items():
                _pack(k, out, default, limit - 1)
                _pack(v, out, default, limit - 1)
        elif isinstance(obj, (list, tuple)):
            n = len(obj)
            if n < 16:
                out.append(_U8.pack(0x90 | n))
            elif n <= 0xFFFF:
                out.append(b"\xdc" + _U16.pack(n))
            else:
                out.append(b"\xdd" + _U32.pack(n))
            for v in obj:
                _pack(v, out, default, limit - 1)
        elif isinstance(obj, memoryview):
            _pack_bin(obj.cast("B") if obj.format != "B" or obj.ndim != 1
                      else obj, out)
        elif default is not None and not default_used:
            obj = default(obj)
            default_used = True
            continue
        else:
            raise TypeError(f"can not serialize {type(obj).__name__!r} "
                            f"object")
        return


def packb(obj: Any, default: Optional[Callable] = None) -> bytes:
    """``obj`` as MessagePack bytes (bin type on, as
    ``msgpack.packb(obj, use_bin_type=True, default=default)``)."""
    out: List[bytes] = []
    _pack(obj, out, default)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "pos", "hook")

    def __init__(self, buf, hook):
        self.buf = memoryview(buf).cast("B") if not isinstance(
            buf, (bytes, bytearray)) else buf
        self.pos = 0
        self.hook = hook

    def take(self, n: int):
        p = self.pos
        end = p + n
        if end > len(self.buf):
            raise ValueError("unpack(b) received truncated data")
        self.pos = end
        return self.buf[p:end]

    def read(self) -> Any:
        buf = self.buf
        if self.pos >= len(buf):
            raise ValueError("unpack(b) received truncated data")
        b = buf[self.pos]
        self.pos += 1
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b == 0xCC:
            return self.take(1)[0]
        if b == 0xCD:
            return _U16.unpack(self.take(2))[0]
        if b == 0xCE:
            return _U32.unpack(self.take(4))[0]
        if b == 0xCF:
            return _U64.unpack(self.take(8))[0]
        if b == 0xD0:
            return _I8.unpack(self.take(1))[0]
        if b == 0xD1:
            return _I16.unpack(self.take(2))[0]
        if b == 0xD2:
            return _I32.unpack(self.take(4))[0]
        if b == 0xD3:
            return _I64.unpack(self.take(8))[0]
        if b == 0xCA:
            return _FLOAT.unpack(self.take(4))[0]
        if b == 0xCB:
            return _DOUBLE.unpack(self.take(8))[0]
        if b == 0xD9:
            return self._str(self.take(1)[0])
        if b == 0xDA:
            return self._str(_U16.unpack(self.take(2))[0])
        if b == 0xDB:
            return self._str(_U32.unpack(self.take(4))[0])
        if b == 0xC4:
            return bytes(self.take(self.take(1)[0]))
        if b == 0xC5:
            return bytes(self.take(_U16.unpack(self.take(2))[0]))
        if b == 0xC6:
            return bytes(self.take(_U32.unpack(self.take(4))[0]))
        if b == 0xDC:
            return self._array(_U16.unpack(self.take(2))[0])
        if b == 0xDD:
            return self._array(_U32.unpack(self.take(4))[0])
        if b == 0xDE:
            return self._map(_U16.unpack(self.take(2))[0])
        if b == 0xDF:
            return self._map(_U32.unpack(self.take(4))[0])
        raise ValueError(f"unsupported MessagePack type byte {b:#x}")

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> Any:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return self.hook(out) if self.hook is not None else out


def unpackb(body, object_hook: Optional[Callable] = None) -> Any:
    """Decode one MessagePack object (str as ``str``, bin as ``bytes``,
    arrays as lists, ``object_hook`` on every map); trailing bytes
    raise, as ``msgpack.unpackb`` does."""
    r = _Reader(body, object_hook)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError("unpack(b) received extra data")
    return out
