"""The msgpack subset that checkpoint format 1 uses, written by hand.

The JAX package writes its checkpoints with ``flax.serialization``,
which packs a state dict with the ``msgpack`` package; the port may not
import either, so this module writes and reads the same bytes with
``struct`` and the standard library. It covers what such a state dict
holds: maps, arrays, nil, bools, ints, str and bin at every width, and
ext types. Every object takes msgpack-python's smallest form
(fixint, fixmap, fixarray, fixstr; fixext for payloads of 1, 2, 4, 8 and
16 bytes, else ext8/16/32; str8 and bin8 before their wider forms), so
the output is byte-identical to ``msgpack.packb(..., use_bin_type=True)``
for the same objects, and a difference from flax's bytes is a bug.

Arrays travel as flax's ext types: type 1 packs ``[shape, dtype name,
C-order bytes]`` (every array, 0-d ones included), type 3 is a numpy
scalar in the same layout (read only: flax writes it for ``np.generic``
leaves, which the port's states never hold). :func:`pack_state` and
:func:`unpack_state` apply them; flax's chunking of arrays over 1 GiB is
not needed at the model's sizes and is refused by name.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple, Optional

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_ARRAY_BYTES = 2 ** 30   # flax chunks larger leaves


class ExtType(NamedTuple):
    code: int
    data: bytes


class _Parts(NamedTuple):
    """An ext object whose payload is written from ``parts`` (buffers) as
    they are, without joining them first: an array's bytes go into the
    output once."""
    code: int
    parts: tuple


class UnpackError(ValueError):
    """The bytes are not one complete msgpack object."""


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_len(out: bytearray, n: int, fix: Optional[tuple], forms) -> None:
    """A length header: ``fix = (limit, base)`` for the fix form, then
    ``forms``, ``(limit, marker, struct code)`` from the narrowest."""
    if fix is not None and n < fix[0]:
        out.append(fix[1] | n)
        return
    for limit, marker, code in forms:
        if n < limit:
            out.append(marker)
            out += struct.pack(">" + code, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


_STR = ((1 << 8, 0xD9, "B"), (1 << 16, 0xDA, "H"), (1 << 32, 0xDB, "I"))
_BIN = ((1 << 8, 0xC4, "B"), (1 << 16, 0xC5, "H"), (1 << 32, 0xC6, "I"))
_ARRAY = ((1 << 16, 0xDC, "H"), (1 << 32, 0xDD, "I"))
_MAP = ((1 << 16, 0xDE, "H"), (1 << 32, 0xDF, "I"))
_EXT = ((1 << 8, 0xC7, "B"), (1 << 16, 0xC8, "H"), (1 << 32, 0xC9, "I"))


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for limit, marker, code in ((1 << 8, 0xCC, "B"),
                                    (1 << 16, 0xCD, "H"),
                                    (1 << 32, 0xCE, "I"),
                                    (1 << 64, 0xCF, "Q")):
            if v < limit:
                out.append(marker)
                out += struct.pack(">" + code, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")
    else:
        for limit, marker, code in ((1 << 7, 0xD0, "b"),
                                    (1 << 15, 0xD1, "h"),
                                    (1 << 31, 0xD2, "i"),
                                    (1 << 63, 0xD3, "q")):
            if v >= -limit:
                out.append(marker)
                out += struct.pack(">" + code, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack(out: bytearray, obj: Any, default) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), (32, 0xA0), _STR)
        out += raw
    elif type(obj) in (bytes, bytearray):
        _pack_len(out, len(obj), None, _BIN)
        out += obj
    elif type(obj) in (list, tuple):
        _pack_len(out, len(obj), (16, 0x90), _ARRAY)
        for v in obj:
            _pack(out, v, default)
    elif type(obj) is dict:
        _pack_len(out, len(obj), (16, 0x80), _MAP)
        for k, v in obj.items():
            _pack(out, k, default)
            _pack(out, v, default)
    elif type(obj) in (ExtType, _Parts):
        parts = (obj.data,) if type(obj) is ExtType else obj.parts
        n = sum(len(p) for p in parts)
        if n in _FIXEXT:
            out.append(_FIXEXT[n])
        else:
            _pack_len(out, n, None, _EXT)
        out += struct.pack(">b", obj.code)
        for p in parts:
            out += p
    elif default is not None:
        _pack(out, default(obj), None)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj: Any, default: Optional[Callable[[Any], Any]] = None
          ) -> bytes:
    """``obj`` as msgpack bytes; ``default`` maps any other object (once)
    to one this module packs, as msgpack-python's ``default`` does."""
    out = bytearray()
    _pack(out, obj, default)
    return bytes(out)


class _Reader:

    def __init__(self, data: bytes, ext_hook):
        self.data = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise UnpackError(f"truncated: {n} bytes wanted at offset "
                              f"{self.pos} of {len(self.data)}")
        out = self.data[self.pos:end].tobytes()
        self.pos = end
        return out

    def num(self, code: str):
        return struct.unpack(">" + code, self.take(struct.calcsize(code)))[0]

    def str_(self, n: int):
        raw = self.take(n)
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise UnpackError(f"str at offset {self.pos - n}: {e}") from None

    def ext(self, n: int):
        code = self.num("b")
        data = self.take(n)
        if self.ext_hook is None:
            return ExtType(code, data)
        return self.ext_hook(code, data)

    def obj(self):
        b = self.num("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.map_(b & 0x0F)
        if b < 0xA0:
            return [self.obj() for _ in range(b & 0x0F)]
        if b < 0xC0:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q", 0xD0: "b",
                0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in ints:
            return self.num(ints[b])
        sizes = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if b in sizes:
            return self.str_(self.num(sizes[b]))
        sizes = {0xC4: "B", 0xC5: "H", 0xC6: "I"}
        if b in sizes:
            return self.take(self.num(sizes[b]))
        if b in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.num(
                "H" if b == 0xDC else "I"))]
        if b in (0xDE, 0xDF):
            return self.map_(self.num("H" if b == 0xDE else "I"))
        fixext = {m: n for n, m in _FIXEXT.items()}
        if b in fixext:
            return self.ext(fixext[b])
        sizes = {0xC7: "B", 0xC8: "H", 0xC9: "I"}
        if b in sizes:
            return self.ext(self.num(sizes[b]))
        raise UnpackError(f"byte 0x{b:02x} at offset {self.pos - 1} starts "
                          f"no msgpack object")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if isinstance(k, (dict, list)):
                raise UnpackError(f"unhashable map key at offset {self.pos}")
            out[k] = self.obj()
        return out


def unpackb(data: bytes, ext_hook=None) -> Any:
    """The one msgpack object ``data`` holds. ``ext_hook(code, data)``
    decodes ext types (else :class:`ExtType`). Truncated, unknown or
    trailing bytes raise :class:`UnpackError`."""
    r = _Reader(data, ext_hook)
    obj = r.obj()
    if r.pos != len(r.data):
        raise UnpackError(f"extra data: {len(r.data) - r.pos} bytes after "
                          f"the object at offset {r.pos}")
    return obj


# -- flax's array ext types ----------------------------------------------


def _ext_pack(x):
    """An array as ext type 1: ``[shape, dtype name, C-order bytes]``,
    the header packed here and the bytes written from the array."""
    if not isinstance(x, np.ndarray):
        raise TypeError(f"cannot msgpack {type(x).__name__}")
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError(f"cannot pack dtype {x.dtype}")
    if x.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"array of {x.nbytes} bytes: flax chunks leaves "
                         f"over {MAX_ARRAY_BYTES} bytes, which format 1 as "
                         f"written here does not")
    head = bytearray(b"\x93")
    _pack(head, list(x.shape), None)
    _pack(head, x.dtype.name, None)
    _pack_len(head, x.nbytes, None, _BIN)
    data = memoryview(np.ascontiguousarray(x)).cast("B")
    return _Parts(EXT_NDARRAY, (bytes(head), data))


def _ndarray_from(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(
        shape, order="C")


def _ext_unpack(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from(data)[()]
    return ExtType(code, data)


def pack_state(state_dict) -> bytes:
    """A state dict of str-keyed maps with numpy array leaves as flax's
    ``to_bytes`` writes it."""
    return packb(state_dict, default=_ext_pack)


def unpack_state(data: bytes):
    """Flax's ``msgpack_restore``: arrays come back as read-only numpy
    arrays over the bytes."""
    return unpackb(data, ext_hook=_ext_unpack)
