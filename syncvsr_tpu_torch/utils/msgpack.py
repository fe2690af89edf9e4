"""flax's msgpack checkpoint format, in pure Python and numpy.

``dumps(tree)`` (or ``dump(tree, file)``) gives the bytes
``flax.serialization.msgpack_serialize`` gives for a tree of dicts with
str keys whose leaves are numpy arrays, numpy scalars, int, float, bool,
None, str and bytes; ``loads`` reads them back as
``flax.serialization.msgpack_restore`` does. The subset of the
MessagePack spec this takes:

* maps (keys sorted at every level, as flax's pass through
  ``jax.tree_util`` leaves them), arrays (read only: flax nests them in its
  ndarray payload), nil, bool, int, float (as float 64), str, bin;
* flax's extension types: 1, an ndarray as the MessagePack array (shape,
  dtype name, C-order bytes); 3, a numpy scalar the same way with shape ();
* arrays above 1 GiB split into flax's ``__msgpack_chunked_array__`` maps.

Arrays come back read-only, over the bytes they were read from, as flax's
do. A ``bfloat16`` leaf raises: numpy has no such type.
"""

from __future__ import annotations

import io
import struct
from typing import Any, BinaryIO, Callable, List

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_MAX_CHUNK_BYTES = 2 ** 30          # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

Write = Callable[[Any], Any]     # a file's write: takes bytes or a memoryview


def _int(v: int, write: Write) -> None:
    if 0 <= v < 0x80:
        write(struct.pack("B", v))
    elif -32 <= v < 0:
        write(struct.pack("b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= top:
                write(struct.pack(">B", code) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} does not fit MessagePack's 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                               (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if v >= low:
                write(struct.pack(">B", code) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} does not fit MessagePack's 64 bits")


def _sized(n: int, write: Write, fix, fix_max: int, codes) -> None:
    """A header of length ``n``: the fix form (``fix | n``) up to
    ``fix_max``, else the first of the 8/16/32-bit forms that holds it
    (``codes``, None where a width does not exist)."""
    if fix is not None and n <= fix_max:
        write(struct.pack("B", fix | n))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            write(struct.pack(">B", code) + struct.pack(fmt, n))
            return
    raise OverflowError(f"length {n} does not fit MessagePack's 32 bits")


def _str(v: str, write: Write) -> None:
    b = v.encode("utf-8")
    _sized(len(b), write, 0xA0, 31, (0xD9, 0xDA, 0xDB))
    write(b)


def _bin(v: bytes, write: Write) -> None:
    _sized(len(v), write, None, -1, (0xC4, 0xC5, 0xC6))
    write(v)


def _ext_header(code: int, n: int, write: Write) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        write(struct.pack("BB", fixed[n], code))
    else:
        _sized(n, write, None, -1, (0xC7, 0xC8, 0xC9))
        write(struct.pack("B", code))


def _pack_ndarray(code: int, a: np.ndarray, write: Write) -> None:
    """flax's ``_ndarray_to_bytes`` payload, (shape, dtype name, C-order
    bytes), as extension ``code``; the array's buffer goes to ``write`` as
    it is, without a copy."""
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    if not a.flags.c_contiguous:
        a = a.copy(order="C")   # (np.ascontiguousarray makes a 0-d array 1-d)
    head: List[bytes] = []
    _sized(3, head.append, 0x90, 15, (None, 0xDC, 0xDD))
    _sized(a.ndim, head.append, 0x90, 15, (None, 0xDC, 0xDD))
    for d in a.shape:
        _int(int(d), head.append)
    _str(a.dtype.name, head.append)
    _sized(a.nbytes, head.append, None, -1, (0xC4, 0xC5, 0xC6))
    head_bytes = b"".join(head)
    _ext_header(code, len(head_bytes) + a.nbytes, write)
    write(head_bytes)
    if a.nbytes:
        write(memoryview(a.reshape(-1)).cast("B"))


def _chunk(a: np.ndarray) -> dict:
    size = max(1, _MAX_CHUNK_BYTES // a.dtype.itemsize)
    flat = a.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(a.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(v: Any, write: Write) -> None:
    if v is None:
        write(b"\xc0")
    elif v is True:
        write(b"\xc3")
    elif v is False:
        write(b"\xc2")
    elif type(v) is int:
        _int(v, write)
    elif type(v) is float:
        write(b"\xcb" + struct.pack(">d", v))
    elif type(v) is str:
        _str(v, write)
    elif type(v) is bytes:
        _bin(v, write)
    elif type(v) is dict:
        _sized(len(v), write, 0x80, 15, (None, 0xDE, 0xDF))
        # keys sorted, as flax's pass through jax.tree_util leaves them; a
        # chunked array's map is made after that pass, in insertion order
        keys = list(v) if _CHUNKED in v else sorted(v)
        for k in keys:
            if type(k) is not str:
                raise TypeError(f"map keys must be str, got {k!r}")
            _str(k, write)
            _pack(v[k], write)
    elif isinstance(v, np.ndarray):
        if v.size * v.dtype.itemsize > _MAX_CHUNK_BYTES:
            _pack(_chunk(v), write)
        else:
            _pack_ndarray(_EXT_NDARRAY, v, write)
    elif isinstance(v, np.generic):
        _pack_ndarray(_EXT_NPSCALAR, np.asarray(v), write)
    else:
        raise TypeError(f"cannot serialize {type(v).__name__} in flax's msgpack format")


def dump(tree: Any, f: BinaryIO) -> None:
    """Write the bytes of ``flax.serialization.msgpack_serialize(tree)`` to
    the binary file ``f``; array buffers are written as they lie (the
    interpreter lock is free while the file takes them)."""
    _pack(tree, f.write)


def dumps(tree: Any) -> bytes:
    """The bytes of ``flax.serialization.msgpack_serialize(tree)``."""
    buf = io.BytesIO()
    dump(tree, buf)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: bytes, raw: bool):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw      # str as bytes (flax's inner ndarray payload)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated MessagePack data")
        chunk = self.buf[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int) -> Any:
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"unknown MessagePack extension type {code}")

    def read(self) -> Any:
        c = self.unpack("B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.text(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            return self.unpack(ints[c])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(sizes[c - 0xC4])))
        if c in (0xD9, 0xDA, 0xDB):
            return self.text(self.unpack(sizes[c - 0xD9]))
        if c in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(sizes[c - 0xDC + 1]))]
        if c in (0xDE, 0xDF):
            return self.map(self.unpack(sizes[c - 0xDE + 1]))
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4))
        if c in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack(sizes[c - 0xC7]))
        raise ValueError(f"MessagePack type byte 0x{c:02x} is not supported")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ndarray(data: memoryview) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``."""
    shape, name, buffer = _Reader(bytes(data), raw=True).read()
    if name == b"bfloat16":
        raise ValueError("a bfloat16 array: numpy has no such dtype")
    return np.frombuffer(buffer, dtype=np.dtype(name.decode())).reshape(shape, order="C")


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data: bytes) -> Any:
    """The tree of ``flax.serialization.msgpack_restore(data)``."""
    reader = _Reader(data, raw=False)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the MessagePack object")
    return _unchunk(tree)
