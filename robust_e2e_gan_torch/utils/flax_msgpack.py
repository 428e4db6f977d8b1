"""The msgpack subset that flax writes, read and written with ``struct`` and
numpy alone.

A JAX checkpoint (``ckpt_<step>.msgpack``) is ``flax.serialization.to_bytes``
of a state tree: maps with string keys down to the leaves, which are
msgpack ints, floats, bools, nil, strings and bytes, or one of flax's
extension types (``flax/serialization.py``):

* ext 1, an ndarray: the payload is itself msgpack, the array
  ``[shape, dtype name, the raw C-order bytes]``;
* ext 3, a numpy scalar, packed as a 0-d ndarray;
* ext 2, a complex number: the payload is the msgpack array
  ``[real, imag]``.

An array larger than flax's chunk size (2**30 bytes) is written as the map
``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
{"0": flat piece, ...}}``; ``loads`` puts it back together. Arrays come
back as writable numpy arrays, except bfloat16 ones, which numpy has no
type for: their bytes are read as 16-bit integers and viewed as a
``torch.bfloat16`` tensor. ``dumps`` writes the same subset (a
``torch.bfloat16`` tensor as a "bfloat16" ndarray), with the smallest
width of each msgpack type, as msgpack-python writes it.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax's: bytes of the largest unchunked array

# fixed-width types: first byte -> (struct format, width)
_FIXED = {
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
# first byte -> width of the length that follows it
_BIN = {0xc4: 1, 0xc5: 2, 0xc6: 4}
_STR = {0xd9: 1, 0xda: 2, 0xdb: 4}
_ARRAY = {0xdc: 2, 0xdd: 4}
_MAP = {0xde: 2, 0xdf: 4}
_EXT = {0xc7: 1, 0xc8: 2, 0xc9: 4}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, width: int) -> int:
        return struct.unpack(_UINT[width], self.take(width))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            fmt, width = _FIXED[b]
            return struct.unpack(fmt, self.take(width))[0]
        if b in _BIN:
            return bytes(self.take(self.uint(_BIN[b])))
        if b in _STR:
            return str(self.take(self.uint(_STR[b])), "utf-8")
        if b in _ARRAY:
            return self.array(self.uint(_ARRAY[b]))
        if b in _MAP:
            return self.map(self.uint(_MAP[b]))
        if b in _EXT:
            n = self.uint(_EXT[b])
        elif b in _FIXEXT:
            n = _FIXEXT[b]
        else:
            raise ValueError(f"byte 0x{b:02x} is no msgpack type")
        code = struct.unpack(">b", self.take(1))[0]
        return _ext(code, self.take(n))

    def array(self, n: int) -> List[Any]:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def _loads_one(data) -> Any:
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _ndarray(payload):
    shape, name, raw = _loads_one(payload)
    if name == "bfloat16":
        flat = np.frombuffer(raw, dtype="<i2").copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, payload) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
    if code == EXT_COMPLEX:
        real, imag = _loads_one(payload)
        return complex(real, imag)
    raise ValueError(f"msgpack extension type {code} is not flax's")


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data) -> Any:
    """The tree of a flax msgpack byte string (``msgpack_restore``)."""
    return _unchunk(_loads_one(data))


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return loads(f.read())


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _head(out: List[bytes], n: int, fix: int, fix_max: int,
          wide: Tuple[Tuple[int, int], ...]) -> None:
    """The type byte and length of a str, bin, array or map of ``n``: the
    fixed form ``fix | n`` up to ``fix_max``, else the first of ``wide``'s
    (type byte, length width) that holds ``n``."""
    if n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for first, width in wide:
        if n < 1 << (8 * width):
            out.append(bytes([first]) + struct.pack(_UINT[width], n))
            return
    raise ValueError(f"msgpack object of {n} entries is too long")


def _int(out: List[bytes], x: int) -> None:
    if 0 <= x <= 0x7f:
        out.append(bytes([x]))
    elif -32 <= x < 0:
        out.append(struct.pack(">b", x))
    elif x > 0:
        for first, fmt in ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"),
                           (0xcf, ">Q")):
            if x < 1 << (8 * struct.calcsize(fmt)):
                out.append(bytes([first]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"{x} does not fit a msgpack int")
    else:
        for first, fmt in ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"),
                           (0xd3, ">q")):
            if x >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(bytes([first]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"{x} does not fit a msgpack int")


def _ext_out(out: List[bytes], code: int, payload: bytes) -> None:
    n = len(payload)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        out.append(bytes([fixext[n]]))
    else:
        _head(out, n, 0, -1, ((0xc7, 1), (0xc8, 2), (0xc9, 4)))
    out.append(struct.pack(">b", code) + payload)


def _ndarray_bytes(arr) -> bytes:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:
            return _dumps_one((tuple(arr.shape), "bfloat16",
                               arr.contiguous().view(torch.int16)
                               .numpy().astype("<i2").tobytes()))
        arr = arr.numpy()
    arr = np.asarray(arr)
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured arrays are not flax leaves")
    return _dumps_one((tuple(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: List[bytes], x: Any) -> None:
    if x is None:
        out.append(b"\xc0")
    elif isinstance(x, bool):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        _int(out, x)
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _head(out, len(raw), 0xa0, 31, ((0xd9, 1), (0xda, 2), (0xdb, 4)))
        out.append(raw)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        raw = bytes(x)
        _head(out, len(raw), 0, -1, ((0xc4, 1), (0xc5, 2), (0xc6, 4)))
        out.append(raw)
    elif isinstance(x, dict):
        _head(out, len(x), 0x80, 15, ((0xde, 2), (0xdf, 4)))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (list, tuple)):
        _head(out, len(x), 0x90, 15, ((0xdc, 2), (0xdd, 4)))
        for v in x:
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _ext_out(out, EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _ext_out(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif isinstance(x, complex):
        _ext_out(out, EXT_COMPLEX, _dumps_one((x.real, x.imag)))
    else:
        raise TypeError(f"{type(x).__name__} is no flax msgpack leaf")


def _dumps_one(x: Any) -> bytes:
    out: List[bytes] = []
    _pack(out, x)
    return b"".join(out)


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else x.nbytes


def _chunk(arr, chunk_bytes: int) -> Dict[str, Any]:
    itemsize = (arr.element_size() if isinstance(arr, torch.Tensor)
                else arr.dtype.itemsize)
    size = max(1, chunk_bytes // itemsize)
    flat = arr.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.shape[0], size))}}


def _chunked(tree: Any, chunk_bytes: int) -> Any:
    if isinstance(tree, dict):
        return {k: _chunked(v, chunk_bytes) for k, v in tree.items()}
    if (isinstance(tree, (np.ndarray, torch.Tensor))
            and _nbytes(tree) > chunk_bytes):
        return _chunk(tree, chunk_bytes)
    return tree


def dumps(tree: Any, chunk_bytes: int = MAX_CHUNK_SIZE) -> bytes:
    """Flax msgpack bytes of ``tree`` (nested dicts with string keys down
    to array, scalar or string leaves), arrays over ``chunk_bytes``
    chunked as flax chunks them; ``flax.serialization.msgpack_restore``
    reads them back."""
    return _dumps_one(_chunked(tree, chunk_bytes))
