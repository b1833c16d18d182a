"""flax's msgpack subset, read and written without flax or msgpack.

The two-tower model file (`models/two_tower.save_model`) holds its
parameters as the bytes of `flax.serialization.to_bytes`: a msgpack map of
`str` keys whose leaves are numpy arrays, each packed as
``ExtType(1, packb((shape, dtype_name, bytes)))`` (code 3 for a numpy
scalar).  This module encodes such a tree of arrays byte for byte as flax
does, and decodes the formats such a tree uses: map, str, bin, int, array
and ext (codes 1 and 3).
Anything else raises `ValueError`, and so does an array over 2^30 bytes,
which flax splits into chunks (`MAX_CHUNK_SIZE`) and this subset does not.

    dumps({"params": {"w": np.ones((2, 3), np.float32)}}) -> bytes
    loads(bytes) -> the same nest of dicts of arrays
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

EXT_NDARRAY = 1         # flax's _MsgpackExtType.ndarray
EXT_NPSCALAR = 3        # flax's _MsgpackExtType.npscalar
MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
CHUNKED_KEY = "__msgpack_chunked_array__"
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


# --------------------------------------------------------------------------
# encoding (msgpack-python's Packer, use_bin_type=True)
# --------------------------------------------------------------------------


def _int(x: int) -> bytes:
    if -32 <= x < 128:
        return struct.pack("b", x) if x < 0 else bytes([x])
    if x >= 0:
        for fmt, code, lim in (("B", 0xCC, 1 << 8), (">H", 0xCD, 1 << 16),
                               (">I", 0xCE, 1 << 32), (">Q", 0xCF, 1 << 64)):
            if x < lim:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for fmt, code, lim in (("b", 0xD0, 1 << 7), (">h", 0xD1, 1 << 15),
                               (">i", 0xD2, 1 << 31), (">q", 0xD3, 1 << 63)):
            if x >= -lim:
                return bytes([code]) + struct.pack(fmt, x)
    raise ValueError(f"integer {x} does not fit msgpack's 64 bits")


def _sized(n: int, fix: Tuple[int, int], codes: Tuple[int, ...]) -> bytes:
    """The header of a length-`n` str, bin, array or map: the fix form
    (base, limit) where it fits, else the 8-, 16- or 32-bit length form
    (`codes`; the str and bin have an 8-bit one, arrays and maps do not)."""
    base, limit = fix
    if n < limit:
        return bytes([base | n])
    widths = ((1, "B"), (2, ">H"), (4, ">I"))[3 - len(codes):]
    for code, (width, fmt) in zip(codes, widths):
        if n < 1 << (8 * width):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit msgpack's 32 bits")


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _sized(len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + data


def _bin(data: bytes) -> bytes:
    return _sized(len(data), (0x00, 0), (0xC4, 0xC5, 0xC6)) + data


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    if n in _FIXEXT:
        return bytes([_FIXEXT[n], code]) + data
    for head, fmt, lim in ((0xC7, "B", 1 << 8), (0xC8, ">H", 1 << 16),
                           (0xC9, ">I", 1 << 32)):
        if n < lim:
            return bytes([head]) + struct.pack(fmt, n) + bytes([code]) + data
    raise ValueError(f"ext of {n} bytes does not fit msgpack's 32 bits")


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's `_ndarray_to_bytes`: packb((shape, dtype name, C bytes))."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    shape = _sized(arr.ndim, (0x90, 16), (0xDC, 0xDD)) + b"".join(
        _int(int(d)) for d in arr.shape)
    return (b"\x93" + shape + _str(arr.dtype.name)
            + _bin(np.ascontiguousarray(arr).tobytes("C")))


def _pack(x: Any) -> bytes:
    if isinstance(x, dict):
        out = [_sized(len(x), (0x80, 16), (0xDE, 0xDF))]
        for k, v in x.items():
            if not isinstance(k, str):
                raise ValueError(f"a state dict has str keys, got {k!r}")
            out += [_str(k), _pack(v)]
        return b"".join(out)
    if isinstance(x, np.ndarray):
        if x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
            raise ValueError("arrays over 2^30 bytes are chunked by flax; "
                             "this subset does not write them")
        return _ext(EXT_NDARRAY, _ndarray_bytes(x))
    raise ValueError(f"unsupported leaf of type {type(x).__name__}")


def dumps(tree: Dict[str, Any]) -> bytes:
    """The bytes `flax.serialization.to_bytes(tree)` gives for a nest of
    dicts (keys in their order) of numpy arrays."""
    return _pack(tree)


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        sized = {0xD9: ("str", "B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xC4: ("bin", "B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
                 0xC7: ("ext", "B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
        ints = {0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        fixext = {code: n for n, code in _FIXEXT.items()}
        if b in ints:
            return self.unpack(ints[b])
        if b in fixext:
            return self.ext(fixext[b])
        if b not in sized:
            raise ValueError(f"msgpack format 0x{b:02x} is outside flax's "
                             "subset (map, str, bin, int, array, ext)")
        kind, fmt = sized[b]
        n = self.unpack(fmt)
        if kind == "str":
            return self.take(n).decode("utf-8")
        if kind == "bin":
            return self.take(n)
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(n)

    def map(self, n: int) -> Dict[str, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"a state dict has str keys, got {key!r}")
            out[key] = self.value()
        if CHUNKED_KEY in out:
            raise ValueError("chunked arrays (over 2^30 bytes) are outside "
                             "this subset")
        return out

    def ext(self, n: int) -> Any:
        code = self.take(1)[0]
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is outside flax's "
                             "subset (1: ndarray, 3: numpy scalar)")
        arr = _ndarray_from_bytes(data)
        return arr if code == EXT_NDARRAY else arr[()]


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    r = _Reader(data)
    tpl = r.value()
    if (r.pos != len(data) or not isinstance(tpl, list) or len(tpl) != 3
            or not isinstance(tpl[0], list) or not isinstance(tpl[1], str)
            or not isinstance(tpl[2], bytes)):
        raise ValueError("an ndarray ext holds (shape, dtype name, bytes)")
    shape, name, buf = tpl
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays need ml_dtypes; not in this subset")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def loads(data: bytes) -> Dict[str, Any]:
    """The nest of dicts of numpy arrays that `dumps` (or flax's
    `to_bytes`) encoded; raises `ValueError` outside the subset."""
    r = _Reader(bytes(data))
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack value")
    if not isinstance(out, dict):
        raise ValueError("a flax state dict is a map at the top level")
    return out
