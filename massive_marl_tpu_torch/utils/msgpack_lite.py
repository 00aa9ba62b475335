"""A msgpack encoder and decoder for the JAX package's checkpoint files.

The JAX package writes its checkpoints with `flax.serialization.to_bytes`:
msgpack of a tree of string-keyed maps whose leaves are arrays, ints,
floats, bools or nil.  flax packs an array as ext type 1, whose payload is
msgpack of (shape, dtype name, raw C-order bytes), and a numpy scalar as
ext type 3 with the same payload.  This module reads and writes exactly
that, with the standard library and numpy only, so the port needs neither
flax nor the `msgpack` package.

* `packb(tree)`: maps (string keys), lists and tuples, int, float, bool,
  None, str, bytes, torch tensors and numpy arrays (ext 1), numpy scalars
  (ext 3).  Every array moves as one bytes blob.  bfloat16 tensors go
  through an int16 view and are named "bfloat16", as flax names them.
* `unpackb(blob)`: the same tree; ext 1 becomes a CPU torch tensor, ext 3 a
  numpy scalar (a 0-d tensor for bfloat16), msgpack arrays become lists.

Anything else raises ValueError naming what it found, among them flax's
chunked arrays (over 2**30 bytes, written as a map with
"__msgpack_chunked_array__"), complex numbers (ext 2) and other ext types.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
# flax splits an array above this many bytes into chunks
MAX_ARRAY_BYTES = 2 ** 30
CHUNKED_KEY = "__msgpack_chunked_array__"

_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
                torch.bool: "bool"}


# ------------------------------------------------------------------ encoder
def _pack_uint_header(out: bytearray, n: int, fix_base: int, fix_max: int, codes):
    """A length header: fix form below fix_max, else the 8/16/32-bit code
    (codes = (code8 or None, code16, code32))."""
    if n < fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(out: bytearray, v: int):
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">BB", 8), (0xCD, ">BH", 16), (0xCE, ">BI", 32),
                               (0xCF, ">BQ", 64)):
            if v < 1 << lim:
                out += struct.pack(fmt, code, v)
                return
        raise ValueError(f"int {v} does not fit msgpack's 64 bits")
    else:
        for code, fmt, lim in ((0xD0, ">Bb", 7), (0xD1, ">Bh", 15), (0xD2, ">Bi", 31),
                               (0xD3, ">Bq", 63)):
            if v >= -(1 << lim):
                out += struct.pack(fmt, code, v)
                return
        raise ValueError(f"int {v} does not fit msgpack's 64 bits")


def _pack_bytes(out: bytearray, b):
    _pack_uint_header(out, len(b), 0, 0, (0xC4, 0xC5, 0xC6))
    out += b


def _pack_str(out: bytearray, s: str):
    b = s.encode("utf-8")
    _pack_uint_header(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
    out += b


def _pack_ext(out: bytearray, code: int, payload: bytes):
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += struct.pack(">Bb", fixed[n], code)
    elif n < 1 << 8:
        out += struct.pack(">BBb", 0xC7, n, code)
    elif n < 1 << 16:
        out += struct.pack(">BHb", 0xC8, n, code)
    elif n < 1 << 32:
        out += struct.pack(">BIb", 0xC9, n, code)
    else:
        raise ValueError(f"msgpack ext payload of {n} bytes is too long")
    out += payload


def _array_payload(shape, dtype_name: str, raw) -> bytes:
    """flax's (shape, dtype name, bytes) triple, msgpack-encoded."""
    if len(raw) > MAX_ARRAY_BYTES:
        raise ValueError(f"array of {len(raw)} bytes is over {MAX_ARRAY_BYTES}: flax would "
                         "chunk it, and chunked arrays are not supported")
    out = bytearray()
    out.append(0x93)
    _pack(out, [int(d) for d in shape])
    _pack_str(out, dtype_name)
    _pack_bytes(out, raw)
    return bytes(out)


def _tensor_payload(t: torch.Tensor) -> bytes:
    t = t.detach()
    if t.dtype not in _TORCH_NAMES:
        raise ValueError(f"tensor of dtype {t.dtype} is not supported")
    name = _TORCH_NAMES[t.dtype]
    t = t.to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return _array_payload(t.shape, name, t.numpy().tobytes())


def _ndarray_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None or a.dtype.kind in "cUSV":
        raise ValueError(f"numpy array of dtype {a.dtype} is not supported")
    return _array_payload(a.shape, a.dtype.name, np.ascontiguousarray(a).tobytes())


def _pack(out: bytearray, x):
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out += struct.pack(">Bd", 0xCB, x)
    elif type(x) is str:
        _pack_str(out, x)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        _pack_bytes(out, x)
    elif type(x) is dict:
        _pack_uint_header(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            if type(k) is not str:
                raise ValueError(f"map key {k!r} is not a string")
            _pack_str(out, k)
            _pack(out, v)
    elif type(x) in (list, tuple):
        _pack_uint_header(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, torch.Tensor):
        _pack_ext(out, EXT_NDARRAY, _tensor_payload(x))
    elif isinstance(x, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic) and not isinstance(x, np.complexfloating):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    else:
        raise ValueError(f"cannot encode {type(x).__name__} ({x!r:.80})")


def packb(tree) -> bytes:
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# ------------------------------------------------------------------ decoder
def _dtype_of(name: str):
    if name == "bfloat16":
        return None
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"array of unknown dtype {name!r}") from None
    if dt.kind in "cOUSV":
        raise ValueError(f"array of dtype {name!r} is not supported")
    return dt


def _array_from_payload(payload: memoryview) -> torch.Tensor:
    triple, end = _Reader(payload).read_all()
    if not (isinstance(triple, list) and len(triple) == 3 and end == len(payload)):
        raise ValueError("ndarray payload is not a (shape, dtype, bytes) triple")
    shape, name, raw = triple
    name = name.decode() if isinstance(name, bytes) else name
    dt = _dtype_of(name)
    buf = bytearray(raw)
    if dt is None:  # bfloat16: no numpy dtype, so through an int16 view
        arr = torch.from_numpy(np.frombuffer(buf, np.int16)).view(torch.bfloat16)
    else:
        arr = torch.from_numpy(np.frombuffer(buf, dt))
    return arr.reshape([int(d) for d in shape])


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def read_all(self):
        value = self.read()
        return value, self.pos

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a string")
            out[k] = self.read()
        if CHUNKED_KEY in out:
            raise ValueError("flax chunked array (an array over 2**30 bytes) is not supported")
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        payload = self._take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(payload)
        if code == EXT_NPSCALAR:
            arr = _array_from_payload(payload)
            return arr.reshape(()) if arr.dtype == torch.bfloat16 else arr.numpy()[()]
        if code == EXT_COMPLEX:
            raise ValueError("complex number (msgpack ext type 2) is not supported")
        raise ValueError(f"msgpack ext type {code} is not supported")

    def read(self):
        c = self._take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return str(self._take(c & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        if c in (0xC4, 0xC5, 0xC6):
            n = self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[c])
            return bytes(self._take(n))
        if c in (0xC7, 0xC8, 0xC9):
            return self._ext(self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c]))
        if c == 0xCA:
            return self._unpack(">f")
        if c == 0xCB:
            return self._unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in ints:
            return self._unpack(ints[c])
        if c in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self._ext(1 << (c - 0xD4))
        if c in (0xD9, 0xDA, 0xDB):
            n = self._unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[c])
            return str(self._take(n), "utf-8")
        if c in (0xDC, 0xDD):
            n = self._unpack(">H" if c == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if c == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{c:02x} is not supported")


def unpackb(blob) -> object:
    value, end = _Reader(blob).read_all()
    if end != len(blob):
        raise ValueError(f"{len(blob) - end} bytes follow the msgpack object")
    return value
