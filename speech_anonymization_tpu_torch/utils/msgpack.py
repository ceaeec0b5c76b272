"""The subset of msgpack that ``flax.serialization.to_bytes`` writes, without
the ``msgpack`` package (the port runs where only torch and numpy are installed).

Values: nil, bool, int, float (64-bit), str, bin, arrays (lists and tuples),
maps, and two extension types:

  * 1, an array: a nested msgpack array ``[shape, dtype name, C-order bytes]``;
  * 3, a numpy scalar: the same payload for a 0-d array.

A tree goes through the state-dict rules of ``flax.serialization``: a named
tuple becomes a map of its fields, a list or tuple a map keyed ``"0"``,
``"1"``, ...; map keys are written in the order the dict holds them. So the
bytes of :func:`to_bytes` equal ``flax.serialization.to_bytes`` on the same
tree. Array leaves are numpy arrays or torch tensors; ``bfloat16`` (which
numpy lacks) decodes to a ``torch.bfloat16`` tensor, every other dtype to a
numpy array. Arrays over 2**30 bytes, which flax splits into
``__msgpack_chunked_array__`` maps, are refused both ways.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30  # flax chunks an array above this many bytes
_CHUNKED = "__msgpack_chunked_array__"


def _torch_dtype_name(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return "bfloat16"
    return torch.empty(0, dtype=dtype).numpy().dtype.name


def _array_payload(x) -> bytes:
    """A numpy array or scalar, or a torch tensor -> the ext payload
    ``[shape, dtype name, bytes]``."""
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        name = _torch_dtype_name(t.dtype)
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        shape = tuple(t.shape)
    else:
        a = np.asarray(x)
        if a.dtype.hasobject or a.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be serialized")
        name, raw, shape = a.dtype.name, a, a.shape
    nbytes = raw.size * raw.dtype.itemsize
    if nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"an array of {nbytes} bytes would be chunked by flax; not supported")
    out = bytearray()
    _pack([list(shape), name, memoryview(np.ascontiguousarray(raw).reshape(-1).view(np.uint8))], out)
    return bytes(out)


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack(">b", v)
    elif 0x80 <= v <= 0xFF:
        out += b"\xcc" + struct.pack(">B", v)
    elif -0x80 <= v < 0:
        out += b"\xd0" + struct.pack(">b", v)
    elif 0xFF < v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif -0x8000 <= v < -0x80:
        out += b"\xd1" + struct.pack(">h", v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif -0x80000000 <= v < -0x8000:
        out += b"\xd2" + struct.pack(">i", v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple, out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), None, 0, (0xC7, 0xC8, 0xC9), out)
    out += struct.pack(">b", code) + data


def _pack(x, out: bytearray) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif type(x) is int:
        _pack_int(x, out)
    elif type(x) is float:
        out += b"\xcb" + struct.pack(">d", x)
    elif type(x) is str:
        raw = x.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif isinstance(x, (bytes, bytearray, memoryview)):
        raw = memoryview(x)
        if raw.format != "B" or raw.ndim != 1:
            raw = raw.cast("B")
        _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += raw
    elif type(x) in (list, tuple):
        _pack_len(len(x), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in x:
            _pack(v, out)
    elif type(x) is dict:
        _pack_len(len(x), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, np.ndarray) or torch.is_tensor(x):
        _pack_ext(EXT_NDARRAY, _array_payload(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(x), out)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def to_state_dict(tree) -> Any:
    """flax's state-dict rules: named tuples and dicts -> maps (string keys), lists and
    tuples -> maps keyed by position; every other value is a leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: to_state_dict(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def to_bytes(tree) -> bytes:
    """``flax.serialization.to_bytes`` of ``tree``, byte for byte."""
    out = bytearray()
    _pack(to_state_dict(tree), out)
    return bytes(out)


class _Reader:
    def __init__(self, data, raw: bool):
        self.data = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw  # an array payload: str as bytes, bin as a view of ``data``

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lens:
            n = self.unpack(lens[b])
            if b in (0xD9, 0xDA, 0xDB):
                return self.str_(n)
            if b in (0xC4, 0xC5, 0xC6):
                return self.take(n) if self.raw else bytes(self.take(n))
            if b in (0xDC, 0xDD):
                return [self.value() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self.map_(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[bytes(k) if isinstance(k, memoryview) else k] = self.value()
        if _CHUNKED in out:
            raise ValueError("chunked arrays (over 2**30 bytes) are not supported")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not supported")
        arr = _array_from_payload(data)
        return arr if code == EXT_NDARRAY else arr[()]


def _array_from_payload(data) -> np.ndarray | torch.Tensor:
    shape, name, buf = _Reader(data, raw=True).value()
    if name == b"bfloat16":
        codes = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(codes.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape)


def from_bytes(data) -> Any:
    """msgpack bytes (``flax.serialization.to_bytes``'s) -> the tree of maps and
    leaves. Array leaves are numpy views of ``data``, writable when ``data``
    is a ``bytearray`` (bfloat16: torch tensors, copies)."""
    reader = _Reader(data, raw=False)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack value")
    return tree
