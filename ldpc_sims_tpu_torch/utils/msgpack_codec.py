"""A small msgpack codec for the subset flax's ``serialization`` writes.

The JAX package's checkpoints hold ``flax.serialization.to_bytes`` of a
param tree: msgpack maps with str keys, arrays, str, bin, int, float,
bool and nil, and three ext types: 1, an ndarray (the msgpack of
``(shape, dtype name, C-order bytes)``); 2, a Python complex (the msgpack
of ``(real, imag)``); 3, a NumPy scalar (ext 1's payload). The machine
that runs the port on the card has neither ``msgpack`` nor ``flax``, so
the port reads and writes this format itself.

:func:`serialize` emits the bytes ``msgpack.packb(tree,
default=flax's ext packer, strict_types=True)`` emits for the same tree
(the smallest encoding of each value, floats as float64, tuples and lists
as arrays). :func:`restore` returns nested dicts and lists with NumPy
leaves. NumPy has no bfloat16: an ndarray of dtype name ``bfloat16`` is
read as a ``torch.bfloat16`` tensor, and such a tensor is written back
under that name. flax splits an array over 2³⁰ bytes into a chunked
dict (``__msgpack_chunked_array__``); reading one raises, and so does
writing an array that large.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

__all__ = ["serialize", "restore", "MAX_CHUNK_SIZE"]

# flax's limit for one array leaf; larger arrays it writes in chunks
MAX_CHUNK_SIZE = 2**30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# -- encoding ------------------------------------------------------------


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for code, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF),
                              (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if x <= hi:
                out += bytes([code]) + struct.pack(fmt, x)
                return
        raise OverflowError(f"integer {x} does not fit in msgpack")
    else:
        for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000),
                              (0xD3, ">q", -0x8000000000000000)):
            if x >= lo:
                out += bytes([code]) + struct.pack(fmt, x)
                return
        raise OverflowError(f"integer {x} does not fit in msgpack")


def _pack_len(n: int, fix: int | None, fix_max: int, codes, out) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32
    bit forms ``codes`` (None where the type has no such form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, hi in zip(codes, (">B", ">H", ">I"),
                             (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= hi:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), None, 0, (0xC7, 0xC8, 0xC9), out)
    out += struct.pack(">b", code) + data


def _ndarray_payload(a) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _payload(tuple(t.shape), "bfloat16",
                            t.view(torch.int16).numpy().tobytes())
        a = t.numpy()
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return _payload(a.shape, a.dtype.name, a.tobytes("C"))


def _payload(shape, name: str, raw: bytes) -> bytes:
    if len(raw) > MAX_CHUNK_SIZE:
        raise ValueError(
            f"an array of {len(raw)} bytes exceeds 2^30: flax writes such "
            "arrays in chunks, which this codec does not")
    out = bytearray()
    _pack((tuple(int(s) for s in shape), name, raw), out)
    return bytes(out)


def _pack(x, out: bytearray) -> None:
    # exact types first, as msgpack's strict_types packer checks them
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
        _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif type(x) in (bytes, bytearray, memoryview):
        raw = bytes(x)
        _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += raw
    elif type(x) in (list, tuple):
        _pack_len(len(x), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in x:
            _pack(v, out)
    elif type(x) is dict:
        _pack_len(len(x), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(_EXT_NDARRAY, _ndarray_payload(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(x)), out)
    elif type(x) is complex:
        body = bytearray()
        _pack((x.real, x.imag), body)
        _pack_ext(_EXT_COMPLEX, bytes(body), out)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def _state_dict(tree):
    """flax's ``to_state_dict`` on plain containers: a tuple or a list
    becomes a dict keyed '0', '1', ...; a named tuple a dict of its
    fields; dicts keep their keys (which must be str)."""
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str):
                raise TypeError(f"state dict keys must be str, got {k!r}")
        return {k: _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _state_dict(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def serialize(tree) -> bytes:
    """``flax.serialization.to_bytes(tree)`` for a tree of dicts, lists,
    tuples and named tuples with array, scalar, str or None leaves."""
    out = bytearray()
    _pack(_state_dict(tree), out)
    return bytes(out)


# -- decoding ------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, ext: bool, raw: bool):
        self.data, self.pos, self.ext, self.raw = data, 0, ext, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def obj(self):
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map_(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.str_(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            v = self.unpack(ints[c])
            return float(v) if c in (0xCA, 0xCB) else v
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in lens:
            return self.take(self.unpack(lens[c]))
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in lens:
            return self.str_(self.unpack(lens[c]))
        if c in (0xDC, 0xDD):
            n = self.unpack(">H" if c == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if c == 0xDE else ">I"))
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixed:
            n = fixed[c]
        elif c in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c])
        else:
            raise ValueError(f"msgpack type byte 0x{c:02x} is not supported")
        code = self.unpack(">b")
        return self.ext_(code, self.take(n))

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext_(self, code: int, data: bytes):
        if not self.ext:
            raise ValueError("nested ext types are not supported")
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            a = _ndarray_from_payload(data)
            if code == _EXT_NPSCALAR:
                return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
            return a
        if code == _EXT_COMPLEX:
            re, im = _plain(data, raw=False)
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not flax's")


def _plain(data: bytes, raw: bool):
    r = _Reader(data, ext=False, raw=raw)
    out = r.obj()
    if r.pos != len(data):
        raise ValueError("trailing bytes after a msgpack object")
    return out


def _ndarray_from_payload(data: bytes):
    shape, name, buf = _plain(data, raw=True)
    shape = tuple(shape)
    if name == b"bfloat16":
        t = torch.frombuffer(bytearray(buf), dtype=torch.int16)
        return t.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape)


def _check_chunks(tree, path="") -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError(
                f"{path or 'the tree'} is a flax chunked array (a leaf over "
                "2^30 bytes); this codec does not read chunked arrays")
        for k, v in tree.items():
            _check_chunks(v, f"{path}/{k}")


def restore(data: bytes):
    """``flax.serialization.msgpack_restore(data)``: nested dicts (and
    lists) with NumPy leaves (``torch.bfloat16`` tensors for bfloat16)."""
    r = _Reader(bytes(data), ext=True, raw=False)
    tree = r.obj()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack tree")
    _check_chunks(tree)
    return tree
