"""Reader of the JAX package's checkpoints (edgedict_tpu/checkpoint.py:
`flax.serialization.to_bytes` of a state dict), without flax or msgpack.

The msgpack subset that flax writes (flax/serialization.py:249-390): nil,
bool, positive / negative fixint, uint / int 8-64, float 32 / 64, str, bin,
array and map; ext 1 (an ndarray: a msgpack (shape, dtype name, buffer)),
ext 2 (a complex: (real, imag)) and ext 3 (a numpy scalar, packed as a 0-d
ndarray).  Arrays over 2**30 bytes arrive as `__msgpack_chunked_array__`
maps and are joined back.  An array is a numpy view of the file's bytes
(`np.frombuffer`, so reading is linear in the file size); a 'bfloat16' one
(numpy has none) is read as uint16 and viewed as a torch.bfloat16 tensor.
An unknown type code, ext type or dtype, and bytes that end early, raise
ValueError.

`load_jax_checkpoint(path)` → the payload dict {'step', 'model', 'optim',
'sched', 'extra'}: the trees as flax wrote them (lists and tuples as
'0', '1', ... keyed maps: `unstate` turns those back into lists), `extra`
decoded from its JSON.
"""

import json
import struct

import numpy as np
import torch

# a flax payload is a msgpack map (fixmap 0x81-0x8f, map16 0xde, map32
# 0xdf); a torch file is a zip ('PK') or, written by an old torch, a
# pickle (0x80, then the protocol byte)
_MAP_HEADS = frozenset(range(0x81, 0x90)) | {0xde, 0xdf}
_CHUNKED = '__msgpack_chunked_array__'
# msgpack type codes: constants, (kind, length format), numbers, fixext
_SIMPLE = {0xc0: None, 0xc2: False, 0xc3: True}
_SIZED = {0xc4: ('bin', 'B'), 0xc5: ('bin', '>H'), 0xc6: ('bin', '>I'),
          0xd9: ('str', 'B'), 0xda: ('str', '>H'), 0xdb: ('str', '>I'),
          0xdc: ('array', '>H'), 0xdd: ('array', '>I'),
          0xde: ('map', '>H'), 0xdf: ('map', '>I'),
          0xc7: ('ext', 'B'), 0xc8: ('ext', '>H'), 0xc9: ('ext', '>I')}
_NUMBERS = {0xca: '>f', 0xcb: '>d', 0xcc: 'B', 0xcd: '>H', 0xce: '>I',
            0xcf: '>Q', 0xd0: 'b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def is_jax_checkpoint(path):
    """True when `path` holds a flax-msgpack payload (its first bytes; the
    extension tells nothing: both packages write .ckpt)."""
    with open(path, 'rb') as f:
        head = f.read(2)
    return len(head) >= 1 and head[0] in _MAP_HEADS


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n):
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f'msgpack: truncated at byte {self.pos} '
                             f'(wanted {n} of {len(self.buf) - self.pos})')
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        c = self.unpack('B')
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return self.array(c & 0x0f)
        if 0xa0 <= c <= 0xbf:
            return self.str(c & 0x1f)
        if c in _SIMPLE:
            return _SIMPLE[c]
        if c in _SIZED:
            kind, fmt = _SIZED[c]
            return getattr(self, kind)(self.unpack(fmt))
        if c in _NUMBERS:
            return self.unpack(_NUMBERS[c])
        if c in _FIXEXT:
            return self.ext(_FIXEXT[c])
        raise ValueError(f'msgpack: unknown type code 0x{c:02x} at byte '
                         f'{self.pos - 1}')

    def bin(self, n):
        return self.take(n)

    def str(self, n):
        return str(self.take(n), 'utf-8')

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n):
        code = self.unpack('b')
        data = self.take(n)
        if code == 1:
            return _ndarray(data)
        if code == 2:
            real, imag = _Reader(data).value()
            return complex(real, imag)
        if code == 3:                   # a numpy scalar as a 0-d array
            arr = _ndarray(data)
            return arr[()] if isinstance(arr, np.ndarray) else arr
        raise ValueError(f'msgpack: unknown ext type {code}')


def _ndarray(data):
    """flax's _ndarray_to_bytes payload → an array viewing `data`."""
    inner = _Reader(data)
    shape, name, buffer = inner.value()
    if inner.pos != len(inner.buf):
        raise ValueError('msgpack: trailing bytes in an ndarray')
    if name == 'bfloat16':
        raw = np.frombuffer(buffer, np.uint16).reshape(shape)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f'msgpack: unknown dtype {name!r}') from None
    if dtype.hasobject:
        raise ValueError(f'msgpack: unknown dtype {name!r}')
    count = int(np.prod(shape, dtype=np.int64))
    if count * dtype.itemsize != len(buffer):
        raise ValueError(f'msgpack: {len(buffer)} bytes for a {name} array '
                         f'of shape {tuple(shape)}')
    return np.frombuffer(buffer, dtype).reshape(shape)


def _unchunk(tree):
    """Join `__msgpack_chunked_array__` maps back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = [tree['shape'][str(i)] for i in range(len(tree['shape']))]
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data):
    """flax.serialization.msgpack_restore of `data` (bytes-like): the whole
    buffer must be one value."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f'msgpack: {len(reader.buf) - reader.pos} bytes '
                         'after the value')
    return _unchunk(out)


def unstate(tree):
    """A flax state dict → the pytree: maps keyed '0', '1', ... back into
    lists (edgedict_tpu/raw_trainer.py:22 `_unstate`)."""
    if isinstance(tree, dict):
        if tree and all(isinstance(k, str) and k.isdigit() for k in tree):
            return [unstate(tree[str(i)]) for i in range(len(tree))]
        return {k: unstate(v) for k, v in tree.items()}
    return tree


def load_jax_checkpoint(path):
    """A JAX package checkpoint → its payload dict, `extra` decoded from
    JSON (None when empty), `model` with its lists restored."""
    with open(path, 'rb') as f:
        data = bytearray(f.read())      # writable, so the arrays are too
    raw = msgpack_restore(data)
    if not isinstance(raw, dict) or 'model' not in raw:
        raise ValueError(f'{path}: not a JAX package checkpoint')
    extra = raw.get('extra')
    raw['extra'] = json.loads(extra) if extra else None
    raw['model'] = unstate(raw['model'])
    return raw
