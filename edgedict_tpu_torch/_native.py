"""ctypes bindings for the repo's host-side C++ libraries in `native/`
(counterpart of edgedict_tpu/native.py: the CharBPE merge engine, the
BPE trainer, the FLAC decoder, the CPU RNN-T loss, the cross-check of the
loss, and the token-budget / fixed-shape bucketing).

Build them with `make -C native`.  Each binding is optional: when a `.so`
is missing, `available()` says so and the callers (tokenizer.py,
data/audio_io.py) take their pure-Python paths.
"""

import ctypes
import os

import numpy as np

# .so lookup: EDGEDICT_NATIVE_DIR override, else <repo root>/native
_NATIVE_DIR = os.environ.get('EDGEDICT_NATIVE_DIR') or os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'native')


def _load(name):
    path = os.path.join(_NATIVE_DIR, name)
    if not os.path.exists(path):
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


_bpe = _load('libchar_bpe.so')
_flac = _load('libflac_decoder.so')
_bpe_tr = _load('libbpe_trainer.so')
_rnnt = _load('librnnt_loss.so')
_bucket = _load('libbucketing.so')

if _bpe is not None:
    _bpe.bpe_create.restype = ctypes.c_void_p
    _bpe.bpe_encode_word.restype = ctypes.c_int
if _flac is not None:
    _flac.flac_probe.restype = ctypes.c_int
    _flac.flac_decode.restype = ctypes.c_int64
    if hasattr(_flac, 'flac_decode_mono_f32'):
        _flac.flac_decode_mono_f32.restype = ctypes.c_int64
if _bpe_tr is not None:
    _bpe_tr.bpe_trainer_create.restype = ctypes.c_void_p
    _bpe_tr.bpe_trainer_add_symbol.restype = ctypes.c_int32
    _bpe_tr.bpe_trainer_train.restype = ctypes.c_int
if _bucket is not None:
    _bucket.batch_by_size.restype = ctypes.c_int
    _bucket.batch_fixed_shapes.restype = ctypes.c_int
if _rnnt is not None:
    _F32, _I32 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    _rnnt.rnnt_loss_cpu.restype = ctypes.c_int
    _rnnt.rnnt_loss_cpu.argtypes = [_F32, _I32, _I32, _I32] + \
        [ctypes.c_int] * 5 + [_F32, _F32]


def available():
    return {'char_bpe': _bpe is not None, 'flac': _flac is not None,
            'bpe_trainer': _bpe_tr is not None,
            'rnnt_loss': _rnnt is not None,
            'bucketing': _bucket is not None}


def _ptr(a, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


def rnnt_loss_cpu(logits, labels, xlen, ylen):
    """native/rnnt_loss.cpp: (per-sample loss (B,), its gradient (B, T,
    U+1, V)) of (B, T, U+1, V) logits, blank id 0 (numpy, fp32)."""
    assert _rnnt is not None, 'build native/librnnt_loss.so first'
    logits = np.ascontiguousarray(logits, np.float32)
    labels = np.ascontiguousarray(labels, np.int32)
    xlen = np.ascontiguousarray(xlen, np.int32)
    ylen = np.ascontiguousarray(ylen, np.int32)
    b, t, u1, v = logits.shape
    if labels.shape != (b, u1 - 1) or xlen.shape != (b,) or \
            ylen.shape != (b,):
        raise ValueError(f'labels {labels.shape}, xlen {xlen.shape}, ylen '
                         f'{ylen.shape} do not fit logits {logits.shape}')
    loss = np.zeros((b,), np.float32)
    grad = np.zeros_like(logits)
    ret = _rnnt.rnnt_loss_cpu(
        _ptr(logits, ctypes.c_float), _ptr(labels, ctypes.c_int32),
        _ptr(xlen, ctypes.c_int32), _ptr(ylen, ctypes.c_int32),
        b, t, u1, v, 0, _ptr(loss, ctypes.c_float),
        _ptr(grad, ctypes.c_float))
    if ret != 0:
        raise RuntimeError(f'rnnt_loss_cpu returned {ret}')
    return loss, grad


def train_bpe_merges(word_freqs, initial_symbols, max_merges,
                     min_frequency=2):
    """Learn BPE merges natively.  word_freqs: [(symbol tuple, freq)];
    initial_symbols: the ORDERED initial symbols.  → [(left, right)],
    identical to the pure-Python trainer's (same tie-breaking)."""
    assert _bpe_tr is not None, 'build native/libbpe_trainer.so first'
    h = ctypes.c_void_p(_bpe_tr.bpe_trainer_create())
    try:
        sym_id = {}
        for s in initial_symbols:
            sym_id[s] = _bpe_tr.bpe_trainer_add_symbol(h, s.encode('utf-8'))
        for symbols, freq in word_freqs:
            ids = np.asarray([sym_id[s] for s in symbols], np.int32)
            _bpe_tr.bpe_trainer_add_word(h, _ptr(ids, ctypes.c_int32),
                                         len(ids), ctypes.c_int64(int(freq)))
        out = np.zeros((max(max_merges, 1), 2), np.int32)
        n = _bpe_tr.bpe_trainer_train(h, max_merges,
                                      ctypes.c_int64(min_frequency),
                                      _ptr(out, ctypes.c_int32))
        names = list(initial_symbols)
        merges = []
        for i in range(n):
            a, b = int(out[i, 0]), int(out[i, 1])
            merges.append((names[a], names[b]))
            names.append(names[a] + names[b])
        return merges
    finally:
        _bpe_tr.bpe_trainer_destroy(h)


def flac_available():
    return _flac is not None


def read_flac(path):
    """Decode a FLAC file → (float32 mono samples in [-1, 1], sample
    rate) via native/flac_decoder.cpp."""
    assert _flac is not None, 'build native/libflac_decoder.so first'
    with open(path, 'rb') as f:
        data = np.frombuffer(f.read(), np.uint8)
    sr, ch, bps = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    total = ctypes.c_int64()
    ret = _flac.flac_probe(_ptr(data, ctypes.c_uint8), len(data),
                           ctypes.byref(sr), ctypes.byref(ch),
                           ctypes.byref(bps), ctypes.byref(total))
    if ret != 0:
        raise ValueError(f'not a FLAC stream: {path}')
    n = int(total.value) or len(data) * 8 // max(bps.value, 1)
    if hasattr(_flac, 'flac_decode_mono_f32'):
        out = np.zeros((n,), np.float32)
        frames = _flac.flac_decode_mono_f32(
            _ptr(data, ctypes.c_uint8), len(data),
            _ptr(out, ctypes.c_float), n)
        if frames < 0:
            raise ValueError(f'FLAC decode failed: {path}')
        return out[:frames], int(sr.value)
    out = np.zeros((n * ch.value,), np.int32)
    frames = _flac.flac_decode(_ptr(data, ctypes.c_uint8), len(data),
                               _ptr(out, ctypes.c_int32), n)
    if frames < 0:
        raise ValueError(f'FLAC decode failed: {path}')
    pcm = out[:frames * ch.value].reshape(-1, ch.value).astype(np.float32)
    pcm = pcm.mean(axis=1) / float(1 << (bps.value - 1))
    return pcm, int(sr.value)


class NativeBPE:
    """Merge engine over int32 symbol ids (Unicode handled by the
    caller)."""

    def __init__(self, merges_ids):
        """merges_ids: [(left_id, right_id, merged_id)]."""
        assert _bpe is not None, 'build native/libchar_bpe.so first'
        arr = np.ascontiguousarray(merges_ids, np.int32).reshape(-1, 3)
        self._handle = ctypes.c_void_p(_bpe.bpe_create(
            len(arr), _ptr(np.ascontiguousarray(arr[:, 0]), ctypes.c_int32),
            _ptr(np.ascontiguousarray(arr[:, 1]), ctypes.c_int32),
            _ptr(np.ascontiguousarray(arr[:, 2]), ctypes.c_int32)))

    def encode_word(self, sym_ids):
        syms = np.ascontiguousarray(sym_ids, np.int32)
        out = np.zeros((max(len(syms), 1),), np.int32)
        n = _bpe.bpe_encode_word(self._handle, _ptr(syms, ctypes.c_int32),
                                 len(syms), _ptr(out, ctypes.c_int32))
        return out[:n].tolist()

    def __del__(self):
        if _bpe is not None and getattr(self, '_handle', None):
            _bpe.bpe_destroy(self._handle)
            self._handle = None


# ---------------------------------------------------------------------------
# bucketing (native/bucketing.cpp)
# ---------------------------------------------------------------------------

def batch_by_size(indices, num_tokens, max_tokens=None, max_sentences=None,
                  bsz_mult=1):
    """Greedy token-budget batching → list of index lists."""
    assert _bucket is not None, 'build native/libbucketing.so first'
    indices = np.ascontiguousarray(indices, np.int64)
    num_tokens = np.ascontiguousarray(num_tokens, np.int64)
    n = len(indices)
    out_idx = np.zeros((n,), np.int64)
    out_sizes = np.zeros((n,), np.int64)
    nb = _bucket.batch_by_size(
        _ptr(indices, ctypes.c_int64), _ptr(num_tokens, ctypes.c_int64),
        n, max_tokens or -1, max_sentences or -1, bsz_mult,
        _ptr(out_idx, ctypes.c_int64), _ptr(out_sizes, ctypes.c_int64))
    batches, pos = [], 0
    for i in range(nb):
        sz = int(out_sizes[i])
        batches.append(out_idx[pos:pos + sz].tolist())
        pos += sz
    return batches


def batch_fixed_shapes(indices, num_tokens, shapes):
    """Pack into a menu of (batch_size, max_len) shapes → list of
    (index_list, shape_row)."""
    assert _bucket is not None, 'build native/libbucketing.so first'
    indices = np.ascontiguousarray(indices, np.int64)
    num_tokens = np.ascontiguousarray(num_tokens, np.int64)
    shapes_a = np.ascontiguousarray(shapes, np.int64).reshape(-1, 2)
    # the C side walks the menu by max_len ascending
    shapes_a = shapes_a[np.argsort(shapes_a[:, 1])]
    n = len(indices)
    out_idx = np.zeros((n,), np.int64)
    out_sizes = np.zeros((n,), np.int64)
    out_shape_ids = np.zeros((n,), np.int64)
    nb = _bucket.batch_fixed_shapes(
        _ptr(indices, ctypes.c_int64), _ptr(num_tokens, ctypes.c_int64),
        n, _ptr(shapes_a, ctypes.c_int64), len(shapes_a),
        _ptr(out_idx, ctypes.c_int64), _ptr(out_sizes, ctypes.c_int64),
        _ptr(out_shape_ids, ctypes.c_int64))
    batches, pos = [], 0
    for i in range(nb):
        sz = int(out_sizes[i])
        batches.append((out_idx[pos:pos + sz].tolist(),
                        tuple(shapes_a[int(out_shape_ids[i])])))
        pos += sz
    return batches
