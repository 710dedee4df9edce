"""Host-side audio I/O (counterpart of edgedict_tpu/data/audio_io.py):
a pure-stdlib WAV codec (PCM 8/16/24/32 and float32/64), FLAC through
native/libflac_decoder.so (`_native.py`) when built, and soundfile when
importable.  Audio returns as float32 in [-1, 1], mono (channel-averaged),
with its sample rate.
"""

import os
import struct
import wave

import numpy as np

try:                      # optional: FLAC/OGG support when available
    import soundfile as _sf
except Exception:         # pragma: no cover
    _sf = None


def _read_wav(path):
    with wave.open(path, 'rb') as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 1:          # unsigned 8-bit
        x = np.frombuffer(raw, np.uint8).astype(np.float32)
        x = (x - 128.0) / 128.0
    elif width == 2:
        x = np.frombuffer(raw, '<i2').astype(np.float32) / 32768.0
    elif width == 3:        # packed 24-bit
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (b[:, 0].astype(np.int32)
             | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x & 0x800000, x - 0x1000000, x).astype(np.float32)
        x = x / 8388608.0
    elif width == 4:
        x = np.frombuffer(raw, '<i4').astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f'unsupported wav sample width {width}: {path}')
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, sr


def load_audio(path):
    """Load an audio file → (float32 mono samples in [-1,1], sample_rate)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == '.wav':
        try:
            return _read_wav(path)
        except wave.Error:
            pass  # e.g. float32 WAV — fall through
    if ext == '.flac':
        try:
            from edgedict_tpu_torch._native import (
                flac_available, read_flac)
            if flac_available():
                return read_flac(path)
        except ImportError:
            pass
    if _sf is not None:
        x, sr = _sf.read(path, dtype='float32', always_2d=True)
        return x.mean(axis=1), sr
    if ext == '.wav':
        return _read_float_wav(path)
    raise RuntimeError(
        f'cannot decode {path}: build native/libflac_decoder.so, install '
        f'soundfile, or convert to PCM wav')


def _read_float_wav(path):
    """Minimal RIFF parser for IEEE-float WAVs stdlib wave rejects."""
    with open(path, 'rb') as f:
        data = f.read()
    assert data[:4] == b'RIFF' and data[8:12] == b'WAVE', path
    pos, fmt, raw = 12, None, None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack('<I', data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b'fmt ':
            fmt = struct.unpack('<HHIIHH', body[:16])
        elif cid == b'data':
            raw = body
        pos += 8 + size + (size & 1)
    assert fmt is not None and raw is not None, path
    audio_fmt, n_ch, sr, _, _, bits = fmt
    if audio_fmt == 3 and bits == 32:
        x = np.frombuffer(raw, '<f4').astype(np.float32)
    elif audio_fmt == 3 and bits == 64:
        x = np.frombuffer(raw, '<f8').astype(np.float32)
    elif audio_fmt == 1 and bits == 16:
        x = np.frombuffer(raw, '<i2').astype(np.float32) / 32768.0
    else:
        raise ValueError(f'unsupported wav format {fmt}: {path}')
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, sr


def save_wav(path, audio, sample_rate=16000):
    """Write float32 [-1,1] mono audio as 16-bit PCM WAV."""
    x = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype('<i2')
    with wave.open(path, 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
