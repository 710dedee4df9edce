"""AudioSegment: load / resample / trim / pad raw audio on the host
(counterpart of edgedict_tpu/data/segment.py, a copy: the reference
parts/segment.py:20-170 surface, minus external backends —
resampling uses scipy polyphase filtering instead of librosa/soundfile).
"""

import numpy as np

from edgedict_tpu_torch.data.audio_io import load_audio


class AudioSegment:
    def __init__(self, samples, sample_rate, target_sr=None, trim=False,
                 trim_db=60):
        samples = np.asarray(samples, np.float32)
        if target_sr is not None and target_sr != sample_rate:
            samples = resample(samples, sample_rate, target_sr)
            sample_rate = target_sr
        if trim:
            samples = trim_silence(samples, trim_db)
        self._samples = samples
        self._sample_rate = sample_rate

    @classmethod
    def from_file(cls, path, target_sr=None, offset=0.0, duration=0.0,
                  trim=False):
        samples, sr = load_audio(path)
        if offset > 0:
            samples = samples[int(offset * sr):]
        if duration > 0:
            samples = samples[:int(duration * sr)]
        return cls(samples, sr, target_sr=target_sr, trim=trim)

    @property
    def samples(self):
        return self._samples

    @property
    def sample_rate(self):
        return self._sample_rate

    @property
    def duration(self):
        return len(self._samples) / self._sample_rate

    def pad(self, pad_size, symmetric=False):
        left = pad_size if symmetric else 0
        self._samples = np.pad(self._samples, (left, pad_size))

    def subsegment(self, start_time=None, end_time=None):
        start = int(round((start_time or 0) * self._sample_rate))
        end = int(round(end_time * self._sample_rate)) \
            if end_time is not None else len(self._samples)
        self._samples = self._samples[start:end]


def resample(samples, orig_sr, target_sr):
    """Polyphase resampling (scipy)."""
    from math import gcd
    from scipy.signal import resample_poly
    g = gcd(int(orig_sr), int(target_sr))
    return resample_poly(samples, target_sr // g, orig_sr // g) \
        .astype(np.float32)


def trim_silence(samples, top_db=60, frame=2048, hop=512):
    """Trim leading/trailing frames more than top_db below peak RMS."""
    if len(samples) < frame:
        return samples
    n = 1 + (len(samples) - frame) // hop
    rms = np.asarray([
        np.sqrt(np.mean(samples[i * hop:i * hop + frame] ** 2))
        for i in range(n)])
    ref = rms.max()
    if ref <= 0:
        return samples
    keep = np.flatnonzero(20 * np.log10(np.maximum(rms, 1e-10) / ref)
                          > -top_db)
    if len(keep) == 0:
        return samples[:0]
    start = keep[0] * hop
    end = min(keep[-1] * hop + frame, len(samples))
    return samples[start:end]
