"""NVIDIA Jasper-style alternative featurizer family (counterpart of
edgedict_tpu/data/nvidia_features.py; reference parts/features.py:125-398:
SpectrogramFeatures, FilterbankFeatures, splice_frames, FeatureFactory,
AudioPreprocessing).

A parallel surface to features.py with the Jasper config vocabulary
(window_size / window_stride in SECONDS, feat_type strings, `pad_to`,
magnitude or power spectrograms).  The featurizers are nn.Modules over
(x (B, L), seq_len (B,)) → (B, F', T'); they run plain tensor ops
(torch.fft.rfft) on the device of their input, as the JAX version runs no
Pallas kernel.

splice_frames implements the documented semantics (each frame stacked with
its n following frames, the sequence end repeated), not the reference
copy's identity concatenation (parts/features.py:113-123), as the JAX
package does.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from edgedict_tpu_torch.features import (
    hann_window, mel_filters, normalize_batch, preemphasis, stft_power)

LOG_GUARD = 1e-20


def _window(kind, win_length):
    """Analysis windows by name (reference torch_windows table)."""
    n = np.arange(win_length)
    if kind == 'hann':
        return np.asarray(hann_window(win_length, periodic=False))
    if kind == 'hamming':
        return (0.54 - 0.46 * np.cos(2 * np.pi * n / (win_length - 1))
                ).astype(np.float32)
    if kind == 'blackman':
        x = 2 * np.pi * n / (win_length - 1)
        return (0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2 * x)
                ).astype(np.float32)
    if kind == 'bartlett':
        return (1.0 - np.abs(2 * n / (win_length - 1) - 1.0)
                ).astype(np.float32)
    if kind == 'none':
        return np.ones(win_length, np.float32)
    raise ValueError(f'unknown window {kind!r}')


def splice_frames(x, frame_splicing):
    """Stack each frame with its following frames: (B, F, T) →
    (B, F·s, T); frame t gets rows [x[t], x[t+1], ..., x[t+s−1]] with the
    sequence end repeated."""
    seq = [x]
    for n in range(1, frame_splicing):
        seq.append(torch.cat([x[:, :, n:], x[:, :, -1:].repeat(1, 1, n)],
                             dim=2))
    return torch.cat(seq, dim=1)


@dataclasses.dataclass(frozen=True)
class NvidiaFeatConfig:
    """Shared config (reference from_config vocabulary: window_size /
    window_stride in seconds)."""
    sample_rate: int = 8000
    window_size: float = 0.02
    window_stride: float = 0.01
    window: str = 'hamming'
    normalize: str = 'per_feature'
    n_fft: Optional[int] = None
    preemph: Optional[float] = 0.97
    nfilt: int = 64
    lowfreq: float = 0.0
    highfreq: Optional[float] = None
    log: bool = True
    dither: float = 1e-5
    pad_to: int = 8
    max_duration: float = 16.7
    frame_splicing: int = 1

    @property
    def win_length(self):
        return int(self.sample_rate * self.window_size)

    @property
    def hop_length(self):
        return int(self.sample_rate * self.window_stride)

    @property
    def fft_size(self):
        return self.n_fft or 2 ** math.ceil(math.log2(self.win_length))

    @property
    def max_length(self):
        """Reference max-frames padding for pad_to < 0 ("max")."""
        max_length = 1 + math.ceil(
            (self.max_duration * self.sample_rate - self.win_length)
            / self.hop_length)
        return max_length + (16 - max_length % 16)


class _BaseFeatures(torch.nn.Module):
    """(x (B, L), seq_len (B,)) → (B, F', T') featurizer skeleton shared by
    the spectrogram and filterbank variants; the window (and filterbank)
    are buffers, used on the input's device."""

    uses_mel = False
    uses_preemph = False

    def __init__(self, cfg: NvidiaFeatConfig):
        super().__init__()
        self.cfg = cfg
        window = _window(cfg.window, cfg.win_length)
        left = (cfg.fft_size - cfg.win_length) // 2
        self.register_buffer('window', torch.as_tensor(np.pad(
            window, (left, cfg.fft_size - cfg.win_length - left))))
        if self.uses_mel:
            # librosa.filters.mel defaults: htk=False, norm='slaney'
            self.register_buffer('fb', torch.as_tensor(mel_filters(
                cfg.sample_rate, cfg.fft_size, cfg.nfilt,
                f_min=cfg.lowfreq, f_max=cfg.highfreq,
                htk=False, norm='slaney')))

    def get_seq_len(self, seq_len):
        return torch.ceil(seq_len.float()
                          / self.cfg.hop_length).to(torch.int32)

    def _spectrum(self, power):
        raise NotImplementedError

    def forward(self, x, seq_len, generator=None):
        """Dither is drawn from `generator` (a torch.Generator on x's
        device) when one is given and cfg.dither > 0."""
        c = self.cfg
        x = x.float()
        seq_len = self.get_seq_len(seq_len.to(x.device))
        if c.dither > 0 and generator is not None:
            x = x + c.dither * torch.randn(x.shape, generator=generator,
                                           device=x.device)
        if self.uses_preemph and c.preemph is not None:
            x = preemphasis(x, c.preemph)
        power = stft_power(x, self.window.to(x.device), c.fft_size,
                           c.hop_length)
        feat = self._spectrum(power)                # (B, T, F')
        if c.log:
            feat = torch.log(feat + LOG_GUARD)
        feat = feat.transpose(1, 2)                  # (B, F', T) like torch
        if c.frame_splicing > 1:
            feat = splice_frames(feat, c.frame_splicing)
        feat = normalize_batch(feat.transpose(1, 2), seq_len,
                               c.normalize).transpose(1, 2)
        # zero beyond seq_len, pad T to a multiple of pad_to (reference
        # masked_fill + functional.pad)
        t = feat.shape[-1]
        mask = torch.arange(t, device=x.device)[None, :] < seq_len[:, None]
        feat = torch.where(mask[:, None, :], feat, 0.0)
        if c.pad_to < 0:
            feat = F.pad(feat, (0, c.max_length - t))
        elif c.pad_to > 0:
            feat = F.pad(feat, (0, c.pad_to - t % c.pad_to))
        return feat

    @classmethod
    def from_config(cls, cfg: dict, log=False):
        return cls(NvidiaFeatConfig(
            sample_rate=cfg['sample_rate'], window_size=cfg['window_size'],
            window_stride=cfg['window_stride'], n_fft=cfg.get('n_fft'),
            window=cfg.get('window', 'hamming'),
            normalize=cfg.get('normalize', 'per_feature'),
            nfilt=cfg.get('features', 64),
            max_duration=cfg.get('max_duration', 16.7),
            dither=cfg.get('dither', 1e-5), pad_to=cfg.get('pad_to', 0),
            frame_splicing=cfg.get('frame_splicing', 1), log=log))


class SpectrogramFeatures(_BaseFeatures):
    """Magnitude (log-)spectrogram (reference parts/features.py:125-225):
    |STFT|, no mel, no preemphasis."""

    def _spectrum(self, power):
        return torch.sqrt(power)


class NvidiaFilterbankFeatures(_BaseFeatures):
    """Mel (log-)filterbank (reference parts/features.py:228-355):
    preemphasis → |STFT|² → librosa mel."""

    uses_mel = True
    uses_preemph = True

    def _spectrum(self, power):
        return torch.einsum('btf,mf->btm', power, self.fb.to(power.device))


class FeatureFactory:
    """feat_type string → featurizer (reference parts/features.py:357-373)."""

    featurizers = {
        'logfbank': NvidiaFilterbankFeatures,
        'fbank': NvidiaFilterbankFeatures,
        'stft': SpectrogramFeatures,
        'logspect': SpectrogramFeatures,
        'logstft': SpectrogramFeatures,
    }

    @classmethod
    def from_config(cls, cfg: dict):
        feat_type = cfg.get('feat_type', 'logspect')
        featurizer = cls.featurizers[feat_type]
        return featurizer.from_config(cfg, log='log' in feat_type)


class AudioPreprocessing(torch.nn.Module):
    """Single-utterance wrapper (reference parts/features.py:375-398):
    (L,) waveform → (F', T') features, optionally transposed to (T', F')."""

    def __init__(self, **kwargs):
        super().__init__()
        self.featurizer = FeatureFactory.from_config(kwargs)
        self.transpose_out = kwargs.get('transpose_out', False)

    def forward(self, input_signal, generator=None):
        length = torch.tensor([input_signal.shape[-1]], dtype=torch.int32,
                              device=input_signal.device)
        feat = self.featurizer(input_signal[None, :], length,
                               generator=generator)[0]
        return feat.transpose(0, 1) if self.transpose_out else feat
