"""Audio feature frontend (counterpart of edgedict_tpu/features.py).

Waveform (B, L) + lengths → features (B, T', input_size) + lengths, on the
device the pipeline was built for.  The mel power stage is K2
(ops/features_kernel.py: plain on CPU, the CUDA kernel on CUDA); log,
normalization, deltas and frame stacking stay plain tensor code.  With
train=True and a torch.Generator, dither is added to the waveform and
SpecAugment masks the stacked features; SpecAugment's time warp
(W_warp > 0) is not ported yet.

The numpy constant builders (Hann window, Slaney/HTK mel filterbank, DCT)
are copies of the JAX package's, so both packages featurize with the same
constants.
"""

import dataclasses

import numpy as np
import torch

from edgedict_tpu_torch.ops.features_kernel import (  # noqa: F401
    MelTables, frame_signal, mel_power, stft_power)

LOG_GUARD = 1e-20        # reference rnnt/features.py:130
MFCC_LOG_GUARD = 1e-6    # torchaudio MFCC(log_mels=True) guard


# ---------------------------------------------------------------------------
# host-side constants (numpy; copies of edgedict_tpu/features.py)
# ---------------------------------------------------------------------------

def hz_to_mel(f, htk=False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep,
                    mel)


def mel_to_hz(m, htk=False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def mel_filters(sample_rate, n_fft, n_mels, f_min=0.0, f_max=None,
                htk=False, norm='slaney'):
    """Triangular mel filterbank (n_mels, n_fft//2 + 1)."""
    if f_max is None:
        f_max = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk),
                          n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))

    if norm == 'slaney':
        enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
        fb = fb * enorm[:, None]
    return fb.astype(np.float32)


def dct_matrix(n_mfcc, n_mels):
    """Orthonormal DCT-II matrix (n_mels, n_mfcc)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    dct *= np.sqrt(2.0 / n_mels)
    dct[:, 0] = 1.0 / np.sqrt(n_mels)
    return dct.astype(np.float32)


def hann_window(win_length, periodic):
    """torch.hann_window: periodic=True divides by N, False by N-1."""
    n = np.arange(win_length, dtype=np.float64)
    denom = win_length if periodic else win_length - 1
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)
    return w.astype(np.float32)


# ---------------------------------------------------------------------------
# tensor primitives
# ---------------------------------------------------------------------------

def preemphasis(x, coeff=0.97):
    """x[t] - coeff * x[t-1], first sample kept."""
    return torch.cat([x[:, :1], x[:, 1:] - coeff * x[:, :-1]], dim=1)


def compute_deltas(feat, win_length=5):
    """torchaudio.functional.compute_deltas over the time axis of
    (B, T, F), replicate padding."""
    n = (win_length - 1) // 2
    denom = 2.0 * sum(i * i for i in range(1, n + 1))
    t = feat.shape[1]
    padded = torch.cat([feat[:, :1].expand(-1, n, -1), feat,
                        feat[:, -1:].expand(-1, n, -1)], dim=1)
    out = torch.zeros_like(feat)
    for i in range(1, n + 1):
        out = out + i * (padded[:, n + i:n + i + t]
                         - padded[:, n - i:n - i + t])
    return out / denom


def downsample_stack(feat, lengths, n_frame, pad_to_divisible=True):
    """Frame stacking: (B, T, F) → (B, ceil_or_floor(T/n), n*F)."""
    if n_frame <= 1:
        return feat, lengths
    b, t, f = feat.shape
    if pad_to_divisible:
        pad = (-t) % n_frame
        if pad:
            feat = torch.cat([feat, feat.new_zeros(b, pad, f)], dim=1)
        new_len = (lengths + n_frame - 1) // n_frame
    else:
        t = t - t % n_frame
        feat = feat[:, :t]
        new_len = torch.clamp(lengths, max=t) // n_frame
    return feat.reshape(b, -1, n_frame * f), new_len


def normalize_batch(feat, lengths, normalize_type):
    """Masked per-utterance normalization on (B, T, F); std unbiased."""
    if normalize_type not in ('per_feature', 'all_features'):
        return feat
    mask = (torch.arange(feat.shape[1], device=feat.device)[None, :]
            < lengths[:, None]).to(feat.dtype)[..., None]
    cnt = mask.sum(1, keepdim=True)
    if normalize_type == 'all_features':
        cnt = cnt * feat.shape[2]
        mean = (feat * mask).sum((1, 2), keepdim=True) / cnt[:, :1]
        var = (((feat - mean) * mask) ** 2).sum((1, 2), keepdim=True) \
            / torch.clamp(cnt[:, :1] - 1, min=1)
    else:
        mean = (feat * mask).sum(1, keepdim=True) / cnt
        var = (((feat - mean) * mask) ** 2).sum(1, keepdim=True) \
            / torch.clamp(cnt - 1, min=1)
    std = torch.sqrt(var) + 1e-5
    return (feat - mean) / std


def spec_augment(feat, t_mask, t_num, f_mask, f_num, generator):
    """SpecAugment on (B, T, F): per-sample time then frequency masks, zero
    fill, start ~ U[0, dim), width ~ U[0, max_width) (features.py:208-231),
    drawn from `generator` on feat's device."""
    b, t, f = feat.shape
    keep = torch.ones((b, t, f), dtype=torch.bool, device=feat.device)
    for dim, num, width, axis in ((t, t_num, t_mask, 1), (f, f_num, f_mask, 2)):
        if num <= 0 or width <= 0:
            continue
        starts = torch.randint(0, dim, (b, num), generator=generator,
                               device=feat.device)
        widths = torch.randint(0, width, (b, num), generator=generator,
                               device=feat.device)
        pos = torch.arange(dim, device=feat.device)[None, None, :]
        hit = ((pos >= starts[..., None])
               & (pos < (starts + widths)[..., None])).any(dim=1)  # (B, dim)
        hit = hit[:, :, None] if axis == 1 else hit[:, None, :]
        keep = keep & ~hit
    return torch.where(keep, feat, 0.0)


def pcm_to_float(audio):
    """int16 PCM → float32 in [-1, 1) on the tensor's device (1/32768 is a
    power of two: exact); float input passes through as float32."""
    if audio.dtype == torch.int16:
        return audio.float() * (1.0 / 32768.0)
    return audio.float()


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """edgedict_tpu.features.FeatureConfig: inference fields, dither and the
    SpecAugment widths (W_warp > 0, time warp, is refused)."""
    feature_type: str = 'logfbank'   # 'mfcc' | 'melspec' | 'logfbank'
    feature_size: int = 80
    sample_rate: int = 16000
    n_fft: int = 512
    win_length: int = 400
    hop_length: int = 200
    dither: float = 1e-5
    preemph: float = 0.97
    normalize: str = 'none'
    delta: bool = False
    downsample: int = 1
    pad_to_divisible: bool = True
    T_mask: int = 0
    T_num_mask: int = 0
    F_mask: int = 0
    F_num_mask: int = 0
    W_warp: int = 0                  # SpecAugment time warp: not ported
    mfcc_n_mels: int = 128

    @property
    def input_size(self):
        size = self.feature_size
        if self.delta:
            size *= 3
        return size * max(1, self.downsample)


class FeaturePipeline:
    """Waveform (B, L) + lengths → (features (B, T', input_size), lengths).
    Build once per device (the window, filterbank and the K2 tables are
    made here), then call."""

    def __init__(self, cfg: FeatureConfig, device):
        self.cfg = c = cfg
        self.device = torch.device(device)
        if c.feature_type == 'logfbank':
            # FilterbankFeatures: hann periodic=False, slaney mel
            window = hann_window(c.win_length, periodic=False)
            mel = mel_filters(c.sample_rate, c.n_fft, c.feature_size,
                              htk=False, norm='slaney')
            self.dct = None
        else:
            # torchaudio Mel/MFCC: hann periodic=True, htk mel, no norm
            n_mels = c.feature_size if c.feature_type == 'melspec' \
                else c.mfcc_n_mels
            window = hann_window(c.win_length, periodic=True)
            mel = mel_filters(c.sample_rate, c.n_fft, n_mels, htk=True,
                              norm=None)
            self.dct = (torch.as_tensor(dct_matrix(c.feature_size, n_mels),
                                        device=self.device)
                        if c.feature_type == 'mfcc' else None)
        # window zero-padded to n_fft, centred (torch.stft convention)
        left = (c.n_fft - c.win_length) // 2
        window = np.pad(window, (left, c.n_fft - c.win_length - left))
        self.tables = MelTables.build(window, mel, c.n_fft, c.hop_length,
                                      self.device)

    def num_frames(self, num_samples):
        t = 1 + num_samples // self.cfg.hop_length
        if self.cfg.downsample > 1:
            if self.cfg.pad_to_divisible:
                t = -(-t // self.cfg.downsample)
            else:
                t = t // self.cfg.downsample
        return t

    def __call__(self, audio, lengths, train=False, generator=None):
        """train=True adds dither (logfbank) and SpecAugment, drawn from
        `generator` (a torch.Generator on this pipeline's device)."""
        c = self.cfg
        if train:
            if generator is None:
                raise ValueError('train=True needs a torch.Generator')
            if c.W_warp > 0:
                raise NotImplementedError(
                    'SpecAugment time warp (W_warp > 0) is not yet ported')
        audio = pcm_to_float(audio)
        lengths = lengths.to(torch.int32)
        if c.feature_type == 'logfbank':
            if train and c.dither > 0:
                audio = audio + c.dither * torch.randn(
                    audio.shape, generator=generator, device=audio.device)
            if c.preemph is not None:
                audio = preemphasis(audio, c.preemph)
        feat = mel_power(audio.contiguous(), self.tables)
        feat_len = torch.ceil(lengths.float() / c.hop_length).to(torch.int32)

        if c.feature_type == 'logfbank':
            feat = torch.log(feat + LOG_GUARD)
            feat = normalize_batch(feat, feat_len, c.normalize)
            # zero beyond seq_len (rnnt/features.py:137-141)
            mask = torch.arange(feat.shape[1], device=feat.device)[None, :] \
                < feat_len[:, None]
            feat = torch.where(mask[..., None], feat, 0.0)
        elif c.feature_type == 'mfcc':
            feat = torch.log(feat + MFCC_LOG_GUARD)
            feat = torch.einsum('btm,mk->btk', feat, self.dct)

        if c.delta:
            d1 = compute_deltas(feat)
            d2 = compute_deltas(d1)
            feat = torch.cat([feat, d1, d2], dim=-1)

        feat, feat_len = downsample_stack(feat, feat_len, c.downsample,
                                          c.pad_to_divisible)
        if train and (c.T_num_mask > 0 or c.F_num_mask > 0):
            feat = spec_augment(feat, c.T_mask, c.T_num_mask, c.F_mask,
                                c.F_num_mask, generator)
        return feat, feat_len
