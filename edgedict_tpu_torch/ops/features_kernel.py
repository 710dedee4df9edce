"""K2 — mel power featurizer (counterpart of
edgedict_tpu/ops/features_pallas.py; kernel in csrc/mel_power.cu).

`mel_power` maps a preemphasized waveform (B, L) to the mel power
(B, 1 + L // hop, n_mels) with torch.stft's center=True convention
(reflect padding of n_fft // 2 per side).  CPU tensors take the plain path
(frame gather, rfft, |.|², filterbank matmul — features.py:stft_power and
the einsum of the JAX pipeline); CUDA tensors launch the kernel once per
call, with the launch plan of ops/features_plan.py, reading the unpadded
audio (the reflection is index arithmetic in the kernel) and the
window-folded DFT pair table of `MelTables`.
"""

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from edgedict_tpu_torch import _build
from edgedict_tpu_torch.ops import features_plan


@dataclasses.dataclass(frozen=True)
class MelTables:
    """Per-pipeline constants on one device, all fp32: the analysis window
    zero-padded to n_fft, the mel filterbank (n_mels, n_freq), and for the
    kernel the window-folded DFT pair table `dft` (table_rows, 2 ·
    table_pairs) of ops/features_plan.py: [cos of the real pairs, zero
    pairs | sin of the same, zero pairs], zero rows past n_fft, for even
    n_fft the sine column of bin 0 (zero) holding the cosine of the
    Nyquist bin; the transposed filterbank (n_freq, n_mels) and each mel's
    band (n_mels, 2) int32: the bins [lo, hi) that hold its nonzero weights
    (0, 0 for an all-zero filter), so that the kernel skips the
    filterbank's zeros."""
    window: torch.Tensor
    mel: torch.Tensor
    dft: torch.Tensor
    mel_t: torch.Tensor
    mel_band: torch.Tensor
    n_fft: int
    hop: int

    @classmethod
    def build(cls, window, mel, n_fft, hop, device):
        """window (n_fft,) and mel (n_mels, n_freq) numpy → device tables.
        The DFT angles are formed in float64 on the host, as
        features_pallas.py:100-108 forms them."""
        n_freq = n_fft // 2 + 1
        ang = -2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(n_freq)) \
            / n_fft
        win = np.asarray(window, np.float32).astype(np.float64)[:, None]
        cos, sin = np.cos(ang) * win, np.sin(ang) * win
        nb = features_plan.real_pairs(n_fft)
        if n_fft % 2 == 0:
            sin[:, 0] = cos[:, nb]
        dft = np.zeros((features_plan.table_rows(n_fft),
                        2 * features_plan.table_pairs(n_fft)))
        half = dft.shape[1] // 2
        dft[:n_fft, :nb], dft[:n_fft, half:half + nb] = cos[:, :nb], \
            sin[:, :nb]
        f32 = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a, np.float32), device=device)
        nz = np.asarray(mel, np.float32) != 0
        lo = np.where(nz.any(1), nz.argmax(1), 0)
        hi = np.where(nz.any(1), nz.shape[1] - nz[:, ::-1].argmax(1), 0)
        band = torch.as_tensor(np.stack([lo, hi], 1).astype(np.int32),
                               device=device)
        return cls(window=f32(window), mel=f32(mel), mel_band=band,
                   dft=f32(dft), mel_t=f32(np.asarray(mel).T), n_fft=n_fft,
                   hop=hop)


def reflect_pad(x, n_fft):
    """(B, L) → (B, L + 2 * (n_fft // 2)) reflect padding (no edge
    repeat: numpy/jnp mode='reflect', torch.stft center=True)."""
    p = n_fft // 2
    return F.pad(x.unsqueeze(1), (p, p), mode='reflect').squeeze(1)


def frame_signal(x, n_fft, hop_length):
    """(B, L) → (B, 1 + L // hop, n_fft) centred frames."""
    x = reflect_pad(x, n_fft)
    return x.unfold(1, n_fft, hop_length)


def stft_power(x, window, n_fft, hop_length):
    """Power spectrogram |STFT|² (B, L) → (B, T, n_fft // 2 + 1)."""
    return _power(frame_signal(x, n_fft, hop_length) * window)


def _power(frames, dtype=torch.float32):
    spec = torch.fft.rfft(frames.to(dtype), dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def mel_power_plain(audio, tables: MelTables):
    """(B, L) → (B, 1 + L // hop, n_mels): frames of the reflect-padded row
    and, for odd n_fft, one zero past it, so that every n_fft gives the
    kernel's (and mel_power_pallas's) frame count; then stft_power's rfft
    and |.|² and the filterbank.  In fp32, or in fp64 for fp64 audio and
    tables (a reference for the kernel)."""
    x = reflect_pad(audio, tables.n_fft)
    if tables.n_fft % 2:
        x = F.pad(x, (0, 1))
    spec = _power(x.unfold(1, tables.n_fft, tables.hop) * tables.window,
                  torch.promote_types(audio.dtype, torch.float32))
    return torch.einsum('btf,mf->btm', spec, tables.mel)


@functools.lru_cache(maxsize=64)
def _plan(batch, length, n_fft, hop, n_mels, n_sms):
    return features_plan.mel_plan(batch, length, n_fft, hop, n_mels, n_sms)


_COUNTS = {}   # (device, stream) → the split's tile counters


def _counts(device, n):
    """The few-frame split's tile counters of the current stream on
    `device` (int32, at least n): zeroed once when made, left at 0 by every
    launch.  One buffer per stream, so that calls overlapping on two
    streams never count into the same counters."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    c = _COUNTS.get(key)
    if c is None or c.numel() < n:
        c = _COUNTS[key] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                       device=device)
    return c


@_build.on_tensor_device
def mel_power(audio, tables: MelTables):
    """audio (B, L) fp32, preemphasized → mel power (B, 1 + L // hop,
    n_mels) fp32.  CUDA tensors launch csrc/mel_power.cu once (K2);
    ValueError for a shape outside ops/features_plan.py's plan."""
    if audio.device.type == 'cpu':
        return mel_power_plain(audio, tables)
    _build.require_cuda(audio, 'audio', (torch.float32,))
    for name in ('dft', 'mel_t'):
        _build.require_cuda(getattr(tables, name), name, (torch.float32,))
    _build.require_cuda(tables.mel_band, 'mel_band', (torch.int32,))
    b, length = audio.shape
    n_fft, hop = tables.n_fft, tables.hop
    n_mels = tables.mel_t.shape[1]
    dev = audio.device
    plan = _plan(b, length, n_fft, hop, n_mels, _build.sm_count(dev))
    t = features_plan.frames_of(length, hop)
    out = torch.empty((b, t, n_mels), dtype=torch.float32, device=dev)
    part = count = None
    if plan.split:
        part = torch.empty(plan.scratch_floats, dtype=torch.float32,
                           device=dev)
        count = _counts(dev, plan.tiles)
    p = _build.ptr
    _build.check(_build.library().edd_mel_power(
        p(audio), p(tables.dft), p(tables.mel_t), p(tables.mel_band), p(out),
        p(part), p(count), length, t, n_fft, hop, n_mels,
        tables.dft.shape[1] // 2, plan.row_groups, plan.col_groups,
        plan.depth_split, plan.passes, plan.slices, plan.chunk_rows,
        plan.tiles_per_row, plan.span, plan.blocks, plan.smem,
        _build.stream_ptr(dev)), 'mel_power')
    mel_power.launches += 1
    return out


mel_power.launches = 0
