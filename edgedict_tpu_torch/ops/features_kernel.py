"""K2 — mel power featurizer (counterpart of
edgedict_tpu/ops/features_pallas.py; kernel in csrc/mel_power.cu).

`mel_power` maps a preemphasized waveform (B, L) to the mel power
(B, 1 + L // hop, n_mels) with torch.stft's center=True convention
(reflect padding of n_fft // 2 per side).  CPU tensors take the plain path
(frame gather, rfft, |.|², filterbank matmul — features.py:stft_power and
the einsum of the JAX pipeline); CUDA tensors launch the kernel, which
reads the window-folded DFT tables of `MelTables`.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from edgedict_tpu_torch import _build


@dataclasses.dataclass(frozen=True)
class MelTables:
    """Per-pipeline constants on one device, all fp32: the analysis window
    zero-padded to n_fft, the mel filterbank (n_mels, n_freq), and for the
    kernel the window-folded DFT tables (n_fft, n_freq) and the transposed
    filterbank (n_freq, n_mels)."""
    window: torch.Tensor
    mel: torch.Tensor
    wcos: torch.Tensor
    wsin: torch.Tensor
    mel_t: torch.Tensor
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
        f32 = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a, np.float32), device=device)
        return cls(window=f32(window), mel=f32(mel),
                   wcos=f32(np.cos(ang) * win), wsin=f32(np.sin(ang) * win),
                   mel_t=f32(np.asarray(mel).T), n_fft=n_fft, hop=hop)


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
    frames = frame_signal(x, n_fft, hop_length) * window
    spec = torch.fft.rfft(frames.float(), dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def mel_power_plain(audio, tables: MelTables):
    spec = stft_power(audio, tables.window, tables.n_fft, tables.hop)
    return torch.einsum('btf,mf->btm', spec, tables.mel)


def mel_power(audio, tables: MelTables):
    """audio (B, L) fp32, preemphasized → mel power (B, 1 + L // hop,
    n_mels) fp32."""
    if audio.device.type == 'cpu':
        return mel_power_plain(audio, tables)
    _build.require_cuda(audio, 'audio', (torch.float32,))
    for name in ('wcos', 'wsin', 'mel_t'):
        _build.require_cuda(getattr(tables, name), name, (torch.float32,))
    b, length = audio.shape
    n_fft, hop = tables.n_fft, tables.hop
    if length <= n_fft // 2:
        raise ValueError(f'mel_power: {length} samples cannot be reflect-'
                         f'padded by {n_fft // 2}')
    n_freq, n_mels = tables.mel_t.shape
    t = 1 + length // hop
    audio_p = reflect_pad(audio, n_fft).contiguous()
    out = torch.empty((b, t, n_mels), dtype=torch.float32,
                      device=audio.device)
    lib = _build.library()
    p = _build.ptr
    _build.check(lib.edd_mel_power(
        p(audio_p), audio_p.shape[1], p(tables.wcos), p(tables.wsin),
        p(tables.mel_t), p(out), b, t, n_fft, hop, n_freq, n_mels,
        _build.stream_ptr(audio.device)), 'mel_power')
    mel_power.launches += 1
    return out


mel_power.launches = 0
