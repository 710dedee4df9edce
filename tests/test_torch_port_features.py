"""Port featurizer (edgedict_tpu_torch/features.py, K2's plain version in
ops/features_kernel.py) == the JAX featurizer: the XLA stft path and the
Pallas mel-power kernel in interpret mode, on the same numpy audio."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edgedict_tpu import features as JF
from edgedict_tpu.ops.features_pallas import mel_power_pallas
from edgedict_tpu_torch import features as PF
from edgedict_tpu_torch.ops import features_kernel as K2

# log-mel: JAX's own Pallas-vs-XLA bound (tests/test_features.py:213)
LOG_RTOL, LOG_ATOL = 1e-3, 5e-3


def _audio(b, n, seed=0):
    x = np.random.RandomState(seed).randn(b, n).astype(np.float32) * 0.3
    x[:, : n // 5] *= 1e-4                  # near-silent stretch
    return x


def _tables(cfg):
    return PF.FeaturePipeline(cfg, 'cpu').tables


def test_mel_power_plain_matches_pallas_interpret():
    cfg = PF.FeatureConfig(feature_size=16, n_fft=128, win_length=80,
                           hop_length=40)
    tables = _tables(cfg)
    x = _audio(2, 1000)
    ref = mel_power_pallas(jnp.asarray(x), jnp.asarray(tables.window),
                           jnp.asarray(tables.mel), 128, 40)
    out = K2.mel_power(torch.from_numpy(x), tables)
    assert out.shape == ref.shape == (2, 1 + 1000 // 40, 16)
    np.testing.assert_allclose(np.log(out.numpy() + 1e-20),
                               np.log(np.asarray(ref) + 1e-20),
                               LOG_RTOL, LOG_ATOL)


def test_stft_power_matches_jax_xla():
    x = _audio(3, 777, seed=1)
    window = np.pad(PF.hann_window(50, periodic=False), (7, 7))
    ref = JF.stft_power(jnp.asarray(x), jnp.asarray(window), 64, 20)
    out = K2.stft_power(torch.from_numpy(x), torch.from_numpy(window), 64, 20)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-3,
                               atol=1e-5)


def test_stft_centre_reflect_convention():
    """center=True framing: reflect padding of n_fft//2 (no edge repeat),
    T = 1 + L // hop, the window zero-padded to n_fft and centred — the
    torch.stft convention features.py:389-392 and features_pallas.py:87-89
    follow."""
    x = _audio(1, 301, seed=2)
    frames = K2.frame_signal(torch.from_numpy(x), 32, 10)
    assert frames.shape == (1, 1 + 301 // 10, 32)
    padded = np.pad(x[0], (16, 16), mode='reflect')
    np.testing.assert_array_equal(frames[0, 3].numpy(), padded[30:62])
    np.testing.assert_array_equal(frames[0, 0, :16].numpy(),
                                  x[0, 16:0:-1])
    win = PF.hann_window(20, periodic=False)
    window = np.pad(win, (6, 6))
    spec = torch.stft(torch.from_numpy(x), 32, 10, win_length=20,
                      window=torch.from_numpy(win), center=True,
                      pad_mode='reflect', return_complex=True)
    power = (spec.abs() ** 2).transpose(1, 2)
    out = K2.stft_power(torch.from_numpy(x), torch.from_numpy(window), 32, 10)
    np.testing.assert_allclose(out.numpy(), power.numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize('ftype,delta,cmvn,pad', [
    ('logfbank', False, False, False),
    ('logfbank', True, True, True),
    ('melspec', False, False, True),
    ('mfcc', False, False, True),
])
def test_pipeline_matches_jax(ftype, delta, cmvn, pad):
    kw = dict(feature_type=ftype, feature_size=12, n_fft=64, win_length=40,
              hop_length=20, downsample=3, delta=delta,
              normalize='per_feature' if cmvn else 'none',
              pad_to_divisible=pad, mfcc_n_mels=20)
    x = _audio(2, 1321, seed=3)
    lens = np.array([1321, 900], np.int32)
    ref, ref_len = JF.FeaturePipeline(JF.FeatureConfig(**kw))(
        jnp.asarray(x), jnp.asarray(lens), train=False)
    out, out_len = PF.FeaturePipeline(PF.FeatureConfig(**kw), 'cpu')(
        torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), LOG_RTOL,
                               LOG_ATOL)


def test_e6d2_chunk_geometry_features():
    """An E6D2 streaming chunk (1320 samples) gives 7 STFT frames that
    stack to 2 encoder input frames of 240."""
    cfg = PF.FeatureConfig(feature_size=80, n_fft=512, win_length=320,
                           hop_length=200, downsample=3,
                           pad_to_divisible=False)
    assert cfg.input_size == 240
    pipe = PF.FeaturePipeline(cfg, 'cpu')
    x = torch.from_numpy(_audio(1, 1320, seed=4))
    feat, flen = pipe(x, torch.tensor([1320]))
    assert feat.shape == (1, 2, 240) and int(flen[0]) == 2
    assert K2.mel_power(PF.preemphasis(x), pipe.tables).shape == (1, 7, 80)


def test_pcm_int16_matches_float():
    x = np.random.RandomState(5).randint(-32768, 32767, (2, 600)) \
        .astype(np.int16)
    pipe = PF.FeaturePipeline(PF.FeatureConfig(feature_size=8, n_fft=64,
                                               win_length=40, hop_length=20),
                              'cpu')
    lens = torch.tensor([600, 600])
    a, _ = pipe(torch.from_numpy(x), lens)
    b, _ = pipe(torch.from_numpy(x.astype(np.float32) / 32768.0), lens)
    assert torch.equal(a, b)


def test_cpu_tensor_takes_plain_path_and_train_refused():
    pipe = PF.FeaturePipeline(PF.FeatureConfig(feature_size=8, n_fft=64,
                                               win_length=40, hop_length=20),
                              'cpu')
    before = K2.mel_power.launches
    pipe(torch.zeros(1, 400), torch.tensor([400]))
    assert K2.mel_power.launches == before
    # train=True needs its generator; SpecAugment's time warp is not ported
    with pytest.raises(ValueError):
        pipe(torch.zeros(1, 400), torch.tensor([400]), train=True)
    warp = PF.FeaturePipeline(PF.FeatureConfig(
        feature_size=8, n_fft=64, win_length=40, hop_length=20, W_warp=5),
        'cpu')
    with pytest.raises(NotImplementedError):
        warp(torch.zeros(1, 400), torch.tensor([400]), train=True,
             generator=torch.Generator().manual_seed(0))
