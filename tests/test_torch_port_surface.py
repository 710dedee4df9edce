"""The port's JAX-free surface against the JAX package's, on the same numpy
inputs: text normalization, audio segments and perturbations, manifests,
utils, the native bucketing and FLAC bindings, compute_measures / cer
(exact), trim_audio, build_transform's pipelines and the NVIDIA
featurizers (rtol 1e-4 / atol 1e-5).  The cases mirror
tests/test_text_and_perturb.py, tests/test_nvidia_features.py and the
bucketing cases of tests/test_native.py."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edgedict_tpu import features as JF
from edgedict_tpu import metrics as JM
from edgedict_tpu import native as JN
from edgedict_tpu import text as JT
from edgedict_tpu.data import nvidia_features as JNV
from edgedict_tpu_torch import _native as PN
from edgedict_tpu_torch import features as PF
from edgedict_tpu_torch import metrics as PM
from edgedict_tpu_torch import text as PT
from edgedict_tpu_torch.data import nvidia_features as PNV

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# text (tests/test_text_and_perturb.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n', [0, 7, 21, 105, 1234, 2000000, 987654321])
def test_number_to_words(n):
    assert PT.number_to_words(n) == JT.number_to_words(n)
    assert PT.ordinal_to_words(max(n, 1)) == JT.ordinal_to_words(max(n, 1))


def test_ordinals_and_numbers_in_text():
    assert PT.ordinal_to_words(22) == 'twenty second'
    assert PT.ordinal_to_words(30) == 'thirtieth'
    for text in ('the 3rd time', '$2.50', 'in 1984', '3.14', '1,000 men',
                 '£12 and $0.05', 'the 21st of 2005', '$1.01'):
        assert PT.normalize_numbers(text) == JT.normalize_numbers(text)


def test_english_cleaners():
    for text in ('Dr. Smith paid $5 on the 2nd of May, 1999.', 'Café',
                 'Mr.  and   Mrs. Jones, Lt. Col. Ft. Knox  ', ''):
        assert PT.english_cleaners(text) == JT.english_cleaners(text)
    assert PT.english_cleaners('Café') == 'cafe'


def test_perturbations_and_segment():
    from edgedict_tpu.data import perturb as JP
    from edgedict_tpu.data import segment as JS
    from edgedict_tpu_torch.data import perturb as PP
    from edgedict_tpu_torch.data import segment as PS

    config = {'speed': {'prob': 1.0, 'min_speed_rate': 0.9,
                        'max_speed_rate': 1.1},
              'gain': {'prob': 1.0, 'min_gain_dbfs': -6, 'max_gain_dbfs': 6},
              'shift': {'prob': 1.0}}
    samples = np.random.RandomState(0).randn(16000).astype(np.float32)
    segs = []
    for seg_mod, pert_mod in ((JS, JP), (PS, PP)):
        seg = seg_mod.AudioSegment(samples, 16000)
        pert_mod.AudioAugmentor.from_config(
            config, rng=np.random.RandomState(1)).perturb(seg)
        segs.append(seg)
    np.testing.assert_array_equal(segs[1].samples, segs[0].samples)
    assert 0.8 < segs[1].duration < 1.25
    sine = np.sin(2 * np.pi * 100 * np.linspace(0, 1, 16000, endpoint=False)
                  ).astype(np.float32)
    np.testing.assert_array_equal(PS.resample(sine, 16000, 8000),
                                  JS.resample(sine, 16000, 8000))
    loud = np.concatenate([np.zeros(8000), sine, np.zeros(8000)])
    np.testing.assert_array_equal(PS.trim_silence(loud, 40),
                                  JS.trim_silence(loud, 40))
    for mod in (JS, PS):
        seg = mod.AudioSegment(sine, 16000, target_sr=8000)
        seg.pad(100, symmetric=True)
        seg.subsegment(0.1, 0.5)
        segs.append(seg.samples)
    np.testing.assert_array_equal(segs[3], segs[2])


def test_manifest(tmp_path):
    from edgedict_tpu.data.manifest import Manifest as JManifest
    from edgedict_tpu_torch.data.manifest import Manifest
    p = tmp_path / 'm.json'
    rows = [
        {'audio_filepath': 'a.wav', 'duration': 2.0, 'text': 'Hello 3rd'},
        {'audio_filepath': 'b.wav', 'duration': 50.0, 'text': 'too long'},
        {'audio_filepath': 'c.wav', 'duration': 1.0, 'text': 'ok'},
        {'files': [{'fname': 'd.wav', 'duration': 3.0}], 'duration': 3.0,
         'transcript': 'Dr. Who'},
    ]
    p.write_text('\n'.join(json.dumps(r) for r in rows) + '\n\n')
    for kw in (dict(max_duration=16.7, sort_by_duration=True),
               dict(min_duration=1.5, normalize=False), dict(max_utts=2)):
        m, j = Manifest([str(p)], **kw), JManifest([str(p)], **kw)
        assert m.items == j.items and len(m) == len(j)
        assert (m.duration, m.filtered_duration) == \
            (j.duration, j.filtered_duration)
    m = Manifest([str(p)], max_duration=16.7, sort_by_duration=True)
    assert m[0]['duration'] == 1.0 and m[1]['text'] == 'hello third'


def test_numpy_seed_context():
    from edgedict_tpu.utils import numpy_seed as jseed
    from edgedict_tpu_torch.utils import numpy_seed
    with numpy_seed(7, 3):
        a = np.random.rand(3)
    with jseed(7, 3):
        b = np.random.rand(3)
    np.testing.assert_array_equal(a, b)
    np.random.seed(123)
    before = np.random.rand(3)
    np.random.seed(123)
    with numpy_seed(7):
        np.random.rand(10)
    np.testing.assert_array_equal(np.random.rand(3), before)


def test_utils_reexports():
    from edgedict_tpu_torch import utils
    assert utils.wer is PM.wer and utils.cer is PM.cer
    assert utils.compute_measures is PM.compute_measures
    assert utils.english_cleaners is PT.english_cleaners
    assert utils.native is PN


def test_dataloader_propagates_worker_errors():
    from edgedict_tpu_torch.data import DataLoader

    class Bad:
        data = [{'audio_length': 1}] * 4

        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise RuntimeError('corrupt sample')
            return np.zeros(10, np.float32), np.asarray([4], np.int32)

    loader = DataLoader(Bad(), batch_size=2, shuffle=False, prefetch=2)
    with pytest.raises(RuntimeError, match='corrupt sample'):
        for _ in loader:
            pass


def test_dataloader_workers_match_jax():
    """The port's loader yields the JAX loader's batches, for every worker
    count."""
    from edgedict_tpu.data import DataLoader as JLoader
    from edgedict_tpu_torch.data import DataLoader

    class DS:
        data = [{'audio_length': i % 5} for i in range(16)]

        def __len__(self):
            return 16

        def __getitem__(self, i):
            return (np.full(8, float(i), np.float32),
                    np.asarray([i + 4], np.int32))

    def batches(cls, workers):
        loader = cls(DS(), batch_size=4, shuffle=True, seed=3,
                     workers=workers)
        return [{k: np.array(v) for k, v in b.items()} for b in loader]

    ref = batches(JLoader, 1)
    for w in (1, 2, 4):
        got = batches(DataLoader, w)
        assert len(got) == len(ref)
        for a, b in zip(ref, got):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# native bindings (tests/test_native.py:82, :92)
# ---------------------------------------------------------------------------

needs_bucketing = pytest.mark.skipif(
    not PN.available()['bucketing'] or not JN.available()['bucketing'],
    reason='native/libbucketing.so not built (make -C native)')


@needs_bucketing
@pytest.mark.parametrize('kw', [dict(max_tokens=20),
                                dict(max_tokens=30, max_sentences=2),
                                dict(max_sentences=3, bsz_mult=2)])
def test_batch_by_size_token_budget(kw):
    lengths = [5, 5, 5, 9, 9, 20]
    batches = PN.batch_by_size(list(range(6)), lengths, **kw)
    assert batches == JN.batch_by_size(list(range(6)), lengths, **kw)
    assert sorted(i for b in batches for i in b) == list(range(6))
    for b in batches:
        if 'max_tokens' in kw:
            assert max(lengths[i] for i in b) * len(b) <= kw['max_tokens'] \
                or len(b) == 1


@needs_bucketing
def test_batch_fixed_shapes_menu():
    lengths = [20, 18, 9, 9, 8, 5, 4]
    shapes = [(4, 12), (2, 24), (8, 6)]            # unsorted menu
    batches = PN.batch_fixed_shapes(list(range(7)), lengths, shapes)
    assert batches == JN.batch_fixed_shapes(list(range(7)), lengths, shapes)
    assert sorted(i for b, _ in batches for i in b) == list(range(7))
    for idxs, (bsz, max_len) in batches:
        assert len(idxs) <= bsz
        assert all(lengths[i] <= max_len for i in idxs)


def test_flac_decoder_rejects_garbage(tmp_path):
    """Corrupt input is a clean ValueError, as in the JAX package."""
    if not PN.flac_available():
        pytest.skip('native/libflac_decoder.so not built')
    path = tmp_path / 'garbage.flac'
    path.write_bytes(b'not a flac stream at all' * 10)
    with pytest.raises(ValueError, match='FLAC'):
        PN.read_flac(str(path))


# ---------------------------------------------------------------------------
# metrics: compute_measures and cer, exact
# ---------------------------------------------------------------------------

def _sentences(rng, n, vocab=6, max_len=9):
    words = [f'w{i}' for i in range(vocab)]
    return [' '.join(rng.choice(words, rng.randint(0, max_len)))
            for _ in range(n)]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_compute_measures_and_cer_equal_jax(seed):
    rng = np.random.RandomState(seed)
    refs, hyps = _sentences(rng, 12), _sentences(rng, 12)
    assert PM.compute_measures(refs, hyps) == JM.compute_measures(refs, hyps)
    assert PM.compute_measures(refs[0], hyps[0]) == \
        JM.compute_measures(refs[0], hyps[0])
    assert PM.cer(refs, hyps) == JM.cer(refs, hyps)
    assert PM.cer(refs[1], hyps[1]) == JM.cer(refs[1], hyps[1])
    m = PM.compute_measures(refs, hyps)
    # the counts a data-parallel eval sums give the corpus WER
    errors = m['substitutions'] + m['deletions'] + m['insertions']
    words = m['hits'] + m['substitutions'] + m['deletions']
    assert errors / max(words, 1) == m['wer'] == PM.wer(refs, hyps)


# ---------------------------------------------------------------------------
# features: trim_audio, build_transform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('truncate_end', [True, False])
@pytest.mark.parametrize('seconds', [0.05, 0.5])
def test_trim_audio(truncate_end, seconds):
    audio = np.random.RandomState(0).randn(3, 2000).astype(np.float32)
    lengths = np.asarray([2000, 1200, 500], np.int32)
    got = PF.trim_audio(torch.as_tensor(audio), torch.as_tensor(lengths),
                        16000, seconds, truncate_end)
    want = JF.trim_audio(jnp.asarray(audio), jnp.asarray(lengths), 16000,
                         seconds, truncate_end)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


TRANSFORM = dict(feature_size=16, n_fft=128, win_length=80, hop_length=40)


@pytest.mark.parametrize('kind,kw', [
    ('logfbank', dict(cmvn=True, downsample=3)),
    ('logfbank', dict(delta=True, pad_to_divisible=False, downsample=2)),
    ('mfcc', dict(downsample=3)),
    ('melspec', dict(delta=True)),
])
def test_build_transform_test_pipeline_equals_jax(kind, kw):
    audio = np.random.RandomState(1).randn(2, 1900).astype(np.float32) * 0.3
    lengths = np.asarray([1900, 1300], np.int32)
    _, test_fn, size = PF.build_transform(kind, device='cpu',
                                          **TRANSFORM, **kw)
    _, jtest_fn, jsize = JF.build_transform(kind, **TRANSFORM, **kw)
    assert size == jsize
    feat, flen = test_fn(torch.as_tensor(audio), torch.as_tensor(lengths))
    jfeat, jflen = jtest_fn(jnp.asarray(audio), jnp.asarray(lengths))
    assert feat.shape == jfeat.shape and feat.shape[-1] == size
    np.testing.assert_array_equal(flen.numpy(), np.asarray(jflen))
    _close(feat, jfeat)


@pytest.mark.parametrize('kind', ['mfcc', 'melspec'])
def test_build_transform_train_pipeline_equals_jax(kind):
    """With SpecAugment off (no masks) and a feature type that takes no
    dither, the train pipeline is deterministic: the port's equals JAX's;
    with masks on, its masked cells are zeros."""
    audio = np.random.RandomState(2).randn(2, 1700).astype(np.float32) * 0.3
    lengths = np.asarray([1700, 900], np.int32)
    train_fn, _, _ = PF.build_transform(kind, device='cpu', downsample=3,
                                        **TRANSFORM)
    jtrain_fn, _, _ = JF.build_transform(kind, downsample=3, **TRANSFORM)
    gen = torch.Generator().manual_seed(0)
    feat, _ = train_fn(torch.as_tensor(audio), torch.as_tensor(lengths), gen)
    import jax
    jfeat, _ = jtrain_fn(jnp.asarray(audio), jnp.asarray(lengths),
                         jax.random.PRNGKey(0))
    _close(feat, jfeat)
    masked_fn, test_fn, _ = PF.build_transform(
        kind, device='cpu', downsample=3, T_mask=4, T_num_mask=2, F_mask=5,
        F_num_mask=1, **TRANSFORM)
    masked, _ = masked_fn(torch.as_tensor(audio), torch.as_tensor(lengths),
                          gen)
    clean, _ = test_fn(torch.as_tensor(audio), torch.as_tensor(lengths))
    changed = masked != clean
    assert changed.any() and (masked[changed] == 0).all()
    with pytest.raises(ValueError, match='Generator'):
        masked_fn(torch.as_tensor(audio), torch.as_tensor(lengths), None)


# ---------------------------------------------------------------------------
# NVIDIA featurizers (tests/test_nvidia_features.py)
# ---------------------------------------------------------------------------

def _nv_pair(cls_name, cfg):
    return getattr(PNV, cls_name)(cfg), getattr(JNV, cls_name)(cfg)


def _nv_run(pair, x, xlen):
    port, jax_feat = pair
    got = port(torch.as_tensor(x), torch.as_tensor(xlen))
    want = jax_feat(jnp.asarray(x), jnp.asarray(xlen))
    assert got.shape == want.shape
    _close(got, want)
    return got


def test_logfbank_matches_main_pipeline():
    """With the main pipeline's geometry (hann, same n_fft / hop, no
    splicing, no normalization) the NVIDIA filterbank equals the port's
    FeaturePipeline's log-mel transposed, and JAX's NVIDIA filterbank."""
    sr = 16000
    cfg = PNV.NvidiaFeatConfig(
        sample_rate=sr, window_size=320 / sr, window_stride=200 / sr,
        window='hann', normalize='none', n_fft=512, nfilt=80,
        dither=0.0, pad_to=0, frame_splicing=1)
    main = PF.FeaturePipeline(PF.FeatureConfig(
        feature_type='logfbank', feature_size=80, n_fft=512,
        win_length=320, hop_length=200, downsample=1), 'cpu')
    x = np.random.RandomState(0).randn(2, 9000).astype(np.float32)
    xlen = np.asarray([9000, 6000], np.int32)
    got = _nv_run(_nv_pair('NvidiaFilterbankFeatures', cfg), x, xlen)
    want, _ = main(torch.as_tensor(x), torch.as_tensor(xlen))
    _close(got, want.transpose(1, 2))


@pytest.mark.parametrize('window', ['hamming', 'blackman', 'bartlett',
                                    'none'])
def test_spectrogram_is_log_magnitude(window):
    cfg = PNV.NvidiaFeatConfig(
        sample_rate=16000, window_size=0.02, window_stride=0.0125,
        window=window, normalize='none', dither=0.0, pad_to=0, log=True)
    x = np.random.RandomState(1).randn(1, 4000).astype(np.float32)
    got = _nv_run(_nv_pair('SpectrogramFeatures', cfg), x,
                  np.asarray([4000], np.int32)).numpy()
    assert got.shape[1] == cfg.fft_size // 2 + 1


def test_splice_frames_roll_semantics():
    x = np.arange(12, dtype=np.float32).reshape(1, 2, 6)
    for s in (2, 3):
        out = PNV.splice_frames(torch.as_tensor(x), s).numpy()
        np.testing.assert_array_equal(
            out, np.asarray(JNV.splice_frames(jnp.asarray(x), s)))
    out = PNV.splice_frames(torch.as_tensor(x), 2).numpy()
    assert out.shape == (1, 4, 6)
    np.testing.assert_array_equal(out[0, 2, :-1], x[0, 0, 1:])
    assert out[0, 2, -1] == x[0, 0, -1]


@pytest.mark.parametrize('pad_to,normalize', [(8, 'per_feature'),
                                              (-1, 'all_features'),
                                              (0, 'none')])
def test_pad_to_and_factory(pad_to, normalize):
    cfg = dict(sample_rate=16000, window_size=0.02, window_stride=0.01,
               features=64, normalize=normalize, dither=0.0, pad_to=pad_to,
               frame_splicing=2, feat_type='logfbank', max_duration=0.5)
    feat = PNV.FeatureFactory.from_config(cfg)
    assert isinstance(feat, PNV.NvidiaFilterbankFeatures) and feat.cfg.log
    x = np.random.RandomState(2).randn(1, 5000).astype(np.float32)
    out = _nv_run((feat, JNV.FeatureFactory.from_config(cfg)), x,
                  np.asarray([5000], np.int32))
    assert out.shape[1] == 64 * 2
    if pad_to > 0:
        assert out.shape[2] % pad_to == 0
    pre = PNV.AudioPreprocessing(**dict(cfg, transpose_out=True))
    out1 = pre(torch.as_tensor(x[0]))
    want = JNV.AudioPreprocessing(**dict(cfg, transpose_out=True))(
        jnp.asarray(x[0]))
    assert out1.shape[1] == 64 * 2 and out1.ndim == 2
    _close(out1, want)


def test_stft_factory_default():
    cfg = dict(sample_rate=8000, window_size=0.02, window_stride=0.01,
               dither=0.0, pad_to=0)
    feat = PNV.FeatureFactory.from_config(cfg)
    assert isinstance(feat, PNV.SpectrogramFeatures) and feat.cfg.log
    x = np.random.RandomState(3).randn(2, 3000).astype(np.float32)
    _nv_run((feat, JNV.FeatureFactory.from_config(cfg)), x,
            np.asarray([3000, 2100], np.int32))


def test_dither_draws_from_the_generator():
    cfg = PNV.NvidiaFeatConfig(sample_rate=16000, dither=1e-3, pad_to=0)
    feat = PNV.NvidiaFilterbankFeatures(cfg)
    x = torch.as_tensor(np.random.RandomState(4).randn(1, 3000),
                        dtype=torch.float32)
    xlen = torch.tensor([3000])
    a = feat(x, xlen, torch.Generator().manual_seed(5))
    b = feat(x, xlen, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, feat(x, xlen))
