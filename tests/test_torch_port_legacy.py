"""The port's legacy v1 models (edgedict_tpu_torch/models/legacy.py) == the
JAX package's (edgedict_tpu/models/legacy.py) on the same weights, handed
over through compat.legacy_state_dict_from_jax_params: fast_tanh, the batch
norm (eval, and train with its running stats), instance norm, the time
reduction, the residual RNN encoder (head, ×2 reduction before a layer,
state carried across chunks) and the residual projection encoder,
RNNModel, the CTC prefix beam search (exact), the legacy transducer's
joint, logits, loss and gradients and its greedy decode (tokens exact),
the MFCC_ featurizer and its CMVN; LegacyCharTokenizer's ids.

Tolerances: forward rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-4
(ROADMAP.md "When a slice is done"); the MFCCs, whose dB values pass
through log10 of a power spectrum from two FFT libraries, at 1e-4 of
their largest magnitude."""

import string

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgedict_tpu import tokenizer as JTok
from edgedict_tpu.models import legacy as JL
from edgedict_tpu_torch import compat
from edgedict_tpu_torch import tokenizer as PTok
from edgedict_tpu_torch.models import legacy as PL

RTOL, ATOL = 1e-4, 1e-5
GRTOL, GATOL = 1e-3, 1e-4
GEN = torch.Generator


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _load(module, params):
    module.load_state_dict(compat.legacy_state_dict_from_jax_params(
        _np_tree(params)))
    return module


def _close(a, r, rtol=RTOL, atol=ATOL):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(r), rtol, atol)


def _grads_close(module, jax_grads, rtol=GRTOL, atol=GATOL):
    want = compat.legacy_state_dict_from_jax_params(_np_tree(jax_grads))
    named = dict(module.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol,
                                   atol, err_msg=name)


def _x(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# pointwise and normalization
# ---------------------------------------------------------------------------

def test_fast_tanh_instance_norm_and_time_reduction():
    xs = _x(0, 3, 9, 5, scale=4.0) + 2.0
    _close(PL.fast_tanh(torch.from_numpy(xs)), JL.fast_tanh(jnp.asarray(xs)))
    _close(PL.instance_norm(torch.from_numpy(xs)),
           JL.instance_norm(jnp.asarray(xs)))
    for factor in (2, 3):
        _close(PL.time_reduction(torch.from_numpy(xs), factor),
               JL.time_reduction(jnp.asarray(xs), factor))


@pytest.mark.parametrize('train', [False, True])
def test_batch_norm_and_running_stats(train):
    """Eval uses the running stats; train the batch's, and returns the
    running stats updated with the unbiased variance (momentum 0.1),
    without storing them."""
    xs = _x(1, 3, 20, 5, scale=4.0) + 2.0
    rng = np.random.RandomState(2)
    params = {'gamma': jnp.asarray(rng.rand(5) + 0.5, jnp.float32),
              'beta': jnp.asarray(rng.randn(5), jnp.float32),
              'mean': jnp.asarray(rng.randn(5), jnp.float32),
              'var': jnp.asarray(rng.rand(5) + 0.5, jnp.float32)}
    y_j, new_j = JL.batch_norm(params, jnp.asarray(xs), train=train)
    norm = PL.BatchNorm(5)
    norm.load_state_dict({
        'weight': torch.from_numpy(np.asarray(params['gamma'])),
        'bias': torch.from_numpy(np.asarray(params['beta'])),
        'running_mean': torch.from_numpy(np.asarray(params['mean'])),
        'running_var': torch.from_numpy(np.asarray(params['var']))})
    before = {k: v.clone() for k, v in norm.state_dict().items()}
    y_p, (mean, var) = PL.batch_norm(norm, torch.from_numpy(xs), train=train)
    _close(y_p, y_j)
    _close(mean, new_j['mean'])
    _close(var, new_j['var'])
    assert all(torch.equal(v, before[k]) for k, v in
               norm.state_dict().items())
    if train:
        assert not np.allclose(mean.detach().numpy(), before['running_mean'])


# ---------------------------------------------------------------------------
# residual encoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('head', [None, 16])
def test_residual_rnn_matches_jax(head):
    params = JL.residual_rnn_init(jax.random.PRNGKey(0), 10, 16, 3,
                                  out_size=head)
    model = _load(PL.ResidualRNN(10, 16, 3, GEN(), out_size=head), params)
    xs = _x(3, 2, 7, 10)
    want, st_j = JL.residual_rnn_apply(params, jnp.asarray(xs))
    got, st_p = PL.residual_rnn_apply(model, torch.from_numpy(xs))
    _close(got, want)
    assert len(st_p) == 3
    for (h, c), (hj, cj) in zip(st_p, st_j):
        _close(h, hj)
        _close(c, cj)
    # gradients of <ys, cotangent> w.r.t. every parameter
    cot = _x(4, *want.shape)
    grads = jax.grad(lambda p: jnp.sum(
        JL.residual_rnn_apply(p, jnp.asarray(xs))[0] * cot))(params)
    (got * torch.from_numpy(cot)).sum().backward()
    _grads_close(model, grads)


def test_residual_rnn_reduction_and_state_carry():
    params = JL.residual_rnn_init(jax.random.PRNGKey(1), 6, 8, 3)
    model = _load(PL.ResidualRNN(6, 8, 3, GEN()), params)
    xs = _x(5, 2, 9, 6)
    with torch.no_grad():
        for k in (1, 2):
            want, st_j = JL.residual_rnn_apply(params, jnp.asarray(xs),
                                               reduce_before_layer=k)
            got, st_p = PL.residual_rnn_apply(model, torch.from_numpy(xs),
                                              reduce_before_layer=k)
            assert got.shape == (2, 5, 8)   # ceil(9 / 2)
            _close(got, want)
            for (h, c), (hj, cj) in zip(st_p, st_j):
                _close(h, hj)
                _close(c, cj)
        # chunks with the state carried == JAX's chunks, chunk by chunk
        st_j = st_p = None
        for lo, hi in ((0, 3), (3, 6), (6, 9)):
            want, st_j = JL.residual_rnn_apply(
                params, jnp.asarray(xs[:, lo:hi]), state=st_j)
            got, st_p = PL.residual_rnn_apply(
                model, torch.from_numpy(xs[:, lo:hi]), state=st_p)
            _close(got, want)
        full, _ = PL.residual_rnn_apply(model, torch.from_numpy(xs))
        _close(got, full[:, 6:])


@pytest.mark.parametrize('ff_dim', [None, 6])
def test_residual_proj_matches_jax(ff_dim):
    params = JL.residual_proj_init(jax.random.PRNGKey(2), 6, 8, 3,
                                   ff_dim=ff_dim)
    model = _load(PL.ResidualProj(6, 8, 3, GEN(), ff_dim=ff_dim), params)
    xs = _x(6, 2, 5, 6)
    want, st_j = JL.residual_proj_apply(params, jnp.asarray(xs))
    got, st_p = PL.residual_proj_apply(model, torch.from_numpy(xs))
    assert got.shape == (2, 5, ff_dim or 4)
    _close(got, want)
    for (h, c), (hj, cj) in zip(st_p, st_j):
        _close(h, hj)
        _close(c, cj)
    cot = _x(7, *want.shape)
    grads = jax.grad(lambda p: jnp.sum(
        JL.residual_proj_apply(p, jnp.asarray(xs))[0] * cot))(params)
    (got * torch.from_numpy(cot)).sum().backward()
    _grads_close(model, grads)


# ---------------------------------------------------------------------------
# RNNModel and the CTC prefix beam search
# ---------------------------------------------------------------------------

def _rnn_model():
    params = JL.rnn_model_init(jax.random.PRNGKey(3), 10, 12, 16, 2)
    rng = np.random.RandomState(8)      # non-trivial running stats
    params['norm']['mean'] = jnp.asarray(rng.uniform(-1, 1, 10), jnp.float32)
    params['norm']['var'] = jnp.asarray(rng.uniform(0.5, 2, 10), jnp.float32)
    return params, _load(PL.RNNModel(10, 12, 16, 2, 'cpu'), params)


@pytest.mark.parametrize('train', [False, True])
def test_rnn_model_matches_jax(train):
    params, model = _rnn_model()
    xs = _x(9, 3, 6, 10)
    want, (h_j, c_j) = JL.rnn_model_apply(params, jnp.asarray(xs),
                                          train=train)
    got, (h_p, c_p) = PL.rnn_model_apply(model, torch.from_numpy(xs),
                                         train=train)
    _close(got, want)
    _close(h_p, h_j)
    _close(c_p, c_j)
    cot = _x(10, *want.shape)
    grads = jax.grad(lambda p: jnp.sum(JL.rnn_model_apply(
        p, jnp.asarray(xs), train=train)[0] * cot))(params)
    (got * torch.from_numpy(cot)).sum().backward()
    _grads_close(model, grads)


@pytest.mark.parametrize('beam', [1, 3, 8, 64])
def test_ctc_prefix_beam_search_matches_jax(beam):
    """Labels and -logp exact, on RNNModel's log-probs and on random
    ones; a tensor input as well as an array."""
    rng = np.random.RandomState(beam)
    params, model = _rnn_model()
    xs = _x(11, 1, 7, 10)
    with torch.no_grad():
        logits, _ = PL.rnn_model_apply(model, torch.from_numpy(xs))
    logp = torch.log_softmax(logits[0], -1)
    cases = [logp, logp.numpy()]
    for _ in range(3):
        z = rng.randn(5, 4) * 2
        cases.append(z - np.log(np.exp(z).sum(-1, keepdims=True)))
    for lp in cases:
        want = JL.ctc_prefix_beam_search(np.asarray(lp), beam_width=beam)
        got = PL.ctc_prefix_beam_search(lp, beam_width=beam)
        assert got[0] == want[0] and got[1] == want[1]


# ---------------------------------------------------------------------------
# the legacy transducer
# ---------------------------------------------------------------------------

KW = dict(input_size=10, vocab_size=12, vocab_embed_size=6, hidden_size=16,
          num_layers=2, pred_num_layers=1)
JCFG, PCFG = JL.LegacyTransducerConfig(**KW), PL.LegacyTransducerConfig(**KW)


def _transducer(cfg=(JCFG, PCFG), seed=0):
    params = JL.legacy_transducer_init(jax.random.PRNGKey(seed), cfg[0])
    return params, _load(PL.LegacyTransducer(cfg[1], 'cpu'), params)


def test_legacy_joint_and_logits_match_jax():
    params, model = _transducer()
    xs = _x(12, 2, 5, 10)
    ys = np.random.RandomState(12).randint(2, 12, (2, 3))
    want = JL.legacy_transducer_logits(params, JCFG, jnp.asarray(xs),
                                       jnp.asarray(ys, jnp.int32))
    with torch.no_grad():
        got = PL.legacy_transducer_logits(model, torch.from_numpy(xs),
                                          torch.from_numpy(ys))
    assert got.shape == want.shape == (2, 5, 4, 12)
    _close(got, want)
    # the joint on matching lower-rank inputs (one frame, one state)
    f, g = _x(13, 2, 16), _x(14, 2, 16)
    with torch.no_grad():
        _close(PL.legacy_joint(model, torch.from_numpy(f),
                               torch.from_numpy(g)),
               JL.legacy_joint(params, jnp.asarray(f), jnp.asarray(g)))


def test_legacy_transducer_loss_and_grads_match_jax():
    params, model = _transducer()
    rng = np.random.RandomState(4)
    xs = _x(15, 3, 6, 10)
    ys = rng.randint(2, 12, (3, 4)).astype(np.int32)
    xlen = np.array([6, 4, 5], np.int32)
    ylen = np.array([4, 2, 0], np.int32)
    loss_j, grads = jax.value_and_grad(JL.legacy_transducer_loss)(
        params, JCFG, *(jnp.asarray(a) for a in (xs, ys, xlen, ylen)))
    loss_p = PL.legacy_transducer_loss(
        model, *(torch.from_numpy(a) for a in (xs, ys, xlen, ylen)))
    loss_p.backward()
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=RTOL)
    _grads_close(model, grads)


def test_legacy_greedy_decode_matches_jax():
    """Tokens exact; the where-gated prediction net advances only on the
    rows that emitted (the joint's weights x3 and its blank bias +1, so
    that about half the frames emit, two labels among them)."""
    params, model = _transducer(seed=1)
    for fc in ('fc1', 'fc2'):
        params[fc]['w'] = params[fc]['w'] * 3.0
    params['fc2']['b'] = params['fc2']['b'].at[0].add(1.0)
    model = _load(PL.LegacyTransducer(PCFG, 'cpu'), params)
    xs = _x(16, 3, 9, 10)
    xlen = np.array([9, 9, 9])
    y_j, neg_j = JL.legacy_greedy_decode(params, JCFG, jnp.asarray(xs),
                                         jnp.asarray(xlen))
    with torch.no_grad():
        y_p, neg_p = PL.legacy_greedy_decode(model, torch.from_numpy(xs),
                                             torch.from_numpy(xlen))
    assert y_p.dtype == torch.int32 and y_p.shape == (3, 9)
    np.testing.assert_array_equal(y_p.numpy(), np.asarray(y_j))
    assert 0 < (y_p != 0).sum() < y_p.numel()
    assert len(set(y_p[y_p != 0].tolist())) > 1
    _close(neg_p, neg_j)


def test_legacy_vocab_holds_every_char_id():
    """LegacyCharTokenizer's quirk, kept: vocab_size 72 but '9' → id 72.
    A model sized by legacy_vocab_size() (73) embeds it as the JAX model
    of 73 rows does; one of 72 rows has no row for it (torch raises)."""
    tok = PTok.LegacyCharTokenizer()
    assert tok.encode('a9') == [1, 4, 72]
    assert tok.vocab_size == 72 and tok.legacy_vocab_size() == 73
    kw = dict(KW, vocab_size=tok.legacy_vocab_size())
    params, model = _transducer((JL.LegacyTransducerConfig(**kw),
                                 PL.LegacyTransducerConfig(**kw)))
    ys = np.array([tok.encode('a9')[1:]])
    xs = _x(17, 1, 3, 10)
    want = JL.legacy_transducer_logits(
        params, JL.LegacyTransducerConfig(**kw), jnp.asarray(xs),
        jnp.asarray(ys, jnp.int32))
    with torch.no_grad():
        got = PL.legacy_transducer_logits(model, torch.from_numpy(xs),
                                          torch.from_numpy(ys))
    _close(got, want)
    small = PL.LegacyTransducer(PL.LegacyTransducerConfig(**dict(
        KW, vocab_size=tok.vocab_size)), 'cpu')
    with pytest.raises(IndexError):
        PL.legacy_transducer_logits(small, torch.from_numpy(xs),
                                    torch.from_numpy(ys))


# ---------------------------------------------------------------------------
# the MFCC_ featurizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('variance', [False, True])
def test_cmvn_sliding_equals_jax(variance):
    feat = _x(18, 50, 4, scale=3.0)
    for win in (11, 201):
        np.testing.assert_array_equal(
            PL.cmvn_sliding(feat, win_size=win, variance=variance),
            JL.cmvn_sliding(feat, win_size=win, variance=variance))


def test_amplitude_to_db_matches_jax():
    spec = np.random.RandomState(19).rand(5, 8).astype(np.float32) * 1e6
    spec[0, 0] = 0.0
    got = PL.amplitude_to_db(torch.from_numpy(spec))
    _close(got, JL.amplitude_to_db(jnp.asarray(spec)))
    assert float(got.max() - got.min()) <= 80.0 + 1e-5


@pytest.mark.parametrize('kw', [dict(), dict(log_mels=True),
                                dict(normalize=True),
                                dict(n_mfcc=13, n_mels=40, n_fft=256,
                                     hop_length=100)])
def test_legacy_mfcc_matches_jax(kw):
    audio = _x(20, 16000, scale=0.1)
    audio[:2000] *= 1e-3                       # a near-silent stretch
    want = np.asarray(JL.legacy_mfcc(audio, **kw))
    got = PL.legacy_mfcc(torch.from_numpy(audio), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.shape[1] == kw.get('n_mfcc', 40) and got.shape[0] > 70
    np.testing.assert_allclose(got.numpy(), want, 0,
                               1e-4 * np.abs(want).max())
    assert got.device.type == 'cpu'            # the audio tensor's device


# ---------------------------------------------------------------------------
# the v1 tokenizer
# ---------------------------------------------------------------------------

TEXTS = ['Hello World 42!', 'the quick brown fox', "it's 9 o'clock; ok?",
         'UPPER lower 0123456789', 'tab\tand ünïcode', '']


def test_legacy_char_tokenizer_equals_jax():
    j, p = JTok.LegacyCharTokenizer(), PTok.LegacyCharTokenizer()
    assert p.token2id == j.token2id and p.id2token == j.id2token
    assert p.vocab_size == j.vocab_size and p.unk_id == j.unk_id == 2
    assert str(p) == str(j) == 'LegacyCharTokenizer'
    assert 3 not in p.id2token
    for text in TEXTS:
        ids = p.encode(text)
        assert ids == j.encode(text) and ids[0] == 1
        assert p.encode(text, max_length=5) == j.encode(text, max_length=5)
        assert p.decode(ids) == j.decode(ids)
        assert p.decode_plus([ids, ids[:3]]) == j.decode_plus([ids, ids[:3]])
    for idx in range(-1, 75):
        assert p.id_to_token(idx) == j.id_to_token(idx)
    # round trip of the charset
    text = string.ascii_lowercase + string.punctuation + ' 0123456789'
    assert p.decode(p.encode(text)) == text
    assert p.decode(p.encode('Hello World 42!')) == 'hello world 42!'
