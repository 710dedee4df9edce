"""The port's synthetic-language learning run
(edgedict_tpu_torch/scripts/synthetic_convergence.py) against the JAX
script (scripts/synthetic_convergence.py), on the CPU, at small corpora
(32 training utterances, 8 held out):

  * the corpus bit for bit (audio, texts, lengths) for the easy,
    confusable and hard languages, a scalar and a list SNR, seeds 0 and 1;
    conf_successors and _parse_snrs;
  * the run's model and feature configs and its char vocabulary equal to
    those of the JAX run (its own Trainer, caught as its run builds it);
  * from the same weights (compat.state_dict_from_jax_params), three fp32
    train steps on the loader's batches, featurised without augmentation
    (no dither, no SpecAugment) by each package's own pipeline: loss
    rtol 1e-5, params after each step rtol 1e-4 / atol 1e-5 (the ladder of
    tests/test_torch_port_train.py); then greedy hypotheses exact and beam
    tokens exact, without and with the LM;
  * the LM: the script's token stream and draws, and its first five Adam
    steps against optax from the same weights
    (compat.lm_state_dict_from_jax_params): loss rtol 1e-5;
  * the serving A/B: the fp32 leg's hypotheses equal the JAX leg's, and
    the int8 leg's weights the JAX package's bit for bit;
  * the SNR sweep restores the held-out set; run() with every option
    returns every key; main() defaults to cuda and raises without a card.
"""

import argparse
import ast
import copy
import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edgedict_tpu_torch import train as ptrain
from edgedict_tpu_torch.compat import (
    lm_state_dict_from_jax_params, state_dict_from_jax_params)
from edgedict_tpu_torch.scripts import synthetic_convergence as P
from scripts import synthetic_convergence as J

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(train_n=32, eval_n=8)
RTOL, ATOL = 1e-4, 1e-5


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('snr', [20.0, [20.0, 10.0, 5.0]])
@pytest.mark.parametrize('language', ['easy', 'confusable', 'hard'])
def test_corpus_is_the_jax_scripts_bit_for_bit(language, snr, seed):
    j = J.ToyCorpus(None, 8, seed, language=language, noise=0.03,
                    snr_db=snr)
    p = P.ToyCorpus(None, 8, seed, language=language, noise=0.03,
                    snr_db=snr)
    assert p.texts() == j.texts() and p.data == j.data
    for (pa, _), (ja, _) in zip(p.samples, j.samples):
        assert pa.dtype == ja.dtype == np.float32
        np.testing.assert_array_equal(pa, ja)


def test_grammar_and_snr_parsing_are_the_jax_scripts():
    assert [P.conf_successors(i) for i in range(12)] == \
        [J.conf_successors(i) for i in range(12)]
    for spec in ('20,10,5', 'inf,20, 10,5,0', 'clean', '', 7.5):
        assert P._parse_snrs(spec) == J._parse_snrs(spec)
    assert P.WORDS == J.WORDS and P.CONF_WORDS == J.CONF_WORDS


# ---------------------------------------------------------------------------
# the run's trainer, the JAX one and the port's, on the same corpora
# ---------------------------------------------------------------------------

class _Caught(Exception):
    pass


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    """(JAX trainer, its tokenizer, port trainer, port tokenizer, port
    train set): the JAX Trainer as the JAX script's run builds it (caught
    at the end of its __init__, before any step), the port's as
    build_run builds it, each in its own logdir; the absl FLAGS restored
    afterwards."""
    import edgedict_tpu.trainer as jtrainer_mod
    from edgedict_tpu.config import FLAGS, ensure_parsed
    ensure_parsed()
    saved = {k: getattr(FLAGS, k) for k in FLAGS}
    caught = {}

    class Catching(jtrainer_mod.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            caught['trainer'] = self
            raise _Caught

    real = jtrainer_mod.Trainer
    jtrainer_mod.Trainer = Catching
    jdir = str(tmp_path_factory.mktemp('jax_synth'))
    try:
        with pytest.raises(_Caught):
            J.run(steps=3, logdir=jdir, **SMALL)
    finally:
        jtrainer_mod.Trainer = real
    jtr = caught['trainer']
    args = argparse.Namespace(**{**P.DEFAULTS, **SMALL, 'device': 'cpu',
                                   'logdir': str(tmp_path_factory.mktemp(
                                       'port_synth'))})
    ptr, ptok, ptrain_set, _ = P.build_run(args)
    yield jtr, jtr.train_dataset.datasets[0].tokenizer, ptr, ptok, \
        ptrain_set
    for k, v in saved.items():
        if getattr(FLAGS, k) != v:
            setattr(FLAGS, k, v)


def test_configs_and_vocabulary_are_the_jax_runs(pair):
    jtr, jtok, ptr, ptok, _ = pair
    assert dataclasses.asdict(ptr.cfg) == dataclasses.asdict(jtr.cfg)
    assert dataclasses.asdict(ptr.feature_cfg) == \
        dataclasses.asdict(jtr.feature_cfg)
    assert ptok.token2id == jtok.token2id == jtr.tokenizer.token2id
    f, jf = ptr.flags, jtr.FLAGS
    for name in ('batch_size', 'sub_batch_size', 'eval_batch_size', 'lr',
                 'warmup_step', 'gradclip', 'optim', 'bf16', 'T_mask',
                 'T_num_mask', 'F_mask', 'F_num_mask', 'time_warp_w',
                 'sched', 'sched_patience', 'sched_factor', 'sched_min_lr',
                 'audio_bucket_frames', 'label_bucket', 'audio_max_length',
                 'enc_dropout', 'dec_dropout', 'num_workers'):
        assert getattr(f, name) == getattr(jf, name), name
    assert f.bf16 and (f.T_mask, f.T_num_mask, f.F_mask, f.F_num_mask) == \
        (50, 2, 5, 1)
    assert ptr.accum_steps == jtr.accum_steps == 1
    assert vars(ptr.bucket) == vars(jtr.bucket)


def _jax_params(tree):
    return jax.tree.map(np.asarray, tree)


def _drawn_alike(got, want):
    """Each tensor of state dict `got` drawn as the same tensor of `want`:
    the same shape; equal where `want` is constant (LayerNorm's ones and
    zeros); else one distribution (two-sample Kolmogorov-Smirnov and
    Levene's test of equal spread, each p > 1e-3) within one bound (max |x|
    within 5 % of the other's)."""
    from scipy.stats import ks_2samp, levene
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].numpy().ravel(), w.numpy().ravel()
        assert g.shape == w.shape, k
        if w.min() == w.max():
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        assert ks_2samp(g, w).pvalue > 1e-3, k
        assert levene(g, w).pvalue > 1e-3, k
        if g.size >= 1000:
            np.testing.assert_allclose(np.abs(g).max(), np.abs(w).max(),
                                       rtol=0.05, err_msg=k)


@pytest.mark.parametrize('enc_type', ['LSTM', 'GRU'])
def test_initial_weights_are_drawn_as_the_jax_runs(pair, enc_type):
    """The run's initial weights, the port's (Transducer at the trainer's
    seed 0, the LM at LM_SEED) against the JAX run's (transducer_init at
    its trainer's PRNGKey(0), lm_init at PRNGKey(3)), tensor by tensor."""
    from edgedict_tpu.models.lm import LMConfig, lm_init
    from edgedict_tpu.models.transducer import transducer_init
    from edgedict_tpu_torch.models.lm import LMModel
    from edgedict_tpu_torch.models.transducer import Transducer
    jtr, _, ptr, ptok, _ = pair
    jcfg = dataclasses.replace(jtr.cfg, module_type=enc_type)
    pcfg = dataclasses.replace(ptr.cfg, module_type=enc_type)
    _drawn_alike(Transducer(pcfg, 'cpu').state_dict(),
                 state_dict_from_jax_params(_jax_params(
                     transducer_init(jax.random.PRNGKey(0), jcfg))))
    lcfg = P.lm_config(ptok.vocab_size)
    _drawn_alike(LMModel(lcfg, 'cpu', seed=P.LM_SEED).state_dict(),
                 lm_state_dict_from_jax_params(_jax_params(lm_init(
                     jax.random.PRNGKey(3),
                     LMConfig(**dataclasses.asdict(lcfg))))))


def _assert_params_equal(model, jparams):
    got = model.state_dict()
    for k, v in state_dict_from_jax_params(_jax_params(jparams)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), RTOL, ATOL,
                                   err_msg=k)


def _features(jtr, ptr, batch):
    jxs, jxlen = jtr.pipeline(jnp.asarray(batch['audio']),
                              jnp.asarray(batch['alen']))
    pxs, pxlen = ptr.pipeline(torch.as_tensor(batch['audio']),
                              torch.as_tensor(batch['alen']))
    np.testing.assert_array_equal(pxlen.numpy(), np.asarray(jxlen))
    return (jxs, jxlen), (pxs, pxlen)


@pytest.fixture(scope='module')
def trained(pair):
    """Three fp32 steps of both packages from the JAX run's weights, on
    the loaders' first three batches (equal in both) featurised without
    augmentation; → (JAX params, the held-out features of both, per-step
    (JAX loss, port loss))."""
    from edgedict_tpu.parallel import train as jtrain
    jtr, _, ptr, _, _ = pair
    ptr.state.model.load_state_dict(state_dict_from_jax_params(
        _jax_params(jtr.state.params)))
    ptr.state.opt_state = ptr.optimizer.init(
        dict(ptr.state.model.named_parameters()))
    # two epochs of two batches each (32 utterances, batch 16)
    jbatches = (list(jtr.loader) + list(jtr.loader))[:3]
    pbatches = (list(ptr.loader) + list(ptr.loader))[:3]
    jstep = jtrain.make_train_step(jtr.cfg, jtr.optimizer, bf16=False)
    pstep = ptrain.make_train_step(ptr.cfg, ptr.optimizer, bf16=False)
    jstate, pstate, losses = jtr.state, ptr.state, []
    for i, (jb, pb) in enumerate(zip(jbatches, pbatches)):
        for k in jb:
            np.testing.assert_array_equal(pb[k], jb[k])
        (jxs, jxlen), (pxs, pxlen) = _features(jtr, ptr, pb)
        lr = ptr._lr(i)
        assert lr == pytest.approx(jtr._lr(i))
        jstate, jm = jstep(jstate, {
            'xs': jxs[None], 'xlen': jxlen[None],
            'ys': jnp.asarray(pb['ys'])[None],
            'ylen': jnp.asarray(pb['ylen'])[None]},
            jax.random.PRNGKey(i), jnp.asarray(lr, jnp.float32))
        pstate, pm = pstep(pstate, {
            'xs': pxs[None], 'xlen': pxlen[None],
            'ys': torch.as_tensor(pb['ys'])[None],
            'ylen': torch.as_tensor(pb['ylen'])[None]}, lr)
        losses.append((float(jm['loss']), float(pm['loss'])))
        _assert_params_equal(pstate.model, jstate.params)
    ptr.state = pstate
    held_out = [_features(jtr, ptr, b) for b in ptr.eval_loader]
    return jstate.params, held_out, losses


def test_three_fp32_steps_match_the_jax_runs(trained):
    _, _, losses = trained
    assert len(losses) == 3
    for jl, pl in losses:
        assert np.isfinite(pl)
        np.testing.assert_allclose(pl, jl, rtol=1e-5)


def _peaky(jparams, lm_params=None):
    """Copies of the weights made peaky, as tests/test_torch_port_beam.py
    makes them: three steps from random weights leave near-uniform
    posteriors under which the beam keeps the all-blank path."""
    jparams = jax.tree.map(lambda x: x, jparams)
    jparams['joint']['out']['w'] = jparams['joint']['out']['w'] * 16.0
    jparams['joint']['w_dec'] = jparams['joint']['w_dec'] * 6.0
    jparams['decoder']['embed']['table'] = \
        jparams['decoder']['embed']['table'] * 4.0
    if lm_params is not None:
        lm_params = jax.tree.map(lambda x: x, lm_params)
        lm_params['out']['w'] = lm_params['out']['w'] * 4.0
    return jparams, lm_params


def _port_run(ptr, jparams):
    """The port's trainer as the script's decoders read it, its eval
    model holding the JAX weights jparams."""
    model = copy.deepcopy(ptr.state.model)
    model.load_state_dict(state_dict_from_jax_params(_jax_params(jparams)))
    return SimpleNamespace(eval_model=lambda: model, cfg=ptr.cfg,
                           eval_loader=ptr.eval_loader, pipeline=ptr.pipeline,
                           device=ptr.device)


# the characters the made-peaky weights must emit over the 8 held-out
# utterances, so that an all-blank decoder cannot pass
EMITTED = 20


@pytest.mark.parametrize('peaky', [False, True])
def test_greedy_hypotheses_equal_the_jax_runs(pair, trained, peaky):
    from edgedict_tpu.models.decoding import (
        transducer_greedy_decode as jdecode, truncate_and_strip)
    from edgedict_tpu_torch.models.decoding import transducer_greedy_decode
    jtr, jtok, ptr, _, _ = pair
    jparams, held_out, _ = trained
    model = ptr.state.model         # the port's own trained weights
    if peaky:
        jparams, _ = _peaky(jparams)
        model = _port_run(ptr, jparams).eval_model()
    hyps = []
    for (jxs, jxlen), (pxs, pxlen) in held_out:
        jy, jn, _ = jdecode(jparams, jtr.cfg, jxs, jxlen)
        with torch.no_grad():
            py, pn, _ = transducer_greedy_decode(model, ptr.cfg, pxs, pxlen)
        np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
        hyps.extend(jtok.decode([int(t) for t in h]) for h in
                    truncate_and_strip(np.asarray(jy), np.asarray(jn),
                                       blank=jtr.cfg.blank))
    assert len(hyps) == 8
    if peaky:
        assert sum(len(h) for h in hyps) > EMITTED, hyps


def _lm_pair(vocab_size):
    """The JAX script's LM (lm_init at PRNGKey(3)) and the port's LM
    holding its weights."""
    from edgedict_tpu.models.lm import LMConfig, lm_init
    from edgedict_tpu_torch.models.lm import LMModel
    jcfg = LMConfig(vocab_size=vocab_size, embed_size=32, hidden_size=64,
                    num_layers=1)
    pcfg = P.lm_config(vocab_size)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    jparams = lm_init(jax.random.PRNGKey(3), jcfg)
    model = LMModel(pcfg, 'cpu')
    model.load_state_dict(lm_state_dict_from_jax_params(
        _jax_params(jparams)))
    return jparams, jcfg, model, pcfg


def _jax_lm_ids(tok, texts):
    ids = []
    for t in texts:
        ids.extend([2] + tok.encode(t))
    return np.asarray(ids, np.int32)


def test_lm_stream_draws_and_first_steps_match_optax(pair):
    from edgedict_tpu.models.lm import lm_loss
    _, jtok, _, ptok, ptrain_set = pair
    texts = ptrain_set.texts()
    ids = P.lm_ids(ptok, texts)
    np.testing.assert_array_equal(ids, _jax_lm_ids(jtok, texts))
    seq, n_steps = 32, 5
    n = (len(ids) - 1) // seq
    rng = np.random.RandomState(0)
    want = [np.stack([ids[s:s + seq + 1]
                      for s in rng.randint(0, n, 8) * seq])
            for _ in range(n_steps)]
    got = list(P.lm_batches(ids, n_steps))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    jparams, jcfg, model, pcfg = _lm_pair(ptok.vocab_size)
    opt = optax.adam(3e-3)
    ost = opt.init(jparams)

    @jax.jit
    def lm_step(p, s, ys):
        ylen = jnp.full((ys.shape[0],), ys.shape[1], jnp.int32)
        loss, g = jax.value_and_grad(lm_loss)(p, jcfg, ys, ylen)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    jlosses = []
    for ys in want:
        jparams, ost, loss = lm_step(jparams, ost, jnp.asarray(ys))
        jlosses.append(float(loss))
    plosses = P.train_lm(model, pcfg, ids, steps=n_steps,
                         log_fn=lambda *_: None)
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    got = model.state_dict()
    for k, v in lm_state_dict_from_jax_params(_jax_params(jparams)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), RTOL, ATOL,
                                   err_msg=k)


@pytest.mark.parametrize('peaky', [False, True])
@pytest.mark.parametrize('fused', [False, True])
def test_beam_tokens_equal_the_jax_runs(pair, trained, fused, peaky):
    from edgedict_tpu.models.beam_search import (
        transducer_beam_search as jbeam)
    from edgedict_tpu_torch.models.lm import LMModel
    jtr, _, ptr, ptok, _ = pair
    jparams, held_out, _ = trained
    jl, jcfg, _, pcfg = _lm_pair(ptok.vocab_size)
    if peaky:
        jparams, jl = _peaky(jparams, jl)
    lm = LMModel(pcfg, 'cpu')
    lm.load_state_dict(lm_state_dict_from_jax_params(_jax_params(jl)))
    jlm, plm = ((jl, jcfg, 0.8), (lm, pcfg, 0.8)) if fused else (None, None)
    (jxs, jxlen), _ = held_out[0]
    jt, jn, _ = jbeam(jparams, jtr.cfg, jxs, jxlen, beam_width=4,
                      max_sym_per_frame=4, max_tokens=64, lm=jlm)
    refs, hyps = P.beam_hyps(_port_run(ptr, jparams), ptok, 4, 4, plm)
    jt, jn = np.asarray(jt), np.asarray(jn)
    want = [ptok.decode([int(t) for t in jt[b][:int(jn[b])]])
            for b in range(jt.shape[0])]
    assert hyps == want
    assert len(refs) == len(hyps) == 8 and all(refs)
    if peaky:
        assert sum(len(h) for h in hyps) > EMITTED, hyps


@pytest.mark.parametrize('peaky', [False, True])
def test_fp32_serving_leg_equals_the_jax_one(pair, trained, peaky):
    from edgedict_tpu.models.decoding import (
        transducer_greedy_decode as jdecode, truncate_and_strip)
    from edgedict_tpu.stream import prepare_inference_params
    jtr, jtok, ptr, ptok, _ = pair
    jparams, held_out, _ = trained
    if peaky:
        jparams, _ = _peaky(jparams)
    prepared = prepare_inference_params(jparams, None, quantize=None)
    want = []
    for (jxs, jxlen), _ in held_out:
        y, n, _ = jdecode(prepared, jtr.cfg, jxs, jxlen)
        want.extend(jtok.decode([int(t) for t in s]) for s in
                    truncate_and_strip(np.asarray(y), np.asarray(n),
                                       blank=jtr.cfg.blank))
    run = _port_run(ptr, jparams) if peaky else ptr
    refs, hyps = P.serving_hyps(run, ptok, None, None)
    assert hyps == want and len(refs) == 8
    if peaky:
        assert sum(len(h) for h in hyps) > EMITTED, hyps


def test_int8_leg_weights_are_the_jax_ones_bit_for_bit(pair, trained):
    from edgedict_tpu.stream import prepare_inference_params as jprepare
    from edgedict_tpu_torch.stream import prepare_inference_params
    _, _, ptr, _, _ = pair
    jparams, _, _ = trained
    dtype, quantize = P.SERVING_LEGS['int8']
    assert (dtype, quantize) == (torch.bfloat16, 'int8')
    # the same weights on both sides: the JAX run's, handed over
    model = _port_run(ptr, jparams).eval_model()
    jenc = jprepare(jparams, jnp.bfloat16, quantize='int8')['encoder']
    penc = prepare_inference_params(model, dtype, quantize=quantize).encoder
    assert len(jenc['layers']) == len(penc.lstm.lstms) == 3
    for jl, pl in zip(jenc['layers'], penc.lstm.lstms):
        for name in ('w_ih', 'w_hh'):
            q = getattr(pl, name + '_q').numpy().T
            np.testing.assert_array_equal(
                q, np.asarray(jl['rnn'][name + '_q'])[:q.shape[0]])
            np.testing.assert_array_equal(
                getattr(pl, name + '_scale').numpy(),
                np.asarray(jl['rnn'][name + '_scale'])[0])
    q = penc.proj.w_q.numpy().T
    np.testing.assert_array_equal(q, np.asarray(jenc['proj']['w_q'])
                                  [:q.shape[0]])
    np.testing.assert_array_equal(penc.proj.scale.numpy(),
                                  np.asarray(jenc['proj']['scale'])[0])


def test_snr_sweep_restores_the_held_out_set(pair):
    _, _, ptr, ptok, _ = pair
    held_out = ptr.eval_dataset, ptr.eval_loader
    seen = []
    real = ptr.evaluate
    ptr.evaluate = lambda: (seen.append(ptr.eval_dataset), real())[1]
    try:
        out = P.snr_sweep(ptr, ptok, 8, [float('inf'), 5.0],
                          log_fn=lambda *_: None)
    finally:
        del ptr.evaluate
    assert set(out) == {'snr_inf', 'snr_5'}
    assert all(0.0 <= v for v in out.values())
    assert (ptr.eval_dataset, ptr.eval_loader) == held_out
    want = J.ToyCorpus(None, 8, 1, language='hard', snr_db=5.0)
    assert seen[1].texts() == want.texts()
    np.testing.assert_array_equal(seen[1].samples[0][0],
                                  want.samples[0][0])


def test_run_with_every_option_returns_every_key(tmp_path):
    lines = []
    result = P.run(device='cpu', steps=2, logdir=str(tmp_path), beam=2,
                   lm_fusion=0.5, quant_ab=True, language='hard',
                   snr_sweep='inf,10', log_fn=lines.append, **SMALL)
    assert set(result) == {'greedy', 'beam', 'beam_lm', 'serve_fp32',
                           'serve_bf16', 'serve_int8', 'snr_inf', 'snr_10'}
    assert all(np.isfinite(v) and v >= 0 for v in result.values())
    assert any(ln.startswith('FINAL held-out (greedy)') for ln in lines)
    assert any(ln.startswith('LM trained') for ln in lines)
    assert os.path.isfile(tmp_path / 'synth' / 'models' / '2.ckpt')


def test_run_with_a_bpe_tokenizer_and_gru(tmp_path):
    result = P.run(device='cpu', steps=1, logdir=str(tmp_path),
                   tokenizer='bpe', enc_type='GRU', log_fn=lambda *_: None,
                   **SMALL)
    assert set(result) == {'greedy'}
    assert os.path.isdir(tmp_path / f'BPE-{P.BPE_SIZE}')


def test_main_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    assert P.build_parser().parse_args([]).device == 'cuda'
    with pytest.raises(TypeError):
        P.run(device='cpu', stepz=1)
    if torch.cuda.is_available():
        pytest.skip('a card is visible: the default device runs')
    with pytest.raises(RuntimeError, match='cuda'):
        P.main(['--steps', '1', '--logdir', str(tmp_path / 'logs')])
    assert not os.path.exists(tmp_path / 'logs')
    r = subprocess.run([sys.executable, '-m',
                        'edgedict_tpu_torch.scripts.synthetic_convergence',
                        '--steps', '1', '--logdir', str(tmp_path / 'logs')],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and 'cuda' in r.stderr


def test_the_script_imports_nothing_of_jax_or_the_jax_package():
    path = P.__file__
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module)
    assert names and all(n.split('.')[0] not in (
        'jax', 'jaxlib', 'optax', 'flax', 'edgedict_tpu', 'scripts')
        for n in names), names
    code = ('import sys\n'
            'import edgedict_tpu_torch.scripts.synthetic_convergence\n'
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "optax", "edgedict_tpu", "scripts")))')
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == '[]', r.stderr
