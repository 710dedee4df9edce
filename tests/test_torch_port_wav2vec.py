"""The port's wav2vec 2.0 model (edgedict_tpu_torch/models/wav2vec.py) ==
the JAX package's (edgedict_tpu/models/wav2vec.py) on the same weights,
carried across by compat.wav2vec_state_dict_from_jax_params, and the same
inputs, seeded with numpy.  Random draws cannot be reproduced across
frameworks, so the port is handed JAX's own: the test splits the key as
wav2vec_forward does (six sub-keys, the negatives' key in two) and draws
with the same shapes.  Forward outputs to rtol 1e-4 / atol 1e-5, gradients
to rtol 1e-3 / atol 1e-4; masks, indices and `correct` exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgedict_tpu.models import wav2vec as JW
from edgedict_tpu.ops import layers as JL
from edgedict_tpu_torch import compat as PC
from edgedict_tpu_torch.models import wav2vec as PW
from edgedict_tpu_torch.ops import layers as PL

RTOL, ATOL = 1e-4, 1e-5
GRTOL, GATOL = 1e-3, 1e-4
SPEC = ((10, 5, 8), (8, 4, 12), (4, 2, 16))
BASE = dict(frontend_params=SPEC, input_size=16, enc_hidden_size=16,
            enc_layers=2, enc_dropout=0.0, enc_proj_size=16,
            num_negatives=4, latent_vars=8, latent_groups=2, final_dim=8)


def _close(a, r, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a.detach()), np.asarray(r),
                               rtol, atol)


def _port(params, cls, *args):
    """A port module from JAX params, via the compat key map."""
    model = cls(*args)
    sd = PC.wav2vec_state_dict_from_jax_params(params) if cls is PW.Wav2Vec \
        else {k.split('.', 1)[1]: v
              for k, v in PC._frontend_sd(params).items()}
    model.load_state_dict(sd, strict=True)
    return model


def test_group_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 12, 17).astype(np.float32) * 3 + 1
    scale, bias = rng.randn(12).astype(np.float32), \
        rng.randn(12).astype(np.float32)
    for groups in (1, 3, 12):
        ref = JL.group_norm({'scale': scale, 'bias': bias}, jnp.asarray(x),
                            groups)
        got = PL.group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias), groups)
        _close(got, ref)
    # bf16 in, bf16 out, statistics in fp32
    got = PL.group_norm(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(scale), torch.from_numpy(bias), 1)
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize('bias', [True, False])
@pytest.mark.parametrize('length', [1500, 2001])
def test_frontend_and_lengths_match_jax(bias, length):
    params = JW.frontend_init(jax.random.PRNGKey(3), SPEC, bias=bias)
    fe = _port(jax.tree.map(np.asarray, params), PW.FrontEnd, SPEC, bias)
    x = np.random.RandomState(1).randn(2, length).astype(np.float32)
    ref = JW.frontend_apply(params, jnp.asarray(x), SPEC)
    got = PW.frontend_apply(fe, torch.from_numpy(x))
    _close(got, ref)
    assert got.shape[1] == PW.frontend_output_length(SPEC, length) \
        == JW.frontend_output_length(SPEC, length)
    for n in (400, 48000, 256000):
        assert PW.frontend_output_length(PW.DEFAULT_FRONTEND, n) == \
            JW.frontend_output_length(JW.DEFAULT_FRONTEND, n)
    assert PW.frontend_output_length(PW.DEFAULT_FRONTEND, 48000) == 297


@pytest.mark.parametrize('mode', ['default', 'layer_norm'])
def test_conv_feature_extractor_matches_jax(mode):
    layers = [(8, 10, 5), (12, 4, 2), (16, 4, 2)]
    params = JW.conv_feature_extractor_init(jax.random.PRNGKey(0), layers,
                                            mode=mode, bias=True)
    ext = _port(jax.tree.map(np.asarray, params), PW.ConvFeatureExtractor,
                layers, mode, True)
    x = np.random.RandomState(2).randn(2, 1000).astype(np.float32)
    ref = JW.conv_feature_extractor_apply(params, layers, jnp.asarray(x),
                                          mode=mode)
    _close(PW.conv_feature_extractor_apply(ext, torch.from_numpy(x)), ref)


@pytest.mark.parametrize('kw', [
    dict(mask_prob=0.3, mask_length=5, min_masks=2),
    dict(mask_prob=0.65, mask_length=10, min_masks=2),
    dict(mask_prob=0.3, mask_length=4, mask_type='uniform', mask_other=1),
    dict(mask_prob=0.3, mask_length=4, mask_type='normal', mask_other=2.0),
    dict(mask_prob=0.3, mask_length=4, mask_type='poisson'),
    dict(mask_prob=0.3, mask_length=4, no_overlap=True, min_space=1),
])
def test_mask_planner_gives_identical_arrays(kw):
    pad = np.zeros((4, 120), bool)
    pad[1, 100:] = True
    for padding in (None, pad):
        a = JW.compute_mask_indices((4, 120), padding,
                                    rng=np.random.RandomState(5), **kw)
        b = PW.compute_mask_indices((4, 120), padding,
                                    rng=np.random.RandomState(5), **kw)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(JW.mask_to_dense_indices(a),
                                      PW.mask_to_dense_indices(b))


def _vq(combine=False):
    cfg = dict(dim=16, num_vars=8, groups=2, vq_dim=8,
               combine_groups=combine)
    jcfg, pcfg = JW.GumbelVQConfig(**cfg), PW.GumbelVQConfig(**cfg)
    params = JW.gumbel_vq_init(jax.random.PRNGKey(0), jcfg)
    vq = PW.GumbelVQ(pcfg, torch.Generator().manual_seed(0))
    vq.load_state_dict({k.split('.', 1)[1]: v for k, v in
                        PC._gumbel_vq_sd(params, 'q.').items()})
    return jcfg, pcfg, params, vq


@pytest.mark.parametrize('combine', [False, True])
@pytest.mark.parametrize('training', [False, True])
def test_gumbel_vq_matches_jax(training, combine):
    jcfg, pcfg, params, vq = _vq(combine)
    x = np.random.RandomState(1).randn(2, 6, 16).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = JW.gumbel_vq_apply(params, jcfg, jnp.asarray(x), 0.7, rng=key,
                             training=training, produce_targets=True)
    u = np.asarray(jax.random.uniform(key, (2 * 6 * 2, 8)))
    xt = torch.from_numpy(x).requires_grad_()
    got = PW.gumbel_vq_apply(vq, pcfg, xt, 0.7, torch.from_numpy(u),
                             training, produce_targets=True)
    for k in ('x', 'code_perplexity', 'prob_perplexity'):
        _close(got[k], ref[k])
    np.testing.assert_array_equal(got['targets'].numpy(),
                                  np.asarray(ref['targets']))
    assert got['num_vars'] == ref['num_vars'] == 16
    assert PW.gumbel_vq_temp(pcfg, 1000) == JW.gumbel_vq_temp(jcfg, 1000)

    # gradients through the straight-through pick (training) into x, the
    # projection and the codebook
    def jloss(p, xx):
        out = JW.gumbel_vq_apply(p, jcfg, xx, 0.7, rng=key,
                                 training=training)
        return jnp.sum(out['x'] ** 2) + out['prob_perplexity']

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    (got['x'].pow(2).sum() + got['prob_perplexity']).backward()
    _close(xt.grad, jgx, GRTOL, GATOL)
    _close(vq.vars.grad, jg['vars'], GRTOL, GATOL)
    _close(vq.weight_proj.weight.grad, jg['weight_proj']['w'], GRTOL, GATOL)


def test_codebook_sampler_matches_jax():
    jcfg, pcfg, params, vq = _vq()
    key = jax.random.PRNGKey(1)
    ref = JW.gumbel_vq_sample_codebook(params, jcfg, key, b=6, n=3)
    idx = np.asarray(jax.random.randint(key, (6 * 3, 2), 0, 8))
    got = PW.gumbel_vq_sample_codebook(vq, pcfg, torch.from_numpy(idx), 6, 3)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))


def test_kmeans_vq_matches_jax():
    kw = dict(dim=16, num_vars=8, groups=2, vq_dim=8)
    jcfg, pcfg = JW.KmeansVQConfig(**kw), PW.KmeansVQConfig(**kw)
    params = JW.kmeans_vq_init(jax.random.PRNGKey(0), jcfg)
    vq = PW.KmeansVQ(pcfg, torch.Generator().manual_seed(0))
    vq.load_state_dict({'embedding': torch.from_numpy(np.asarray(
        params['embedding'])), 'proj': torch.from_numpy(np.asarray(
            params['proj'])), 'gn.weight': torch.from_numpy(np.asarray(
                params['gn']['scale'])), 'gn.bias': torch.from_numpy(
                    np.asarray(params['gn']['bias']))})
    x = np.random.RandomState(1).randn(2, 6, 16).astype(np.float32)

    def jloss(p):
        out = JW.kmeans_vq_apply(p, jcfg, jnp.asarray(x),
                                 produce_targets=True)
        return out['kmeans_loss'] + jnp.mean(out['x'] ** 2), out

    (jl, ref), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    got = PW.kmeans_vq_apply(vq, pcfg, torch.from_numpy(x),
                             produce_targets=True)
    for k in ('x', 'kmeans_loss', 'code_perplexity'):
        _close(got[k], ref[k])
    np.testing.assert_array_equal(got['targets'].numpy(),
                                  np.asarray(ref['targets']))
    (got['kmeans_loss'] + got['x'].pow(2).mean()).backward()
    _close(vq.embedding.grad, jg['embedding'], GRTOL, GATOL)
    _close(vq.proj.grad, jg['proj'], GRTOL, GATOL)
    _close(vq.gn.weight.grad, jg['gn']['scale'], GRTOL, GATOL)


@pytest.mark.parametrize('n_neg,n_cross', [(6, 0), (0, 8), (3, 2), (0, 0)])
def test_sample_negatives_matches_jax(n_neg, n_cross):
    b, tsz, m = 3, 12, 5
    y = np.random.RandomState(0).randn(b, tsz, 4).astype(np.float32)
    key = jax.random.PRNGKey(n_neg * 10 + n_cross)
    ref = JW.sample_negatives(key, jnp.asarray(y), m, n_neg, n_cross)
    kw, kx = jax.random.split(key)
    within = torch.from_numpy(np.asarray(jax.random.randint(
        kw, (b, n_neg * m), 0, tsz - 1))) if n_neg else None
    cross = torch.from_numpy(np.asarray(jax.random.randint(
        kx, (b, n_cross * m), 0, b * tsz - 1))) if n_cross else None
    got = PW.sample_negatives(torch.from_numpy(y), m, n_neg, n_cross,
                              within=within, cross=cross)
    assert got.shape == ref.shape == (n_neg + n_cross, b, m, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if n_neg and not n_cross:
        # within-utterance negatives come from the own row, never self
        eq = (got.numpy()[:, :, :, None] == y[None, :, None]).all(-1)
        assert eq.any(-1).all()
        assert (eq.argmax(-1) != np.arange(m)).all()


def jax_draws(cfg, rng, b, t, m, training=True):
    """JAX's own draws inside wav2vec_forward, under the port's names."""
    rng_g, rng_n, _, rng_iq, rng_ne, rng_cb = jax.random.split(rng, 6)
    rng_w, rng_x = jax.random.split(rng_n)
    keys = {'gumbel': rng_g, 'gumbel_input': rng_iq,
            'gumbel_everywhere': rng_ne, 'neg_within': rng_w,
            'neg_cross': rng_x, 'codebook': rng_cb}
    out = {}
    for name, (shape, high) in PW.draw_spec(cfg, b, t, m,
                                            training).items():
        arr = jax.random.uniform(keys[name], shape) if high is None \
            else jax.random.randint(keys[name], shape, 0, high)
        out[name] = torch.from_numpy(np.asarray(arr))
    return out


def _case(seed=0, training=True, infonce=True, **kw):
    """(JAX value, metrics, result, grads), (port's), mask_idx, model."""
    cfg_kw = dict(BASE, **kw)
    jcfg, pcfg = JW.Wav2VecConfig(**cfg_kw), PW.Wav2VecConfig(**cfg_kw)
    params = JW.wav2vec_init(jax.random.PRNGKey(seed), jcfg)
    model = PW.Wav2Vec(pcfg, 'cpu')
    model.load_state_dict(PC.wav2vec_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)), strict=True)
    source = np.random.RandomState(1).randn(2, 2000).astype(np.float32)
    t = JW.frontend_output_length(SPEC, 2000)
    mask = JW.compute_mask_indices((2, t), None, 0.4, 3, min_masks=2,
                                   rng=np.random.RandomState(0))
    mask_idx = JW.mask_to_dense_indices(mask)
    key = jax.random.PRNGKey(2)

    def jloss(p):
        res = JW.wav2vec_forward(p, jcfg, jnp.asarray(source),
                                 jnp.asarray(mask_idx), temp=1.0, rng=key,
                                 training=training)
        loss, met = JW.contrastive_loss(res, infonce=infonce)
        return loss, (met, res)

    (jl, (jm, jres)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    draws = jax_draws(pcfg, key, 2, t, mask_idx.shape[1], training)
    res = PW.wav2vec_forward(model, pcfg, torch.from_numpy(source),
                             torch.from_numpy(mask_idx), temp=1.0,
                             draws=draws, training=training)
    loss, met = PW.contrastive_loss(res, infonce=infonce)
    loss.backward()
    return (jl, jm, jres, jg), (loss, met, res), mask_idx, model


def _check(case, branch_params=()):
    (jl, jm, jres, jg), (loss, met, res), mask_idx, model = case
    _close(res['logits'], jres['logits'])
    assert res['logits'].shape[2] == mask_idx.shape[1]
    np.testing.assert_array_equal(np.isneginf(res['logits'].detach()),
                                  np.isneginf(np.asarray(jres['logits'])))
    _close(loss, jl)
    for k in ('features_pen', 'prob_perplexity', 'code_perplexity',
              'contrastive_loss'):
        if k in jm:
            _close(met[k], jm[k])
    assert int(met['correct']) == int(jm['correct'])
    assert met['count'] == int(jm['count'])
    want = PC.wav2vec_state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                              jg))
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want)
    for k, g in want.items():
        got = grads[k] if grads[k] is not None else torch.zeros_like(g)
        np.testing.assert_allclose(got.numpy(), g.numpy(), GRTOL, GATOL,
                                   err_msg=k)
    for name in branch_params:
        assert float(want[name].abs().sum()) > 0, name


def test_forward_loss_and_grads_match_jax():
    _check(_case(), ('quantizer.vars', 'mask_emb', 'frontend.layers.0.weight',
                     'encoder.lstm.lstms.0.weight_hh_l0'))


def test_forward_eval_mode_matches_jax():
    case = _case(training=False)
    _check(case)
    np.testing.assert_array_equal(case[1][2]['targets'].numpy(),
                                  np.asarray(case[0][2]['targets']))


def test_quantize_input_branch_matches_jax():
    case = _case(quantize_input=True)
    assert case[3].input_quantizer is not None \
        and case[3].post_extract_proj is None
    _check(case, ('input_quantizer.vars', 'project_inp.weight'))
    _close(case[1][2]['input_prob_perplexity'],
           case[0][2]['input_prob_perplexity'])


def test_quantize_input_same_quantizer_matches_jax():
    case = _case(quantize_input=True, same_quantizer=True)
    assert case[3].input_quantizer is None
    _check(case, ('quantizer.vars', 'project_inp.weight'))


def test_negatives_from_everywhere_cross_and_codebook_match_jax():
    case = _case(negatives_from_everywhere=True, cross_sample_negatives=3,
                 codebook_negatives=2)
    assert case[1][2]['logits'].shape[0] == 1 + 4 + 3 + 2
    _check(case, ('quantizer.vars',))


def test_codebook_only_negatives_match_jax():
    case = _case(num_negatives=0, cross_sample_negatives=0,
                 codebook_negatives=2)
    assert case[1][2]['logits'].shape[0] == 3
    _check(case)


def test_unquantized_targets_from_everywhere_match_jax():
    case = _case(quantize_targets=False, negatives_from_everywhere=True)
    assert case[3].quantizer is None
    _check(case, ('project_q.weight',))


def test_post_extract_proj_branch_matches_jax():
    case = _case(input_size=24)
    assert case[3].post_extract_proj is not None
    _check(case, ('post_extract_proj.weight',))


def test_bce_mode_matches_jax():
    _check(_case(infonce=False), ('mask_emb',))


@pytest.mark.parametrize('infonce', [True, False])
def test_contrastive_loss_on_given_logits(infonce):
    """Ties at the max count as wrong, a −inf negative contributes 0 to
    the BCE, and both modes equal the JAX criterion."""
    logits = np.asarray([[[5.0, 1.0, 2.0]], [[-5.0, 1.0, 3.0]],
                         [[-np.inf, 0.5, 3.0]]], np.float32)   # (3, 1, 3)
    res = {'logits': logits, 'features_pen': np.float32(0.25),
           'prob_perplexity': np.float32(9.0),
           'code_perplexity': np.float32(7.0), 'num_vars': 16}
    jl, jm = JW.contrastive_loss({k: jnp.asarray(v) for k, v in res.items()},
                                 infonce=infonce)
    pl, pm = PW.contrastive_loss({k: torch.as_tensor(v)
                                  for k, v in res.items()},
                                 infonce=infonce)
    _close(pl, jl)
    for k in ('contrastive_loss', 'prob_perplexity', 'features_pen'):
        _close(pm[k], jm[k])
    assert int(pm['correct']) == int(jm['correct']) == 1
    assert pm['count'] == 3
