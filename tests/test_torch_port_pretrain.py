"""The port's wav2vec pretraining and raw-waveform fine-tune
(edgedict_tpu_torch/{pretrainer,raw_trainer,optim,train}.py) == the JAX
package's (edgedict_tpu/{pretrainer,raw_trainer}.py, parallel/train.py) on
the same weights and inputs: the AdamW without decay of 1-D params against
its optax chain, one pretraining update through both train steps (JAX's
draws handed to the port, the aux metrics averaged over micro-batches, no
compute-dtype cast), the host-side crops, masks and schedules, the raw
path's FrontEnd features, xlen and loss with its gradients, and the splice
of a pretraining checkpoint into the fine-tune model."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from edgedict_tpu import pretrainer as JP
from edgedict_tpu.features import pcm_to_float as j_pcm_to_float
from edgedict_tpu.models import transducer as JT
from edgedict_tpu.models import wav2vec as JW
from edgedict_tpu.parallel import TrainState as JTrainState
from edgedict_tpu.parallel import make_train_step as j_make_train_step
from edgedict_tpu_torch import compat as PC
from edgedict_tpu_torch import optim
from edgedict_tpu_torch import pretrainer as PP
from edgedict_tpu_torch import raw_trainer as PR
from edgedict_tpu_torch import train as PTR
from edgedict_tpu_torch.checkpoint import save_checkpoint
from edgedict_tpu_torch.models import transducer as PT
from edgedict_tpu_torch.models import wav2vec as PW
from test_torch_port_wav2vec import BASE, SPEC, jax_draws

RTOL, ATOL = 1e-4, 1e-5
GRTOL, GATOL = 1e-3, 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_adamw_no_ln_decay_matches_its_optax_chain():
    """Three updates on the same grads: clip, Adam(b1, b2), + wd·p only on
    params of two or more dims, × (−lr)."""
    rng = np.random.RandomState(0)
    params = {'w': rng.randn(4, 3).astype(np.float32),
              'b': rng.randn(3).astype(np.float32),
              'c': rng.randn(2, 2, 2).astype(np.float32)}
    chain = JP.adamw_no_ln_decay(1e-2, 0.9, 0.998, 0.1, gradclip=1.0)
    j_state = chain.init(params)
    opt = optim.adamw_no_ln_decay(0.9, 0.998, 0.1, gradclip=1.0)
    p_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    p_state = opt.init(p_params)
    j_params = dict(params)
    for i in range(3):
        grads = {k: rng.randn(*v.shape).astype(np.float32) * (i + 1)
                 for k, v in params.items()}
        upd, j_state = chain.update(grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        p_upd, p_state = opt.update(
            {k: torch.from_numpy(g) for k, g in grads.items()}, p_state,
            p_params, 1e-2)
        p_params = {k: p + p_upd[k] for k, p in p_params.items()}
        for k in params:
            np.testing.assert_allclose(p_upd[k].numpy(), np.asarray(upd[k]),
                                       1e-5, 1e-7, err_msg=k)
    # the bias gets no decay: the same chain without decay moves it alike
    plain = optim.Optimizer('adamw', weight_decay=0.1, b1=0.9, b2=0.998)
    g = {'b': torch.ones(3), 'w': torch.ones(4, 3)}
    p = {'b': torch.ones(3), 'w': torch.ones(4, 3)}
    masked, _ = opt.update(g, opt.init(p), p, 1.0)
    decayed, _ = plain.update(g, plain.init(p), p, 1.0)
    assert torch.equal(masked['w'], decayed['w'])
    assert torch.allclose(masked['b'] - decayed['b'], torch.full((3,), 0.1))


def test_schedules_match_jax():
    for step, warm, total in ((0, 10, 100), (5, 10, 100), (50, 10, 100),
                              (150, 10, 100), (3, 0, 0)):
        assert optim.linear_warmup_decay(step, warm, total) == \
            JP.linear_warmup_decay(step, warm, total)


def test_crops_and_mask_plans_match_jax():
    rng = np.random.RandomState(3)
    samples = [(rng.randn(n).astype(np.float32), None)
               for n in (5000, 3000, 4000, 9000)]
    a = JP.crop_audio_batch(samples, 4000, np.random.RandomState(1))
    b = PP.crop_audio_batch(samples, 4000, np.random.RandomState(1))
    for k in ('audio', 'alen'):
        np.testing.assert_array_equal(a[k], b[k])

    class Holder:
        cfg = JW.Wav2VecConfig(mask_prob=0.15, mask_length=10)

    for t in (297, 60, 25):
        ja = Holder()
        ja._np_rng = np.random.RandomState(7)
        want = JP.Wav2VecPretrainer.plan_masks(ja, 4, t)
        got = PP.plan_masks(PW.Wav2VecConfig(), 4, t,
                            np.random.RandomState(7))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (4, max(2, int(0.15 * t / 10)))


@pytest.mark.parametrize('accum', [1, 2])
def test_one_pretraining_update_matches_jax(accum):
    """The pretrainer's loss through both train steps at bf16=True (the
    custom loss takes no cast: the encoder runs fp32), lr 1e-3, clip 10:
    loss, grad norm, the micro-batch means of the aux metrics, and the
    params after the AdamW-no-LN-decay update."""
    jcfg, pcfg = JW.Wav2VecConfig(**BASE), PW.Wav2VecConfig(**BASE)
    params = _np(JW.wav2vec_init(jax.random.PRNGKey(0), jcfg))
    b, length, lr, temp = 4, 2000, 1e-3, 0.9
    t = JW.frontend_output_length(SPEC, length)
    audio = np.random.RandomState(1).randn(b, length).astype(np.float32)
    mask = JW.compute_mask_indices((b, t), None, 0.4, 3, min_masks=2,
                                   rng=np.random.RandomState(0))
    mask_idx = JW.mask_to_dense_indices(mask)
    host = {'audio': audio, 'alen': np.full((b,), length, np.int32),
            'mask_idx': mask_idx}
    jbatch = {k: jnp.asarray(v.reshape((accum, -1) + v.shape[1:]))
              for k, v in host.items()}
    rng = jax.random.PRNGKey(5)

    def j_loss(p, micro, r, aux):
        res = JW.wav2vec_forward(p, jcfg, micro['audio'], micro['mask_idx'],
                                 temp=aux['temp'], rng=r, training=True)
        loss, met = JW.contrastive_loss(res)
        return loss, {k: met[k] for k in ('contrastive_loss', 'correct',
                                          'count', 'prob_perplexity')}

    chain = optax.inject_hyperparams(lambda lr: JP.adamw_no_ln_decay(
        lr, 0.9, 0.998, 0.01, 10.0))(lr=lr)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                         opt_state=chain.init(jparams))
    jstep = j_make_train_step(jcfg, chain, bf16=True, loss_fn=j_loss,
                              loss_has_aux=True)
    jnew, jm = jstep(jstate, jbatch, rng, jnp.float32(lr),
                     {'temp': jnp.float32(temp)})
    jnew_params = _np(jnew.params)

    model = PW.Wav2Vec(pcfg, 'cpu')
    model.load_state_dict(PC.wav2vec_state_dict_from_jax_params(params))
    draws = [jax_draws(pcfg, r, b // accum, t, mask_idx.shape[1])
             for r in jax.random.split(rng, accum)]

    def p_loss(model, micro, generator, aux):
        res = PW.wav2vec_forward(model, pcfg, micro['audio'],
                                 micro['mask_idx'], temp=aux['temp'],
                                 draws=draws.pop(0), training=True)
        loss, met = PW.contrastive_loss(res)
        assert res['logits'].dtype == torch.float32
        return loss, {k: met[k] for k in ('contrastive_loss', 'correct',
                                          'count', 'prob_perplexity')}

    opt = optim.adamw_no_ln_decay(0.9, 0.998, 0.01, 10.0)
    state = PTR.TrainState(model, opt.init(dict(model.named_parameters())))
    pstep = PTR.make_train_step(pcfg, opt, bf16=True, loss_fn=p_loss,
                                loss_has_aux=True)
    state, pm = pstep(state, PTR.device_batch(host, accum, 'cpu'), lr, None,
                      {'temp': temp})
    assert not draws
    for k in ('loss', 'grad_norm', 'contrastive_loss', 'prob_perplexity'):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), RTOL,
                                   err_msg=k)
    for k in ('correct', 'count', 'skipped'):
        assert float(pm[k]) == float(jm[k]), k
    assert float(pm['count']) == b // accum * mask_idx.shape[1]
    want = PC.wav2vec_state_dict_from_jax_params(jnew_params)
    moved = 0.0
    for k, p in state.model.state_dict().items():
        d = (p - want[k]).abs()
        assert float(d.max()) <= 2 * lr + 1e-6, k
        moved = max(moved, float((p - PC.wav2vec_state_dict_from_jax_params(
            params)[k]).abs().max()))
    assert moved > 0.5 * lr


def _raw_pair(seed=0, frontend_bias=True):
    kw = dict(vocab_size=12, vocab_embed_size=8, input_size=SPEC[-1][2],
              enc_hidden_size=16, enc_layers=2, enc_proj_size=12,
              dec_hidden_size=14, dec_layers=1, dec_proj_size=12,
              joint_size=16, enc_time_reductions=())
    jcfg, pcfg = JT.TransducerConfig(**kw), PT.TransducerConfig(**kw)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = JT.transducer_init(k1, jcfg)
    params['frontend'] = JW.frontend_init(k2, SPEC, bias=frontend_bias)
    params = _np(params)
    model = PW.RawTransducer(pcfg, 'cpu', spec=SPEC)
    model.load_state_dict(PC.state_dict_from_jax_params(params))
    return jcfg, pcfg, params, model


def _j_features(params, audio, alen, spec=SPEC):
    """raw_trainer.py:71-82, the JAX raw path's feature_fn."""
    xs = JW.frontend_apply(params['frontend'], j_pcm_to_float(audio), spec)
    ratio = audio.shape[1] / xs.shape[1]
    xlen = jnp.ceil(alen.astype(jnp.float32) / ratio).astype(jnp.int32)
    return xs, jnp.minimum(xlen, xs.shape[1])


@pytest.mark.parametrize('pcm', ['int16', 'float32'])
def test_raw_features_xlen_and_loss_match_jax(pcm):
    jcfg, pcfg, params, model = _raw_pair()
    rng = np.random.RandomState(2)
    length = 3217
    audio = rng.randn(3, length) * 0.3
    audio = (audio * 32767).astype(np.int16) if pcm == 'int16' \
        else audio.astype(np.float32)
    alen = np.array([length, 2000, 1001], np.int32)
    ys = rng.randint(4, 12, (3, 5)).astype(np.int32)
    ylen = np.array([5, 3, 2], np.int32)

    def j_loss(p):
        xs, xlen = _j_features(p, jnp.asarray(audio), jnp.asarray(alen))
        return JT.transducer_loss(p, jcfg, xs, jnp.asarray(ys), xlen,
                                  jnp.asarray(ylen)), (xs, xlen)

    (jl, (jxs, jxlen)), jg = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    xs, xlen = PR.raw_features(model, SPEC, torch.from_numpy(audio),
                               torch.from_numpy(alen))
    np.testing.assert_allclose(xs.detach().numpy(), np.asarray(jxs), RTOL,
                               ATOL)
    np.testing.assert_array_equal(xlen.numpy(), np.asarray(jxlen))
    assert int(xlen.max()) == xs.shape[1] and xlen.dtype == torch.int32
    loss = PT.transducer_loss(model, pcfg, xs, torch.from_numpy(ys), xlen,
                              torch.from_numpy(ylen))
    np.testing.assert_allclose(float(loss), float(jl), RTOL)
    loss.backward()
    want = PC.state_dict_from_jax_params(_np(jg))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), GRTOL,
                                   GATOL, err_msg=k)
    assert float(model.frontend.layers[0].weight.grad.abs().sum()) > 0


def test_splice_copies_frontend_and_encoder_only():
    """Keys in both (FrontEnd convs and norms, the whole encoder) come from
    the pretraining checkpoint; the fine-tune's own keys (the FrontEnd's
    conv biases, which pretraining has not, the prediction net and the
    joint) keep their values; a shape or layer-count mismatch raises."""
    _, pcfg, _, model = _raw_pair()
    wcfg = PW.Wav2VecConfig(**dict(BASE, enc_proj_size=12))
    pre = PW.Wav2Vec(wcfg, 'cpu', seed=3).state_dict()
    dst = model.state_dict()
    out, copied = PR.splice_state_dict(dst, pre)
    assert set(copied) == {k for k in dst if k in pre}
    assert any(k.startswith('frontend.') for k in copied)
    assert any(k.startswith('encoder.') for k in copied)
    for k, v in out.items():
        ref = pre[k] if k in copied else dst[k]
        assert torch.equal(v, ref), k
    assert 'frontend.layers.0.bias' in out \
        and 'frontend.layers.0.bias' not in copied
    bad = dict(pre)
    bad['encoder.proj.weight'] = torch.zeros(5, 16)
    with pytest.raises(ValueError, match='encoder.proj.weight'):
        PR.splice_state_dict(dst, bad)
    deeper = PW.Wav2Vec(PW.Wav2VecConfig(**dict(BASE, enc_proj_size=12,
                                                enc_layers=3)), 'cpu')
    with pytest.raises(ValueError, match='layers'):
        PR.splice_state_dict(dst, deeper.state_dict())


def test_raw_trainer_loads_pretrained_and_steps(tmp_path):
    """RawTrainer from tiny flags: its feature_fn is the JAX raw path's on
    the same weights, load_pretrained splices a pretrainer checkpoint and
    starts the optimizer afresh, and a train step is finite."""
    from test_torch_port_train import _cli_args, _write_corpus

    from edgedict_tpu_torch.cli import train as cli_train
    from edgedict_tpu_torch.config import parse_flags
    corpus = _write_corpus(str(tmp_path / 'libri'), n=4)
    args = _cli_args(corpus, str(tmp_path / 'logs'), 'raw')
    flags = parse_flags(cli_train.build_parser(), args)
    trainer = PR.RawTrainer(flags)
    assert trainer.cfg.enc_time_reductions == () \
        and trainer.cfg.input_size == PW.DEFAULT_FRONTEND[-1][2]
    batch = next(iter(trainer.loader))
    dev = {k: torch.as_tensor(v) for k, v in batch.items()}
    xs, xlen = trainer.feature_fn(trainer.state.model, dev)
    params = {'frontend': {
        'layers': [{'w': l.weight.detach().numpy(),
                    'b': l.bias.detach().numpy(),
                    **({'gn': {'scale': l.gn.weight.detach().numpy(),
                               'bias': l.gn.bias.detach().numpy()}}
                       if l.gn is not None else {})}
                   for l in trainer.state.model.frontend.layers],
        'ln': {'scale': trainer.state.model.frontend.ln.weight.detach()
               .numpy(), 'bias': trainer.state.model.frontend.ln.bias
               .detach().numpy()}}}
    jxs, jxlen = _j_features(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(batch['audio']),
                             jnp.asarray(batch['alen']), JW.DEFAULT_FRONTEND)
    np.testing.assert_allclose(xs.detach().numpy(), np.asarray(jxs), RTOL,
                               ATOL)
    np.testing.assert_array_equal(xlen.numpy(), np.asarray(jxlen))

    m = trainer.run_step(batch)
    assert np.isfinite(float(m['loss'])) and trainer.state.step == 1
    wcfg = PW.Wav2VecConfig(input_size=128, enc_hidden_size=16,
                            enc_layers=2, enc_proj_size=16)
    pre = PW.Wav2Vec(wcfg, 'cpu', seed=9).state_dict()
    path = save_checkpoint(str(tmp_path), 0, pre)
    copied = trainer.load_pretrained(path)
    sd = trainer.state.model.state_dict()
    assert copied and all(torch.equal(sd[k], pre[k]) for k in copied)
    assert int(trainer.state.opt_state['count']) == 0
    assert all(float(v.abs().max()) == 0
               for v in trainer.state.opt_state['mu'].values())
    assert trainer.state.step == 1
    assert np.isfinite(float(trainer.run_step(batch)['loss']))
    assert os.path.isfile(os.path.join(trainer.logdir, 'flagfile.txt'))


def test_pretrainer_run_step_takes_the_given_draws(tmp_path):
    """Wav2VecPretrainer.run_step(batch, draws): the step's loss is the
    micro-batch mean of the pretrainer's own loss_fn on those draws at the
    host step's temperature, and two pretrainers from the same flags
    (their seeded init, crops and masks) given the same draws take the
    same step, bit for bit, at the host step's lr."""
    from test_torch_port_cli import W2V_PRETRAIN
    from test_torch_port_train import _cli_args

    from edgedict_tpu_torch.cli import pretrain_wav2vec
    from edgedict_tpu_torch.config import parse_flags
    args = _cli_args('/nonexistent', str(tmp_path), 'draws')
    flags = parse_flags(pretrain_wav2vec.build_parser(),
                        args + W2V_PRETRAIN + ['--warmup_step', '1'])
    samples = [(np.random.RandomState(i).randn(5000).astype(np.float32)
                * 0.1, None) for i in range(4)]
    pres = [PP.Wav2VecPretrainer(flags, samples) for _ in range(2)]
    for p in pres:
        p.host_step = 1
    host = pres[0].make_batch(samples)
    again = pres[1].make_batch(samples)
    for k, v in host.items():
        np.testing.assert_array_equal(v, again[k])
    pre = pres[0]
    assert pre.accum_steps == 2 and pre.learning_rate(1) > 0
    t = PW.frontend_output_length(pre.cfg.frontend_params,
                                  host['audio'].shape[1])
    draws = PW.make_draws(pre.cfg, 2, t, host['mask_idx'].shape[1],
                          torch.Generator().manual_seed(3), 'cpu')
    batch = PTR.device_batch(host, 2, 'cpu')
    aux = {'temp': pre.temperature(1), 'draws': draws}
    with torch.no_grad():
        want = np.mean([float(pre.loss_fn(
            pre.state.model, {k: v[i] for k, v in batch.items()}, None,
            aux)[0]) for i in range(2)])
    init = {k: v.clone() for k, v in pre.state.model.state_dict().items()}
    metrics = [p.run_step(host, draws=draws) for p in pres]
    np.testing.assert_allclose(float(metrics[0]['loss']), want, rtol=1e-6)
    assert float(metrics[1]['loss']) == float(metrics[0]['loss'])
    a, b = (p.state.model.state_dict() for p in pres)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], init[k]) for k in a)
    assert pre.host_step == 2
