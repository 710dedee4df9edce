"""Pipeline parallelism of the port (edgedict_tpu_torch/parallel/
pipeline.py) on the CPU against the JAX package's
(edgedict_tpu/parallel/pipeline.py) on the suite's virtual CPU mesh:

  * pipeline_split: the same (k0, n_tail) and the same refusals;
  * encoder_pipeline over a make_layout(pp=4) of [cpu] * 4 against JAX
    encoder_pipeline on make_mesh(dp=2, pp=4), LSTM and GRU, M = 5 (not a
    multiple of pp): rtol 2e-5 / atol 2e-6 (tests/test_pipeline.py:60-64),
    and against the port's own encoder_apply per microbatch;
  * one SGD step of make_train_step_pp against JAX make_train_step_pp,
    from features and featurized (dither and SpecAugment off: torch and JAX
    draw different bits): loss rtol 1e-5, params rtol 5e-4 / atol 1e-5
    (tests/test_pipeline.py:117-123);
  * the port's pp step against its own plain step with accum_steps = M,
    featurized with dither and SpecAugment on (the same generator draws a
    microbatch): loss rtol 1e-6, params after two Adam steps rtol 1e-4 /
    atol 1e-6 (the loss sums in another order: Adam's step scales a
    gradient's rounding to its lr);
  * pick_accum_steps' pp rule against the JAX package's, the tp and
    dropout refusals, the layout's refusals and where place_model puts
    each part ('meta' stands in for a second device);
  * cli.baseline --device cpu --pp_size 2 trains and evaluates.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgedict_tpu import optim as jopt
from edgedict_tpu.features import FeatureConfig as JFeatureConfig
from edgedict_tpu.features import FeaturePipeline as JFeaturePipeline
from edgedict_tpu.models import transducer as JT
from edgedict_tpu.parallel import pipeline as jpipe
from edgedict_tpu.parallel import train as jtrain
from edgedict_tpu_torch import optim as popt
from edgedict_tpu_torch import parallel as P
from edgedict_tpu_torch import train as ptrain
from edgedict_tpu_torch.compat import state_dict_from_jax_params
from edgedict_tpu_torch.features import FeatureConfig, FeaturePipeline
from edgedict_tpu_torch.models import transducer as PT
from edgedict_tpu_torch.parallel import pipeline as ppipe
from edgedict_tpu_torch.trainer import pick_accum_steps

CFG = dict(vocab_size=24, vocab_embed_size=8, input_size=20,
           enc_hidden_size=48, enc_layers=6, enc_proj_size=28,
           dec_hidden_size=24, dec_layers=2, dec_proj_size=20,
           joint_size=24, enc_time_reductions=(1,))


def _cfgs(**kw):
    return JT.TransducerConfig(**{**CFG, **kw}), \
        PT.TransducerConfig(**{**CFG, **kw})


def _cpu(n):
    return P.make_layout(pp=n, devices=['cpu'] * n)


def _port_model(jparams, cfg, layout=None):
    model = PT.Transducer(cfg, 'cpu')
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree.map(np.asarray, jparams)))
    return P.place_model(model, layout) if layout else model


@pytest.mark.parametrize('kw,pp', [
    ({}, 1), ({}, 2), ({}, 3), ({}, 4), ({}, 5), ({}, 0),
    ({'enc_layers': 5, 'enc_time_reductions': ()}, 4),
    ({'enc_layers': 7, 'enc_time_reductions': (0, 2)}, 2),
    ({'enc_layers': 4, 'enc_time_reductions': (1,)}, 2),
])
def test_pipeline_split_matches_jax(kw, pp):
    jcfg, pcfg = _cfgs(**kw)
    try:
        want = jpipe.pipeline_split(jcfg, pp)
    except ValueError as e:
        with pytest.raises(ValueError) as exc:
            ppipe.pipeline_split(pcfg, pp)
        assert str(exc.value) == str(e)
        return
    assert ppipe.pipeline_split(pcfg, pp) == want


@pytest.mark.parametrize('module_type', ['LSTM', 'GRU'])
def test_encoder_pipeline_matches_jax(module_type):
    jcfg, pcfg = _cfgs(module_type=module_type)
    mesh = jtrain.make_mesh(dp=2, pp=4)
    params = JT.transducer_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(0)
    m, b = 5, 4                          # M deliberately not a pp multiple
    xs = rng.randn(m, b, 18, jcfg.input_size).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jpipe.encoder_pipeline(
        p, jcfg, x, mesh))(params['encoder'], xs))
    layout = _cpu(4)
    model = _port_model(params, pcfg, layout)
    with torch.no_grad():
        got = ppipe.encoder_pipeline(model.encoder, pcfg, torch.as_tensor(xs),
                                     layout)
        plain = [PT.encoder_apply(model.encoder, pcfg,
                                  torch.as_tensor(xs[i]))[0]
                 for i in range(m)]
    assert got.shape == want.shape == (m, b, 9, jcfg.enc_proj_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)
    for i in range(m):
        np.testing.assert_allclose(got[i].numpy(), plain[i].numpy(),
                                   rtol=1e-6, atol=1e-7)


def _batch(rng, m=4, b=4, t=18, u=5, feat=20, vocab=24):
    return {'xs': rng.randn(m, b, t, feat).astype(np.float32),
            'xlen': np.tile(np.array([t, t - 3, t - 1, t - 5], np.int32),
                            (m, 1))[:, :b],
            'ys': rng.randint(4, vocab, (m, b, u)).astype(np.int32),
            'ylen': np.tile(np.array([u, u - 1, u - 2, u], np.int32),
                            (m, 1))[:, :b]}


def _audio_batch(rng, m=4, b=4, length=1600, u=5, vocab=24):
    return {'audio': (rng.randn(m, b, length) * 0.1).astype(np.float32),
            'alen': np.tile(np.array([length, length - 300, length - 100,
                                      length - 500], np.int32), (m, 1)),
            'ys': rng.randint(4, vocab, (m, b, u)).astype(np.int32),
            'ylen': np.full((m, b), u, np.int32)}


FEATS = dict(feature_size=20, n_fft=128, win_length=64, hop_length=48,
             downsample=1, dither=0.0)


@pytest.mark.parametrize('featurized', [False, True])
def test_train_step_pp_matches_jax(featurized):
    jcfg, pcfg = _cfgs()
    rng = np.random.RandomState(2)
    batch = _audio_batch(rng) if featurized else _batch(rng)
    jpipe_f = JFeaturePipeline(JFeatureConfig(**FEATS)) if featurized \
        else None
    ppipe_f = FeaturePipeline(FeatureConfig(**FEATS), 'cpu') if featurized \
        else None
    mesh = jtrain.make_mesh(dp=2, pp=4)
    jo = jopt.build_optimizer('sgd', lr=1e-2, momentum=0.0)
    jstate = jtrain.make_train_state(jax.random.PRNGKey(3), jcfg, jo, mesh)
    layout = _cpu(4)
    po = popt.build_optimizer('sgd', momentum=0.0)
    model = _port_model(jstate.params, pcfg, layout)
    pstate = ptrain.TrainState(model, po.init(dict(model.named_parameters())))

    jstep = jpipe.make_train_step_pp(jcfg, jo, mesh, bf16=False,
                                     feature_pipeline=jpipe_f)
    jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0),
                       jnp.asarray(1e-2))
    pstep = ppipe.make_train_step_pp(pcfg, po, layout, bf16=False,
                                     feature_pipeline=ppipe_f)
    pstate, pm = pstep(pstate, {k: torch.as_tensor(v)
                                for k, v in batch.items()}, 1e-2,
                       torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(pm['loss']), float(jm['loss']),
                               rtol=1e-5)
    assert float(pm['skipped']) == 0.0 and pstate.step == 1
    want = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                   jstate.params))
    got = pstate.model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=5e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize('module_type,featurized', [('LSTM', True),
                                                    ('GRU', False)])
def test_train_step_pp_equals_the_plain_step(module_type, featurized):
    """The same weights, batch and generator seed: make_train_step_pp at
    pp = 2 against make_train_step with accum_steps = M = 4, two Adam
    steps; featurized with dither and SpecAugment on, so each microbatch
    must take the plain step's draws of its micro-batch."""
    _, cfg = _cfgs(module_type=module_type)
    rng = np.random.RandomState(5)
    pipe = FeaturePipeline(FeatureConfig(
        **{**FEATS, 'dither': 1e-5}, T_mask=4, T_num_mask=1, F_mask=2,
        F_num_mask=1), 'cpu') if featurized else None
    batch = {k: torch.as_tensor(v) for k, v in (
        _audio_batch(rng) if featurized else _batch(rng)).items()}
    opt = popt.build_optimizer('adam', gradclip=1.0)
    out = []
    for layout in (None, _cpu(2)):
        state = ptrain.make_train_state(cfg, opt, 'cpu', seed=4,
                                        layout=layout)
        step = ptrain.make_train_step(cfg, opt, bf16=False,
                                      feature_pipeline=pipe) \
            if layout is None else ppipe.make_train_step_pp(
                cfg, opt, layout, bf16=False, feature_pipeline=pipe)
        gen = torch.Generator().manual_seed(11)
        losses = []
        for lr in (1e-3, 2e-3):
            state, m = step(state, batch, lr, gen)
            losses.append(float(m['loss']))
        out.append((losses, state.model.state_dict(),
                    int(state.opt_state['count'])))
    (l0, sd0, c0), (l1, sd1, c1) = out
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    assert c0 == c1 == 2
    for k, v in sd0.items():
        np.testing.assert_allclose(sd1[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize('batch_size,sub_batch_size,pp', [
    (12, 4, 1), (12, 4, 2), (12, 4, 3), (6, 6, 4), (32, 16, 2), (32, 16, 4),
    (128, 7, 2), (8, 8, 2), (9, 2, 2)])
def test_pick_accum_steps_pp_rule_matches_jax(batch_size, sub_batch_size,
                                              pp):
    from edgedict_tpu.trainer import pick_accum_steps as jpick
    assert pick_accum_steps(batch_size, sub_batch_size, pp=pp) == \
        jpick(batch_size, sub_batch_size, 1, pp=pp)


@pytest.mark.parametrize('what', ['tp', 'enc_dropout', 'dec_dropout'])
def test_train_step_pp_refuses_tp_and_dropout(what):
    """As the JAX tests test_train_step_pp_rejects_{tp,dropout}."""
    cfg = PT.TransducerConfig(**CFG)
    layout = P.make_layout(tp=1, pp=4, devices=['cpu'] * 4)
    if what == 'tp':
        layout = P.make_layout(tp=2, pp=4, devices=['cpu'] * 8)
    else:
        cfg = dataclasses.replace(cfg, **{what: 0.1})
    with pytest.raises(NotImplementedError):
        ppipe.make_train_step_pp(cfg, popt.build_optimizer('adam'), layout)


@pytest.mark.parametrize('tp,pp,n', [(0, 1, 4), (1, 0, 4), (2, 2, 3),
                                     (4, 1, 2)])
def test_make_layout_refuses_as_make_mesh(tp, pp, n):
    with pytest.raises(ValueError):
        P.make_layout(tp=tp, pp=pp, devices=['cpu'] * n)


def test_grid_devices_count_cards_without_wrapping(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert P.grid_devices('cuda', 4) == [torch.device('cuda', i)
                                         for i in range(4)]
    assert P.grid_devices('cuda:2', 2) == [torch.device('cuda', 2),
                                           torch.device('cuda', 3)]
    with pytest.raises(ValueError, match='2 cards needed from cuda:3'):
        P.grid_devices('cuda:3', 2)
    assert P.grid_devices('cpu', 3) == [torch.device('cpu')] * 3


def test_place_model_puts_each_part_on_its_slot():
    """Slot (k, s) = devices[k·pp + s]: at pp = 2 stage 1's tail layers
    (4 and 5 of 6, the preamble 0-1) go to devices[1]; at tp = 2 slice 1
    of the joint's output layer to devices[1] ('meta' here); everything
    else, and the optimizer state of each, beside its parameter."""
    cfg = PT.TransducerConfig(**CFG)
    model = P.place_model(PT.Transducer(cfg, 'cpu'),
                          P.make_layout(pp=2, devices=['cpu', 'meta']))
    on_meta = {k for k, p in model.named_parameters() if p.is_meta}
    assert on_meta == {k for k, _ in model.named_parameters()
                       if k.startswith(('encoder.lstm.lstms.4.',
                                        'encoder.lstm.lstms.5.',
                                        'encoder.lstm.projs.4.',
                                        'encoder.lstm.projs.5.'))}
    model = P.place_model(PT.Transducer(cfg, 'cpu'),
                          P.make_layout(tp=2, devices=['cpu', 'meta']))
    params = dict(model.named_parameters())
    assert {k for k, p in params.items() if p.is_meta} == {
        'joint.joint.2.weight_1', 'joint.joint.2.bias_1'}
    assert params['joint.joint.2.weight_0'].shape == (12, 24)
    state = popt.build_optimizer('adam').init(params)
    assert state['mu']['joint.joint.2.weight_1'].is_meta
    assert not state['mu']['joint.joint.2.weight_0'].is_meta
    slice_1 = {'joint.joint.2.weight_1', 'joint.joint.2.bias_1'}
    state = popt.build_optimizer('sm3').init(params)
    assert {k for k, accs in state['accs'].items()
            if all(a.is_meta for a in accs.values())} == slice_1
    state = popt.build_optimizer('novograd').init(params)
    assert {k for k, v in state['v'].items() if v.is_meta} == slice_1
    assert not state['count'].is_meta


def _corpus(root, n=8, seconds=0.6, sr=16000):
    from edgedict_tpu_torch.data.audio_io import save_wav
    rng = np.random.RandomState(0)
    d = os.path.join(root, '9', '9')
    os.makedirs(d, exist_ok=True)
    lines = []
    for i in range(n):
        name = f'9-9-{i:04d}'
        t = np.linspace(0, seconds, int(sr * seconds), endpoint=False)
        save_wav(os.path.join(d, name + '.wav'),
                 0.3 * np.sin(2 * np.pi * (300 + 40 * i) * t)
                 + 0.05 * rng.randn(len(t)), sr)
        lines.append(f'{name} HELLO WORLD {i}')
    with open(os.path.join(d, '9-9.trans.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return root


def cli_args(corpus, logs, name):
    """A tiny cli.baseline run (4 encoder layers: preamble 2, a tail of
    2) on the CPU."""
    return ['--LibriSpeech_train_100', corpus,
            '--LibriSpeech_train_360', '/nonexistent',
            '--LibriSpeech_train_500', '/nonexistent',
            '--LibriSpeech_test', corpus, '--TEDLIUM_train', '/nonexistent',
            '--CommonVoice', '/nonexistent', '--YT_bloomberg2',
            '/nonexistent', '--YT_life', '/nonexistent',
            '--logdir_root', logs, '--name', name, '--tokenizer', 'char',
            '--batch_size', '4', '--sub_batch_size', '2',
            '--eval_batch_size', '2', '--enc_hidden_size', '16',
            '--enc_layers', '4', '--enc_proj_size', '16',
            '--dec_hidden_size', '16', '--dec_layers', '1',
            '--dec_proj_size', '16', '--joint_size', '16',
            '--vocab_embed_size', '8', '--feature', 'logfbank',
            '--feature_size', '8', '--n_fft', '256', '--win_length', '256',
            '--hop_length', '128', '--downsample', '3', '--T_mask', '3',
            '--audio_bucket_frames', '8', '--warmup_step', '2',
            '--loss_step', '1', '--save_step', '2', '--eval_step', '2',
            '--epochs', '2', '--gradclip', '5', '--lr', '3e-3',
            '--num_workers', '1', '--device', 'cpu', '--nobf16']


def test_cli_baseline_pp_trains_and_evaluates(tmp_path):
    from edgedict_tpu_torch.cli import baseline
    corpus = _corpus(str(tmp_path / 'libri'))
    args = cli_args(corpus, str(tmp_path / 'logs'), 'pp') + ['--pp_size',
                                                            '2']
    lines = []
    trainer = baseline.main(args + ['--mode', 'train'], log_fn=lines.append)
    assert trainer.layout.pp == 2 and trainer.accum_steps == 2
    assert trainer.state.step == 4
    losses = [float(ln.split()[3]) for ln in lines if ln.startswith('step ')]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert sum(ln.startswith('eval @ ') for ln in lines) == 2
    lines = []
    baseline.main(args + ['--mode', 'eval'], log_fn=lines.append)
    val = [ln for ln in lines if ln.startswith('val_loss')]
    assert val and np.isfinite(float(val[0].split()[1])) and 'WER' in val[0]
