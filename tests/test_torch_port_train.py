"""The port's training step and what surrounds it, on the CPU:

  * two make_train_step steps (adam, gradclip, accum 2, fp32, LSTM and
    GRU encoders) against the JAX package's from the same weights
    (state_dict_from_jax_params): loss rtol 1e-5, params after each step
    rtol 1e-4 / atol 1e-5 (tests/test_rnn_pallas.py:132-138);
  * the optimizers against optax, and the non-finite skip (params and
    optimizer state, Adam's count included, unchanged);
  * dither, SpecAugment and dropout by their properties (torch and JAX
    draw different bits from one seed);
  * checkpoints, and cli.baseline train → resume replaying the same losses;
  * the hand-off: a trainer checkpoint decodes through cli.stream
    --pt_path;
  * cli.profile_train on the CPU (host clocks only).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edgedict_tpu import optim as jopt
from edgedict_tpu.models import transducer as JT
from edgedict_tpu.parallel import train as jtrain
from edgedict_tpu_torch import checkpoint as C
from edgedict_tpu_torch import optim as popt
from edgedict_tpu_torch import train as ptrain
from edgedict_tpu_torch.compat import state_dict_from_jax_params
from edgedict_tpu_torch.features import FeatureConfig, FeaturePipeline, \
    spec_augment
from edgedict_tpu_torch.models import transducer as PT
from edgedict_tpu_torch.ops.layers import dropout

SMALL = dict(vocab_size=11, vocab_embed_size=4, input_size=6,
             enc_hidden_size=8, enc_layers=2, enc_proj_size=7,
             dec_hidden_size=5, dec_layers=2, dec_proj_size=6, joint_size=9)


def _batch(rng, accum=2, micro=2, t=9, u=4, feat=6, vocab=11):
    return {'xs': rng.randn(accum, micro, t, feat).astype(np.float32),
            'xlen': np.array([[t, t - 2], [t - 1, t]] * (accum // 2),
                             np.int32)[:accum, :micro],
            'ys': rng.randint(4, vocab, (accum, micro, u)).astype(np.int32),
            'ylen': np.array([[u, u - 1], [u - 2, u]] * (accum // 2),
                             np.int32)[:accum, :micro]}


def _port_state(jparams, cfg, optimizer):
    state = ptrain.make_train_state(cfg, optimizer, 'cpu')
    state.model.load_state_dict(state_dict_from_jax_params(
        jax.tree.map(np.asarray, jparams)))
    state.opt_state = optimizer.init(dict(state.model.named_parameters()))
    return state


@pytest.mark.parametrize('module_type', ['LSTM', 'GRU'])
def test_train_step_matches_jax(module_type):
    jcfg = JT.TransducerConfig(**SMALL, module_type=module_type)
    pcfg = PT.TransducerConfig(**SMALL, module_type=module_type)
    jo = jopt.build_optimizer('adam', lr=1e-2, gradclip=0.5)
    jstate = jtrain.make_train_state(jax.random.PRNGKey(3), jcfg, jo)
    po = popt.build_optimizer('adam', gradclip=0.5)
    pstate = _port_state(jstate.params, pcfg, po)
    batch = _batch(np.random.RandomState(0))
    jstep = jtrain.make_train_step(jcfg, jo, bf16=False)
    pstep = ptrain.make_train_step(pcfg, po, bf16=False)
    for i in range(2):                       # the second step sees Adam state
        lr = 1e-2 * (i + 1)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()},
                           jax.random.PRNGKey(i), jnp.asarray(lr))
        pstate, pm = pstep(pstate, ptrain.device_batch(
            {k: v.reshape((-1,) + v.shape[2:]) for k, v in batch.items()},
            2, 'cpu'), lr)
        np.testing.assert_allclose(float(pm['loss']), float(jm['loss']),
                                   1e-5)
        np.testing.assert_allclose(float(pm['grad_norm']),
                                   float(jm['grad_norm']), 1e-4)
        assert float(pm['skipped']) == 0.0
        want = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                       jstate.params))
        got = pstate.model.state_dict()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), 1e-4, 1e-5,
                                       err_msg=k)
    assert int(pstate.opt_state['count']) == 2 and pstate.step == 2


@pytest.mark.parametrize('name', ['adam', 'adamw', 'sgd', 'sm3',
                                  'novograd'])
def test_optimizer_matches_optax(name):
    """The port's update == the JAX package's optax chain (clip → scale →
    × −lr) over three steps; SM3 on a matrix, a vector and a scalar (its
    rank-1 accumulators), Novograd from its v == 0 first step, with
    weight decay."""
    rng = np.random.RandomState(1)
    params = {'a': rng.randn(3, 4).astype(np.float32),
              'b': rng.randn(5).astype(np.float32),
              'c': np.float32(rng.randn())}
    chain = [optax.clip_by_global_norm(1.0)]
    chain += {'adam': [optax.scale_by_adam()],
              'adamw': [optax.scale_by_adam(),
                        optax.add_decayed_weights(0.1)],
              'sgd': [optax.trace(decay=0.9)],
              'sm3': [jopt.scale_by_sm3(momentum=0.9)],
              'novograd': [jopt.scale_by_novograd(weight_decay=0.1)]}[name]
    jo = optax.chain(*chain)
    po = popt.Optimizer(name, gradclip=1.0, weight_decay=0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    js, ps = jo.init(jp), po.init(pp)
    for step in range(3):
        grads = {k: np.array(rng.randn(*np.shape(v)) * (step + 1),
                             np.float32) for k, v in params.items()}
        ju, js = jo.update({k: jnp.asarray(g) for k, g in grads.items()},
                           js, jp)
        jp = {k: jp[k] - 0.05 * ju[k] for k in jp}
        pu, ps = po.update({k: torch.from_numpy(g) for k, g in grads.items()},
                           ps, pp, 0.05)
        pp = {k: pp[k] + pu[k] for k in pp}
        for k in params:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       1e-5, 1e-6)


def test_non_finite_step_leaves_params_and_state_unchanged():
    cfg = PT.TransducerConfig(**SMALL)
    opt = popt.build_optimizer('adam', gradclip=1.0)
    state = ptrain.make_train_state(cfg, opt, 'cpu', seed=4)
    step = ptrain.make_train_step(cfg, opt, bf16=False)
    batch = ptrain.device_batch({k: v.reshape((-1,) + v.shape[2:]) for k, v
                                 in _batch(np.random.RandomState(2)).items()},
                                2, 'cpu')
    state, m = step(state, batch, 1e-3)                  # a good step first
    assert float(m['skipped']) == 0.0
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt_before = popt.select_state(torch.tensor(True), state.opt_state,
                                   state.opt_state)
    bad = dict(batch)
    bad['xs'] = batch['xs'].clone()
    bad['xs'][1, 0, 3] = float('nan')
    state, m = step(state, bad, 1e-3)
    assert float(m['skipped']) == 1.0
    assert not np.isfinite(float(m['loss']))
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert int(state.opt_state['count']) == int(opt_before['count']) == 1
    for part in ('mu', 'nu'):
        for k, v in state.opt_state[part].items():
            assert torch.equal(v, opt_before[part][k])
    state, m = step(state, batch, 1e-3)                  # and on again
    assert float(m['skipped']) == 0.0
    assert int(state.opt_state['count']) == 2


def test_spec_augment_properties():
    g = torch.Generator().manual_seed(0)
    feat = torch.ones(64, 40, 12)
    out = spec_augment(feat, 10, 2, 4, 1, g)
    masked = out == 0
    assert set(out.unique().tolist()) <= {0.0, 1.0}
    # masks are whole time rows and frequency columns, per sample
    t_rows = masked.all(dim=2)
    f_cols = masked.all(dim=1)
    assert torch.equal(masked, t_rows[:, :, None] | f_cols[:, None, :])
    assert int(t_rows.sum(1).max()) <= 2 * 9 and int(f_cols.sum(1).max()) <= 3
    assert t_rows.any() and f_cols.any()
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(out, spec_augment(feat, 10, 2, 4, 1, g2))


def test_train_features_dither_and_augment():
    cfg = FeatureConfig(feature_size=8, n_fft=64, win_length=40,
                        hop_length=20, downsample=3, T_mask=3, T_num_mask=1,
                        F_mask=4, F_num_mask=1)
    pipe = FeaturePipeline(cfg, 'cpu')
    audio = torch.from_numpy(np.random.RandomState(3).randn(4, 1200)
                             .astype(np.float32)) * 0.1
    lens = torch.full((4,), 1200)
    clean, n0 = pipe(audio, lens)
    aug, n1 = pipe(audio, lens, train=True,
                   generator=torch.Generator().manual_seed(1))
    assert torch.equal(n0, n1) and aug.shape == clean.shape
    kept = aug != 0
    # where nothing is masked, only the 1e-5 dither separates them
    np.testing.assert_allclose(aug[kept].numpy(), clean[kept].numpy(),
                               rtol=0, atol=1e-2)
    assert not torch.equal(aug[kept], clean[kept])
    no_aug = FeaturePipeline(FeatureConfig(
        feature_size=8, n_fft=64, win_length=40, hop_length=20,
        downsample=3, dither=0.0), 'cpu')
    same, _ = no_aug(audio, lens, train=True,
                     generator=torch.Generator().manual_seed(1))
    assert torch.equal(same, clean)


def test_dropout_properties():
    x = torch.ones(200, 100)
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.25, False, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.75, rtol=1e-6)
    assert dropout(x, 0.25, True, g) is x and dropout(x, 0.0, False, g) is x
    cfg = PT.TransducerConfig(**dict(SMALL, enc_dropout=0.3, dec_dropout=0.3))
    model = PT.Transducer(cfg, 'cpu', seed=1)
    xs = torch.randn(2, 8, 6)
    a, _ = PT.encoder_apply(model.encoder, cfg, xs)
    b, _ = PT.encoder_apply(model.encoder, cfg, xs, deterministic=False,
                            generator=torch.Generator().manual_seed(2))
    c, _ = PT.encoder_apply(model.encoder, cfg, xs, deterministic=False)
    assert not torch.equal(a, b) and torch.equal(a, c)


def test_e6d2_flagfile_parses_for_the_trainer():
    from edgedict_tpu_torch.cli import baseline
    from edgedict_tpu_torch.config import parse_flags
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    f = parse_flags(baseline.build_parser(),
                    [f'--flagfile={repo}/flagfiles/E6D2.txt'])
    assert (f.batch_size, f.sub_batch_size, f.optim, f.lr) == (32, 32,
                                                                'adam', 5e-4)
    assert f.sched and f.bf16 and f.gradclip is None and f.mode == 'train'
    assert (f.T_mask, f.T_num_mask, f.F_mask, f.F_num_mask) == (50, 2, 5, 1)
    assert (f.enc_hidden_size, f.enc_layers, f.joint_size, f.bpe_size) == (
        1024, 6, 640, 2048)
    assert f.warmup_step == 10000 and f.audio_max_length == 16


def test_checkpoint_roundtrip_latest_and_prune(tmp_path):
    logdir = str(tmp_path / 'run')
    sd = {'w': torch.arange(3.0)}
    for step in (1, 5, 12):
        C.save_checkpoint(logdir, step, sd, {'count': torch.tensor(step)},
                          {'scale': 0.5}, {'best_wer': 0.1})
    assert C.latest_step(logdir) == 12
    p = C.load_checkpoint(C.checkpoint_path(logdir, 5))
    assert p['step'] == 5 and torch.equal(p['model']['w'], sd['w'])
    assert int(p['optim']['count']) == 5 and p['sched'] == {'scale': 0.5}
    assert C.prune_checkpoints(logdir, 1) == [1, 5]
    assert C.latest_step(logdir) == 12


def _write_corpus(root, n=8, seconds=0.6, sr=16000):
    """LibriSpeech layout: <root>/9/9/9-9.trans.txt + wav files."""
    from edgedict_tpu.data.audio_io import save_wav
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


def _cli_args(corpus, logs, name):
    return ['--LibriSpeech_train_100', corpus,
            '--LibriSpeech_train_360', '/nonexistent',
            '--LibriSpeech_train_500', '/nonexistent',
            '--LibriSpeech_test', corpus, '--TEDLIUM_train', '/nonexistent',
            '--CommonVoice', '/nonexistent', '--YT_bloomberg2',
            '/nonexistent', '--YT_life', '/nonexistent',
            '--logdir_root', logs, '--name', name, '--tokenizer', 'char',
            '--batch_size', '4', '--sub_batch_size', '2',
            '--eval_batch_size', '2', '--enc_hidden_size', '16',
            '--enc_layers', '2', '--enc_proj_size', '16',
            '--dec_hidden_size', '16', '--dec_layers', '1',
            '--dec_proj_size', '16', '--joint_size', '16',
            '--vocab_embed_size', '8', '--feature', 'logfbank',
            '--feature_size', '8', '--n_fft', '256', '--win_length', '256',
            '--hop_length', '128', '--downsample', '3', '--T_mask', '3',
            '--audio_bucket_frames', '8', '--warmup_step', '2',
            '--loss_step', '1', '--save_step', '3', '--eval_step', '1000',
            '--epochs', '3', '--gradclip', '5', '--lr', '3e-3',
            '--num_workers', '1', '--device', 'cpu', '--nobf16']


def test_cli_baseline_train_resume_replays_losses(tmp_path):
    """train 6 steps (checkpoints at 3 and 6); resume from 3 in a copy of
    the run: steps 4-6 replay the same losses and end on the same params,
    bit for bit (the augmentation generator, loader epoch and in-epoch
    position come back with the checkpoint)."""
    from edgedict_tpu_torch.cli import baseline
    corpus = _write_corpus(str(tmp_path / 'libri'))
    logs = str(tmp_path / 'logs')
    args = _cli_args(corpus, logs, 'run')
    lines_a = []
    a = baseline.main(args + ['--mode', 'train'], log_fn=lines_a.append)
    assert a.state.step == 6
    steps_a = [ln for ln in lines_a if ln.startswith('step ')]
    assert len(steps_a) == 6
    final_a = C.load_checkpoint(C.checkpoint_path(a.logdir, 6))['model']
    os.remove(C.checkpoint_path(a.logdir, 6))
    lines_b = []
    b = baseline.main(args + ['--mode', 'resume', '--resume_step', '3'],
                      log_fn=lines_b.append)
    assert 'resumed from step 3' in lines_b
    steps_b = [ln for ln in lines_b if ln.startswith('step ')]
    strip = lambda ln: ln.rsplit(' (', 1)[0]  # noqa: E731  (drop the clock)
    assert [strip(x) for x in steps_b] == [strip(x) for x in steps_a[3:]]
    for k, v in b.state.model.state_dict().items():
        assert torch.equal(v, final_a[k]), k
    lines_e = []
    baseline.main(args + ['--mode', 'eval'], log_fn=lines_e.append)
    val = [ln for ln in lines_e if ln.startswith('val_loss')]
    assert val and np.isfinite(float(val[0].split()[1]))
    assert 'WER' in val[0]
    assert os.path.isfile(os.path.join(logs, 'run', 'flagfile.txt'))


def test_trainer_checkpoint_decodes_through_cli_stream(tmp_path, capsys):
    """Hand-off: the trainer's checkpoint and flag snapshot drive the
    streaming CLI (--pt_path) on a wav file."""
    from edgedict_tpu.data.audio_io import save_wav
    from edgedict_tpu_torch.cli import baseline, stream
    corpus = _write_corpus(str(tmp_path / 'libri'), n=4)
    logs = str(tmp_path / 'logs')
    args = _cli_args(corpus, logs, 'handoff')
    args[args.index('--epochs') + 1] = '1'
    trainer = baseline.main(args + ['--mode', 'train'], log_fn=lambda *_: 0)
    ckpt = C.checkpoint_path(trainer.logdir, trainer.state.step)
    wav = str(tmp_path / 'x.wav')
    save_wav(wav, np.random.RandomState(1).randn(8000) * 0.1, 16000)
    capsys.readouterr()
    stream.main(['--flagfile', os.path.join(trainer.logdir, 'flagfile.txt'),
                 '--pt_path', ckpt, '--path', wav, '--device', 'cpu'])
    out = capsys.readouterr().out
    assert f'loaded {ckpt}' in out and 'throughput' in out


def test_profile_train_cpu_smoke():
    from edgedict_tpu_torch.cli import profile_train
    res = profile_train.main(
        ['--device', 'cpu', '--batch_size', '2', '--sub_batch_size', '1',
         '--seconds', '0.5', '--label_len', '3', '--steps', '1',
         '--bpe_size', '12', '--enc_hidden_size', '8', '--enc_layers', '2',
         '--enc_proj_size', '8', '--dec_hidden_size', '8', '--dec_layers',
         '1', '--dec_proj_size', '8', '--joint_size', '8',
         '--vocab_embed_size', '4', '--feature', 'logfbank',
         '--feature_size', '8', '--n_fft', '128', '--win_length', '128',
         '--hop_length', '64', '--gradclip', '1'], log_fn=lambda *_: 0)
    assert res['accum'] == 2 and res['step_ms'] > 0
    assert set(res['stage_ms']) == {'forward', 'loss', 'backward',
                                    'optimizer'}
    assert res['device_busy_share'] is None and len(res['losses']) == 1


def test_profile_train_k8_slab_mb_sets_the_plan_for_the_run_alone():
    from edgedict_tpu_torch.cli import profile_train
    from edgedict_tpu_torch.ops import joint_lse_plan
    default = joint_lse_plan.SLAB_BYTES
    argv = ['--device', 'cpu', '--batch_size', '2', '--sub_batch_size', '1',
            '--seconds', '0.5', '--label_len', '3', '--steps', '1',
            '--bpe_size', '12', '--enc_hidden_size', '8', '--enc_layers', '2',
            '--enc_proj_size', '8', '--dec_hidden_size', '8', '--dec_layers',
            '1', '--dec_proj_size', '8', '--joint_size', '8',
            '--vocab_embed_size', '4', '--feature', 'logfbank',
            '--feature_size', '8', '--n_fft', '128', '--win_length', '128',
            '--hop_length', '64', '--gradclip', '1']
    res = profile_train.main(argv + ['--k8_slab_mb', '8'],
                             log_fn=lambda *_: 0)
    assert res['k8_slab_bytes'] == 8 << 20
    assert joint_lse_plan.SLAB_BYTES == default
    assert profile_train.main(argv, log_fn=lambda *_: 0)[
        'k8_slab_bytes'] == default
