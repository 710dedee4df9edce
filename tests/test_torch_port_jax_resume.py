"""A run trained and saved by the JAX package goes on in the port, on the CPU.

For each optimizer (adam, adamw, sgd, sm3, novograd) with the global-norm
clip on and off: the JAX Trainer takes two steps and saves
logs/<name>/models/2.ckpt (flax-msgpack: params, the optax state, step,
plateau state, best WER); the port's Trainer loads it (model,
compat.optim_state_from_jax, sched, best_wer), and both packages take
step 3 on the same batch without augmentation (fp32).  Loss rtol 1e-5,
params rtol 1e-4 / atol 1e-5 (the tolerances of
tests/test_torch_port_train.py).  SM3's accumulators and Novograd's
second moments are per JAX tensor, so the joint's w_enc | w_dec keep
theirs apart in the port (optim.Optimizer segments).  The same
checkpoint also resumes on a port Trainer at --tp_size 2.  Also: the port's
load_reference_checkpoint gives state_dict_from_jax_params of the saved
params bit for bit, and its greedy decode the JAX package's tokens.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgedict_tpu_torch.compat import state_dict_from_jax_params

from test_torch_port_train import _write_corpus

TINY = dict(tokenizer='char', batch_size=4, sub_batch_size=2,
            eval_batch_size=2, enc_hidden_size=16, enc_layers=2,
            enc_proj_size=16, dec_hidden_size=16, dec_layers=1,
            dec_proj_size=12, joint_size=16, vocab_embed_size=8,
            feature='logfbank', feature_size=8, n_fft=256, win_length=256,
            hop_length=128, downsample=3, audio_bucket_frames=16,
            label_bucket=16, audio_max_length=2.0, lr=1e-3, warmup_step=2,
            epochs=1)
NONE_DIRS = ('LibriSpeech_train_360', 'LibriSpeech_train_500',
             'TEDLIUM_train', 'CommonVoice', 'YT_bloomberg2', 'YT_life',
             'LibriSpeech_test')


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    return _write_corpus(str(tmp_path_factory.mktemp('resume') / 'libri'))


@pytest.fixture()
def jax_flags():
    from edgedict_tpu.config import FLAGS, ensure_parsed
    ensure_parsed()
    saved = {k: getattr(FLAGS, k) for k in FLAGS}
    yield FLAGS
    for k, v in saved.items():
        if getattr(FLAGS, k) != v:
            setattr(FLAGS, k, v)


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    t, u = 9, 4
    return {'xs': rng.randn(2, 2, t, cfg.input_size).astype(np.float32),
            'xlen': np.array([[t, t - 2], [t - 1, t]], np.int32),
            'ys': rng.randint(4, cfg.vocab_size, (2, 2, u)).astype(np.int32),
            'ylen': np.array([[u, u - 1], [u - 2, u]], np.int32)}


def _jax_run(jflags, corpus, logs, optim, gradclip):
    """The JAX Trainer after two fp32 steps on seeded batches, its plateau
    state moved and a best WER set, saved: → (trainer, step fn)."""
    from edgedict_tpu.parallel import train as jtrain
    from edgedict_tpu.trainer import Trainer
    for k, v in TINY.items():
        setattr(jflags, k, v)
    for k in NONE_DIRS:
        setattr(jflags, k, os.path.join(logs, 'none'))
    jflags.LibriSpeech_train_100 = corpus
    jflags.logdir_root, jflags.name = logs, 'run'
    jflags.optim, jflags.gradclip = optim, gradclip
    jflags.dp_size, jflags.tp_size, jflags.device_corpus = 1, 1, False
    trainer = Trainer(jflags)
    step = jtrain.make_train_step(trainer.cfg, trainer.optimizer, bf16=False)
    state = trainer.state
    for i in range(2):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in
                                _batch(trainer.cfg, i).items()},
                        jax.random.PRNGKey(i), jnp.asarray(1e-2))
    trainer.state = state
    trainer.sched.step(1.0)
    trainer.sched.step(2.0)                 # one bad eval
    trainer._best_wer = 0.375
    trainer.save()
    return trainer, step


def _port_trainer(corpus, logs, optim, gradclip, extra=()):
    from edgedict_tpu_torch.cli import baseline
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.trainer import Trainer
    argv = ['--device', 'cpu', '--nobf16', '--LibriSpeech_train_100', corpus,
            '--logdir_root', logs, '--name', 'run', '--optim', optim,
            '--gradclip', str(gradclip), *extra]
    for k, v in TINY.items():
        argv += [f'--{k}', str(v)]
    for k in NONE_DIRS:
        argv += [f'--{k}', os.path.join(logs, 'none')]
    return Trainer(parse_flags(baseline.build_parser(), argv))


@pytest.mark.parametrize('gradclip', [None, 0.05])
@pytest.mark.parametrize('optim', ['adam', 'adamw', 'sgd', 'sm3',
                                   'novograd'])
def test_resume_from_a_jax_checkpoint_matches_its_next_step(
        corpus, tmp_path, jax_flags, optim, gradclip):
    from edgedict_tpu_torch import train as ptrain
    logs = str(tmp_path / 'logs')
    jtr, jstep = _jax_run(jax_flags, corpus, logs, optim, gradclip)
    ptr = _port_trainer(corpus, logs, optim, gradclip)
    lines = []
    assert ptr.load(log_fn=lines.append) == 2 and ptr.state.step == 2
    assert ptr.sched.state_dict() == jtr.sched.state_dict() == {
        'best': 1.0, 'bad_evals': 1, 'scale': 1.0}
    assert ptr._best_wer == 0.375
    assert int(ptr.state.opt_state['count']) == 2
    sd = {k: v.clone() for k, v in ptr.state.model.state_dict().items()}
    for k, v in state_dict_from_jax_params(
            jax.tree.map(np.asarray, jtr.state.params)).items():
        assert torch.equal(sd[k], v), k

    batch = _batch(jtr.cfg, 2)
    lr = 1e-2
    jstate, jm = jstep(jtr.state, {k: jnp.asarray(v) for k, v in
                                   batch.items()},
                       jax.random.PRNGKey(2), jnp.asarray(lr))
    pstep = ptrain.make_train_step(ptr.cfg, ptr.optimizer, bf16=False)
    pstate, pm = pstep(ptr.state, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, lr)
    np.testing.assert_allclose(float(pm['loss']), float(jm['loss']), 1e-5)
    assert float(pm['skipped']) == 0.0
    if gradclip:                            # the clip engaged
        assert float(jm['grad_norm']) > gradclip
    want = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                   jstate.params))
    got = pstate.model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), 1e-4, 1e-5,
                                   err_msg=k)
    for k in ('joint.joint.0.weight', 'encoder.lstm.lstms.0.weight_ih_l0'):
        assert not torch.equal(want[k], sd[k]), k     # the step moved it
    assert int(pstate.opt_state['count']) == 3


@pytest.mark.parametrize('optim', ['adam', 'sm3', 'novograd'])
def test_resume_from_a_jax_checkpoint_onto_a_tp_grid(corpus, tmp_path,
                                                    jax_flags, optim):
    """The JAX run's checkpoint loads into a port Trainer at --tp_size 2
    (the joint's output layer and its optimizer state scattered over two
    vocabulary slices, SM3's and Novograd's statistics spanning them),
    and step 3 matches the JAX package's (the tolerances above)."""
    from edgedict_tpu_torch import train as ptrain
    logs = str(tmp_path / 'logs')
    jtr, jstep = _jax_run(jax_flags, corpus, logs, optim, 0.05)
    ptr = _port_trainer(corpus, logs, optim, 0.05, ['--tp_size', '2'])
    assert ptr.load() == 2 and int(ptr.state.opt_state['count']) == 2
    v = ptr.cfg.vocab_size
    assert v % 2 == 0 and ptr.optimizer.shards == {
        'joint.joint.2.weight': 2, 'joint.joint.2.bias': 2}
    assert ptr.state.model.joint.out.slices('weight')[1].shape[0] == v // 2
    batch = _batch(jtr.cfg, 2)
    jstate, jm = jstep(jtr.state, {k: jnp.asarray(v_) for k, v_ in
                                   batch.items()},
                       jax.random.PRNGKey(2), jnp.asarray(1e-2))
    pstep = ptrain.make_train_step(ptr.cfg, ptr.optimizer, bf16=False)
    pstate, pm = pstep(ptr.state, {k: torch.from_numpy(v_)
                                   for k, v_ in batch.items()}, 1e-2)
    np.testing.assert_allclose(float(pm['loss']), float(jm['loss']), 1e-5)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                   jstate.params))
    got = pstate.model.state_dict()
    for k, v_ in want.items():
        np.testing.assert_allclose(got[k].numpy(), v_.numpy(), 1e-4, 1e-5,
                                   err_msg=k)
    assert int(pstate.opt_state['count']) == 3


@pytest.mark.parametrize('saved,resumed', [('adam', 'sgd'),
                                            ('sm3', 'adam')])
def test_resume_with_another_optimizer_raises(corpus, tmp_path, jax_flags,
                                              saved, resumed):
    """An optax state that the port's optimizer cannot take raises, as the
    JAX package's restore against its target does: the run never goes on
    from a fresh optimizer state."""
    logs = str(tmp_path / 'logs')
    _jax_run(jax_flags, corpus, logs, saved, None)
    ptr = _port_trainer(corpus, logs, resumed, None)
    with pytest.raises(ValueError, match='optax chain'):
        ptr.load()


def test_reference_loader_and_greedy_decode_of_a_jax_run(corpus, tmp_path,
                                                         jax_flags):
    from edgedict_tpu.models.decoding import transducer_greedy_decode as jdec
    from edgedict_tpu_torch.checkpoint import checkpoint_path
    from edgedict_tpu_torch.compat import load_reference_checkpoint
    from edgedict_tpu_torch.models.decoding import transducer_greedy_decode
    logs = str(tmp_path / 'logs')
    jtr, _ = _jax_run(jax_flags, corpus, logs, 'adam', None)
    ptr = _port_trainer(corpus, logs, 'adam', None)
    model = load_reference_checkpoint(checkpoint_path(jtr.logdir, 2),
                                      ptr.cfg, 'cpu')
    want = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                   jtr.state.params))
    sd = model.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    rng = np.random.RandomState(5)
    xs = rng.randn(3, 30, jtr.cfg.input_size).astype(np.float32) * 3
    xlen = np.array([30, 21, 12], np.int32)
    jy, jn, _ = jdec(jtr.state.params, jtr.cfg, jnp.asarray(xs),
                     jnp.asarray(xlen))
    with torch.no_grad():
        py, pn, _ = transducer_greedy_decode(model, ptr.cfg,
                                             torch.from_numpy(xs),
                                             torch.from_numpy(xlen))
    assert np.array_equal(np.asarray(jn), pn.numpy())
    assert np.array_equal(np.asarray(jy), py.numpy())
    assert (py.numpy() != 0).any()          # it emits labels


@pytest.mark.parametrize('name', ['sm3', 'novograd'])
def test_sm3_novograd_keep_the_joint_state_per_jax_tensor(name):
    """Two steps from the same init: with the joint's first weight cut into
    the JAX package's w_enc | w_dec (transducer.build_optimizer) the
    port's step is the JAX package's (~1e-8 apart); kept as one tensor
    (a bare optim.Optimizer), SM3's row
    accumulator and Novograd's second moment span both pieces and the
    joint drifts by 5e-4 (SM3) to 4e-3 (Novograd) at lr 1e-2."""
    from edgedict_tpu import optim as jopt
    from edgedict_tpu.models import transducer as JT
    from edgedict_tpu.parallel import train as jtrain
    from edgedict_tpu_torch import optim as popt
    from edgedict_tpu_torch import train as ptrain
    from edgedict_tpu_torch.models import transducer as PT

    from test_torch_port_train import SMALL, _batch as small_batch
    jcfg, pcfg = JT.TransducerConfig(**SMALL), PT.TransducerConfig(**SMALL)
    jo = jopt.build_optimizer(name, lr=1e-2)
    jstate = jtrain.make_train_state(jax.random.PRNGKey(3), jcfg, jo)
    jstep = jtrain.make_train_step(jcfg, jo, bf16=False)
    init = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                   jstate.params))
    batch = small_batch(np.random.RandomState(0))
    host = {k: v.reshape((-1,) + v.shape[2:]) for k, v in batch.items()}
    for i in range(2):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                   batch.items()},
                          jax.random.PRNGKey(i), jnp.asarray(1e-2))
    want = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                   jstate.params))
    drift = {}
    for segmented in (True, False):
        po = PT.build_optimizer(pcfg, name) if segmented else \
            popt.Optimizer(name)
        state = ptrain.make_train_state(pcfg, po, 'cpu')
        state.model.load_state_dict(init)
        state.opt_state = po.init(dict(state.model.named_parameters()))
        pstep = ptrain.make_train_step(pcfg, po, bf16=False)
        for _ in range(2):
            state, _ = pstep(state, ptrain.device_batch(host, 2, 'cpu'),
                             1e-2)
        got = state.model.state_dict()
        drift[not segmented] = float(
            (got['joint.joint.0.weight'] - want['joint.joint.0.weight'])
            .abs().max())
        if segmented:
            assert set(state.opt_state['v' if name == 'novograd'
                                       else 'accs']) >= {
                'joint.joint.0.weight[0]', 'joint.joint.0.weight[1]'}
            for k, v in want.items():
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), 1e-4,
                                           1e-5, err_msg=k)
    assert drift[False] < 1e-6 < 1e-4 < drift[True]
