"""Data-parallel training of the port on the CPU, two gloo processes with a
file:// rendezvous in tmp_path (no port to race for), each spawn joined
within 120 s so a hang fails instead of stalling the suite:

  * the shared train step (train.py) on a tiny LSTM and a tiny GRU, two
    ranks of two rows for two Adam steps with gradient clipping, equals
    the one-process step over the four rows with accum_steps=2 (rtol
    1e-5) and the JAX package's step on a make_mesh(dp=2) over two of the
    suite's virtual CPU devices (rtol 1e-4 / atol 1e-5); dropout and
    SpecAugment are off (each rank draws its own);
  * a NaN in one rank's rows makes both ranks skip, Adam's count kept;
  * cli.distributed under the JAX launcher's flags on a 9-utterance corpus
    (shards of 5 and 4 utterances at batch 1, so the loaders' lengths
    differ) runs to its end, only rank 0 writes, and both ranks log the
    same evaluation;
  * the same at dp = 2 × pp = 2 (--pp_size 2, 4 encoder layers, batch 2
    in 2 pipeline microbatches), as tests/test_cli_baseline.py runs the
    JAX CLI: both ranks train and log the same evaluation, and rank 0's
    checkpoint holds the one-device key layout;
  * a rank's grid of tp × pp cards starts at cuda:<local rank · tp·pp>:
    too few visible exits 2 naming the count (no wrap).
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgedict_tpu import optim as jopt
from edgedict_tpu.models import transducer as JT
from edgedict_tpu.parallel import train as jtrain
from edgedict_tpu_torch import optim as popt
from edgedict_tpu_torch import train as ptrain
from edgedict_tpu_torch.compat import state_dict_from_jax_params
from edgedict_tpu_torch.models import transducer as PT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', 'torch_dp_worker.py')
JOIN_S = 120
SMALL = dict(vocab_size=11, vocab_embed_size=4, input_size=6,
             enc_hidden_size=8, enc_layers=2, enc_proj_size=7,
             dec_hidden_size=5, dec_layers=2, dec_proj_size=6, joint_size=9)
LRS = (1e-2, 2e-2)
GRADCLIP = 0.5


def _env():
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    return env


def _run_ranks(argvs, cwds=None):
    """Start one process per argv, join each within JOIN_S; → [(rc,
    stdout, stderr)].  A process still running at its limit fails the
    test (all are killed)."""
    procs = [subprocess.Popen(argv, cwd=(cwds or [REPO] * len(argvs))[i],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i, argv in enumerate(argvs)]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=JOIN_S)
            out.append((p.returncode, stdout, stderr))
    except subprocess.TimeoutExpired:
        pytest.fail(f'a rank did not finish within {JOIN_S} s')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, stdout, stderr in out:
        assert rc == 0, stdout[-3000:] + stderr[-3000:]
    return out


def _batches(rng, steps=2, rows=4, t=9, u=4, feat=6, vocab=11):
    return {'xs': rng.randn(steps, rows, t, feat).astype(np.float32),
            'xlen': np.tile(np.array([t, t - 2, t - 1, t - 3], np.int32),
                            (steps, 1)),
            'ys': rng.randint(4, vocab, (steps, rows, u)).astype(np.int32),
            'ylen': np.tile(np.array([u, u - 1, u - 2, u], np.int32),
                            (steps, 1))}


def _dp_run(tmp_path, state_dict, batches, module_type):
    spec = {'cfg': dict(SMALL, module_type=module_type),
            'gradclip': GRADCLIP, 'lrs': list(LRS),
            'batches': {k: torch.as_tensor(v) for k, v in batches.items()},
            'state_dict': state_dict}
    torch.save(spec, tmp_path / 'spec.pt')
    rdv = tmp_path / 'rendezvous'
    _run_ranks([[sys.executable, WORKER, str(rdv), str(r), '2',
                 str(tmp_path / 'spec.pt'), str(tmp_path / f'out{r}.pt')]
                for r in range(2)])
    return [torch.load(tmp_path / f'out{r}.pt') for r in range(2)]


def _one_process(state_dict, batches, module_type):
    """The one-device step over all four rows, rows 0-1 the first
    micro-batch and 2-3 the second (rank order)."""
    cfg = PT.TransducerConfig(**SMALL, module_type=module_type)
    opt = popt.build_optimizer('adam', gradclip=GRADCLIP)
    state = ptrain.make_train_state(cfg, opt, 'cpu')
    state.model.load_state_dict(state_dict)
    state.opt_state = opt.init(dict(state.model.named_parameters()))
    step = ptrain.make_train_step(cfg, opt, bf16=False)
    states, metrics = [], []
    for i, lr in enumerate(LRS):
        state, m = step(state, ptrain.device_batch(
            {k: v[i] for k, v in batches.items()}, 2, 'cpu'), lr)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append({k: v.clone() for k, v in
                       state.model.state_dict().items()})
    return states, metrics


@pytest.mark.parametrize('module_type', ['LSTM', 'GRU'])
def test_dp_step_equals_accumulation_and_the_jax_dp_mesh(tmp_path,
                                                          module_type):
    jcfg = JT.TransducerConfig(**SMALL, module_type=module_type)
    jo = jopt.build_optimizer('adam', lr=LRS[0], gradclip=GRADCLIP)
    mesh = jtrain.make_mesh(dp=2, devices=jax.devices()[:2])
    jstate = jtrain.make_train_state(jax.random.PRNGKey(3), jcfg, jo,
                                     mesh=mesh)
    state_dict = state_dict_from_jax_params(
        jax.tree.map(np.asarray, jstate.params))
    batches = _batches(np.random.RandomState(0))

    ranks = _dp_run(tmp_path, state_dict, batches, module_type)
    one_states, one_metrics = _one_process(state_dict, batches, module_type)
    jstep = jtrain.make_train_step(jcfg, jo, mesh=mesh, bf16=False)
    for i, lr in enumerate(LRS):
        jstate, jm = jstep(jstate, jtrain.shard_batch(
            mesh, {k: v[i] for k, v in batches.items()}),
            jax.random.PRNGKey(i), jnp.asarray(lr))
        want = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                       jstate.params))
        for r in range(2):
            got, m = ranks[r]['states'][i], ranks[r]['metrics'][i]
            assert m['skipped'] == 0.0
            np.testing.assert_allclose(m['loss'], one_metrics[i]['loss'],
                                       1e-5)
            np.testing.assert_allclose(m['grad_norm'],
                                       one_metrics[i]['grad_norm'], 1e-5)
            np.testing.assert_allclose(m['loss'], float(jm['loss']), 1e-4)
            for k, v in got.items():
                assert torch.equal(v, ranks[0]['states'][i][k]), k
                np.testing.assert_allclose(v.numpy(),
                                           one_states[i][k].numpy(), 1e-5,
                                           err_msg=k)
                np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                           1e-4, 1e-5, err_msg=k)
    assert ranks[0]['count'] == ranks[1]['count'] == 2


def test_a_nan_on_one_rank_makes_every_rank_skip(tmp_path):
    cfg = PT.TransducerConfig(**SMALL)
    state_dict = PT.Transducer(cfg, 'cpu', seed=5).state_dict()
    batches = _batches(np.random.RandomState(1))
    batches['xs'][1, 3, 2, 1] = np.nan              # step 2, rank 1's row
    ranks = _dp_run(tmp_path, state_dict, batches, 'LSTM')
    for out in ranks:
        assert [m['skipped'] for m in out['metrics']] == [0.0, 1.0]
        assert not np.isfinite(out['metrics'][1]['loss'])
        assert out['count'] == 1                    # Adam's count kept
        for k, v in out['states'][1].items():
            assert torch.equal(v, out['states'][0][k]), k
            assert torch.equal(v, ranks[0]['states'][1][k]), k


# ---------------------------------------------------------------------------
# cli.distributed
# ---------------------------------------------------------------------------

def _corpus(root, n=9, seconds=0.6, sr=16000):
    """tests/test_cli_baseline.py:_make_corpus's LibriSpeech layout."""
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


def _char_cache(corpus, logdir_root):
    from edgedict_tpu_torch.data import Librispeech
    from edgedict_tpu_torch.tokenizer import CharTokenizer
    tok = CharTokenizer(cache_dir=os.path.join(logdir_root, 'char'))
    tok.build(Librispeech(corpus, tok).texts())


def _cli_flags(extra=()):
    """cli.distributed's tiny LSTM run on _corpus, each rank in its own
    directory with a relative --logdir_root."""
    return ['--LibriSpeech_train_100', 'LIBRI',
            '--LibriSpeech_train_360', '/nonexistent',
            '--LibriSpeech_train_500', '/nonexistent',
            '--LibriSpeech_test', 'LIBRI', '--TEDLIUM_train', '/nonexistent',
            '--CommonVoice', '/nonexistent', '--YT_bloomberg2', '/nonexistent',
            '--YT_life', '/nonexistent', '--logdir_root', 'logs',
            '--name', 'dp', '--tokenizer', 'char', '--batch_size', '1',
            '--sub_batch_size', '1', '--eval_batch_size', '2',
            '--enc_hidden_size', '16', '--enc_layers', '2',
            '--enc_proj_size', '16', '--dec_hidden_size', '16',
            '--dec_layers', '1', '--dec_proj_size', '16', '--joint_size', '16',
            '--vocab_embed_size', '8', '--feature', 'logfbank',
            '--feature_size', '8', '--n_fft', '256', '--win_length', '256',
            '--hop_length', '128', '--downsample', '3',
            '--audio_bucket_frames', '8', '--warmup_step', '2',
            '--epochs', '1',
            '--loss_step', '1', '--save_step', '2', '--eval_step', '2',
            '--num_workers', '1', '--bf16=false', '--dp_size', '2',
            '--device', 'cpu', *extra]


def _cli_ranks(tmp_path, flags):
    """cli.distributed in two gloo processes, each in tmp_path/rank<r>;
    → (their stdout, their run directories)."""
    corpus = str(tmp_path / 'libri')
    _corpus(corpus)
    cwds = [str(tmp_path / f'rank{r}') for r in range(2)]
    for cwd in cwds:
        _char_cache(corpus, os.path.join(cwd, 'logs'))
    flags = [corpus if f == 'LIBRI' else f for f in flags]
    rdv = f'file://{tmp_path}/rendezvous'
    out = _run_ranks([[sys.executable, '-m',
                       'edgedict_tpu_torch.cli.distributed', *flags,
                       '--coordinator_address', rdv, '--num_processes', '2',
                       '--process_id', str(r)] for r in range(2)], cwds)
    return ([stdout for _, stdout, _ in out],
            [os.path.join(cwd, 'logs', 'dp') for cwd in cwds])


def test_cli_distributed_two_gloo_ranks_with_uneven_shards(tmp_path):
    """Each rank runs in its own directory with a relative --logdir_root,
    so what each one writes is seen apart: rank 0 holds the flag snapshot
    and the checkpoints, rank 1 nothing.  Its shard has one utterance
    fewer; both stop after the 4 steps of the shorter one."""
    logs, (run0, run1) = _cli_ranks(tmp_path, _cli_flags())
    evals = [re.findall(rf'\[rank {r}/2\] eval @ (\d+): (loss \S+ WER \S+)',
                        logs[r]) for r in range(2)]
    assert [s for s, _ in evals[0]] == ['2', '4']
    assert evals[0] == evals[1]
    assert len(re.findall(r'^step \d+/4 ', logs[0], re.M)) == 4
    assert not re.findall(r'^step ', logs[1], re.M)
    assert sorted(os.listdir(os.path.join(run0, 'models'))) == \
        ['2.ckpt', '4.ckpt']
    assert os.path.isfile(os.path.join(run0, 'flagfile.txt'))
    assert not os.path.exists(os.path.join(run1, 'models'))
    assert not os.path.exists(os.path.join(run1, 'flagfile.txt'))
    from edgedict_tpu_torch.checkpoint import load_checkpoint
    payload = load_checkpoint(os.path.join(run0, 'models', '4.ckpt'))
    assert payload['step'] == 4 and len(payload['extra']['generators']) == 2
    assert not torch.equal(*payload['extra']['generators'])


def test_cli_distributed_two_gloo_ranks_pipelined(tmp_path):
    """dp = 2 × pp = 2, as tests/test_cli_baseline.py runs the JAX CLI:
    4 encoder layers (a preamble of 2, two stages of 1), batch 2 in 2
    microbatches a rank; both ranks train the 2 steps of the shorter
    shard, log the same evaluation, and rank 0's checkpoint holds the
    one-device layout."""
    flags = _cli_flags(['--pp_size', '2'])
    for key, value in (('--enc_layers', '4'), ('--batch_size', '2')):
        flags[flags.index(key) + 1] = value
    logs, (run0, _) = _cli_ranks(tmp_path, flags)
    evals = [re.findall(rf'\[rank {r}/2\] eval @ (\d+): (loss \S+ WER \S+)',
                        logs[r]) for r in range(2)]
    assert [s for s, _ in evals[0]] == ['2'] and evals[0] == evals[1]
    losses = re.findall(r'^step \d+/2 loss (\S+)', logs[0], re.M)
    assert len(losses) == 2 and all(np.isfinite(float(x)) for x in losses)
    from edgedict_tpu_torch.checkpoint import load_checkpoint
    payload = load_checkpoint(os.path.join(run0, 'models', '2.ckpt'))
    keys = PT.Transducer(PT.TransducerConfig(
        vocab_size=5, enc_layers=4, dec_layers=1), 'cpu').state_dict()
    assert set(payload['model']) == set(keys)


def test_cli_distributed_needs_a_launcher(capsys):
    from edgedict_tpu_torch.cli import distributed
    env = {k: os.environ.pop(k) for k in ('RANK', 'WORLD_SIZE')
           if k in os.environ}
    try:
        with pytest.raises(SystemExit) as exc:
            distributed.main(['--device', 'cpu'])
    finally:
        os.environ.update(env)
    assert exc.value.code == 2
    assert 'torchrun' in capsys.readouterr().err


def test_cli_distributed_counts_a_ranks_grid_of_cards(monkeypatch, capsys):
    """Rank r takes cuda:r·tp·pp onwards: process 1 of a tp = 2 run needs
    cards 2 and 3, so with two visible it exits 2 naming the count before
    joining any group, where it once wrapped onto cuda:(1 % 2)."""
    from edgedict_tpu_torch.cli import distributed
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    monkeypatch.delenv('LOCAL_RANK', raising=False)
    with pytest.raises(SystemExit) as exc:
        distributed.init_process_group([
            '--coordinator_address', 'file:///nonexistent/rdv',
            '--num_processes', '2', '--process_id', '1', '--tp_size', '2'])
    assert exc.value.code == 2
    err = ' '.join(capsys.readouterr().err.split())
    assert 'cuda:2..cuda:3' in err and 'but 2 are visible' in err
