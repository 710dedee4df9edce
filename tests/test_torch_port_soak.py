"""The port's training soak (edgedict_tpu_torch/scripts/soak_train.py)
against the JAX script (scripts/soak_train.py), on the CPU:

  * make_corpus writes the JAX script's WAV bytes and transcripts, at two
    seeds;
  * flags_for gives the JAX script's flags, full width and --tiny, in
    every mode, apart from the port's trailing --device;
  * parse_log reads the port trainer's real step lines (cli.baseline's
    log), as the JAX script's parse_log does;
  * a --tiny soak runs end to end: a real SIGKILL of a live child, two
    resumed legs whose final checkpoints are byte-identical, a final leg
    to --steps, the device-rate probe, and the JAX report's keys;
  * a double resume whose legs differ names the entry that differs, with
    its largest absolute difference;
  * a child that exits by itself past the kill point fails the soak, and
    without a card the soak refuses before any work.
"""

import ast
import hashlib
import os
import signal
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from edgedict_tpu_torch import checkpoint as C
from edgedict_tpu_torch.scripts import soak_train as P
from scripts import soak_train as J

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny soak: 2 steps an epoch, the kill at step 18 (seen at 20),
# checkpoints every 10 steps, resume legs of 10 steps
TINY = ['--tiny', '--utts', '8', '--batch', '4', '--utt_seconds', '4',
        '--steps', '40', '--save_step', '10', '--eval_step', '40',
        '--resume_probe_steps', '10', '--poll', '0.1']


def _sha(path):
    with open(path, 'rb') as f:
        return hashlib.sha256(f.read()).hexdigest()


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), 'rb') as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize('seed', [0, 3])
def test_corpus_is_the_jax_scripts_byte_for_byte(tmp_path, seed):
    P.make_corpus(str(tmp_path / 'p'), 3, 4.0, seed=seed)
    J.make_corpus(str(tmp_path / 'j'), 3, 4.0, seed=seed)
    p, j = _files(tmp_path / 'p'), _files(tmp_path / 'j')
    assert sorted(p) == sorted(j) == sorted(
        [os.path.join('1', '1', f'1-1-{i:04d}.wav') for i in range(3)]
        + [os.path.join('1', '1', '1-1.trans.txt')])
    assert p == j
    text = p[os.path.join('1', '1', '1-1.trans.txt')].decode()
    assert all(len(ln.split()) > 1 for ln in text.splitlines())


def _args(argv):
    return P.build_parser().parse_args(argv)


@pytest.mark.parametrize('mode', ['train', 'resume', 'device_rate'])
@pytest.mark.parametrize('argv', [
    [], ['--tiny'], ['--device_corpus', '--no_cache_audio'],
    ['--tiny', '--batch', '4', '--utt_seconds', '4', '--save_step', '10',
     '--eval_step', '40']])
def test_flags_are_the_jax_scripts(argv, mode):
    args = _args(argv)
    got = P.flags_for(args, '/c', '/l', 7, mode=mode, extra=('--x', '1'))
    want = J.flags_for(args, '/c', '/l', 7, mode=mode, extra=('--x', '1'))
    assert got[:-2] == want
    assert got[-2:] == ['--device', 'cpu' if args.tiny else 'cuda']
    assert P.flags_for(_args(argv + ['--device', 'cpu']), '/c', '/l',
                       7)[-1] == 'cpu'


def test_flags_parse_in_the_ports_trainer_cli():
    from edgedict_tpu_torch.cli import baseline
    from edgedict_tpu_torch.config import parse_flags
    flags = parse_flags(baseline.build_parser(), P.flags_for(
        _args(['--device_corpus']), '/c', '/l', 3, mode='resume'))
    assert (flags.enc_hidden_size, flags.enc_layers, flags.enc_proj_size,
            flags.dec_hidden_size, flags.dec_layers, flags.joint_size,
            flags.feature_size, flags.n_fft, flags.hop_length) == \
        (1024, 6, 640, 256, 2, 640, 80, 400, 200)
    assert flags.mode == 'resume' and flags.device == 'cuda'
    assert flags.device_corpus and flags.cache_audio


def test_parse_log_reads_the_trainers_step_lines(tmp_path):
    from edgedict_tpu_torch.cli import baseline
    from test_torch_port_train import _cli_args, _write_corpus
    corpus = _write_corpus(str(tmp_path / 'libri'))
    log = tmp_path / 'train.log'
    lines = []
    argv = _cli_args(corpus, str(tmp_path / 'logs'), 'run')
    argv[argv.index('--epochs') + 1] = '2'
    trainer = baseline.main(argv, log_fn=lines.append)
    log.write_text('\n'.join(lines) + '\n')
    steps = P.parse_log(str(log))
    assert [s for s, _, _ in steps] == [1, 2, 3, 4] == \
        [s for s, _, _ in J.parse_log(str(log))]
    assert steps == J.parse_log(str(log))
    assert all(np.isfinite(loss) and t >= 0 for _, loss, t in steps)
    assert trainer.state.step == 4
    third = next(i for i, ln in enumerate(lines)
                 if ln.startswith('step 3/'))
    offset = len(('\n'.join(lines[:third]) + '\n').encode())
    assert P.parse_log(str(log), offset=offset) == steps[2:]


def _report_keys():
    """The keys of the JAX script's report dict (its main's `result`)."""
    with open(os.path.join(REPO, 'scripts', 'soak_train.py')) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], 'id', None) == 'result' \
                and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys}
    raise AssertionError('no result dict in scripts/soak_train.py')


def test_tiny_soak_end_to_end(tmp_path, monkeypatch):
    # one intra-op thread in the children: the CPU's BLAS sums a product
    # in an order that depends on its thread count, and at two threads 3
    # of ~50 tiny soaks parted (ROADMAP, Open items); the card's legs are
    # held by the smoke's soak phase
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    monkeypatch.setenv('MKL_NUM_THREADS', '1')
    procs, real_launch = [], P.launch

    def launch(flags, log_path, env):
        procs.append(real_launch(flags, log_path, env)[0])
        return procs[-1], open(os.devnull, 'w')

    monkeypatch.setattr(P, 'launch', launch)
    work = tmp_path / 'work'
    lines = []
    result = P.run(_args(TINY + ['--work', str(work)]), log_fn=lines.append)
    # the kill hit a live child; every other leg exited 0
    assert [p.returncode for p in procs] == [-signal.SIGKILL, 0, 0, 0, 0]
    assert result['killed_at_step'] >= 18
    assert result['resumed_from'] in result['checkpoints']
    assert result['resumed_from'] <= result['killed_at_step']
    assert result['double_resume_bit_identical'] is True
    assert _sha(work / 'probe_A.ckpt') == _sha(work / 'probe_B.ckpt')
    legs = [C.load_checkpoint(str(work / f'probe_{x}.ckpt'))
            for x in 'AB']
    assert legs[0]['step'] == legs[1]['step'] == \
        result['resumed_from'] + 10
    assert result['steps'] == 40
    assert os.path.exists(work / 'logs' / 'soak' / 'models' / '40.ckpt')
    assert set(result) == _report_keys()
    assert result['device_step_ms'] > 0 and result['nan_skipped_loss_lines'] \
        == 0
    for log in ('train.log', 'probe_A.log', 'probe_B.log',
                'device_rate.log'):
        assert 'device: cpu' in (work / log).read_text()
    assert (work / 'soak_report.json').exists()
    assert any('BYTE-IDENTICAL' in ln for ln in lines)


class _FakeProc:
    def __init__(self, rc=0):
        self.returncode = rc

    def wait(self, timeout=None):
        return self.returncode

    def poll(self):
        return self.returncode


def test_resume_legs_that_differ_name_the_entry(tmp_path, monkeypatch):
    """The mismatch report of _double_resume: leg B's checkpoint has one
    tensor perturbed, and the error names that key and its difference."""
    logdir = tmp_path / 'logs' / 'soak'
    g = torch.Generator().manual_seed(0)
    model = {'encoder.w': torch.randn(4, 3, generator=g),
             'joint.b': torch.arange(5.0)}
    C.save_checkpoint(str(logdir), 6, model)
    legs = []

    def launch(flags, log_path, env):
        leg = dict(model)
        if legs:                         # leg B
            leg['joint.b'] = leg['joint.b'].clone()
            leg['joint.b'][3] += 0.25
        legs.append(log_path)
        C.save_checkpoint(str(logdir), 9, leg,
                          extra={'generator': torch.zeros(3,
                                                          dtype=torch.uint8)})
        return _FakeProc(), open(os.devnull, 'w')

    monkeypatch.setattr(P, 'launch', launch)
    args = _args(['--tiny', '--resume_probe_steps', '3'])
    with pytest.raises(P.SoakError, match='NOT bit-deterministic') as e:
        P._double_resume(args, 'c', str(tmp_path / 'logs'), str(logdir),
                         str(tmp_path), {}, 6, 3, print)
    assert len(legs) == 2
    assert "('/model/joint.b', 0.25)" in str(e.value)
    assert 'encoder.w' not in str(e.value)
    diff = P.checkpoint_diff(str(tmp_path / 'probe_A.ckpt'),
                             str(tmp_path / 'probe_B.ckpt'))
    assert diff == [('/model/joint.b', 0.25)]


def test_checkpoint_diff_lists_every_kind_of_difference(tmp_path):
    a = {'w': torch.zeros(3), 'n': torch.zeros(2, dtype=torch.int64),
         'gen': torch.zeros(4, dtype=torch.uint8)}
    b = {'w': torch.zeros(4), 'n': torch.tensor([0, 5]),
         'gen': torch.tensor([0, 0, 7, 0], dtype=torch.uint8)}
    pa = C.save_checkpoint(str(tmp_path / 'a'), 1, a, extra={'best_wer': 1})
    pb = C.save_checkpoint(str(tmp_path / 'b'), 1, b, extra={'best_wer': 2})
    diff = dict(P.checkpoint_diff(pa, pb))
    assert diff['/model/n'] == 5.0 and diff['/model/gen'] == 7.0
    assert '(3,)' in diff['/model/w'] and '(4,)' in diff['/model/w']
    assert diff['/extra/best_wer'] == '1 against 2'
    assert P.checkpoint_diff(pa, pa) == []


_EXITS_PAST_THE_KILL_POINT = (
    "print('step 10/40 loss 3.0 lr 1.00e-04 (0.5s)', flush=True)\n"
    "print('step 20/40 loss 2.0 lr 1.00e-04 (1.0s)', flush=True)\n")


def test_a_child_that_exits_before_the_kill_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(P, 'child_command', lambda: [
        sys.executable, '-c', _EXITS_PAST_THE_KILL_POINT])
    args = _args(TINY[:-1] + ['2.0', '--work', str(tmp_path / 'w')])
    with pytest.raises(P.SoakError, match='did not hit a live trainer'):
        P.run(args, log_fn=lambda *_: None)
    assert 'step 20/40' in (tmp_path / 'w' / 'train.log').read_text()


def test_without_a_card_the_soak_refuses_before_any_work(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is visible')
    work = tmp_path / 'w'
    with pytest.raises(RuntimeError, match='cuda'):
        P.run(_args(['--work', str(work)]))
    assert not work.exists()
    assert P.main(['--tiny', '--utts', '2', '--batch', '4', '--work',
                   str(work)]) == 1                  # no step: a SoakError


def test_report_windows_are_the_jax_scripts(tmp_path):
    """report()'s loss windows and rates on a log the JAX formula reads
    the same way."""
    log = tmp_path / 'train.log'
    rows = [(s, 100.0 / s, 0.02 * s) for s in range(10, 210, 10)]
    log.write_text(''.join(f'step {s}/200 loss {l:.4f} lr 1.00e-04 '
                           f'({t:.1f}s)\n' for s, l, t in rows))
    args = SimpleNamespace(batch=4, utt_seconds=4.0, no_cache_audio=False,
                           device_corpus=False)
    r = P.report(args, str(log), 0, 90, 80, [40, 80], 150.0, 26.7)
    losses = np.array([round(l, 4) for _, l, _ in rows])
    assert r['loss_first'] == round(float(losses[:2].mean()), 3)
    assert r['loss_mid'] == round(float(losses[10:12].mean()), 3)
    assert r['loss_final'] == round(float(losses[-2:].mean()), 3)
    assert r['sustained_step_ms'] == 20.0 and r['steps'] == 200
    assert r['loader_efficiency'] == 1.0 and r['monotone_improving']
