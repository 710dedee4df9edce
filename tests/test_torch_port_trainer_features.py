"""The trainer's one-card features in the port, on the CPU (counterparts of
tests/test_checkpoint_async.py and tests/test_device_corpus.py):

  * background checkpoint writes: equal to a synchronous write, isolated
    from a later in-place update, a failed write re-raised, same-step
    saves that do not race, pruning beside an in-flight write;
  * --device_corpus: the same two steps, bit for bit, as the host loader
    on a uniform corpus, the host loader's index order (and the JAX
    package's) over two epochs, and train → resume replaying the losses;
  * the one-ahead prefetcher hands over device_batch's batches in order,
    after the resume's skip;
  * --profile_dir writes a chrome trace of steps 11-13 and leaves no
    profiler running;
  * tensorboard: the same (tag, step) sequence as the JAX Trainer, and no
    writer (and no error) without tensorboardX;
  * the plain RNN-T loss against native/librnnt_loss.so (tolerances of
    tests/test_native.py:39-45).
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from edgedict_tpu_torch import checkpoint as C
from edgedict_tpu_torch.cli import baseline
from edgedict_tpu_torch.config import parse_flags
from edgedict_tpu_torch.train import device_batch, prefetch_batches
from edgedict_tpu_torch.trainer import IndexBatches, Trainer

from test_torch_port_train import _cli_args, _write_corpus


def _sd():
    return {'w': torch.arange(12.0).reshape(3, 4), 'b': torch.ones(4)}


def _drain_writer():
    """Block until the background writer has finished every queued write
    (its error, if one failed, is then recorded; nothing is raised)."""
    if C._WRITER is not None:
        C._WRITER._q.join()


@pytest.fixture(autouse=True)
def _fresh_writer():
    """After each test: drain the writer and drop an error it left, so a
    failed test's write cannot fail the next test's first submit."""
    yield
    _drain_writer()
    if C._WRITER is not None:
        C._WRITER._error = None


# ---------------------------------------------------------------------------
# background checkpoint writes
# ---------------------------------------------------------------------------

def test_background_save_matches_sync(tmp_path):
    sd = _sd()
    opt = {'count': torch.tensor(3, dtype=torch.int32),
           'mu': {k: v * 2 for k, v in sd.items()}}
    p_sync = C.save_checkpoint(str(tmp_path / 'a'), 3, sd, opt,
                               {'scale': 0.5}, {'best_wer': 0.25})
    p_bg = C.save_checkpoint(str(tmp_path / 'b'), 3, sd, opt,
                             {'scale': 0.5}, {'best_wer': 0.25},
                             background=True)
    C.wait_for_checkpoints()
    a, b = C.load_checkpoint(p_sync), C.load_checkpoint(p_bg)
    assert a['step'] == b['step'] == 3 and a['sched'] == b['sched']
    assert a['extra'] == b['extra'] == {'best_wer': 0.25}
    for k in sd:
        assert torch.equal(a['model'][k], b['model'][k])
        assert torch.equal(b['model'][k], sd[k])
        assert torch.equal(a['optim']['mu'][k], b['optim']['mu'][k])
    assert int(b['optim']['count']) == 3


def test_background_save_snapshot_isolated_from_later_update(tmp_path):
    """The snapshot is taken at submit time: the train step's in-place
    update of CPU params afterwards does not reach the file."""
    sd = {'w': torch.zeros(64, 64)}
    opt = {'mu': {'w': torch.zeros(64, 64)}}
    path = C.save_checkpoint(str(tmp_path), 1, sd, opt, background=True)
    with torch.no_grad():
        sd['w'].add_(7.0)                  # the next step, in place
        opt['mu']['w'].add_(3.0)
    C.wait_for_checkpoints()
    payload = C.load_checkpoint(path)
    assert float(payload['model']['w'].abs().max()) == 0.0
    assert float(payload['optim']['mu']['w'].abs().max()) == 0.0


def test_background_write_error_propagates(tmp_path, monkeypatch):
    real = C._write_payload

    def boom(payload, path):
        if os.sep + 'x' + os.sep in path:
            raise OSError('disk on fire')
        return real(payload, path)

    monkeypatch.setattr(C, '_write_payload', boom)
    C.save_checkpoint(str(tmp_path / 'x'), 1, _sd(), background=True)
    with pytest.raises(RuntimeError, match='background checkpoint'):
        C.wait_for_checkpoints()
    # a failed write also surfaces at the next submit, once the writer has
    # recorded it (the submit itself does not wait for earlier writes)
    C.save_checkpoint(str(tmp_path / 'x'), 2, _sd(), background=True)
    _drain_writer()
    with pytest.raises(RuntimeError, match='background checkpoint'):
        C.save_checkpoint(str(tmp_path / 'y'), 3, _sd(), background=True)
    C.wait_for_checkpoints()
    # the writer recovers after surfacing the error
    p = C.save_checkpoint(str(tmp_path / 'y'), 4, _sd(), background=True)
    C.wait_for_checkpoints()
    assert os.path.exists(p)


def test_concurrent_same_step_saves_do_not_race(tmp_path):
    """A background and a synchronous save of one step (periodic save +
    end-of-training save) both land: each write has its own tmp name."""
    sd = _sd()
    for _ in range(20):
        C.save_checkpoint(str(tmp_path), 7, sd, background=True)
        p = C.save_checkpoint(str(tmp_path), 7, sd)
        assert os.path.exists(p)
    C.wait_for_checkpoints()
    assert C.load_checkpoint(p)['step'] == 7
    assert os.listdir(os.path.join(str(tmp_path), 'models')) == ['7.ckpt']


def test_prune_beside_an_in_flight_write(tmp_path, monkeypatch):
    """Pruning while the newest step is still being written removes only
    older steps; the in-flight write then lands."""
    import threading
    for step in (1, 2, 3):
        C.save_checkpoint(str(tmp_path), step, _sd())
    gate = threading.Event()
    real = C._write_payload

    def slow(payload, path):
        gate.wait(10)
        return real(payload, path)

    monkeypatch.setattr(C, '_write_payload', slow)
    p4 = C.save_checkpoint(str(tmp_path), 4, _sd(), background=True)
    assert C.prune_checkpoints(str(tmp_path), 2) == [1]
    gate.set()
    C.wait_for_checkpoints()
    assert os.path.exists(p4) and C.latest_step(str(tmp_path)) == 4
    assert C.prune_checkpoints(str(tmp_path), 2) == [2]
    left = sorted(os.listdir(os.path.join(str(tmp_path), 'models')))
    assert left == ['3.ckpt', '4.ckpt']


# ---------------------------------------------------------------------------
# --device_corpus, the prefetcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    return _write_corpus(str(tmp_path_factory.mktemp('dc') / 'libri'))


def _trainer(corpus, logs, name, *extra):
    args = _cli_args(corpus, logs, name) + list(extra)
    return Trainer(parse_flags(baseline.build_parser(), args))


def _two_steps(trainer):
    losses, it = [], iter(trainer.loader)
    for _ in range(2):
        losses.append(float(trainer.run_step(next(it))['loss']))
    return losses, trainer.state.model.state_dict()


def test_device_corpus_matches_host_loader(corpus, tmp_path):
    """Uniform utterances and labels: the gathered batches equal the host
    loader's, so the two runs are bit-identical."""
    logs = str(tmp_path / 'logs')
    host_losses, host_sd = _two_steps(_trainer(corpus, logs, 'host'))
    dc = _trainer(corpus, logs, 'dc', '--device_corpus')
    assert isinstance(dc.loader, IndexBatches)
    assert dc.device_corpus['audio'].shape[0] == len(dc.train_dataset)
    dc_losses, dc_sd = _two_steps(dc)
    assert host_losses == dc_losses
    for k, v in host_sd.items():
        assert torch.equal(v, dc_sd[k]), k


def test_device_corpus_gathers_the_host_batches(corpus, tmp_path):
    logs = str(tmp_path / 'logs')
    host = _trainer(corpus, logs, 'host')
    dc = _trainer(corpus, logs, 'dc', '--device_corpus')
    for hb, ib in zip(host.loader, dc.loader):
        want = device_batch(hb, host.accum_steps, 'cpu')
        got = dc.gather(ib['idx'])
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_device_corpus_index_order_replays_the_loader(corpus, tmp_path):
    tr = _trainer(corpus, str(tmp_path / 'logs'), 'dc', '--device_corpus')
    from edgedict_tpu_torch.data import DataLoader
    a = DataLoader(tr.train_dataset, 4, shuffle=True, drop_last=True)
    b = IndexBatches(DataLoader(tr.train_dataset, 4, shuffle=True,
                                drop_last=True))
    for _ in range(2):                       # two epochs: the same order
        order_a = [list(i) for i in a._batches_indices()]
        a.epoch += 1
        assert order_a == [list(batch['idx']) for batch in b]
    assert a.epoch == b.epoch == 2 and len(b) == len(a)


def test_device_corpus_index_order_equals_the_jax_package(corpus):
    """The same dataset and seed give the JAX package's _IndexBatches
    order, epoch by epoch."""
    from edgedict_tpu.data import DataLoader as JLoader
    from edgedict_tpu.data import Librispeech as JLibri
    from edgedict_tpu.tokenizer import CharTokenizer as JChar
    from edgedict_tpu.trainer import _IndexBatches
    from edgedict_tpu_torch.data import DataLoader, Librispeech
    from edgedict_tpu_torch.tokenizer import CharTokenizer
    cache = os.path.join(os.path.dirname(corpus), 'chartok')
    jt, pt = JChar(cache_dir=cache), CharTokenizer(cache_dir=cache)
    for tok in (jt, pt):
        tok.build(['hello world'])
    j = _IndexBatches(JLoader(JLibri(corpus, jt), 2, shuffle=True,
                              drop_last=True))
    p = IndexBatches(DataLoader(Librispeech(corpus, pt), 2, shuffle=True,
                                drop_last=True))
    for _ in range(3):
        assert [list(b['idx']) for b in j] == [list(b['idx']) for b in p]


def test_device_corpus_train_resume_replays_losses(corpus, tmp_path):
    """cli.baseline --device_corpus: train 6 steps, then resume from step 3
    in the same run: steps 4-6 replay the same losses and end on the same
    params, bit for bit."""
    logs = str(tmp_path / 'logs')
    args = _cli_args(corpus, logs, 'run') + ['--device_corpus']
    lines_a = []
    a = baseline.main(args + ['--mode', 'train'], log_fn=lines_a.append)
    assert a.state.step == 6 and isinstance(a.loader, IndexBatches)
    final_a = C.load_checkpoint(C.checkpoint_path(a.logdir, 6))['model']
    os.remove(C.checkpoint_path(a.logdir, 6))
    lines_b = []
    b = baseline.main(args + ['--mode', 'resume', '--resume_step', '3'],
                      log_fn=lines_b.append)
    strip = lambda ln: ln.rsplit(' (', 1)[0]  # noqa: E731  (drop the clock)
    steps_a = [strip(x) for x in lines_a if x.startswith('step ')]
    steps_b = [strip(x) for x in lines_b if x.startswith('step ')]
    assert steps_b == steps_a[3:]
    for k, v in b.state.model.state_dict().items():
        assert torch.equal(v, final_a[k]), k


def test_device_corpus_prints_its_size(corpus, tmp_path, capsys):
    _trainer(corpus, str(tmp_path / 'logs'), 'dc', '--device_corpus')
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith('device_corpus:')]
    assert line and line[0].startswith('device_corpus: 8 utts padded to L=')
    assert line[0].endswith('GB audio on device)')


def test_device_rate_takes_the_index_path(corpus, tmp_path):
    tr = _trainer(corpus, str(tmp_path / 'logs'), 'dc', '--device_corpus')
    lines = []
    step_ms, rate = baseline.device_rate(tr, steps=2, log_fn=lines.append)
    assert step_ms > 0 and rate > 0 and lines[0].startswith('device_rate:')


@pytest.mark.parametrize('skip', [0, 1])
def test_prefetcher_hands_over_device_batch_in_order(corpus, tmp_path, skip):
    tr = _trainer(corpus, str(tmp_path / 'logs'), 'pf')
    tr.loader.epoch = 0
    want = [device_batch(b, tr.accum_steps, 'cpu') for b in tr.loader][skip:]
    tr.loader.epoch = 0
    tr._skip_batches = skip
    got = list(tr.device_batches(tr._loader_batches()))
    assert len(got) == len(want) == 2 - skip
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert torch.equal(g[k], w[k]) and g[k].shape[0] == 2, k
    host = [{'x': np.arange(8).reshape(4, 2) + i} for i in range(3)]
    out = list(prefetch_batches(iter(host), 2, 'cpu'))
    assert [o['x'].shape for o in out] == [(2, 2, 2)] * 3
    assert all(torch.equal(o['x'].reshape(4, 2), torch.as_tensor(h['x']))
               for o, h in zip(out, host))


def test_loader_pins_batches_when_asked(corpus, tmp_path):
    tr = _trainer(corpus, str(tmp_path / 'logs'), 'pin')
    assert tr.loader.pin_memory is False          # a CPU trainer
    tr.loader.pin_memory = True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):         # no card to pin for
            next(iter(tr.loader))
        return
    batch = next(iter(tr.loader))
    assert all(v.is_pinned() for v in batch.values())


# ---------------------------------------------------------------------------
# --profile_dir
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('epochs,steps', [(7, 14), (6, 12)])
def test_profile_dir_writes_a_trace(corpus, tmp_path, epochs, steps):
    """Steps 11-13 traced (the window cut by the run's end at 12 steps is
    closed all the same); no profiler is left running."""
    import torch.autograd.profiler as autograd_profiler
    prof_dir = str(tmp_path / 'prof')
    args = _cli_args(corpus, str(tmp_path / 'logs'), 'prof')
    args[args.index('--epochs') + 1] = str(epochs)
    args[args.index('--save_step') + 1] = '100'
    trainer = baseline.main(args + ['--profile_dir', prof_dir],
                            log_fn=lambda *_: 0)
    assert trainer.state.step == steps
    assert not autograd_profiler._is_profiler_enabled
    assert os.listdir(prof_dir) == ['trace_steps_11-13.json']
    with open(os.path.join(prof_dir, 'trace_steps_11-13.json')) as f:
        trace = json.load(f)
    assert trace['traceEvents']


# ---------------------------------------------------------------------------
# tensorboard
# ---------------------------------------------------------------------------

def _fake_tensorboard(calls):
    class SummaryWriter:
        def __init__(self, logdir):
            self.logdir = logdir

        def add_scalar(self, tag, value, step):
            calls.append((tag, int(step)))
            assert np.isfinite(float(value))

        def add_text(self, tag, text, step):
            calls.append((tag, int(step)))
            assert text.startswith('REF: ')

    return types.SimpleNamespace(SummaryWriter=SummaryWriter)


TB_FLAGS = dict(loss_step=1, eval_step=2, epochs=2, save_step=100,
                sample_size=2)


@pytest.fixture()
def jax_flags():
    """The JAX package's absl FLAGS, restored after the test."""
    from edgedict_tpu.config import FLAGS, ensure_parsed
    ensure_parsed()
    saved = {k: getattr(FLAGS, k) for k in FLAGS}
    yield FLAGS
    for k, v in saved.items():
        if getattr(FLAGS, k) != v:
            setattr(FLAGS, k, v)


def _jax_tb_run(jflags, corpus, logs):
    import jax  # noqa: F401
    from edgedict_tpu.trainer import Trainer as JTrainer
    args = _cli_args(corpus, logs, 'jax')
    pairs = dict(zip(args[::2], args[1::2]))     # '--nobf16' ends it
    for key, value in pairs.items():
        name = key[2:]
        if name == 'device':
            continue
        cur = getattr(jflags, name)
        if isinstance(cur, bool):
            value = value == 'true'
        elif name == 'gradclip':
            value = float(value)
        elif cur is not None and not isinstance(cur, str):
            value = type(cur)(value)
        setattr(jflags, name, value)
    for name in ('device_corpus',):
        setattr(jflags, name, False)
    jflags.bf16 = False
    jflags.dp_size, jflags.tp_size = 1, 1
    for k, v in TB_FLAGS.items():
        setattr(jflags, k, v)
    trainer = JTrainer(jflags)
    trainer.train(log_fn=lambda *_: 0)


def test_tensorboard_tags_match_the_jax_trainer(corpus, tmp_path,
                                                monkeypatch, jax_flags):
    jax_calls, port_calls = [], []
    monkeypatch.setitem(sys.modules, 'tensorboardX',
                        _fake_tensorboard(jax_calls))
    _jax_tb_run(jax_flags, corpus, str(tmp_path / 'jax_logs'))
    monkeypatch.setitem(sys.modules, 'tensorboardX',
                        _fake_tensorboard(port_calls))
    args = _cli_args(corpus, str(tmp_path / 'logs'), 'port')
    for k, v in TB_FLAGS.items():         # the last spelling wins
        args += [f'--{k}', str(v)]
    trainer = baseline.main(args + ['--mode', 'train'], log_fn=lambda *_: 0)
    assert trainer.writer is not None and trainer.state.step == 4
    assert port_calls == jax_calls
    assert port_calls[:2] == [('train_loss', 1), ('lr', 1)]
    assert ('samples', 2) in port_calls and ('WER', 4) in port_calls


def test_no_tensorboard_no_writer(corpus, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'tensorboardX', None)
    args = _cli_args(corpus, str(tmp_path / 'logs'), 'plain')
    args += ['--eval_step', '2', '--epochs', '1']
    trainer = baseline.main(args + ['--mode', 'train'], log_fn=lambda *_: 0)
    assert trainer.writer is None and trainer.state.step == 2


# ---------------------------------------------------------------------------
# the plain loss against the native one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('which', ['rnnt_loss', 'rnnt_loss_reference'])
def test_plain_loss_matches_native_rnnt_loss(which):
    from edgedict_tpu_torch import _native
    from edgedict_tpu_torch.ops import rnnt_loss as L
    if not _native.available()['rnnt_loss']:
        pytest.skip('native/librnnt_loss.so is not built')
    rng = np.random.RandomState(0)
    b, t, u, v = 3, 6, 4, 8
    logits = rng.randn(b, t, u + 1, v).astype(np.float32)
    labels = rng.randint(1, v, (b, u)).astype(np.int32)
    xlen = np.asarray([t, t - 1, t - 2], np.int32)
    ylen = np.asarray([u, u - 1, u - 2], np.int32)
    loss_cpp, grad_cpp = _native.rnnt_loss_cpu(logits, labels, xlen, ylen)
    lg = torch.from_numpy(logits).requires_grad_()
    loss = getattr(L, which)(lg, torch.from_numpy(labels),
                             torch.from_numpy(xlen), torch.from_numpy(ylen))
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), loss_cpp, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(lg.grad.numpy(), grad_cpp, rtol=1e-3,
                               atol=1e-4)
