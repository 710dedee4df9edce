"""The port's checkpoint files depend only on the state they hold
(edgedict_tpu_torch/checkpoint.py), on the CPU:

  * two saves of the same payload, from different threads (the background
    writer and a synchronous save), from another process, and into
    different run directories, write files with equal sha256s, whose
    archive folder is 'archive/' (torch.save to a path would name it after
    the file: the pid and thread id of the tmp name);
  * a checkpoint written the earlier way (torch.save straight to the tmp
    path, then renamed) still loads, through load_checkpoint and
    Trainer.load's sniffing;
  * is_jax_checkpoint still tells the JAX package's msgpack files from
    the port's zip files, old and new;
  * the JAX package's own checkpoint files have the same property
    (scripts/soak_train.py's byte-identity check relies on it).
"""

import hashlib
import os
import shutil
import subprocess
import sys
import threading
import zipfile

import numpy as np
import torch

from edgedict_tpu_torch import checkpoint as C
from edgedict_tpu_torch.jax_checkpoint import is_jax_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, 'tests', 'data', 'jax_ckpt', 'run', 'models',
                       '2.ckpt')


def _sha(path):
    with open(path, 'rb') as f:
        return hashlib.sha256(f.read()).hexdigest()


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    model = {'enc.w': torch.randn(8, 6, generator=g),
             'enc.b': torch.randn(6, generator=g).to(torch.bfloat16),
             'embed': torch.randn(5, 4, generator=g)}
    optim = {'count': torch.tensor(7, dtype=torch.int32),
             'mu': {k: v.float() * 0.5 for k, v in model.items()}}
    extra = {'generator': torch.Generator().manual_seed(1234).get_state(),
             'best_wer': 0.25}
    return model, optim, {'scale': 0.5, 'bad': 1}, extra


def _save(logdir, background=False):
    path = C.save_checkpoint(logdir, 12, *_state(), background=background)
    C.wait_for_checkpoints()
    return path


_CHILD = '''
import sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
from test_torch_port_checkpoint_bytes import _save
print(_save(sys.argv[1]))
'''


def test_same_state_same_bytes_across_threads_and_processes(tmp_path):
    main = _save(str(tmp_path / 'main'))
    background = _save(str(tmp_path / 'bg'), background=True)
    other = {}
    t = threading.Thread(target=lambda: other.update(
        path=_save(str(tmp_path / 'thread'))))
    t.start()
    t.join()
    child = subprocess.run(
        [sys.executable, '-c', _CHILD.format(
            repo=REPO, tests=os.path.join(REPO, 'tests')),
         str(tmp_path / 'child')],
        capture_output=True, text=True, timeout=120)
    assert child.returncode == 0, child.stderr
    paths = [main, background, other['path'], child.stdout.strip()]
    assert len(set(paths)) == 4
    assert len({_sha(p) for p in paths}) == 1
    with zipfile.ZipFile(main) as z:
        assert {n.split('/')[0] for n in z.namelist()} == {'archive'}


def test_a_changed_tensor_changes_the_bytes(tmp_path):
    a = _save(str(tmp_path / 'a'))
    model, optim, sched, extra = _state()
    model['embed'][2, 1] += 1e-6
    b = C.save_checkpoint(str(tmp_path / 'b'), 12, model, optim, sched,
                          extra)
    assert _sha(a) != _sha(b)


def _write_the_earlier_way(logdir, step, *state):
    """The writer before file handles: torch.save to the tmp path (its
    archive folder named after the tmp file), then the rename."""
    path = C.checkpoint_path(logdir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    model, optim, sched, extra = state
    payload = {'step': step, 'model': model, 'optim': optim, 'sched': sched,
               'extra': extra}
    tmp = f'{path}.tmp.{os.getpid()}.{threading.get_ident()}.1'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def test_a_checkpoint_written_the_earlier_way_loads(tmp_path):
    state = _state()
    old = _write_the_earlier_way(str(tmp_path / 'old'), 12, *state)
    new = _save(str(tmp_path / 'new'))
    with zipfile.ZipFile(old) as z:
        assert z.namelist()[0].startswith('12.ckpt.tmp.')
    assert _sha(old) != _sha(new)
    a, b = C.load_checkpoint(old), C.load_checkpoint(new)
    assert a['step'] == b['step'] == 12 and a['sched'] == b['sched']
    assert a['extra']['best_wer'] == b['extra']['best_wer']
    assert torch.equal(a['extra']['generator'], b['extra']['generator'])
    for k in state[0]:
        assert torch.equal(a['model'][k], b['model'][k])
        assert torch.equal(a['optim']['mu'][k], b['optim']['mu'][k])
    assert not is_jax_checkpoint(old)


def test_trainer_resumes_from_a_checkpoint_written_the_earlier_way(tmp_path):
    """Trainer.load of a run's checkpoint rewritten the earlier way
    restores what the file as written restores: the model, the optimizer
    state, the step, the generator and the best WER."""
    from edgedict_tpu_torch.cli import baseline
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.trainer import Trainer
    from test_torch_port_train import _cli_args, _write_corpus
    corpus = _write_corpus(str(tmp_path / 'libri'))
    logs = str(tmp_path / 'logs')

    def trainer(name):
        return Trainer(parse_flags(baseline.build_parser(),
                                   _cli_args(corpus, logs, name)))

    run = trainer('run')
    run.run_step(next(iter(run.loader)))
    run._best_wer = 0.5
    payload = C.load_checkpoint(run.save())
    _write_the_earlier_way(os.path.join(logs, 'old'), 1, *(
        payload[k] for k in ('model', 'optim', 'sched', 'extra')))
    shutil.copytree(os.path.join(logs, 'run', 'models'),
                    os.path.join(logs, 'new', 'models'))
    old, new = trainer('old'), trainer('new')
    assert old.load(log_fn=print) == new.load(log_fn=print) == 1
    assert old.state.step == new.state.step == 1
    assert old._best_wer == new._best_wer == 0.5
    assert torch.equal(old.generator.get_state(), new.generator.get_state())
    for (k, a), b in zip(old.state.model.state_dict().items(),
                         new.state.model.state_dict().values()):
        assert torch.equal(a, b), k
    flat = [(torch.utils._pytree.tree_leaves(t.state.opt_state))
            for t in (old, new)]
    assert len(flat[0]) == len(flat[1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(*flat))


def test_is_jax_checkpoint_tells_the_formats_apart(tmp_path):
    old = _write_the_earlier_way(str(tmp_path / 'old'), 3, *_state())
    new = _save(str(tmp_path / 'new'))
    with open(new, 'rb') as f:
        assert f.read(2) == b'PK'
    assert not is_jax_checkpoint(old) and not is_jax_checkpoint(new)
    assert is_jax_checkpoint(FIXTURE)


def test_jax_package_checkpoints_are_byte_reproducible(tmp_path):
    from edgedict_tpu import checkpoint as JC
    params = {'w': np.arange(12, dtype=np.float32).reshape(3, 4)}
    paths = [JC.save_checkpoint(str(tmp_path / d), 5, params)
             for d in ('a', 'b')]
    assert _sha(paths[0]) == _sha(paths[1])
