"""Checkpoint save/resume (counterpart of edgedict_tpu/checkpoint.py).

Layout: logs/<name>/models/<step>.ckpt, written with torch.save and loaded
with torch.load(weights_only=True), holding

    {'step': int, 'model': state_dict (the reference key layout, so
     cli/stream.py --pt_path loads it), 'optim': optimizer state, 'sched':
     plateau state or None, 'extra': {generator state, best_wer, ...}}.

Writes are atomic (a temporary file of its own per write, then a rename).
With background=True the snapshot is taken at once (copied off the card,
or cloned when already on the CPU: the train step updates its params in
place) and torch.save + the rename run on one writer thread
(checkpoint.py:53-140); wait_for_checkpoints() makes them durable and
re-raises a failed write.  Also the flag snapshot
logs/<name>/flagfile.txt that cli/stream.py and later runs read.
"""

import itertools
import os
import queue
import re
import threading

import torch

from edgedict_tpu_torch.config import MODEL_FLAGS, PRETRAIN_FLAGS, TRAIN_FLAGS

_STEP_FILE = re.compile(r'(\d+)\.ckpt')


def checkpoint_path(logdir, step):
    return os.path.join(logdir, 'models', f'{int(step)}.ckpt')


def _to_cpu(tree, copy=False):
    """CPU snapshot of a tree of tensors; copy=True clones tensors that are
    already on the CPU (.cpu() returns them as they are)."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v, copy) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.clone() if copy and t.device.type == 'cpu' else t.cpu()
    return tree


_TMP_SEQ = itertools.count(1)


def _write_payload(payload, path):
    # a tmp name of its own per write: a background and a synchronous save
    # of one step must not rename each other's file
    tmp = (f'{path}.tmp.{os.getpid()}.{threading.get_ident()}.'
           f'{next(_TMP_SEQ)}')
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(logdir, step, model_state, optim_state=None,
                    sched_state=None, extra=None, background=False):
    """Write logs/<name>/models/<step>.ckpt; → its path.  background=True
    hands the write to the writer thread (call wait_for_checkpoints()
    before reading the file)."""
    path = checkpoint_path(logdir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {'step': int(step),
               'model': _to_cpu(dict(model_state), background),
               'optim': _to_cpu(optim_state, background),
               'sched': sched_state, 'extra': _to_cpu(extra, background)}
    if background:
        _writer().submit(payload, path)
    else:
        _write_payload(payload, path)
    return path


class _CheckpointWriter:
    """One daemon thread draining a queue of (payload, path) writes; a
    failed write is re-raised by the next submit() or wait()."""

    def __init__(self):
        self._q = queue.Queue()
        self._error = None
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            payload, path = self._q.get()
            try:
                _write_payload(payload, path)
            except Exception as e:            # re-raised by _check
                self._error = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError('background checkpoint write failed') from e

    def submit(self, payload, path):
        self._check()
        self._q.put((payload, path))

    def wait(self):
        self._q.join()
        self._check()


_WRITER = None
_WRITER_LOCK = threading.Lock()


def _writer():
    global _WRITER
    with _WRITER_LOCK:
        if _WRITER is None:
            _WRITER = _CheckpointWriter()
        return _WRITER


def wait_for_checkpoints():
    """Block until every background write is on disk; re-raise a failed
    one."""
    if _WRITER is not None:
        _WRITER.wait()


def load_checkpoint(path):
    """→ the payload dict, tensors on the CPU (the JAX package's files:
    jax_checkpoint.load_jax_checkpoint)."""
    return torch.load(path, map_location='cpu', weights_only=True)


def _steps(logdir):
    models_dir = os.path.join(logdir, 'models')
    if not os.path.isdir(models_dir):
        return []
    return sorted(int(m.group(1)) for fn in os.listdir(models_dir)
                  if (m := _STEP_FILE.fullmatch(fn)))


def latest_step(logdir):
    """Highest checkpoint step in logs/<name>/models, or None."""
    steps = _steps(logdir)
    return steps[-1] if steps else None


def prune_checkpoints(logdir, keep):
    """Keep only the newest `keep` step checkpoints (0/None = keep all);
    best.ckpt and the flag snapshot are untouched.  Only steps older than
    the `keep` newest go, so an in-flight background write of the newest
    is never removed.  → removed steps."""
    if not keep:
        return []
    removed = []
    for step in _steps(logdir)[:-keep]:
        try:
            os.remove(checkpoint_path(logdir, step))
            removed.append(step)
        except OSError:
            pass
    return removed


def snapshot_flags(flags, logdir):
    """Write the run's model, trainer and pretraining flags to
    logs/<name>/flagfile.txt, one `--k=v` per line (booleans as
    true/false, unset flags left out), readable by config.parse_flags in
    every CLI of the port."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, 'flagfile.txt')
    registry = {name for name, _, _ in
                MODEL_FLAGS + TRAIN_FLAGS + PRETRAIN_FLAGS}
    lines = []
    for key, value in sorted(vars(flags).items()):
        if value is None or key not in registry:
            continue
        if isinstance(value, bool):
            value = 'true' if value else 'false'
        lines.append(f'--{key}={value}')
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path
