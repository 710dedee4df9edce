"""Checkpoint save/resume (counterpart of edgedict_tpu/checkpoint.py).

Layout: logs/<name>/models/<step>.ckpt, written with torch.save and loaded
with torch.load(weights_only=True), holding

    {'step': int, 'model': state_dict (the reference key layout, so
     cli/stream.py --pt_path loads it), 'optim': optimizer state, 'sched':
     plateau state or None, 'extra': {generator state, best_wer, ...}}.

Writes are synchronous and atomic (temporary file + rename).  Also the flag
snapshot logs/<name>/flagfile.txt that cli/stream.py and later runs read.
"""

import os
import re

import torch

from edgedict_tpu_torch.config import MODEL_FLAGS, TRAIN_FLAGS

_STEP_FILE = re.compile(r'(\d+)\.ckpt')


def checkpoint_path(logdir, step):
    return os.path.join(logdir, 'models', f'{int(step)}.ckpt')


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(logdir, step, model_state, optim_state=None,
                    sched_state=None, extra=None):
    """Write logs/<name>/models/<step>.ckpt; → its path."""
    path = checkpoint_path(logdir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {'step': int(step), 'model': _to_cpu(dict(model_state)),
               'optim': _to_cpu(optim_state), 'sched': sched_state,
               'extra': _to_cpu(extra)}
    tmp = f'{path}.tmp.{os.getpid()}'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path):
    """→ the payload dict, tensors on the CPU."""
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
    best.ckpt and the flag snapshot are untouched.  → removed steps."""
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
    """Write the run's model and trainer flags to logs/<name>/flagfile.txt,
    one `--k=v` per line (booleans as true/false, unset flags left out),
    readable by config.parse_flags in every CLI of the port."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, 'flagfile.txt')
    registry = {name for name, _, _ in MODEL_FLAGS + TRAIN_FLAGS}
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
