"""Optimizers and LR schedules (counterpart of edgedict_tpu/optim.py).

The update is the JAX package's optax chain, written out as plain tensor
math on dicts of tensors keyed by parameter name:

    clip_by_global_norm(gradclip) → scale_by_adam(b1 .9, b2 .999, eps 1e-8)
    [→ + weight_decay · param for adamw] → × (−lr)

(sgd: clip → momentum trace g + m·t → × (−lr)).  `update` is functional: it
returns the updates and a NEW state and leaves the given state untouched,
so the train step can keep the old params and state, Adam's step count
included, when a step is skipped (parallel/train.py:201-211), without a
host sync.  The lr enters each call as a number (the warmup × plateau
schedule lives on the host).  SM3 and Novograd are not ported yet.
"""

import math

import torch


def global_norm(tensors):
    """sqrt(sum of squares) over all tensors, in fp32 (optax global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


class Optimizer:
    """One of adam / adamw / sgd with optional global-norm clipping."""

    def __init__(self, name, gradclip=None, weight_decay=0.0, momentum=0.9,
                 b1=0.9, b2=0.999, eps=1e-8):
        if name in ('sm3', 'novograd'):
            raise NotImplementedError(
                f'optimizer {name!r} is not yet ported (adam, adamw, sgd)')
        if name not in ('adam', 'adamw', 'sgd'):
            raise ValueError(f'unknown optimizer {name}')
        self.name = name
        self.gradclip = gradclip
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        """params: {name: tensor} → state {'count': int32 scalar, and
        'mu'/'nu' (adam, adamw) or 'trace' (sgd with momentum)}."""
        dev = next(iter(params.values())).device
        state = {'count': torch.zeros((), dtype=torch.int32, device=dev)}
        if self.name in ('adam', 'adamw'):
            state['mu'] = {k: torch.zeros_like(p) for k, p in params.items()}
            state['nu'] = {k: torch.zeros_like(p) for k, p in params.items()}
        elif self.momentum:
            state['trace'] = {k: torch.zeros_like(p)
                              for k, p in params.items()}
        return state

    def update(self, grads, state, params, lr):
        """→ (updates {name: tensor} to add to the params, new state)."""
        if self.gradclip is not None and self.gradclip > 0:
            norm = global_norm(grads.values())
            keep = norm < self.gradclip
            grads = {k: torch.where(keep, g, g / norm * self.gradclip)
                     for k, g in grads.items()}
        count = state['count'] + 1
        new = {'count': count}
        if self.name in ('adam', 'adamw'):
            b1, b2 = self.b1, self.b2
            new['mu'] = {k: (1 - b1) * g + b1 * state['mu'][k]
                         for k, g in grads.items()}
            new['nu'] = {k: (1 - b2) * g * g + b2 * state['nu'][k]
                         for k, g in grads.items()}
            c = count.float()
            bc1 = 1 - torch.pow(torch.tensor(b1, device=c.device), c)
            bc2 = 1 - torch.pow(torch.tensor(b2, device=c.device), c)
            updates = {k: (new['mu'][k] / bc1)
                       / (torch.sqrt(new['nu'][k] / bc2) + self.eps)
                       for k in grads}
            if self.name == 'adamw' and self.weight_decay:
                updates = {k: u + self.weight_decay * params[k]
                           for k, u in updates.items()}
        elif self.momentum:
            new['trace'] = {k: g + self.momentum * state['trace'][k]
                            for k, g in grads.items()}
            updates = dict(new['trace'])
        else:
            updates = dict(grads)
        return {k: u * -lr for k, u in updates.items()}, new


def build_optimizer(name, gradclip=None, weight_decay=0.0, momentum=0.9):
    """The optimizer by flag name (optim.py:build_optimizer)."""
    return Optimizer(name, gradclip=gradclip, weight_decay=weight_decay,
                     momentum=momentum)


def select_state(ok, new, old):
    """Elementwise `new if ok else old` over a (nested dict) state."""
    if isinstance(new, dict):
        return {k: select_state(ok, v, old[k]) for k, v in new.items()}
    return torch.where(ok, new, old)


def warmup_scale(step, warmup_step):
    """Linear warmup factor in [0, 1] (reference cli/baseline.py:182-184)."""
    if warmup_step <= 0:
        return 1.0
    return min(1.0, (step + 1) / warmup_step)


class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch ReduceLROnPlateau semantics:
    mode='min', patience, factor, min_lr) as a multiplicative lr scale."""

    def __init__(self, base_lr, factor=0.5, patience=1, min_lr=1e-6):
        self.base_lr = base_lr
        self.factor = factor
        self.patience = patience
        self.min_scale = min_lr / base_lr
        self.best = math.inf
        self.bad_evals = 0
        self.scale = 1.0

    def step(self, metric):
        if metric < self.best:
            self.best = float(metric)
            self.bad_evals = 0
        else:
            self.bad_evals += 1
            if self.bad_evals > self.patience:
                self.bad_evals = 0
                self.scale = max(self.scale * self.factor, self.min_scale)
        return self.scale

    def state_dict(self):
        return {'best': self.best, 'bad_evals': self.bad_evals,
                'scale': self.scale}

    def load_state_dict(self, d):
        self.best = float(d['best'])
        self.bad_evals = int(d['bad_evals'])
        self.scale = float(d['scale'])
