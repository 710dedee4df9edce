"""Optimizers and LR schedules (counterpart of edgedict_tpu/optim.py).

The update is the JAX package's optax chain, written out as plain tensor
math on dicts of tensors keyed by parameter name:

    clip_by_global_norm(gradclip) → scale_by_adam(b1 .9, b2 .999, eps 1e-8)
    [→ + weight_decay · param for adamw] → × (−lr)

(the wav2vec pretrainer's adamw_no_ln_decay: the same with its own b1, b2
and the decay only on params of two or more dims, pretrainer.py:28-41)

(sgd: clip → momentum trace g + m·t → × (−lr); sm3: clip → scale_by_sm3
with momentum 0.9 → × (−lr); novograd: clip → scale_by_novograd(
weight_decay) → × (−lr); optim.py:30-129, 155-158).  `update` is
functional: it returns the updates and a NEW state and leaves the given
state untouched, so the train step can keep the old params and state,
Adam's step count included, when a step is skipped (parallel/train.py:
201-211), without a host sync.  The lr enters each call as a number (the
warmup × plateau schedule lives on the host).
"""

import math

import torch


def global_norm(tensors):
    """sqrt(sum of squares) over all tensors, in fp32 (optax global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


SM3_MOMENTUM = 0.9          # build_optimizer's scale_by_sm3(momentum=0.9)
SM3_EPS = 1e-30
NOVOGRAD_B1, NOVOGRAD_B2, NOVOGRAD_EPS = 0.95, 0.0, 1e-8


def sm3_update(g, accs, mom):
    """SM3-II (optim.py:scale_by_sm3, beta 0): the second-moment estimate
    is the min of the rank-1 accumulators {dim: tensor keeping only that
    dim} plus g², each accumulator then takes its max over the other dims;
    the update is g / (sqrt(nu) + eps) through a 0.9 momentum EMA.
    → (new accs, new momentum = the update)."""
    nu = accs[0]
    for i in range(1, g.ndim):
        nu = torch.minimum(nu, accs[i])
    nu = nu.expand(g.shape) + g * g
    new_accs = {}
    for i in range(max(1, g.ndim)):          # a scalar keeps one accumulator
        rest = [j for j in range(g.ndim) if j != i]
        new_accs[i] = torch.amax(nu, dim=rest, keepdim=True) if rest else nu
    upd = g / (torch.sqrt(nu) + SM3_EPS)
    return new_accs, SM3_MOMENTUM * mom + (1 - SM3_MOMENTUM) * upd


def novograd_update(g, m, v, p, weight_decay):
    """Novograd (optim.py:scale_by_novograd, b2 0, no grad averaging):
    one fp32 scalar second moment per tensor, v = |g|² on the first step
    (v == 0), d = g / (sqrt(v) + eps) + wd·p, m = b1·m + d.
    → (new m = the update, new v)."""
    norm = torch.sum(g.float() ** 2)
    v = torch.where(v == 0, norm,
                    NOVOGRAD_B2 * v + (1 - NOVOGRAD_B2) * norm)
    d = g / (torch.sqrt(v) + NOVOGRAD_EPS)
    if weight_decay:
        d = d + weight_decay * p
    return NOVOGRAD_B1 * m + d, v


def split_segments(tree, segments):
    """{name: tensor} with each segmented name's tensor cut into its pieces
    '<name>[i]' ({name: (dim, sizes)})."""
    out = {}
    for k, v in tree.items():
        if k in segments:
            dim, sizes = segments[k]
            for i, piece in enumerate(torch.split(v, list(sizes), dim)):
                out[f'{k}[{i}]'] = piece
        else:
            out[k] = v
    return out


def join_segments(tree, segments):
    """The inverse of split_segments."""
    out = {k: v for k, v in tree.items() if '[' not in k}
    for k, (dim, sizes) in segments.items():
        if f'{k}[0]' in tree:
            out[k] = torch.cat([tree[f'{k}[{i}]'] for i in range(len(sizes))],
                               dim)
    return out


class Optimizer:
    """One of adam / adamw / sgd / sm3 / novograd with optional
    global-norm clipping.  adamw decays the params of at least
    `decay_min_ndim` dims (0: all of them, as build_optimizer's adamw).
    segments {name: (dim, sizes)}: params whose SM3 / Novograd state is
    kept per piece (the elementwise optimizers need no cut)."""

    def __init__(self, name, gradclip=None, weight_decay=0.0, momentum=0.9,
                 b1=0.9, b2=0.999, eps=1e-8, decay_min_ndim=0,
                 segments=None):
        if name not in ('adam', 'adamw', 'sgd', 'sm3', 'novograd'):
            raise ValueError(f'unknown optimizer {name}')
        self.name = name
        self.gradclip = gradclip
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.b1, self.b2, self.eps = b1, b2, eps
        self.decay_min_ndim = decay_min_ndim
        self.segments = dict(segments or {}) \
            if name in ('sm3', 'novograd') else {}

    def init(self, params):
        """params: {name: tensor} → state {'count': int32 scalar, and
        'mu'/'nu' (adam, adamw), 'trace' (sgd with momentum), 'accs' {name:
        {dim: rank-1 accumulator}} / 'momentum' (sm3) or 'm' / 'v' fp32
        scalars (novograd)}."""
        dev = next(iter(params.values())).device
        params = split_segments(params, self.segments)
        state = {'count': torch.zeros((), dtype=torch.int32, device=dev)}
        if self.name in ('adam', 'adamw'):
            state['mu'] = {k: torch.zeros_like(p) for k, p in params.items()}
            state['nu'] = {k: torch.zeros_like(p) for k, p in params.items()}
        elif self.name == 'sm3':
            state['accs'] = {
                k: {i: p.new_zeros([d if j == i else 1
                                    for j, d in enumerate(p.shape)])
                    for i in range(max(1, p.ndim))}
                for k, p in params.items()}
            state['momentum'] = {k: torch.zeros_like(p)
                                 for k, p in params.items()}
        elif self.name == 'novograd':
            state['m'] = {k: torch.zeros_like(p) for k, p in params.items()}
            state['v'] = {k: torch.zeros((), dtype=torch.float32, device=dev)
                          for k in params}
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
        if self.segments:
            grads = split_segments(grads, self.segments)
            params = split_segments(params, self.segments)
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
                           if params[k].ndim >= self.decay_min_ndim else u
                           for k, u in updates.items()}
        elif self.name == 'sm3':
            outs = {k: sm3_update(g, state['accs'][k], state['momentum'][k])
                    for k, g in grads.items()}
            new['accs'] = {k: o[0] for k, o in outs.items()}
            new['momentum'] = {k: o[1] for k, o in outs.items()}
            updates = dict(new['momentum'])
        elif self.name == 'novograd':
            outs = {k: novograd_update(g, state['m'][k], state['v'][k],
                                       params[k], self.weight_decay)
                    for k, g in grads.items()}
            new['m'] = {k: o[0] for k, o in outs.items()}
            new['v'] = {k: o[1] for k, o in outs.items()}
            updates = dict(new['m'])
        elif self.momentum:
            new['trace'] = {k: g + self.momentum * state['trace'][k]
                            for k, g in grads.items()}
            updates = dict(new['trace'])
        else:
            updates = dict(grads)
        updates = join_segments(updates, self.segments)
        return {k: u * -lr for k, u in updates.items()}, new


def build_optimizer(name, gradclip=None, weight_decay=0.0, momentum=0.9):
    """The optimizer by flag name (optim.py:build_optimizer); a Transducer's
    is models/transducer.py build_optimizer."""
    return Optimizer(name, gradclip=gradclip, weight_decay=weight_decay,
                     momentum=momentum)


def adamw_no_ln_decay(b1, b2, weight_decay, gradclip=None):
    """The pretrainer's AdamW (pretrainer.py:28-41): clip, Adam(b1, b2,
    eps 1e-8), + weight_decay · p on params of two or more dims only (no
    decay of biases, norm scales or other 1-D params), × (−lr)."""
    return Optimizer('adamw', gradclip=gradclip, weight_decay=weight_decay,
                     b1=b1, b2=b2, decay_min_ndim=2)


def linear_warmup_decay(step, warmup, total):
    """lr scale min(1, step / warmup) · max(0, 1 − step / total)
    (pretrainer.py:44-48)."""
    s = float(step)
    return min(1.0, s / max(warmup, 1)) * max(0.0, 1.0 - s / max(total, 1))


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
