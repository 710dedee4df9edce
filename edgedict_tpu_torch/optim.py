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

The tensors may lie on several devices (parallel/: pipeline stages and
vocabulary slices).  Each state entry sits beside its parameter; the count
and every reduction over several tensors (the global norm, the skip's
`ok`) are made on the first tensor's device and sent to the others.  A
tensor cut along dim 0 into slices named shard_key(name, k) (`shards`) is
one tensor to SM3 and Novograd, whose statistics span it: SM3 takes the
max over the slices for its accumulators of the other dims, Novograd sums
the slices' squared norms; Adam and SGD are elementwise and need no cut.
"""

import functools
import math

import torch


def on(x, ref):
    """x on ref's device (x itself where it is there already)."""
    return x if x.device == ref.device else x.to(ref.device)


def global_norm(tensors):
    """sqrt(sum of squares) over all tensors, in fp32 (optax global_norm),
    on the first tensor's device."""
    parts = [torch.sum(t.float() ** 2) for t in tensors]
    return torch.sqrt(sum(on(p, parts[0]) for p in parts))


def shard_key(name, k):
    """The name of slice k of the sharded tensor `name`."""
    return f'{name}_{k}'


SM3_MOMENTUM = 0.9          # build_optimizer's scale_by_sm3(momentum=0.9)
SM3_EPS = 1e-30
NOVOGRAD_B1, NOVOGRAD_B2, NOVOGRAD_EPS = 0.95, 0.0, 1e-8


def sm3_update(gs, accs, moms):
    """SM3-II (optim.py:scale_by_sm3, beta 0) of one tensor held as slices
    along dim 0 (gs, their accumulators and momenta; one slice is the
    whole): the second-moment estimate is the min of the rank-1
    accumulators {dim: tensor keeping only that dim} plus g², each
    accumulator then takes its max over the other dims (dim 0's stays each
    slice's own, the others' is the max over the slices, held by each);
    the update is g / (sqrt(nu) + eps) through a 0.9 momentum EMA.
    → (new accs, new momenta = the updates), one a slice."""
    nus = []
    for g, acc in zip(gs, accs):
        nu = acc[0]
        for i in range(1, g.ndim):
            nu = torch.minimum(nu, acc[i])
        nus.append(nu.expand(g.shape) + g * g)
    ndim = gs[0].ndim
    new_accs = [{} for _ in gs]
    for i in range(max(1, ndim)):            # a scalar keeps one accumulator
        rest = [j for j in range(ndim) if j != i]
        parts = [torch.amax(nu, dim=rest, keepdim=True) if rest else nu
                 for nu in nus]
        if i and len(parts) > 1:
            whole = functools.reduce(torch.maximum,
                                     [on(p, parts[0]) for p in parts])
            parts = [on(whole, p) for p in parts]
        for acc, part in zip(new_accs, parts):
            acc[i] = part
    new_moms = [SM3_MOMENTUM * m + (1 - SM3_MOMENTUM)
                * (g / (torch.sqrt(nu) + SM3_EPS))
                for g, nu, m in zip(gs, nus, moms)]
    return new_accs, new_moms


def novograd_update(gs, ms, vs, ps, weight_decay):
    """Novograd (optim.py:scale_by_novograd, b2 0, no grad averaging) of
    one tensor held as slices along dim 0: one fp32 scalar second moment
    per tensor (held by each slice), v = |g|² on the first step (v == 0),
    d = g / (sqrt(v) + eps) + wd·p, m = b1·m + d.
    → (new m = the updates, new v), one a slice."""
    parts = [torch.sum(g.float() ** 2) for g in gs]
    norm = sum(on(p, parts[0]) for p in parts)
    v = on(vs[0], norm)
    v = torch.where(v == 0, norm,
                    NOVOGRAD_B2 * v + (1 - NOVOGRAD_B2) * norm)
    new_ms, new_vs = [], []
    for g, m, p in zip(gs, ms, ps):
        d = g / (torch.sqrt(on(v, g)) + NOVOGRAD_EPS)
        if weight_decay:
            d = d + weight_decay * p
        new_ms.append(NOVOGRAD_B1 * m + d)
        new_vs.append(on(v, g))
    return new_ms, new_vs


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
    kept per piece (the elementwise optimizers need no cut).  shards {name:
    n}: tensors held as n slices along dim 0, params shard_key(name, k)."""

    def __init__(self, name, gradclip=None, weight_decay=0.0, momentum=0.9,
                 b1=0.9, b2=0.999, eps=1e-8, decay_min_ndim=0,
                 segments=None, shards=None):
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
        self.shards = dict(shards or {})

    def groups(self, keys):
        """The keys, the slices of each sharded tensor as one group (in
        slice order), every other key alone."""
        slices = {shard_key(name, k): name for name, n in self.shards.items()
                  for k in range(n)}
        out, seen = [], set()
        for key in keys:
            name = slices.get(key)
            if name is None:
                out.append([key])
            elif name not in seen:
                seen.add(name)
                out.append([shard_key(name, k)
                            for k in range(self.shards[name])])
        return out

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
            state['v'] = {k: torch.zeros((), dtype=torch.float32,
                                         device=p.device)
                          for k, p in params.items()}
        elif self.momentum:
            state['trace'] = {k: torch.zeros_like(p)
                              for k, p in params.items()}
        return state

    def update(self, grads, state, params, lr):
        """→ (updates {name: tensor} to add to the params, new state)."""
        if self.gradclip is not None and self.gradclip > 0:
            norm = global_norm(grads.values())
            keep = norm < self.gradclip
            grads = {k: torch.where(on(keep, g), g,
                                    g / on(norm, g) * self.gradclip)
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
            updates = {k: (new['mu'][k] / on(bc1, g))
                       / (torch.sqrt(new['nu'][k] / on(bc2, g)) + self.eps)
                       for k, g in grads.items()}
            if self.name == 'adamw' and self.weight_decay:
                updates = {k: u + self.weight_decay * params[k]
                           if params[k].ndim >= self.decay_min_ndim else u
                           for k, u in updates.items()}
        elif self.name == 'sm3':
            new['accs'], new['momentum'] = {}, {}
            for keys in self.groups(grads):
                accs, moms = sm3_update([grads[k] for k in keys],
                                        [state['accs'][k] for k in keys],
                                        [state['momentum'][k] for k in keys])
                new['accs'].update(zip(keys, accs))
                new['momentum'].update(zip(keys, moms))
            updates = dict(new['momentum'])
        elif self.name == 'novograd':
            new['m'], new['v'] = {}, {}
            for keys in self.groups(grads):
                ms, vs = novograd_update(
                    [grads[k] for k in keys], [state['m'][k] for k in keys],
                    [state['v'][k] for k in keys],
                    [params[k] for k in keys], self.weight_decay)
                new['m'].update(zip(keys, ms))
                new['v'].update(zip(keys, vs))
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
    """Elementwise `new if ok else old` over a (nested dict) state, `ok`
    sent to each tensor's device."""
    if isinstance(new, dict):
        return {k: select_state(ok, v, old[k]) for k, v in new.items()}
    return torch.where(on(ok, new), new, old)


# the entries of Optimizer.init's state that hold a tensor a parameter key
PER_KEY = ('mu', 'nu', 'trace', 'accs', 'momentum', 'm', 'v')


def _join(pieces, dim0):
    return torch.cat([on(p, pieces[0]) for p in pieces]) if dim0 \
        else pieces[0]


def join_shards(state, shards):
    """An optimizer state over sharded params (shards {name: n}) → the
    state of the whole params, on the first slice's device: each slice's
    entries cut along dim 0 (the moments, SM3's dim-0 accumulator) are
    concatenated, the entries every slice holds alike (SM3's other
    accumulators, Novograd's v) taken once."""
    out = {k: v for k, v in state.items() if k not in PER_KEY}
    for entry in PER_KEY:
        if entry not in state:
            continue
        tree = dict(state[entry])
        for name, n in shards.items():
            pieces = [tree.pop(shard_key(name, k)) for k in range(n)]
            if isinstance(pieces[0], dict):            # SM3's accumulators
                tree[name] = {i: _join([p[i] for p in pieces], i == 0)
                              for i in pieces[0]}
            else:
                tree[name] = _join(pieces, pieces[0].ndim > 0)
        out[entry] = tree
    return out


def split_shards(state, shards):
    """The inverse of join_shards (on the whole state's devices; place_state
    moves each slice's entries to its parameter)."""
    def cut(t, n, dim0):
        return list(torch.chunk(t, n)) if dim0 else [t.clone()
                                                      for _ in range(n)]

    out = {k: v for k, v in state.items() if k not in PER_KEY}
    for entry in PER_KEY:
        if entry not in state:
            continue
        tree = dict(state[entry])
        for name, n in shards.items():
            whole = tree.pop(name)
            if isinstance(whole, dict):
                parts = {i: cut(a, n, i == 0) for i, a in whole.items()}
                pieces = [{i: p[k] for i, p in parts.items()}
                          for k in range(n)]
            else:
                pieces = cut(whole, n, whole.ndim > 0)
            tree.update({shard_key(name, k): p for k, p in enumerate(pieces)})
        out[entry] = tree
    return out


def place_state(state, params):
    """Each per-key entry of an optimizer state on its parameter's device
    (a segment '<name>[i]' on <name>'s), the rest on the first
    parameter's; → the placed state (tensors already there are kept)."""
    home = next(iter(params.values()))

    def move(tree, ref):
        if isinstance(tree, dict):
            return {k: move(v, ref) for k, v in tree.items()}
        return on(tree, ref)

    out = {}
    for entry, tree in state.items():
        if entry in PER_KEY:
            out[entry] = {k: move(v, params[k.split('[', 1)[0]])
                          for k, v in tree.items()}
        else:
            out[entry] = move(tree, home)
    return out


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
