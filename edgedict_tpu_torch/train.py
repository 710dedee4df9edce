"""The training step (counterpart of edgedict_tpu/parallel/train.py, one
device, no mesh).

`make_train_step` returns `step(state, batch, lr, generator, aux=None)`.
The batch holds (accum, micro, ...) tensors on the model's device: 'audio',
'alen', 'ys', 'ylen' when a feature pipeline is given (featurised inside
the step, dither and SpecAugment on), else 'xs', 'xlen', 'ys', 'ylen'.
Each micro-batch runs forward + backward with bf16 activations when
bf16=True (features cast to bf16, params stay fp32, each op casts its
weights to the activation dtype); the gradients sum in fp32 in
`param.grad` and are averaged over the micro-batches (train.py:171-194).
A custom `loss_fn(model, micro, generator, aux)` replaces the transducer
loss (the raw-waveform and wav2vec paths) and takes no compute-dtype cast
from the step (train.py:164); with loss_has_aux it returns (loss, metrics)
and each metric is the mean over the micro-batches (train.py:216).  The
optimizer update is applied only when the loss and the gradient norm are
finite: a non-finite step leaves the params and the optimizer state, Adam's
count included, as they were, without a host sync (train.py:201-211).
Metrics: loss, grad_norm (before clipping), skipped (`apply_grads`, the
end of every train step: this one and parallel/pipeline.py's).

Data parallelism (parallel/train.py:141 of the JAX package, one process a
GPU here): when a default torch.distributed process group of world size > 1
is initialized, each rank runs the step on its own rows and, after the
accumulation loop and before the optimizer, the gradients and the loss are
averaged across the ranks by one all-reduce of a flat fp32 buffer for each
device the rank's parameters lie on (one device, or the rank's grid of
tensor / pipeline slots, parallel/; what DistributedDataParallel with
no_sync would do).  The gradient norm and the
non-finite skip then read the averaged values, so every rank skips or
updates alike; auxiliary metrics stay per rank.  Without a group, or at
world size 1, the step is the one-device step.

`make_eval_step` returns `eval(model, batch)` → (loss, y_seq, out_len) for
an 'audio', 'alen', 'ys', 'ylen' batch: the deterministic fp32 loss and the
greedy decode (K3 on CUDA), featurised by the pipeline or by
`feature_fn(model, batch)` → (xs, xlen).  `make_beam_eval_step` returns
`beam(model, batch)` → (tokens, n_tok) of the fixed-shape beam search on
the same batch (models/beam_search.py; the trainer's --eval_beam_width).

`prefetch_batches` moves host batches to the device one ahead: on CUDA
batch N+1's copy is issued on a side stream as soon as the consumer has
enqueued step N, so it overlaps that step; elsewhere it is `device_batch`.
"""

import dataclasses

import torch
import torch.distributed as dist

from edgedict_tpu_torch import optim, parallel
from edgedict_tpu_torch.models import transducer as T
from edgedict_tpu_torch.models.decoding import transducer_greedy_decode
from edgedict_tpu_torch.optim import on


@dataclasses.dataclass
class TrainState:
    model: T.Transducer
    opt_state: dict
    step: int = 0


def make_train_state(cfg, optimizer, device, seed=0, layout=None):
    """Seeded model on `device` (Transducer's CPU torch.Generator init, so
    every device gets the same weights), or placed by `layout` over its
    grid (parallel/__init__.py:place_model; `device` is then unread), and
    its optimizer state, each entry beside its parameter."""
    if layout is None:
        model = T.Transducer(cfg, device=device, seed=seed)
    else:
        model = parallel.place_model(
            T.Transducer(cfg, device=layout.home, seed=seed), layout)
    return TrainState(model=model,
                      opt_state=optimizer.init(dict(model.named_parameters())))


def world():
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_reduce_mean(tensors):
    """Average fp32 tensors across the process group with one all-reduce a
    device, of the concatenation of the tensors on it (a rank's grid puts
    its parameters on several devices, parallel/); → the averaged tensors
    (new ones), in order."""
    by_device = {}
    for i, t in enumerate(tensors):
        by_device.setdefault(t.device, []).append(i)
    out = [None] * len(tensors)
    for idx in by_device.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        flat /= dist.get_world_size()
        for i, piece in zip(idx, flat.split([tensors[i].numel()
                                             for i in idx])):
            out[i] = piece.view_as(tensors[i])
    return out


def broadcast_module(module, src=0):
    """Copy rank `src`'s parameters and buffers to every rank (no-op
    without a group)."""
    if world()[1] == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)


def make_train_step(cfg, optimizer, bf16=True, feature_pipeline=None,
                    loss_fn=None, loss_has_aux=False):
    compute_dtype = torch.bfloat16 if bf16 else torch.float32

    def micro_loss(model, micro, generator, aux):
        if loss_fn is not None:
            return loss_fn(model, micro, generator, aux)
        if feature_pipeline is not None:
            xs, xlen = feature_pipeline(micro['audio'], micro['alen'],
                                        train=True, generator=generator)
        else:
            xs, xlen = micro['xs'], micro['xlen']
        return T.transducer_loss(model, cfg, xs.to(compute_dtype),
                                 micro['ys'], xlen, micro['ylen'],
                                 deterministic=False, generator=generator)

    def train_step(state, batch, lr, generator=None, aux=None):
        model = state.model
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        first = next(iter(batch.values()))
        accum = first.shape[0]
        loss_sum = torch.zeros((), dtype=torch.float32, device=first.device)
        extras = []
        for i in range(accum):
            loss = micro_loss(model, {k: v[i] for k, v in batch.items()},
                              generator, aux)
            if loss_has_aux:
                loss, extra = loss
                extras.append({k: torch.as_tensor(v).detach().float()
                               for k, v in extra.items()})
            loss.backward()
            loss_sum = loss_sum + loss.detach().float()
        state, metrics = apply_grads(state, optimizer, params,
                                     loss_sum / accum, lr, accum)
        for k in extras[0] if extras else ():
            metrics[k] = torch.stack([e[k].to(first.device)
                                      for e in extras]).mean()
        return state, metrics

    return train_step


def apply_grads(state, optimizer, params, loss, lr, accum=1):
    """The end of a train step over `params` ({name: parameter} of
    state.model): their .grad / accum (a param no loss reached has a zero
    gradient, as under jax.grad), averaged with the loss across the
    process group, then the optimizer update, applied only where the loss
    and the gradient norm are finite; the .grad cleared.
    → (the next TrainState, metrics loss, grad_norm, skipped)."""
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             / accum for k, p in params.items()}
    if world()[1] > 1:
        *reduced, loss = all_reduce_mean([*grads.values(), loss.reshape(1)])
        grads = dict(zip(grads, reduced))
        loss = loss.reshape(())
    with torch.no_grad():
        updates, new_opt = optimizer.update(grads, state.opt_state, params,
                                            lr)
        gnorm = optim.global_norm(grads.values())
        ok = torch.isfinite(loss) & torch.isfinite(on(gnorm, loss))
        for k, p in params.items():
            p.copy_(torch.where(on(ok, p), p + updates[k], p))
        new_opt = optim.select_state(ok, new_opt, state.opt_state)
    for p in params.values():
        p.grad = None
    return TrainState(state.model, new_opt, state.step + 1), \
        {'loss': loss, 'grad_norm': gnorm, 'skipped': (~ok).float()}


def make_eval_step(cfg, feature_pipeline=None, feature_fn=None):
    @torch.no_grad()
    def eval_step(model, batch):
        xs, xlen = feature_fn(model, batch) if feature_fn is not None \
            else feature_pipeline(batch['audio'], batch['alen'])
        loss = T.transducer_loss(model, cfg, xs, batch['ys'], xlen,
                                 batch['ylen'])
        y_seq, out_len, _ = transducer_greedy_decode(model, cfg, xs, xlen)
        return loss, y_seq, out_len

    return eval_step


def make_beam_eval_step(cfg, beam_width, feature_pipeline, max_sym_per_frame=3,
                        max_tokens=200, lm=None):
    """Beam-search eval step (parallel/train.py:283-307): (model, batch) →
    (tokens (B, max_tokens) int32, n_tok (B,)), fp32 features as the
    greedy eval; lm: optional (LMModel, LMConfig, weight)."""
    from edgedict_tpu_torch.models.beam_search import transducer_beam_search

    @torch.no_grad()
    def beam_step(model, batch):
        xs, xlen = feature_pipeline(batch['audio'], batch['alen'])
        toks, n_tok, _ = transducer_beam_search(
            model, cfg, xs, xlen, beam_width=beam_width,
            max_sym_per_frame=max_sym_per_frame, max_tokens=max_tokens,
            lm=lm)
        return toks, n_tok

    return beam_step


def device_batch(batch, accum_steps, device, non_blocking=False):
    """Host batch dict of (B, ...) arrays → (accum, B / accum, ...) tensors
    on `device` (train.py:shard_batch, one device)."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % accum_steps:
            raise ValueError(f'{k}: batch {v.shape[0]} does not split into '
                             f'{accum_steps} micro-batches')
        out[k] = v.reshape((accum_steps, -1) + tuple(v.shape[1:])).to(
            device, non_blocking=non_blocking)
    return out


def prefetch_batches(batches, accum_steps, device):
    """Host batches → device_batch's batches, in order.  On CUDA each copy
    (from the loader's page-locked batches) runs on a side stream: the
    generator issues batch N+1's copy when the consumer asks for it, right
    after enqueuing step N, and the compute stream waits on the copy's
    event alone.  A host batch stays referenced until its copy has
    passed."""
    device = torch.device(device)
    if device.type != 'cuda':
        for batch in batches:
            yield device_batch(batch, accum_steps, device)
        return
    side = torch.cuda.Stream(device)
    inflight = []                    # (copy event, host batch)
    for batch in batches:
        compute = torch.cuda.current_stream(device)
        with torch.cuda.stream(side):
            dev = device_batch(batch, accum_steps, device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        compute.wait_event(done)
        for t in dev.values():
            t.record_stream(compute)
        inflight = [(e, b) for e, b in inflight if not e.query()]
        inflight.append((done, batch))
        yield dev
