"""Pipeline parallelism for the transducer encoder (counterpart of
edgedict_tpu/parallel/pipeline.py).

The encoder splits into a preamble (the input LayerNorm and every layer up
to and including the last in-encoder time reduction, whose activation
shapes differ layer to layer) and a uniform tail of residual + LayerNorm
layers at the reduced frame rate, cut into pp stages of equal depth
(`pipeline_split`, `stage_layers`).  Stage 0's device runs the preamble
and its own tail layers; stage s's device holds and runs its layers
(parallel/__init__.py:place_model).

`encoder_pipeline` runs the GPipe schedule of the JAX package
(pipeline.py:161-186) in tick order from Python: M + pp - 1 ticks, at tick
t stage s runs microbatch t - s on its device, its activation then moved
to the next stage's device (`.to(device, non_blocking=True)`); the
projection runs on the home device after the last stage.  Autograd runs
the mirrored backward pipeline.

`make_train_step_pp` is make_train_step with accum_steps = M (loss = mean
over the M·B rows; each microbatch featurized with the same generator
draws as the plain step's micro-batch m), its encoder pipelined; one
backward over the loss of all microbatches.  The joint and loss of each
microbatch run on the home device.  It refuses dropout and tp > 1, as the
JAX package's does (pipeline.py:216-225).
"""

import torch

from edgedict_tpu_torch import train as TR
from edgedict_tpu_torch.models import transducer as T
from edgedict_tpu_torch.ops.layers import layer_norm
from edgedict_tpu_torch.ops.rnnt_loss import rnnt_loss_from_joint
from edgedict_tpu_torch.optim import on


def pipeline_split(cfg, pp):
    """(k0, n_tail): preamble layer count and pipelined tail layer count.

    The preamble absorbs every in-encoder time reduction so the activations
    exchanged between stages all share one (T', B, H) shape."""
    k0 = (max(cfg.enc_time_reductions) + 1) if cfg.enc_time_reductions else 1
    k0 = max(k0, 1)
    n_tail = cfg.enc_layers - k0
    if pp < 1:
        raise ValueError(f'pp={pp} must be >= 1')
    if n_tail < pp or n_tail % pp:
        raise ValueError(
            f'pipeline needs the {n_tail} uniform encoder layers after the '
            f'last time reduction (layer {k0 - 1}) to divide over pp={pp} '
            f'stages; enc_layers={cfg.enc_layers}, '
            f'enc_time_reductions={cfg.enc_time_reductions}')
    return k0, n_tail


def stage_layers(cfg, pp):
    """The encoder layer indices of each of the pp stages' tails."""
    k0, n_tail = pipeline_split(cfg, pp)
    per = n_tail // pp
    return [range(k0 + s * per, k0 + (s + 1) * per) for s in range(pp)]


def _run_layers(encoder, cfg, x, layers):
    """Encoder layers `layers` on time-major x from zero state, on x's
    device."""
    for i in layers:
        z = torch.zeros((x.shape[1], cfg.enc_hidden_size), device=x.device)
        x, _ = T.encoder_layer(encoder, cfg, i, x,
                               (z, z) if cfg.module_type == 'LSTM' else z)
    return x


def encoder_pipeline(encoder, cfg, micros, layout):
    """Pipelined encoder forward over M microbatches: micros (M, B, T,
    input_size) on the home device → (M, B, T', enc_proj_size) there, each
    microbatch's equal to encoder_apply's from zero state."""
    pp = layout.pp
    k0, _ = pipeline_split(cfg, pp)
    stages = stage_layers(cfg, pp)
    devices = layout.stage_devices()
    m_count = micros.shape[0]
    carry, outs = {}, [None] * m_count
    for tick in range(m_count + pp - 1):
        for s in range(pp):
            m = tick - s
            if not 0 <= m < m_count:
                continue
            if s == 0:
                x = layer_norm(micros[m].transpose(0, 1),
                               encoder.norm.weight, encoder.norm.bias)
                x = _run_layers(encoder, cfg, x, range(k0))
            else:
                x = carry.pop(m)
            y = _run_layers(encoder, cfg, x, stages[s])
            if s + 1 < pp:
                carry[m] = y.to(devices[s + 1], non_blocking=True)
            else:
                outs[m] = y
    return torch.stack([        # the projection on the home device
        T.encoder_linear(encoder.proj, on(y, micros)).transpose(0, 1)
        for y in outs])


def make_train_step_pp(cfg, optimizer, layout, bf16=True,
                       feature_pipeline=None):
    """The train step with a pipelined encoder: step(state, batch, lr,
    generator=None) → (state, metrics), as make_train_step's, the batch's
    (M, micro, ...) tensors on the home device and the model placed by
    `layout` (parallel/__init__.py:place_model)."""
    if cfg.enc_dropout > 0 or cfg.dec_dropout > 0:
        raise NotImplementedError(
            'pipeline v1 does not thread dropout rngs through stages '
            '(the bundled presets train with dropout=0)')
    if layout.tp > 1:
        raise NotImplementedError(
            'tp>1 with pp>1 is not supported: the pipelined joint/loss '
            'phase is data-parallel over (pp, dp) and the pipeline '
            'does not partition over tp (use tp with the plain '
            'dp step, or pp with tp=1)')
    compute_dtype = torch.bfloat16 if bf16 else torch.float32

    def loss_fn(model, batch, generator):
        """Σ_m mean loss of microbatch m, / M."""
        m_count = batch['ys'].shape[0]
        if feature_pipeline is not None:
            feats = [feature_pipeline(batch['audio'][m], batch['alen'][m],
                                      train=True, generator=generator)
                     for m in range(m_count)]
            xs = torch.stack([x for x, _ in feats])
            xlen = torch.stack([n for _, n in feats])
        else:
            xs, xlen = batch['xs'], batch['xlen']
        xs = xs.to(compute_dtype)
        h_enc = encoder_pipeline(model.encoder, cfg, xs, layout)
        total = 0.0
        for m in range(m_count):
            h_dec, _ = T.decoder_apply(model.decoder, cfg, batch['ys'][m])
            xlen_s = T.scale_length(cfg, xlen[m], xs.shape[2], h_enc.shape[2])
            total = total + rnnt_loss_from_joint(
                model.joint, h_enc[m], h_dec, batch['ys'][m], xlen_s,
                batch['ylen'][m], blank=cfg.blank).mean()
        return total / m_count

    def train_step(state, batch, lr, generator=None):
        params = dict(state.model.named_parameters())
        for p in params.values():
            p.grad = None
        loss = loss_fn(state.model, batch, generator)
        loss.backward()
        return TR.apply_grads(state, optimizer, params,
                              loss.detach().float(), lr)

    return train_step
