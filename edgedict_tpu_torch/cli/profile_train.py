"""Where a training step's time goes.

  python -m edgedict_tpu_torch.cli.profile_train \
      --flagfile flagfiles/E6D2.txt [--batch_size 32] [--seconds 16] \
      [--label_len 64] [--steps 5] [--device cuda|cpu] [--enc_type GRU] \
      [--k8_slab_mb 8]

Seeded random weights (seed 0), a seeded synthetic batch of --batch_size
utterances of --seconds of audio with --label_len random token ids over
--bpe_size ids, and the flags' optimizer, gradclip, bf16 and SpecAugment.
--k8_slab_mb caps the h + dlogits scratch of K8's bf16 plan
(ops/joint_lse_plan.py SLAB_BYTES): it measures how K8's scratch traffic
moves the kernels around it.
Prints one JSON line with
  step_ms                 median of --steps whole train steps (train.py),
                          each closed by a device synchronise;
  audio_s_per_s           the batch's audio seconds over step_ms;
  peak_mem_gb             the most device memory allocated over the warm-up
                          and timed steps (null on the CPU);
  stage_ms                median per stage of the same step run piecewise,
                          each stage closed by a synchronise: forward
                          (features, encoder, prediction net, joint
                          projections), loss (fused joint + lattice),
                          backward, optimizer;
  device_ms_per_step      torch.profiler over --steps steps: summed device
                          time of every kernel and copy, per step;
  device_busy_share       that device time over the profiled wall time (one
                          stream, so device events do not overlap);
  kernel_device_ms_per_step   the same, per hand-written kernel;
  top_device_ms           the ten largest device entries by name.
On the CPU the device fields are null: the profiler sees no device there.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from edgedict_tpu_torch import optim
from edgedict_tpu_torch.cli.baseline import set_numerics
from edgedict_tpu_torch.cli.profile_stream import (
    device_times_us, synthetic_audio)
from edgedict_tpu_torch.config import (
    add_model_flags, add_train_flags, feature_config_from_flags,
    parse_flags, transducer_config_from_flags)
from edgedict_tpu_torch.features import FeaturePipeline
from edgedict_tpu_torch.models import transducer as T
from edgedict_tpu_torch.ops import joint_lse_plan
from edgedict_tpu_torch.ops.rnnt_loss import rnnt_loss_from_joint
from edgedict_tpu_torch.stream import resolve_device
from edgedict_tpu_torch.train import (
    device_batch, make_train_state, make_train_step)

# the hand-written kernels in the profiler's trace: every substring of a
# value is in the kernel's name (K1/K5: the persistent recurrence; K4/K6:
# remat + chain, and each apart; K7: all its launches, and apart its h
# launch and product where h is staged, 0 for the h launch where resident)
KERNELS = {'lstm_fwd': ('recur_fwd_kernel', 'LstmStep'),
           'lstm_bwd': ('LstmCell',),
           'lstm_bwd_remat': ('remat_', 'LstmCell'),
           'lstm_bwd_chain': ('chain_kernel', 'LstmCell'),
           'gru_fwd': ('recur_fwd_kernel', 'GruStep'),
           'gru_bwd': ('GruCell',),
           'gru_bwd_remat': ('remat_', 'GruCell'),
           'gru_bwd_chain': ('chain_kernel', 'GruCell'),
           'mel_power': ('mel_power_kernel',),
           'joint_lse_fwd': ('joint_lse_fwd',),
           'joint_lse_fwd_h': ('joint_lse_fwd_h_',),
           'joint_lse_fwd_mma': ('joint_lse_fwd_mma',),
           'joint_lse_bwd_h': ('joint_lse_bwd_h_',),
           'joint_lse_bwd_dl': ('joint_lse_bwd_dl_',),
           'joint_lse_bwd_dh': ('joint_lse_bwd_dh',),
           'joint_lse_bwd_dw': ('joint_lse_bwd_dw',),
           'joint_lse_bwd_reduce': ('joint_lse_bwd_reduce',),
           'lattice_alpha': ('lattice_alpha_kernel',),
           'lattice_beta_grad': ('lattice_beta_grad_kernel',)}


def synthetic_batch(n, seconds, label_len, vocab, seed=0):
    """Host batch dict: n seeded utterances and random ids in [4, vocab)
    (ids 0-3 are blank, pad, bos, unk)."""
    audio = np.stack([synthetic_audio(seed + i, seconds) for i in range(n)])
    rng = np.random.RandomState(seed)
    return {'audio': audio,
            'alen': np.full((n,), audio.shape[1], np.int32),
            'ys': rng.randint(4, vocab, (n, label_len)).astype(np.int32),
            'ylen': np.full((n,), label_len, np.int32)}


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def stage_ms(state, cfg, optimizer, pipeline, batch, lr, generator, bf16,
             device):
    """One train step run piecewise (accumulation over the leading axis as
    in train.py), each stage closed by a synchronise: → {stage: ms}."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = state.model
    params = dict(model.named_parameters())
    clock = dict.fromkeys(('forward', 'loss', 'backward', 'optimizer'), 0.0)
    accum = batch['ys'].shape[0]
    for i in range(accum):
        _sync(device)
        t0 = time.perf_counter()
        xs, xlen = pipeline(batch['audio'][i], batch['alen'][i], train=True,
                            generator=generator)
        xs = xs.to(dtype)
        h_enc, _ = T.encoder_apply(model.encoder, cfg, xs,
                                   deterministic=False, generator=generator)
        h_dec, _ = T.decoder_apply(model.decoder, cfg, batch['ys'][i],
                                   deterministic=False, generator=generator)
        xlen_s = T.scale_length(cfg, xlen, xs.shape[1], h_enc.shape[1])
        _sync(device)
        t1 = time.perf_counter()
        loss = rnnt_loss_from_joint(model.joint, h_enc, h_dec,
                                    batch['ys'][i], xlen_s,
                                    batch['ylen'][i], blank=cfg.blank).mean()
        _sync(device)
        t2 = time.perf_counter()
        loss.backward()
        _sync(device)
        t3 = time.perf_counter()
        clock['forward'] += t1 - t0
        clock['loss'] += t2 - t1
        clock['backward'] += t3 - t2
    t3 = time.perf_counter()
    with torch.no_grad():
        grads = {k: p.grad / accum for k, p in params.items()}
        updates, _ = optimizer.update(grads, state.opt_state, params, lr)
        gnorm = optim.global_norm(grads.values())
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        for k, p in params.items():
            torch.where(ok, p + updates[k], p)   # as the step, not applied
    _sync(device)
    clock['optimizer'] = time.perf_counter() - t3
    for p in params.values():
        p.grad = None
    return {k: 1e3 * v for k, v in clock.items()}


def profile(flags, device, log_fn=print):
    from torch.profiler import ProfilerActivity, profile as torch_profile
    feat = feature_config_from_flags(flags)
    cfg = transducer_config_from_flags(flags, flags.bpe_size,
                                       feat.input_size)
    pipeline = FeaturePipeline(feat, device)
    optimizer = T.build_optimizer(cfg, flags.optim, gradclip=flags.gradclip)
    state = make_train_state(cfg, optimizer, device)
    step = make_train_step(cfg, optimizer, bf16=flags.bf16,
                           feature_pipeline=pipeline)
    host = synthetic_batch(flags.batch_size, flags.seconds, flags.label_len,
                           flags.bpe_size)
    accum = max(1, flags.batch_size // max(1, flags.sub_batch_size))
    batch = device_batch(host, accum, device)
    gen = torch.Generator(device=device).manual_seed(0)
    lr = flags.lr
    head = {'device': str(device), 'batch_size': flags.batch_size,
            'accum': accum, 'audio_s': flags.seconds,
            'label_len': flags.label_len, 'vocab': flags.bpe_size,
            'bf16': flags.bf16, 'k8_slab_bytes': joint_lse_plan.SLAB_BYTES,
            'params': sum(p.numel() for p in state.model.parameters())}
    if device.type == 'cuda':
        head['name'] = torch.cuda.get_device_name(device)
        head['nvidia_smi'] = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip()
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(2):                                   # warm-up
        state, m = step(state, batch, lr, gen)
    _sync(device)

    times, losses = [], []
    for _ in range(flags.steps):
        t0 = time.perf_counter()
        state, m = step(state, batch, lr, gen)
        losses.append(float(m['loss']))                  # synchronises
        times.append(time.perf_counter() - t0)
    res = dict(head)
    res['step_ms'] = 1e3 * statistics.median(times)
    res['audio_s_per_s'] = float(host['alen'].sum()) / 16000.0 \
        / statistics.median(times)
    res['losses'] = losses
    res['peak_mem_gb'] = torch.cuda.max_memory_allocated(device) / 1e9 \
        if device.type == 'cuda' else None
    stages = [stage_ms(state, cfg, optimizer, pipeline, batch, lr, gen,
                       flags.bf16, device) for _ in range(flags.steps)]
    res['stage_ms'] = {k: statistics.median(s[k] for s in stages)
                       for k in stages[0]}

    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(flags.steps):
            state, m = step(state, batch, lr, gen)
        _sync(device)
        wall = time.perf_counter() - t0
    dev_us = device_times_us(prof) if device.type == 'cuda' else {}
    total_us = sum(dev_us.values())
    n = flags.steps
    res['profiled_wall_ms_per_step'] = 1e3 * wall / n
    res['device_ms_per_step'] = total_us / 1e3 / n if total_us else None
    res['device_busy_share'] = total_us / 1e6 / wall if total_us else None
    res['kernel_device_ms_per_step'] = {
        name: sum(us for key, us in dev_us.items()
                  if all(sub in key for sub in subs)) / 1e3 / n
        if total_us else None for name, subs in KERNELS.items()}
    res['top_device_ms'] = {k: us / 1e3 / n for k, us in sorted(
        dev_us.items(), key=lambda kv: -kv[1])[:10]}
    log_fn(json.dumps(res))
    return res


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    add_model_flags(parser)
    add_train_flags(parser)
    parser.add_argument('--device', default='cuda',
                        help="torch device: 'cuda' (default) or 'cpu'")
    parser.add_argument('--seconds', type=float, default=16.0,
                        help='length of each synthetic utterance')
    parser.add_argument('--label_len', type=int, default=64,
                        help='token ids per utterance')
    parser.add_argument('--steps', type=int, default=5,
                        help='timed (and profiled) steps')
    parser.add_argument('--k8_slab_mb', type=float, default=None,
                        help="K8's slab scratch in MiB (default: the plan's "
                             'SLAB_BYTES)')
    return parser


def main(argv=None, log_fn=print):
    flags = parse_flags(build_parser(), sys.argv[1:] if argv is None
                        else argv)
    set_numerics()
    slab_bytes = joint_lse_plan.SLAB_BYTES
    if flags.k8_slab_mb is not None:
        joint_lse_plan.SLAB_BYTES = int(flags.k8_slab_mb * 2 ** 20)
    try:
        return profile(flags, resolve_device(flags.device), log_fn)
    finally:
        joint_lse_plan.SLAB_BYTES = slab_bytes


if __name__ == '__main__':
    main()
