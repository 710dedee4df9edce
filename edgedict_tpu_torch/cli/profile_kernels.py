"""Time single kernel calls of the port on the card: wall and device ms.

  python -m edgedict_tpu_torch.cli.profile_kernels [--iters 50]

For each case, at the shape its main path gives it (seeded random inputs):
  * `wall_ms`: the median over --iters calls of CUDA events recorded just
    before and just after one call of the wrapper, the card idle before it,
    so the wrapper's host work (checks, plan, allocation, the launch)
    counts;
  * `device_ms`: the kernel time on the card per call, by torch.profiler
    over --iters calls (every kernel the call launched, the largest of 3
    profiled runs: the profiler has lost records on the card machine), and
    `launches_per_call`, the kernel records it saw per call;
  * `host_ms` = wall_ms - device_ms.
Cases: the persistent recurrences K1 (LSTM), K5 (GRU), K12 (int8 LSTM) and
K13 (int8 GRU) at H=1024 B=1 T=2 fp32 (a streaming chunk's layer), K12 and
K13 at B=64 T=2 (the int8 server) in fp32 and bf16 and at B=1 T=16, and
K9 (the lattice alpha) and K10 (the lattice beta + gradients) at the E6D2
train step (B=32 T=214 U+1=65), and K3 (the greedy frame loop; seeded
random weights, <unk> 3, no log-probs) at E6D2's joint and prediction net
and at E6D2_LARGE_Batch's (2 x 512 prediction net, projection 640): B=1
T=1 a streaming chunk, B=4 T=214 the eval batch at blank bias 1.8, the
servers' B=64 and B=256 at T=1; LARGE's B=256 also with its partials'
and stream chunks forced to (12, 32) and (4, 256), other splits that fit
its block beside the plan's (8, 160); and K2 (the mel power) with
E6D2's featurizer (n_fft 512, hop 200, 80 mels) and the flags' defaults'
(MFCC: n_fft 400, hop 200, 128 mels) at a streaming chunk (B=1; 1,320 and
1,400 samples), the 64-stream server's round, the defaults' train batch
(B=8 x 224,000) and E6D2's (B=32 x 256,000).  `--only K3` runs
the cases of the named kernels alone.  A case the port cannot plan prints
its error instead of times.  Prints one JSON line per case, then the
card's `nvidia-smi --query-gpu=name,power.limit` line.  Needs a CUDA card;
only the wrappers' public entry points are called, so the script runs
against any version of the port that has them.
"""

import argparse
import json
import statistics
import subprocess
from functools import partial

import numpy as np
import torch


def _wall_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, iters):
    """(device ms per call, kernel records per call): the largest of 3
    profiled runs."""
    from torch.profiler import ProfilerActivity, profile
    best = (0.0, 0.0)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = n = 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us += e.device_time_total
                n += e.count
        best = max(best, (us / 1e3 / iters, n / iters))
    return best


def cases(dev):
    """[(name, shape, fn)] with inputs made from a fixed seed."""
    from edgedict_tpu_torch.ops import gru_kernel as K5
    from edgedict_tpu_torch.ops import quant as Q
    from edgedict_tpu_torch.ops import rnn_kernel as K1
    from edgedict_tpu_torch.ops import rnnt_loss_kernel as KL
    rng = np.random.RandomState(0)

    def t_(*shape, scale=1.0, dtype=torch.float32):
        return torch.as_tensor((rng.randn(*shape) * scale)
                               .astype(np.float32), device=dev).to(dtype)
    out = []
    hid = 1024
    kw = hid ** -0.5
    for name, b, t, dt in [('K1', 1, 2, torch.float32),
                           ('K5', 1, 2, torch.float32),
                           ('K12', 1, 2, torch.float32),
                           ('K13', 1, 2, torch.float32),
                           ('K12', 64, 2, torch.float32),
                           ('K13', 64, 2, torch.float32),
                           ('K12', 64, 2, torch.bfloat16),
                           ('K13', 64, 2, torch.bfloat16),
                           ('K12', 1, 16, torch.float32),
                           ('K13', 1, 16, torch.float32)]:
        gates = 4 if name in ('K1', 'K12') else 3
        xp = t_(t, b, gates * hid, dtype=dt)
        w = torch.as_tensor(rng.uniform(-kw, kw, (gates * hid, hid))
                            .astype(np.float32), device=dev)
        b_hh, h0, c0 = t_(gates * hid, scale=0.1), t_(b, hid), t_(b, hid)
        q, sc = Q.quantize_int8(w)
        w = w.to(dt)
        fn = {'K1': partial(K1.lstm_recurrence, xp, w, h0, c0),
              'K5': partial(K5.gru_recurrence, xp, w, b_hh, h0),
              'K12': partial(Q.lstm_recurrence_q, xp, q, sc, h0, c0),
              'K13': partial(Q.gru_recurrence_q, xp, q, sc, b_hh, h0)}[name]
        out.append((name, {'H': hid, 'B': b, 'T': t,
                           'dtype': str(dt).split('.')[-1]}, fn))
    b, t, u1 = 32, 214, 65
    logits = t_(b, t, u1, 2)
    lp = logits - torch.logsumexp(logits, -1, keepdim=True)
    blank, label = lp[..., 0].contiguous(), lp[:, :, :-1, 1].contiguous()
    xlen = torch.as_tensor(rng.randint(200, t + 1, b).astype(np.int32),
                           device=dev)
    ylen = torch.as_tensor(rng.randint(40, u1, b).astype(np.int32),
                           device=dev)
    alpha, logz = KL.lattice_alpha(blank, label, xlen, ylen)
    out.append(('K9', {'B': b, 'T': t, 'U1': u1},
                partial(KL.lattice_alpha, blank, label, xlen, ylen)))
    out.append(('K10', {'B': b, 'T': t, 'U1': u1},
                partial(KL.lattice_beta_grad, blank, label, alpha, logz,
                        xlen, ylen)))
    for config, hid, d in (('E6D2', 256, 256),
                           ('E6D2_LARGE_Batch', 512, 640)):
        cache, state = _k3_model(dev, hid, d)
        for b, t, bias in ((1, 1, 0.0), (4, 214, 1.8), (64, 1, 0.0),
                           (256, 1, 0.0)):
            f = t_(t, b, 640)
            out.append(('K3', {'config': config, 'B': b, 'T': t,
                               'blank_bias': bias},
                        partial(_k3_call, cache[bias], f, *state(b))))
        if config == 'E6D2_LARGE_Batch':
            for chunks in ((12, 32), (4, 256)):
                out.append(('K3', {'config': config, 'B': b, 'T': t,
                                   'blank_bias': bias, 'chunks': chunks},
                            partial(_k3_forced, chunks, cache[bias], f,
                                    *state(b))))
    from edgedict_tpu_torch import features as F
    from edgedict_tpu_torch.ops import features_kernel as K2
    for config, cfg in (
            ('E6D2', F.FeatureConfig(feature_size=80, n_fft=512,
                                     win_length=320, hop_length=200)),
            ('defaults', F.FeatureConfig(feature_type='mfcc',
                                         feature_size=80, n_fft=400,
                                         win_length=400, hop_length=200,
                                         mfcc_n_mels=128))):
        tables = F.FeaturePipeline(cfg, dev).tables
        chunk = 1320 if cfg.n_fft == 512 else 1400
        for b, n in ((1, chunk), (64, chunk), (8, 224000), (32, 256000)):
            out.append(('K2', {'config': config, 'n_fft': cfg.n_fft, 'B': b,
                               'samples': n},
                        partial(K2.mel_power, t_(b, n, scale=0.1), tables)))
    return out


def _k3_model(dev, hid, d):
    """({blank bias: K3's decode cache}, state(b) → (h_dec, hs, cs)) of a
    seeded joint (J 640, V 2048) and 2-layer prediction net (E 64, hid
    units, projection d), blank lifted by 0 and by 1.8 (chip_smoke.py's
    eval case: most frames blank)."""
    from edgedict_tpu_torch.models import transducer as T
    from edgedict_tpu_torch.ops import decode_kernel as K3
    cfg = T.TransducerConfig(vocab_size=2048, vocab_embed_size=64,
                             enc_hidden_size=8, enc_layers=1,
                             enc_proj_size=640, dec_hidden_size=hid,
                             dec_layers=2, dec_proj_size=d, joint_size=640)
    caches = {}
    for bias in (0.0, 1.8):
        model = T.Transducer(cfg, device=dev, seed=1)
        with torch.no_grad():
            model.joint.out.bias[cfg.blank] += bias
        caches[bias] = K3.build_decode_cache(model)

    def state(b):
        with torch.no_grad():
            h_dec, (hs, cs) = T.decoder_apply(
                model.decoder, cfg,
                torch.zeros((b, 0), dtype=torch.long, device=dev))
        return h_dec[:, 0].contiguous(), hs, cs
    return caches, state


def _k3_call(cache, f, h_dec, hs, cs):
    from edgedict_tpu_torch.ops import decode_kernel as K3
    return K3.greedy_frame_loop(cache, f, h_dec, hs, cs, 0, 3)


def _k3_forced(chunks, cache, f, h_dec, hs, cs):
    """_k3_call on its plan with (partials' chunk, stream chunk) = chunks
    and the bytes layout_floats gives them; ValueError for a port whose
    plan has no partials' chunk."""
    import dataclasses

    from edgedict_tpu_torch.ops import decode_kernel as K3
    from edgedict_tpu_torch.ops import decode_plan as P
    plan = K3.card_plan(cache, f, hs)
    if not hasattr(plan, 'part_chunk'):
        raise ValueError('K3: this port stages every partial at once')
    pc, bc = chunks
    v, e = cache['table'].shape
    smem, scratch = P.layout_floats(
        f.shape[1], f.shape[2], v, e, hs.shape[0], hs.shape[2],
        cache['w_proj_t'].shape[1], plan.blocks, bc, pc)
    forced = dataclasses.replace(plan, part_chunk=pc, stream_chunk=bc,
                                 smem=4 * smem, scratch_floats=scratch)
    if forced.smem > P.SMEM_PER_BLOCK:
        raise ValueError(f'K3: chunks {chunks} need {forced.smem} bytes')
    planned, K3.card_plan = K3.card_plan, lambda *a: forced
    try:
        return _k3_call(cache, f, h_dec, hs, cs)
    finally:
        K3.card_plan = planned


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--iters', type=int, default=50)
    ap.add_argument('--tag', default='', help='a label for every line')
    ap.add_argument('--only', default='',
                    help='comma-separated kernels (K1, K3, ...) to time')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_kernels: needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    only = set(filter(None, args.only.split(',')))
    for name, shape, fn in cases(dev):
        if only and name not in only:
            continue
        try:
            wall = _wall_ms(fn, args.iters)
        except ValueError as e:            # no plan for this shape
            print(json.dumps({'tag': args.tag, 'kernel': name, **shape,
                              'error': str(e)}), flush=True)
            continue
        device, launches = _device_ms(fn, args.iters)
        print(json.dumps({'tag': args.tag, 'kernel': name, **shape,
                          'wall_ms': wall, 'device_ms': device,
                          'host_ms': wall - device,
                          'launches_per_call': launches}), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == '__main__':
    main()
