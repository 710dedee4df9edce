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
train step (B=32 T=214 U+1=65).  Prints one JSON line per case, then the
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
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--iters', type=int, default=50)
    ap.add_argument('--tag', default='', help='a label for every line')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_kernels: needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    for name, shape, fn in cases(dev):
        wall = _wall_ms(fn, args.iters)
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
