"""Time K7 and K8 (the fused joint's forward and backward) on the card.

  python -m edgedict_tpu_torch.cli.profile_joint [--iters 10] [--plain]
      [--cases fwd32_eval,fwd32_raw,bwd32,fwd16,bwd16] [--tag X]

Cases, on seeded random inputs at E6D2's joint widths (J=640, V=2048):
  fwd32_raw   K7 fp32 at B=4 T=1437 U+1=33 (the raw fine-tune's eval)
  fwd32_eval  K7 fp32 at B=32 T=214 U+1=65 (the E6D2 trainer's eval)
  bwd32       K8 fp32 at B=32 T=214 U+1=65 (an E6D2 --bf16 false step)
  fwd16, bwd16  K7 / K8 bf16 at B=32 T=214 U+1=65 (the training step)
For each: `ms`, the median of CUDA-event timings of one wrapper call
(joint_lse_fwd / joint_lse_bwd, host work included) over --iters calls
after two warm-up calls; `max_err`, the largest |kernel - plain| over
max(1, |plain|) of the outputs (log-probs and lse, or the four gradients)
against the plain version on the same inputs; with --plain also
`plain_ms`, the plain version timed the same way (fused_joint_lse_plain
over the whole lattice; the backward: autograd through it, its forward
graph kept).  Prints one JSON line per case, then the card's
`nvidia-smi --query-gpu=name,power.limit` line.  Needs a CUDA card; only
the wrappers' public entry points are called, so a copy of the script runs
against any version of the port that has them (a parent commit, for turns).
"""

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

CASES = {'fwd32_raw': ('fwd', 4, 1437, 33, torch.float32),
         'fwd32_eval': ('fwd', 32, 214, 65, torch.float32),
         'bwd32': ('bwd', 32, 214, 65, torch.float32),
         'fwd16': ('fwd', 32, 214, 65, torch.bfloat16),
         'bwd16': ('bwd', 32, 214, 65, torch.bfloat16)}
J, V = 640, 2048


def _ms(fn, iters):
    for _ in range(2):
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


def _err(got, want):
    return max(float((a.float() - r.float()).abs().max())
               / max(1.0, float(r.float().abs().max()))
               for a, r in zip(got, want))


def run_case(name, iters, plain):
    from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
    kind, b, t, u1, dt = CASES[name]
    dev = torch.device('cuda')
    rng = np.random.RandomState(b + t + u1)

    def t_(*shape, scale=1.0):
        return torch.as_tensor((rng.randn(*shape) * scale).astype(np.float32),
                               device=dev)
    f, g = t_(b, t, J).to(dt), t_(b, u1, J).to(dt)
    w_t, bias = t_(J, V, scale=J ** -0.5), t_(V, scale=0.1)
    labels = torch.as_tensor(rng.randint(4, V, (b, u1 - 1)).astype(np.int32),
                             device=dev)
    wt_e = w_t.to(dt).contiguous()
    out = {'case': name, 'kernel': 'K7' if kind == 'fwd' else 'K8', 'B': b,
           'T': t, 'U1': u1, 'J': J, 'V': V,
           'dtype': str(dt).split('.')[-1]}
    leaves = [x.clone().requires_grad_() for x in (f, g, w_t, bias)]
    ref = KJ.fused_joint_lse_plain(*leaves, labels, 0)
    lse = KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0)[2]
    if kind == 'fwd':
        def kernel():
            return KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0)

        def plain_fn():
            with torch.no_grad():
                return KJ.fused_joint_lse_plain(f, g, w_t, bias, labels, 0)
        want = ref
        got = kernel()[:2]
    else:
        d_b, d_l = t_(b, t, u1, scale=0.1), t_(b, t, u1 - 1, scale=0.1)

        def kernel():
            return KJ.joint_lse_bwd(f, g, wt_e, bias, labels, 0, lse, d_b,
                                    d_l)

        def plain_fn():
            return torch.autograd.grad(ref, leaves, (d_b, d_l),
                                       retain_graph=True)
        want = plain_fn()
        got = kernel()
    torch.cuda.synchronize()
    out['max_err'] = _err(got, want)
    del got, want
    out['ms'] = _ms(kernel, iters)
    if plain:
        out['plain_ms'] = _ms(plain_fn, iters)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--plain', action='store_true',
                    help='also time the plain versions')
    ap.add_argument('--cases', default=','.join(CASES))
    ap.add_argument('--tag', default='', help='a label for every line')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_joint needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in args.cases.split(','):
        row = run_case(name, args.iters, args.plain)
        print(json.dumps({'tag': args.tag, **row}), flush=True)
        torch.cuda.empty_cache()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == '__main__':
    main()
