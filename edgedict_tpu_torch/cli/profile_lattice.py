"""Where K9's time goes: the lattice alpha kernel (csrc/rnnt_loss.cu) per
diagonal across U+1, and ablations of its walk.

  python -m edgedict_tpu_torch.cli.profile_lattice [--iters 50]

Each row is timed by CUDA events over --iters back-to-back launches of a
library's `edd_lattice_alpha` entry (no wrapper host work), the median of
15 such runs, on seeded inputs at B=32 T=214:
  * `sweep`: the shipped kernel at U+1 from 2 to 512 (xlen = T, ylen = U),
    one warp up to 32 columns and one more warp for each 32 after: ms per
    launch and µs per diagonal (T + U+1 of them).  From 32 to 33 columns
    the walk gains the inter-warp ring;
  * `ablation` at the E6D2 lattice (U+1 = 65, ragged lengths): copies of
    csrc/rnnt_loss.cu with one change to K9 each (ABLATIONS), built alone
    into edgedict_tpu_torch/_build/ablation/ and timed in turns (every
    variant, then every variant again in reverse order).  The changed
    kernels are not all correct; they show what each part of the walk
    costs.  Each row says whether the variant's alpha is bit-equal to the
    shipped kernel's.
Prints one JSON line per row, then the card's `nvidia-smi
--query-gpu=name,power.limit` line.  Needs a CUDA card and nvcc.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess

import numpy as np
import torch

from edgedict_tpu_torch import _build
from edgedict_tpu_torch.ops.rnnt_loss_kernel import beta_plan

# (old, new) edits of K9's part of csrc/rnnt_loss.cu (AlphaCell and
# lattice_alpha_kernel), each old text found there exactly once
ABLATIONS = {
    'shipped': (),
    'depth4': (('constexpr int P = 2;', 'constexpr int P = 4;'),),
    'no_fence': (
        ('        __threadfence_block();\n        edge =', '        edge ='),
        ('          __threadfence_block();\n          *static_cast',
         '          *static_cast')),
    'fp32_chain': (
        ('const double v = log_add_d(up + bm, left + lm);',
         'const float a_ = (float)up + bm, c_ = (float)left + lm;\n'
         '    const double v = fmaxf(a_, c_) + log1pf(expf(-fabsf(a_ - '
         'c_)));'),),
    'fast_log': (
        ('const double v = log_add_d(up + bm, left + lm);',
         'const double a_ = up + bm, c_ = left + lm;\n'
         '    const double v = fmax(a_, c_) + (double)__logf(1.f + '
         '__expf((float)(-fabs(a_ - c_))));'),),
    'no_store': (('al[ob_off[k] + U1] = v32;',
                  'if (v32 == 12345.f) al[ob_off[k] + U1] = v32;'),),
}


def k9_region(src):
    """(start, end) of K9's part of the source: AlphaCell and the kernel."""
    return (src.index('struct AlphaCell'),
            src.index('lattice_beta_grad_kernel(const float'))


def ablated_source(src, edits):
    """The source with `edits` applied inside K9's part; ValueError when an
    edit's old text is not there exactly once."""
    a, b = k9_region(src)
    part = src[a:b]
    for old, new in edits:
        if part.count(old) != 1:
            raise ValueError(f'ablation edit not found once in K9: {old!r}')
        part = part.replace(old, new)
    return src[:a] + part + src[b:]


def _build_ablation(name, src):
    out = os.path.join(_build.BUILD_DIR, 'ablation')
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, f'{name}.cu'), os.path.join(out, f'{name}.so')
    with open(cu, 'w') as f:
        f.write(src)
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, '-std=c++17',
                    '-O3', '-shared', '-Xcompiler', '-fPIC', '-o', so, cu],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(so).edd_lattice_alpha
    fn.argtypes = list(_build._SIGNATURES['edd_lattice_alpha'])
    fn.restype = ctypes.c_int
    return fn


def _inputs(rng, dev, b, t, u1, ragged):
    logits = torch.as_tensor(rng.randn(b, t, u1, 2).astype(np.float32),
                             device=dev)
    lp = logits - torch.logsumexp(logits, -1, keepdim=True)
    blank, label = lp[..., 0].contiguous(), lp[:, :, :-1, 1].contiguous()
    if ragged:      # the train step's draw (chip_smoke.py, profile_kernels)
        xlen = rng.randint(200, t + 1, b).astype(np.int32)
        ylen = rng.randint(40, u1, b).astype(np.int32)
    else:
        xlen = np.full(b, t, np.int32)
        ylen = np.full(b, u1 - 1, np.int32)
    return (blank, label, torch.as_tensor(xlen, device=dev),
            torch.as_tensor(ylen, device=dev))


def _timer(fn, inputs, iters):
    """(ms per launch, alpha, logz) of fn = an edd_lattice_alpha entry."""
    blank, label, xlen, ylen = inputs
    b, t, u1 = blank.shape
    alpha = torch.empty((b, t + 1, u1), device=blank.device)
    logz = torch.empty((b,), device=blank.device)
    plan = beta_plan(u1)
    p = _build.ptr
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(p(blank), p(label), p(xlen), p(ylen), p(alpha), p(logz), b,
                t, u1, plan.warps, plan.items, stream)
        if rc:
            raise RuntimeError(f'edd_lattice_alpha returned {rc}')
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    runs = []
    for _ in range(15):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs), alpha, logz


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--iters', type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_lattice: needs a CUDA card')
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    shipped = _build.library().edd_lattice_alpha
    b, t = 32, 214
    for u1 in (2, 16, 32, 33, 64, 65, 96, 97, 128, 129, 256, 512):
        ms, _, _ = _timer(shipped, _inputs(rng, dev, b, t, u1, False),
                          args.iters)
        print(json.dumps({'part': 'sweep', 'B': b, 'T': t, 'U1': u1,
                          'warps': beta_plan(u1).warps, 'ms': ms,
                          'us_per_diagonal': ms * 1e3 / (t + u1)}),
              flush=True)
    with open(os.path.join(_build.CSRC, 'rnnt_loss.cu')) as f:
        src = f.read()
    fns = {name: _build_ablation(name, ablated_source(src, edits))
           for name, edits in ABLATIONS.items()}
    inputs = _inputs(rng, dev, b, t, 65, True)
    times = {name: [] for name in fns}
    outs = {}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            ms, alpha, logz = _timer(fns[name], inputs, args.iters)
            times[name].append(ms)
            outs[name] = (alpha, logz)
    ref = outs['shipped']
    for name, ms in times.items():
        print(json.dumps({'part': 'ablation', 'variant': name, 'B': b,
                          'T': t, 'U1': 65, 'ms': ms,
                          'alpha_bit_equal': torch.equal(outs[name][0],
                                                         ref[0]),
                          'logz_max_abs_diff': float(
                              (outs[name][1] - ref[1]).abs().max())}),
              flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == '__main__':
    main()
