"""K9 + K10 — the RNN-T lattice alpha and beta+gradient (counterpart of
edgedict_tpu/ops/rnnt_loss_pallas.py; kernels in csrc/rnnt_loss.cu).

`rnnt_loss_core(blank_lp, label_lp, xlen, ylen)` → per-sample −logZ (B,)
is an autograd.Function whose forward is K9 (`lattice_alpha`) and whose
backward is K10 (`lattice_beta_grad`), the occupancies scaled by −g
outside.  CPU tensors take the plain versions in ops/rnnt_loss.py (row loop
over t, doubling over u); CUDA tensors launch the kernels.
"""

import torch

from edgedict_tpu_torch import _build
from edgedict_tpu_torch.ops.rnnt_loss import (
    lattice_alpha_plain, lattice_beta_grad_plain, make_core)


def _check(blank_lp, label_lp, xlen, ylen):
    _build.require_cuda(blank_lp, 'blank_lp', (torch.float32,))
    _build.require_cuda(label_lp, 'label_lp', (torch.float32,))
    _build.require_cuda(xlen, 'xlen', (torch.int32,))
    _build.require_cuda(ylen, 'ylen', (torch.int32,))
    b, t, u1 = blank_lp.shape
    if label_lp.shape != (b, t, u1 - 1) or xlen.shape != (b,) \
            or ylen.shape != (b,) or t < 1:
        raise ValueError(f'rnnt lattice: blank {tuple(blank_lp.shape)} label '
                         f'{tuple(label_lp.shape)} xlen {tuple(xlen.shape)} '
                         f'ylen {tuple(ylen.shape)}')
    return b, t, u1


def lattice_alpha(blank_lp, label_lp, xlen, ylen):
    """(blank (B,T,U+1), label (B,T,U) fp32, xlen/ylen (B,) int32) →
    (alpha (B, T+1, U+1), logz (B,)).  CUDA tensors launch K9."""
    if blank_lp.device.type == 'cpu':
        return lattice_alpha_plain(blank_lp, label_lp, xlen, ylen)
    blank_lp, label_lp = blank_lp.contiguous(), label_lp.contiguous()
    xlen, ylen = xlen.contiguous(), ylen.contiguous()
    b, t, u1 = _check(blank_lp, label_lp, xlen, ylen)
    dev = blank_lp.device
    alpha = torch.empty((b, t + 1, u1), dtype=torch.float32, device=dev)
    logz = torch.empty((b,), dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.check(_build.library().edd_lattice_alpha(
        p(blank_lp), p(label_lp), p(xlen), p(ylen), p(alpha), p(logz), b, t,
        u1, _build.stream_ptr(dev)), 'lattice_alpha')
    lattice_alpha.launches += 1
    return alpha, logz


lattice_alpha.launches = 0


def lattice_beta_grad(blank_lp, label_lp, alpha, logz, xlen, ylen):
    """→ (gb (B,T,U+1), gl (B,T,U)) transition occupancies.  CUDA tensors
    launch K10."""
    if blank_lp.device.type == 'cpu':
        return lattice_beta_grad_plain(blank_lp, label_lp, alpha, logz, xlen,
                                       ylen)
    blank_lp, label_lp = blank_lp.contiguous(), label_lp.contiguous()
    xlen, ylen = xlen.contiguous(), ylen.contiguous()
    b, t, u1 = _check(blank_lp, label_lp, xlen, ylen)
    _build.require_cuda(alpha, 'alpha', (torch.float32,))
    _build.require_cuda(logz, 'logz', (torch.float32,))
    if alpha.shape != (b, t + 1, u1) or logz.shape != (b,):
        raise ValueError(f'rnnt lattice: alpha {tuple(alpha.shape)} logz '
                         f'{tuple(logz.shape)}')
    dev = blank_lp.device
    beta = torch.empty_like(alpha)
    gb = torch.empty_like(blank_lp)
    gl = torch.empty_like(label_lp)
    p = _build.ptr
    _build.check(_build.library().edd_lattice_beta_grad(
        p(blank_lp), p(label_lp), p(alpha), p(logz), p(xlen), p(ylen),
        p(beta), p(gb), p(gl), b, t, u1, _build.stream_ptr(dev)),
        'lattice_beta_grad')
    lattice_beta_grad.launches += 1
    return gb, gl


lattice_beta_grad.launches = 0

rnnt_loss_core = make_core(lattice_alpha, lattice_beta_grad)
