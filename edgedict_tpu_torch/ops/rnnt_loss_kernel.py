"""K9 + K10 — the RNN-T lattice alpha and beta+gradient (counterpart of
edgedict_tpu/ops/rnnt_loss_pallas.py; kernels in csrc/rnnt_loss.cu).

`rnnt_loss_core(blank_lp, label_lp, xlen, ylen)` → per-sample −logZ (B,)
is an autograd.Function whose forward is K9 (`lattice_alpha`) and whose
backward is K10 (`lattice_beta_grad`), the occupancies scaled by −g
outside.  CPU tensors take the plain versions in ops/rnnt_loss.py (row loop
over t, doubling over u); CUDA tensors launch the kernels.

Both are register wavefronts (csrc/rnnt_loss.cu), K9 walking the
lattice's diagonals forwards and K10 backwards: alpha and beta live in
registers, one diagonal at a time, so a call allocates only its outputs,
with no (B, T+1, U+1) scratch.  `beta_plan` picks the block geometry of
both from U+1: W warps of 32 lanes, each lane owning K columns; U+1 up to
4096, a ValueError above.
"""

import dataclasses

import torch

from edgedict_tpu_torch import _build
from edgedict_tpu_torch.ops.rnnt_loss import (
    lattice_alpha_plain, lattice_beta_grad_plain, make_core)

MAX_WARPS = 16        # warps along u in one block (csrc: kMaxWarps)
RING = 32             # diagonals of edge values in flight between warps


@dataclasses.dataclass(frozen=True)
class BetaPlan:
    warps: int        # W: warps of one utterance's block, along u
    items: int        # K: columns a lane owns, u = 32 K w + 32 k + lane


def beta_plan(u1):
    """K9's and K10's geometry for U+1 = `u1` columns → BetaPlan: as many
    warps as it takes at one column a lane, up to 16 warps (512 columns;
    the warps run on the SM's four schedulers side by side, where one warp
    walking several columns a lane is bound by its own instruction
    latency), then 2, 4 and 8 columns a lane (1024, 2048, 4096).
    ValueError for no column or more than 4096."""
    if u1 >= 1:
        for items in (1, 2, 4, 8):
            warps = -(-u1 // (32 * items))
            if warps <= MAX_WARPS:
                return BetaPlan(warps, items)
    raise ValueError(f'rnnt lattice: no plan for U+1={u1} (1 to '
                     f'{32 * 8 * MAX_WARPS})')


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


@_build.on_tensor_device
def lattice_alpha(blank_lp, label_lp, xlen, ylen):
    """(blank (B,T,U+1), label (B,T,U) fp32, xlen/ylen (B,) int32) →
    (alpha (B, T+1, U+1), logz (B,)).  CUDA tensors launch K9 once (plan
    `beta_plan`)."""
    if blank_lp.device.type == 'cpu':
        return lattice_alpha_plain(blank_lp, label_lp, xlen, ylen)
    blank_lp, label_lp = blank_lp.contiguous(), label_lp.contiguous()
    xlen, ylen = xlen.contiguous(), ylen.contiguous()
    b, t, u1 = _check(blank_lp, label_lp, xlen, ylen)
    plan = beta_plan(u1)
    dev = blank_lp.device
    alpha = torch.empty((b, t + 1, u1), dtype=torch.float32, device=dev)
    logz = torch.empty((b,), dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.check(_build.library().edd_lattice_alpha(
        p(blank_lp), p(label_lp), p(xlen), p(ylen), p(alpha), p(logz), b, t,
        u1, plan.warps, plan.items, _build.stream_ptr(dev)), 'lattice_alpha')
    lattice_alpha.launches += 1
    return alpha, logz


lattice_alpha.launches = 0


@_build.on_tensor_device
def lattice_beta_grad(blank_lp, label_lp, alpha, logz, xlen, ylen):
    """→ (gb (B,T,U+1), gl (B,T,U)) transition occupancies.  CUDA tensors
    launch K10 once (plan `beta_plan`)."""
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
    plan = beta_plan(u1)
    gb = torch.empty_like(blank_lp)
    gl = torch.empty_like(label_lp)
    p = _build.ptr
    _build.check(_build.library().edd_lattice_beta_grad(
        p(blank_lp), p(label_lp), p(alpha), p(logz), p(xlen), p(ylen),
        p(gb), p(gl), b, t, u1, plan.warps, plan.items,
        _build.stream_ptr(blank_lp.device)), 'lattice_beta_grad')
    lattice_beta_grad.launches += 1
    return gb, gl


lattice_beta_grad.launches = 0

rnnt_loss_core = make_core(lattice_alpha, lattice_beta_grad)
