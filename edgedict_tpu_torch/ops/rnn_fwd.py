"""The launch plan of K1, K5, K12 and K13, the recurrent forward
(csrc/rnn_fwd.cu; K12 / K13 the int8 LSTM / GRU, whose block dequantizes
its int8 slice of W_hh once into the same shared layout: their shared
memory is K1's / K5's at the compute dtype, their occupancy asked of their
own kernels).

Each call is one persistent cooperative launch whose block i owns UNITS
hidden units and holds the G·UNITS gate rows of W_hh that feed them (G·H
values per unit: G = 4 for the LSTM, 3 for the GRU) in shared memory for
all T steps, beside the warps' partial sums for a slab of 32 batch rows and
the carries of its (B x UNITS) cells.  The grid must be co-resident on the
card: `fwd_plan` checks that from numbers the wrapper reads off the card
(the SM count, and the blocks one SM holds at that shared-memory size from
cudaOccupancyMaxActiveBlocksPerMultiprocessor) and raises ValueError for a
shape outside the plan, with the checks and the cached occupancy query it
shares with K4/K6's plan (ops/rnn_bwd.py).  Its co-residency limit is
K4/K6's: ceil(H / UNITS) blocks, one or two per SM (H up to 1056 or 2112
on the H100's 132 SMs), so a hidden size whose backward is refused may be
refused here too.  There is no second path: a CUDA tensor launches the
kernel or raises.  `card_plan` caches each plan by (device, shape, dtype,
kernel): a call after the first reads no card property and asks no
occupancy.
"""

import dataclasses
import functools

import torch

from edgedict_tpu_torch import _build
from edgedict_tpu_torch.ops import rnn_bwd
from edgedict_tpu_torch.ops.rnn_bwd import SMEM_PER_BLOCK, THREADS, UNITS

WARPS = THREADS // 32
SLAB = THREADS // UNITS   # batch rows per pass
RED_LD = {4: 40, 3: 24}   # a partial-sum row, padded off bank conflicts


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    blocks: int           # the grid, UNITS hidden units per block
    smem: int             # dynamic shared memory per block, bytes
    blocks_per_sm: int    # such blocks one SM holds at once


def fwd_smem_bytes(hid, gates, batch, elem_bytes):
    """The block's shared memory: the W_hh slice (H rounded up to 32, x
    G·UNITS), the warps' partial sums for one slab of SLAB rows, and the
    carry of the block's (B x UNITS) cells."""
    k32 = -(-hid // 32) * 32
    return (k32 * gates * UNITS * elem_bytes
            + WARPS * SLAB * RED_LD[gates] * 4 + batch * UNITS * 4)


def fwd_plan(hid, gates, batch, elem_bytes, n_sms, blocks_per_sm):
    """→ FwdPlan for hidden size `hid`, `gates` = 4 (LSTM) or 3 (GRU),
    `batch` rows and elements of `elem_bytes`, on a card of `n_sms` SMs
    that holds `blocks_per_sm` such blocks each.  Raises ValueError when
    the slice does not fit one block's shared memory or the grid cannot
    be co-resident."""
    rnn_bwd.check_shape('rnn forward', hid, gates, batch, elem_bytes)
    smem = fwd_smem_bytes(hid, gates, batch, elem_bytes)
    return FwdPlan(rnn_bwd.resident_blocks('rnn forward', hid, gates, batch,
                                           smem, n_sms, blocks_per_sm),
                   smem, blocks_per_sm)


# the kernel of each (gates, quant): the `cell` of edd_rnn_fwd_blocks_per_sm
CELLS = {(4, False): 0, (3, False): 1, (4, True): 2, (3, True): 3}


def card_plan(x_proj, gates, quant=False):
    """The plan for x_proj (T, B, G·H) on its card; quant: the int8 kernel
    of the cell (K12 for the LSTM, K13 for the GRU)."""
    _, batch, gh = x_proj.shape
    return _card_plan(x_proj.device.index, gh // gates, gates, batch,
                      x_proj.element_size(), CELLS[gates, bool(quant)])


@functools.lru_cache(maxsize=None)
def _card_plan(index, hid, gates, batch, elem, cell):
    smem = fwd_smem_bytes(hid, gates, batch, elem)
    n = 0
    if smem <= SMEM_PER_BLOCK:
        n = rnn_bwd.card_blocks_per_sm('edd_rnn_fwd_blocks_per_sm', index,
                                       cell, elem == 2, smem)
    return fwd_plan(hid, gates, batch, elem,
                    _build.sm_count(torch.device('cuda', index)), n)
