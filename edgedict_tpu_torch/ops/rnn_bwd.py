"""The launch plan of K4 and K6, the recurrent backward (csrc/rnn_bwd.cu).

Each call is two launches: the gate remat, one product over all steps into
an fp32 scratch (T, B, G·H), then the dh chain, one persistent cooperative
kernel whose block i owns UNITS hidden units and holds its column slice of
W_hh (G·H x UNITS) in shared memory for all T steps.  The chain's grid must
be co-resident on the card: `chain_plan` checks that from numbers the
wrapper reads off the card (the SM count, and the blocks one SM holds at
that shared-memory size from cudaOccupancyMaxActiveBlocksPerMultiprocessor)
and raises ValueError for a shape outside the plan.  There is no second
path: a CUDA tensor launches the kernels or raises.
"""

import ctypes
import dataclasses
import functools

import torch

from edgedict_tpu_torch import _build

UNITS = 8                 # hidden units per chain block (the mma's N)
THREADS = 256
WARPS = THREADS // 32
SMEM_PER_BLOCK = 232448   # the H100's most dynamic shared memory per block


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    blocks: int           # the chain's grid, UNITS hidden units per block
    smem: int             # dynamic shared memory per block, bytes


def chain_smem_bytes(hid, gates, batch, elem_bytes):
    """The chain block's shared memory: the W_hh slice (G·H rounded up to
    32, x UNITS), the warps' partial sums for 32 batch rows, and dh and
    the carry for the block's (B x UNITS)."""
    k32 = -(-gates * hid // 32) * 32
    return (k32 * UNITS * elem_bytes + WARPS * 32 * UNITS * 4
            + 2 * batch * UNITS * 4)


def check_shape(what, hid, gates, batch, elem_bytes):
    """ValueError, naming `what` and the shape, for a shape no persistent
    recurrence kernel (this module's chain, ops/rnn_fwd.py's forward)
    takes."""
    if hid < 1 or batch < 1 or gates not in (3, 4) \
            or elem_bytes not in (2, 4):
        raise ValueError(f'{what}: no plan for H={hid} B={batch} '
                         f'G={gates} elem_bytes={elem_bytes}')


def resident_blocks(what, hid, gates, batch, smem_bytes, n_sms,
                    blocks_per_sm):
    """→ the grid of a persistent recurrence kernel: ceil(hid / UNITS)
    blocks of `smem_bytes` each, checked to fit one block's shared memory
    and to be co-resident on a card of `n_sms` SMs holding `blocks_per_sm`
    of them.  ValueError, naming `what` and the shape, otherwise."""
    blocks = -(-hid // UNITS)
    if smem_bytes > SMEM_PER_BLOCK:
        raise ValueError(
            f'{what}: H={hid} B={batch} G={gates} needs {smem_bytes} bytes '
            f'of shared memory per block, over {SMEM_PER_BLOCK}')
    if blocks > n_sms * blocks_per_sm:
        raise ValueError(
            f'{what}: H={hid} B={batch} G={gates} needs {blocks} '
            f'co-resident blocks; the card holds {n_sms} x {blocks_per_sm}')
    return blocks


def chain_plan(hid, gates, batch, elem_bytes, n_sms, blocks_per_sm):
    """→ ChainPlan for hidden size `hid`, `gates` = 4 (LSTM) or 3 (GRU),
    `batch` rows and elements of `elem_bytes`, on a card of `n_sms` SMs
    that holds `blocks_per_sm` such blocks each.  Raises ValueError when
    the slice does not fit one block's shared memory or the grid cannot
    be co-resident."""
    check_shape('rnn backward', hid, gates, batch, elem_bytes)
    smem = chain_smem_bytes(hid, gates, batch, elem_bytes)
    return ChainPlan(resident_blocks('rnn backward', hid, gates, batch, smem,
                                     n_sms, blocks_per_sm), smem)


@functools.lru_cache(maxsize=None)
def card_blocks_per_sm(entry, device_index, cell, bf16, smem_bytes):
    """How many blocks of `smem_bytes` the kernel behind the C entry
    `entry` (edd_rnn_bwd_blocks_per_sm, edd_rnn_fwd_blocks_per_sm, ...)
    for `cell` (its first argument: 0 the LSTM, 1 the GRU, 2 and 3 the
    forward's int8 LSTM and GRU) fits on one SM of the card, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor; cached per shape, off
    the host path of every call."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _build.check(getattr(_build.library(), entry)(
            cell, int(bf16), smem_bytes, ctypes.addressof(out)), entry)
    return out.value


def card_plan(x_proj, gates):
    """The plan for x_proj (T, B, G·H) on its card."""
    _, batch, gh = x_proj.shape
    hid = gh // gates
    elem = x_proj.element_size()
    smem = chain_smem_bytes(hid, gates, batch, elem)
    dev = x_proj.device
    n = 0
    if smem <= SMEM_PER_BLOCK:
        n = card_blocks_per_sm('edd_rnn_bwd_blocks_per_sm', dev.index,
                               int(gates == 3), elem == 2, smem)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return chain_plan(hid, gates, batch, elem, sms, n)
