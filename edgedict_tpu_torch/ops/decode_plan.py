"""The launch plan of K3, the greedy frame loop (csrc/greedy_decode.cu).

Each call is one cooperative launch of BLOCKS_PER_SM blocks on every SM.
Block g of G owns a balanced slice of the output columns of every product
(`split`): J of W_dec, V of W_out, the 4 gate columns of its hidden units
in each prediction-net LSTM layer, D of the projection.  It keeps those
weight slices in shared memory for all T frames, beside its own units'
(h, c) and h_dec columns for all B streams, a chunk of at most
STREAM_CHUNK streams' product outputs, the warps' partial sums and every
block's argmax partials for PART_CHUNK streams; the activations that
cross blocks go through a scratch the wrapper allocates.
`decode_plan` computes that layout (the same numbers as the kernel's
make_layout, which refuses a plan that disagrees), checks it fits one
block's shared memory and that the grid is co-resident on the card (the
blocks one SM holds at that size, from cudaOccupancyMaxActiveBlocksPer-
Multiprocessor through the query the recurrences' plans share), and raises
ValueError for a shape it cannot place.  There is no second path: a CUDA
tensor launches the kernel or raises.
"""

import dataclasses

from edgedict_tpu_torch.ops.rnn_bwd import SMEM_PER_BLOCK

MAX_LAYERS = 4            # csrc/greedy_decode.cu:kMaxLayers
WARPS = 8                 # 256 threads
SB, NC = 4, 16            # streams x columns of a warp pass
STREAM_CHUNK = 256        # streams through a product at a time
PART_CHUNK = 16           # streams whose partials are staged at once
BLOCKS_PER_SM = 1         # more blocks add barrier members, not SMs
NONE = 0xFFFF             # a partial's column offset: 16 bits


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    blocks: int           # the grid: BLOCKS_PER_SM on every SM
    stream_chunk: int     # streams through a product at a time
    cols: tuple           # the most (J, V, units of H, D) a block owns
    smem: int             # dynamic shared memory per block, bytes
    scratch_floats: int   # the cross-block activations, fp32
    barriers_blank: int   # grid barriers of a frame where no stream emits
    barriers_emit: int    # ... where one does


def split(n, g, blocks):
    """First column of block g's slice of n columns."""
    return n * g // blocks


def pitch(nc):
    """A weight slice's row in floats: whole float4s, off multiples of 8."""
    p = -(-nc // 4) * 4
    return p + 4 if p % 8 == 0 else p


def layout_floats(b, j, v, e, layers, hid, d, blocks, chunk):
    """→ (shared-memory floats per block, scratch floats): a chunk of
    streams' partials from every block, the weight slices, the own state of
    all b streams, the staged outputs of a chunk, the warps' partial sums
    and the tokens; the partials (16 bytes per block and stream), jh, and
    double-buffered h and h_dec."""
    cj, cv, cu, cd = (-(-n // blocks) for n in (j, v, hid, d))
    po = max(cv, 4 * cu, 1)
    smem = (4 * min(b, PART_CHUNK) * blocks + d * pitch(cj) + j * pitch(cv)
            + sum(((e if k == 0 else hid) + hid) * pitch(4 * cu)
                  for k in range(layers))
            + hid * pitch(cd) + 2 * layers * b * cu + b * cd + chunk * po
            + WARPS * SB * NC + b)
    scratch = 4 * blocks * b + b * j + 2 * layers * b * hid + 2 * b * d
    return smem, scratch


def decode_plan(b, j, v, e, layers, hid, d, n_sms, blocks_per_sm):
    """→ DecodePlan for b streams at joint width j, vocab v, embedding e,
    `layers` LSTM layers of hid units and projection d, on a card of n_sms
    SMs that holds `blocks_per_sm` such blocks each.  ValueError for an
    empty shape, more than MAX_LAYERS layers, a slice of V past 16-bit
    offsets, a block over the shared memory of one SM, or a grid that is
    not co-resident."""
    if min(b, j, v, e, layers, hid, d, n_sms) < 1 or layers > MAX_LAYERS:
        raise ValueError(f'greedy_decode: no plan for B={b} J={j} V={v} '
                         f'E={e} L={layers} H={hid} D={d}')
    blocks = BLOCKS_PER_SM * n_sms
    if -(-v // blocks) >= NONE:
        raise ValueError(f'greedy_decode: V={v} over {blocks} blocks needs '
                         f'column offsets past 16 bits')
    chunk = min(b, STREAM_CHUNK)
    smem, scratch = layout_floats(b, j, v, e, layers, hid, d, blocks, chunk)
    smem *= 4
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f'greedy_decode: B={b} J={j} V={v} H={hid} D={d} needs {smem} '
            f'bytes of shared memory per block, over {SMEM_PER_BLOCK}')
    if blocks_per_sm < BLOCKS_PER_SM:
        raise ValueError(
            f'greedy_decode: B={b} J={j} V={v} H={hid} D={d} needs '
            f'{BLOCKS_PER_SM} blocks of {smem} bytes on each SM; it holds '
            f'{blocks_per_sm}')
    cols = tuple(-(-n // blocks) for n in (j, v, hid, d))
    return DecodePlan(blocks, chunk, cols, smem, scratch, 2, 3 + layers)
