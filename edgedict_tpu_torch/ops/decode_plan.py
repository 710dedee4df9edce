"""The launch plan of K3, the greedy frame loop (csrc/greedy_decode.cu).

Each call is one cooperative launch of BLOCKS_PER_SM blocks on every SM.
Block g of G owns a balanced slice of the output columns of every product
(`split`): J of W_dec, V of W_out, the 4 gate columns of its hidden units
in each prediction-net LSTM layer, D of the projection.  It keeps those
weight slices in shared memory for all T frames, beside its own units'
(h, c) and h_dec columns for all B streams, a chunk of at most
STREAM_CHUNK streams' product outputs, the warps' partial sums and every
block's argmax partials for a chunk of at most PART_CHUNK streams; the
activations that cross blocks go through a scratch the wrapper allocates.

A weight slice's rows are whole float4s (`pitch`), their float4 columns
XOR-swizzled by row (`swizzle`), so the float4 reads of a warp's 8
neighbouring rows fall on 8 bank groups without padding the rows.  The
partials of min(B, PART_CHUNK) streams and min(B, STREAM_CHUNK) streams'
outputs are staged at once where they fit (E6D2 and E4D1 at every B up to
1024 on the H100's 132 SMs); else the partials' chunk shrinks first (a
stream's partials are 16 bytes from every block), by powers of two, and the
stream chunk takes the bytes left (`choose_chunks`).  E6D2_LARGE_Batch (2 x 512 prediction
net, projection 640) needs both: its slices are 180,224 bytes a block, and
with each row padded off multiples of 8 floats in place of the swizzle
they would be 234,496, over the 232,448 the card gives one.

`decode_plan` computes that layout (the same numbers as the kernel's
make_layout, which refuses a plan that disagrees), checks that the grid is
co-resident on the card (the blocks one SM holds at that size, from
cudaOccupancyMaxActiveBlocksPerMultiprocessor through the query the
recurrences' plans share), and raises ValueError for a shape it cannot
place.  There is no second path: a CUDA tensor launches the kernel or
raises.
"""

import dataclasses

from edgedict_tpu_torch.ops.rnn_bwd import SMEM_PER_BLOCK

MAX_LAYERS = 4            # csrc/greedy_decode.cu:kMaxLayers
WARPS = 8                 # 256 threads
SB, NC = 4, 16            # streams x columns of a warp pass
STREAM_CHUNK = 256        # streams through a product at a time
PART_CHUNK = 16           # streams whose partials are staged at once
MIN_CHUNK = WARPS * SB    # a product chunk that gives every warp a pass
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
    part_chunk: int       # streams whose partials are staged at once


def split(n, g, blocks):
    """First column of block g's slice of n columns."""
    return n * g // blocks


def pitch(nc):
    """A weight slice's row in floats: whole float4s."""
    return -(-nc // 4) * 4


def swizzle(p):
    """(shift, mask) of a weight slice's rows of p floats: float4
    column q of row k is stored at q ^ ((k >> shift) & mask).  With p / 4
    = 2^a x odd (a capped at 3), rows 2^(3-a) apart get different low a
    bits, so the 8 rows of one phase of a warp's float4 load (lanes along
    k) land on 8 different 16-byte bank groups; the XOR stays inside the
    row."""
    n4 = p // 4
    a = min((n4 & -n4).bit_length() - 1, 3)
    return 3 - a, (1 << a) - 1


def layout_floats(b, j, v, e, layers, hid, d, blocks, chunk, part_chunk=None):
    """→ (shared-memory floats per block, scratch floats): a chunk of
    streams' partials from every block (part_chunk streams, default
    min(b, PART_CHUNK)), the weight slices, the own state of all b
    streams, the staged outputs of a chunk, the warps' partial sums and
    the tokens; the partials (16 bytes per block and stream), jh, and
    double-buffered h and h_dec."""
    pc = min(b, PART_CHUNK) if part_chunk is None else part_chunk
    cj, cv, cu, cd = (-(-n // blocks) for n in (j, v, hid, d))
    po = max(cv, 4 * cu, 1)
    smem = (4 * pc * blocks + d * pitch(cj) + j * pitch(cv)
            + sum(((e if k == 0 else hid) + hid) * pitch(4 * cu)
                  for k in range(layers))
            + hid * pitch(cd) + 2 * layers * b * cu + b * cd
            + chunk * po + WARPS * SB * NC + b)
    scratch = 4 * blocks * b + b * j + 2 * layers * b * hid + 2 * b * d
    return smem, scratch


def choose_chunks(b, j, v, e, layers, hid, d, blocks):
    """→ (part_chunk, stream_chunk, smem floats, scratch floats): the
    largest partials' chunk of min(b, PART_CHUNK), 8, 4, 2, 1 that leaves
    room for a stream chunk of min(b, MIN_CHUNK) streams; the stream chunk
    min(b, STREAM_CHUNK) where it fits, else the most whole MIN_CHUNKs the
    bytes left hold.  ValueError naming the least bytes where none fits.
    Powers of two below PART_CHUNK: 8 streams' partials keep all 256
    threads of step 3 busy (32 lanes a stream), 12 only 192 (16 lanes);
    at E6D2_LARGE_Batch's B = 256 on one H100 (80GB HBM3, 700 W), (8, 160)
    ran 0.609 ms a frame against (12, 32)'s 0.633 and (4, 256)'s 0.718
    (cli/profile_kernels.py --only K3)."""
    limit = SMEM_PER_BLOCK // 4
    po = max(-(-v // blocks), 4 * -(-hid // blocks), 1)
    least = min(b, MIN_CHUNK)
    for pc in sorted({min(b, PART_CHUNK)} | {n for n in (8, 4, 2, 1)
                                             if n < min(b, PART_CHUNK)},
                     reverse=True):
        base, _ = layout_floats(b, j, v, e, layers, hid, d, blocks, 0, pc)
        room = (limit - base) // po
        chunk = min(b, STREAM_CHUNK)
        if chunk > room:
            chunk = room - room % MIN_CHUNK if room >= MIN_CHUNK else room
        if chunk >= least:
            smem, scratch = layout_floats(b, j, v, e, layers, hid, d, blocks,
                                          chunk, pc)
            return pc, chunk, smem, scratch
    smem, _ = layout_floats(b, j, v, e, layers, hid, d, blocks, least, 1)
    raise ValueError(
        f'greedy_decode: B={b} J={j} V={v} H={hid} D={d} needs {4 * smem} '
        f"bytes of shared memory per block (one stream's partials at a "
        f'time), over {SMEM_PER_BLOCK}')


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
    pc, chunk, smem, scratch = choose_chunks(b, j, v, e, layers, hid, d,
                                             blocks)
    smem *= 4
    if blocks_per_sm < BLOCKS_PER_SM:
        raise ValueError(
            f'greedy_decode: B={b} J={j} V={v} H={hid} D={d} needs '
            f'{BLOCKS_PER_SM} blocks of {smem} bytes on each SM; it holds '
            f'{blocks_per_sm}')
    cols = tuple(-(-n // blocks) for n in (j, v, hid, d))
    return DecodePlan(blocks, chunk, cols, smem, scratch, 2, 3 + layers, pc)
