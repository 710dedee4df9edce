"""The launch plan of K2, the mel power featurizer (csrc/mel_power.cu).

One launch per call.  The DFT is a register-tiled fp32 product of frames
(rows) by the window-folded table `MelTables.dft` (n_fft, 2·NB), NB =
n_fft / 2 bin pairs: columns [cos of pairs 0..NB-1 | sin of pairs
0..NB-1], where pair p is bin p, except that the sine column of bin 0
(zero: the DC bin has no imaginary part) carries the cosine of the Nyquist
bin NB (whose sine is zero too).  So the n_fft / 2 + 1 bins are NB pairs of
columns and every pair is a whole 16-byte unit of the table.

A block owns a tile of FRAMES consecutive frames of one batch row and a
slice of the bin pairs.  Its threads are (row groups × column groups ×
depth splits): a thread sums TILE_ROWS frames × TILE_PAIRS pairs (cos and
sin: 64 accumulators) over every `depth_split`-th sample of the frame, the
splits are added in order in shared memory, squared into the power tile
and projected onto the filterbank in the same block, each mel summed over
its band of nonzero weights only (`MelTables.mel_band`).  The tile's frames
are one contiguous span of the reflect-padded row, staged once: (FRAMES -
1)·hop + n_fft samples, read from the unpadded audio through
`reflect_index`.  The table's
slice streams through shared memory in chunks of `chunk_rows` rows
(cp.async, two stages).

Two splits, one kernel, chosen from the frame count and the SM count:
  * many frames (training): 64-frame tiles, 128 pairs a pass, every block
    runs all NB / 128 passes and writes its mel tile itself (NB a multiple
    of 128, else the few-frame split);
  * few frames (serving chunks): 8-frame tiles, 16 pairs a block and a
    64-way depth split; the NB / 16 blocks of a tile write partial mel
    tiles to a scratch, and the last of them to finish (a counter the same
    block resets) adds the partials in slice order: one launch, the same
    bits on every call.
`mel_plan` raises ValueError for a shape outside the plan.
"""

import dataclasses

THREADS = 256
TILE_ROWS = 8            # frames per thread
TILE_PAIRS = 4           # bin pairs (cos and sin) per thread
STAGE_FLOATS = 4096      # one table stage: chunk_rows x 2·pairs floats
SMEM_PER_BLOCK = 232448  # the H100's most dynamic shared memory per block
# (row groups, column groups, depth splits): the threads of a block
MANY = (8, 32, 1)
FEW = (1, 4, 64)


@dataclasses.dataclass(frozen=True)
class MelPlan:
    split: bool           # few frames: slices folded by the last block
    row_groups: int
    col_groups: int
    depth_split: int
    frames: int           # frames per tile
    pairs: int            # bin pairs per pass
    passes: int           # passes per block
    slices: int           # blocks per tile (bin slices)
    chunk_rows: int       # table rows per stage
    tiles_per_row: int    # frame tiles per batch row
    tiles: int
    blocks: int
    span: int             # staged samples per tile
    smem: int             # dynamic shared memory per block, bytes
    scratch_floats: int   # partial mel tiles (split only)


def reflect_index(i, length, n_fft):
    """The sample of the unpadded row (length `length`) that index i of the
    row reflect-padded by n_fft // 2 per side holds (numpy / torch
    mode='reflect', no edge repeat); one reflection is exact because
    length > n_fft // 2."""
    j = i - n_fft // 2
    if j < 0:
        return -j
    if j >= length:
        return 2 * (length - 1) - j
    return j


def frames_of(length, hop):
    """Frames of a row of `length` samples (torch.stft center=True)."""
    return 1 + length // hop


def _layout(geometry, batch, n_frames, n_fft, hop, n_mels, split):
    rg, cg, depth = geometry
    nb = n_fft // 2
    frames, pairs = TILE_ROWS * rg, TILE_PAIRS * cg
    if nb % pairs:
        return None
    chunk = min(STAGE_FLOATS // (2 * pairs), n_fft)
    if n_fft % chunk or chunk % depth:
        return None
    span = (frames - 1) * hop + n_fft
    tiles_per_row = -(-n_frames // frames)
    tiles = batch * tiles_per_row
    slices = nb // pairs if split else 1
    passes = 1 if split else nb // pairs
    # the ring (two stages; then the splits' partials and the power tile),
    # the span, the block's mel tile and the Nyquist bin's power
    smem = 4 * (2 * STAGE_FLOATS + -(-span // 4) * 4 + frames * n_mels
                + frames)
    return MelPlan(split, rg, cg, depth, frames, pairs, passes, slices,
                   chunk, tiles_per_row, tiles, tiles * slices, span, smem,
                   tiles * slices * frames * n_mels if split else 0)


def mel_plan(batch, length, n_fft, hop, n_mels, n_sms):
    """→ MelPlan for audio (batch, length), an n_fft-point DFT at `hop`
    and `n_mels` mels on a card of `n_sms` SMs: the many-frame split where
    its 64-frame tiles alone fill the card, else the few-frame split.
    Raises ValueError for a shape outside the plan."""
    what = (f'mel_power: no plan for B={batch} L={length} n_fft={n_fft} '
            f'hop={hop} n_mels={n_mels}')
    if batch < 1 or hop < 1 or n_mels < 1 or n_fft < 64 or n_fft % 32:
        raise ValueError(f'{what} (n_fft a multiple of 32, at least 64)')
    if length <= n_fft // 2:
        raise ValueError(f'{what}: {length} samples cannot be reflect-padded '
                         f'by {n_fft // 2}')
    n_frames = frames_of(length, hop)
    plan = None
    if batch * -(-n_frames // (TILE_ROWS * MANY[0])) >= n_sms:
        plan = _layout(MANY, batch, n_frames, n_fft, hop, n_mels, False)
        if plan is not None and plan.smem > SMEM_PER_BLOCK:
            plan = None
    if plan is None:
        plan = _layout(FEW, batch, n_frames, n_fft, hop, n_mels, True)
    if plan is None or plan.smem > SMEM_PER_BLOCK:
        raise ValueError(f'{what}: over {SMEM_PER_BLOCK} bytes of shared '
                         'memory per block')
    return plan

