"""The launch plan of K2, the mel power featurizer (csrc/mel_power.cu).

One launch per call, for every n_fft from 64 to 2048 (even or odd), every
hop from 1 to n_fft.  The DFT is a register-tiled fp32 product of frames
(rows) by the window-folded table `MelTables.dft` (table_rows(n_fft),
2·table_pairs(n_fft)): columns [cos of pairs 0..P-1 | sin of pairs
0..P-1].  Pair p is bin p for the real_pairs(n_fft) = ceil(n_fft / 2)
pairs.  For even n_fft the sine column of bin 0 (zero: the DC bin has no
imaginary part) carries the cosine of the Nyquist bin n_fft / 2 (whose sine
is zero too), so the n_fft / 2 + 1 bins are n_fft / 2 pairs; odd n_fft has
no Nyquist bin, and its (n_fft + 1) / 2 bins are as many pairs, bin 0's
sine column zero.  The table is zero past its real pairs, up to a whole
number of pair groups (128), and past row n_fft, up to a whole number of
stages (128 rows): a zero pair has zero power and no mel reads it, a zero
row adds nothing.  So every pair group and every stage of rows is whole.

A block owns a tile of FRAMES consecutive frames of one batch row and a
slice of the bin pairs.  Its threads are (row groups × column groups ×
depth splits): a thread sums TILE_ROWS frames × TILE_PAIRS pairs (cos and
sin: 64 accumulators) over every `depth_split`-th row of the table, the
splits are added in order in shared memory, squared into the power tile
and projected onto the filterbank in the same block, each mel summed over
its band of nonzero weights among the real pairs only
(`MelTables.mel_band`).  The tile's frames are one contiguous span of the
reflect-padded row, staged once: (FRAMES - 1)·hop + the table rows the
product reads (n_fft rounded up to whole stages), read from the unpadded
audio through `reflect_index` and zero past the padded row.  The table's
slice streams through shared memory in chunks of `chunk_rows` rows
(cp.async, two stages).

Two splits, one kernel, chosen from the frame count and the SM count:
  * many frames (training): 64-frame tiles, 128 pairs a pass, every block
    runs all passes over the pairs and writes its mel tile itself (where
    its span fits one block's shared memory, else the few-frame split);
  * few frames (serving chunks): 8-frame tiles, 16 pairs a block and a
    64-way depth split; the blocks of a tile (one per 16 pairs) write
    partial mel tiles to a scratch, and the last of them to finish (a
    counter the same block resets) adds the partials in slice order: one
    launch, the same bits on every call.
`mel_plan` raises ValueError, naming what it refused, for a shape outside
the plan.
"""

import dataclasses

THREADS = 256
TILE_ROWS = 8            # frames per thread
TILE_PAIRS = 4           # bin pairs (cos and sin) per thread
STAGE_FLOATS = 4096      # one table stage: chunk_rows x 2·pairs floats
SMEM_PER_BLOCK = 232448  # the H100's most dynamic shared memory per block
MIN_FFT, MAX_FFT = 64, 2048
PAIR_GROUP = 128         # the table's pairs: a whole number of these
ROW_GROUP = 128          # the table's rows: a whole number of these
# (row groups, column groups, depth splits): the threads of a block
MANY = (8, 32, 1)
FEW = (1, 4, 64)


def real_pairs(n_fft):
    """The pairs that carry bins: n_fft / 2 (even: the Nyquist bin in
    pair 0), (n_fft + 1) / 2 (odd)."""
    return (n_fft + 1) // 2


def table_pairs(n_fft):
    """The pair table's pairs: real_pairs rounded up to PAIR_GROUP."""
    return -(-real_pairs(n_fft) // PAIR_GROUP) * PAIR_GROUP


def table_rows(n_fft):
    """The pair table's rows: n_fft rounded up to ROW_GROUP (every split's
    chunk_rows divides it)."""
    return -(-n_fft // ROW_GROUP) * ROW_GROUP


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
    frames, pairs = TILE_ROWS * rg, TILE_PAIRS * cg
    groups = -(-real_pairs(n_fft) // pairs)
    # a stage of 2·pairs columns; rows a multiple of the depth split
    chunk = min(STAGE_FLOATS // (2 * pairs), -(-n_fft // depth) * depth)
    span = (frames - 1) * hop + -(-n_fft // chunk) * chunk
    tiles_per_row = -(-n_frames // frames)
    tiles = batch * tiles_per_row
    slices = groups if split else 1
    passes = 1 if split else groups
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
    its 64-frame tiles alone fill the card and its span fits a block, else
    the few-frame split.  Raises ValueError, naming what it refused, for a
    shape outside the plan."""
    what = (f'mel_power: no plan for B={batch} L={length} n_fft={n_fft} '
            f'hop={hop} n_mels={n_mels}')
    if not MIN_FFT <= n_fft <= MAX_FFT:
        raise ValueError(f'{what}: n_fft outside {MIN_FFT}..{MAX_FFT}')
    if not 1 <= hop <= n_fft:
        raise ValueError(f'{what}: hop outside 1..n_fft')
    if batch < 1 or n_mels < 1:
        raise ValueError(f'{what}: no rows or no mels')
    if length <= n_fft // 2:
        raise ValueError(f'{what}: {length} samples cannot be reflect-padded '
                         f'by {n_fft // 2}')
    n_frames = frames_of(length, hop)
    if batch * -(-n_frames // (TILE_ROWS * MANY[0])) >= n_sms:
        plan = _layout(MANY, batch, n_frames, n_fft, hop, n_mels, False)
        if plan.smem <= SMEM_PER_BLOCK:
            return plan
    plan = _layout(FEW, batch, n_frames, n_fft, hop, n_mels, True)
    if plan.smem > SMEM_PER_BLOCK:
        raise ValueError(f'{what}: the few-frame split needs {plan.smem} '
                         f'bytes of shared memory per block, over '
                         f'{SMEM_PER_BLOCK}')
    return plan
