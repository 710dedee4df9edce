"""The launch plans of K7 and K8 (csrc/joint_lse.cu), bf16 on the tensor
cores and fp32 on the CUDA cores, with J and V multiples of 16 (the wrapper
pads them).  Each plan takes the element size: 2 (bf16) or 4 (fp32).

The lattice of cells (b, t, u) is cut into tiles of TILE_CELLS = r_t x r_u
cells (r_t frames by r_u label slots, ragged T and U+1 masked); a tile's
cells are 64 consecutive "tile rows", cell (t0 + i // r_u, u0 + i % r_u) at
row i.  Every product is one block product of 8 warps fed by a ring of
STAGES cp.async stages: bf16 (mma.sync) BK deep, fp32 (register-tiled
FFMA, a thread 8 x 8 outputs) BK_F32 deep in K7 and BK8_F32 in K8.

K7, the forward (`fwd_plan`): a block takes whole tiles, bf16 two lattice
tiles (GEMM_ROWS rows, GEMM_COLS columns a chunk), fp32 one "flat" tile of
TILE_CELLS consecutive cells in (b, t, u) order (FFMA_COLS columns a chunk;
r_t = r_u = 0 in its plan).  Where their h fits in shared memory beside
W^T's ring (bf16 J up to 640, fp32 up to 704), the block forms h itself
(the tiles' r_t f-rows and r_u g-rows loaded once, tanh once per cell) and
streams only W^T through the ring, a chunk of columns at a time, folding
each chunk into a per-row online logsumexp and the two gathered logits: one
launch, no scratch.  Wider J stages h slab by slab through a bounded
scratch with the h launch K8 uses (fp32: of the flat tiles), and the same
product reads it.
bf16 takes K8's tile shape.  fp32 has no df / dg for a tile to sum, so
nothing gains from a tile's shared f and g rows, and a lattice tile's
padding (6.3 % of the rows at the E6D2 eval, T=214 U+1=65) would be work.

K8, the backward (`bwd_plan`): lattice tiles (bf16 the fewest df / dg
partial rows within PAD_SLACK of the least padding, fp32 the least
padding); consecutive tiles (b-major, then t, then u) form slabs of
`slab_tiles` tiles, and each slab runs four steps over a scratch that holds
the slab alone, in the input dtype:
  1. h: one block per tile loads its r_t f-rows and r_u g-rows once
     (h_cols(elem) columns at a time) and writes h = tanh(f + g) to the
     slab's (rows, J) scratch;
  2. dl: dlogits = the softmax gradient of h . W^T + bias (from the saved
     lse), a tiled product into the slab's (rows, V) scratch, with the
     column sums of the fp32 dlogits added to per-row-block dbias partials;
  3. dh: dlogits . W over the slab, 128 rows (two tiles) x 128 columns of J
     a block; da = dh (1 - h^2) with fp32 h, summed inside each tile over
     its r_u cells and over its r_t cells into the slab's (slab_tiles (r_t
     + r_u), J) fp32 partials, then added to df and dg in tile order by a
     sum launch (one writer per element and slab);
  4. dW: dW^T += h^T . dlogits, split over `dw_split` shares of the slab's
     rows, each share added to its own fp32 partial of dW^T.
One last launch sums the dW^T and dbias partials in a fixed order.  No
atomics: df, dg, dW and dbias are the same bits from run to run.  The
scratch does not grow with B·T·U: the slab is cut to SLAB_BYTES.
`fwd_plan` and `bwd_plan` raise ValueError for a shape outside the plan.
"""

import dataclasses

TILE_CELLS = 64           # lattice cells per tile (r_t x r_u)
H_COLS = 1024             # bf16 columns of f and g the h launch stages at once
GEMM_ROWS = 128           # rows (two tiles) per block of K8's products
GEMM_COLS = 128           # columns per block of K8's products (bf16 K7's too)
BK = 64                   # depth of a bf16 product's shared-memory stage
BK_F32 = 16               # depth of fp32 K7's stage (beside a resident h)
BK8_F32 = 32              # depth of fp32 K8's product stages
FFMA_COLS = 256           # columns per chunk of fp32 K7 (one tile of rows)
STAGES = 3                # cp.async ring of the products
SMEM_PER_BLOCK = 232448   # the H100's most dynamic shared memory per block
SLAB_BYTES = 128 << 20    # the slab's h + dlogits scratch, at most
MAX_DW_SPLIT = 8
PAD_SLACK = 1.25          # padding a squarer tile may add (tile_shape)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    r_t: int              # frames per tile
    r_u: int              # label slots per tile
    n_tt: int             # tiles along T
    n_tu: int             # tiles along U+1
    tiles: int            # B * n_tt * n_tu
    slab_tiles: int       # tiles per slab (even: whole 128-row blocks)
    slabs: int
    dw_split: int         # row shares of the dW product per slab
    smem_h: int           # dynamic shared memory per block, bytes
    smem_dl: int
    smem_dh: int
    smem_dw: int
    scratch_bytes: int    # a slab's h + dlogits and df / dg partials, the
    #                       dW^T and dbias partials

    @property
    def slab_rows(self):
        return self.slab_tiles * TILE_CELLS


def tile_shape(t, u1, slack=PAD_SLACK):
    """(r_t, r_u), r_t * r_u = TILE_CELLS: of the shapes that pad the (T,
    U+1) lattice at most `slack` times the least padding, the one with the
    fewest df + dg partial rows (r_t + r_u per tile), then the least
    padding."""
    shapes = [(TILE_CELLS >> k, 1 << k) for k in range(7)]
    padded = {s: -(-t // s[0]) * s[0] * -(-u1 // s[1]) * s[1] for s in shapes}
    least = min(padded.values())
    return min((s for s in shapes if padded[s] <= slack * least),
               key=lambda s: (s[0] + s[1], padded[s]))


def _check_elem(elem):
    if elem not in (2, 4):
        raise ValueError(f'joint_lse: element size {elem}, not 2 (bf16) or '
                         '4 (fp32)')


def h_cols(elem=2):
    """Columns of f and g the h launch stages at a time (2 KB of a row)."""
    return H_COLS * 2 // elem


def gemm_smem(elem=2, a_km=False):
    """A K8 product's cp.async ring: bf16 STAGES x (A + B) tiles of
    GEMM_ROWS x (BK + 8) (the widest of its two layouts); fp32 STAGES x (A:
    GEMM_ROWS x (BK8_F32 + 4) stored [m][k], or BK8_F32 x GEMM_ROWS stored
    [k][m] (a_km, the dW product), + B: BK8_F32 x GEMM_COLS)."""
    if elem == 2:
        return STAGES * 2 * GEMM_ROWS * (BK + 8) * 2
    a = BK8_F32 * GEMM_ROWS if a_km else GEMM_ROWS * (BK8_F32 + 4)
    return STAGES * (a + BK8_F32 * GEMM_COLS) * 4


def dw_split_count(j, v, n_sms, slab_rows):
    """Row shares of the dW product: as many as fill about two blocks per
    SM over the (J/128) x (V/128) output tiles, at least one, at most
    MAX_DW_SPLIT, each at least one BK-row stage."""
    out_tiles = -(-j // GEMM_COLS) * -(-v // GEMM_COLS)
    split = max(1, min(MAX_DW_SPLIT, 2 * n_sms // out_tiles))
    return max(1, min(split, slab_rows // BK))


def bwd_plan(b, t, u1, j, v, n_sms, elem=2):
    """→ BwdPlan for the (b, t, u1) lattice at joint width j and vocab v on
    a card of n_sms SMs, in elements of `elem` bytes (2: bf16, 4: fp32),
    slabs of at most SLAB_BYTES of h + dlogits (at least two tiles).
    ValueError when the shape is empty or J or V is not a multiple of 16:
    every other shape fits a block's shared memory."""
    _check_elem(elem)
    if min(b, t, u1, j, v) < 1 or j % 16 or v % 16:
        raise ValueError(f'joint_lse_bwd: no plan for B={b} T={t} U+1={u1} '
                         f'J={j} V={v}')
    # fp32: the products run on the CUDA cores, where padded rows cost more
    # than the df / dg partials a squarer tile saves
    r_t, r_u = tile_shape(t, u1) if elem == 2 else tile_shape(t, u1, 1.0)
    n_tt, n_tu = -(-t // r_t), -(-u1 // r_u)
    tiles = b * n_tt * n_tu
    row_bytes = (j + v) * elem
    per_slab = max(2, SLAB_BYTES // (TILE_CELLS * row_bytes) // 2 * 2)
    slab_tiles = min(per_slab, tiles + tiles % 2)
    slab_rows = slab_tiles * TILE_CELLS
    dw_split = dw_split_count(j, v, n_sms, slab_rows)
    smem_h = (r_t + r_u) * min(j, h_cols(elem)) * elem
    smem_dl = max(gemm_smem(elem),
                  GEMM_ROWS * (GEMM_COLS + 16 // elem) * elem
                  + 2 * GEMM_COLS * 4)
    smem_dh = max(gemm_smem(elem), GEMM_ROWS * (GEMM_COLS + 4) * 4)
    smem_dw = gemm_smem(elem, a_km=True)
    scratch = (slab_rows * row_bytes + dw_split * j * v * 4
               + slab_tiles // 2 * v * 4 + slab_tiles * (r_t + r_u) * j * 4)
    return BwdPlan(r_t, r_u, n_tt, n_tu, tiles, slab_tiles,
                   -(-tiles // slab_tiles), dw_split, smem_h, smem_dl,
                   smem_dh, smem_dw, scratch)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    r_t: int              # frames per tile (0: flat tiles, fp32)
    r_u: int              # label slots per tile (0: flat tiles)
    n_tt: int             # tiles along T (0: flat)
    n_tu: int             # tiles along U+1 (0: flat)
    tiles: int            # B * n_tt * n_tu, or B * T * U+1 / 64 rounded up
    rows_per_block: int   # bf16 GEMM_ROWS (two tiles), fp32 TILE_CELLS (one)
    resident: bool        # h formed in shared memory (else slab scratch)
    ldh: int              # resident h's row, in elements (0 when staged)
    blocks: int           # blocks of the product, over every slab
    waves: float          # blocks over the card's SMs (one block per SM)
    slab_tiles: int       # staged: tiles per slab (whole blocks); resident:
    #                       all tiles
    slabs: int
    smem: int             # dynamic shared memory of the product's block
    smem_h: int           # staged: of the h launch's block (else 0)
    scratch_bytes: int    # staged: the slab's h (else 0)


def resident_ldh(j, elem=2):
    """The resident h's row in elements: bf16 J rounded up to a whole
    BK-deep stage (the columns past J read as zero), + 8 against bank
    conflicts; fp32 J rounded up to BK_F32, + 4 (an odd number of 16-byte
    words: the 8 rows a warp reads at once fall in distinct banks)."""
    if elem == 2:
        return -(-j // BK) * BK + 8
    return -(-j // BK_F32) * BK_F32 + 4


def fwd_smem_resident(j, elem=2):
    """The resident block: bf16 128 rows of h and one operand's ring (W^T);
    fp32 64 rows of h and W^T's ring of BK_F32 x FFMA_COLS stages."""
    if elem == 2:
        return (GEMM_ROWS * resident_ldh(j) + STAGES * GEMM_ROWS * (BK + 8)) \
            * 2
    return (TILE_CELLS * resident_ldh(j, 4)
            + STAGES * BK_F32 * FFMA_COLS) * 4


def fwd_smem_staged(elem=2):
    """The product's block where h comes from the scratch: bf16 a K8
    product's ring; fp32 STAGES x (64 rows x (BK_F32 + 4) of h + BK_F32 x
    FFMA_COLS of W^T)."""
    if elem == 2:
        return gemm_smem()
    return STAGES * (TILE_CELLS * (BK_F32 + 4) + BK_F32 * FFMA_COLS) * 4


def fwd_plan(b, t, u1, j, v, n_sms, staged=False, elem=2):
    """→ FwdPlan for K7 on the (b, t, u1) lattice at joint width j and vocab
    v on a card of n_sms SMs, in elements of `elem` bytes (2: bf16, 4:
    fp32): h resident in shared memory where it fits (and `staged` is
    False), else slabs of at most SLAB_BYTES of h.  ValueError when the
    shape is empty or J or V is not a multiple of 16: every other shape has
    a plan."""
    _check_elem(elem)
    if min(b, t, u1, j, v) < 1 or j % 16 or v % 16:
        raise ValueError(f'joint_lse_fwd: no plan for B={b} T={t} U+1={u1} '
                         f'J={j} V={v}')
    per_block = 2 if elem == 2 else 1        # tiles a block takes
    if elem == 2:
        r_t, r_u = tile_shape(t, u1)
        n_tt, n_tu = -(-t // r_t), -(-u1 // r_u)
        tiles = b * n_tt * n_tu
    else:
        r_t = r_u = n_tt = n_tu = 0
        tiles = -(-b * t * u1 // TILE_CELLS)
    resident = not staged and fwd_smem_resident(j, elem) <= SMEM_PER_BLOCK
    if resident:
        slab_tiles, smem_h, scratch = tiles, 0, 0
        ldh, smem = resident_ldh(j, elem), fwd_smem_resident(j, elem)
    else:
        per_slab = max(per_block, SLAB_BYTES // (TILE_CELLS * j * elem)
                       // per_block * per_block)
        slab_tiles = min(per_slab, -(-tiles // per_block) * per_block)
        smem_h = (r_t + r_u) * min(j, h_cols(elem)) * elem   # fp32: 0
        scratch = slab_tiles * TILE_CELLS * j * elem
        ldh, smem = 0, fwd_smem_staged(elem)
    slabs = -(-tiles // slab_tiles)
    blocks = sum(-(-min(slab_tiles, tiles - s * slab_tiles) // per_block)
                 for s in range(slabs))
    return FwdPlan(r_t, r_u, n_tt, n_tu, tiles, per_block * TILE_CELLS,
                   resident, ldh, blocks, blocks / n_sms, slab_tiles, slabs,
                   smem, smem_h, scratch)


def tile_cells(plan, b, t, u1, tile):
    """(b, t, u, valid) of the TILE_CELLS rows of `tile`: the map every
    launch of the plan uses (cells past T, U+1 or B are not valid; a flat
    tile's rows are the cells 64 tile .. in (b, t, u) order)."""
    if plan.r_t == 0:
        cells = []
        for m in range(tile * TILE_CELLS, (tile + 1) * TILE_CELLS):
            cells.append((m // (t * u1), m // u1 % t, m % u1, m < b * t * u1))
        return cells
    tu = tile % plan.n_tu
    tt = tile // plan.n_tu % plan.n_tt
    bb = tile // (plan.n_tu * plan.n_tt)
    cells = []
    for i in range(TILE_CELLS):
        ct = tt * plan.r_t + i // plan.r_u
        cu = tu * plan.r_u + i % plan.r_u
        cells.append((bb, ct, cu, bb < b and ct < t and cu < u1))
    return cells
