"""The launch plans of K7 and K8's tensor-core kernels (csrc/joint_lse.cu,
bf16 with J and V multiples of 16).

The lattice of cells (b, t, u) is cut into tiles of TILE_CELLS = r_t x r_u
cells (r_t frames by r_u label slots, ragged T and U+1 masked); a tile's
cells are 64 consecutive "tile rows", cell (t0 + i // r_u, u0 + i % r_u) at
row i.  Both directions share one block product of GEMM_ROWS = 128 rows
(two tiles) x GEMM_COLS columns, a ring of STAGES cp.async stages BK deep.

K7, the forward (`fwd_plan`): a block takes two whole tiles.  Where their
h fits in shared memory beside one operand's ring (J rounded up to BK, + 8
bf16 of padding, x 128 rows: J up to 640), the block forms h itself (the
tiles' r_t f-rows and r_u g-rows loaded once, tanh once per cell) and
streams only W^T through the ring, GEMM_COLS columns at a time, folding
each chunk into a per-row online logsumexp and the two gathered logits:
one launch, no scratch.  Wider J stages h slab by slab through a bounded
scratch with the h launch K8 uses, and the same product reads it.

K8, the backward (`bwd_plan`): consecutive tiles (b-major, then t, then u)
form slabs of `slab_tiles` tiles, and each slab runs four launches over a
scratch that holds the slab alone:
  1. h: one block per tile loads its r_t f-rows and r_u g-rows once (H_COLS
     columns at a time) and writes h = tanh(f + g) in bf16 to the slab's
     (rows, J) scratch;
  2. dl: dlogits = the softmax gradient of h . W^T + bias (from the saved
     lse), a tiled product into the slab's (rows, V) bf16 scratch, with the
     column sums of the fp32 dlogits added to per-row-block dbias partials;
  3. dh: dlogits . W over the slab, 128 rows (two tiles) x 128 columns of J
     a block; da = dh (1 - h^2) with fp32 h, summed inside each tile over
     its r_u cells into df and over its r_t cells into dg (one atomic per
     tile and (b, t, k) or (b, u, k));
  4. dW: dW^T += h^T . dlogits, split over `dw_split` shares of the slab's
     rows, each share added to its own fp32 partial of dW^T.
One last launch sums the dW^T and dbias partials in a fixed order, so dW and
dbias are the same bits from run to run; df and dg take fp32 atomics.  The
scratch does not grow with B·T·U: the slab is cut to SLAB_BYTES.
`fwd_plan` and `bwd_plan` raise ValueError for a shape outside the plan;
the wrapper (ops/joint_lse_kernel.py) pads J and V to multiples of 16 and
routes fp32 to the CUDA-core kernels.
"""

import dataclasses

TILE_CELLS = 64           # lattice cells per tile (r_t x r_u)
H_COLS = 1024             # columns of f and g the h launch stages at a time
GEMM_ROWS = 128           # rows (two tiles) per block of the products
GEMM_COLS = 128           # columns per block of the products
BK = 64                   # depth of a product's shared-memory stage
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
    scratch_bytes: int    # h + dlogits of a slab, dW^T and dbias partials

    @property
    def slab_rows(self):
        return self.slab_tiles * TILE_CELLS


def tile_shape(t, u1):
    """(r_t, r_u), r_t * r_u = TILE_CELLS: of the shapes that pad the (T,
    U+1) lattice at most PAD_SLACK times the least padding, the one with the
    fewest df + dg atomics (r_t + r_u per tile and column), then the least
    padding."""
    shapes = [(TILE_CELLS >> k, 1 << k) for k in range(7)]
    padded = {s: -(-t // s[0]) * s[0] * -(-u1 // s[1]) * s[1] for s in shapes}
    least = min(padded.values())
    return min((s for s in shapes if padded[s] <= PAD_SLACK * least),
               key=lambda s: (s[0] + s[1], padded[s]))


def gemm_smem():
    """A product's cp.async ring: STAGES x (A + B) tiles of GEMM_ROWS x (BK
    + 8) bf16 (the widest of its two layouts)."""
    return STAGES * 2 * GEMM_ROWS * (BK + 8) * 2


def dw_split_count(j, v, n_sms, slab_rows):
    """Row shares of the dW product: as many as fill about two blocks per
    SM over the (J/128) x (V/128) output tiles, at least one, at most
    MAX_DW_SPLIT, each at least one BK-row stage."""
    out_tiles = -(-j // GEMM_COLS) * -(-v // GEMM_COLS)
    split = max(1, min(MAX_DW_SPLIT, 2 * n_sms // out_tiles))
    return max(1, min(split, slab_rows // BK))


def bwd_plan(b, t, u1, j, v, n_sms):
    """→ BwdPlan for the (b, t, u1) lattice at joint width j and vocab v on
    a card of n_sms SMs, slabs of at most SLAB_BYTES of h + dlogits (at
    least two tiles).  ValueError when the shape is empty or J or V is not
    a multiple of 16: every other shape fits a block's shared memory."""
    if min(b, t, u1, j, v) < 1 or j % 16 or v % 16:
        raise ValueError(f'joint_lse_bwd: no tensor-core plan for B={b} '
                         f'T={t} U+1={u1} J={j} V={v}')
    r_t, r_u = tile_shape(t, u1)
    n_tt, n_tu = -(-t // r_t), -(-u1 // r_u)
    tiles = b * n_tt * n_tu
    row_bytes = (j + v) * 2
    per_slab = max(2, SLAB_BYTES // (TILE_CELLS * row_bytes) // 2 * 2)
    slab_tiles = min(per_slab, tiles + tiles % 2)
    slab_rows = slab_tiles * TILE_CELLS
    dw_split = dw_split_count(j, v, n_sms, slab_rows)
    smem_h = (r_t + r_u) * min(j, H_COLS) * 2
    smem_dl = gemm_smem()
    smem_dh = max(gemm_smem(), GEMM_ROWS * (GEMM_COLS + 4) * 4)
    smem_dw = gemm_smem()
    scratch = (slab_rows * row_bytes + dw_split * j * v * 4
               + slab_tiles // 2 * v * 4)
    return BwdPlan(r_t, r_u, n_tt, n_tu, tiles, slab_tiles,
                   -(-tiles // slab_tiles), dw_split, smem_h, smem_dl,
                   smem_dh, smem_dw, scratch)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    r_t: int              # frames per tile
    r_u: int              # label slots per tile
    n_tt: int             # tiles along T
    n_tu: int             # tiles along U+1
    tiles: int            # B * n_tt * n_tu
    rows_per_block: int   # GEMM_ROWS: two tiles
    resident: bool        # h formed in shared memory (else slab scratch)
    ldh: int              # resident h's row, bf16 (0 when staged)
    blocks: int           # blocks of the product, over every slab
    waves: float          # blocks over the card's SMs (one block per SM)
    slab_tiles: int       # staged: tiles per slab (even); resident: tiles
    slabs: int
    smem: int             # dynamic shared memory of the product's block
    smem_h: int           # staged: of the h launch's block (else 0)
    scratch_bytes: int    # staged: the slab's h (else 0)


def resident_ldh(j):
    """The resident h's row in bf16: J rounded up to a whole BK-deep stage
    (the columns past J read as zero), + 8 against bank conflicts."""
    return -(-j // BK) * BK + 8


def fwd_smem_resident(j):
    """The resident block: 128 rows of h and one operand's ring (W^T)."""
    return (GEMM_ROWS * resident_ldh(j) + STAGES * GEMM_ROWS * (BK + 8)) * 2


def fwd_plan(b, t, u1, j, v, n_sms, staged=False):
    """→ FwdPlan for K7 on the (b, t, u1) lattice at joint width j and vocab
    v on a card of n_sms SMs: h resident in shared memory where it fits
    (and `staged` is False), else slabs of at most SLAB_BYTES of h.
    ValueError when the shape is empty or J or V is not a multiple of 16:
    every other shape has a plan."""
    if min(b, t, u1, j, v) < 1 or j % 16 or v % 16:
        raise ValueError(f'joint_lse_fwd: no tensor-core plan for B={b} '
                         f'T={t} U+1={u1} J={j} V={v}')
    r_t, r_u = tile_shape(t, u1)
    n_tt, n_tu = -(-t // r_t), -(-u1 // r_u)
    tiles = b * n_tt * n_tu
    resident = not staged and fwd_smem_resident(j) <= SMEM_PER_BLOCK
    if resident:
        slab_tiles, smem_h, scratch = tiles, 0, 0
        ldh, smem = resident_ldh(j), fwd_smem_resident(j)
    else:
        per_slab = max(2, SLAB_BYTES // (TILE_CELLS * j * 2) // 2 * 2)
        slab_tiles = min(per_slab, tiles + tiles % 2)
        smem_h = (r_t + r_u) * min(j, H_COLS) * 2
        scratch = slab_tiles * TILE_CELLS * j * 2
        ldh, smem = 0, gemm_smem()
    slabs = -(-tiles // slab_tiles)
    blocks = sum(-(-min(slab_tiles, tiles - s * slab_tiles) // 2)
                 for s in range(slabs))
    return FwdPlan(r_t, r_u, n_tt, n_tu, tiles, GEMM_ROWS, resident, ldh,
                   blocks, blocks / n_sms, slab_tiles, slabs, smem, smem_h,
                   scratch)


def tile_cells(plan, b, t, u1, tile):
    """(b, t, u, valid) of the TILE_CELLS rows of `tile`: the map every
    launch of the plan uses (cells past T, U+1 or B are not valid)."""
    tu = tile % plan.n_tu
    tt = tile // plan.n_tu % plan.n_tt
    bb = tile // (plan.n_tu * plan.n_tt)
    cells = []
    for i in range(TILE_CELLS):
        ct = tt * plan.r_t + i // plan.r_u
        cu = tu * plan.r_u + i % plan.r_u
        cells.append((bb, ct, cu, bb < b and ct < t and cu < u1))
    return cells
