"""K7 on the CPU: its launch plans (ops/joint_lse_plan.py fwd_plan, bf16 on
the tensor cores and fp32 on the CUDA cores) and its algorithm written out
in PyTorch.

The plan: every tile pair of a block lies in one slab, the lattice tiles
cover every cell once, the block fits the H100's shared memory (h resident
up to J = 640, staged through a bounded scratch above or on request),
shapes outside the plan raise ValueError.

The algorithm (`_fwd_model`, fp32): the wrapper's pad16 (zero columns of J,
-inf bias on padded vocab columns), then per block of two lattice tiles h
formed once per cell from the tiles' f-rows and g-rows, 128-column chunks
of h . W^T + bias with -inf past V, each thread's 8 columns of a chunk
folded into a running (max, sum of exp) and the blank / label logits, and
at the end the 4 lanes and the 4 column warps of a row merged in the
kernel's order.  It is held to 1e-5 against fused_joint_lse_plain and
against the JAX package's Pallas forward in interpret mode, both the
column-blocked _fwd_kernel_split (EDGEDICT_JOINT_FWD_COLS=128) and the
whole-V _fwd_kernel, including J, V not multiples of 16, U = 0 and labels
equal to blank.  The fp32 plan's model (64 consecutive cells a block,
256-column chunks, the FFMA threads' columns, 8 column warps) is held to
the same versions at rtol 1e-4 / atol 1e-5, with a chunk whose columns are
all -inf (a vocabulary slice's sentinel, padding), V not a multiple of 128
and U+1 = 1; its plan covers every cell once, fits the card at J = 640 and
1000 and raises outside the plan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgedict_tpu.ops import joint_lse_pallas
from edgedict_tpu_torch.ops import joint_lse_kernel as K
from edgedict_tpu_torch.ops import joint_lse_plan as P

H100_SMS = 132
NEG = float('-inf')


def _merge(m, s, m2, s2):
    """The kernel's lse_merge on tensors: (m, s) with s a sum of exp(x - m),
    m = -inf an empty pair."""
    mn = torch.maximum(m, m2)
    live = mn != NEG
    safe = torch.where(live, mn, torch.zeros_like(mn))
    s_new = s * torch.exp(m - safe) + s2 * torch.exp(m2 - safe)
    return torch.where(live, mn, m), torch.where(live, s_new, s)


def _colmap(elem):
    """(warps, 4, 8) chunk columns held by column warp wn, lane tig, as the
    thread's accumulator c (csrc/joint_lse.cu frag_col): bf16 4 warps of a
    128-column chunk, 8 (c / 2) + 2 tig + c % 2; fp32 8 warps of a
    256-column chunk, 4 tig + c % 4 + 16 (c / 4); + 32 wn."""
    warps = 4 if elem == 2 else 8
    wn = torch.arange(warps)[:, None, None]
    tig = torch.arange(4)[None, :, None]
    c = torch.arange(8)[None, None, :]
    if elem == 2:
        return 32 * wn + 8 * (c >> 1) + 2 * tig + (c & 1)
    return 32 * wn + 4 * tig + (c & 3) + 16 * (c >> 2)


def _fwd_model(plan, f, g, w_t, bias, labels, blank, elem=2):
    """K7's algorithm (fp32) over the plan's blocks → (blank_lp, label_lp,
    lse) of the problem f, g, w_t, bias as the kernel receives it (J and V
    multiples of 16): the block's tiles (bf16 two, fp32 one), chunks of
    the block's width (bf16 128 columns, fp32 256), each thread's 8
    columns of a chunk (_colmap) folded into its running pairs, then the
    4 lanes and the column warps of a row merged in the kernel's order."""
    b, t, j = f.shape
    u1, v = g.shape[1], w_t.shape[1]
    u = u1 - 1
    per_block = plan.rows_per_block // P.TILE_CELLS
    colmap = _colmap(elem)
    warps = colmap.shape[0]
    width = 32 * warps
    blank_lp = torch.full((b, t, u1), float('nan'))
    label_lp = torch.full((b, t, max(u, 0)), float('nan'))
    lse_out = torch.full((b, t, u1), float('nan'))
    cols = -(-v // width) * width
    w_pad = torch.zeros(j, cols)
    w_pad[:, :v] = w_t
    b_pad = torch.full((cols,), NEG)
    b_pad[:v] = bias
    for first in range(0, plan.tiles, per_block):
        cells = [c for tile in range(first, first + per_block)
                 for c in P.tile_cells(plan, b, t, u1, tile)]
        ok = torch.tensor([c[3] for c in cells])
        cb, ct, cu = (torch.tensor([c[i] if c[3] else 0 for c in cells])
                      for i in range(3))
        h = torch.tanh(f[cb, ct] + g[cb, cu]) * ok[:, None]
        lbl = torch.where(ok & (cu < u),
                          labels[cb, cu.clamp(max=max(u - 1, 0))]
                          if u else torch.zeros(len(cells), dtype=torch.long),
                          blank)
        # per thread (wn, tig): running pairs of its 8 columns of a chunk
        m = torch.full((len(cells), warps, 4), NEG)
        s = torch.zeros(len(cells), warps, 4)
        bl = torch.zeros(len(cells), warps, 4)
        la = torch.zeros(len(cells), warps, 4)
        for n0 in range(0, v, width):
            x = (h @ w_pad[:, n0:n0 + width] + b_pad[n0:n0 + width])[
                :, colmap]
            col = n0 + colmap
            bl += torch.where(col == blank, x, 0.0).sum(-1)
            la += torch.where(col == lbl[:, None, None, None], x, 0.0) \
                .sum(-1)
            cm = x.max(-1).values
            mn = torch.maximum(m, cm)
            live = mn != NEG
            safe = torch.where(live, mn, torch.zeros_like(mn))
            cs = torch.exp(x - safe[..., None]).sum(-1)
            s = torch.where(live, s * torch.exp(m - safe) + cs, s)
            m = torch.where(live, mn, m)
        for off in (1, 2):                       # the lanes of a row
            idx = torch.arange(4) ^ off
            m2, s2 = m[:, :, idx], s[:, :, idx]
            bl, la = bl + bl[:, :, idx], la + la[:, :, idx]
            m, s = _merge(m, s, m2, s2)
        am, as_, ab, al = m[:, 0, 0], s[:, 0, 0], bl[:, 0, 0], la[:, 0, 0]
        for wn in range(1, warps):               # the column warps, in order
            am, as_ = _merge(am, as_, m[:, wn, 0], s[:, wn, 0])
            ab, al = ab + bl[:, wn, 0], al + la[:, wn, 0]
        lse = am + torch.log(as_)
        for r, (cb_, ct_, cu_, valid) in enumerate(cells):
            if not valid:
                continue
            blank_lp[cb_, ct_, cu_] = ab[r] - lse[r]
            lse_out[cb_, ct_, cu_] = lse[r]
            if cu_ < u:
                label_lp[cb_, ct_, cu_] = al[r] - lse[r]
    return blank_lp, label_lp, lse_out


def _case(seed, b, t, u1, j, v, blank=0, labels_blank=False):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    c = dict(f=rng.randn(b, t, j).astype(f32),
             g=rng.randn(b, u1, j).astype(f32),
             w_t=(rng.randn(j, v) / j ** 0.5).astype(f32),
             bias=(rng.randn(v) * 0.1).astype(f32),
             labels=rng.randint(0, v, (b, u1 - 1)).astype(np.int32))
    if labels_blank:
        c['labels'][:, ::2] = blank
    return c


def _model_outputs(c, blank, elem=2, staged=False):
    """The model on the problem as the wrapper hands it to the kernel, under
    the plan of `elem`-byte elements."""
    f, g, w_t, bias = (torch.from_numpy(c[k]) for k in
                       ('f', 'g', 'w_t', 'bias'))
    f, g, w_t, bias = K.pad16(f, g, w_t, bias)
    b, t, j = f.shape
    plan = P.fwd_plan(b, t, g.shape[1], j, w_t.shape[1], H100_SMS, staged,
                      elem)
    return _fwd_model(plan, f, g, w_t, bias,
                      torch.from_numpy(c['labels']).long(), blank, elem)


@pytest.mark.parametrize('b,t,u1,j,v,blank,labels_blank', [
    (2, 5, 7, 16, 256, 0, False),
    (1, 9, 1, 32, 256, 0, False),        # U = 0: one label slot
    (3, 4, 12, 24, 130, 2, True),        # J, V not multiples of 16
    (2, 11, 3, 40, 300, 0, True),        # labels equal to blank
])
def test_forward_model_matches_plain(b, t, u1, j, v, blank, labels_blank):
    c = _case(b * 100 + t + u1, b, t, u1, j, v, blank, labels_blank)
    got = _model_outputs(c, blank)
    want = K.fused_joint_lse_plain(
        *(torch.from_numpy(c[k]) for k in ('f', 'g', 'w_t', 'bias')),
        torch.from_numpy(c['labels']), blank)
    lse = torch.logsumexp(torch.tanh(
        torch.from_numpy(c['f'])[:, :, None] + torch.from_numpy(c['g'])
        [:, None]) @ torch.from_numpy(c['w_t']) + torch.from_numpy(
            c['bias']), -1)
    for a, w in zip(got, (*want, lse)):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), w.numpy(), 1e-5, 1e-5)


@pytest.mark.parametrize('cols', ['128', '0'])
@pytest.mark.parametrize('b,t,u,blank', [(2, 5, 6, 0), (1, 7, 0, 0),
                                          (2, 4, 9, 3)])
def test_forward_model_matches_pallas(monkeypatch, cols, b, t, u, blank):
    """Against _fwd_kernel_split (128-lane column blocks with a running
    max / sum, as the model's chunks) and the whole-V _fwd_kernel, in
    interpret mode."""
    monkeypatch.setenv('EDGEDICT_JOINT_FWD_COLS', cols)
    c = _case(b * 10 + t + u, b, t, u + 1, 16, 256, blank, True)
    jb, jl = joint_lse_pallas.fused_joint_lse(
        *(jnp.asarray(c[k]) for k in ('f', 'g', 'w_t', 'bias')),
        jnp.asarray(c['labels']), blank)
    got = _model_outputs(c, blank)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jb), 1e-5, 1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jl), 1e-5, 1e-5)


def test_padded_vocab_adds_nothing():
    """pad16's -inf bias columns add 0 to the sum of exp: the model on a
    V = 130 problem padded to 144 (and past it to 256 columns of chunks)
    gives the unpadded logsumexp."""
    c = _case(3, 2, 3, 4, 16, 130)
    _, _, lse = _model_outputs(c, 0)
    h = torch.tanh(torch.from_numpy(c['f'])[:, :, None]
                   + torch.from_numpy(c['g'])[:, None])
    want = torch.logsumexp(h @ torch.from_numpy(c['w_t'])
                           + torch.from_numpy(c['bias']), -1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), 1e-5, 1e-5)


@pytest.mark.parametrize('b,t,u1,j,v', [(32, 214, 65, 640, 2048),
                                        (33, 214, 65, 640, 2048),
                                        (2, 6, 1100, 640, 2048),
                                        (2, 37, 1, 48, 80),
                                        (2, 6, 33, 768, 400),
                                        (2, 200, 1, 4096, 2048)])
@pytest.mark.parametrize('staged', [False, True])
def test_fwd_plan_blocks_cover_the_lattice_and_fit(b, t, u1, j, v, staged):
    plan = P.fwd_plan(b, t, u1, j, v, H100_SMS, staged)
    assert plan.resident == (not staged and j <= 640)
    assert plan.smem <= P.SMEM_PER_BLOCK and plan.smem_h <= P.SMEM_PER_BLOCK
    assert plan.rows_per_block == 2 * P.TILE_CELLS == P.GEMM_ROWS
    # the blocks' tile pairs, slab by slab: every tile once, no pair across
    # two slabs
    pairs = []
    for s0 in range(0, plan.tiles, plan.slab_tiles):
        n = min(plan.slab_tiles, plan.tiles - s0)
        pairs += [(s0 + 2 * i, s0 + 2 * i + 1) for i in range(-(-n // 2))]
        assert pairs[-1][0] < s0 + n
    assert len(pairs) == plan.blocks and plan.slabs == -(-plan.tiles //
                                                         plan.slab_tiles)
    tiles = [x for p in pairs for x in p if x < plan.tiles]
    assert tiles == list(range(plan.tiles))
    assert plan.waves == plan.blocks / H100_SMS
    if plan.resident:
        assert plan.ldh == -(-j // P.BK) * P.BK + 8 and plan.ldh % 8 == 0
        assert plan.smem == P.fwd_smem_resident(j)
        assert plan.scratch_bytes == 0 and plan.slabs == 1
    else:
        assert plan.slab_tiles % 2 == 0 and plan.ldh == 0
        assert plan.scratch_bytes == plan.slab_tiles * P.TILE_CELLS * j * 2
        assert plan.scratch_bytes <= max(P.SLAB_BYTES,
                                         2 * P.TILE_CELLS * j * 2)


def test_fwd_plan_resident_limit_and_bytes():
    """h resident: 128 rows of (J rounded up to 64) + 8 bf16 beside a
    3-stage ring of 128 x 72 bf16 W^T stages; J = 640 fits (221,184
    bytes), J = 656 does not."""
    assert P.fwd_smem_resident(640) == 128 * 648 * 2 + 3 * 128 * 72 * 2
    assert P.fwd_smem_resident(640) <= P.SMEM_PER_BLOCK \
        < P.fwd_smem_resident(656)
    assert P.fwd_plan(2, 5, 7, 640, 2048, H100_SMS).resident
    assert not P.fwd_plan(2, 5, 7, 656, 2048, H100_SMS).resident


@pytest.mark.parametrize('b,t,u1,j,v', [(2, 5, 7, 40, 48), (2, 5, 7, 64, 70),
                                        (0, 5, 7, 64, 48), (2, 5, 0, 64, 48),
                                        (2, 5, 7, 0, 48)])
def test_fwd_plan_outside_raises(b, t, u1, j, v):
    with pytest.raises(ValueError, match=f'J={j} V={v}'):
        P.fwd_plan(b, t, u1, j, v, H100_SMS)


def _neg_chunk_case(seed, b, t, u1, j, v, blank=0):
    """_case with the bias of columns 256 .. 511 at -inf (a whole fp32
    chunk) and no label there."""
    c = _case(seed, b, t, u1, j, v, blank)
    c['bias'][256:512] = float('-inf')
    lab = c['labels']
    lab[(lab >= 256) & (lab < 512)] = 5
    return c


FP32_CASES = [
    (2, 5, 7, 16, 256, 0, False),
    (1, 9, 1, 32, 256, 0, False),        # U+1 = 1: one label slot
    (3, 4, 12, 24, 300, 2, True),        # J, V not multiples of 16 / 128
    (2, 11, 3, 40, 600, 0, True),        # chunk 2 of 3 all -inf
    (2, 70, 2, 48, 200, 0, False),       # a ragged last block
]


@pytest.mark.parametrize('b,t,u1,j,v,blank,labels_blank', FP32_CASES)
def test_fp32_forward_model_matches_plain(b, t, u1, j, v, blank,
                                          labels_blank):
    """The fp32 model against fused_joint_lse_plain and the plain
    logsumexp, rtol 1e-4 / atol 1e-5, nothing NaN (a -inf chunk folds to
    nothing)."""
    make = _neg_chunk_case if v == 600 else _case
    c = make(b * 100 + t + u1, b, t, u1, j, v, blank)
    if labels_blank:
        c['labels'][:, ::2] = blank
    got = _model_outputs(c, blank, elem=4)
    tens = [torch.from_numpy(c[k]) for k in ('f', 'g', 'w_t', 'bias')]
    want = K.fused_joint_lse_plain(*tens, torch.from_numpy(c['labels']),
                                   blank)
    lse = torch.logsumexp(torch.tanh(tens[0][:, :, None] + tens[1][:, None])
                          @ tens[2] + tens[3], -1)
    for a, w in zip(got, (*want, lse)):
        assert a.shape == w.shape and not torch.isnan(a).any()
        np.testing.assert_allclose(a.numpy(), w.numpy(), 1e-4, 1e-5)


@pytest.mark.parametrize('cols', ['128', '0'])
@pytest.mark.parametrize('b,t,u,v,neg', [(2, 5, 6, 256, False),
                                         (1, 7, 0, 304, False),
                                         (2, 4, 9, 600, True)])
def test_fp32_forward_model_matches_pallas(monkeypatch, cols, b, t, u, v,
                                           neg):
    """The fp32 model against the JAX package's K7 in interpret mode
    (_fwd_kernel_split with 128-lane column blocks, and the whole-V
    _fwd_kernel), rtol 1e-4 / atol 1e-5, including U+1 = 1 and a chunk of
    -inf bias."""
    monkeypatch.setenv('EDGEDICT_JOINT_FWD_COLS', cols)
    make = _neg_chunk_case if neg else _case
    c = make(b * 10 + t + u, b, t, u + 1, 16, v)
    c['labels'][:, ::2] = 0
    jb, jl = joint_lse_pallas.fused_joint_lse(
        *(jnp.asarray(c[k]) for k in ('f', 'g', 'w_t', 'bias')),
        jnp.asarray(c['labels']), 0)
    got = _model_outputs(c, 0, elem=4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jb), 1e-4, 1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jl), 1e-4, 1e-5)


def test_fp32_staged_model_matches_resident():
    """The fp32 plan through the slab scratch (forced) takes the same
    blocks and gives the same outputs as the resident plan."""
    c = _case(7, 2, 9, 5, 32, 272)
    res = _model_outputs(c, 0, elem=4)
    st = _model_outputs(c, 0, elem=4, staged=True)
    for a, w in zip(res, st):
        assert torch.equal(a, w)


@pytest.mark.parametrize('b,t,u1,j,v', [(32, 214, 65, 640, 2048),
                                        (4, 1437, 33, 640, 2048),
                                        (2, 6, 1100, 640, 2048),
                                        (2, 37, 1, 48, 80),
                                        (2, 6, 33, 1008, 400),
                                        (1, 4, 300, 1008, 80),
                                        (2, 200, 1, 4096, 2048)])
@pytest.mark.parametrize('staged', [False, True])
def test_fp32_fwd_plan_covers_the_lattice_and_fits(b, t, u1, j, v, staged):
    """64 consecutive cells a block (no tile shape: r_t = r_u = 0), every
    cell once, h resident up to J = 704 (J + 4 fp32 a row, an odd number of
    16-byte words), every block within the card's shared memory, the
    staged scratch within SLAB_BYTES."""
    plan = P.fwd_plan(b, t, u1, j, v, H100_SMS, staged, 4)
    assert plan.rows_per_block == P.TILE_CELLS
    assert (plan.r_t, plan.r_u, plan.n_tt, plan.n_tu) == (0, 0, 0, 0)
    assert plan.tiles == -(-b * t * u1 // P.TILE_CELLS)
    assert plan.resident == (not staged and j <= 704)
    assert plan.smem <= P.SMEM_PER_BLOCK and plan.smem_h <= P.SMEM_PER_BLOCK
    assert plan.blocks == plan.tiles and plan.waves == plan.tiles / H100_SMS
    if plan.resident:
        assert plan.ldh == j + 4 and (plan.ldh // 4) % 2 == 1
        assert plan.smem == (64 * (j + 4) + 3 * 16 * 256) * 4
    else:
        assert plan.ldh == 0 and plan.slabs == -(-plan.tiles //
                                                 plan.slab_tiles)
        assert plan.smem_h == 0          # the flat h launch reads f, g
        assert plan.scratch_bytes == plan.slab_tiles * P.TILE_CELLS * j * 4
        assert plan.scratch_bytes <= max(P.SLAB_BYTES, P.TILE_CELLS * j * 4)
    seen = {}
    order = []
    for tile in range(plan.tiles):
        for cell in P.tile_cells(plan, b, t, u1, tile):
            if cell[3]:
                seen[cell[:3]] = seen.get(cell[:3], 0) + 1
                order.append(cell[:3])
    assert len(seen) == b * t * u1 and set(seen.values()) == {1}
    assert order == sorted(order)             # (b, t, u) order


def test_fp32_fwd_plan_resident_limit_and_bytes():
    """h resident in fp32: 64 rows of J + 4 beside a 3-stage ring of 16 x
    256 W^T stages; J = 640 takes 214,016 bytes, 704 fits, 720 does not."""
    assert P.fwd_smem_resident(640, 4) == 214016
    assert P.fwd_smem_resident(704, 4) <= P.SMEM_PER_BLOCK \
        < P.fwd_smem_resident(720, 4)
    assert P.fwd_smem_staged(4) == 3 * (64 * 20 + 16 * 256) * 4
    assert P.fwd_plan(2, 5, 7, 704, 2048, H100_SMS, elem=4).resident
    assert not P.fwd_plan(2, 5, 7, 720, 2048, H100_SMS, elem=4).resident


@pytest.mark.parametrize('b,t,u1,j,v,elem', [(2, 5, 7, 40, 48, 4),
                                             (2, 5, 7, 64, 70, 4),
                                             (0, 5, 7, 64, 48, 4),
                                             (2, 5, 0, 64, 48, 4),
                                             (2, 5, 7, 64, 48, 3)])
def test_fp32_fwd_plan_outside_raises(b, t, u1, j, v, elem):
    with pytest.raises(ValueError, match=f'J={j} V={v}'
                       if elem == 4 else 'element size 3'):
        P.fwd_plan(b, t, u1, j, v, H100_SMS, elem=elem)
