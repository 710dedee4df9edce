"""The launch plan of K8's backward (ops/joint_lse_plan.py bwd_plan, bf16
on the tensor cores and, sized in 4-byte elements, fp32 on the CUDA cores)
on the CPU: the lattice tiles cover every cell (b, t, u) once for ragged T and
U+1, the slabs partition the tiles, every block's shared memory fits the
H100, the scratch does not grow with B·T·U, shapes outside the plan raise
ValueError; and the slab-by-slab algorithm the kernels run, written out in
PyTorch over the plan's row map (per-tile df / dg sums, per-row-block dbias
partials, dW split over row shares), gives the gradients of
fused_joint_lse_plain, also on a problem padded to J, V multiples of 16 by
the wrapper's pad16."""

import numpy as np
import pytest
import torch

from edgedict_tpu_torch.ops import joint_lse_kernel as K
from edgedict_tpu_torch.ops import joint_lse_plan as P

H100_SMS = 132


def _cells(plan, b, t, u1):
    """{(b, t, u): count} over the valid rows of every tile."""
    seen = {}
    for tile in range(plan.tiles):
        for cell in P.tile_cells(plan, b, t, u1, tile):
            if cell[3]:
                seen[cell[:3]] = seen.get(cell[:3], 0) + 1
    return seen


@pytest.mark.parametrize('b,t,u1', [(2, 9, 1), (2, 9, 7), (2, 23, 65),
                                    (1, 11, 300), (1, 3, 1100),
                                    (3, 1, 65)])
def test_tiles_cover_every_cell_once(b, t, u1):
    plan = P.bwd_plan(b, t, u1, 64, 48, H100_SMS)
    assert plan.r_t * plan.r_u == P.TILE_CELLS
    assert plan.n_tt == -(-t // plan.r_t) and plan.n_tu == -(-u1 // plan.r_u)
    assert plan.tiles == b * plan.n_tt * plan.n_tu
    seen = _cells(plan, b, t, u1)
    assert len(seen) == b * t * u1 and set(seen.values()) == {1}


@pytest.mark.parametrize('t,u1,want', [(214, 65, (8, 8)), (214, 49, (8, 8)),
                                       (300, 1, (64, 1)), (1, 1100, (1, 64)),
                                       (214, 300, (8, 8)), (7, 7, (8, 8))])
def test_tile_shape_pads_little_and_sums_most(t, u1, want):
    assert P.tile_shape(t, u1) == want
    shapes = [(P.TILE_CELLS >> k, 1 << k) for k in range(7)]

    def padded(s):
        return -(-t // s[0]) * s[0] * -(-u1 // s[1]) * s[1]
    least = min(padded(s) for s in shapes)
    assert padded(want) <= P.PAD_SLACK * least
    for s in shapes:        # no tile within the slack needs fewer atomics
        if padded(s) <= P.PAD_SLACK * least:
            assert sum(want) <= sum(s)


@pytest.mark.parametrize('b,t,u1,j,v', [(32, 214, 65, 640, 2048),
                                        (32, 214, 49, 640, 2048),
                                        (2, 50, 300, 640, 2048),
                                        (2, 6, 1100, 640, 2048),
                                        (2, 6, 33, 768, 400),
                                        (2, 5, 17, 64, 48),
                                        (4, 300, 1, 1024, 4096),
                                        (2, 200, 1, 4096, 2048)])
def test_slabs_partition_the_tiles_and_fit_the_card(b, t, u1, j, v):
    plan = P.bwd_plan(b, t, u1, j, v, H100_SMS)
    assert plan.slab_tiles % 2 == 0 and plan.slab_tiles >= 2
    starts = list(range(0, plan.tiles, plan.slab_tiles))
    assert len(starts) == plan.slabs
    owned = [0] * plan.tiles
    for s in starts:
        for tile in range(s, min(plan.tiles, s + plan.slab_tiles)):
            owned[tile] += 1
    assert owned == [1] * plan.tiles
    assert plan.slab_rows == plan.slab_tiles * P.TILE_CELLS
    assert max(plan.smem_h, plan.smem_dl, plan.smem_dh, plan.smem_dw) \
        <= P.SMEM_PER_BLOCK
    assert plan.smem_h == (plan.r_t + plan.r_u) * min(j, P.H_COLS) * 2
    assert 1 <= plan.dw_split <= P.MAX_DW_SPLIT
    assert plan.slab_rows // plan.dw_split >= P.BK


def test_scratch_does_not_grow_with_the_lattice():
    j, v = 640, 2048
    plans = [P.bwd_plan(b, t, u1, j, v, H100_SMS)
             for b, t, u1 in ((32, 214, 65), (64, 214, 65), (32, 428, 130),
                              (32, 214, 300))]
    assert len({p.scratch_bytes for p in plans}) == 1
    assert len({p.slab_rows for p in plans}) == 1
    p = plans[0]
    assert p.slab_rows * (j + v) * 2 <= P.SLAB_BYTES
    assert p.scratch_bytes == (p.slab_rows * (j + v) * 2
                               + p.dw_split * j * v * 4
                               + p.slab_tiles // 2 * v * 4
                               + p.slab_tiles * (p.r_t + p.r_u) * j * 4)
    # a lattice smaller than a slab takes a smaller one
    small = P.bwd_plan(2, 5, 17, j, v, H100_SMS)
    assert small.slabs == 1 and small.scratch_bytes < p.scratch_bytes


@pytest.mark.parametrize('b,t,u1,j,v', [(2, 5, 7, 40, 48), (2, 5, 7, 64, 70),
                                        (0, 5, 7, 64, 48), (2, 5, 0, 64, 48),
                                        (2, 200, 1, 4104, 2048)])
def test_shape_outside_the_plan_raises(b, t, u1, j, v):
    with pytest.raises(ValueError, match=f'J={j} V={v}'):
        P.bwd_plan(b, t, u1, j, v, H100_SMS)


def _slab_backward(plan, f, g, w_t, bias, labels, blank, lse, d_b, d_l):
    """The kernels' algorithm in PyTorch (fp32): slab by slab over the
    plan's row map → (df, dg, dw_t, dbias)."""
    b, t, j = f.shape
    u1, v = g.shape[1], w_t.shape[1]
    u = u1 - 1
    df, dg = torch.zeros(b, t, j), torch.zeros(b, u1, j)
    dw_part = torch.zeros(plan.dw_split, j, v)
    dbias_part = torch.zeros(plan.slab_tiles // 2, v)
    for t0 in range(0, plan.tiles, plan.slab_tiles):
        n = min(plan.slab_tiles, plan.tiles - t0)
        cells = [c for tile in range(t0, t0 + n)
                 for c in P.tile_cells(plan, b, t, u1, tile)]
        ok = torch.tensor([c[3] for c in cells])
        cb, ct, cu = (torch.tensor([c[i] if c[3] else 0 for c in cells])
                      for i in range(3))
        h = torch.tanh(f[cb, ct] + g[cb, cu]) * ok[:, None]       # 1. h
        logits = h @ w_t + bias                                   # 2. dl
        z = lse[cb, ct, cu]
        db = d_b[cb, ct, cu] * ok
        has_l = ok & (cu < u)
        dl = torch.where(has_l, d_l[cb, ct, cu.clamp(max=max(u - 1, 0))]
                         if u else torch.zeros(len(cells)), 0.0)
        lbl = torch.where(has_l, labels[cb, cu.clamp(max=max(u - 1, 0))]
                          if u else torch.zeros(len(cells), dtype=torch.long),
                          blank)
        cols = torch.arange(v)
        dlog = ((cols == blank) * db[:, None]
                + (cols == lbl[:, None]) * dl[:, None]
                - (db + dl)[:, None] * torch.exp(logits - z[:, None]))
        for mb in range(-(-len(cells) // P.GEMM_ROWS)):
            dbias_part[mb] += dlog[mb * P.GEMM_ROWS:
                                   (mb + 1) * P.GEMM_ROWS].sum(0)
        da = (dlog @ w_t.t()) * (1 - h * h)                       # 3. dh
        for i in range(n):
            tile = da[i * P.TILE_CELLS:(i + 1) * P.TILE_CELLS]
            tile = tile.reshape(plan.r_t, plan.r_u, j)
            bb, tt, uu, _ = cells[i * P.TILE_CELLS]
            for ti in range(plan.r_t):
                if tt + ti < t:
                    df[bb, tt + ti] += tile[ti].sum(0)
            for ui in range(plan.r_u):
                if uu + ui < u1:
                    dg[bb, uu + ui] += tile[:, ui].sum(0)
        rows = len(cells)                                         # 4. dW
        share = -(-rows // (plan.dw_split * P.BK)) * P.BK
        for s in range(plan.dw_split):
            lo, hi = s * share, min(rows, (s + 1) * share)
            dw_part[s] += h[lo:hi].t() @ dlog[lo:hi]
    return df, dg, dw_part.sum(0), dbias_part.sum(0)


@pytest.mark.parametrize('b,t,u1,slab_bytes', [
    (2, 9, 7, 1), (1, 13, 1, 1), (2, 5, 17, 1 << 20), (1, 3, 70, 1)])
def test_slab_algorithm_matches_plain_gradients(b, t, u1, slab_bytes,
                                                monkeypatch):
    j, v = 16, 32
    rng = np.random.RandomState(b * 100 + t + u1)
    f = torch.tensor(rng.randn(b, t, j).astype(np.float32))
    g = torch.tensor(rng.randn(b, u1, j).astype(np.float32))
    w_t = torch.tensor(rng.randn(j, v).astype(np.float32) / 4)
    bias = torch.tensor(rng.randn(v).astype(np.float32) / 10)
    labels = torch.tensor(rng.randint(1, v, (b, u1 - 1)))
    d_b = torch.tensor(rng.randn(b, t, u1).astype(np.float32))
    d_l = torch.tensor(rng.randn(b, t, u1 - 1).astype(np.float32))
    monkeypatch.setattr(P, 'SLAB_BYTES', slab_bytes)
    plan = P.bwd_plan(b, t, u1, j, v, H100_SMS)
    if slab_bytes == 1:
        assert plan.slab_tiles == 2 and plan.slabs == -(-plan.tiles // 2)
    h = torch.tanh(f[:, :, None] + g[:, None])
    lse = torch.logsumexp(h @ w_t + bias, -1)
    got = _slab_backward(plan, f, g, w_t, bias, labels, 0, lse, d_b, d_l)
    leaves = [x.clone().requires_grad_() for x in (f, g, w_t, bias)]
    out = K.fused_joint_lse_plain(*leaves, labels, 0)
    want = torch.autograd.grad(out, leaves, (d_b, d_l))
    for a, r in zip(got, want):
        assert torch.allclose(a, r, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize('j,v', [(40, 300), (24, 50), (1000, 70), (16, 20)])
def test_padding_to_16_keeps_the_gradients(j, v):
    """The wrapper pads J and V to multiples of 16 before the tensor-core
    kernels: the slab algorithm on the padded problem, cut back to J and V,
    gives the plain gradients of the original one."""
    b, t, u1 = 2, 5, 4
    rng = np.random.RandomState(j + v)
    f = torch.tensor(rng.randn(b, t, j).astype(np.float32))
    g = torch.tensor(rng.randn(b, u1, j).astype(np.float32))
    w_t = torch.tensor(rng.randn(j, v).astype(np.float32) / j ** 0.5)
    bias = torch.tensor(rng.randn(v).astype(np.float32) / 10)
    labels = torch.tensor(rng.randint(1, v, (b, u1 - 1)))
    d_b = torch.tensor(rng.randn(b, t, u1).astype(np.float32))
    d_l = torch.tensor(rng.randn(b, t, u1 - 1).astype(np.float32))
    h = torch.tanh(f[:, :, None] + g[:, None])
    lse = torch.logsumexp(h @ w_t + bias, -1)
    padded = K.pad16(f, g, w_t, bias)
    jp, vp = padded[2].shape
    assert jp % 16 == 0 and vp % 16 == 0 and jp - j < 16 and vp - v < 16
    plan = P.bwd_plan(b, t, u1, jp, vp, H100_SMS)
    df, dg, dw_t, dbias = _slab_backward(plan, *padded, labels, 0, lse, d_b,
                                         d_l)
    got = (df[..., :j], dg[..., :j], dw_t[:j, :v], dbias[:v])
    assert not dw_t[:, v:].any() and not dbias[v:].any()
    leaves = [x.clone().requires_grad_() for x in (f, g, w_t, bias)]
    out = K.fused_joint_lse_plain(*leaves, labels, 0)
    want = torch.autograd.grad(out, leaves, (d_b, d_l))
    for a, r in zip(got, want):
        assert torch.allclose(a, r, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize('b,t,u1,j,v', [(32, 214, 65, 640, 2048),
                                        (4, 1437, 33, 640, 2048),
                                        (2, 6, 1100, 640, 2048),
                                        (1, 4, 300, 1008, 80),
                                        (4, 300, 1, 1008, 4096),
                                        (2, 200, 1, 4096, 2048)])
def test_fp32_bwd_plan_covers_the_lattice_and_fits(b, t, u1, j, v):
    """K8's fp32 plan: the tile shape that pads the lattice least (every
    cell once), slabs of h + dlogits in 4-byte elements within SLAB_BYTES,
    every launch's block within the card's 232,448 bytes of shared memory
    at J = 640 and 1000 (padded to 1008), the h launch staging 512 fp32
    columns at a time."""
    plan = P.bwd_plan(b, t, u1, j, v, H100_SMS, 4)
    assert (plan.r_t, plan.r_u) == P.tile_shape(t, u1, 1.0)
    shapes = [(P.TILE_CELLS >> k, 1 << k) for k in range(7)]

    def padded(s):
        return -(-t // s[0]) * s[0] * -(-u1 // s[1]) * s[1]
    assert padded((plan.r_t, plan.r_u)) == min(padded(s) for s in shapes)
    seen = _cells(plan, b, t, u1)
    assert len(seen) == b * t * u1 and set(seen.values()) == {1}
    assert plan.slab_tiles % 2 == 0 and plan.slab_tiles >= 2
    assert plan.slab_rows * (j + v) * 4 <= max(P.SLAB_BYTES,
                                               2 * P.TILE_CELLS * (j + v) * 4)
    assert plan.slab_tiles == min(
        max(2, P.SLAB_BYTES // (P.TILE_CELLS * (j + v) * 4) // 2 * 2),
        plan.tiles + plan.tiles % 2)
    assert plan.smem_h == (plan.r_t + plan.r_u) * min(j, 512) * 4
    assert max(plan.smem_h, plan.smem_dl, plan.smem_dh, plan.smem_dw) \
        <= P.SMEM_PER_BLOCK
    assert plan.smem_dl == max(P.gemm_smem(4), 128 * 132 * 4 + 2 * 128 * 4)
    assert plan.smem_dw == P.gemm_smem(4, a_km=True) == 3 * 8192 * 4
    assert plan.smem_dh == P.gemm_smem(4) == 3 * (128 * 36 + 32 * 128) * 4
    assert plan.scratch_bytes == (plan.slab_rows * (j + v) * 4
                                  + plan.dw_split * j * v * 4
                                  + plan.slab_tiles // 2 * v * 4
                                  + plan.slab_tiles * (plan.r_t + plan.r_u)
                                  * j * 4)


def test_fp32_slab_is_half_the_bf16_slab():
    """The same SLAB_BYTES holds half the fp32 rows: 194 tiles a slab at
    the E6D2 step against bf16's 390; fp32 takes 32 x 2 tiles there (6.3 %
    padding), bf16 8 x 8 (11.8 %, half the df / dg atomics)."""
    p2 = P.bwd_plan(32, 214, 65, 640, 2048, H100_SMS)
    p4 = P.bwd_plan(32, 214, 65, 640, 2048, H100_SMS, 4)
    assert (p2.slab_tiles, p4.slab_tiles) == (390, 194)
    assert (p2.r_t, p2.r_u, p4.r_t, p4.r_u) == (8, 8, 32, 2)
    assert p4.slabs == -(-p4.tiles // 194)


@pytest.mark.parametrize('b,t,u1,j,v,elem', [(2, 5, 7, 40, 48, 4),
                                             (2, 5, 7, 64, 70, 4),
                                             (0, 5, 7, 64, 48, 4),
                                             (2, 200, 1, 4104, 2048, 4),
                                             (2, 5, 7, 64, 48, 1)])
def test_fp32_shape_outside_the_plan_raises(b, t, u1, j, v, elem):
    with pytest.raises(ValueError, match=f'J={j} V={v}'
                       if elem == 4 else 'element size 1'):
        P.bwd_plan(b, t, u1, j, v, H100_SMS, elem)


@pytest.mark.parametrize('b,t,u1,slab_bytes', [
    (2, 9, 7, 1), (1, 13, 1, 1), (2, 5, 17, 1 << 20), (1, 3, 70, 1),
    (2, 70, 2, 1 << 16)])
def test_fp32_slab_algorithm_matches_plain_gradients(b, t, u1, slab_bytes,
                                                     monkeypatch):
    """The slab algorithm under the fp32 plan (slabs sized in 4-byte
    elements, dlogits kept in fp32) gives the plain gradients."""
    j, v = 16, 32
    rng = np.random.RandomState(b * 100 + t + u1 + 1)
    f = torch.tensor(rng.randn(b, t, j).astype(np.float32))
    g = torch.tensor(rng.randn(b, u1, j).astype(np.float32))
    w_t = torch.tensor(rng.randn(j, v).astype(np.float32) / 4)
    bias = torch.tensor(rng.randn(v).astype(np.float32) / 10)
    labels = torch.tensor(rng.randint(1, v, (b, u1 - 1)))
    d_b = torch.tensor(rng.randn(b, t, u1).astype(np.float32))
    d_l = torch.tensor(rng.randn(b, t, u1 - 1).astype(np.float32))
    monkeypatch.setattr(P, 'SLAB_BYTES', slab_bytes)
    plan = P.bwd_plan(b, t, u1, j, v, H100_SMS, 4)
    if slab_bytes == 1:
        assert plan.slab_tiles == 2 and plan.slabs == -(-plan.tiles // 2)
    else:
        assert plan.slab_tiles == min(
            max(2, slab_bytes // (P.TILE_CELLS * (j + v) * 4) // 2 * 2),
            plan.tiles + plan.tiles % 2)
    h = torch.tanh(f[:, :, None] + g[:, None])
    lse = torch.logsumexp(h @ w_t + bias, -1)
    got = _slab_backward(plan, f, g, w_t, bias, labels, 0, lse, d_b, d_l)
    leaves = [x.clone().requires_grad_() for x in (f, g, w_t, bias)]
    out = K.fused_joint_lse_plain(*leaves, labels, 0)
    want = torch.autograd.grad(out, leaves, (d_b, d_l))
    for a, r in zip(got, want):
        assert torch.allclose(a, r, atol=1e-5, rtol=1e-4)
