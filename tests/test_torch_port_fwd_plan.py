"""The launch plan of K1/K5's persistent forward kernel (ops/rnn_fwd.py) on
the CPU: for the hidden sizes of the port's main paths (E6D2's encoder
H=1024, its prediction net H=256, E6D2_LARGE_Batch's H=512) and the odd
shapes the card tests use, for both cells, batches from one stream to the
server's 256 and both dtypes, at the H100's 132 SMs the grid is
co-resident, every hidden unit is owned by exactly one block and the whole
W_hh slice fits in a block's shared memory; shapes beyond the plan raise
ValueError naming the shape."""

import pytest

from edgedict_tpu_torch.ops import rnn_fwd as P

H100_SMS = 132


def resident_blocks_per_sm(smem, regs_per_thread=128):
    """The H100's limits on resident blocks of P.THREADS threads and `smem`
    dynamic bytes per SM: 228 KB of shared memory with 1 KB reserved per
    block, 2048 threads, 64K registers.  The wrapper asks the card instead
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    if smem > P.SMEM_PER_BLOCK:
        return 0
    return min(233472 // (smem + 1024), 2048 // P.THREADS,
               65536 // (regs_per_thread * P.THREADS))


def _plan(hid, gates, batch, elem):
    smem = P.fwd_smem_bytes(hid, gates, batch, elem)
    return P.fwd_plan(hid, gates, batch, elem, H100_SMS,
                      resident_blocks_per_sm(smem))


@pytest.mark.parametrize('hid', [16, 40, 64, 256, 512, 600, 1024, 1030])
@pytest.mark.parametrize('gates', [3, 4])
@pytest.mark.parametrize('batch', [1, 5, 11, 32, 33, 256])
@pytest.mark.parametrize('elem', [2, 4])
def test_plan_is_co_resident_and_covers_every_unit(hid, gates, batch, elem):
    plan = _plan(hid, gates, batch, elem)
    smem = P.fwd_smem_bytes(hid, gates, batch, elem)
    assert plan.smem == smem <= P.SMEM_PER_BLOCK
    assert plan.blocks <= H100_SMS * resident_blocks_per_sm(smem)
    owners = [0] * hid
    for blk in range(plan.blocks):
        for u in range(blk * P.UNITS, min(hid, (blk + 1) * P.UNITS)):
            owners[u] += 1
    assert owners == [1] * hid
    assert (plan.blocks - 1) * P.UNITS < hid   # no block owns nothing


@pytest.mark.parametrize('gates', [3, 4])
@pytest.mark.parametrize('elem', [2, 4])
def test_plan_holds_the_whole_weight_slice(gates, elem):
    # every one of the block's G·UNITS gate rows, all H of each (rounded up
    # to 32), beside the partial sums of one slab and the (B x UNITS)
    # carries: E6D2's LSTM layer in bf16 is 64 KB of slice
    for hid in (1024, 1030):
        k32 = -(-hid // 32) * 32
        rest = P.WARPS * P.SLAB * P.RED_LD[gates] * 4 + 33 * P.UNITS * 4
        assert P.fwd_smem_bytes(hid, gates, 33, elem) \
            == gates * P.UNITS * k32 * elem + rest
        assert k32 >= hid and P.RED_LD[gates] >= gates * P.UNITS
    assert P.fwd_smem_bytes(1024, 4, 32, 2) - 4 * 1024 * P.UNITS * 2 \
        == P.WARPS * P.SLAB * 40 * 4 + 32 * P.UNITS * 4


@pytest.mark.parametrize('hid,gates,batch,elem', [
    (2048, 4, 32, 4), (4096, 4, 32, 2), (3000, 3, 1, 4), (8192, 3, 256, 2),
    (1024, 4, 8192, 4)])
def test_shape_beyond_the_plan_raises(hid, gates, batch, elem):
    with pytest.raises(ValueError, match=f'H={hid}'):
        _plan(hid, gates, batch, elem)


def test_grid_not_co_resident_raises():
    # 1056 units fit 132 blocks of 8, one block per SM; 1064 do not
    P.fwd_plan(1056, 4, 32, 4, H100_SMS, 1)
    with pytest.raises(ValueError, match='H=1064'):
        P.fwd_plan(1064, 4, 32, 4, H100_SMS, 1)
    with pytest.raises(ValueError, match='H=16'):
        P.fwd_plan(16, 3, 32, 2, H100_SMS, 0)


@pytest.mark.parametrize('hid,gates,batch,elem', [
    (0, 4, 1, 2), (16, 2, 1, 2), (16, 4, 0, 4), (16, 3, 1, 8), (-8, 3, 4, 4)])
def test_degenerate_shapes_raise(hid, gates, batch, elem):
    with pytest.raises(ValueError, match=f'H={hid}'):
        P.fwd_plan(hid, gates, batch, elem, H100_SMS, 1)


# K12, the int8 LSTM: the same kernel body and shared slice as K1, so the
# same plan at the compute dtype (its occupancy asked of its own kernel)

@pytest.mark.parametrize('batch', [1, 64])
@pytest.mark.parametrize('elem', [2, 4])
def test_int8_plan_at_the_serving_shapes(batch, elem):
    plan = _plan(1024, 4, batch, elem)
    assert plan.blocks == 128 <= H100_SMS * plan.blocks_per_sm
    assert plan.smem == P.fwd_smem_bytes(1024, 4, batch, elem) \
        <= P.SMEM_PER_BLOCK
    if (batch, elem) == (64, 4):
        # the fp32 slice (128 KB), one slab's partials and 64 x 8 carries
        assert plan.smem == 174080 and plan.blocks_per_sm == 1


@pytest.mark.parametrize('hid,batch,elem', [(2048, 1, 4), (1024, 8192, 4),
                                            (4096, 64, 2)])
def test_int8_shape_that_does_not_fit_raises(hid, batch, elem):
    with pytest.raises(ValueError, match=f'H={hid}'):
        _plan(hid, 4, batch, elem)


def _ws_index(k, n, gates, k32, elem):
    """rnn_fwd.cu:ws_index, the slot of W_hh[n-th row of the block, k]."""
    if elem == 2:
        return ((((k >> 5) * gates + n // P.UNITS) * 32 + (n % P.UNITS) * 4
                 + ((k & 31) >> 3)) << 3) + (k & 7)
    return (n >> 2) * k32 * 4 + k * 4 + (n & 3)


def _q_prologue_slots(hid, elem, gates=4):
    """K12's vector prologue (rnn_fwd.cu:load_slice_q) written out: for
    each thread's item, the (slot, row n, k) of every value it stores, in
    store order, and the 16-byte unit its first store writes."""
    k32 = -(-hid // 32) * 32
    items = []
    if elem == 2:
        for i in range(k32 // 32 * gates * 16):
            h, j = i & 1, (i >> 1) & 7
            q, c = (i >> 4) % gates, (i >> 4) // gates
            k, n = 32 * c + 16 * h, q * P.UNITS + j
            unit = (c * gates + q) * 32 + j * 4 + 2 * h
            order = (1, 0) if (j >> 1) & 1 else (0, 1)
            stores = [((unit + u) * 8 + e, n, k + 8 * u + e)
                      for u in order for e in range(8)]
            items.append((stores, unit + order[0]))
    else:
        nm = k32 // 16
        for i in range(gates * P.UNITS // 4 * nm):
            m, grp = i % nm, i // nm
            stores, first = [], None
            for e in range(16):
                ee = (e + m) & 15
                f4 = grp * k32 + 16 * m + ee
                first = f4 if first is None else first
                stores += [(4 * f4 + r, 4 * grp + r, 16 * m + ee)
                           for r in range(4)]
            items.append((stores, first))
    return items, k32


@pytest.mark.parametrize('hid', [16, 1024])
@pytest.mark.parametrize('elem', [2, 4])
def test_int8_prologue_fills_k1_layout_once(hid, elem):
    """Every value the int8 prologue stores goes to the slot K1's
    ws_index gives it, and the slice is filled exactly once."""
    items, k32 = _q_prologue_slots(hid, elem)
    seen = {}
    for stores, _ in items:
        for slot, n, k in stores:
            assert slot == _ws_index(k, n, 4, k32, elem)
            seen[slot] = seen.get(slot, 0) + 1
    assert sorted(seen) == list(range(4 * P.UNITS * k32))
    assert set(seen.values()) == {1}


@pytest.mark.parametrize('elem', [2, 4])
def test_int8_prologue_stores_spread_over_the_banks(elem):
    """A quarter warp's first 16-byte stores (8 threads, 128 bytes) land on
    8 distinct 16-byte bank groups at H=1024, so they take one pass."""
    items, _ = _q_prologue_slots(1024, elem)
    for quarter in range(0, 64, 8):
        units = [first % 8 for _, first in items[quarter:quarter + 8]]
        assert sorted(units) == list(range(8))


# K13, the int8 GRU: K5's kernel body and shared slice with the int8
# prologue at G = 3, so K5's plan at the compute dtype, its occupancy asked
# of its own kernel (cell 3)

@pytest.mark.parametrize('batch', [1, 64])
@pytest.mark.parametrize('elem', [2, 4])
def test_int8_gru_plan_at_the_serving_shapes(batch, elem):
    plan = _plan(1024, 3, batch, elem)
    assert plan.blocks == 128 <= H100_SMS * plan.blocks_per_sm
    assert plan.smem == P.fwd_smem_bytes(1024, 3, batch, elem) \
        <= P.SMEM_PER_BLOCK
    if (batch, elem) == (64, 4):
        # the fp32 slice (96 KB), one slab's partials and 64 x 8 carries
        assert plan.smem == 1024 * 24 * 4 + 8 * 32 * 24 * 4 + 64 * 8 * 4
    # every preset's GRU encoder fits: E4D1 at H=256, E6D2 at 1024
    assert _plan(256, 3, batch, elem).blocks == 32


@pytest.mark.parametrize('hid,batch,elem', [(2120, 1, 2), (3000, 1, 4),
                                            (1024, 8192, 4),
                                            (8192, 64, 2)])
def test_int8_gru_shape_that_does_not_fit_raises(hid, batch, elem):
    with pytest.raises(ValueError, match=f'H={hid}'):
        _plan(hid, 3, batch, elem)


@pytest.mark.parametrize('gates,quant,cell', [(4, False, 0), (3, False, 1),
                                              (4, True, 2), (3, True, 3)])
def test_card_plan_asks_the_occupancy_of_the_cells_kernel(monkeypatch, gates,
                                                          quant, cell):
    """card_plan asks edd_rnn_fwd_blocks_per_sm for the kernel of (gates,
    quant): K1 0, K5 1, K12 2, K13 3, so K13 is not planned with K12's
    occupancy; a second call of the same shape asks nothing."""
    import types

    from edgedict_tpu_torch import _build
    from edgedict_tpu_torch.ops import rnn_bwd
    asked = []

    def blocks_per_sm(entry, index, cell_, bf16, smem):
        asked.append((entry, index, cell_, bf16, smem))
        return 1
    monkeypatch.setattr(rnn_bwd, 'card_blocks_per_sm', blocks_per_sm)
    monkeypatch.setattr(_build, 'sm_count', lambda dev: H100_SMS)
    P._card_plan.cache_clear()
    x_proj = types.SimpleNamespace(
        shape=(2, 1, gates * 1024), device=types.SimpleNamespace(index=0),
        element_size=lambda: 4)
    try:
        plan = P.card_plan(x_proj, gates, quant)
        again = P.card_plan(x_proj, gates, quant)
    finally:
        P._card_plan.cache_clear()
    smem = P.fwd_smem_bytes(1024, gates, 1, 4)
    assert asked == [('edd_rnn_fwd_blocks_per_sm', 0, cell, False, smem)]
    assert plan == again == P.FwdPlan(128, smem, 1)
    assert P.CELLS[gates, quant] == cell


@pytest.mark.parametrize('hid', [16, 72, 1024])
@pytest.mark.parametrize('elem', [2, 4])
def test_int8_gru_prologue_fills_k5_layout_once(hid, elem):
    """At G = 3 (K13) every value the int8 prologue stores goes to the
    slot K5's ws_index gives it, and the slice is filled exactly once (the
    16-byte path's model; H=72, not a multiple of 16, takes the scalar
    path on the card, which writes each slot by ws_index itself)."""
    items, k32 = _q_prologue_slots(hid, elem, gates=3)
    seen = {}
    for stores, _ in items:
        for slot, n, k in stores:
            assert slot == _ws_index(k, n, 3, k32, elem)
            seen[slot] = seen.get(slot, 0) + 1
    assert sorted(seen) == list(range(3 * P.UNITS * k32))
    assert set(seen.values()) == {1}


@pytest.mark.parametrize('gates', [3, 4])
@pytest.mark.parametrize('elem', [2, 4])
def test_int8_prologue_bank_spread_at_either_gate_count(gates, elem):
    """At G = 3 as at G = 4, a quarter warp's first 16-byte stores land on
    8 distinct 16-byte bank groups at H=1024."""
    items, _ = _q_prologue_slots(1024, elem, gates=gates)
    for quarter in range(0, 64, 8):
        units = [first % 8 for _, first in items[quarter:quarter + 8]]
        assert sorted(units) == list(range(8))


@pytest.mark.parametrize('batch', [1, 8, 32])
@pytest.mark.parametrize('elem', [2, 4])
def test_plan_at_the_legacy_and_ctc_width(batch, elem):
    """The CTC and legacy models' H=600 (not a multiple of the bf16 mma's
    K of 16: the slice is padded to 608): 75 blocks, all co-resident on
    the H100 at one block an SM."""
    plan = _plan(600, 4, batch, elem)
    assert plan.blocks == 75 <= H100_SMS
    assert plan.smem == P.fwd_smem_bytes(600, 4, batch, elem)
    assert plan.smem >= 608 * 4 * P.UNITS * elem
