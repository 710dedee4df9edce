"""The launch plan of K4/K6's persistent chain kernel (ops/rnn_bwd.py) on
the CPU: for the E6D2 shapes (encoder H=1024 LSTM and GRU, prediction net
H=256) and the odd shapes the card tests and the smoke use, at the H100's
132 SMs, the grid is co-resident, every hidden unit is owned by exactly one
block, and a block's shared memory fits the card, in both dtypes; a hidden
size beyond the plan raises ValueError naming the shape."""

import pytest

from edgedict_tpu_torch.ops import rnn_bwd as P

H100_SMS = 132


def resident_blocks_per_sm(smem, regs_per_thread=128):
    """The H100's limits on resident blocks of P.THREADS threads and `smem`
    dynamic bytes per SM: 228 KB of shared memory with 1 KB reserved per
    block, 2048 threads, 64K registers (128 a thread, as ptxas gives the
    chain kernels).  The wrapper asks the card instead
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    if smem > P.SMEM_PER_BLOCK:
        return 0
    return min(233472 // (smem + 1024), 2048 // P.THREADS,
               65536 // (regs_per_thread * P.THREADS))


SHAPES = [(1024, 4), (1024, 3), (256, 4), (1030, 4), (1030, 3), (40, 3),
          (40, 4), (16, 4), (16, 3), (64, 4), (600, 4)]


def _plan(hid, gates, batch, elem):
    smem = P.chain_smem_bytes(hid, gates, batch, elem)
    return P.chain_plan(hid, gates, batch, elem, H100_SMS,
                        resident_blocks_per_sm(smem))


@pytest.mark.parametrize('hid,gates', SHAPES)
@pytest.mark.parametrize('elem', [2, 4])
@pytest.mark.parametrize('batch', [1, 5, 11, 32, 33])
def test_plan_is_co_resident_and_covers_every_unit(hid, gates, elem, batch):
    plan = _plan(hid, gates, batch, elem)
    smem = P.chain_smem_bytes(hid, gates, batch, elem)
    assert plan.smem == smem <= P.SMEM_PER_BLOCK
    assert plan.blocks <= H100_SMS * resident_blocks_per_sm(smem)
    owners = [0] * hid
    for blk in range(plan.blocks):
        for u in range(blk * P.UNITS, min(hid, (blk + 1) * P.UNITS)):
            owners[u] += 1
    assert owners == [1] * hid
    assert (plan.blocks - 1) * P.UNITS < hid   # no block owns nothing


def test_plan_holds_the_whole_weight_slice():
    # the slice is G·H rounded up to 32 rows of UNITS columns, at least the
    # column slice itself: E6D2's LSTM layer in bf16 is 64 KB of it
    assert P.chain_smem_bytes(1024, 4, 32, 2) >= 4 * 1024 * P.UNITS * 2
    assert P.chain_smem_bytes(1024, 4, 32, 2) - 4 * 1024 * P.UNITS * 2 \
        == P.WARPS * 32 * P.UNITS * 4 + 2 * 32 * P.UNITS * 4


@pytest.mark.parametrize('hid,gates,elem', [(2048, 4, 4), (4096, 4, 2),
                                            (3000, 3, 4), (8192, 3, 2)])
def test_hidden_size_beyond_the_plan_raises(hid, gates, elem):
    with pytest.raises(ValueError, match=f'H={hid}'):
        _plan(hid, gates, 32, elem)


def test_grid_not_co_resident_raises():
    # 1056 units fit 132 blocks of 8, one block per SM; 1064 do not
    P.chain_plan(1056, 4, 32, 4, H100_SMS, 1)
    with pytest.raises(ValueError, match='H=1064'):
        P.chain_plan(1064, 4, 32, 4, H100_SMS, 1)
    with pytest.raises(ValueError, match='H=16'):
        P.chain_plan(16, 4, 32, 2, H100_SMS, 0)


@pytest.mark.parametrize('hid,gates,batch,elem', [(0, 4, 1, 2), (16, 2, 1, 2),
                                                  (16, 4, 0, 4),
                                                  (16, 4, 1, 8)])
def test_degenerate_shapes_raise(hid, gates, batch, elem):
    with pytest.raises(ValueError, match=f'H={hid}'):
        P.chain_plan(hid, gates, batch, elem, H100_SMS, 1)


@pytest.mark.parametrize('batch', [1, 8, 32])
@pytest.mark.parametrize('elem', [2, 4])
def test_chain_plan_at_the_legacy_and_ctc_width(batch, elem):
    """The CTC and legacy models' H=600: 75 chain blocks, co-resident on
    the H100, each holding its 2400 gate rows of W_hh (a multiple of 32)."""
    plan = _plan(600, 4, batch, elem)
    assert plan.blocks == 75 <= H100_SMS
    assert plan.smem == P.chain_smem_bytes(600, 4, batch, elem)
    assert plan.smem >= 2400 * P.UNITS * elem
