"""K11's launch plan (ops/quant.py:quant_plan) on the CPU: the split between
the matrix-vector kernel (R <= 32) and the tiled kernels, the tile grid
covering every output once at the int8 server's and the smoke's shapes, and
ValueError for an empty shape."""

import pytest

from edgedict_tpu_torch.ops import quant as Q

# x_proj of the int8 encoder (layer 0 K=240, later K=1024; N = 4H or 3H)
# and the final projection (N=640), plus ragged shapes
SHAPES = [(240, 4096), (1024, 4096), (1024, 3072), (1024, 640), (13, 7),
          (240, 640)]


@pytest.mark.parametrize('rows', [1, 2, 3, 8, 16, 17, 24, 30, 31, 32])
def test_up_to_32_rows_take_the_matrix_vector_kernel(rows):
    for k, n in SHAPES:
        assert Q.quant_plan(rows, k, n) is False


@pytest.mark.parametrize('rows', [33, 64, 128, 256, 512, 4096])
@pytest.mark.parametrize('k,n', SHAPES)
def test_above_32_rows_the_tile_grid_covers_every_output_once(rows, k, n):
    assert Q.quant_plan(rows, k, n) is True
    bm, bn = Q.TILE_ROWS, Q.TILE_COLS
    grid_m, grid_n = -(-rows // bm), -(-n // bn)
    # output (r, c) belongs to block (r // bm, c // bn): every row and every
    # column in exactly one block row / column, and no block empty
    for size, tile, grid in ((rows, bm, grid_m), (n, bn, grid_n)):
        owners = [0] * size
        for blk in range(grid):
            for i in range(blk * tile, min(size, (blk + 1) * tile)):
                owners[i] += 1
        assert owners == [1] * size
        assert (grid - 1) * tile < size


def test_the_int8_server_and_the_smoke_take_the_tiles():
    # the int8 server at 64 streams: x_proj R = 128, 64 after the time
    # reduction; the smoke's R = 512
    for rows in (64, 128, 512):
        for k, n in SHAPES[:4]:
            assert Q.quant_plan(rows, k, n)
    # one stream (R = 2) and the 8-stream server (R = 16) stay on the GEMV
    assert not Q.quant_plan(2, 1024, 4096) and not Q.quant_plan(16, 240, 4096)


@pytest.mark.parametrize('rows,k,n', [(0, 16, 16), (64, 0, 16), (64, 16, 0),
                                      (-1, 16, 16)])
def test_empty_shape_raises(rows, k, n):
    with pytest.raises(ValueError, match=f'R={rows} K={k} N={n}'):
        Q.quant_plan(rows, k, n)
