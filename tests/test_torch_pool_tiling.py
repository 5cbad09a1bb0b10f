"""The launch of the tiled pool kernels, computed on the CPU.

``pool_tiling`` decides how ``pool_mask_fwd`` and ``pool_mask_bwd`` cut a
pooled shape into row-pair tiles: tile ``j`` of a row pair takes the pooled
columns ``[j * tile_w, min((j + 1) * tile_w, w))`` and the input columns
twice that, grid row ``y`` takes the row pairs ``y, y + grid_rows, ...``.
These tests check the tiling's own properties: the tiles cover every
element exactly once, 16-byte accesses are only asked where every span is
whole vectors, the shared memory fits. The kernels themselves run only on
the card, where ``chip_smoke.py`` holds them bit-equal to the plain versions
at the same shapes, ragged ones included.
"""
import numpy as np
import pytest

from dct_tpu_torch.ops import pool_kernels
from dct_tpu_torch.ops.pool_kernels import (GRID_Y_MAX, SMEM_DEFAULT, SMEM_MAX,
                                            VEC_BYTES, pool_tiling)

MAIN_PATH = [(8, 128, 128, 14), (8, 64, 64, 64)]       # ENet bottleneck_1_0, 2_0
RAGGED = [(1, 2, 2, 1), (3, 6, 10, 3), (2, 130, 34, 14),
          (2, 6, 14, 5),                               # w * c = 35, odd
          (2, 6, 10, 4)]                               # pairs, ragged
WIDE = (1, 2, 4, 4096)        # over 48 KB of shared memory a block in fp32
TALL = (2, 65538, 4, 2)       # more row pairs than a grid has rows
SHAPES = MAIN_PATH + RAGGED + [WIDE, TALL]
DTYPES = {"float32": 4, "bfloat16": 2}
SMS = 132                                              # H100 SXM


def pooled_of(x_shape):
    n, hh, ww, c = x_shape
    return (n, hh // 2, ww // 2, c)


def last_w(tiling, w):
    return w - (tiling.tiles_per_row - 1) * tiling.tile_w


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape", SHAPES)
def test_tiles_cover_each_element_once(x_shape, dtype):
    n, h, w, c = pooled_of(x_shape)
    tiling = pool_tiling((n, h, w, c), DTYPES[dtype])
    # no tile of a row is empty, and the last one reaches the row's end
    assert (tiling.tiles_per_row - 1) * tiling.tile_w < w <= (
        tiling.tiles_per_row * tiling.tile_w)
    pooled_row, input_row = np.zeros(w * c, np.int32), np.zeros(2 * w * c, np.int32)
    for j in range(tiling.tiles_per_row):
        j0, j1 = j * tiling.tile_w, min((j + 1) * tiling.tile_w, w)
        pooled_row[j0 * c:j1 * c] += 1
        input_row[2 * j0 * c:2 * j1 * c] += 1
    assert (pooled_row == 1).all()        # every pooled element in one tile
    assert (input_row == 1).all()         # each input row covered once
    # grid row y takes row pairs y, y + grid_rows, ...: each once, none idle
    assert tiling.grid_rows == min(n * h, GRID_Y_MAX)
    assert tiling.blocks == tiling.tiles_per_row * tiling.grid_rows


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape", SHAPES)
def test_vector_accesses_only_on_whole_vectors(x_shape, dtype, aligned):
    esize = DTYPES[dtype]
    n, h, w, c = pooled_of(x_shape)
    tiling = pool_tiling((n, h, w, c), esize, aligned)
    v = VEC_BYTES // esize
    if not aligned:         # a pointer off 16 bytes: every access scalar
        assert tiling.vec == 0
    else:
        assert tiling.vec in (1, 2)
    spans = (w * c, tiling.tile_w * c, last_w(tiling, w) * c)
    # vec 2 compiles no head or tail code: every tile's spans (row starts,
    # tile starts, tile lengths) must then be whole 16-byte vectors
    assert (tiling.vec == 2) == (aligned and all(k % v == 0 for k in spans))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape", SHAPES)
def test_shared_memory_fits(x_shape, dtype):
    esize = DTYPES[dtype]
    shape = pooled_of(x_shape)
    tiling = pool_tiling(shape, esize)
    c = shape[3]
    # two input buffers and one pooled buffer, each padded by one vector
    need = esize * (2 * 2 * tiling.tile_w * c + tiling.tile_w * c)
    assert need <= tiling.smem_bytes <= need + 3 * 2 * VEC_BYTES
    assert tiling.smem_bytes <= SMEM_MAX
    if x_shape != WIDE:                   # the kernel is not asked for more
        assert tiling.smem_bytes <= SMEM_DEFAULT
    assert tiling.threads % 32 == 0 and 32 <= tiling.threads <= 1024


def test_wide_channels_ask_for_more_shared_memory():
    """One pooled column of 4096 fp32 channels needs more than 48 KB (the
    kernel is then allowed it); one of 20000 does not fit a block and is
    rejected rather than launched."""
    tiling = pool_tiling(pooled_of(WIDE), 4)
    assert tiling.tile_w == 1 and SMEM_DEFAULT < tiling.smem_bytes <= SMEM_MAX
    assert pool_tiling(pooled_of(WIDE), 2).smem_bytes <= SMEM_DEFAULT
    with pytest.raises(ValueError):
        pool_tiling((1, 1, 1, 20000), 4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape", MAIN_PATH)
def test_main_path_runs_on_the_vector_body(x_shape, dtype):
    tiling = pool_tiling(pooled_of(x_shape), DTYPES[dtype])
    assert tiling.vec == 2
    assert tiling.blocks >= 4 * SMS                   # several tiles per SM


def test_empty_shape_launches_no_tile():
    assert pool_tiling((0, 4, 4, 14), 2).blocks == 0


def test_tiling_is_memoised():
    pool_tiling.cache_clear()
    a = pool_tiling(pooled_of(MAIN_PATH[0]), 2, True)
    assert pool_tiling(pooled_of(MAIN_PATH[0]), 2, True) is a
    assert pool_tiling.cache_info().hits == 1


def test_tiled_kernels_take_the_tiling_arguments():
    assert set(pool_kernels.TILED) == {"pool_mask_fwd", "pool_mask_bwd"}
    assert set(pool_kernels.TILED) < set(pool_kernels.KERNELS)
    assert pool_tiling(pooled_of(MAIN_PATH[0]), 2)._fields == (
        "tile_w", "tiles_per_row", "grid_rows", "threads", "smem_bytes", "vec",
        "pack", "magic")


@pytest.mark.parametrize("x_shape", SHAPES + [(1, 2, 8, 1000)])
def test_magic_multiplier_divides_exactly(x_shape):
    """The kernel finds a pack's column as umulhi(pack, magic) instead of
    pack // (c / pack_size): exact for every pack a tile holds."""
    shape = pooled_of(x_shape)
    c = shape[3]
    for esize in DTYPES.values():
        t = pool_tiling(shape, esize)
        assert c % t.pack == 0
        cn = c // t.pack
        kk = np.arange(t.tile_w * cn, dtype=np.uint64)
        col = kk if cn == 1 else (kk * np.uint64(t.magic)) >> np.uint64(32)
        np.testing.assert_array_equal(col, kk // np.uint64(cn))
