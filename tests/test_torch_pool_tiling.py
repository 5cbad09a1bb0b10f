"""The launch of the pool and unpool kernels, computed on the CPU.

``pool_tiling`` decides how each kernel cuts a pooled shape. The pool pair
stages row-pair tiles: tile ``j`` of a row pair takes the pooled columns
``[j * tile_w, min((j + 1) * tile_w, w))`` and the input columns twice that,
grid row ``y`` takes the row pairs ``y, y + grid_rows, ...``. The unpool
pair takes one pack of channels a thread: tile ``j`` of a row pair is the
packs ``[j * tile_w, (j + 1) * tile_w)`` of each full-resolution row
(unpool_fwd) or of the pooled row (unpool_bwd), and row pairs beyond the
grid's rows take its third dimension. These tests check the tiling's own
properties: every element is covered exactly once, 16-byte accesses are only
asked where every span is whole vectors, the shared memory fits. The
kernels themselves run only on the card, where ``chip_smoke.py`` holds them
bit-equal to the plain versions at the same shapes, ragged ones included.
"""
import numpy as np
import pytest

from dct_tpu_torch.ops import pool_kernels
from dct_tpu_torch.ops.pool_kernels import (DIRECT_THREADS, GRID_Y_MAX, KERNELS,
                                            SMEM_DEFAULT, SMEM_MAX, STAGED,
                                            VEC_BYTES, pool_tiling)

MAIN_PATH = [(8, 128, 128, 14), (8, 64, 64, 64)]       # ENet bottleneck_1_0, 2_0
# the eval step's forwards take one padded patient bucket: L slices, L a
# multiple of 8 (8 is the main path's batch; 16 for ACDC-sized patients)
EVAL = [(16, 128, 128, 14), (16, 64, 64, 64)]
RAGGED = [(1, 2, 2, 1), (3, 6, 10, 3), (2, 130, 34, 14),
          (2, 6, 14, 5),                               # w * c = 35, odd
          (2, 6, 10, 4)]                               # pairs, ragged
WIDE = (1, 2, 4, 4096)        # over 48 KB of shared memory a block in fp32
TALL = (2, 65538, 4, 2)       # more row pairs than a grid has rows
SHAPES = MAIN_PATH + EVAL + RAGGED + [WIDE, TALL]
DTYPES = {"float32": 4, "bfloat16": 2}
SMS = 132                                              # H100 SXM
# buffers a block stages: two full-resolution rows and one pooled row
STAGED_BUFFERS = {"pool_mask_fwd": (2, 1), "pool_mask_bwd": (2, 1),
                  "unpool_fwd": (0, 0), "unpool_bwd": (0, 0)}


def pooled_of(x_shape):
    n, hh, ww, c = x_shape
    return (n, hh // 2, ww // 2, c)


def last_w(tiling, w):
    return w - (tiling.tiles_per_row - 1) * tiling.tile_w


def direct_packs(kernel, shape, tiling):
    """Packs of a row pair the unpool kernel walks, one a thread."""
    _, _, w, c = shape
    return (2 if kernel == "unpool_fwd" else 1) * w * c // tiling.pack


def test_kernels_split_into_staged_and_direct():
    assert set(STAGED) == {"pool_mask_fwd", "pool_mask_bwd"} < set(KERNELS)
    assert set(STAGED_BUFFERS) == set(KERNELS)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape", SHAPES)
def test_tiles_cover_each_element_once(x_shape, dtype, kernel):
    n, h, w, c = shape = pooled_of(x_shape)
    tiling = pool_tiling(kernel, shape, DTYPES[dtype])
    pooled_row, input_row = np.zeros(w * c, np.int32), np.zeros(2 * w * c, np.int32)
    if kernel in STAGED:
        # no tile of a row is empty, and the last one reaches the row's end
        assert (tiling.tiles_per_row - 1) * tiling.tile_w < w <= (
            tiling.tiles_per_row * tiling.tile_w)
        for j in range(tiling.tiles_per_row):
            j0, j1 = j * tiling.tile_w, min((j + 1) * tiling.tile_w, w)
            pooled_row[j0 * c:j1 * c] += 1
            input_row[2 * j0 * c:2 * j1 * c] += 1
        assert (pooled_row == 1).all()    # every pooled element in one tile
    else:
        packs, p = direct_packs(kernel, shape, tiling), tiling.pack
        assert tiling.threads == tiling.tile_w            # one pack a thread
        assert (tiling.tiles_per_row - 1) * tiling.tile_w < packs <= (
            tiling.tiles_per_row * tiling.tile_w)
        kk = np.arange(tiling.tiles_per_row * tiling.tile_w)
        kk = kk[kk < packs]                               # the rest return
        lanes = np.arange(p)
        if kernel == "unpool_fwd":    # a pack of each full row, and its y
            e = (p * kk)[:, None] + lanes
            input_row[e.ravel()] += 1
            q = kk // (c // p)
            np.add.at(pooled_row, (e - ((q + 1) // 2 * c)[:, None]).ravel(), 1)
            assert (pooled_row == 2).all()    # y: once for each column of its window
        else:                         # a pooled pack, and its corners
            ia = p * kk + kk // (c // p) * c
            pooled_row[((p * kk)[:, None] + lanes).ravel()] += 1
            for corner in (ia, ia + c):
                input_row[(corner[:, None] + lanes).ravel()] += 1
            assert (pooled_row == 1).all()
    assert (input_row == 1).all()         # each full-resolution row once
    # grid row y takes row pairs y, y + grid_rows, ... (pool pair) or the
    # row pair of each grid layer (unpool pair): each once, none idle
    assert tiling.grid_rows == min(n * h, GRID_Y_MAX)
    assert tiling.blocks == tiling.tiles_per_row * tiling.grid_rows


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape", SHAPES)
def test_vector_accesses_only_on_whole_vectors(x_shape, dtype, aligned, kernel):
    esize = DTYPES[dtype]
    n, h, w, c = pooled_of(x_shape)
    tiling = pool_tiling(kernel, (n, h, w, c), esize, aligned)
    if kernel not in STAGED:
        # no 16-byte access; channel pairs in place only from aligned pointers
        assert tiling.vec == 0
        assert tiling.pack == (2 if aligned and c % 2 == 0 else 1)
        return
    v = VEC_BYTES // esize
    if not aligned:         # a pointer off 16 bytes: every access scalar
        assert tiling.vec == 0
    else:
        assert tiling.vec in (1, 2)
    spans = (w * c, tiling.tile_w * c, last_w(tiling, w) * c)
    # vec 2 compiles no head or tail code: every tile's spans (row starts,
    # tile starts, tile lengths) must then be whole 16-byte vectors
    assert (tiling.vec == 2) == (aligned and all(k % v == 0 for k in spans))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape", SHAPES)
def test_shared_memory_fits(x_shape, dtype, kernel):
    esize = DTYPES[dtype]
    shape = pooled_of(x_shape)
    tiling = pool_tiling(kernel, shape, esize)
    c = shape[3]
    full, pooled = STAGED_BUFFERS[kernel]
    # each staged buffer padded by one vector
    need = esize * (full * 2 * tiling.tile_w * c + pooled * tiling.tile_w * c)
    assert need <= tiling.smem_bytes <= need + (full + pooled) * 2 * VEC_BYTES
    assert tiling.smem_bytes <= SMEM_MAX
    if x_shape != WIDE:                   # the kernel is not asked for more
        assert tiling.smem_bytes <= SMEM_DEFAULT
    assert tiling.threads % 32 == 0 and 32 <= tiling.threads <= 1024
    if kernel not in STAGED:
        assert tiling.threads <= DIRECT_THREADS


def test_wide_channels_ask_for_more_shared_memory():
    """One pooled column of 4096 fp32 channels needs more than 48 KB (the
    pool kernels are then allowed it); one of 20000 does not fit a block and
    is rejected rather than launched. The unpool pair stages nothing."""
    for kernel in STAGED:
        tiling = pool_tiling(kernel, pooled_of(WIDE), 4)
        assert tiling.tile_w == 1 and SMEM_DEFAULT < tiling.smem_bytes <= SMEM_MAX
        assert pool_tiling(kernel, pooled_of(WIDE), 2).smem_bytes <= SMEM_DEFAULT
        with pytest.raises(ValueError):
            pool_tiling(kernel, (1, 1, 1, 20000), 4)
    for kernel in ("unpool_fwd", "unpool_bwd"):
        assert pool_tiling(kernel, (1, 1, 1, 20000), 4).smem_bytes == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape", MAIN_PATH + EVAL)
def test_main_path_runs_on_the_vector_body(x_shape, dtype):
    for kernel in STAGED:
        tiling = pool_tiling(kernel, pooled_of(x_shape), DTYPES[dtype])
        assert tiling.vec == 2
        assert tiling.blocks >= 4 * SMS               # several tiles per SM


@pytest.mark.parametrize("kernel", ["unpool_fwd", "unpool_bwd"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("y_shape", [(8, 32, 32, 64), (8, 64, 64, 14),
                                     (16, 32, 32, 64), (16, 64, 64, 14)])
def test_unpool_main_path_takes_channel_pairs(y_shape, dtype, kernel):
    """ENet's bottleneck_4_0 and 5_0, in training (8 images) and in eval
    (a bucket of 16): one 2-channel pack a thread, full blocks of
    DIRECT_THREADS, one grid layer, several blocks per SM."""
    tiling = pool_tiling(kernel, y_shape, DTYPES[dtype])
    assert tiling.pack == 2 and tiling.threads == DIRECT_THREADS
    assert tiling.grid_rows == y_shape[0] * y_shape[1]
    assert tiling.blocks >= 4 * SMS


def test_tall_shapes_take_grid_layers():
    """Row pairs beyond GRID_Y_MAX: the pool pair loops over them in its grid
    rows, the unpool pair's entry point adds grid layers; both launches
    name GRID_Y_MAX rows."""
    shape = pooled_of(TALL)
    for kernel in KERNELS:
        assert pool_tiling(kernel, shape, 2).grid_rows == GRID_Y_MAX < shape[0] * shape[1]
        with pytest.raises(ValueError):                # n * h over 2**31 - 1
            pool_tiling(kernel, (2**16, 2**15, 1, 2), 2)


@pytest.mark.parametrize("kernel", KERNELS)
def test_empty_shape_launches_no_tile(kernel):
    assert pool_tiling(kernel, (0, 4, 4, 14), 2).blocks == 0


def test_tiling_is_memoised():
    pool_tiling.cache_clear()
    a = pool_tiling("pool_mask_fwd", pooled_of(MAIN_PATH[0]), 2, True)
    assert pool_tiling("pool_mask_fwd", pooled_of(MAIN_PATH[0]), 2, True) is a
    assert pool_tiling.cache_info().hits == 1
    assert pool_tiling("unpool_fwd", pooled_of(MAIN_PATH[0]), 2, True) != a


def test_tiled_kernels_take_the_tiling_arguments():
    """All four entry points take the same eight trailing tiling arguments,
    in PoolTiling's order."""
    assert not hasattr(pool_kernels, "TILED")
    for kernel in KERNELS:
        tiling = pool_tiling(kernel, pooled_of(MAIN_PATH[0]), 2)
        assert tiling._fields == (
            "tile_w", "tiles_per_row", "grid_rows", "threads", "smem_bytes",
            "vec", "pack", "magic")
        assert all(isinstance(v, int) for v in tiling)


@pytest.mark.parametrize("x_shape", SHAPES + [(1, 2, 8, 1000)])
def test_magic_multiplier_divides_exactly(x_shape):
    """The kernels find a pack's column as umulhi(pack, magic) instead of
    pack // (c / pack_size): exact for every pack a tile or a row holds."""
    shape = pooled_of(x_shape)
    c = shape[3]
    for kernel in KERNELS:
        for esize in DTYPES.values():
            t = pool_tiling(kernel, shape, esize)
            assert c % t.pack == 0
            cn = c // t.pack
            packs = (t.tile_w * cn if kernel in STAGED
                     else direct_packs(kernel, shape, t))
            kk = np.arange(packs, dtype=np.uint64)
            col = kk if cn == 1 else (kk * np.uint64(t.magic)) >> np.uint64(32)
            np.testing.assert_array_equal(col, kk // np.uint64(cn))
