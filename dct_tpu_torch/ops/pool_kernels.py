"""ENet's pool-with-mask and unpool on the card: the CUDA kernels of
``csrc/pool_mask.cu``, bound with ctypes and wrapped in autograd Functions.

Each wrapper takes dct_tpu's NHWC layout. For a tensor on the CPU it runs
the plain version (``ops/pooling.py``); for a CUDA tensor it launches the
kernel or raises: there is no fallback, not when ``nvcc`` is missing and not
when the build fails.

Kernels (see the header of ``csrc/pool_mask.cu`` for their semantics):

* ``pool_mask_fwd`` replaces ``_pool_mask_kernel`` /
  ``max_pool_2x2_with_mask_pallas`` (dct_tpu/ops/pallas_pool.py). Bound on
  an H100: bytes, x read once plus pooled and mask written once, over
  3.35 TB/s.
* ``pool_mask_bwd`` replaces JAX's autodiff of that pool. Bound: bytes, x
  and the pooled gradient read, the input gradient written. It recomputes
  the two inner maxima from the saved x rather than saving them, so the
  forward writes nothing extra.
* ``unpool_fwd`` replaces ``_unpool_kernel`` / ``mask_unpool_2x2_pallas``.
  Bound: bytes, y and the mask read, the output written.
* ``unpool_bwd`` replaces JAX's autodiff of the unpool. Bound: bytes, the
  output gradient and the mask read, the y gradient written.

All four are one kernel template on row pairs, whose two full-resolution
rows and one pooled row are contiguous spans of each tensor. The pool pair
stages a tile (a run of pooled columns of one row pair) in shared memory
with 16-byte ``cp.async`` copies, computes the windows there two channels
at a time (bf16 pairs as 32-bit SIMD words), and writes pooled, mask or gx
back as 16-byte vectors; a span's unaligned head and tail go one element a
thread inside the same kernel. The unpool pair loads and stores one pack of
channels a thread straight from and to the tensors, with no shared memory
and no loop, so all of a thread's loads are in flight at once.
:func:`pool_tiling` computes the launch (tile, grid, threads, shared
memory, pack, the magic multiplier that replaces the division by C, and
whether every span is whole 16-byte vectors), once per kernel and shape;
the C entry points reject a tiling that does not fit the shape. On the main
path: 2,048 blocks of 128 threads at each shape (unpool_fwd: 4,096 and
3,584), 2.3–5.2 KB of shared memory a pool block, 16–28 registers a thread
(``-Xptxas -v`` on an H100).

``LAUNCHES`` counts, per kernel, the launches this process has made; a run
resets it with :func:`reset_launch_counts` to show which kernels a path used.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import torch

from .pooling import mask_unpool_2x2, max_pool_2x2_with_mask

KERNELS = ("pool_mask_fwd", "pool_mask_bwd", "unpool_fwd", "unpool_bwd")
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "pool_mask.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the kernels that stage their tiles in shared memory; the unpool pair loads
# and stores one pack a thread straight from and to the tensors
STAGED = ("pool_mask_fwd", "pool_mask_bwd")

VEC_BYTES = 16            # one cp.async / uint4 access
TILE_ELEMS = 256          # pooled elements a staged tile aims at
ELEMS_PER_THREAD = 2      # pooled elements each thread computes per tile
DIRECT_THREADS = 128      # unpool pair: packs (one a thread) per block
SMEM_DEFAULT = 49_152     # dynamic shared memory a block gets unasked
SMEM_MAX = 232_448        # and at most, once the kernel is allowed it (H100)
GRID_Y_MAX = 65_535       # row pairs a grid layer covers: the pool pair loops
                          # beyond, the unpool pair adds layers (grid z)
INT32_MAX = 2**31 - 1

_lib = None
_lock = threading.Lock()


class PoolTiling(NamedTuple):
    """Launch of one kernel at one pooled shape, in the order of the C entry
    points' trailing arguments."""
    tile_w: int           # pool pair: pooled columns per tile (a row's last
                          # may be fewer); unpool pair: packs per tile
    tiles_per_row: int    # grid x
    grid_rows: int        # grid y: row pairs n * h, at most GRID_Y_MAX
    threads: int
    smem_bytes: int       # dynamic shared memory per block
    vec: int              # 0: scalar; 1: 16-byte accesses on each span's
                          # aligned body; 2: every span whole 16-byte vectors
    pack: int             # channels per access of the window math: 2 or 1
    magic: int            # ceil(2**32 / (c // pack)): division by multiply

    @property
    def blocks(self) -> int:
        """Blocks of one grid layer (all of them up to GRID_Y_MAX row pairs)."""
        return self.tiles_per_row * self.grid_rows


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _buffer_elems(length: int, v: int) -> int:
    """Shared-memory buffer of a span: one vector of padding, whole vectors
    (buffer_elems in csrc/pool_mask.cu)."""
    return (length + 2 * v - 1) // v * v


@functools.lru_cache(maxsize=256)
def pool_tiling(kernel: str, pooled_shape: Tuple[int, int, int, int],
                esize: int, aligned: bool = True) -> PoolTiling:
    """Launch of ``kernel`` (one of KERNELS) at one pooled shape; ``aligned``:
    every pointer is 16-byte aligned. Raises ValueError for what one launch
    cannot cover. Memoised: a training step launches the same few shapes
    over and over.

    The pool pair (STAGED) cuts each pooled row into tiles of about
    TILE_ELEMS elements, as even as the row allows, each tile's width a
    multiple of the columns that fill whole 16-byte vectors where C allows
    it, and gives each thread about ELEMS_PER_THREAD pooled elements; where
    ``aligned``, the aligned body of each span goes in 16-byte accesses.
    The unpool pair takes one pack a thread, DIRECT_THREADS a block: a tile
    is that many packs of one row pair (of each full-resolution row for
    unpool_fwd, of the pooled row for unpool_bwd); it reads and writes
    channel pairs in place only where ``aligned``."""
    n, h, w, c = pooled_shape
    v = VEC_BYTES // esize
    staged = kernel in STAGED
    pack = 2 if c % 2 == 0 and (staged or aligned) else 1
    magic = _cdiv(2**32, c // pack) if c // pack > 1 else 0
    if n * h * w * c == 0:
        return PoolTiling(1, 0, 0, 32, 0, int(staged and aligned), pack, magic)
    if n * h > INT32_MAX or w > INT32_MAX:
        raise ValueError(f"pooled shape {pooled_shape} is too large for one "
                         "launch")
    if not staged:
        packs = (2 if kernel == "unpool_fwd" else 1) * w * c // pack
        threads = min(DIRECT_THREADS, _cdiv(packs, 32) * 32)
        if 2 * w * c > INT32_MAX or packs * (c // pack) >= 2**32:
            raise ValueError(f"pooled shape {pooled_shape} is too large for "
                             "one launch")
        return PoolTiling(threads, _cdiv(packs, threads),
                          min(n * h, GRID_Y_MAX), threads, 0, 0, pack, magic)
    per_vec = VEC_BYTES // math.gcd(VEC_BYTES, c * esize)   # columns
    tiles_per_row = _cdiv(w, max(1, TILE_ELEMS // c))
    tile_w = min(w, _cdiv(_cdiv(w, tiles_per_row), per_vec) * per_vec)
    tiles_per_row = _cdiv(w, tile_w)
    last_w = w - (tiles_per_row - 1) * tile_w
    exact = aligned and all(k * c % v == 0 for k in (w, tile_w, last_w))
    threads = min(1024, _cdiv(_cdiv(tile_w * c, ELEMS_PER_THREAD), 32) * 32)
    smem = esize * (2 * _buffer_elems(2 * tile_w * c, v)
                    + _buffer_elems(tile_w * c, v))
    if smem > SMEM_MAX:
        raise ValueError(f"C = {c} needs {smem} bytes of shared memory for one "
                         f"pooled column, more than a block has ({SMEM_MAX})")
    if tile_w * c * (c // pack) >= 2**32:
        raise ValueError(f"pooled shape {pooled_shape} is too large for one "
                         "launch")
    return PoolTiling(tile_w, tiles_per_row, min(n * h, GRID_Y_MAX), threads,
                      smem, 2 if exact else int(aligned), pack, magic)


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the pool kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> str:
    """Compile ``csrc/pool_mask.cu`` into ``build/kernels/`` (again only when
    the source or the flags change) and load it. Returns nvcc's output, or
    "" when the library was already built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return ""
        digest = hashlib.sha256(SOURCE.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"libpool_mask_{digest}.so"
        log = ""
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                   str(SOURCE)], capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE}:\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name in KERNELS:
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                           + [ctypes.c_int] * 7 + [ctypes.c_uint])
            fn.restype = ctypes.c_int
        _lib = lib
        return log


def _launch(name: str, p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
            pooled_shape: Tuple[int, int, int, int]) -> None:
    """Launch kernel ``name`` on the current stream of p0's device; the
    pointers go in the entry point's order, sizes are the pooled tensor's."""
    build()
    dev = p0.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    n, h, w, c = pooled_shape
    ptrs = (p0.data_ptr(), p1.data_ptr(), p2.data_ptr())
    tiling = pool_tiling(name, tuple(pooled_shape), p0.element_size(),
                         all(p % VEC_BYTES == 0 for p in ptrs))
    rc = getattr(_lib, name)(*ptrs, n, h, w, c, int(p0.dtype == torch.bfloat16),
                             dev.index, stream, *tiling)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


class _PoolMask(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        n, hh, ww, c = x.shape
        pooled = torch.empty((n, hh // 2, ww // 2, c), dtype=x.dtype,
                             device=x.device)
        mask = torch.empty_like(x)
        _launch("pool_mask_fwd", x, pooled, mask, pooled.shape)
        ctx.save_for_backward(x)
        ctx.mark_non_differentiable(mask)
        return pooled, mask

    @staticmethod
    def backward(ctx, g_pooled, _g_mask):
        (x,) = ctx.saved_tensors
        g = g_pooled.contiguous()
        gx = torch.empty_like(x)
        _launch("pool_mask_bwd", x, g, gx, g.shape)
        return gx


class _Unpool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mask):
        n, h, w, c = y.shape
        out = torch.empty_like(mask)
        _launch("unpool_fwd", y, mask, out, y.shape)
        ctx.save_for_backward(mask)
        return out

    @staticmethod
    def backward(ctx, g_out):
        (mask,) = ctx.saved_tensors
        g = g_out.contiguous()
        gy = torch.empty((g.shape[0], g.shape[1] // 2, g.shape[2] // 2,
                          g.shape[3]), dtype=g.dtype, device=g.device)
        _launch("unpool_bwd", g, mask, gy, gy.shape)
        return gy, None


# The kernels take fp32 and bf16. The plain CPU path also takes float64, in
# which the tests hold the port to dct_tpu's exact arithmetic.
_DTYPES = {"cuda": (torch.float32, torch.bfloat16),
           "cpu": (torch.float32, torch.bfloat16, torch.float64)}


def _check_nhwc(t: torch.Tensor, name: str) -> None:
    if t.dim() != 4:
        raise ValueError(f"{name} must be NHWC (4-D), got shape {tuple(t.shape)}")
    if t.device.type not in _DTYPES:
        raise ValueError(f"{name} lies on unsupported device {t.device}")
    if t.dtype not in _DTYPES[t.device.type]:
        raise TypeError(f"{name} must be one of {_DTYPES[t.device.type]} on "
                        f"{t.device.type}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous NHWC tensor")


def max_pool_2x2_with_mask_kernel(x: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,H,W,C) → (pooled (B,H/2,W/2,C), argmax mask (B,H,W,C))."""
    _check_nhwc(x, "x")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"H and W must be even, got {tuple(x.shape[1:3])}")
    if x.device.type == "cpu":
        return max_pool_2x2_with_mask(x)
    return _PoolMask.apply(x)


def mask_unpool_2x2_kernel(y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """y (B,h,w,C), mask (B,2h,2w,C) → y placed at the mask's argmax."""
    _check_nhwc(y, "y")
    _check_nhwc(mask, "mask")
    b, h, w, c = y.shape
    if tuple(mask.shape) != (b, 2 * h, 2 * w, c):
        raise ValueError(f"mask shape {tuple(mask.shape)} does not match "
                         f"y shape {tuple(y.shape)}")
    if mask.dtype != y.dtype or mask.device != y.device:
        raise TypeError("y and mask must share dtype and device")
    if y.device.type == "cpu":
        return mask_unpool_2x2(y, mask)
    return _Unpool.apply(y, mask)
