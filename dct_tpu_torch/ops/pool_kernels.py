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
  3.35 TB/s. One thread per pooled element, channels fastest, so every
  access coalesces for any C.
* ``pool_mask_bwd`` replaces JAX's autodiff of that pool. Bound: bytes, x
  and the pooled gradient read, the input gradient written. It recomputes
  the two inner maxima from the saved x rather than saving them, so the
  forward writes nothing extra.
* ``unpool_fwd`` replaces ``_unpool_kernel`` / ``mask_unpool_2x2_pallas``.
  Bound: bytes, y and the mask read, the output written.
* ``unpool_bwd`` replaces JAX's autodiff of the unpool. Bound: bytes, the
  output gradient and the mask read, the y gradient written.

``LAUNCHES`` counts, per kernel, the launches this process has made; a run
resets it with :func:`reset_launch_counts` to show which kernels a path used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from .pooling import mask_unpool_2x2, max_pool_2x2_with_mask

KERNELS = ("pool_mask_fwd", "pool_mask_bwd", "unpool_fwd", "unpool_bwd")
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "pool_mask.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lock = threading.Lock()


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
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
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
    rc = getattr(_lib, name)(p0.data_ptr(), p1.data_ptr(), p2.data_ptr(),
                             n, h, w, c, int(p0.dtype == torch.bfloat16),
                             dev.index, stream)
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
