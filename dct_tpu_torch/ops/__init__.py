"""Tensor ops: pooling (plain versions and CUDA kernels) and affine warps."""
from .pooling import max_pool_2x2, max_pool_2x2_with_mask, mask_unpool_2x2  # noqa: F401
from .warp import affine_warp, make_affine  # noqa: F401
