"""Tensor ops: pooling (plain versions and CUDA kernels) and affine warps."""
