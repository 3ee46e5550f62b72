"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

``softthresh``          fused prox update + line-search stats (kernel 1)
``blocksparse_matmul``  block-sparse x dense product (kernel 2)
``ops``                 device dispatch and launch counts
``ref``                 the plain versions every kernel is held against
``build``               nvcc build of ``csrc/*.cu`` at first use

Importing the package builds nothing and needs no CUDA toolkit.
"""
from . import ops, ref  # noqa: F401
