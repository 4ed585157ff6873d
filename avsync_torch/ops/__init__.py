"""Tensor ops of the port; hand-written CUDA kernels live in `ops.cuda`."""
