"""Ops: conv1d, and the CUDA kernels with their plain twins."""
