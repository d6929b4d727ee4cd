"""Ops: conv1d, and the CUDA kernels with their plain twins."""
from .conv import conv1d, conv_transpose1d, depthwise_conv1d

__all__ = ["conv1d", "conv_transpose1d", "depthwise_conv1d"]
