"""Weight-only quantization (tts_tpu/quant counterpart): int8 and int4 weights."""
from .weight_only import (QTensor, QTensor4, QTensorG, dense, dequantize, quantize_int4,
                          quantize_int4_jit, quantize_int8_eager, quantize_int8_jit,
                          quantize_pytree)

__all__ = ["QTensor", "QTensor4", "QTensorG", "dense", "dequantize", "quantize_int4",
           "quantize_int4_jit", "quantize_int8_eager", "quantize_int8_jit", "quantize_pytree"]
