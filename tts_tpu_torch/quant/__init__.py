"""Weight-only quantization (tts_tpu/quant counterpart): float and int8 weights."""
