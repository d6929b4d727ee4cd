"""Weight-only quantization (tts_tpu/quant counterpart): the float path."""
