"""Shared layers: LayerNorm, RMSNorm, RoPE and GQA attention (tts_tpu/nn counterparts)."""
