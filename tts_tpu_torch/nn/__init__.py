"""Shared layers: LayerNorm and RoPE tables (tts_tpu/nn counterparts)."""
