"""Shared layers: LayerNorm, RMSNorm, L2 norm, RoPE and GQA attention (tts_tpu/nn counterparts)."""
from .attention import attention_mask, gqa_attention
from .norm import l2_norm, layer_norm, rms_norm
from .rope import apply_rope, apply_rope_interleaved, rope_table, rope_table_interleaved

__all__ = [
    "attention_mask", "gqa_attention", "l2_norm", "layer_norm", "rms_norm",
    "apply_rope", "apply_rope_interleaved", "rope_table", "rope_table_interleaved",
]
