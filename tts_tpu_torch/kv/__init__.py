"""The static-shape KV cache (tts_tpu/kv counterpart)."""
