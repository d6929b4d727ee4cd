"""F5 synthesis pipeline (tts_tpu/runtime counterpart)."""
