"""Parameter conversion from tts_tpu pytrees."""
