"""Model families (tts_tpu/models counterparts): F5-TTS and Vocos."""
