"""DSP: windows, STFT/ISTFT and log-mel (tts_tpu/audio counterparts)."""
