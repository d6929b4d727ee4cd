"""Text frontend (F5): tts_tpu's, with a jieba-free path for ASCII text."""
