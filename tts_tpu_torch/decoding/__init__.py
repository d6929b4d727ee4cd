"""Token selection: greedy, repetition penalty, beam search (tts_tpu/decoding counterpart)."""
