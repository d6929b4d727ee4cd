"""tts_tpu_torch: the PyTorch/CUDA port of tts_tpu, for NVIDIA Hopper.

It mirrors tts_tpu's module paths and function names (tts_tpu is the
reference it is tested against) and imports neither JAX nor anything of
tts_tpu: what it needs of that package is copied. So far it holds F5-TTS
synthesis (float, W8A8 int8 and int4 DiT weights), KaniTTS, Qwen3-TTS and
IndexTTS-1.5 synthesis from token ids, and the BigVGAN vocoder:
  audio/     - windows, STFT/ISTFT as framed matmuls, log-mel (tts_tpu's
               options), snake and snake_beta, kaiser-sinc filters and the
               anti-aliased 2x resampling
  nn/        - LayerNorm, RMSNorm, RoPE, GQA attention
  kv/        - the static KV cache, written in place
  decoding/  - greedy, repetition penalty, beam search
  ops/       - conv1d, conv_transpose1d, and the hand-written CUDA kernels
               (flash_attention, grouped_conv, dit_mlp incl. its W8A8 form
               and quant_matmul for the F5 DiT; decode_qkv, decode_step,
               decode_attention and decode_mlp (incl. its W8A8 form) for
               AR decode; bigvgan_stage, the fused AMP resblock) with their
               plain PyTorch twins; _build compiles csrc/ with nvcc at
               first use
  quant/     - dense; int8 (eager and jitted scale forms) and int4
               weight-only quantization
  models/    - F5 DiT (float and W8A8 block routes), Vocos, the Kani LFM2
               LM and NanoCodec, the Qwen3-TTS talker and code predictor
               (qwen_tts, every decode route) and its 12 Hz codec decoder
               (qwen_codec), BigVGAN (AMPBlock1/2, speaker conditioning),
               the IndexTTS conformer, perceiver, ECAPA and GPT-2
               (indextts), as functions over params dicts (+ modules for
               F5 and Vocos)
  weights/   - conversion of tts_tpu parameter trees, quantized leaves too
  frontend/  - F5 text frontend (tts_tpu's, with a jieba-free ASCII path)
  runtime/   - F5Pipeline (quantize None / 8 / "w8a8" / 4) and KaniPipeline:
               synthesis and benchmark; QwenTTSPipeline (quantize None /
               8, every decode route): synthesis, single and batched;
               BigVGANVocoder: mel -> int16, benchmark; IndexTTSPipeline
               (quantize None / 8 / 4): encode_reference, synthesis from
               token ids, single and batched
"""

__version__ = "0.1.0"
