"""tts_tpu_torch: the PyTorch/CUDA port of tts_tpu, for NVIDIA Hopper.

It mirrors tts_tpu's module paths and function names (tts_tpu is the
reference it is tested against) and imports neither JAX nor anything of
tts_tpu: what it needs of that package is copied. It turns text into
speech for F5-TTS (float, W8A8 int8 and int4 DiT weights), KaniTTS,
Qwen3-TTS (custom voices and voice clone), IndexTTS-1.5 and VoxCPM from
checkpoint files, whole or streamed, through the
pipelines or the command line (`python -m tts_tpu_torch.cli`), and holds
the BigVGAN vocoder and the serving layer:
  audio/     - windows, STFT/ISTFT as framed matmuls, log-mel (tts_tpu's
               options), snake and snake_beta, kaiser-sinc filters and the
               anti-aliased 2x resampling
  nn/        - LayerNorm, RMSNorm, L2 norm, RoPE (half-split and
               interleaved), GQA attention
  kv/        - the static KV cache, written in place
  decoding/  - greedy, repetition penalty, beam search
  ops/       - conv1d, depthwise_conv1d, conv_transpose1d, and the
               hand-written CUDA kernels
               (flash_attention, grouped_conv, dit_mlp incl. its W8A8 form
               and quant_matmul for the F5 DiT; decode_qkv, decode_step,
               decode_attention and decode_mlp (incl. its W8A8 form) for
               AR decode; bigvgan_stage, the fused AMP resblock) with their
               plain PyTorch twins; _build compiles csrc/ with nvcc at
               first use
  quant/     - dense, dequantize; int8 and int4 weight-only quantization,
               each in tts_tpu's eager and jitted forms
  models/    - F5 DiT (float and W8A8 block routes), Vocos, the Kani LFM2
               LM and NanoCodec, the Qwen3-TTS talker and code predictor
               (qwen_tts, every decode route), its 12 Hz codec decoder
               (qwen_codec) and Mimi prompt encoder (qwen_encoder), BigVGAN (AMPBlock1/2, speaker conditioning),
               the IndexTTS conformer, perceiver, ECAPA and GPT-2
               (indextts), as functions over params dicts (+ modules for
               F5 and Vocos)
  weights/   - conversion of tts_tpu parameter trees, quantized leaves too
  frontend/  - the text frontends (copies of tts_tpu's): F5's (with a
               jieba-free ASCII path), the tokenizer.json and
               SentencePiece readers, the normalizers, IndexTTS's and
               VoxCPM's text functions
  utils/     - stage timers, the synthesis report, a torch.profiler trace
  cli.py     - the command line: f5, kani, indextts, qwen, voxcpm, serve
  runtime/   - F5Pipeline (quantize None / 8 / "w8a8" / 4) and KaniPipeline
               (quantize None / 8 / 4): synthesis and benchmark;
               QwenTTSPipeline (quantize None / 8 / 4, every decode
               route): synthesis, single, batched and streamed, the voice
               clone's encode_reference and prefill; BigVGANVocoder: mel
               -> int16, benchmark; IndexTTSPipeline (quantize None / 8 /
               4): encode_reference, synthesis from token ids, single and
               batched; VoxCPMPipeline (quantize None / 8 / 4, any output
               rate): synthesis, single, batched and streamed;
               streaming: the codec-window assembler
"""

__version__ = "0.1.0"
