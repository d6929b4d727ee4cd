"""tts_tpu_torch: the PyTorch/CUDA port of tts_tpu, for NVIDIA Hopper.

It mirrors tts_tpu's module paths and function names (tts_tpu is the
reference it is tested against) and imports no JAX. So far it holds the
F5-TTS synthesis path:
  audio/     - windows, STFT/ISTFT as framed matmuls, log-mel
  nn/        - LayerNorm, RoPE tables
  ops/       - conv1d, and the three hand-written CUDA kernels of the DiT
               (flash_attention, grouped_conv, dit_mlp) with their plain
               PyTorch twins; _build compiles csrc/ with nvcc at first use
  quant/     - dense (float weights)
  models/    - F5 DiT and Vocos, as functions over params dicts + modules
  weights/   - conversion of tts_tpu parameter trees
  frontend/  - F5 text frontend (tts_tpu's, with a jieba-free ASCII path)
  runtime/   - F5Pipeline: synthesize and benchmark
"""

__version__ = "0.1.0"
