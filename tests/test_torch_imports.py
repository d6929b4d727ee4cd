"""The PyTorch port imports no JAX and nothing of the JAX package:
tts_tpu_torch and every submodule import in a fresh interpreter where
`import jax` and `import tts_tpu` fail."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["tts_tpu"] = None      # and so does any import of the JAX package
import tts_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tts_tpu_torch.__path__,
                                                "tts_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the entry points of the F5 route table and kernels 4 and 5
from tts_tpu_torch.models.f5 import attention_route, conv_fits, mlp_fits
from tts_tpu_torch.ops.flash_attention import (flash_attention, flash_onepass_plain,
                                               flash_online_plain)
# the ablation entry points
from tts_tpu_torch.ablations import flash_ablation, q8_kernel_profile
# the serving layer's lazy names resolve without JAX too
import tts_tpu_torch.serving as serving
for name in serving.__all__:
    getattr(serving, name)
assert not any(m.split(".")[0] in ("jax", "tts_tpu") for m, v in sys.modules.items()
               if v is not None), "a jax or tts_tpu module was imported"
print(len(names))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module of the F5, Kani, F5 W8A8, Qwen3-TTS, BigVGAN, IndexTTS
    # and VoxCPM slices: audio (filters among them), nn, kv, decoding, ops
    # (+ the kernels' modules, quant_matmul, decode_attention, decode_mlp and
    # bigvgan_stage among them), quant, models (qwen_tts, qwen_codec,
    # bigvgan, indextts and voxcpm among them), weights, frontend, runtime
    # (qwen, vocoder, indextts, voxcpm and streaming among them), serving
    # (slots, batcher, server, router, devices, families and the Kani, Qwen,
    # IndexTTS, VoxCPM and F5 slot servers), the ablation sets of kernels 16
    # and 17 (ops/flash_variants, ops/dit_mlp_q8_variants) and their entry
    # points (ablations) and their packages; kernels 4 and 5 live in
    # ops/flash_attention, beside kernel 1
    assert int(proc.stdout.split()[-1]) >= 69
