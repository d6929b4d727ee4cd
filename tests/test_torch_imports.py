"""The PyTorch port imports no JAX: tts_tpu_torch and every submodule
import in a fresh interpreter where `import jax` fails."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import tts_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tts_tpu_torch.__path__,
                                                "tts_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith("jax.") for m, v in sys.modules.items()
               if v is not None), "a jax module was imported"
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
    # every module of the slice: audio, nn, ops (+ the three kernels), quant,
    # models, weights, frontend, runtime and their packages
    assert int(proc.stdout.split()[-1]) >= 20
