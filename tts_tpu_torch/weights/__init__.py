"""Checkpoint loaders, saved-params bundles and the conversion of tts_tpu
parameter trees (tts_tpu/weights counterparts).

Every `load_*` reads upstream checkpoint files, folds them in fp32 numpy as
tts_tpu does, and returns the port's parameter tree on `device` (default
"cuda") in `dtype` (default torch.float32). `convert.params_from_jax` takes
trees made by tts_tpu instead; `save.save_params` / `load_params` persist a
folded tree to the .npz layout both packages read.
"""
from .loaders import (CheckpointDict, bigvgan_config_from_json, bigvgan_params_from_state_dict,
                      collapse_weight_norm, load_bigvgan, load_hf_state_dict,
                      load_torch_state_dict, place, read_safetensors, write_safetensors)

__all__ = [
    "CheckpointDict",
    "bigvgan_config_from_json",
    "bigvgan_params_from_state_dict",
    "collapse_weight_norm",
    "load_bigvgan",
    "load_hf_state_dict",
    "load_torch_state_dict",
    "place",
    "read_safetensors",
    "write_safetensors",
    # per-family loaders and the bundles (imported on first use)
    "load_f5", "load_vocos",
    "load_kani_lm", "load_nanocodec",
    "load_indextts",
    "load_qwen_tts", "load_qwen_codec", "load_qwen_encoder",
    "load_voxcpm",
    "save_params", "load_params",
]

_LAZY = {
    "load_f5": ("f5_loader", "load_f5"),
    "load_vocos": ("f5_loader", "load_vocos"),
    "load_kani_lm": ("kani_loader", "load_kani_lm"),
    "load_nanocodec": ("kani_loader", "load_nanocodec"),
    "load_indextts": ("indextts_loader", "load_indextts"),
    "load_qwen_tts": ("qwen_loader", "load_qwen_tts"),
    "load_qwen_codec": ("qwen_loader", "load_qwen_codec"),
    "load_qwen_encoder": ("qwen_loader", "load_qwen_encoder"),
    "load_voxcpm": ("voxcpm_loader", "load_voxcpm"),
    "save_params": ("save", "save_params"),
    "load_params": ("save", "load_params"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(f"{__name__}.{mod}"), attr)
    raise AttributeError(name)
