"""Upstream-checkpoint readers and the BigVGAN loader (counterpart of
tts_tpu/weights/loaders.py).

The file readers every loader uses, with no `safetensors` package:

  * `read_safetensors(path)` parses a `.safetensors` file itself (an 8-byte
    little-endian header length, the JSON header, the raw bytes) into CPU
    tensors; F64, F32, F16, BF16, I64, I32, I16, I8, U8 and BOOL entries;
  * `load_hf_state_dict(model_dir)` reads every `*.safetensors` shard of a
    HF directory, in name order (else its `pytorch_model.bin`);
  * `load_torch_state_dict(path)` is `torch.load(..., weights_only=True)`
    with the `generator` / `state_dict` unwrapping of BigVGAN checkpoints.

`host_state_dict` turns such tensors into numpy for the folds: bf16 and
fp16 entries upcast exactly to fp32 first (`tensor.float().numpy()`; a bf16
tensor has no numpy view). The folds are tts_tpu's, in numpy, and give a
host tree of fp32 arrays; `place` puts a host tree on a device in the
dtype asked for through the port's schema conversion (`convert._convert`),
which checks every key and shape, casts each leaf on the host and only
then moves it, so a device never holds an fp32 copy of a bf16 tree.
"""
from __future__ import annotations

import difflib
import json
import os
import struct
import sys
import warnings
from typing import Any, Mapping

import numpy as np
import torch

from ..models.bigvgan import BigVGANConfig
from . import convert as _cv

__all__ = [
    "CheckpointDict",
    "read_safetensors",
    "write_safetensors",
    "load_hf_state_dict",
    "load_torch_state_dict",
    "host_state_dict",
    "place",
    "collapse_weight_norm",
    "bigvgan_params_from_state_dict",
    "bigvgan_config_from_json",
    "load_bigvgan",
]


class CheckpointDict(Mapping):
    """State-dict wrapper with real-checkpoint diagnostics: a missing key
    raises a KeyError naming the closest keys present (so a rename or a
    nesting drift shows at a glance), and reads are tracked so a loader can
    warn about keys it never consumed."""

    def __init__(self, sd: Mapping[str, Any], name: str = "checkpoint"):
        self._sd = dict(sd)
        self._name = name
        self._used: set[str] = set()

    @classmethod
    def wrap(cls, sd: Mapping[str, Any], name: str = "checkpoint"):
        return sd if isinstance(sd, cls) else cls(sd, name)

    def __getitem__(self, k: str):
        try:
            v = self._sd[k]
        except KeyError:
            close = difflib.get_close_matches(k, self._sd.keys(), n=3, cutoff=0.4)
            hint = f" closest present: {close}" if close else " no similar keys present"
            raise KeyError(
                f"{self._name}: missing key {k!r};{hint}. The checkpoint's "
                "key layout likely differs from the upstream release this "
                "loader targets — see the loader docstring for the expected "
                "layout.") from None
        self._used.add(k)
        return v

    def __iter__(self):
        return iter(self._sd)

    def __len__(self):
        return len(self._sd)

    def __contains__(self, k):
        return k in self._sd

    def unused_keys(self) -> list[str]:
        return sorted(set(self._sd) - self._used)

    def warn_unused(self, ignore_substrings: tuple[str, ...] = ()) -> None:
        """Warn when keys were never read (dropped subtrees such as
        discriminators are normal: pass their markers in ignore_substrings)."""
        left = [k for k in self.unused_keys() if not any(s in k for s in ignore_substrings)]
        if left and self._used:
            ex = ", ".join(left[:5]) + ("..." if len(left) > 5 else "")
            warnings.warn(
                f"{self._name}: {len(left)} checkpoint keys were not "
                f"consumed by the loader (e.g. {ex}) — layout drift or an "
                "unexpected checkpoint variant", stacklevel=3)


# --------------------------------------------------------------------------
# File readers

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A `.safetensors` file -> {name: CPU tensor}, parsed here (no
    `safetensors` package). The tensors view one buffer holding the file;
    an entry whose offset is not a multiple of its item size is copied out."""
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors data is little-endian")
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(memoryview(buf)) != len(buf):
            raise OSError(f"{path}: short read")
    if len(buf) < 8:
        raise ValueError(f"{path}: not a safetensors file (no header length)")
    (n,) = struct.unpack_from("<Q", buf, 0)
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header length {n} past the end of the file")
    header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    base = 8 + n
    out: dict[str, torch.Tensor] = {}
    for name, e in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(e["dtype"])
        if dtype is None:
            raise TypeError(f"{path}: {name}: dtype {e['dtype']} is not read")
        shape = tuple(int(s) for s in e["shape"])
        begin, end = (base + int(o) for o in e["data_offsets"])
        item = torch.empty((), dtype=dtype).element_size()
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * item or end > len(buf):
            raise ValueError(f"{path}: {name}: {end - begin} bytes for shape "
                             f"{shape} of {e['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif begin % item:
            out[name] = torch.frombuffer(bytearray(buf[begin:end]), dtype=dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=begin).reshape(shape)
    return out


def write_safetensors(path: str, tensors: Mapping[str, Any]) -> None:
    """Write {name: numpy array or tensor} as a `.safetensors` file (the
    header padded to 8 bytes, entries in the given order)."""
    entries, offset = [], 0
    header: dict[str, Any] = {}
    for name, v in tensors.items():
        t = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if t.dtype not in _ST_NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} is not written")
        t = t.contiguous()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        entries.append(t)
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in entries:
            if t.numel():
                # bytes of any dtype (bf16 and bool have no numpy view)
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """torch.load a checkpoint on the CPU (weights only), unwrapping a
    `generator` or `state_dict` entry; non-tensor entries are dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "generator" in obj:
        obj = obj["generator"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach() for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_hf_state_dict(model_dir: str) -> dict[str, torch.Tensor]:
    """Every `*.safetensors` shard of a HF directory in name order (a later
    shard's key wins), else its `pytorch_model.bin`."""
    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if not files:
        return load_torch_state_dict(os.path.join(model_dir, "pytorch_model.bin"))
    sd: dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(read_safetensors(os.path.join(model_dir, f)))
    return sd


def host_state_dict(sd: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """CPU tensors -> numpy arrays for the folds: bf16 and fp16 entries
    upcast exactly to fp32 (`.float().numpy()`), others keep their dtype."""
    out = {}
    for k, t in sd.items():
        t = t.detach().cpu()
        out[k] = (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).numpy()
    return out


def _yaml(what: str):
    """The `yaml` module, imported only where a YAML config is read; without
    PyYAML an ImportError names it (no config is guessed)."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"reading {what} needs the PyYAML package (`import yaml`)") from e
    return yaml


# --------------------------------------------------------------------------
# Placement

# the schemas of the sub-trees a loader returns alone; whole family trees
# are told by their keys (convert._schema_of)
_SUB_SCHEMAS = {
    "ecapa": _cv._INDEXTTS["ecapa"],
    "indextts_gpt": _cv._INDEXTTS["gpt"],
    "conformer": _cv._INDEXTTS["conformer"],
    "perceiver": _cv._INDEXTTS["perceiver"],
    "qwen3_stack": _cv._qwen_stack(""),
    "llama_stack": _cv._llama_stack("hs", ""),
}


def _f32(a) -> np.ndarray:
    """A fold's result as a C-contiguous fp32 host array (tts_tpu's
    `jnp.asarray(x, jnp.float32)`)."""
    return np.ascontiguousarray(a, dtype=np.float32)


def place(tree: dict, device="cuda", dtype: torch.dtype = torch.float32,
          kind: str | None = None) -> dict:
    """A host tree (nested dicts/lists of numpy arrays) -> the same tree of
    torch tensors on `device`, floats in `dtype` (F5's `delta_t` stays
    fp32), checked against the family's schema (told by the tree's keys) or
    the sub-tree schema `kind`: one of "ecapa", "indextts_gpt", "conformer",
    "perceiver", "qwen3_stack", "llama_stack". Each leaf is cast on the host
    before it moves."""
    if kind is None:
        return _cv.params_from_jax(tree, device, dtype)
    return _cv._convert(tree, _SUB_SCHEMAS[kind], (), {}, torch.device(device), dtype)


# --------------------------------------------------------------------------
# Weight norm, convs, snake

def collapse_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """weight-norm reparam w = g * v / ||v||, norm over all dims but 0
    (torch.nn.utils.remove_weight_norm for dim=0), in float64."""
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
    return (g.astype(np.float64) * v.astype(np.float64) / norm).astype(np.float32)


def _conv_p(sd, prefix, transposed=False) -> dict[str, np.ndarray]:
    """A Conv1d (out, in, k) or ConvTranspose1d (in, out, k) weight, its
    weight norm collapsed, -> (k, in, out), and its bias."""
    if f"{prefix}.weight_g" in sd:
        w = collapse_weight_norm(sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"])
    else:
        w = sd[f"{prefix}.weight"]
    p = {"w": _f32(np.transpose(w, (2, 0, 1) if transposed else (2, 1, 0)))}
    if f"{prefix}.bias" in sd:
        p["b"] = _f32(sd[f"{prefix}.bias"])
    return p


def _snake_p(sd, prefix, cfg: BigVGANConfig) -> dict[str, np.ndarray]:
    """Upstream stores `alpha` (and `beta` for snakebeta), in log scale when
    snake_logscale; the tree holds alpha = exp(a) and beta_recip =
    1 / (exp(b) + 1e-9) (or alpha_recip), computed in float64."""
    alpha = sd[f"{prefix}.alpha"].astype(np.float64)
    if cfg.activation == "snakebeta":
        beta = sd[f"{prefix}.beta"].astype(np.float64)
        if cfg.snake_logscale:
            alpha, beta = np.exp(alpha), np.exp(beta)
        return {"alpha": _f32(alpha), "beta_recip": _f32(1.0 / (beta + 1e-9))}
    if cfg.snake_logscale:
        alpha = np.exp(alpha)
    return {"alpha": _f32(alpha), "alpha_recip": _f32(1.0 / (alpha + 1e-9))}


# --------------------------------------------------------------------------
# BigVGAN

def bigvgan_params_from_state_dict(sd: Mapping[str, np.ndarray],
                                   cfg: BigVGANConfig) -> dict:
    """The upstream BigVGAN state dict -> the host tree of models/bigvgan.py.

    Key layout: conv_pre, ups.{i}.0, resblocks.{n}.convs1.{j} / convs2.{j} /
    activations.{m}.act.{alpha,beta} (acts[::2] before convs1, acts[1::2]
    before convs2; AMPBlock2: convs.{m} and one activation a conv),
    activation_post.act, conv_post."""
    sd = CheckpointDict.wrap(sd, "bigvgan")
    params: dict[str, Any] = {"conv_pre": _conv_p(sd, "conv_pre"), "ups": [], "resblocks": []}
    for i in range(len(cfg.upsample_rates)):
        params["ups"].append(_conv_p(sd, f"ups.{i}.0", transposed=True))
        for j in range(cfg.num_kernels):
            n = i * cfg.num_kernels + j
            ndil = len(cfg.resblock_dilation_sizes[j])
            if cfg.resblock == "2":
                params["resblocks"].append({
                    "convs": [_conv_p(sd, f"resblocks.{n}.convs.{m}") for m in range(ndil)],
                    "acts": [_snake_p(sd, f"resblocks.{n}.activations.{m}.act", cfg)
                             for m in range(ndil)],
                })
                continue
            params["resblocks"].append({
                "convs1": [_conv_p(sd, f"resblocks.{n}.convs1.{m}") for m in range(ndil)],
                "convs2": [_conv_p(sd, f"resblocks.{n}.convs2.{m}") for m in range(ndil)],
                "acts1": [_snake_p(sd, f"resblocks.{n}.activations.{2 * m}.act", cfg)
                          for m in range(ndil)],
                "acts2": [_snake_p(sd, f"resblocks.{n}.activations.{2 * m + 1}.act", cfg)
                          for m in range(ndil)],
            })
    params["act_post"] = _snake_p(sd, "activation_post.act", cfg)
    params["conv_post"] = _conv_p(sd, "conv_post")
    return params


def bigvgan_config_from_json(path: str) -> BigVGANConfig:
    with open(path) as f:
        h = json.load(f)
    return BigVGANConfig(
        num_mels=h["num_mels"],
        upsample_initial_channel=h["upsample_initial_channel"],
        upsample_rates=tuple(h["upsample_rates"]),
        upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
        resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in h["resblock_dilation_sizes"]),
        activation=h["activation"],
        snake_logscale=h["snake_logscale"],
        use_bias_at_final=h.get("use_bias_at_final", True),
        use_tanh_at_final=h.get("use_tanh_at_final", True),
        sample_rate=h.get("sampling_rate", 24000),
        resblock=str(h.get("resblock", "1")),
        feat_upsample=bool(h.get("feat_upsample", False)),
    )


def load_bigvgan(model_dir: str, dtype: torch.dtype = torch.float32, device="cuda"):
    """A HF-style BigVGAN dir (config.json + bigvgan_generator.pt) ->
    (params on `device` in `dtype`, cfg)."""
    cfg = bigvgan_config_from_json(os.path.join(model_dir, "config.json"))
    sd = CheckpointDict(host_state_dict(load_torch_state_dict(
        os.path.join(model_dir, "bigvgan_generator.pt"))), "bigvgan")
    params = bigvgan_params_from_state_dict(sd, cfg)
    sd.warn_unused()
    return place(params, device, dtype), cfg
