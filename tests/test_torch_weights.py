"""The port's checkpoint loaders, readers and saved-params bundles
(tts_tpu_torch/weights) against tts_tpu's, on the CPU at small sizes.

Each family writes a synthetic checkpoint in the upstream key layout (from a
seed) to tmp_path; the port's `load_*` (device="cpu") and
`params_from_jax(<tts_tpu's load_* of the same files>)` must agree leaf for
leaf, bit for bit at fp32: both packages fold in numpy. The exception, named
where it is checked: F5's AdaLN tables `ada_table` and `norm_out_table`,
which tts_tpu computes with jnp matmuls and the port with torch's fp32
matmul on the host; their sums run in another order (within FOLD_TOL of
their largest value at fp32, within 1 bf16 ulp at bf16)."""
import dataclasses
import inspect
import io
import json
import os
import subprocess
import sys
import tarfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_f5_loader import _build_state_dict as f5_state_dict
from tests.test_indextts import TINY as INDEX_TINY
from tests.test_indextts_loader import _build_state_dict as gpt_state_dict
from tests.test_qwen import TINY as QWEN_TINY
from tests.test_qwen import TINY_CODEC as QWEN_CODEC_TINY
from tests.test_qwen_codec_loader import _build_state_dict as qwen_codec_state_dict
from tests.test_voxcpm import TINY as VOX_TINY
from tests.test_voxcpm_vae_loader import TINY as VAE_TINY
from tests.test_voxcpm_vae_loader import _build_state_dict as vae_state_dict
from tests.test_weights import SMALL as BV_SMALL
from tests.test_weights import _synthetic_state_dict as bigvgan_state_dict
from tts_tpu_torch.weights import loaders as tl
from tts_tpu_torch.weights.convert import params_from_jax

# F5's AdaLN tables: jnp (tts_tpu) against torch (the port) fp32 matmuls of
# the same fp32 operands, relative to the table's largest |value|
FOLD_TOL = 2.0 ** -20

# max_signal_len 4096: the loaders build text_freqs_cis at 4096 rows, as
# tts_tpu's, and the schema binds its rows to the RoPE tables'
F5_SMALL = dict(dim=128, depth=2, heads=2, head_dim=64, text_dim=64, conv_layers=1,
                nfe_steps=4, max_signal_len=4096, vocab_size=40)
VOCAB = " abcdefghijklmnopqrstuvwxyz,."
VOCOS_SMALL = dict(dim=32, intermediate_dim=64, num_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _add(sd, rng, s=0.05):
    def add(key, *shape, scale=s):
        sd[key] = (rng.standard_normal(shape) * scale).astype(np.float32)
    return add


def _jax_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def assert_same_tree(got: dict, ref: dict, loose: dict | None = None) -> None:
    """Every leaf of two torch trees equal in path, dtype and bits; a leaf
    named in `loose` within its tolerance (relative to max |ref|)."""
    loose = loose or {}
    g, r = dict(_walk(got)), dict(_walk(ref))
    assert set(g) == set(r), (sorted(set(g) ^ set(r)))
    for k, a in g.items():
        b = r[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        assert a.is_contiguous(), k
        tol = loose.get(k.split("/")[-1])
        if tol is None:
            assert torch.equal(a, b), k
        else:
            scale = b.float().abs().max().item()
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=tol * scale,
                                       err_msg=k)


def assert_same_host(got, ref) -> None:
    """A host tree (numpy) of the port against tts_tpu's, bit for bit."""
    g, r = dict(_walk(got)), dict(_walk(_jax_tree(ref)))
    assert set(g) == set(r), sorted(set(g) ^ set(r))
    for k, a in g.items():
        assert a.dtype == np.float32 and a.flags.c_contiguous, k
        np.testing.assert_array_equal(a, r[k], err_msg=k)


def _torch_sd(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


# ------------------------------------------------------------ the readers


ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
             "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
             "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


@pytest.mark.parametrize("name", sorted(ST_DTYPES))
def test_safetensors_roundtrip_per_dtype(tmp_path, name):
    """The port's writer and reader per dtype, and the writer's files read by
    the `safetensors` package itself to the same tensors."""
    import safetensors.torch as st

    dt = ST_DTYPES[name]
    g = torch.Generator().manual_seed(3)
    t = (torch.randn((5, 7), generator=g) * 100).to(dt)
    scalar = torch.tensor(3).to(dt)
    path = str(tmp_path / "a.safetensors")
    tl.write_safetensors(path, {"w": t, "s": scalar, "e": torch.zeros((0, 4), dtype=dt)})
    got = tl.read_safetensors(path)
    ref = st.load_file(path)
    for k in ("w", "s", "e"):
        assert got[k].dtype == dt == ref[k].dtype and got[k].shape == ref[k].shape
        assert torch.equal(got[k], ref[k])
    assert torch.equal(got["w"], t)
    with open(path, "rb") as f:
        assert (8 + int.from_bytes(f.read(8), "little")) % 8 == 0


def test_safetensors_unaligned_offsets(tmp_path):
    """A file whose header is not padded (entries off their item size's
    alignment) reads the same: those entries are copied out."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.arange(3, dtype=np.int64) - 1
    raw = a.tobytes() + b.tobytes()
    header = {"a": {"dtype": "F32", "shape": [2, 3], "data_offsets": [0, 24]},
              "b": {"dtype": "I64", "shape": [3], "data_offsets": [24, 48]}}
    blob = json.dumps(header).encode()
    blob += b" " * ((8 - (len(blob) + 8) % 8) % 8 + 3)      # 3 bytes off alignment
    (tmp_path / "u.safetensors").write_bytes(len(blob).to_bytes(8, "little") + blob + raw)
    got = tl.read_safetensors(str(tmp_path / "u.safetensors"))
    np.testing.assert_array_equal(got["a"].numpy(), a)
    np.testing.assert_array_equal(got["b"].numpy(), b)


def test_safetensors_skips_metadata(tmp_path):
    """A header's `__metadata__` entry (as HF's writers add) is not a tensor:
    the reader skips it, and reads what the `safetensors` package reads."""
    import safetensors.torch as st

    a = np.arange(4, dtype=np.float32) - 1.5
    header = {"__metadata__": {"format": "pt"},
              "a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    path = tmp_path / "m.safetensors"
    path.write_bytes(len(blob).to_bytes(8, "little") + blob + a.tobytes())
    got = tl.read_safetensors(str(path))
    assert list(got) == ["a"]
    np.testing.assert_array_equal(got["a"].numpy(), a)
    assert torch.equal(got["a"], st.load_file(str(path))["a"])


@pytest.mark.parametrize("fault", ["short", "dtype", "size"])
def test_safetensors_rejects_bad_files(tmp_path, fault):
    path = tmp_path / "bad.safetensors"
    if fault == "short":
        path.write_bytes(b"\x10\x00")
    else:
        dtype, end = ("C64", 8) if fault == "dtype" else ("F32", 12)
        blob = json.dumps({"a": {"dtype": dtype, "shape": [2], "data_offsets": [0, end]}})
        blob = blob.encode() + b" " * (-len(blob) % 8)
        path.write_bytes(len(blob).to_bytes(8, "little") + blob + b"\x00" * end)
    with pytest.raises((ValueError, TypeError)):
        tl.read_safetensors(str(path))


@pytest.mark.parametrize("name", ["BF16", "F16"])
def test_half_entries_upcast_exactly(tmp_path, name):
    """bf16 and fp16 entries load to their exact fp32 upcast, from a
    .safetensors file and from a torch checkpoint. What tts_tpu's readers do
    with them is recorded here, not fixed: `safetensors.numpy.load_file`
    raises on BF16 where ml_dtypes is not loaded (a process without JAX);
    with JAX loaded it returns ml_dtypes bf16 (and F16 as float16), so
    tts_tpu's folds then run at that precision; its load_torch_state_dict
    raises on a bf16 torch checkpoint (`Tensor.numpy()`)."""
    from tts_tpu.weights.f5_loader import _load_safetensors
    from tts_tpu.weights.loaders import load_torch_state_dict as jax_load_torch

    dt = ST_DTYPES[name]
    t = torch.randn((4, 6), generator=torch.Generator().manual_seed(1)).to(dt)
    path = str(tmp_path / "h.safetensors")
    tl.write_safetensors(path, {"w": t})
    torch.save({"w": t}, str(tmp_path / "h.pt"))
    for sd in (tl.read_safetensors(path), tl.load_torch_state_dict(str(tmp_path / "h.pt"))):
        host = tl.host_state_dict(sd)["w"]
        assert host.dtype == np.float32
        np.testing.assert_array_equal(host, t.float().numpy())

    # tts_tpu: the half dtype reaches the folds
    assert str(_load_safetensors(path)["w"].dtype) == ("bfloat16" if name == "BF16"
                                                       else "float16")
    if name == "BF16":
        with pytest.raises(TypeError, match="BFloat16"):
            jax_load_torch(str(tmp_path / "h.pt"))
        code = ("import sys, safetensors.numpy as s\n"
                "try:\n    s.load_file(sys.argv[1])\nexcept TypeError as e:\n"
                "    print('TypeError', e)\n")
        out = subprocess.run([sys.executable, "-c", code, path], capture_output=True,
                             text=True, timeout=60).stdout
        assert out.startswith("TypeError") and "bfloat16" in out
    else:
        assert jax_load_torch(str(tmp_path / "h.pt"))["w"].dtype == np.float16


@pytest.mark.parametrize("name", ["BF16", "F16"])
def test_half_f5_checkpoint_folds_at_fp32(tmp_path, name):
    """A BF16 or F16 F5 checkpoint loads as its exact fp32 upcast folded in
    fp32: the same tree as the upcast checkpoint's. tts_tpu's load of the
    same file, recorded: BF16 folds as the port's (ml_dtypes promotes bf16
    times a float to fp32), F16 folds the q/k scale in fp16 (NEP 50 keeps
    float16 times a float in float16), so its wqkv and bqkv differ."""
    from tts_tpu.models.f5 import F5Config as JF5Config
    from tts_tpu.weights.f5_loader import load_f5 as jax_load_f5
    from tts_tpu_torch.models.f5 import F5Config
    from tts_tpu_torch.weights.f5_loader import load_f5

    cfg = F5Config(**F5_SMALL)
    sd = f5_state_dict(cfg, _rng(5))
    half = {f"ema_model.{k}": torch.from_numpy(v).to(ST_DTYPES[name]) for k, v in sd.items()}
    tl.write_safetensors(str(tmp_path / "half.safetensors"), half)
    tl.write_safetensors(str(tmp_path / "up.safetensors"), {k: v.float() for k, v in half.items()})
    vocab = str(tmp_path / "vocab.txt")
    (tmp_path / "vocab.txt").write_text("".join(c + "\n" for c in VOCAB))
    got = load_f5(str(tmp_path / "half.safetensors"), vocab, cfg, device="cpu")[0]
    assert_same_tree(got, load_f5(str(tmp_path / "up.safetensors"), vocab, cfg, device="cpu")[0])
    jp = jax_load_f5(str(tmp_path / "half.safetensors"), vocab, JF5Config(**F5_SMALL))[0]
    ref = params_from_jax(_jax_tree(jp), "cpu", torch.float32)
    loose = {"ada_table": FOLD_TOL, "norm_out_table": FOLD_TOL}
    if name == "BF16":
        assert_same_tree(got, ref, loose)
    else:
        for k in ("wqkv", "bqkv"):
            assert not torch.equal(got["blocks"][0]["attn"][k], ref["blocks"][0]["attn"][k])
        for part in ("blocks", "ada_table", "norm_out_table"):
            got.pop(part), ref.pop(part)
        assert_same_tree(got, ref)


def test_sharded_hf_directory(tmp_path):
    """Every shard of a HF directory, in name order; a .bin without shards."""
    rng = _rng(2)
    a = {f"x.{i}": rng.standard_normal((3, i + 1)).astype(np.float32) for i in range(4)}
    tl.write_safetensors(str(tmp_path / "model-00002-of-00002.safetensors"),
                         {k: a[k] for k in ("x.2", "x.3")})
    tl.write_safetensors(str(tmp_path / "model-00001-of-00002.safetensors"),
                         {k: a[k] for k in ("x.0", "x.1")})
    got = tl.host_state_dict(tl.load_hf_state_dict(str(tmp_path)))
    assert sorted(got) == sorted(a)
    for k in a:
        np.testing.assert_array_equal(got[k], a[k])
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    torch.save(_torch_sd(a), str(bin_dir / "pytorch_model.bin"))
    got = tl.host_state_dict(tl.load_hf_state_dict(str(bin_dir)))
    np.testing.assert_array_equal(got["x.3"], a["x.3"])


@pytest.mark.parametrize("wrap", [None, "generator", "state_dict"])
def test_load_torch_state_dict_unwraps(tmp_path, wrap):
    sd = {"a.weight": torch.ones(2, 3), "b.bias": torch.arange(3.0)}
    obj = dict(sd) if wrap is None else {wrap: dict(sd), "step": 7}
    if wrap is None:
        obj["not_a_tensor"] = 3
    torch.save(obj, str(tmp_path / "c.pt"))
    got = tl.load_torch_state_dict(str(tmp_path / "c.pt"))
    assert sorted(got) == sorted(sd) and torch.equal(got["b.bias"], sd["b.bias"])


def test_checkpoint_dict_diagnostics():
    """A missing key names the closest keys present; unused keys warn unless
    ignored."""
    sd = tl.CheckpointDict({"model.layers.0.attn.weight": np.zeros(2),
                            "model.layers.0.mlp.weight": np.zeros(2),
                            "discriminator.conv.weight": np.zeros(2)}, "fam")
    with pytest.raises(KeyError) as ei:
        sd["model.layers.0.attn.wieght"]
    assert "fam" in str(ei.value) and "model.layers.0.attn.weight" in str(ei.value)
    with pytest.raises(KeyError, match="no similar keys"):
        sd["zzz"]
    _ = sd["model.layers.0.attn.weight"]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sd.warn_unused(ignore_substrings=("discriminator",))
    assert len(w) == 1 and "1 checkpoint keys" in str(w[0].message)
    _ = sd["model.layers.0.mlp.weight"]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sd.warn_unused(ignore_substrings=("discriminator",))
    assert not w


def test_loader_names_close_keys(tmp_path):
    """A loader on a checkpoint with a renamed key fails naming it."""
    from tts_tpu_torch.models.f5 import F5Config
    from tts_tpu_torch.weights.f5_loader import load_f5

    cfg = F5Config(**F5_SMALL)
    sd = f5_state_dict(cfg, _rng(1))
    sd["transformer.proj_out.wieght"] = sd.pop("transformer.proj_out.weight")
    tl.write_safetensors(str(tmp_path / "m.safetensors"), sd)
    (tmp_path / "vocab.txt").write_text("".join(c + "\n" for c in VOCAB))
    with pytest.raises(KeyError, match="transformer.proj_out.wieght"):
        load_f5(str(tmp_path / "m.safetensors"), str(tmp_path / "vocab.txt"), cfg, device="cpu")


def test_loader_shapes_checked_by_the_schema(tmp_path):
    from tts_tpu_torch.models.vocos import VocosConfig
    from tts_tpu_torch.weights.f5_loader import load_vocos

    sd = vocos_state_dict(VocosConfig(**VOCOS_SMALL), _rng(0))
    sd["backbone.convnext.1.pwconv2.weight"] = np.zeros((32, 65), np.float32)
    torch.save(_torch_sd(sd), str(tmp_path / "pytorch_model.bin"))
    with pytest.raises(ValueError, match="pw2"):
        load_vocos(str(tmp_path), VocosConfig(**VOCOS_SMALL), device="cpu")


# ------------------------------------------------------------ fold checks


def kani_state_dict(cfg, rng, tied=False, conv_bias=True):
    """The LFM2 layout (test_family_loaders' keys)."""
    def w(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.1

    hs, hd = cfg.hidden_size, cfg.head_dim
    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, hs),
          "model.embedding_norm.weight": np.abs(w(hs)) + 0.5}
    if not tied:
        sd["lm_head.weight"] = w(cfg.vocab_size, hs)
    for i, lt in enumerate(cfg.layer_types):
        p = f"model.layers.{i}"
        sd[f"{p}.operator_norm.weight"] = np.abs(w(hs)) + 0.5
        sd[f"{p}.ffn_norm.weight"] = np.abs(w(hs)) + 0.5
        sd[f"{p}.feed_forward.w1.weight"] = w(cfg.ffn_dim, hs)
        sd[f"{p}.feed_forward.w2.weight"] = w(hs, cfg.ffn_dim)
        sd[f"{p}.feed_forward.w3.weight"] = w(cfg.ffn_dim, hs)
        if lt == "attn":
            sd[f"{p}.self_attn.q_proj.weight"] = w(cfg.num_heads * hd, hs)
            sd[f"{p}.self_attn.k_proj.weight"] = w(cfg.num_kv_heads * hd, hs)
            sd[f"{p}.self_attn.v_proj.weight"] = w(cfg.num_kv_heads * hd, hs)
            sd[f"{p}.self_attn.out_proj.weight"] = w(hs, cfg.num_heads * hd)
            sd[f"{p}.self_attn.q_layernorm.weight"] = np.abs(w(hd)) + 0.5
            sd[f"{p}.self_attn.k_layernorm.weight"] = np.abs(w(hd)) + 0.5
        else:
            sd[f"{p}.conv.in_proj.weight"] = w(3 * hs, hs)
            sd[f"{p}.conv.conv.weight"] = w(hs, 1, cfg.conv_kernel)
            sd[f"{p}.conv.out_proj.weight"] = w(hs, hs)
            if conv_bias and i == 0:
                sd[f"{p}.conv.conv.bias"] = w(hs)
    return sd


KANI_KW = dict(hidden_size=16, num_heads=2, num_kv_heads=1, head_dim=8, ffn_dim=32,
               vocab_size=32, layer_types=("conv", "attn"), max_seq_len=32, stop_token=31)


def test_kani_fold_algebra():
    """operator_norm folded into the qkv columns, as tts_tpu's; the tree
    equal to tts_tpu's bit for bit."""
    from tts_tpu.models.kani import KaniConfig as JKaniConfig
    from tts_tpu.weights.kani_loader import kani_params_from_state_dict as jax_fold
    from tts_tpu_torch.models.kani import KaniConfig
    from tts_tpu_torch.weights.kani_loader import kani_params_from_state_dict

    cfg = KaniConfig(**KANI_KW)
    sd = kani_state_dict(cfg, _rng())
    got = kani_params_from_state_dict(sd, cfg)
    op = sd["model.layers.1.operator_norm.weight"][None, :]
    np.testing.assert_allclose(got["layers"][1]["wqkv"][:, :cfg.num_heads * cfg.head_dim],
                               (sd["model.layers.1.self_attn.q_proj.weight"] * op).T,
                               atol=1e-6)
    assert_same_host(got, jax_fold(sd, JKaniConfig(**KANI_KW)))


def _qwen_stack_sd(prefix, hs, heads, kvh, hd, ff, layers, rng, bias=False):
    def w(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.1

    sd = {}
    for i in range(layers):
        p = f"{prefix}.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = np.abs(w(hs)) + 0.5
        sd[f"{p}.post_attention_layernorm.weight"] = np.abs(w(hs)) + 0.5
        sd[f"{p}.self_attn.q_proj.weight"] = w(heads * hd, hs)
        sd[f"{p}.self_attn.k_proj.weight"] = w(kvh * hd, hs)
        sd[f"{p}.self_attn.v_proj.weight"] = w(kvh * hd, hs)
        sd[f"{p}.self_attn.o_proj.weight"] = w(hs, heads * hd)
        sd[f"{p}.self_attn.q_norm.weight"] = np.abs(w(hd)) + 0.5
        sd[f"{p}.self_attn.k_norm.weight"] = np.abs(w(hd)) + 0.5
        sd[f"{p}.mlp.gate_proj.weight"] = w(ff, hs)
        sd[f"{p}.mlp.up_proj.weight"] = w(ff, hs)
        sd[f"{p}.mlp.down_proj.weight"] = w(hs, ff)
        if bias:
            for n, rows in (("q", heads * hd), ("k", kvh * hd), ("v", kvh * hd)):
                sd[f"{p}.self_attn.{n}_proj.bias"] = w(rows)
    return sd


@pytest.mark.parametrize("bias", [False, True])
def test_qwen_stack_fold(bias):
    from tts_tpu.models.qwen_tts import Qwen3StackConfig as JCfg
    from tts_tpu.weights.qwen_loader import qwen3_stack_from_state_dict as jax_fold
    from tts_tpu_torch.models.qwen_tts import Qwen3StackConfig
    from tts_tpu_torch.weights.qwen_loader import qwen3_stack_from_state_dict

    kw = dict(hidden_size=16, num_heads=2, num_kv_heads=1, head_dim=8, ffn_dim=32,
              num_layers=2, max_seq_len=16)
    sd = _qwen_stack_sd("m", 16, 2, 1, 8, 32, 2, _rng(), bias)
    got = qwen3_stack_from_state_dict(sd, "m", Qwen3StackConfig(**kw))
    np.testing.assert_allclose(got["layers"][0]["q_norm"],
                               sd["m.layers.0.self_attn.q_norm.weight"] * 8 ** -0.25, atol=1e-6)
    assert_same_host(got, jax_fold(sd, "m", JCfg(**kw)))
    placed = tl.place(got, "cpu", torch.float32, kind="qwen3_stack")
    assert placed["layers"][1]["wqkv"].shape == (16, 32)


def test_bn_fold_matches_torch():
    from tts_tpu.weights.indextts_loader import _bn_fold as jax_bn_fold
    from tts_tpu_torch.weights.indextts_loader import _bn_fold

    r = _rng()
    c = 6
    bn = torch.nn.BatchNorm1d(c).eval()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.from_numpy(r.standard_normal(c).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(np.abs(r.standard_normal(c)).astype(np.float32)
                                              + 0.1))
    sd = {"x.weight": bn.weight.detach().numpy(), "x.bias": bn.bias.detach().numpy(),
          "x.running_mean": bn.running_mean.numpy(), "x.running_var": bn.running_var.numpy()}
    p = _bn_fold(sd, "x")
    x = r.standard_normal((1, 5, c)).astype(np.float32)
    with torch.no_grad():
        ref = bn(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(x * p["scale"] + p["shift"], ref, atol=1e-5)
    assert_same_host(p, jax_bn_fold(sd, "x"))


def test_f5_ema_strip():
    from tts_tpu_torch.weights.f5_loader import _strip_ema

    sd = {"ema_model.transformer.x": np.zeros(2), "ema_model.initted": np.zeros(1),
          "ema_model.step": np.zeros(1)}
    assert list(_strip_ema(sd)) == ["transformer.x"]
    assert list(_strip_ema({"transformer.x": np.zeros(2)})) == ["transformer.x"]


@pytest.mark.parametrize("residual_scale", [1.0, 1.4 / np.sqrt(2)])
def test_voxcpm_llama_stack_fold(residual_scale):
    from tts_tpu.models.voxcpm import LlamaStackConfig as JCfg
    from tts_tpu.weights.voxcpm_loader import llama_stack_from_state_dict as jax_fold
    from tts_tpu_torch.models.voxcpm import LlamaStackConfig
    from tts_tpu_torch.weights.voxcpm_loader import llama_stack_from_state_dict

    kw = dict(hidden_size=16, num_heads=2, num_kv_heads=1, head_dim=8, ffn_dim=32,
              num_layers=1, max_seq_len=16)
    sd = _qwen_stack_sd("lm", 16, 2, 1, 8, 32, 1, _rng())
    got = llama_stack_from_state_dict(sd, "lm", LlamaStackConfig(**kw), residual_scale)
    assert_same_host(got, jax_fold(sd, "lm", JCfg(**kw), residual_scale=residual_scale))
    assert tl.place(got, "cpu", torch.float32, kind="llama_stack")["layers"][0]["wo"].shape \
        == (16, 16)


def test_weight_norm_collapse_matches_torch():
    from tts_tpu.weights.loaders import collapse_weight_norm

    conv = torch.nn.utils.parametrizations.weight_norm(torch.nn.Conv1d(4, 6, 3))
    g = conv.parametrizations.weight.original0.detach().numpy()
    v = conv.parametrizations.weight.original1.detach().numpy()
    got = tl.collapse_weight_norm(g, v)
    assert np.abs(got - conv.weight.detach().numpy()).max() < 1e-6
    np.testing.assert_array_equal(got, collapse_weight_norm(g, v))


# --------------------------------------------------- F5 and Vocos loaders


def vocos_state_dict(cfg, rng, loud=False):
    """charactr/vocos-mel-24khz's key layout, feature_extractor buffers too."""
    sd = {}
    add = _add(sd, rng)
    d, inter = cfg.dim, cfg.intermediate_dim
    add("backbone.embed.weight", d, cfg.input_channels, 7)
    add("backbone.embed.bias", d)
    sd["backbone.norm.weight"] = np.ones(d, np.float32) + 0.01 * rng.standard_normal(d
                                                                                    ).astype(np.float32)
    add("backbone.norm.bias", d)
    for i in range(cfg.num_layers):
        p = f"backbone.convnext.{i}"
        add(f"{p}.dwconv.weight", d, 1, 7)
        add(f"{p}.dwconv.bias", d)
        sd[f"{p}.norm.weight"] = np.ones(d, np.float32)
        add(f"{p}.norm.bias", d)
        add(f"{p}.pwconv1.weight", inter, d)
        add(f"{p}.pwconv1.bias", inter)
        add(f"{p}.pwconv2.weight", d, inter)
        add(f"{p}.pwconv2.bias", d)
        sd[f"{p}.gamma"] = (0.5 + rng.random(d)).astype(np.float32)
    sd["backbone.final_layer_norm.weight"] = np.ones(d, np.float32)
    add("backbone.final_layer_norm.bias", d)
    add("head.out.weight", cfg.n_fft + 2, d)
    add("head.out.bias", cfg.n_fft + 2)
    if loud:      # magnitudes near e^3, so int16 audio sees a good part of its range
        sd["head.out.bias"][:cfg.n_fft // 2 + 1] = 3.0
    add("feature_extractor.mel_spec.mel_scale.fb", cfg.n_fft // 2 + 1, cfg.input_channels)
    add("feature_extractor.mel_spec.spectrogram.window", cfg.n_fft)
    return sd


def write_f5(tmp_path, cfg, seed=0):
    """An upstream F5 checkpoint: ema_model.* keys with initted/step and the
    mel_spec buffers, fp32, and its vocab.txt."""
    sd = {f"ema_model.{k}": v for k, v in f5_state_dict(cfg, _rng(seed)).items()}
    sd["ema_model.initted"] = np.asarray(True)
    sd["ema_model.step"] = np.asarray(1250000, np.int64)
    sd["ema_model.mel_spec.mel_stft.mel_scale.fb"] = np.zeros((513, cfg.n_mels), np.float32)
    ckpt, vocab = str(tmp_path / "model_1250000.safetensors"), str(tmp_path / "vocab.txt")
    tl.write_safetensors(ckpt, sd)
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("".join(c + "\n" for c in VOCAB))
    return ckpt, vocab


def write_vocos(tmp_path, cfg, seed=1, loud=False):
    d = tmp_path / "vocos"
    d.mkdir(exist_ok=True)
    torch.save(_torch_sd(vocos_state_dict(cfg, _rng(seed), loud)), str(d / "pytorch_model.bin"))
    return str(d)


def test_load_f5_matches_tts_tpu(tmp_path):
    from tts_tpu.models.f5 import F5Config as JF5Config
    from tts_tpu.weights.f5_loader import load_f5 as jax_load_f5
    from tts_tpu_torch.models.f5 import F5Config
    from tts_tpu_torch.weights.f5_loader import load_f5

    cfg = F5Config(**F5_SMALL)
    ckpt, vocab = write_f5(tmp_path, cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")         # every key consumed or ignored
        params, cfg2, vmap = load_f5(ckpt, vocab, cfg, device="cpu")
    jp, _, jvmap = jax_load_f5(ckpt, vocab, JF5Config(**F5_SMALL))
    assert cfg2 == cfg and vmap == jvmap and vmap[" "] == 0 and len(vmap) == len(VOCAB)
    ref = params_from_jax(_jax_tree(jp), "cpu", torch.float32)
    assert_same_tree(params, ref, loose={"ada_table": FOLD_TOL, "norm_out_table": FOLD_TOL})


def test_load_f5_default_config_from_vocab(tmp_path):
    from tts_tpu_torch.models.f5 import F5Config
    from tts_tpu_torch.weights.f5_loader import load_f5_vocab

    ckpt, vocab = write_f5(tmp_path, F5Config(**F5_SMALL))
    assert load_f5_vocab(vocab) == {c: i for i, c in enumerate(VOCAB)}
    from tts_tpu.weights.f5_loader import load_f5_vocab as jax_vocab

    assert load_f5_vocab(vocab) == jax_vocab(vocab)


def test_load_f5_bf16_is_the_fp32_tree_cast(tmp_path):
    """dtype=bf16: every float leaf is the fp32 load cast to bf16, delta_t
    stays fp32 (as F5Model keeps it), but the two AdaLN tables: those are
    attach_mod_tables over the cast tree (built from the bf16 time table and
    AdaLN weights, as tts_tpu's bf16 load builds them)."""
    from tts_tpu_torch.models.f5 import F5Config, F5Model, attach_mod_tables
    from tts_tpu_torch.weights.f5_loader import load_f5

    cfg = F5Config(**F5_SMALL)
    ckpt, vocab = write_f5(tmp_path, cfg)
    bf = load_f5(ckpt, vocab, cfg, dtype=torch.bfloat16, device="cpu")[0]
    f32 = load_f5(ckpt, vocab, cfg, device="cpu")[0]
    cast = F5Model(cfg, f32).to(torch.bfloat16).params
    fp32_tables = {k: cast[k] for k in ("ada_table", "norm_out_table")}
    assert_same_tree(bf, attach_mod_tables(cast, cfg))
    assert any(not torch.equal(bf[k], t) for k, t in fp32_tables.items())
    assert bf["delta_t"].dtype == torch.float32 and bf["ada_table"].dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_load_f5_bf16_matches_tts_tpu(tmp_path, seed):
    """dtype=bf16 against tts_tpu's load_f5(dtype=bfloat16): bitwise on every
    leaf but the AdaLN tables, whose fp32 sums (jnp against torch) run in
    another order; rounded to bf16, each element is within 1 bf16 ulp (bit
    pattern distance), and at most 1 in 1,000 elements is off."""
    from tts_tpu.models.f5 import F5Config as JF5Config
    from tts_tpu.weights.f5_loader import load_f5 as jax_load_f5
    from tts_tpu_torch.models.f5 import F5Config
    from tts_tpu_torch.weights.f5_loader import load_f5

    cfg = F5Config(**F5_SMALL)
    ckpt, vocab = write_f5(tmp_path, cfg, seed=seed)
    bf = load_f5(ckpt, vocab, cfg, dtype=torch.bfloat16, device="cpu")[0]
    jp = jax_load_f5(ckpt, vocab, JF5Config(**F5_SMALL), dtype=jnp.bfloat16)[0]
    ref = params_from_jax(_jax_tree(jp), "cpu", torch.bfloat16)
    tables = ("ada_table", "norm_out_table")
    assert_same_tree({k: v for k, v in bf.items() if k not in tables},
                     {k: v for k, v in ref.items() if k not in tables})
    for k in tables:
        a, b = bf[k], ref[k]
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape, k
        ulps = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()
        assert int(ulps.max()) <= 1 and int((ulps > 0).sum()) <= a.numel() // 1000, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_load_vocos_matches_tts_tpu(tmp_path, dtype):
    from tts_tpu.models.vocos import VocosConfig as JVocosConfig
    from tts_tpu.weights.f5_loader import load_vocos as jax_load_vocos
    from tts_tpu_torch.models.vocos import VocosConfig
    from tts_tpu_torch.weights.f5_loader import load_vocos

    d = write_vocos(tmp_path, VocosConfig(**VOCOS_SMALL))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        params, cfg = load_vocos(d, VocosConfig(**VOCOS_SMALL), dtype=dtype, device="cpu")
    jp, _ = jax_load_vocos(d, JVocosConfig(**VOCOS_SMALL))
    assert_same_tree(params, params_from_jax(_jax_tree(jp), "cpu", dtype))


# --------------------------------------------------------------- BigVGAN


def write_bigvgan_config(path, cfg):
    h = {"num_mels": cfg.num_mels, "upsample_initial_channel": cfg.upsample_initial_channel,
         "upsample_rates": list(cfg.upsample_rates),
         "upsample_kernel_sizes": list(cfg.upsample_kernel_sizes),
         "resblock_kernel_sizes": list(cfg.resblock_kernel_sizes),
         "resblock_dilation_sizes": [list(d) for d in cfg.resblock_dilation_sizes],
         "activation": cfg.activation, "snake_logscale": cfg.snake_logscale,
         "use_bias_at_final": cfg.use_bias_at_final, "use_tanh_at_final": cfg.use_tanh_at_final,
         "sampling_rate": cfg.sample_rate, "resblock": cfg.resblock}
    with open(path, "w") as f:
        json.dump(h, f)


@pytest.mark.parametrize("activation,logscale,final_bias", [
    ("snakebeta", True, False), ("snake", False, True), ("snake", True, True)])
def test_load_bigvgan_matches_tts_tpu(tmp_path, activation, logscale, final_bias):
    from tts_tpu.weights.loaders import load_bigvgan as jax_load_bigvgan

    cfg = dataclasses.replace(BV_SMALL, activation=activation, snake_logscale=logscale,
                              use_bias_at_final=final_bias)
    sd = bigvgan_state_dict(cfg, _rng(4))
    write_bigvgan_config(str(tmp_path / "config.json"), cfg)
    torch.save({"generator": _torch_sd(sd)}, str(tmp_path / "bigvgan_generator.pt"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # snake leaves the beta keys unread
        params, pcfg = tl.load_bigvgan(str(tmp_path), device="cpu")
        jp, jcfg = jax_load_bigvgan(str(tmp_path))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert_same_tree(params, params_from_jax(_jax_tree(jp), "cpu", torch.float32))
    assert ("alpha_recip" in params["act_post"]) == (activation == "snake")


# ------------------------------------------------------------------ Kani


def write_kani_dir(path, cfg, fmt, tied, rng):
    os.makedirs(path, exist_ok=True)
    c = {"layer_types": ["full_attention" if t == "attn" else "conv" for t in cfg.layer_types],
         "hidden_size": cfg.hidden_size, "num_attention_heads": cfg.num_heads,
         "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
         "block_ff_dim": cfg.ffn_dim, "vocab_size": cfg.vocab_size, "conv_L_cache": 3,
         "rope_theta": 1000000.0, "norm_eps": 1e-5}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(c, f)
    sd = kani_state_dict(cfg, rng, tied=tied)
    if fmt == "bin":
        torch.save(_torch_sd(sd), os.path.join(path, "pytorch_model.bin"))
    else:
        keys = sorted(sd)
        for i, part in enumerate((keys[::2], keys[1::2])):
            tl.write_safetensors(os.path.join(path, f"model-0000{i + 1}-of-00002.safetensors"),
                                 {k: sd[k] for k in part})


@pytest.mark.parametrize("fmt,tied", [("sharded", False), ("bin", True)])
def test_load_kani_lm_matches_tts_tpu(tmp_path, fmt, tied):
    from tts_tpu.weights.kani_loader import load_kani_lm as jax_load
    from tts_tpu_torch.models.kani import KaniConfig
    from tts_tpu_torch.weights.kani_loader import load_kani_lm

    cfg = KaniConfig(**KANI_KW)
    write_kani_dir(str(tmp_path), cfg, fmt, tied, _rng(6))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        params, pcfg = load_kani_lm(str(tmp_path), device="cpu")
    jp, jcfg = jax_load(str(tmp_path))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert_same_tree(params, params_from_jax(_jax_tree(jp), "cpu", torch.float32))


def nanocodec_state_dict(cfg, rng):
    """The NeMo decoder's layout: parametrized weight norm on the convs but
    the up-convs (weight_g/v), snake alphas under their three key forms, and
    encoder/discriminator keys a decoder load skips."""
    sd = {}
    add = _add(sd, rng, 0.1)
    d = "audio_decoder"

    def conv(pre, cin, cout, k, transposed=False, form="param"):
        shape = (cin, cout, k) if transposed else (cout, cin, k)
        g_rows = cin if transposed else cout
        if form == "param":
            add(f"{pre}.parametrizations.weight.original1", *shape)
            sd[f"{pre}.parametrizations.weight.original0"] = (
                np.abs(rng.standard_normal((g_rows, 1, 1))) + 0.5).astype(np.float32)
        elif form == "wn":
            add(f"{pre}.weight_v", *shape)
            sd[f"{pre}.weight_g"] = (np.abs(rng.standard_normal((g_rows, 1, 1))) + 0.5
                                     ).astype(np.float32)
        else:
            add(f"{pre}.weight", *shape)
        add(f"{pre}.bias", cout)

    def act(pre, c, n):
        key = ("snake.alpha", "alpha", "snake_act.alpha")[n % 3]
        sd[f"{pre}.{key}"] = (np.abs(rng.standard_normal((1, c, 1))) + 0.3).astype(np.float32)

    c0 = cfg.base_channels
    conv(f"{d}.pre_conv.conv", cfg.input_dim, c0, cfg.pre_kernel)
    n = 0
    for i, _ in enumerate(cfg.up_sample_rates):
        cin, cout = c0 // 2 ** i, c0 // 2 ** (i + 1)
        act(f"{d}.activations.{i}", cin, n)
        n += 1
        conv(f"{d}.up_sample_conv_layers.{i}.conv", cin, cout, 4, transposed=True, form="wn")
        for j, k in enumerate(cfg.kernel_sizes):
            rb = f"{d}.res_layers.{i}.res_blocks.{j}.res_blocks"
            for m, _ in enumerate(cfg.dilations):
                act(f"{rb}.{m}.input_activation", cout, n)
                conv(f"{rb}.{m}.input_conv.conv", cout, cout, k,
                     form=("param", "plain")[m % 2])
                act(f"{rb}.{m}.skip_activation", cout, n + 1)
                conv(f"{rb}.{m}.skip_conv.conv", cout, cout, 1)
                n += 2
    cl = c0 // 2 ** len(cfg.up_sample_rates)
    act(f"{d}.post_activation", cl, n)
    conv(f"{d}.post_conv.conv", cl, 1, cfg.post_kernel)
    add("audio_encoder.pre_conv.conv.weight", 4, 1, 3)
    add("discriminator.disc.0.weight", 2, 2)
    return sd


def write_nemo(path, ycfg, sd, yaml_name="model_config.yaml"):
    with tarfile.open(path, "w") as tar:
        for name, blob in ((f"./{yaml_name}", yaml.safe_dump(ycfg).encode()),
                           ("./model_weights.ckpt", None)):
            if blob is None:
                buf = io.BytesIO()
                torch.save(_torch_sd(sd), buf)
                blob = buf.getvalue()
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))


NEMO_YAML = {"sample_rate": 22050,
             "audio_decoder": {"base_channels": 16, "up_sample_rates": [2, 2],
                               "activation": "half_snake"},
             "vector_quantizer": {"num_groups": 4, "num_levels": [9, 8, 8, 7]}}


def test_load_nanocodec_matches_tts_tpu(tmp_path):
    from tts_tpu.weights.kani_loader import load_nanocodec as jax_load
    from tts_tpu_torch.weights.kani_loader import load_nanocodec, nanocodec_config_from_yaml

    cfg = nanocodec_config_from_yaml(NEMO_YAML)
    path = str(tmp_path / "codec.nemo")
    write_nemo(path, NEMO_YAML, nanocodec_state_dict(cfg, _rng(7)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        params, pcfg = load_nanocodec(path, device="cpu")
    jp, jcfg = jax_load(path)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg) and pcfg == cfg
    assert_same_tree(params, params_from_jax(_jax_tree(jp), "cpu", torch.float32))


@pytest.mark.parametrize("fault", ["no_yaml_package", "no_config"])
def test_load_nanocodec_needs_its_config(tmp_path, monkeypatch, fault):
    from tts_tpu_torch.weights.kani_loader import load_nanocodec, nanocodec_config_from_yaml

    path = str(tmp_path / "codec.nemo")
    sd = nanocodec_state_dict(nanocodec_config_from_yaml(NEMO_YAML), _rng(7))
    if fault == "no_yaml_package":
        write_nemo(path, NEMO_YAML, sd)
        monkeypatch.setitem(sys.modules, "yaml", None)
        with pytest.raises(ImportError, match="PyYAML"):
            load_nanocodec(path, device="cpu")
    else:
        write_nemo(path, NEMO_YAML, sd, yaml_name="other.yaml")
        with pytest.raises(FileNotFoundError, match="missing config"):
            load_nanocodec(path, device="cpu")


# ------------------------------------------------------------------ Qwen


def qwen_talker_state_dict(cfg, rng):
    """The Qwen3-TTS talker + code predictor layout (talker.* keys)."""
    t, p = cfg.talker, cfg.predictor
    sd = _qwen_stack_sd("talker.model", t.hidden_size, t.num_heads, t.num_kv_heads,
                        t.head_dim, t.ffn_dim, t.num_layers, rng, bias=True)
    sd.update(_qwen_stack_sd("talker.code_predictor.model", p.hidden_size, p.num_heads,
                             p.num_kv_heads, p.head_dim, p.ffn_dim, p.num_layers, rng))
    add = _add(sd, rng)
    sd["talker.model.norm.weight"] = (np.abs(rng.standard_normal(t.hidden_size)) + 0.5
                                      ).astype(np.float32)
    sd["talker.code_predictor.model.norm.weight"] = (
        np.abs(rng.standard_normal(p.hidden_size)) + 0.5).astype(np.float32)
    for g in range(cfg.num_code_groups - 1):
        add(f"talker.code_predictor.lm_head.{g}.weight", cfg.group_vocab, p.hidden_size)
        add(f"talker.code_predictor.model.codec_embedding.{g}.weight", cfg.group_vocab,
            t.hidden_size)
    add("talker.codec_head.weight", cfg.codec_vocab, t.hidden_size)
    add("talker.model.codec_embedding.weight", cfg.codec_vocab, t.hidden_size)
    add("talker.model.text_embedding.weight", cfg.text_vocab, cfg.text_hidden)
    add("talker.text_projection.weight", t.hidden_size, cfg.text_hidden)
    add("talker.code_predictor.small_to_mtp_projection.weight", p.hidden_size, t.hidden_size)
    return sd


def write_qwen_dir(path, rng, text_bias=True):
    sd = qwen_talker_state_dict(QWEN_TINY, rng)
    if text_bias:
        sd["talker.text_projection.bias"] = (rng.standard_normal(
            QWEN_TINY.talker.hidden_size) * 0.05).astype(np.float32)
    tl.write_safetensors(os.path.join(path, "model.safetensors"), sd)
    tl.write_safetensors(os.path.join(path, "speech_tokenizer.safetensors"),
                         qwen_codec_state_dict(QWEN_CODEC_TINY, rng))


@pytest.mark.parametrize("text_bias", [True, False])
def test_load_qwen_tts_matches_tts_tpu(tmp_path, text_bias):
    from tts_tpu.models.qwen_tts import QwenTTSConfig as JCfg
    from tts_tpu.weights.qwen_loader import load_qwen_tts as jax_load
    from tts_tpu_torch.weights.qwen_loader import load_qwen_tts

    write_qwen_dir(str(tmp_path), _rng(8), text_bias)
    jcfg = JCfg(**{**dataclasses.asdict(QWEN_TINY), "talker": _jax_stack_cfg(QWEN_TINY.talker),
                   "predictor": _jax_stack_cfg(QWEN_TINY.predictor)})
    params, _ = load_qwen_tts(str(tmp_path), QWEN_TINY, device="cpu")
    jp, _ = jax_load(str(tmp_path), jcfg)
    assert_same_tree(params, params_from_jax(_jax_tree(jp), "cpu", torch.float32))


def _jax_stack_cfg(c):
    from tts_tpu.models.qwen_tts import Qwen3StackConfig

    return Qwen3StackConfig(**dataclasses.asdict(c))


def test_qwen_config_from_json_matches_tts_tpu(tmp_path):
    from tts_tpu.weights.qwen_loader import qwen_config_from_json as jax_cfg
    from tts_tpu_torch.weights.qwen_loader import qwen_config_from_json

    c = {"tts_bos_token_id": 97, "text_vocab_size": 100, "text_hidden_size": 16,
         "talker_config": {"hidden_size": 32, "num_attention_heads": 2,
                           "num_key_value_heads": 1, "head_dim": 16,
                           "intermediate_size": 64, "num_hidden_layers": 2,
                           "vocab_size": 64, "codec_eos_token_id": 62,
                           "code_predictor_config": {"hidden_size": 24, "num_hidden_layers": 2,
                                                     "vocab_size": 32, "num_code_groups": 4}}}
    (tmp_path / "config.json").write_text(json.dumps(c))
    got, ref = qwen_config_from_json(str(tmp_path)), jax_cfg(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.talker.hidden_size == 32 and got.predictor.num_layers == 2


def test_load_qwen_codec_matches_tts_tpu(tmp_path):
    from tts_tpu.models.qwen_codec import QwenCodecDecoderConfig as JCfg
    from tts_tpu.weights.qwen_loader import load_qwen_codec as jax_load
    from tts_tpu_torch.weights.qwen_loader import load_qwen_codec

    write_qwen_dir(str(tmp_path), _rng(9))
    params, cfg = load_qwen_codec(str(tmp_path), QWEN_CODEC_TINY, device="cpu")
    jp, _ = jax_load(str(tmp_path), JCfg(**dataclasses.asdict(QWEN_CODEC_TINY)))
    assert_same_tree(params, params_from_jax(_jax_tree(jp), "cpu", torch.float32))


def ecapa_state_dict(prefix, c, n_mels, scale, se, attn, spk, rng, bn):
    """The speechbrain ECAPA-TDNN layout (tdnn convs, Res2Net, SE, attentive
    stats pooling); with `bn` each tdnn and the pooling carry BatchNorm
    running statistics (IndexTTS), without them the Qwen variant."""
    sd = {}
    add = _add(sd, rng)

    def tdnn(pre, cin, cout, k):
        add(f"{pre}.conv.weight", cout, cin, k)
        add(f"{pre}.conv.bias", cout)
        if bn:
            norm(f"{pre}.norm.norm", cout)

    def norm(pre, n):
        add(f"{pre}.weight", n, scale=1.0)
        add(f"{pre}.bias", n)
        add(f"{pre}.running_mean", n)
        sd[f"{pre}.running_var"] = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)

    sub = c // scale
    tdnn(f"{prefix}.blocks.0", n_mels, c, 5)
    for i in (1, 2, 3):
        pre = f"{prefix}.blocks.{i}"
        tdnn(f"{pre}.tdnn1", c, c, 1)
        for j in range(scale - 1):
            tdnn(f"{pre}.res2net_block.blocks.{j}", sub, sub, 3)
        tdnn(f"{pre}.tdnn2", c, c, 1)
        add(f"{pre}.se_block.conv1.weight", se, c, 1)
        add(f"{pre}.se_block.conv1.bias", se)
        add(f"{pre}.se_block.conv2.weight", c, se, 1)
        add(f"{pre}.se_block.conv2.bias", c)
    tdnn(f"{prefix}.mfa", 3 * c, 3 * c, 1)
    tdnn(f"{prefix}.asp.tdnn", 9 * c, attn, 1)
    add(f"{prefix}.asp.conv.weight", 3 * c, attn, 1)
    add(f"{prefix}.asp.conv.bias", 3 * c)
    if bn:
        norm(f"{prefix}.asp_bn", 6 * c)
    add(f"{prefix}.fc.weight", spk, 6 * c, 1)
    add(f"{prefix}.fc.bias", spk)
    return sd


def test_qwen_speaker_fold_matches_tts_tpu():
    from tts_tpu.weights.qwen_loader import qwen_speaker_from_state_dict as jax_fold
    from tts_tpu_torch.weights.qwen_loader import qwen_speaker_from_state_dict

    sd = ecapa_state_dict("speaker_encoder", 16, 24, 4, 8, 8, 12, _rng(10), bn=False)
    got = qwen_speaker_from_state_dict(sd, res2net_scale=4)
    assert_same_host(got, jax_fold(sd, res2net_scale=4))
    placed = tl.place(got, "cpu", torch.bfloat16, kind="ecapa")
    assert "bn" not in placed["block0"] and placed["fc"]["w"].dtype == torch.bfloat16


# --------------------------------------------------------------- IndexTTS


def conformer_perceiver_state_dict(cfg, rng):
    """conditioning_encoder.* (ESPnet conformer) and perceiver_encoder.*."""
    sd = {}
    add = _add(sd, rng)
    d, h = cfg.enc_dim, cfg.enc_heads
    hd = d // h
    p = "conditioning_encoder"
    f_out = ((cfg.n_mels - 1) // 2 - 1) // 2

    def ln(pre, n=d):
        sd[f"{pre}.weight"] = (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32)
        add(f"{pre}.bias", n)

    add(f"{p}.embed.conv.0.weight", d, 1, 3, 3)
    add(f"{p}.embed.conv.0.bias", d)
    add(f"{p}.embed.conv.2.weight", d, d, 3, 3)
    add(f"{p}.embed.conv.2.bias", d)
    add(f"{p}.embed.out.0.weight", d, d * f_out)
    add(f"{p}.embed.out.0.bias", d)
    for i in range(cfg.enc_layers):
        pre = f"{p}.encoders.{i}"
        a, cm = f"{pre}.self_attn", f"{pre}.conv_module"
        for n in ("q", "k", "v"):
            add(f"{a}.linear_{n}.weight", d, d)
            add(f"{a}.linear_{n}.bias", d)
        add(f"{a}.linear_pos.weight", d, d)
        add(f"{a}.pos_bias_u", h, hd)
        add(f"{a}.pos_bias_v", h, hd)
        add(f"{a}.linear_out.weight", d, d)
        add(f"{a}.linear_out.bias", d)
        add(f"{cm}.pointwise_conv1.weight", 2 * d, d, 1)
        add(f"{cm}.pointwise_conv1.bias", 2 * d)
        add(f"{cm}.depthwise_conv.weight", d, 1, cfg.enc_conv_kernel)
        add(f"{cm}.depthwise_conv.bias", d)
        add(f"{cm}.pointwise_conv2.weight", d, d, 1)
        add(f"{cm}.pointwise_conv2.bias", d)
        add(f"{pre}.feed_forward.w_1.weight", cfg.enc_ff_dim, d)
        add(f"{pre}.feed_forward.w_1.bias", cfg.enc_ff_dim)
        add(f"{pre}.feed_forward.w_2.weight", d, cfg.enc_ff_dim)
        add(f"{pre}.feed_forward.w_2.bias", d)
        for n in ("norm_mha", "norm_conv", "conv_module.norm", "norm_ff", "norm_final"):
            ln(f"{pre}.{n}")
    ln(f"{p}.after_norm")

    q = "perceiver_encoder"
    g, ph, pd = cfg.gpt_dim, cfg.perceiver_heads, cfg.perceiver_dim_head
    inner, ff = ph * pd, g * cfg.perceiver_ff_mult
    add(f"{q}.proj_context.weight", g, d)
    add(f"{q}.proj_context.bias", g)
    add(f"{q}.latents", cfg.num_latents, g, scale=1.0)
    for i in range(2):
        pre = f"{q}.layers.{i}"
        add(f"{pre}.0.to_q.weight", inner, g)
        add(f"{pre}.0.to_kv.weight", 2 * inner, g)
        add(f"{pre}.0.to_out.weight", g, inner)
        ln(f"{pre}.1.0", g)
        add(f"{pre}.1.1.weight", ff, g)
        add(f"{pre}.1.1.bias", ff)
        add(f"{pre}.1.3.weight", g, ff)
        add(f"{pre}.1.3.bias", g)
    ln(f"{q}.norm", g)
    return sd


INDEX_VCFG = dict(upsample_initial_channel=32, upsample_rates=(4, 2),
                  upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3, 5),
                  resblock_dilation_sizes=((1, 3), (1, 3)))


def write_indextts_dir(path, rng, with_config=True):
    from tts_tpu_torch.models.bigvgan import BigVGANConfig

    cfg = INDEX_TINY
    gpt = gpt_state_dict(cfg, rng)
    gpt.update(conformer_perceiver_state_dict(cfg, rng))
    torch.save(_torch_sd(gpt), os.path.join(path, "gpt.pth"))
    vcfg = BigVGANConfig(num_mels=cfg.gpt_dim, use_bias_at_final=True, use_tanh_at_final=True,
                         **INDEX_VCFG)
    bv = bigvgan_state_dict(vcfg, rng)
    bv.update(ecapa_state_dict("speaker_encoder", cfg.ecapa_channels, cfg.n_mels,
                               cfg.res2net_scale, cfg.se_channels, cfg.ecapa_attn_channels,
                               cfg.speaker_embed_dim, rng, bn=True))
    add = _add(bv, rng)
    add("cond_layer.weight", vcfg.upsample_initial_channel, cfg.speaker_embed_dim, 1)
    add("cond_layer.bias", vcfg.upsample_initial_channel)
    for i, c in enumerate(vcfg.stage_channels):
        add(f"conds.{i}.weight", c, cfg.speaker_embed_dim, 1)
        add(f"conds.{i}.bias", c)
    torch.save(_torch_sd(bv), os.path.join(path, "bigvgan.pth"))
    if with_config:
        section = {k: (list(v) if isinstance(v, tuple) else v) for k, v in INDEX_VCFG.items()}
        section["resblock_dilation_sizes"] = [list(d) for d in INDEX_VCFG["resblock_dilation_sizes"]]
        section.update(activation="snakebeta", snake_logscale=True, sampling_rate=24000,
                       resblock="1", feat_upsample=True)
        with open(os.path.join(path, "config.yaml"), "w") as f:
            yaml.safe_dump({"gpt": {"model_dim": cfg.gpt_dim}, "bigvgan": section}, f)


def _jax_index_cfg():
    from tts_tpu.models.indextts import IndexTTSConfig

    return IndexTTSConfig(**dataclasses.asdict(INDEX_TINY))


def test_load_indextts_matches_tts_tpu(tmp_path):
    from tts_tpu.weights.indextts_loader import load_indextts as jax_load
    from tts_tpu_torch.weights.indextts_loader import load_indextts

    write_indextts_dir(str(tmp_path), _rng(11))
    params, cfg, vcfg = load_indextts(str(tmp_path), INDEX_TINY, device="cpu")
    jp, _, jvcfg = jax_load(str(tmp_path), _jax_index_cfg())
    assert dataclasses.asdict(vcfg) == dataclasses.asdict(jvcfg)
    assert vcfg.upsample_rates == (4, 2) and vcfg.feat_upsample
    assert_same_tree(params, params_from_jax(_jax_tree(jp), "cpu", torch.float32))


@pytest.mark.parametrize("part", ["indextts_gpt", "conformer", "perceiver", "ecapa"])
def test_indextts_parts_match_tts_tpu(part):
    import tts_tpu.weights.indextts_loader as jl
    import tts_tpu_torch.weights.indextts_loader as pl

    rng = _rng(12)
    cfg = INDEX_TINY
    if part == "ecapa":
        sd = ecapa_state_dict("speaker_encoder", cfg.ecapa_channels, cfg.n_mels,
                              cfg.res2net_scale, cfg.se_channels, cfg.ecapa_attn_channels,
                              cfg.speaker_embed_dim, rng, bn=True)
    else:
        sd = gpt_state_dict(cfg, rng)
        sd.update(conformer_perceiver_state_dict(cfg, rng))
    name = {"indextts_gpt": "gpt"}.get(part, part)
    got = getattr(pl, f"indextts_{name}_from_state_dict")(sd, cfg)
    assert_same_host(got, getattr(jl, f"indextts_{name}_from_state_dict")(sd, _jax_index_cfg()))
    tl.place(got, "cpu", torch.float32, kind=part)


def test_load_indextts_raises_without_config_yaml(tmp_path):
    """No guessed vocoder: tts_tpu falls back to IndexTTS-1.5's rates here."""
    from tts_tpu.weights.indextts_loader import _bigvgan_config_from_yaml
    from tts_tpu.weights.indextts_loader import load_indextts as jax_load
    from tts_tpu_torch.weights.indextts_loader import load_indextts

    write_indextts_dir(str(tmp_path), _rng(11), with_config=False)
    with pytest.raises(FileNotFoundError, match="config.yaml"):
        load_indextts(str(tmp_path), INDEX_TINY, device="cpu")
    # tts_tpu takes IndexTTS-1.5's 256x rates instead, which this checkpoint's
    # two stages and dilations (1, 3) do not fit
    fallback = _bigvgan_config_from_yaml(str(tmp_path / "config.yaml"), _jax_index_cfg())
    assert fallback.upsample_rates == (4, 4, 2, 2, 2, 2)
    with pytest.raises(KeyError, match="resblocks"):
        jax_load(str(tmp_path), _jax_index_cfg())


def test_load_indextts_names_pyyaml(tmp_path, monkeypatch):
    from tts_tpu_torch.weights.indextts_loader import load_indextts

    write_indextts_dir(str(tmp_path), _rng(11))
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        load_indextts(str(tmp_path), INDEX_TINY, device="cpu")


# ----------------------------------------------------------------- VoxCPM


VOX_CFG = dataclasses.replace(VOX_TINY, vae=VAE_TINY)


def voxcpm_state_dict(cfg, rng, delta):
    """The VoxCPM layout: base_lm, residual_lm, fsq_layer, the projections,
    the feature encoder and the CFM estimator (+ its delta-time MLP)."""
    b, r, fe, est = cfg.base, cfg.residual, cfg.feat_encoder, cfg.estimator
    lat, hs = cfg.vae.latent_dim, b.hidden_size
    sd = {}
    for prefix, c in (("base_lm", b), ("residual_lm", r), ("feat_encoder.encoder", fe),
                      ("feat_decoder.estimator.decoder", est)):
        sd.update(_qwen_stack_sd(prefix, c.hidden_size, c.num_heads, c.num_kv_heads,
                                 c.head_dim, c.ffn_dim, c.num_layers, rng))
        sd[f"{prefix}.norm.weight"] = (np.abs(rng.standard_normal(c.hidden_size)) + 0.5
                                       ).astype(np.float32)
    sd = {k: v for k, v in sd.items() if "q_norm" not in k and "k_norm" not in k}
    add = _add(sd, rng)
    add("base_lm.embed_tokens.weight", cfg.vocab_size, hs)
    add("fsq_layer.in_proj.weight", cfg.fsq_dim, hs)
    add("fsq_layer.in_proj.bias", cfg.fsq_dim)
    add("fsq_layer.out_proj.weight", hs, cfg.fsq_dim)
    add("lm_to_dit_proj.weight", est.hidden_size, hs)
    add("stop_proj.weight", hs, hs)
    add("stop_head.weight", 2, hs)
    add("res_to_dit_proj.weight", est.hidden_size, hs)
    add("feat_encoder.in_proj.weight", fe.hidden_size, lat)
    add("feat_encoder.in_proj.bias", fe.hidden_size)
    add("feat_encoder.special_token", 1, 1, 1, fe.hidden_size)
    add("enc_to_lm_proj.weight", hs, fe.hidden_size)
    e = "feat_decoder.estimator"
    add(f"{e}.cond_proj.weight", est.hidden_size, lat)
    add(f"{e}.cond_proj.bias", est.hidden_size)
    add(f"{e}.in_proj.weight", est.hidden_size, lat)
    add(f"{e}.in_proj.bias", est.hidden_size)
    add(f"{e}.out_proj.weight", lat, est.hidden_size)
    for m in ("time_mlp",) + (("delta_time_mlp",) if delta else ()):
        add(f"{e}.{m}.0.weight", est.hidden_size, est.hidden_size)
        add(f"{e}.{m}.0.bias", est.hidden_size)
        add(f"{e}.{m}.2.weight", est.hidden_size, est.hidden_size)
        add(f"{e}.{m}.2.bias", est.hidden_size)
    sd.update(vae_state_dict(cfg.vae, rng))
    return sd


def _jax_vox_cfg(cfg):
    from tts_tpu.models import voxcpm as jv

    return jv.VoxCPMConfig(**{
        **dataclasses.asdict(cfg),
        **{k: jv.LlamaStackConfig(**dataclasses.asdict(getattr(cfg, k)))
           for k in ("base", "residual", "feat_encoder", "estimator")},
        "vae": jv.VaeConfig(**dataclasses.asdict(cfg.vae))})


@pytest.mark.parametrize("fmt,use_mup,delta,mean_mode", [
    ("bin", False, False, False), ("safetensors", True, True, False),
    ("safetensors", False, True, True)])
def test_load_voxcpm_matches_tts_tpu(tmp_path, fmt, use_mup, delta, mean_mode):
    from tts_tpu.weights.voxcpm_loader import load_voxcpm as jax_load
    from tts_tpu_torch.weights.voxcpm_loader import load_voxcpm

    cfg = dataclasses.replace(VOX_CFG, cfm_mean_mode=mean_mode)
    sd = voxcpm_state_dict(cfg, _rng(13), delta)
    if fmt == "bin":
        torch.save(_torch_sd(sd), str(tmp_path / "pytorch_model.bin"))
    else:
        tl.write_safetensors(str(tmp_path / "model.safetensors"), sd)
    kw = dict(use_mup=use_mup, scale_emb=12.0, scale_depth=1.4)
    params, vae, _ = load_voxcpm(str(tmp_path), cfg, device="cpu", **kw)
    jp, jvae, _ = jax_load(str(tmp_path), _jax_vox_cfg(cfg), **kw)
    assert_same_tree(params, params_from_jax(_jax_tree(jp), "cpu", torch.float32))
    assert_same_tree(vae, params_from_jax(_jax_tree(jvae), "cpu", torch.float32))
    assert "sr_scale" in vae["dec"]["dec_blocks"][0] and "pre_dw" in vae["dec"]


def test_vae_fold_matches_tts_tpu():
    from tts_tpu.models.voxcpm import VaeConfig as JVae
    from tts_tpu.weights.voxcpm_loader import vae_from_state_dict as jax_fold
    from tts_tpu_torch.weights.voxcpm_loader import vae_from_state_dict

    sd = vae_state_dict(VAE_TINY, _rng(14))
    got = vae_from_state_dict(sd, VAE_TINY)
    assert got["enc_blocks"][0]["units"][0]["c1"]["w"].shape == (7, 1, 4)
    assert_same_host(got, jax_fold(sd, JVae(**dataclasses.asdict(VAE_TINY))))


# ------------------------------------------------------- the .npz bundles


def _bundle_trees():
    """The same tree in both packages: float, bf16 and int leaves, lists, a
    None, and int8 (QTensor), packed int4 (QTensor4) and runtime int4
    (QTensorG) leaves."""
    from tts_tpu.quant import weight_only as jq
    from tts_tpu_torch.quant import weight_only as tq

    rng = _rng(15)
    f = rng.standard_normal((4, 6)).astype(np.float32)
    bf = rng.standard_normal(5).astype(np.float32)
    q = rng.integers(-127, 128, (8, 6)).astype(np.int8)
    s = (rng.random(6) + 0.1).astype(np.float32)
    q4 = rng.integers(-128, 128, (16, 6)).astype(np.int8)
    s4 = (rng.random((1, 6)) + 0.1).astype(np.float32)
    qg = rng.integers(-7, 8, (32, 6)).astype(np.int8)
    ids = np.arange(5, dtype=np.int32)
    jtree = {"a": jnp.asarray(f), "bf": jnp.asarray(bf, jnp.bfloat16), "ids": jnp.asarray(ids),
             "layers": [{"w": jnp.asarray(f[:2])}, {"w": jnp.asarray(f[2:])}],
             "none": None,
             "q8": jq.QTensor(q=jnp.asarray(q), scale=jnp.asarray(s)),
             "q4": jq.QTensor4(q=jnp.asarray(q4), scale=jnp.asarray(s4), group_size=32),
             "qg": jq.QTensorG(q=jnp.asarray(qg), scale=jnp.asarray(s4), group_size=32)}
    t = torch.from_numpy
    ttree = {"a": t(f), "bf": t(bf).to(torch.bfloat16), "ids": t(ids),
             "layers": [{"w": t(f[:2].copy())}, {"w": t(f[2:].copy())}],
             "none": None,
             "q8": tq.QTensor(q=t(q), scale=t(s)),
             "q4": tq.QTensor4(q=t(q4), scale=t(s4), group_size=32),
             "qg": tq.QTensorG(q=t(qg), scale=t(s4), group_size=32)}
    return jtree, ttree


def _assert_bundle(tree, ttree):
    from tts_tpu_torch.quant import weight_only as tq

    assert set(tree) == set(ttree) and tree["none"] is None
    assert isinstance(tree["layers"], list) and len(tree["layers"]) == 2
    assert tree["bf"].dtype == torch.bfloat16 and torch.equal(tree["bf"], ttree["bf"])
    for k in ("a", "ids"):
        assert tree[k].dtype == ttree[k].dtype and torch.equal(tree[k], ttree[k])
    assert torch.equal(tree["layers"][1]["w"], ttree["layers"][1]["w"])
    for k, cls in (("q8", tq.QTensor), ("q4", tq.QTensor4), ("qg", tq.QTensorG)):
        assert type(tree[k]) is cls
        assert torch.equal(tree[k].q, ttree[k].q) and torch.equal(tree[k].scale, ttree[k].scale)
        assert getattr(tree[k], "group_size", None) == getattr(ttree[k], "group_size", None)


@pytest.mark.parametrize("direction", ["port_to_port", "tts_tpu_to_port", "port_to_tts_tpu"])
def test_bundle_roundtrip_between_packages(tmp_path, direction):
    from tts_tpu.quant import weight_only as jq
    from tts_tpu.weights.save import load_params as jax_load
    from tts_tpu.weights.save import save_params as jax_save
    from tts_tpu_torch.weights.save import load_params, save_params

    jtree, ttree = _bundle_trees()
    path = str(tmp_path / "b.npz")
    if direction == "port_to_tts_tpu":
        save_params(path, ttree)
        back = jax_load(path, device=False)
        assert back["none"] is None and isinstance(back["layers"], list)
        assert str(back["bf"].dtype) == "bfloat16"
        np.testing.assert_array_equal(back["bf"].astype(np.float32),
                                      ttree["bf"].float().numpy())
        np.testing.assert_array_equal(back["a"], ttree["a"].numpy())
        for k, cls in (("q8", jq.QTensor), ("q4", jq.QTensor4), ("qg", jq.QTensorG)):
            assert type(back[k]) is cls
            np.testing.assert_array_equal(np.asarray(back[k].q), ttree[k].q.numpy())
            np.testing.assert_array_equal(np.asarray(back[k].scale), ttree[k].scale.numpy())
        return
    if direction == "tts_tpu_to_port":
        jax_save(path, jtree)
    else:
        save_params(path, ttree)
    _assert_bundle(load_params(path, device="cpu"), ttree)


def test_bundle_of_a_loaded_tree(tmp_path):
    """A loaded bf16 F5 tree saves and loads back bit for bit."""
    from tts_tpu_torch.models.f5 import F5Config
    from tts_tpu_torch.weights.f5_loader import load_f5
    from tts_tpu_torch.weights.save import load_params, save_params

    cfg = F5Config(**F5_SMALL)
    params = load_f5(*write_f5(tmp_path, cfg), cfg, dtype=torch.bfloat16, device="cpu")[0]
    save_params(str(tmp_path / "f5.npz"), params)
    assert_same_tree(load_params(str(tmp_path / "f5.npz"), device="cpu"), params)


def _configs():
    """name -> (the port's config, tts_tpu's or None where the fields differ:
    F5's attn_kv_split is a TPU knob the port has not)."""
    from tts_tpu.models.kani import KaniConfig as JKaniConfig
    from tts_tpu.models.qwen_tts import QwenTTSConfig as JQwenTTSConfig
    from tts_tpu_torch.models.f5 import F5Config
    from tts_tpu_torch.models.kani import KaniConfig

    jqwen = JQwenTTSConfig(**{**dataclasses.asdict(QWEN_TINY),
                              "talker": _jax_stack_cfg(QWEN_TINY.talker),
                              "predictor": _jax_stack_cfg(QWEN_TINY.predictor)})
    return {"F5Config": (F5Config(**F5_SMALL), None),
            "QwenTTSConfig": (QWEN_TINY, jqwen),
            "VoxCPMConfig": (VOX_CFG, _jax_vox_cfg(VOX_CFG)),
            "KaniConfig": (KaniConfig(**KANI_KW), JKaniConfig(**KANI_KW))}


@pytest.mark.parametrize("name", ["F5Config", "QwenTTSConfig", "VoxCPMConfig", "KaniConfig"])
def test_config_dict_roundtrip(name):
    from tts_tpu.weights.save import config_to_dict as jax_to_dict
    from tts_tpu_torch.weights.save import config_from_dict, config_to_dict

    cfg, jcfg = _configs()[name]
    d = config_to_dict(cfg)
    assert config_from_dict(type(cfg), json.loads(json.dumps(d))) == cfg
    if jcfg is not None:
        assert d == jax_to_dict(jcfg)


# ------------------------------------------------------ signatures, export


LOADERS = {"load_f5": "f5_loader", "load_vocos": "f5_loader", "load_bigvgan": "loaders",
           "load_kani_lm": "kani_loader", "load_nanocodec": "kani_loader",
           "load_qwen_tts": "qwen_loader", "load_qwen_codec": "qwen_loader",
           "load_indextts": "indextts_loader", "load_voxcpm": "voxcpm_loader"}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_signature(name):
    """tts_tpu's arguments, then device (default the card) and dtype (default
    fp32); exported lazily from tts_tpu_torch.weights."""
    import importlib

    import tts_tpu.weights as jw
    import tts_tpu_torch.weights as w

    fn = getattr(importlib.import_module(f"tts_tpu_torch.weights.{LOADERS[name]}"), name)
    params = inspect.signature(fn).parameters
    assert params["device"].default == "cuda" and params["dtype"].default is torch.float32
    jmod = importlib.import_module(f"tts_tpu.weights.{LOADERS[name]}")
    assert [p for p in inspect.signature(getattr(jmod, name)).parameters] == \
        [p for p in params if p != "device"]
    assert getattr(w, name) is fn
    if name in jw.__all__:
        assert name in w.__all__


# ------------------------------------------------- the F5 slice end to end


def test_f5_from_checkpoint_files_matches_tts_tpu(tmp_path):
    """Checkpoint files -> load_f5 / load_vocos -> F5Pipeline.synthesize, in
    both packages, with tts_tpu's noise draw handed to the port: within the
    2 LSB of tests/test_torch_f5.py::test_synthesize_matches_jax."""
    from tts_tpu.models.f5 import F5Config as JF5Config
    from tts_tpu.models.vocos import VocosConfig as JVocosConfig
    from tts_tpu.runtime.f5 import F5Pipeline as JaxPipeline
    from tts_tpu.weights.f5_loader import load_f5 as jax_load_f5
    from tts_tpu.weights.f5_loader import load_vocos as jax_load_vocos
    from tts_tpu_torch.audio.wav import read_wav, write_wav
    from tts_tpu_torch.models.f5 import F5Config, F5Model
    from tts_tpu_torch.models.vocos import VocosConfig, VocosModel
    from tts_tpu_torch.runtime.f5 import F5Pipeline
    from tts_tpu_torch.weights import load_f5, load_vocos

    cfg = F5Config(**F5_SMALL)
    ckpt, vocab_path = write_f5(tmp_path, cfg, seed=3)
    vdir = write_vocos(tmp_path, VocosConfig(**VOCOS_SMALL), seed=4, loud=True)
    rng = np.random.default_rng(6)
    write_wav(str(tmp_path / "ref.wav"), (rng.standard_normal(12000) * 3000).astype(np.int16),
              24000)
    audio, _ = read_wav(str(tmp_path / "ref.wav"), target_rate=24000)
    ref_text, gen_text = "hello there.", " some words here"

    params, pcfg, vocab = load_f5(ckpt, vocab_path, cfg, device="cpu")
    vparams, vcfg = load_vocos(vdir, VocosConfig(**VOCOS_SMALL), device="cpu")
    pipe = F5Pipeline(F5Model(pcfg, params), vocab, VocosModel(vcfg, vparams))

    jp, jc, jvocab = jax_load_f5(ckpt, vocab_path, JF5Config(**F5_SMALL))
    jvp, jvc = jax_load_vocos(vdir, JVocosConfig(**VOCOS_SMALL))
    wav_j, _ = JaxPipeline(jp, jc, jvocab, jvp, jvc).synthesize(audio, ref_text, gen_text,
                                                                 seed=7)
    frames = pipe._prepare(audio, ref_text, gen_text)[4][2]
    noise = np.asarray(jax.random.normal(jax.random.key(7), (1, frames, jc.n_mels)))
    wav_t, stats = pipe.synthesize(audio, ref_text, gen_text, noise=noise)
    assert wav_t.dtype == np.int16 and wav_t.shape == wav_j.shape
    assert np.abs(wav_j.astype(np.int32)).max() > 3000
    assert np.abs(wav_t.astype(np.int32) - wav_j.astype(np.int32)).max() <= 2
    write_wav(str(tmp_path / "out.wav"), wav_t, 24000)
    back, rate = read_wav(str(tmp_path / "out.wav"))
    assert rate == 24000 and np.array_equal(back, wav_t)
