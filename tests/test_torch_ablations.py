"""Kernels 16 and 17, the port's ablation sets (ops/flash_variants.py,
ops/dit_mlp_q8_variants.py, on CPU tensors: their plain twins), against the
Pallas kernels they port, benchmarks/flash_ablation.py:flash_variant and
benchmarks/q8_kernel_profile.py:_mk, run in Pallas interpret mode; and the
two entry points (tts_tpu_torch/ablations) run with --device cpu.

Both scripts are loaded by path. q8_kernel_profile.py turns on a persistent
XLA compile cache under ~ when imported, so that is made a no-op first;
its INTERPRET flag is set for the call. Same numpy inputs, fp32 on both
sides.

Tolerances:
- kernel 16, atol 2e-5 (kernel 1's own parity bound): both sides compute
  the same fp32 math at the same points; only the order of fp32 sums
  differs. In bf16sm and nodiv the script takes exp2 of a bf16 score, which
  XLA's CPU backend expands to exp(x * bf16(ln 2)) with the product rounded
  to bf16 (12% off at x = -31); the card's exp2 and the twin's are exp2
  itself rounded to bf16, so the script's exp2 is taken in fp32 and rounded
  to bf16 for these two (the module's jnp, not JAX, is swapped). kvsplit2
  and kvsplit4 hold `base` with its keys over 2 and 4 CTAs against
  tts_tpu's flash_attention_flat with kv_split, at T 512: the TPU kernel
  splits the keys in 128-row chunks, so kv_split 4 needs T >= 512.
- kernel 17, on out and on out - x (the MLP term alone, which x could
  otherwise hide): fp32 variants atol 3e-5 + rtol 1e-4, with int8 rounding
  flips allowed in one row as tests/test_torch_q8_kernels.py allows them
  (an ulp of the fp32 LayerNorm or activation moves an activation across a
  .5; a flip moves its row by one step of the second product). gelu_bf16
  and lean take the gelu in bf16, and XLA's CPU tanh on bf16 is not the
  correctly rounded one the twin takes: about half the hidden values differ
  by one bf16 step (2^-8 relative), each moving its int8 value by up to 0.5
  steps, so out - x is held to 2^-6 in rel L2 and 2^-5 of max |ref - x| in
  max |err| (measured: 2^-7.6 and 2^-6.6). dots_only is integers below
  2^24 on both sides: equal.
"""
import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tts_tpu_torch.ops.dit_mlp_q8_variants import VARIANTS, mlp_block_q8_variant
from tts_tpu_torch.ops.flash_variants import flash_variant

ROOT = Path(__file__).resolve().parent.parent
ATOL16 = 2e-5
ATOL17, RTOL17 = 3e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def flash_script():
    return _load("_flash_ablation", "benchmarks/flash_ablation.py")


@pytest.fixture(scope="module")
def q8_script():
    import tts_tpu.utils.compile_cache as cc

    mp = pytest.MonkeyPatch()
    mp.setattr(cc, "enable_compile_cache", lambda *a, **k: None)
    try:
        yield _load("_q8_kernel_profile", "benchmarks/q8_kernel_profile.py")
    finally:
        mp.undo()


class _Exp2F32:
    """jax.numpy with exp2 of a bf16 array taken in fp32, rounded to bf16."""

    def __getattr__(self, name):
        if name == "exp2":
            return lambda a: jnp.exp2(a.astype(jnp.float32)).astype(a.dtype)
        return getattr(jnp, name)


def _flash_inputs(t: int, seed: int):
    """The script's inputs at B 1, H 2, D 64: qkv ~ N(0, 0.25) and its RoPE
    tables."""
    rng = np.random.default_rng(seed)
    qkv = (rng.standard_normal((1, t, 3 * 2 * 64)) * 0.5).astype(np.float32)
    ang = np.arange(t)[:, None] * np.exp(-np.arange(64)[None, :] / 10.0)
    return qkv, np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@pytest.mark.parametrize("variant", ["base", "qscale", "bf16sm", "nodiv"])
def test_flash_variant_matches_pallas(variant, flash_script, monkeypatch):
    qkv, cos, sin = _flash_inputs(256, 16)
    if variant in ("bf16sm", "nodiv"):
        monkeypatch.setattr(flash_script, "jnp", _Exp2F32())
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(flash_script.flash_variant(
            *map(jnp.asarray, (qkv, cos, sin)), heads=2, scale=0.125, variant=variant))
    out = flash_variant(*map(torch.from_numpy, (qkv, cos, sin)), heads=2, scale=0.125,
                        variant=variant)
    assert out.shape == (1, 256, 128) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL16, rtol=0)


@pytest.mark.parametrize("split", [2, 4])
def test_flash_kvsplit_matches_pallas(split):
    from tts_tpu.ops.flash_attention import flash_attention_flat

    qkv, cos, sin = _flash_inputs(512, 17)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(flash_attention_flat(*map(jnp.asarray, (qkv, cos, sin)), heads=2,
                                              scale=0.125, kv_split=split))
    out = flash_variant(*map(torch.from_numpy, (qkv, cos, sin)), heads=2, scale=0.125,
                        variant="base", kv_split=split)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL16, rtol=0)


def test_flash_variant_refuses():
    qkv, cos, sin = map(torch.from_numpy, _flash_inputs(64, 18))
    for kw in (dict(variant="fast"), dict(variant="qscale", kv_split=2),
               dict(variant="base", kv_split=3)):
        with pytest.raises(ValueError):
            flash_variant(qkv, cos, sin, heads=2, scale=0.125, **kw)
    with pytest.raises(ValueError, match="no kernel"):
        flash_variant(qkv.to("meta"), cos, sin, heads=2, scale=0.125, variant="base")


def _row_scale(v):
    return np.maximum(np.abs(v).max(-1), np.float32(1e-8)) * np.float32(1 / 127)


def _close_or_flip(out, ref, step):
    """Every element within ATOL17 + RTOL17 |ref|; past that only one row,
    each element within one step more."""
    step = np.broadcast_to(step, ref.shape).reshape(-1, ref.shape[-1])
    out, ref = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
    err = np.abs(out - ref)
    bad = err > ATOL17 + RTOL17 * np.abs(ref)
    rows = np.unique(np.nonzero(bad)[0])
    assert len(rows) <= 1, f"{len(rows)} rows past the tolerance: {rows}"
    assert np.all(err[bad] <= ATOL17 + RTOL17 * np.abs(ref[bad]) + step[bad])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mlp_variant_matches_pallas(variant, q8_script, monkeypatch):
    """B 1, T 160 (one of the script's 160-row blocks), D 128, F 256; the
    script's uniform int8 weights, with scales and biases drawn so that the
    MLP term is of the order of x. dots_only's x is spread to +-90 so that
    its int8 conversion and the wrap of acc >> 8 both act."""
    rng = np.random.default_rng(170 + list(VARIANTS).index(variant))
    b, t, d, f = 1, 160, 128, 256
    x = (rng.standard_normal((b, t, d)) * (20.0 if variant == "dots_only" else 1.0)
         ).astype(np.float32)
    mods = (rng.standard_normal((1, 3, d)) * 0.5).astype(np.float32)
    w1 = rng.integers(-127, 128, (d, f)).astype(np.int8)
    w2 = rng.integers(-127, 128, (f, d)).astype(np.int8)
    s1 = (rng.random(f) * 2e-3).astype(np.float32)
    s2 = (rng.random(d) * 2e-3).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    if VARIANTS[variant] is None:
        body = q8_script._body_dots_only
    else:
        ln, quant, gelu = VARIANTS[variant]
        body = functools.partial(q8_script._body, ln=ln, quant=quant, gelu=gelu)
    monkeypatch.setattr(q8_script, "INTERPRET", True)
    ref = np.asarray(q8_script._mk(body, *map(jnp.asarray, (
        x, mods, w1, s1[None], b1[None], w2, s2[None], b2[None]))))
    out = mlp_block_q8_variant(*map(torch.from_numpy, (x, mods, w1, s1, b1, w2, s2, b2)),
                               variant=variant).numpy()
    assert out.shape == (b, t, d) and out.dtype == np.float32
    if VARIANTS[variant] is None:
        acc = x.astype(np.int8).astype(np.int64) @ w1.astype(np.int64)
        assert np.abs(acc >> 8).max() > 127, "no acc >> 8 wrapped"
        np.testing.assert_array_equal(out, ref)
        return
    mlp, mlp_ref = out - x, ref - x
    assert np.abs(mlp_ref).max() > 0.5 * np.abs(x).max()
    if VARIANTS[variant][2] == "tanh_bf16":
        err = mlp - mlp_ref
        assert np.linalg.norm(err) <= 2.0 ** -6 * np.linalg.norm(mlp_ref)
        assert np.abs(err).max() <= 2.0 ** -5 * np.abs(mlp_ref).max()
        return
    # one int8 flip moves its row's y by at most one step: a hidden value's
    # (hs |w2[j, c]| s2[c]), or an input value's through every hidden value,
    # each moving by at most 1.13 (the activations' largest slope) xs
    # |w1[i, j]| s1[j] before its own quantization, whose dequantized value
    # then moves by at most that plus hs; the gate scales it into the output
    from tts_tpu_torch.ops.dit_mlp_q8_variants import _gelu, _layer_norm, _quantize
    ln, quant, gelu = VARIANTS[variant]
    xf, m = torch.from_numpy(x), torch.from_numpy(mods)
    nrm = (xf if ln == "none" else _layer_norm(xf, ln)) * (1 + m[:, 1:2]) + m[:, 0:1]
    q, xs = _quantize(nrm, quant)
    h = _gelu(q @ torch.from_numpy(w1).float() * xs * torch.from_numpy(s1)
              + torch.from_numpy(b1), gelu).numpy()
    hs = _row_scale(h)[..., None] if quant == "dynamic" else np.float32(0.05)
    dh = 1.13 * xs.numpy() * (np.abs(w1).max(0) * s1) + hs
    step = (dh @ (np.abs(w2) * s2)) * np.abs(mods[:, 2])
    _close_or_flip(out, ref, step)
    _close_or_flip(mlp, mlp_ref, step)


def test_mlp_variant_refuses():
    x = torch.zeros((1, 64, 128))
    w1, w2 = torch.zeros((128, 256), dtype=torch.int8), torch.zeros((256, 128), dtype=torch.int8)
    args = (x, torch.zeros((3, 128)), w1, torch.ones(256), torch.zeros(256), w2,
            torch.ones(128), torch.zeros(128))
    with pytest.raises(ValueError, match="variant"):
        mlp_block_q8_variant(*args, variant="fast")
    with pytest.raises(ValueError):
        mlp_block_q8_variant(*args[:2], w2, *args[3:], variant="full")
    with pytest.raises(ValueError, match="no kernel"):
        mlp_block_q8_variant(x.to("meta"), *args[1:], variant="full")


@pytest.mark.parametrize("entry, names", [
    ("flash_ablation", ["base", "qscale", "bf16sm", "nodiv", "kvsplit1", "kvsplit2",
                        "kvsplit4"]),
    ("q8_kernel_profile", list(VARIANTS)),
])
def test_entry_point_cpu_lines(entry, names):
    """--device cpu: one JSON line a variant, every default variant in
    order, at the script's T 1408 (a few seconds on the CPU), finite errors
    and bound, and no time (nothing ran on a card)."""
    proc = subprocess.run([sys.executable, "-m", f"tts_tpu_torch.ablations.{entry}",
                           "--device", "cpu"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(s) for s in proc.stdout.splitlines()]
    assert [ln["variant"] for ln in lines] == names
    for ln in lines:
        assert ln["card"] == "cpu" and ln["ms"] is None and ln["chain_ms"] is None
        assert ln["shape"]["T"] == 1408
        assert np.isfinite([ln["maxabs"], ln["mad"], ln["bound_ms"]]).all()
        assert ln["bound_by"] in ("bytes", "operations")


@pytest.mark.parametrize("entry, names", [
    ("flash_ablation", ["nodiv", "kvsplit2"]), ("q8_kernel_profile", ["dots_only", "full"])])
def test_entry_point_named_variants(entry, names):
    """Named variants run alone; q8's full runs first, for the marginals;
    an unknown name is refused; without --device cpu and with no card the
    run fails."""
    cmd = [sys.executable, "-m", f"tts_tpu_torch.ablations.{entry}"]
    proc = subprocess.run([*cmd, *names, "--device", "cpu"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = [json.loads(s)["variant"] for s in proc.stdout.splitlines()]
    assert sorted(got) == sorted(names)
    if entry == "q8_kernel_profile":
        assert got[0] == "full"
    bad = subprocess.run([*cmd, "nope", "--device", "cpu"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert bad.returncode != 0 and not bad.stdout
    if not torch.cuda.is_available():
        none = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert none.returncode != 0 and not none.stdout
        assert "no CUDA device" in none.stderr
