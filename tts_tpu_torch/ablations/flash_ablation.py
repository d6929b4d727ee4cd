"""Kernel 16's ablation entry point: kernel 1's epilogue variants on the card.

    python -m tts_tpu_torch.ablations.flash_ablation [variant ...] [--device cpu]

Counterpart of benchmarks/flash_ablation.py, at its shape (B 2, T 1408, H
16, D 64, scale 1/8, every key kept) and with its variants (default all):
base, qscale, bf16sm, nodiv (ops/flash_variants.py says what each changes)
and kvsplit1, kvsplit2, kvsplit4 (base with each row block's keys over a
cluster of 1, 2 or 4 CTAs). qkv ~ N(0, 0.25) in bf16, from a
torch.Generator on the device; the RoPE tables are the script's.

Each variant prints one JSON line: "ms", the device time a call of its two
launches (RoPE pre-pass and core; a torch.profiler trace of 10 calls);
"chain_ms", a call over a chain of 10 (CUDA events); "maxabs" and "mad"
against the fp32 reference chain (RoPE, softmax(q k^T scale), P V in fp32);
the bound (two products in bf16, or the bytes) and the exp floor (one exp2
a score on the SFUs). With --device cpu the twin runs and nothing is timed.
"""
from __future__ import annotations

import torch

from ..ops.flash_variants import flash_variant
from . import card, chain_ms, device_ms, emit, errors, exp_floor_ms, nbytes, parse, set_bound

B, T, H, D = 2, 1408, 16, 64
SCALE = 1.0 / D ** 0.5
SEED = 0
NAMES = ("base", "qscale", "bf16sm", "nodiv", "kvsplit1", "kvsplit2", "kvsplit4")


def inputs(device: torch.device) -> tuple:
    """qkv (B, T, 3*H*D) bf16 and the script's fp32 RoPE tables (T, D)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    qkv = (torch.randn((B, T, 3 * H * D), generator=gen, device=device) * 0.5).to(torch.bfloat16)
    ang = torch.arange(T, device=device)[:, None] \
        * torch.exp(-torch.arange(D, device=device)[None, :] / 10.0)
    return qkv, torch.cos(ang), torch.sin(ang)


def reference(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The fp32 reference chain: RoPE on q and k, softmax(q k^T scale) v."""
    b, t, _ = qkv.shape
    q, k, v = qkv.float().reshape(b, t, 3, H, D).unbind(2)

    def rope(x):
        rot = torch.cat([-x[..., D // 2:], x[..., :D // 2]], dim=-1)
        return x * cos[None, :, None, :] + rot * sin[None, :, None, :]

    s = torch.einsum("bqhd,bkhd->bhqk", rope(q), rope(k)) * SCALE
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return o.reshape(b, t, H * D)


def main() -> None:
    args = parse(__doc__, NAMES)
    device = torch.device(args.device)
    name = card(device)
    qkv, cos, sin = inputs(device)
    ref = reference(qkv, cos, sin)
    for variant in args.variants:
        base = variant.startswith("kvsplit")

        def call(v=variant, b=base):
            return flash_variant(qkv, cos, sin, heads=H, scale=SCALE,
                                 variant="base" if b else v,
                                 kv_split=int(v[len("kvsplit"):]) if b else 1)

        out = call()
        line = {"kernel": "flash_variant", "variant": variant, "card": name,
                "shape": {"B": B, "T": T, "H": H, "D": D, "scale": SCALE}}
        timed = device.type == "cuda"
        line["ms"] = device_ms(call, only=("rope_qk", "flash_variant")) if timed else None
        line["chain_ms"] = chain_ms(call) if timed else None
        line.update(errors(out, ref))
        set_bound(line, nbytes(qkv, cos, sin, out), 4 * B * H * T * T * D, "bf16")
        line["exp_floor_ms"] = exp_floor_ms(B * H * T * T)
        emit(line)


if __name__ == "__main__":
    main()
