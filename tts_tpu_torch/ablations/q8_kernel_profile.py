"""Kernel 17's ablation entry point: the W8A8 MLP block's variants on the card.

    python -m tts_tpu_torch.ablations.q8_kernel_profile [variant ...] [--device cpu]

Counterpart of benchmarks/q8_kernel_profile.py, at its shape (B 2, T 1408,
D 1024, F 2048, one shared mod vector) and with its twelve variants
(default all; ops/dit_mlp_q8_variants.py says what each changes), and its
inputs: x ~ N(0, 1) bf16, mods ~ N(0, 0.01) bf16, int8 weights uniform in
[-127, 127] (K-major, as kernel 6 reads them), scales 1e-3, zero biases;
drawn from a torch.Generator on the device.

Each variant prints one JSON line: "ms", the device time a call of its
int8 kernels (the row pass or dots_only's conversion, and the two GEMMs; a
torch.profiler trace of 10 calls); "chain_ms", a call over a chain of 10
(CUDA events); "marginal_ms", full's ms less this one's (what the piece it
removes or swaps costs), where full ran first; "maxabs" and "mad" against
the fp32 reference chain (the float MLP block on the dequantized weights;
dots_only, integer work that computes another function, against its twin
rounded to bf16, which it matches bit for bit); the
bound (the int8 products, or the bytes). With --device cpu the twin runs
and nothing is timed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.dit_mlp_q8_variants import (VARIANTS, mlp_block_q8_variant,
                                       mlp_block_q8_variant_plain)
from ..ops.quant_matmul import to_kmajor
from . import card, chain_ms, device_ms, emit, errors, nbytes, parse, set_bound

B, T, D, FF = 2, 1408, 1024, 2048
SEED = 0


def inputs(device: torch.device) -> tuple:
    """The script's x, mods, w1, s1, b1, w2, s2, b2 (weights K-major)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((B, T, D), generator=gen, device=device).to(torch.bfloat16)
    mods = (torch.randn((1, 3, D), generator=gen, device=device) * 0.1).to(torch.bfloat16)
    w1, w2 = (torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)
              for shape in ((D, FF), (FF, D)))
    s1 = torch.full((FF,), 1e-3, device=device)
    s2 = torch.full((D,), 1e-3, device=device)
    return (x, mods, to_kmajor(w1), s1, torch.zeros_like(s1), to_kmajor(w2), s2,
            torch.zeros_like(s2))


def reference(x, mods, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """The fp32 reference chain: x + gate * ff2(gelu(ff1(LN(x) (1 + scale)
    + shift))) on the dequantized weights, no int8 activations."""
    shift, scale, gate = mods.float()[0]
    n = F.layer_norm(x.float(), (D,), eps=1e-6) * (1 + scale) + shift
    h = F.gelu(n @ (w1.float() * s1) + b1, approximate="tanh")
    return x.float() + gate * (h @ (w2.float() * s2) + b2)


def main() -> None:
    args = parse(__doc__, tuple(VARIANTS))
    device = torch.device(args.device)
    name = card(device)
    a = inputs(device)
    ref = reference(*a)
    timed = device.type == "cuda"
    # full first, for the marginals
    order = sorted(args.variants, key=lambda v: v != "full")
    full_ms = None
    for variant in order:
        def call(v=variant):
            return mlp_block_q8_variant(*a, variant=v)

        out = call()
        line = {"kernel": "mlp_block_q8_variant", "variant": variant, "card": name,
                "shape": {"B": B, "T": T, "D": D, "F": FF}}
        line["ms"] = device_ms(call, only="q8_") if timed else None
        line["chain_ms"] = chain_ms(call) if timed else None
        if variant == "full":
            full_ms = line["ms"]
        line["marginal_ms"] = None if full_ms is None or line["ms"] is None \
            else full_ms - line["ms"]
        if VARIANTS[variant] is None:
            line["ref"] = "bf16 twin"
            line.update(errors(out, mlp_block_q8_variant_plain(*a, variant=variant)))
        else:
            line["ref"] = "fp32 chain"
            line.update(errors(out, ref))
        set_bound(line, nbytes(*a, out), 4 * B * T * D * FF, "int8")
        emit(line)


if __name__ == "__main__":
    main()
