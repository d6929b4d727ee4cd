"""F5-TTS flow-matching DiT (counterpart of tts_tpu/models/f5.py).

Plain functions on tensors over a params dict with tts_tpu's keys and
layouts: fused `wqkv` whose q/k columns carry the d^-0.25 scale and the
half-split RoPE permutation, (K, C_in/groups, C_out) conv weights, and the
precomputed AdaLN tables `ada_table` / `norm_out_table`. Feature-last
(B, T, C) throughout. The hot ops go through the port's kernels
(ops/flash_attention, ops/grouped_conv, ops/dit_mlp, ops/quant_matmul),
which run their plain twins on CPU tensors.

Every kernel sits behind a gate that picks its route before any call:
tts_tpu's gates, with the CUDA kernels' own limits added on a CUDA device
(`attention_route`, `conv_fits`, `mlp_fits`, `q8_fits`). Past a gate the
block runs the plain chain, a copy of tts_tpu's XLA path. Attention takes
kernel 1 (flat qkv, RoPE in its prologue) where the head geometry allows
it, kernel 4 (`_rope_qkv_flat` + the single pass) at the other head dims
that are multiples of 64, kernel 5 (the online softmax) past T = 4096, and
the plain chain otherwise; on the card, fp32 at a flat geometry takes
kernel 4 (kernel 1 is bf16 only), which computes the same contract after
the flat RoPE. On the CPU the routes are tts_tpu's, through the twins;
the tests pin the card's routes by passing the device to the gates.

With int8 DiT weights (F5Pipeline's quantize=8 / "w8a8") a block takes
tts_tpu's W8A8 route, under tts_tpu's gates: kernel 7 (LN + modulate + qkv),
attention as above, kernel 8 (out-proj + gated residual), then kernel 6
(the MLP). The gates add the CUDA kernels' own weight-shape limits
(`q8_fits`), as tts_tpu's encode its VMEM limits; F5TTS_v1_Base is within
them. int4 weights take the plain chain with a quantized `dense`.

Many requests (tts_tpu's step-vector mode): `dit_forward` takes B requests
as a CFG batch of 2B rows with a (2B,) kv_len, and a (B,) step vector on
the device where each request sits at its own NFE step; the per-row AdaLN
vectors keep kernels 7 and 8 (one shared vector) off and go into kernels 3
and 6 as (2B, 3, D) mods. `dit_forward_cached` is tts_tpu's FORA layer
cache (attention and FF outputs kept across steps).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.norm import layer_norm
from ..nn.rope import rope_table_interleaved
from ..ops import dit_mlp as _k3
from ..ops import flash_attention as _k1
from ..ops import grouped_conv as _k2
from ..ops.conv import conv1d
from ..ops.dit_mlp import mlp_block_fused, mlp_block_fused_q8
from ..ops.flash_attention import flash_attention, flash_attention_flat
from ..ops.grouped_conv import _grouped_conv_mm, conv_pos_embed_fused
from ..ops.quant_matmul import ln_qkv_q8, out_proj_residual_q8, q8_fits
from ..quant.weight_only import QTensor, dense
from ._params import ParamTree

__all__ = [
    "F5Config",
    "F5Model",
    "f5_time_schedule",
    "f5_time_embed_table",
    "f5_rope_tables",
    "attach_mod_tables",
    "attention_route",
    "conv_fits",
    "mlp_fits",
    "hs_perm",
    "text_embedding",
    "input_embedding",
    "dit_forward",
    "dit_forward_cached",
    "init_params",
]


@dataclass(frozen=True)
class F5Config:
    """Defaults = F5TTS_v1_Base, as tts_tpu's F5Config (without its
    `attn_kv_split`, a TPU scheduling knob)."""

    dim: int = 1024
    depth: int = 22
    heads: int = 16
    head_dim: int = 64
    ff_mult: int = 2
    text_dim: int = 512
    conv_layers: int = 4
    conv_mult: int = 2
    n_mels: int = 100
    vocab_size: int = 2545          # len(vocab.txt); +1 filler row in the table
    nfe_steps: int = 32
    cfg_strength: float = 2.0
    sway_coef: float = -1.0
    sample_rate: int = 24000
    n_fft: int = 1024
    hop: int = 256
    win_length: int = 1024
    max_signal_len: int = 4096
    freq_embed_dim: int = 256

    @property
    def inner_dim(self) -> int:
        return self.heads * self.head_dim


# --------------------------------------------------------------------------
# Host tables (numpy; bit-equal to tts_tpu's, which live in a JAX module)

def f5_time_schedule(nfe_steps: int, sway_coef: float) -> tuple[np.ndarray, np.ndarray]:
    """Sway-sampled t-span and per-step deltas: (t (nfe,), delta_t (nfe-1,))."""
    t = np.linspace(0.0, 1.0, nfe_steps, dtype=np.float64)
    ts = t + sway_coef * (np.cos(np.pi * 0.5 * t) - 1.0 + t)
    return ts.astype(np.float32), np.diff(ts).astype(np.float32)


def f5_time_embed_table(ts: np.ndarray, mlp_w1: np.ndarray, mlp_b1: np.ndarray,
                        mlp_w2: np.ndarray, mlp_b2: np.ndarray,
                        freq_embed_dim: int = 256) -> np.ndarray:
    """time_mlp outputs for every NFE step, (nfe, dim) float32; mlp weights
    in (in, out) layout."""
    half = freq_embed_dim // 2
    emb_factor = math.log(10000) / (half - 1)
    emb_factor = 1000.0 * np.exp(np.arange(half, dtype=np.float64) * -emb_factor)
    emb = ts.astype(np.float64)[:, None] * emb_factor[None, :]
    emb = np.concatenate([np.sin(emb), np.cos(emb)], axis=-1)       # (nfe, 256)
    h = emb @ mlp_w1 + mlp_b1
    h = h / (1.0 + np.exp(-h))                                      # silu
    return (h @ mlp_w2 + mlp_b2).astype(np.float32)


def hs_perm(head_dim: int) -> np.ndarray:
    """Permutation turning interleaved-pair RoPE into half-split form
    ([evens | odds] per head), applied to the q/k weight columns at load."""
    return np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])


def f5_rope_tables(max_len: int, head_dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Interleaved-pair RoPE tables re-laid-out for the half-split perm."""
    cos, sin = rope_table_interleaved(max_len, head_dim)
    p = hs_perm(head_dim)
    return cos[:, p], sin[:, p]


def _text_freqs_cis(text_dim: int, max_pos: int = 4096) -> np.ndarray:
    """Sinus position table cat(cos, sin) of the text embedding."""
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, text_dim, 2, dtype=np.float64) / text_dim))
    freqs = np.outer(np.arange(max_pos, dtype=np.float64), inv_freq)
    return np.concatenate([np.cos(freqs), np.sin(freqs)], axis=-1).astype(np.float32)


def attach_mod_tables(params: dict, cfg: F5Config) -> dict:
    """Precompute every AdaLN modulation vector: silu(time_table) @ W_ada
    per block -> ada_table (nfe, depth, 6*dim), and the final norm's ->
    norm_out_table (nfe, 2*dim). Computed in fp32, stored in the weights'
    dtype."""
    silu_t = F.silu(params["time_table"].float())
    dt = params["proj_out"]["w"].dtype
    ada = torch.stack([silu_t @ b["ada"]["w"].float() + b["ada"]["b"].float()
                       for b in params["blocks"]], dim=1)
    nout = silu_t @ params["norm_out"]["w"].float() + params["norm_out"]["b"].float()
    params["ada_table"] = ada.to(dt)
    params["norm_out_table"] = nout.to(dt)
    return params


# --------------------------------------------------------------------------
# Text embedding

def _grn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Global response norm over the (whole, padded) sequence axis."""
    gx = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))          # (B, 1, D)
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    return gamma * (x * nx) + beta + x


def _convnext_v2_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    """dwconv(7) -> LN -> pw1 -> GELU (exact) -> GRN -> pw2, residual."""
    r = x
    x = conv1d(x, p["dwconv"]["w"], p["dwconv"]["b"], padding=3, groups=x.shape[-1])
    x = layer_norm(x, p["norm"]["w"], p["norm"]["b"], eps=1e-6)
    x = torch.matmul(x, p["pw1"]["w"]) + p["pw1"]["b"]
    x = F.gelu(x)
    x = _grn(x, p["grn"]["gamma"], p["grn"]["beta"])
    x = torch.matmul(x, p["pw2"]["w"]) + p["pw2"]["b"]
    return r + x


def text_embedding(params: dict, text_ids: torch.Tensor, seq_len: int,
                   cfg: F5Config) -> tuple[torch.Tensor, torch.Tensor]:
    """(1, T_text) raw char ids (-1 pad BEFORE the +1 shift applied here, so
    0 is the filler) -> (text, text_drop), each (1, seq_len, text_dim). The
    drop row is the filler embedding through the same conv stack; both rows
    are masked at filler positions before and after every block."""
    p = params["text_embed"]
    ids = F.pad(text_ids.long() + 1, (0, seq_len - text_ids.shape[1]))
    mask = (ids == 0)[..., None]                                    # (1, T, 1)
    emb = p["embed"][ids]                                           # (1, T, D)
    drop = p["embed"][0].expand_as(emb)
    pos = params["text_freqs_cis"][:seq_len][None]
    emb = torch.where(mask, 0.0, emb + pos)
    drop = torch.where(mask, 0.0, drop + pos)
    # cond and drop rows ride one batch-2 pass through the conv stack
    z = torch.cat([emb, drop], dim=0)
    mask2 = torch.cat([mask, mask], dim=0)
    for blk in p["blocks"]:
        z = torch.where(mask2, 0.0, _convnext_v2_block(z, blk))
    nb = emb.shape[0]
    return z[:nb], z[nb:]


# --------------------------------------------------------------------------
# Input embedding + DiT blocks

def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def conv_fits(dtype, cin_pg: int, k: int, t: int, device=None) -> bool:
    """Kernel 2's gate: tts_tpu's T % 8 == 0 and, on a CUDA device, the
    kernel's own limits (`grouped_conv.kernel_fits`: bf16, 64 channels a
    group, an odd width <= 33, T % 64 == 0). tts_tpu's 7 MB column gate
    was a VMEM limit the CUDA kernel does not have."""
    return t % 8 == 0 and (not _on_card(device) or _k2.kernel_fits(dtype, cin_pg, k, t))


def mlp_fits(dtype, rows: int, d: int, f: int, t: int, device=None) -> bool:
    """Kernel 3's gate: tts_tpu's (T % 8 == 0 and both weights within 12 MB,
    which keeps fp32 at F5TTS_v1_Base width on the plain chain) and, on a
    CUDA device, the kernel's own limits (`dit_mlp.kernel_fits`: bf16, the
    rows, D and F multiples of 64)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    ok = t % 8 == 0 and 2 * d * f * itemsize <= 12 << 20
    return ok and (not _on_card(device) or _k3.kernel_fits(dtype, rows, d, f))


def attention_route(dtype, head_dim: int, heads: int, t: int, device=None) -> str:
    """The DiT attention's route, for `_dit_attention` and the W8A8 block:
    "flat" (kernel 1), "onepass" (`_rope_qkv_flat` + kernel 4), "online"
    (kernel 5) or "plain" (the XLA chain's copy).

    tts_tpu's gates: T % 128 == 0 and head_dim % 64 == 0 for any kernel;
    then kernel 5 past T = 4096, kernel 1 where 128 % head_dim == 0 and
    heads % (128 // head_dim) == 0, kernel 4 otherwise. On a CUDA device the
    kernels' own limits come on top: kernel 1 takes bf16 only, so other
    dtypes at a flat geometry take kernel 4 (the same contract after the
    flat RoPE); kernels 4 and 5 take bf16 or fp32 with head_dim <= 256, and
    anything else takes the plain chain."""
    if t % 128 or head_dim % 64:
        return "plain"
    if t > 4096:
        route = "online"
    elif 128 % head_dim == 0 and heads % (128 // head_dim) == 0:
        route = "flat"
    else:
        route = "onepass"
    if _on_card(device):
        if route == "flat" and not _k1.flat_kernel_fits(dtype, head_dim, t):
            route = "onepass"
        if route != "flat" and not _k1.mha_kernel_fits(dtype, head_dim, t):
            route = "plain"
    return route


def input_embedding(params: dict, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """cat(x, cond) -> proj -> conv position embedding with residual
    (kernel 2, ops/grouped_conv.py, where `conv_fits`; else tts_tpu's
    im2col chain)."""
    p = params["input_embed"]
    h = torch.cat([x, cond], dim=-1)
    h = torch.matmul(h, p["proj"]["w"]) + p["proj"]["b"]
    k, cin_pg, _ = p["conv1"]["w"].shape
    if conv_fits(h.dtype, cin_pg, k, h.shape[1], h.device):
        return conv_pos_embed_fused(h, p["conv1"]["w"], p["conv1"]["b"],
                                    p["conv2"]["w"], p["conv2"]["b"])
    c = _grouped_conv_mm(h, p["conv1"]["w"], p["conv1"]["b"])
    c = c * torch.tanh(torch.logaddexp(c, torch.zeros_like(c)))          # mish
    c = _grouped_conv_mm(c, p["conv2"]["w"], p["conv2"]["b"])
    c = c * torch.tanh(torch.logaddexp(c, torch.zeros_like(c)))
    return c + h


def _rope_qkv_flat(qkv: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                   heads: int, head_dim: int):
    """Half-split RoPE over the (B, T, 3*H*D) qkv tensor: q and k as
    x * cos + rot_half(x) * sin in fp32, rounded to qkv's dtype; v passes
    through. Returns q, k, v in (B, H, T, D)."""
    b, t, _ = qkv.shape
    x = qkv.reshape(b, t, 3, heads, head_dim)
    cos = rope_cos[:t].float()[None, :, None, :]
    sin = rope_sin[:t].float()[None, :, None, :]
    half = head_dim // 2

    def rope(u):
        rot = torch.cat([-u[..., half:], u[..., :half]], dim=-1)
        return (u.float() * cos + rot.float() * sin).to(qkv.dtype)

    q, k, v = rope(x[:, :, 0]), rope(x[:, :, 1]), x[:, :, 2]
    return (q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous())


def _plain_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len) -> torch.Tensor:
    """Plain packed attention, tts_tpu's XLA chain (`_dit_attention`'s
    fallback): fp32 scores, keys >= kv_len at -1e30, softmax, the weights
    rounded to the activation dtype, then P.V. Returns (B, T, H*D)."""
    b, h, t, d = q.shape
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if kv_len is not None:
        kv = kv_len if isinstance(kv_len, torch.Tensor) else torch.tensor(kv_len)
        kv = kv.to(device=q.device, dtype=torch.int64).reshape(-1, 1, 1, 1)
        mask = torch.arange(t, device=q.device)[None, None, None, :] < kv
        scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", w.float(), v.float()).to(q.dtype)
    return o.transpose(1, 2).reshape(b, t, h * d)


def _flash_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len) -> torch.Tensor:
    """Kernel 4 with the packed (B, T, H*D) output, two heads a program
    where the count is even, as tts_tpu calls it. tts_tpu sizes its q block
    to VMEM; here the q block only selects the route (the CUDA kernel tiles
    itself), and T % 128 == 0 on every path that calls this."""
    heads, t = q.shape[1], q.shape[2]
    hb = 2 if heads % 2 == 0 else 1
    return flash_attention(q, k, v, kv_len, block_q=128, block_kv=t, head_block=hb,
                           packed_out=True)


def _attend(qkv: torch.Tensor, rope_cos, rope_sin, heads: int, head_dim: int, kv_len,
            route: str) -> torch.Tensor:
    """Attention over the flat qkv tensor on `route` (`attention_route`):
    (B, T, 3*H*D) -> (B, T, H*D)."""
    if route == "flat":
        return flash_attention_flat(qkv, rope_cos, rope_sin, kv_len, heads=heads)
    q, k, v = _rope_qkv_flat(qkv, rope_cos, rope_sin, heads, head_dim)
    if route == "onepass":
        return _flash_packed(q, k, v, kv_len)
    if route == "online":
        # tts_tpu calls it with blocks of 256 / 512 and so raises where its
        # gate admits T % 512 != 0 (as 4224); the largest kv block of 512,
        # 256 and 128 that divides T keeps its call where it works
        b, _, t, _ = q.shape
        bkv = next(n for n in (512, 256, 128) if t % n == 0)
        out = flash_attention(q, k, v, kv_len, block_q=min(256, bkv), block_kv=bkv)
        return out.transpose(1, 2).reshape(b, t, heads * head_dim)
    return _plain_packed(q, k, v, kv_len)


def _dit_attention(p: dict, x: torch.Tensor, rope_cos: torch.Tensor,
                   rope_sin: torch.Tensor, heads: int, head_dim: int,
                   kv_len=None) -> torch.Tensor:
    """Full (non-causal) self-attention with RoPE on q and k, on the route
    `attention_route` picks; the d^-0.5 scale is folded into wqkv."""
    qkv = dense(x, p["wqkv"]) + p["bqkv"]
    route = attention_route(qkv.dtype, head_dim, heads, qkv.shape[1], qkv.device)
    out = _attend(qkv, rope_cos, rope_sin, heads, head_dim, kv_len, route)
    return dense(out, p["wo"]) + p["bo"]


def _dit_block(p: dict, x: torch.Tensor, mod: torch.Tensor, rope_cos, rope_sin,
               cfg: F5Config, kv_len=None) -> torch.Tensor:
    """AdaLN-zero DiT block; mod (Bm, 1, 6*dim) from the AdaLN table."""
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
        torch.chunk(mod, 6, dim=-1)
    b, t, d = x.shape
    a, f1, f2 = p["attn"], p["ff1"], p["ff2"]
    # the W8A8 attention kernels take one shared mod vector
    if (mod.shape[0] == 1 and t % 128 == 0 and t <= 4096 and cfg.head_dim % 64 == 0
            and isinstance(a["wqkv"], QTensor) and isinstance(a["wo"], QTensor)
            and q8_fits(*a["wqkv"].shape) and q8_fits(*a["wo"].shape)):
        mods_a = torch.cat([shift_msa[0], scale_msa[0]], dim=0)        # (2, D)
        qkv = ln_qkv_q8(x, mods_a, a["wqkv"].q, a["wqkv"].scale, a["bqkv"])  # kernel 7
        route = attention_route(qkv.dtype, cfg.head_dim, cfg.heads, t, qkv.device)
        o = _attend(qkv, rope_cos, rope_sin, cfg.heads, cfg.head_dim, kv_len, route)
        x = out_proj_residual_q8(o, a["wo"].q, a["wo"].scale, a["bo"],
                                 gate_msa.reshape(-1), x)               # kernel 8
    else:
        norm = layer_norm(x, eps=1e-6) * (1 + scale_msa) + shift_msa
        x = x + gate_msa * _dit_attention(a, norm, rope_cos, rope_sin, cfg.heads,
                                          cfg.head_dim, kv_len)
    mods = torch.cat([shift_mlp, scale_mlp, gate_mlp], dim=1)       # (Bm, 3, D)
    if (t % 32 == 0 and isinstance(f1["w"], QTensor) and isinstance(f2["w"], QTensor)
            and q8_fits(*f1["w"].shape) and q8_fits(*f2["w"].shape)):
        return mlp_block_fused_q8(x, mods, f1["w"].q, f1["w"].scale, f1["b"],
                                  f2["w"].q, f2["w"].scale, f2["b"])    # kernel 6
    if (isinstance(f1["w"], torch.Tensor) and isinstance(f2["w"], torch.Tensor)
            and mlp_fits(x.dtype, b * t, d, f1["w"].shape[1], t, x.device)):
        return mlp_block_fused(x, mods, f1["w"], f1["b"], f2["w"], f2["b"])  # kernel 3
    norm = layer_norm(x, eps=1e-6) * (1 + scale_mlp) + shift_mlp
    h = F.gelu(dense(norm, f1["w"]) + f1["b"], approximate="tanh")
    return x + gate_mlp * (dense(h, f2["w"]) + f2["b"])


def _pair(v: torch.Tensor) -> torch.Tensor:
    """(·,) or (B, ·) modulation rows -> (1, 1, ·) or (2B, 1, ·): per-row
    vectors double for the CFG pair, cond rows 0..B-1 then uncond rows
    B..2B-1 (tts_tpu's `_pair`; the rows of cat([noise, noise]))."""
    v = v.reshape(-1, 1, v.shape[-1])
    return torch.cat([v, v], dim=0) if v.shape[0] > 1 else v


def _step_mods(params: dict, step_idx) -> tuple[list, torch.Tensor]:
    """The AdaLN vectors of NFE step `step_idx` from the precomputed
    tables: ([each block's (Bm, 1, 6*dim)], the final norm's (Bm, 1,
    2*dim)). An int step gives Bm = 1. A (B,) integer tensor on the device
    (each row at its own step) is gathered on the device, never read back,
    and paired for the CFG batch (Bm = 2B; 1 where B = 1)."""
    if not isinstance(step_idx, torch.Tensor):
        mods = [params["ada_table"][step_idx, li].reshape(1, 1, -1)
                for li in range(len(params["blocks"]))]
        return mods, params["norm_out_table"][step_idx].reshape(1, 1, -1)
    idx = step_idx.reshape(-1).long()
    ada = params["ada_table"].index_select(0, idx)                 # (B, depth, 6*dim)
    mods = [_pair(ada[:, li]) for li in range(len(params["blocks"]))]
    return mods, _pair(params["norm_out_table"].index_select(0, idx))


def _dit_out(params: dict, x: torch.Tensor, mod: torch.Tensor,
             noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Final modulated LayerNorm and output projection of the CFG batch:
    (pred_cond, pred_uncond) in noise's dtype."""
    scale, shift = torch.chunk(mod, 2, dim=-1)
    x = layer_norm(x, eps=1e-6) * (1 + scale) + shift
    # the output projection accumulates and returns fp32, as tts_tpu's
    # preferred_element_type=float32
    x = torch.matmul(x.float(), params["proj_out"]["w"].float()) + params["proj_out"]["b"]
    nb = noise.shape[0]
    return x[:nb].to(noise.dtype), x[nb:].to(noise.dtype)


def dit_forward(params: dict, noise: torch.Tensor, cond: torch.Tensor,
                cond_drop: torch.Tensor, rope_cos: torch.Tensor,
                rope_sin: torch.Tensor, cfg: F5Config, kv_len=None,
                step_idx: int | torch.Tensor = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One CFG-paired DiT pass at NFE step `step_idx`. noise (B, T, n_mels);
    cond/cond_drop (B, T, n_mels + text_dim). Returns (pred_cond,
    pred_uncond), each (B, T, n_mels) in noise's dtype. kv_len masks keys
    of the batch-2B pair: an int or a (2B,) tensor (each row's length, cond
    half then uncond half).

    step_idx: an int, or a (B,) integer tensor on the device with each
    request at its own step (continuous serving). Per-row AdaLN vectors
    then ride as (2B, 1, ·): kernels 7 and 8, which take one shared vector,
    give way to the plain attention projections, and kernels 3 and 6 take
    the (2B, 3, D) mods (`_dit_block`)."""
    x = input_embedding(params, torch.cat([noise, noise], dim=0),
                        torch.cat([cond, cond_drop], dim=0))         # (2B, T, dim)
    mods, out_mod = _step_mods(params, step_idx)
    for p, mod in zip(params["blocks"], mods):
        x = _dit_block(p, x, mod, rope_cos, rope_sin, cfg, kv_len)
    return _dit_out(params, x, out_mod, noise)


def _dit_block_cached(p: dict, x: torch.Tensor, mod: torch.Tensor, rope_cos, rope_sin,
                      cfg: F5Config, kv_len, cached_attn, cached_ff, use_cache: bool):
    """`_dit_block` with the attention and FF sub-module outputs exposed
    for cross-step caching (tts_tpu's `_dit_block_cached`). With use_cache
    the sub-modules are skipped and the previous full step's outputs are
    re-modulated by this step's AdaLN gates (the FORA-style layer cache,
    arXiv:2509.08696). The outputs must stay apart, so attention takes
    `_dit_attention` (kernel 1 where `attention_route` says "flat") and the
    MLP the plain chain: kernel 3 folds its output into the gated residual.
    Returns (x, attn_out, ff_out)."""
    s1, c1, g1, s2, c2, g2 = torch.chunk(mod, 6, dim=-1)
    if use_cache:
        attn_out, ff_out = cached_attn, cached_ff
    else:
        norm = layer_norm(x, eps=1e-6) * (1 + c1) + s1
        attn_out = _dit_attention(p["attn"], norm, rope_cos, rope_sin, cfg.heads,
                                  cfg.head_dim, kv_len)
    x = x + g1 * attn_out
    if not use_cache:
        norm = layer_norm(x, eps=1e-6) * (1 + c2) + s2
        h = F.gelu(dense(norm, p["ff1"]["w"]) + p["ff1"]["b"], approximate="tanh")
        ff_out = dense(h, p["ff2"]["w"]) + p["ff2"]["b"]
    return x + g2 * ff_out, attn_out, ff_out


def dit_forward_cached(params: dict, noise: torch.Tensor, cond: torch.Tensor,
                       cond_drop: torch.Tensor, rope_cos: torch.Tensor,
                       rope_sin: torch.Tensor, cfg: F5Config, kv_len, cache,
                       use_cache: bool, step_idx: int = 0):
    """`dit_forward` carrying each block's (attention, FF) outputs across
    NFE steps (tts_tpu's `dit_forward_cached`). cache: ((depth, 2B, T, dim)
    attention, (depth, 2B, T, dim) FF) in the compute dtype, read only
    where use_cache (a Python bool; None is taken on a full step). Returns
    (pred, pred_uncond, cache): the new cache on a full step, the same
    tensors on a cached one."""
    x = input_embedding(params, torch.cat([noise, noise], dim=0),
                        torch.cat([cond, cond_drop], dim=0))
    mods, out_mod = _step_mods(params, step_idx)
    new_attn, new_ff = [], []
    for i, (p, mod) in enumerate(zip(params["blocks"], mods)):
        x, a, f = _dit_block_cached(p, x, mod, rope_cos, rope_sin, cfg, kv_len,
                                    cache[0][i] if use_cache else None,
                                    cache[1][i] if use_cache else None, use_cache)
        new_attn.append(a)
        new_ff.append(f)
    if not use_cache:
        cache = (torch.stack(new_attn), torch.stack(new_ff))
    pred, pred1 = _dit_out(params, x, out_mod, noise)
    return pred, pred1, cache


# --------------------------------------------------------------------------
# Random init and the module

def init_params(cfg: F5Config, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters on `generator.device`, with the same structure,
    scales and load-time folds as tts_tpu's init_params: q/k weights scaled
    by d^-0.25 with half-split columns, the time-MLP table from numpy's
    default_rng(0), fp32 delta_t, and the AdaLN tables."""
    dev = generator.device

    def randn(*shape, scale=0.02):
        w = torch.randn(shape, generator=generator, device=dev) * scale
        return w.to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def lin(cin, cout):
        return {"w": randn(cin, cout), "b": zeros(cout)}

    def conv(k, cin, cout, groups=1):
        return {"w": randn(k, cin // groups, cout), "b": zeros(cout)}

    def ln(c):
        return {"w": torch.ones(c, dtype=dtype, device=dev), "b": zeros(c)}

    def table(a):
        return torch.as_tensor(a, device=dev).to(dtype)

    td, d, inner = cfg.text_dim, cfg.dim, cfg.inner_dim
    scale = cfg.head_dim ** -0.25
    col_perm = torch.as_tensor(
        np.arange(inner).reshape(cfg.heads, cfg.head_dim)[:, hs_perm(cfg.head_dim)]
        .reshape(-1), device=dev)

    def attn_p():
        q, k, v, o = lin(d, inner), lin(d, inner), lin(d, inner), lin(inner, d)
        wqkv = torch.cat([q["w"][:, col_perm] * scale, k["w"][:, col_perm] * scale,
                          v["w"]], dim=-1)
        bqkv = torch.cat([q["b"][col_perm] * scale, k["b"][col_perm] * scale, v["b"]])
        return {"wqkv": wqkv, "bqkv": bqkv, "wo": o["w"], "bo": o["b"]}

    params = {
        "text_embed": {
            "embed": randn(cfg.vocab_size + 1, td),
            "blocks": [
                {
                    "dwconv": conv(7, td, td, groups=td),
                    "norm": ln(td),
                    "pw1": lin(td, td * cfg.conv_mult),
                    "grn": {"gamma": zeros(1, 1, td * cfg.conv_mult),
                            "beta": zeros(1, 1, td * cfg.conv_mult)},
                    "pw2": lin(td * cfg.conv_mult, td),
                }
                for _ in range(cfg.conv_layers)
            ],
        },
        "text_freqs_cis": table(_text_freqs_cis(td, cfg.max_signal_len)),
        "input_embed": {
            "proj": lin(cfg.n_mels * 2 + td, d),
            "conv1": conv(31, d, d, groups=16),
            "conv2": conv(31, d, d, groups=16),
        },
        "blocks": [
            {"ada": lin(d, d * 6), "attn": attn_p(),
             "ff1": lin(d, d * cfg.ff_mult), "ff2": lin(d * cfg.ff_mult, d)}
            for _ in range(cfg.depth)
        ],
        "norm_out": lin(d, d * 2),
        "proj_out": lin(d, cfg.n_mels),
    }
    rope_cos, rope_sin = f5_rope_tables(cfg.max_signal_len, cfg.head_dim)
    params["rope_cos"], params["rope_sin"] = table(rope_cos), table(rope_sin)
    ts, dts = f5_time_schedule(cfg.nfe_steps, cfg.sway_coef)
    rng = np.random.default_rng(0)
    mlp_w1 = rng.standard_normal((cfg.freq_embed_dim, d)).astype(np.float32) * 0.02
    mlp_w2 = rng.standard_normal((d, d)).astype(np.float32) * 0.02
    params["time_table"] = table(f5_time_embed_table(
        ts, mlp_w1, np.zeros(d, np.float32), mlp_w2, np.zeros(d, np.float32),
        cfg.freq_embed_dim))
    params["delta_t"] = torch.as_tensor(dts, device=dev)   # the Euler carry stays fp32
    return attach_mod_tables(params, cfg)


class F5Model(ParamTree):
    """F5 parameters as a module: `F5Model(cfg, params).to(device, dtype)`.
    The Euler step sizes `delta_t` stay fp32 whatever dtype the weights take,
    as in tts_tpu."""

    keep_fp32 = ("delta_t",)

    def __init__(self, cfg: F5Config, params: dict):
        super().__init__(params)
        self.cfg = cfg
