"""IndexTTS-1.5: conformer reference encoder, perceiver resampler, ECAPA
speaker encoder and the GPT-2 AR acoustic model (counterpart of
tts_tpu/models/indextts.py).

Plain functions over params dicts with tts_tpu's keys and load-time folds:
  * conformer_encoder: Conv2d subsampling (x4, F.conv2d) and rel-position
    conformer blocks (ESPnet legacy rel_shift, pos_bias_u/v, the d^-0.25
    scales folded into the weights) with a GLU / depthwise / LN / swish
    conv module;
  * perceiver_resample: 2 cross-attention layers from learned latents
    over cat(latents, context), exact erf GELU;
  * ecapa_speaker_encoder: ECAPA-TDNN, in both checkpoint families'
    variants (IndexTTS: zero padding, BatchNorm, clipped pooling std; the
    Qwen3-TTS speaker encoder: reflect padding, no BatchNorm, unclipped);
  * gpt_step: GPT-2 over S new positions (LN with bias, fused qkv with
    bias, MHA, tanh GELU) with the repetition-penalty vector on the logits.

`gpt_step` takes tts_tpu's decode routes (`fused`), under tts_tpu's gates
plus the CUDA kernels' own limits, on every device (the CPU runs each
kernel's twin):
  "step"  kernel 12 (LN + qkv head + attention, ops/decode_step.py): B = 1,
          no kv_valid, head_dim 64 or 128, 128 | heads * head_dim, a
          batch-1 cache (the guard tts_tpu's IndexTTS check lacks) and the
          kernel's shared memory; else True;
  True    kernel 11 (the qkv head, ops/decode_qkv.py): tts_tpu's packing
          gate, int8 or float wqkv, head_dim 64 or 128, B <= 8; else plain;
  False   plain ops.
A prefill (S > 1) always takes the plain ops. The KV cache is written in
place (kv/cache.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..kv.cache import KVCache
from ..nn.attention import attention_mask, combine_kv_valid, gqa_attention
from ..nn.norm import layer_norm
from ..ops.conv import conv1d
from ..ops.decode_qkv import fusable_layout, fusable_weight, fused_qkv_rope, qkv_fits
from ..ops.decode_step import fused_qkv_attn, step_fits
from ..quant.weight_only import dense

__all__ = ["IndexTTSConfig", "conformer_encoder", "perceiver_resample",
           "ecapa_speaker_encoder", "gpt_embed_text", "gpt_embed_mel", "gpt_route",
           "gpt_step", "gpt_final_norm", "init_gpt_params", "init_conformer_params",
           "init_perceiver_params", "init_ecapa_params"]


@dataclass(frozen=True)
class IndexTTSConfig:
    """Defaults = IndexTTS-1.5, as tts_tpu's."""

    # conformer conditioning encoder
    enc_dim: int = 512
    enc_heads: int = 8
    enc_ff_dim: int = 2048
    enc_layers: int = 6
    enc_conv_kernel: int = 15
    # perceiver
    num_latents: int = 32
    perceiver_heads: int = 8
    perceiver_dim_head: int = 64
    perceiver_ff_mult: int = 4
    # ECAPA speaker encoder
    n_mels: int = 100
    ecapa_channels: int = 512
    ecapa_attn_channels: int = 128
    res2net_scale: int = 8
    se_channels: int = 128
    speaker_embed_dim: int = 512
    # GPT-2 acoustic model
    gpt_dim: int = 1280
    gpt_heads: int = 20
    gpt_layers: int = 24
    num_mel_codes: int = 8194
    num_text_tokens: int = 12001
    max_text_tokens: int = 600
    max_mel_tokens: int = 800
    max_seq_len: int = 1536
    stop_token: int = 8193
    start_mel_token: int = 8192

    @property
    def gpt_head_dim(self) -> int:
        return self.gpt_dim // self.gpt_heads


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with fp32 accumulation and an fp32 result (tts_tpu's
    preferred_element_type=float32): bf16 products are exact in fp32."""
    return torch.einsum(eq, a.float(), b.float())


# --------------------------------------------------------------------------
# Conformer conditioning encoder

def _rel_shift(bd: torch.Tensor) -> torch.Tensor:
    """ESPnet legacy rel_shift: prepend a zero column on the position axis,
    fold, drop the first row."""
    h, t, p = bd.shape
    padded = F.pad(bd, (1, 0)).reshape(h, p + 1, t)
    return padded[:, 1:].reshape(h, t, p)[:, :, :t]


def _rel_pos_attention(p: dict, x: torch.Tensor, pos_emb: torch.Tensor) -> torch.Tensor:
    """Relative-position MHA with pos_bias_u/v over x (1, T, D); weights
    per head (H, D, d)."""
    q = torch.einsum("td,hde->hte", x[0], p["wq"]) + p["bq"]
    k = torch.einsum("td,hde->hte", x[0], p["wk"]) + p["bk"]
    v = torch.einsum("td,hde->hte", x[0], p["wv"]) + p["bv"]
    pos = torch.einsum("td,hde->hte", pos_emb, p["wpos"])
    ac = _f32_einsum("hte,hse->hts", q + p["bias_u"], k)
    bd = _f32_einsum("hte,hpe->htp", q + p["bias_v"], pos)
    probs = torch.softmax(ac + _rel_shift(bd), dim=-1).to(x.dtype)
    out = torch.einsum("hts,hse->hte", probs, v)
    return (torch.einsum("hte,hed->td", out, p["wo"]) + p["bo"])[None]


def _conformer_conv(p: dict, x: torch.Tensor, kernel: int) -> torch.Tensor:
    """pointwise(2C) -> GLU -> depthwise(k) -> LN -> swish -> pointwise."""
    h = torch.matmul(x, p["pw1"]["w"]) + p["pw1"]["b"]
    a, b = torch.chunk(h, 2, dim=-1)
    h = a * torch.sigmoid(b)
    h = conv1d(h, p["dw"]["w"], p["dw"]["b"], padding=(kernel - 1) // 2, groups=h.shape[-1])
    h = layer_norm(h, p["norm"]["w"], p["norm"]["b"])
    h = h * torch.sigmoid(h)
    return torch.matmul(h, p["pw2"]["w"]) + p["pw2"]["b"]


def conformer_encoder(params: dict, mel: torch.Tensor, cfg: IndexTTSConfig) -> torch.Tensor:
    """mel (1, T, n_mels) -> (1, T', enc_dim), T' = ((T-1)//2 - 1)//2."""
    x = mel[:, None]                                      # (1, 1, T, F) NCHW
    for cp in params["sub_convs"]:
        x = F.conv2d(x.to(cp["w"].dtype), cp["w"], stride=2) + cp["b"][None, :, None, None]
        x = torch.relu(x)
    b, c, t, f = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b, t, c * f)
    x = torch.matmul(x, params["out"]["w"]) + params["out"]["b"]
    pos_emb = params["pos_enc"][:t]
    for p in params["layers"]:
        h = layer_norm(x, p["norm_mha"]["w"], p["norm_mha"]["b"])
        x = x + _rel_pos_attention(p["attn"], h, pos_emb)
        h = layer_norm(x, p["norm_conv"]["w"], p["norm_conv"]["b"])
        x = x + _conformer_conv(p["conv"], h, cfg.enc_conv_kernel)
        h = layer_norm(x, p["norm_ff"]["w"], p["norm_ff"]["b"])
        h = torch.matmul(h, p["ff1"]["w"]) + p["ff1"]["b"]
        h = h * torch.sigmoid(h)
        x = x + (torch.matmul(h, p["ff2"]["w"]) + p["ff2"]["b"])
        x = layer_norm(x, p["norm_final"]["w"], p["norm_final"]["b"])
    return layer_norm(x, params["after_norm"]["w"], params["after_norm"]["b"])


# --------------------------------------------------------------------------
# Perceiver resampler

def perceiver_resample(params: dict, x: torch.Tensor, cfg: IndexTTSConfig) -> torch.Tensor:
    """Context (1, T, enc_dim) -> (1, num_latents, gpt_dim)."""
    x = torch.matmul(x, params["proj_context"]["w"]) + params["proj_context"]["b"]
    latents = params["latents"][None]
    for p in params["layers"]:
        q = torch.einsum("td,hde->hte", latents[0], p["wq"])
        ctx = torch.cat([latents, x], dim=1)[0]
        k = torch.einsum("td,hde->hte", ctx, p["wk"])
        v = torch.einsum("td,hde->hte", ctx, p["wv"])
        probs = torch.softmax(_f32_einsum("hte,hse->hts", q, k), dim=-1).to(x.dtype)
        out = torch.einsum("hte,hed->td", torch.einsum("hts,hse->hte", probs, v), p["wo"])
        latents = latents + out[None]
        h = layer_norm(latents, p["ff_norm"]["w"], p["ff_norm"]["b"])
        h = F.gelu(torch.matmul(h, p["ff1"]["w"]) + p["ff1"]["b"])
        latents = latents + (torch.matmul(h, p["ff2"]["w"]) + p["ff2"]["b"])
    return layer_norm(latents, params["norm"]["w"], params["norm"]["b"])


# --------------------------------------------------------------------------
# ECAPA-TDNN speaker encoder

def _bn(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Eval-mode BatchNorm1d folded into (scale, shift) at load."""
    return x * p["scale"] + p["shift"]


def _tdnn(p: dict, x: torch.Tensor, dilation: int = 1, reflect_pad: bool = False):
    """Conv1d(k, dilation, same) -> ReLU [-> BN]; reflect padding for the
    Qwen3-TTS family, zeros for IndexTTS's."""
    k = p["conv"]["w"].shape[0]
    pad = (k - 1) * dilation // 2
    if reflect_pad and pad:
        x = F.pad(x.transpose(1, 2), (pad, pad), mode="reflect").transpose(1, 2)
        pad = 0
    x = torch.relu(conv1d(x, p["conv"]["w"], p["conv"]["b"], padding=pad, dilation=dilation))
    return _bn(x, p["bn"]) if "bn" in p else x


def _res2net(p: dict, x: torch.Tensor, scale: int, dilation: int, reflect_pad: bool = False):
    chunks = torch.chunk(x, scale, dim=-1)
    outs, y = [chunks[0]], None
    for i in range(1, scale):
        inp = chunks[i] if y is None else chunks[i] + y
        y = _tdnn(p["blocks"][i - 1], inp, dilation, reflect_pad)
        outs.append(y)
    return torch.cat(outs, dim=-1)


def _se_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    s = x.mean(dim=1, keepdim=True)
    s = torch.relu(torch.matmul(s, p["w1"]) + p["b1"])
    s = torch.sigmoid(torch.matmul(s, p["w2"]) + p["b2"])
    return x * s


def _stats(x: torch.Tensor, w, clip: float | None = 1e-6):
    """Weighted mean and std over time; x (1, T, C), w (1, T, 1) or a
    scalar. The variance is clipped below at `clip` (None: unclipped)."""
    mean = (w * x).sum(dim=1, keepdim=True)
    var = (w * (x - mean) ** 2).sum(dim=1, keepdim=True)
    return mean, torch.sqrt(var if clip is None else torch.clamp(var, min=clip))


def ecapa_speaker_encoder(params: dict, mel: torch.Tensor, cfg: IndexTTSConfig, *,
                          reflect_pad: bool = False,
                          std_clip: float | None = 1e-6) -> torch.Tensor:
    """mel (1, T, n_mels) -> speaker embedding (1, 1, speaker_embed_dim).
    The variant is carried by the params (no "bn" / "asp_bn" entries for
    the Qwen3-TTS family) and the reflect_pad / std_clip switches."""
    t = mel.shape[1]
    x = _tdnn(params["block0"], mel, dilation=1, reflect_pad=reflect_pad)
    feats = []
    for blk, dilation in zip(params["se_blocks"], (2, 3, 4)):
        res = x
        h = _tdnn(blk["tdnn1"], x, reflect_pad=reflect_pad)
        h = _res2net(blk["res2net"], h, cfg.res2net_scale, dilation, reflect_pad)
        h = _tdnn(blk["tdnn2"], h, reflect_pad=reflect_pad)
        x = _se_block(blk["se"], h) + res
        feats.append(x)
    x = _tdnn(params["mfa"], torch.cat(feats, dim=-1), reflect_pad=reflect_pad)
    mean, std = _stats(x, 1.0 / t, std_clip)
    ctx = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
    a = torch.tanh(_tdnn(params["asp_tdnn"], ctx, reflect_pad=reflect_pad))
    a = torch.softmax(torch.matmul(a, params["asp_conv"]["w"]) + params["asp_conv"]["b"],
                      dim=1)
    mean, std = _stats(x, a, std_clip)
    pooled = torch.cat([mean, std], dim=-1)
    if "asp_bn" in params:
        pooled = _bn(pooled, params["asp_bn"])
    return torch.matmul(pooled, params["fc"]["w"]) + params["fc"]["b"]


# --------------------------------------------------------------------------
# GPT-2 AR acoustic model

def gpt_embed_text(params: dict, text_ids: torch.Tensor) -> torch.Tensor:
    """ids (B, T) -> text embedding + learned position (B, T, D)."""
    return params["text_embed"][text_ids] + params["text_pos"][None, :text_ids.shape[1]]


def gpt_embed_mel(params: dict, mel_ids: torch.Tensor, gen_len: int) -> torch.Tensor:
    """mel-code ids (B, S) -> embedding + mel_pos[gen_len + arange(S)]."""
    s = mel_ids.shape[1]
    return params["mel_embed"][mel_ids] + params["mel_pos"][gen_len:gen_len + s][None]


def gpt_route(params: dict, cfg: IndexTTSConfig, batch: int, s: int, kv: KVCache,
              kv_valid, fused):
    """The route of one gpt_step: "step", True or False (tts_tpu's gates
    plus the CUDA kernels' limits and the batch-1 cache guard)."""
    if not fused or s != 1:
        return False
    heads, hd = cfg.gpt_heads, cfg.gpt_head_dim
    if not (fusable_layout(batch, heads, heads, hd)
            and all(fusable_weight(p["wqkv"]) for p in params["layers"])
            and qkv_fits(batch, cfg.gpt_dim, hd)):
        return False
    if fused == "step" and (batch != 1 or kv_valid is not None or (heads * hd) % 128
                            or kv.k.shape[1] != 1 or not step_fits(1, hd, kv.length)):
        return True
    return fused


def gpt_step(params: dict, hidden: torch.Tensor, kv: KVCache, penalty_vec: torch.Tensor,
             cfg: IndexTTSConfig, kv_valid: torch.Tensor | None = None, fused=False):
    """One GPT-2 pass over S new positions. hidden (B, S, D); penalty_vec
    (B, vocab) multiplies the logits; kv_valid (T,) or (B, T) masks the
    text-bucket holes. Returns (logits (B, vocab) fp32, last hidden (B, D)
    after ln_f, the cache advanced by S); the cache rows are written in
    place."""
    b, s, d = hidden.shape
    pos = kv.length
    n = pos + s
    heads, hd = cfg.gpt_heads, cfg.gpt_head_dim
    route = gpt_route(params, cfg, b, s, kv, kv_valid, fused)
    # keys past pos + s are masked: attend over the rows that can be valid
    mask = attention_mask(s, n, pos, n, causal=True, device=hidden.device)
    if kv_valid is not None:
        mask = combine_kv_valid(mask, kv_valid[..., :n])
    x = hidden
    for i, p in enumerate(params["layers"]):
        if route == "step":
            out, kf, vf = fused_qkv_attn(
                x[:, 0], p["wqkv"], None, None, kv.k, kv.v, i, pos, heads=heads,
                kv_heads=heads, head_dim=hd, bqkv=p["bqkv"], norm="ln",
                ln_weight=p["ln1"]["w"], ln_bias=p["ln1"]["b"], eps=1e-5)
            kv.update_layer(i, kf.reshape(b, 1, heads, hd), vf.reshape(b, 1, heads, hd))
            out = out[:, None]
        else:
            if route:
                q, k, v = fused_qkv_rope(
                    x[:, 0], p["wqkv"], heads=heads, kv_heads=heads, head_dim=hd,
                    bqkv=p["bqkv"], norm="ln", ln_weight=p["ln1"]["w"],
                    ln_bias=p["ln1"]["b"], eps=1e-5)
            else:
                h = layer_norm(x, p["ln1"]["w"], p["ln1"]["b"], eps=1e-5)
                q, k, v = torch.chunk(dense(h, p["wqkv"]) + p["bqkv"], 3, dim=-1)
            q, k, v = (t.reshape(b, s, heads, hd) for t in (q, k, v))
            _, k_full, v_full = kv.update_layer(i, k, v)
            out = gqa_attention(q, k_full[:, :, :n], v_full[:, :, :n], mask).reshape(b, s, d)
        x = x + (dense(out, p["wo"]) + p["bo"])
        h = layer_norm(x, p["ln2"]["w"], p["ln2"]["b"], eps=1e-5)
        h = F.gelu(dense(h, p["fc"]["w"]) + p["fc"]["b"], approximate="tanh")
        x = x + (dense(h, p["proj"]["w"]) + p["proj"]["b"])
    kv = kv.advance(s)
    last = layer_norm(x[:, -1], params["ln_f"]["w"], params["ln_f"]["b"], eps=1e-5)
    logits = (dense(last, params["lm_head"]) + params["lm_head_b"]) * penalty_vec
    return logits, last, kv


def gpt_final_norm(params: dict, hidden_stack: torch.Tensor) -> torch.Tensor:
    """final_norm over the collected last hidden states (B, T, D) before
    the vocoder."""
    return layer_norm(hidden_stack, params["final_norm"]["w"], params["final_norm"]["b"],
                      eps=1e-5)


# --------------------------------------------------------------------------
# Random init (tts_tpu's shapes; the port's random numbers)

def _maker(generator: torch.Generator, dtype):
    device = generator.device

    def mat(*shape, s=0.02):
        return (torch.randn(shape, generator=generator, device=device) * s).to(dtype)

    def ones(c):
        return torch.ones((c,), dtype=dtype, device=device)

    def zeros(c):
        return torch.zeros((c,), dtype=dtype, device=device)

    return mat, ones, zeros


def init_gpt_params(cfg: IndexTTSConfig, generator: torch.Generator,
                    dtype=torch.float32) -> dict:
    mat, ones, zeros = _maker(generator, dtype)
    d = cfg.gpt_dim
    scale = cfg.gpt_head_dim ** -0.25

    def ln():
        return {"w": ones(d), "b": zeros(d)}

    layers = []
    for _ in range(cfg.gpt_layers):
        wq, wk, wv = mat(d, d), mat(d, d), mat(d, d)
        layers.append({
            "ln1": ln(),
            "wqkv": torch.cat([(wq.float() * scale).to(dtype),
                               (wk.float() * scale).to(dtype), wv], dim=-1),
            "bqkv": zeros(3 * d),
            "wo": mat(d, d), "bo": zeros(d),
            "ln2": ln(),
            "fc": {"w": mat(d, 4 * d), "b": zeros(4 * d)},
            "proj": {"w": mat(4 * d, d), "b": zeros(d)},
        })
    return {
        "text_embed": mat(cfg.num_text_tokens + 2, d),
        "text_pos": mat(cfg.max_text_tokens + 2, d),
        "mel_embed": mat(cfg.num_mel_codes, d),
        "mel_pos": mat(cfg.max_mel_tokens + 2, d),
        "layers": layers,
        "ln_f": ln(),
        "final_norm": ln(),
        "lm_head": mat(d, cfg.num_mel_codes),
        "lm_head_b": zeros(cfg.num_mel_codes),
    }


def init_conformer_params(cfg: IndexTTSConfig, generator: torch.Generator,
                          n_mels: int | None = None, dtype=torch.float32) -> dict:
    mat, ones, zeros = _maker(generator, dtype)
    d, h = cfg.enc_dim, cfg.enc_heads
    hd = d // h
    n_mels = n_mels or cfg.n_mels

    def lnp():
        return {"w": ones(d), "b": zeros(d)}

    f_out = ((n_mels - 1) // 2 - 1) // 2
    layers = []
    for _ in range(cfg.enc_layers):
        layers.append({
            "norm_mha": lnp(),
            "attn": {"wq": mat(h, d, hd), "bq": mat(h, 1, hd), "wk": mat(h, d, hd),
                     "bk": mat(h, 1, hd), "wv": mat(h, d, hd), "bv": mat(h, 1, hd),
                     "wpos": mat(h, d, hd), "bias_u": mat(h, 1, hd),
                     "bias_v": mat(h, 1, hd), "wo": mat(h, hd, d), "bo": mat(d)},
            "norm_conv": lnp(),
            "conv": {"pw1": {"w": mat(d, 2 * d), "b": mat(2 * d)},
                     "dw": {"w": mat(cfg.enc_conv_kernel, 1, d), "b": mat(d)},
                     "norm": lnp(),
                     "pw2": {"w": mat(d, d), "b": mat(d)}},
            "norm_ff": lnp(),
            "ff1": {"w": mat(d, cfg.enc_ff_dim), "b": mat(cfg.enc_ff_dim)},
            "ff2": {"w": mat(cfg.enc_ff_dim, d), "b": mat(d)},
            "norm_final": lnp(),
        })
    return {
        "sub_convs": [{"w": mat(d, 1, 3, 3), "b": mat(d)},
                      {"w": mat(d, d, 3, 3), "b": mat(d)}],
        "out": {"w": mat(d * f_out, d), "b": mat(d)},
        "pos_enc": mat(4096, d),
        "layers": layers,
        "after_norm": lnp(),
    }


def init_perceiver_params(cfg: IndexTTSConfig, generator: torch.Generator,
                          dtype=torch.float32) -> dict:
    mat, ones, zeros = _maker(generator, dtype)
    d, h, hd = cfg.gpt_dim, cfg.perceiver_heads, cfg.perceiver_dim_head
    ff_dim = d * cfg.perceiver_ff_mult
    return {
        "proj_context": {"w": mat(cfg.enc_dim, d), "b": mat(d)},
        "latents": mat(cfg.num_latents, d),
        "layers": [{"wq": mat(h, d, hd), "wk": mat(h, d, hd), "wv": mat(h, d, hd),
                    "wo": mat(h, hd, d), "ff_norm": {"w": ones(d), "b": zeros(d)},
                    "ff1": {"w": mat(d, ff_dim), "b": mat(ff_dim)},
                    "ff2": {"w": mat(ff_dim, d), "b": mat(d)}} for _ in range(2)],
        "norm": {"w": ones(d), "b": zeros(d)},
    }


def init_ecapa_params(cfg: IndexTTSConfig, generator: torch.Generator,
                      dtype=torch.float32) -> dict:
    mat, ones, zeros = _maker(generator, dtype)
    c = cfg.ecapa_channels

    def tdnn(cin, cout, k):
        return {"conv": {"w": mat(k, cin, cout), "b": mat(cout)},
                "bn": {"scale": ones(cout), "shift": zeros(cout)}}

    sub = c // cfg.res2net_scale
    se_blocks = [{
        "tdnn1": tdnn(c, c, 1),
        "res2net": {"blocks": [tdnn(sub, sub, 3) for _ in range(cfg.res2net_scale - 1)]},
        "tdnn2": tdnn(c, c, 1),
        "se": {"w1": mat(c, cfg.se_channels), "b1": mat(cfg.se_channels),
               "w2": mat(cfg.se_channels, c), "b2": mat(c)},
    } for _ in (2, 3, 4)]
    mfa = 3 * c
    return {
        "block0": tdnn(cfg.n_mels, c, 5),
        "se_blocks": se_blocks,
        "mfa": tdnn(mfa, mfa, 1),
        "asp_tdnn": tdnn(3 * mfa, cfg.ecapa_attn_channels, 1),
        "asp_conv": {"w": mat(cfg.ecapa_attn_channels, mfa), "b": mat(mfa)},
        "asp_bn": {"scale": ones(2 * mfa), "shift": zeros(2 * mfa)},
        "fc": {"w": mat(2 * mfa, cfg.speaker_embed_dim), "b": mat(cfg.speaker_embed_dim)},
    }
