"""VoxCPM-1.5 and VoxCPM-2: the MiniCPM dual LM, the per-latent CFM feature
decoder and the causal audio VAE (counterpart of tts_tpu/models/voxcpm.py).

Plain functions over a params dict with tts_tpu's keys and load-time folds
(input/post norms absorbed into wqkv and w_gate_up, d^-0.25 in the q and k
columns):
  * the audio VAE: a causal-conv encoder (snake residual units, strided
    downsampling, fc_mu) and decoder (transposed-conv upsampling, residual
    units, an optional noise block, VoxCPM-2's sample-rate conditioning and
    depthwise + pointwise init convs, tanh);
  * the feature encoder: a 5-token non-causal transformer a latent patch
    (learned special token first) -> feat_embed for the LM, and cond_proj of
    the last patch, twice, for the CFG pair -> feat_cond;
  * the dual LM (voxcpm_main_step): the base Llama stack -> norm -> an FSQ
    bottleneck on the audio positions -> the residual stack over
    [text hidden | fsq + feat_embed] -> dit_hidden and the stop flag;
  * the CFM feature decoder: cfm_steps - 1 Euler steps of a batch-2 CFG
    estimator over [dit_hidden + t | feat_cond | x], the guidance rescaled
    by st_star. Here a Python loop (tts_tpu's lax.scan).

`llama_stack_step` takes tts_tpu's decode routes (`fused`), under
tts_tpu's gates plus the CUDA kernels' own limits, on every device (the CPU
runs each kernel's twin):
  "step"  kernel 12 (qkv head + attention, ops/decode_step.py): B = 1, no
          kv_valid, head dim 64 or 128, 128-lane q and kv sections, a
          batch-1 cache, at most 8 q heads a kv head; else True;
  True    kernel 11 (the qkv head, ops/decode_qkv.py), then attention;
  False   plain ops.
`voxcpm_main_step` passes the route it is given on to both stacks at S = 1.
(tts_tpu's `fused and s == 1` turns "step" into True, so its VoxCPM never
reaches kernel 12; the port keeps the route asked for.)

Both take a cache whose length is a host int, or a 0-dim int32 device
tensor (kv/cache.py; the decode programs of runtime/voxcpm.py, which a CUDA
graph replays without a host read). In the device form the RoPE rows come
by `index_select` at the device position, the plain attention reads the
cache's `bound` rows under a mask built on the device, the "step" route is
gated at the bound's top row and takes kernel 12's device form (`top`), and
a device `valid_len` picks the last row by `index_select`.

Precision: activations run in the params' dtype. The CFM's Euler state and
its noise stay fp32 and are cast to the params' dtype where they enter a
matmul (tts_tpu promotes the whole estimator to fp32 there, by JAX's
mixed-dtype rule); the update x - dt * dphi is fp32.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.snake import snake
from ..kv.cache import KVCache
from ..nn.attention import attention_mask, combine_kv_valid, gqa_attention
from ..nn.norm import rms_norm
from ..nn.rope import apply_rope, rope_table
from ..ops.conv import conv1d, conv_transpose1d
from ..ops.decode_qkv import fusable_layout, fusable_weight, fused_qkv_rope, qkv_fits
from ..ops.decode_step import fused_qkv_attn, step_fits
from ..quant.weight_only import dense

__all__ = ["LlamaStackConfig", "VaeConfig", "VoxCPMConfig", "voxcpm_v2_config",
           "stack_routes", "llama_stack_step", "llama_stack_nocache", "vae_encode",
           "vae_decode", "feat_encoder_cond", "feat_encoder_cond_batch",
           "cfm_time_schedule", "cfm_feat_decoder", "cfm_feat_decoder_batch", "fsq_layer",
           "voxcpm_main_step", "init_params", "init_vae_params"]


@dataclass(frozen=True)
class LlamaStackConfig:
    """MiniCPM/Llama-style stack (no q/k norm)."""

    hidden_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    ffn_dim: int
    num_layers: int
    rms_eps: float = 1e-5
    rope_base: float = 10000.0
    max_seq_len: int = 2048


@dataclass(frozen=True)
class VaeConfig:
    """Defaults = the upstream AudioVAEConfig, as tts_tpu's: encoder_dim
    128, rates (2, 5, 8, 8), decoder_dim 1536, decoder rates (8, 8, 5, 2),
    depthwise residual convs (and a depthwise + pointwise decoder init
    conv). VoxCPM-2 sets decoder_rates apart from the encoder's and sr_bins
    for its sample-rate conditioning."""

    d_model: int = 128
    latent_dim: int = 64
    strides: tuple[int, ...] = (2, 5, 8, 8)
    decoder_channels: int = 1536
    use_noise_block: bool = False
    depthwise: bool = True
    decoder_rates: tuple[int, ...] | None = None
    sr_bins: tuple[float, ...] = ()

    @property
    def encoder_stride(self) -> int:
        return int(np.prod(self.strides))

    @property
    def decoder_stride(self) -> int:
        rates = self.decoder_rates or tuple(reversed(self.strides))
        return int(np.prod(rates))


@dataclass(frozen=True)
class VoxCPMConfig:
    """Defaults sized for VoxCPM-1.5, as tts_tpu's."""

    base: LlamaStackConfig = LlamaStackConfig(
        hidden_size=1024, num_heads=16, num_kv_heads=2, head_dim=64,
        ffn_dim=2560, num_layers=24)
    residual: LlamaStackConfig = LlamaStackConfig(
        hidden_size=1024, num_heads=16, num_kv_heads=2, head_dim=64,
        ffn_dim=2560, num_layers=4)
    feat_encoder: LlamaStackConfig = LlamaStackConfig(
        hidden_size=512, num_heads=8, num_kv_heads=2, head_dim=64,
        ffn_dim=1280, num_layers=3, max_seq_len=8)
    estimator: LlamaStackConfig = LlamaStackConfig(
        hidden_size=512, num_heads=8, num_kv_heads=2, head_dim=64,
        ffn_dim=1280, num_layers=6, max_seq_len=16)
    vae: VaeConfig = VaeConfig()
    patch_size: int = 4
    chunk_size: int = 640              # vae encoder stride per latent
    fsq_dim: int = 32
    fsq_levels: int = 9
    vocab_size: int = 73448
    audio_start_id: int = 101
    cfm_steps: int = 10
    cfm_sway: float = 1.0
    # the delta-time embedding is folded into cfm_t_table at load
    cfm_mean_mode: bool = False
    cfg_value: float = 2.0
    stop_act: str = "tanh"             # stop_actn nonlinearity
    sample_rate: int = 44100           # VAE input rate

    @property
    def output_sample_rate(self) -> int:
        """The decoder's native output rate (VoxCPM-2: 16 kHz in, 48 kHz out)."""
        return self.sample_rate * self.vae.decoder_stride // self.vae.encoder_stride

    @property
    def samples_per_latent(self) -> int:
        return self.patch_size * self.vae.decoder_stride


def voxcpm_v2_config() -> VoxCPMConfig:
    """VoxCPM-2: 16 kHz VAE input with encoder strides (2, 5, 8, 8) (chunk
    640) and a sample-rate-conditioned decoder of 2048 channels whose
    upsampling totals 1920: native 48 kHz output."""
    return VoxCPMConfig(
        sample_rate=16000,
        chunk_size=640,
        vae=VaeConfig(d_model=128, latent_dim=64, strides=(2, 5, 8, 8),
                      decoder_channels=2048, decoder_rates=(8, 8, 6, 5),
                      sr_bins=(22050.0, 44100.0)),
    )


# --------------------------------------------------------------------------
# Llama-style stacks

@dataclass(frozen=True)
class _Routes:
    step: bool = False       # kernel 12
    qkv: bool = False        # kernel 11


def stack_routes(params: dict, cfg: LlamaStackConfig, batch: int, s: int, kv: KVCache,
                 kv_valid, fused) -> _Routes:
    """tts_tpu's gates (models/voxcpm.py:llama_stack_step), plus the CUDA
    kernels' own limits and the batch-1 cache guard tts_tpu's "step" gate
    lacks, so a step takes the same route on every device."""
    if not fused:
        return _Routes()
    if s != 1:
        raise ValueError("fused decode path requires S == 1")
    heads, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ok = (fusable_layout(batch, heads, kvh, hd)
          and all(fusable_weight(p["wqkv"]) for p in params["layers"])
          and qkv_fits(batch, cfg.hidden_size, hd))
    if not ok:
        return _Routes()
    # the device form is gated at its top row, the host form at the length
    most = kv.rows - 1 if kv.on_device else kv.length
    step = (fused == "step" and batch == 1 and kv_valid is None and hd in (64, 128)
            and (heads * hd) % 128 == 0 and (kvh * hd) % 128 == 0
            and kv.k.shape[1] == 1 and heads % kvh == 0
            and step_fits(heads // kvh, hd, most))
    return _Routes(step=step, qkv=not step)


def llama_stack_step(params: dict, hidden: torch.Tensor, kv: KVCache,
                     cfg: LlamaStackConfig, rope_cos, rope_sin,
                     kv_valid: torch.Tensor | None = None, fused=False):
    """A causal cached pass over S new positions. hidden (B, S, H); kv_valid
    (T,) shared or (B, T) per row, key validity over the cache rows, or
    None. Returns (the hidden sequence (B, S, H) before the final norm, the
    cache advanced by S). The cache rows are written in place. kv.length
    may live on the device (see the module's docstring)."""
    b, s, _ = hidden.shape
    pos = kv.length
    # the keys a step may see: pos + s, and in the device form its bound's rows
    n = kv.rows if kv.on_device else pos + s
    top = kv.rows - 1 if kv.on_device else None
    routes = stack_routes(params, cfg, b, s, kv, kv_valid, fused)
    heads, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q_sz, kv_sz = heads * hd, kvh * hd
    mask = None
    if not routes.step:
        # keys past pos + s are masked: attend over the rows that can be valid
        mask = attention_mask(s, n, pos, pos + s, causal=True, device=hidden.device)
        if kv_valid is not None:
            mask = combine_kv_valid(mask, kv_valid[..., :n])
    x = hidden
    for i, p in enumerate(params["layers"]):
        if routes.step:
            out, kf, vf = fused_qkv_attn(
                x[:, 0], p["wqkv"], rope_cos, rope_sin, kv.k, kv.v, i, pos,
                heads=heads, kv_heads=kvh, head_dim=hd, bqkv=p.get("bqkv"),
                eps=cfg.rms_eps, top=top)
            # an ordinary launch: kernel 12 loads cache rows before its wait
            kv.update_layer(i, kf.reshape(b, 1, kvh, hd), vf.reshape(b, 1, kvh, hd))
            out = out[:, None]
        else:
            if routes.qkv:
                qf, kf, vf = fused_qkv_rope(
                    x[:, 0], p["wqkv"], rope_cos, rope_sin, heads=heads, kv_heads=kvh,
                    head_dim=hd, bqkv=p.get("bqkv"), eps=cfg.rms_eps)
                q = qf.reshape(b, 1, heads, hd)
                k = kf.reshape(b, 1, kvh, hd)
                v = vf.reshape(b, 1, kvh, hd)
            else:
                qkv = dense(rms_norm(x, eps=cfg.rms_eps), p["wqkv"])
                if "bqkv" in p:
                    qkv = qkv + p["bqkv"]
                q = apply_rope(qkv[..., :q_sz].reshape(b, s, heads, hd), rope_cos, rope_sin)
                k = apply_rope(qkv[..., q_sz:q_sz + kv_sz].reshape(b, s, kvh, hd),
                               rope_cos, rope_sin)
                v = qkv[..., q_sz + kv_sz:].reshape(b, s, kvh, hd)
            _, k_full, v_full = kv.update_layer(i, k, v)
            out = gqa_attention(q, k_full[:, :, :n], v_full[:, :, :n],
                                mask).reshape(b, s, -1)
        x = x + dense(out, p["wo"])
        gate, up = dense(rms_norm(x, eps=cfg.rms_eps), p["w_gate_up"]).chunk(2, dim=-1)
        x = x + dense(F.silu(gate) * up, p["w_down"])
    return x, kv.advance(s)


def llama_stack_nocache(params: dict, x: torch.Tensor, cfg: LlamaStackConfig,
                        rope_cos, rope_sin) -> torch.Tensor:
    """Full (non-causal) attention over a short fixed window, batched over
    patches (the feature encoder and the CFM estimator)."""
    b, s, _ = x.shape
    heads, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q_sz, kv_sz = heads * hd, kvh * hd
    for p in params["layers"]:
        qkv = dense(rms_norm(x, eps=cfg.rms_eps), p["wqkv"])
        if "bqkv" in p:
            qkv = qkv + p["bqkv"]
        q = apply_rope(qkv[..., :q_sz].reshape(b, s, heads, hd), rope_cos, rope_sin)
        k = apply_rope(qkv[..., q_sz:q_sz + kv_sz].reshape(b, s, kvh, hd), rope_cos, rope_sin)
        v = qkv[..., q_sz + kv_sz:].reshape(b, s, kvh, hd)
        out = gqa_attention(q, k.transpose(1, 2), v.transpose(1, 2), None).reshape(b, s, -1)
        x = x + dense(out, p["wo"])
        gate, up = dense(rms_norm(x, eps=cfg.rms_eps), p["w_gate_up"]).chunk(2, dim=-1)
        x = x + dense(F.silu(gate) * up, p["w_down"])
    return x


# --------------------------------------------------------------------------
# Audio VAE

def _causal_conv(x, w, b=None, pad: int = 0, stride: int = 1, dilation: int = 1,
                 groups: int = 1):
    """Left-pad 2 * pad, then a VALID conv. x (B, T, C)."""
    x = F.pad(x, (0, 0, 2 * pad, 0))
    return conv1d(x, w, b, padding=0, stride=stride, dilation=dilation, groups=groups)


def _causal_conv_t(x, w, b=None, pad: int = 0, stride: int = 1, output_padding: int = 0):
    """A transposed conv trimmed right by 2 * pad - output_padding."""
    y = conv_transpose1d(x, w, b, stride=stride, padding=0)
    trim = 2 * pad - output_padding
    return y[:, :y.shape[1] - trim] if trim > 0 else y


def _residual_unit(x, p: dict, dilation: int):
    pad = ((7 - 1) * dilation) // 2
    # depthwise when the stored kernel has a single input channel
    groups = x.shape[-1] if p["c1"]["w"].shape[1] == 1 else 1
    h = snake(x, p["s1"]["alpha"], p["s1"]["alpha_recip"])
    h = _causal_conv(h, p["c1"]["w"], p["c1"].get("b"), pad=pad, dilation=dilation,
                     groups=groups)
    h = snake(h, p["s2"]["alpha"], p["s2"]["alpha_recip"])
    h = _causal_conv(h, p["c2"]["w"], p["c2"].get("b"))
    return x + h


def vae_encode(params: dict, audio: torch.Tensor, cfg: VaeConfig) -> torch.Tensor:
    """audio (B, N) -> latents (B, N / encoder_stride, latent_dim). The
    caller pads N to a multiple of the stride."""
    x = audio[..., None]
    x = _causal_conv(x, params["pre"]["w"], params["pre"].get("b"), pad=3)
    for blk, stride in zip(params["enc_blocks"], cfg.strides):
        for unit, dil in zip(blk["units"], (1, 3, 9)):
            x = _residual_unit(x, unit, dil)
        x = snake(x, blk["snake"]["alpha"], blk["snake"]["alpha_recip"])
        x = _causal_conv(x, blk["down"]["w"], blk["down"].get("b"), pad=-(-stride // 2),
                         stride=stride)
    return _causal_conv(x, params["fc_mu"]["w"], params["fc_mu"].get("b"), pad=1)


def vae_decode(params: dict, latents: torch.Tensor, cfg: VaeConfig, sr_idx: int = 0,
               noise: list | None = None) -> torch.Tensor:
    """latents (B, T, latent_dim) -> audio (B, T * decoder_stride) in [-1, 1].

    The depthwise + pointwise init pair where `pre_dw` is given; each block
    modulated first by the sample-rate conditioning (x * scale + bias at
    sr_idx, then the optional snake + conv out layer) where it has one.
    The noise block adds noise[i] * conv(x) after block i's upsampling,
    noise[i] (B, T_i, 1); where `noise` is None it draws noise[i] from a
    generator seeded with i (tts_tpu's fixed key i)."""
    if cfg.depthwise and "pre_dw" in params:
        x = _causal_conv(latents, params["pre_dw"]["w"], params["pre_dw"].get("b"), pad=3,
                         groups=latents.shape[-1])
        x = _causal_conv(x, params["pre"]["w"], params["pre"].get("b"))
    else:
        x = _causal_conv(latents, params["pre"]["w"], params["pre"].get("b"), pad=3)
    rates = cfg.decoder_rates or tuple(reversed(cfg.strides))
    for i, (blk, stride) in enumerate(zip(params["dec_blocks"], rates)):
        if "sr_scale" in blk:
            x = x * blk["sr_scale"][sr_idx] + blk["sr_bias"][sr_idx]
            if "sr_out_conv" in blk:
                x = snake(x, blk["sr_out_snake"]["alpha"], blk["sr_out_snake"]["alpha_recip"])
                k = blk["sr_out_conv"]["w"].shape[0]
                x = _causal_conv(x, blk["sr_out_conv"]["w"], blk["sr_out_conv"].get("b"),
                                 pad=(k - 1) // 2)
        x = snake(x, blk["snake"]["alpha"], blk["snake"]["alpha_recip"])
        x = _causal_conv_t(x, blk["up"]["w"], blk["up"].get("b"), pad=-(-stride // 2),
                           stride=stride, output_padding=stride % 2)
        if cfg.use_noise_block and "noise" in blk:
            if noise is None:
                gen = torch.Generator(x.device).manual_seed(i)
                n = torch.randn((x.shape[0], x.shape[1], 1), generator=gen,
                                device=x.device).to(x.dtype)
            else:
                n = noise[i].to(x.dtype)
            x = x + n * _causal_conv(x, blk["noise"]["w"], None)
        for unit, dil in zip(blk["units"], (1, 3, 9)):
            x = _residual_unit(x, unit, dil)
    x = snake(x, params["post_snake"]["alpha"], params["post_snake"]["alpha_recip"])
    x = _causal_conv(x, params["post"]["w"], params["post"].get("b"), pad=3)
    return torch.tanh(x[..., 0])


# --------------------------------------------------------------------------
# Feature encoder and conditioning

def _linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    y = torch.matmul(x.to(p["w"].dtype), p["w"])
    return y + p["b"] if "b" in p else y


def _encode_patches(params: dict, feats: torch.Tensor, cfg: VoxCPMConfig) -> torch.Tensor:
    """feats (N, patch, latent) -> feat_embed (N, base_H): the special token
    before each patch, the encoder stack, its first position normed and
    projected."""
    fe = cfg.feat_encoder
    h = _linear(feats, params["fe_in_proj"])                     # (N, P, H)
    sp = params["fe_special"].expand(feats.shape[0], 1, fe.hidden_size)
    h = torch.cat([sp, h], dim=1)                                # (N, P+1, H)
    q_len = cfg.patch_size + 1
    h = llama_stack_nocache(params["fe"], h, fe, params["fe_rope_cos"][:q_len],
                            params["fe_rope_sin"][:q_len])
    return _linear(rms_norm(h[:, 0], eps=fe.rms_eps), params["enc_to_lm"])


def feat_encoder_cond(params: dict, audio_feat: torch.Tensor, cfg: VoxCPMConfig):
    """audio_feat (T, patch, latent) -> (feat_embed (1, T, base_H),
    feat_cond (2, patch, est_H): cond_proj of the last patch, twice)."""
    feat_embed = _encode_patches(params, audio_feat, cfg)[None]
    cond = _linear(audio_feat[-1:], params["cond_proj"])         # (1, P, est_H)
    return feat_embed, torch.cat([cond, cond], dim=0)


def feat_encoder_cond_batch(params: dict, audio_feat: torch.Tensor, cfg: VoxCPMConfig):
    """Batched serving, one latent a stream: audio_feat (B, patch, latent)
    -> (feat_embed (B, 1, base_H), feat_cond (2B, patch, est_H), the rows
    [pos | neg])."""
    feat_embed = _encode_patches(params, audio_feat, cfg)[:, None]
    cond = _linear(audio_feat, params["cond_proj"])              # (B, P, est_H)
    return feat_embed, torch.cat([cond, cond], dim=0)


# --------------------------------------------------------------------------
# CFM feature decoder

def cfm_time_schedule(steps: int, sway: float = 1.0):
    """The sway-sampled descending t-span: (ts (steps,), dt (steps - 1,))."""
    t = np.linspace(1.0, 0.0, steps + 1, dtype=np.float64)
    ts = (t + sway * (np.cos(np.pi / 2 * t) - 1.0 + t))[1:]
    dt = ts[:-1] - ts[1:]
    return ts.astype(np.float32), dt.astype(np.float32)


def cfm_feat_decoder_batch(params: dict, noise: torch.Tensor, dit_hidden: torch.Tensor,
                           feat_cond: torch.Tensor, cfg: VoxCPMConfig) -> torch.Tensor:
    """noise (B, patch, latent); dit_hidden (B, 1, est_H); feat_cond (2B,
    patch, est_H), the rows [pos | neg]. Each Euler step runs the CFG pair
    as 2B estimator rows, [dit_hidden + t | feat_cond | x] and [t |
    feat_cond | x], and rescales the guidance by st_star a row. Returns the
    latent patches (B, patch, latent), fp32."""
    est = cfg.estimator
    bsz = noise.shape[0]
    dt = params["est_in_proj"]["w"].dtype
    q_len = 2 * cfg.patch_size + 1
    rope_cos, rope_sin = params["est_rope_cos"][:q_len], params["est_rope_sin"][:q_len]
    dit_hidden, feat_cond = dit_hidden.to(dt), feat_cond.to(dt)
    x = noise.float()
    for i in range(cfg.cfm_steps - 1):
        t = params["cfm_t_table"][i].expand_as(dit_hidden)
        rows = torch.cat([dit_hidden + t, t], dim=0)             # (2B, 1, H)
        xin = _linear(x, params["est_in_proj"])
        h = torch.cat([rows, feat_cond, torch.cat([xin, xin], dim=0)], dim=1)
        h = llama_stack_nocache(params["est"], h, est, rope_cos, rope_sin)
        out = _linear(rms_norm(h[:, cfg.patch_size + 1:], eps=est.rms_eps),
                      params["est_out_proj"]).float()
        pos, neg = out[:bsz], out[bsz:]
        pf, nf = pos.reshape(bsz, 1, -1), neg.reshape(bsz, 1, -1)
        st_star = (pf * nf).sum(-1, keepdim=True) / ((nf * nf).sum(-1, keepdim=True) + 1e-12)
        dphi = (1.0 - cfg.cfg_value) * neg * st_star + cfg.cfg_value * pos
        x = x - params["cfm_dt"][i].float() * dphi
    return x


def cfm_feat_decoder(params: dict, noise: torch.Tensor, dit_hidden: torch.Tensor,
                     feat_cond: torch.Tensor, cfg: VoxCPMConfig) -> torch.Tensor:
    """noise (1, patch, latent) -> the latent patch (1, patch, latent): the
    batch form at B = 1 (feat_cond (2, patch, est_H) is its [pos | neg])."""
    return cfm_feat_decoder_batch(params, noise, dit_hidden, feat_cond, cfg)


# --------------------------------------------------------------------------
# FSQ bottleneck and the dual-LM step

def fsq_layer(params: dict, x: torch.Tensor, cfg: VoxCPMConfig) -> torch.Tensor:
    """Project down, bound with tanh, round to the (levels - 1) / 2 grid,
    project back up."""
    z = _linear(x, params["fsq_down"])
    half = (cfg.fsq_levels - 1) / 2.0
    z = torch.round(torch.tanh(z) * half) / half
    return _linear(z, params["fsq_up"])


def voxcpm_main_step(params: dict, hidden: torch.Tensor, feat_embed: torch.Tensor,
                     concat_text_len, base_kv: KVCache, res_kv: KVCache,
                     cfg: VoxCPMConfig, valid_len: int | None = None,
                     kv_valid: torch.Tensor | None = None, fused=False):
    """One dual-LM pass over S positions. hidden (B, S, base_H).
    concat_text_len marks the audio positions: an int boundary (positions
    >= it are audio, the v1.5 layout), an (S,) bool mask (the v2 modes
    interleave text and audio) or a (B, S) bool mask (batched serving).
    Audio positions go through the FSQ bottleneck, and get feat_embed added
    before the residual LM; feat_embed aligns with hidden.

    valid_len (a host int, or a 0-dim int32 device tensor): the true length
    inside a padded bucket; dit and stop come from position valid_len - 1
    and the caller rewinds the caches. kv_valid: per-row (B, T) key
    validity (right-justified batch rows). fused: the decode route of both
    stacks at S = 1. The caches' length may live on the device (both share
    it; see the module's docstring).

    Returns (dit_hidden (B, 1, est_H), stop_flag (int32, () at B = 1, (B,)
    otherwise), base_kv, res_kv)."""
    b = cfg.base
    bsz, s, _ = hidden.shape
    pos = base_kv.length
    if base_kv.on_device:
        idx = pos.long() + torch.arange(s, device=pos.device)
        rope_cos = params["rope_cos"].index_select(0, idx)
        rope_sin = params["rope_sin"].index_select(0, idx)
    else:
        rope_cos, rope_sin = params["rope_cos"][pos:pos + s], params["rope_sin"][pos:pos + s]
    fused = fused if s == 1 else False
    x, base_kv = llama_stack_step(params["base"], hidden, base_kv, b, rope_cos, rope_sin,
                                  kv_valid=kv_valid, fused=fused)
    x = rms_norm(x, params["base_norm"], eps=b.rms_eps)

    ctl = concat_text_len
    if isinstance(ctl, torch.Tensor) and ctl.dim() > 0:          # an (S,) or (B, S) mask
        is_audio = (ctl if ctl.dim() == 2 else ctl[None])[..., None]
    else:
        is_audio = (torch.arange(s, device=x.device) >= int(ctl))[None, :, None]
    fsq_out = fsq_layer(params, x, cfg)
    mixed = torch.where(is_audio, fsq_out, x)
    res_in = torch.where(is_audio, fsq_out + feat_embed, x)
    r, res_kv = llama_stack_step(params["residual"], res_in, res_kv, cfg.residual,
                                 rope_cos, rope_sin, kv_valid=kv_valid, fused=fused)

    if isinstance(valid_len, torch.Tensor):
        at = (valid_len.long() - 1).reshape(1)
        lm_hidden, r_last = mixed.index_select(1, at), r.index_select(1, at)
    else:
        last = s if valid_len is None else valid_len
        lm_hidden, r_last = mixed[:, last - 1:last], r[:, last - 1:last]
    # lm_hidden: before the feat add
    res_hidden = rms_norm(r_last, eps=cfg.residual.rms_eps)
    both = _linear(lm_hidden, params["dit_stop"])
    dit_dim = cfg.estimator.hidden_size
    dit_hidden = both[..., :dit_dim] + torch.matmul(res_hidden, params["res_to_dit"]["w"])
    stop_im = both[..., dit_dim:]
    stop = F.silu(stop_im) if cfg.stop_act == "silu" else torch.tanh(stop_im)
    stop = _linear(stop, params["stop_head"])
    stop_flag = torch.argmax(stop[:, -1], dim=-1).to(torch.int32)
    if bsz == 1:
        stop_flag = stop_flag[0]
    return dit_hidden, stop_flag, base_kv, res_kv


# --------------------------------------------------------------------------
# Random init

def _init_llama_stack(cfg: LlamaStackConfig, gen: torch.Generator, dtype) -> dict:
    hs, hd = cfg.hidden_size, cfg.head_dim
    dev = gen.device
    scale = hd ** -0.25

    def mat(cin, cout, s=0.02):
        return torch.randn((cin, cout), generator=gen, device=dev) * s

    layers = []
    for _ in range(cfg.num_layers):
        wq = mat(hs, cfg.num_heads * hd) * scale
        wk = mat(hs, cfg.num_kv_heads * hd) * scale
        wv = mat(hs, cfg.num_kv_heads * hd)
        layers.append({
            "wqkv": torch.cat([wq, wk, wv], dim=-1).to(dtype),
            "wo": mat(cfg.num_heads * hd, hs).to(dtype),
            "w_gate_up": mat(hs, 2 * cfg.ffn_dim).to(dtype),
            "w_down": mat(cfg.ffn_dim, hs).to(dtype),
        })
    return {"layers": layers}


def init_vae_params(cfg: VaeConfig, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32) -> dict:
    """Random VAE parameters on `generator.device` with tts_tpu's structure
    and scales (the decoder under "dec")."""
    dev = generator.device

    def mat(*shape, s=0.1):
        return (torch.randn(shape, generator=generator, device=dev) * s).to(dtype)

    def conv_p(k, cin, cout):
        return {"w": mat(k, cin, cout), "b": torch.zeros((cout,), dtype=dtype, device=dev)}

    def snake_p(c):
        return {"alpha": torch.ones((c,), dtype=dtype, device=dev),
                "alpha_recip": torch.ones((c,), dtype=dtype, device=dev)}

    def unit(c):
        return {"s1": snake_p(c), "c1": conv_p(7, 1 if cfg.depthwise else c, c),
                "s2": snake_p(c), "c2": conv_p(1, c, c)}

    d = cfg.d_model
    enc_blocks = []
    for s in cfg.strides:
        enc_blocks.append({"units": [unit(d) for _ in range(3)], "snake": snake_p(d),
                           "down": conv_p(2 * s, d, 2 * d)})
        d *= 2
    enc_dim = d

    dc = cfg.decoder_channels
    rates = cfg.decoder_rates or tuple(reversed(cfg.strides))
    n_bins = len(cfg.sr_bins) + 1
    dec_blocks = []
    cin = dc
    for s in rates:
        cout = cin // 2
        blk = {"snake": snake_p(cin), "up": conv_p(2 * s, cin, cout),
               "units": [unit(cout) for _ in range(3)]}
        if cfg.use_noise_block:
            blk["noise"] = {"w": mat(1, cout, cout)}
        if cfg.sr_bins:
            blk["sr_scale"] = torch.ones((n_bins, cin), dtype=dtype, device=dev)
            blk["sr_bias"] = torch.zeros((n_bins, cin), dtype=dtype, device=dev)
        dec_blocks.append(blk)
        cin = cout
    dec = {"pre": conv_p(1, cfg.latent_dim, dc) if cfg.depthwise
           else conv_p(7, cfg.latent_dim, dc),
           "dec_blocks": dec_blocks, "post_snake": snake_p(cin), "post": conv_p(7, cin, 1)}
    if cfg.depthwise:
        dec["pre_dw"] = {"w": mat(7, 1, cfg.latent_dim),
                         "b": torch.zeros((cfg.latent_dim,), dtype=dtype, device=dev)}
    return {"pre": conv_p(7, 1, cfg.d_model), "enc_blocks": enc_blocks,
            "fc_mu": conv_p(3, enc_dim, cfg.latent_dim), "dec": dec}


def init_params(cfg: VoxCPMConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random LM, feature-encoder and estimator parameters on
    `generator.device` with tts_tpu's structure and scales."""
    dev = generator.device

    def mat(*shape, s=0.02):
        return (torch.randn(shape, generator=generator, device=dev) * s).to(dtype)

    def lin(cin, cout):
        return {"w": mat(cin, cout), "b": torch.zeros((cout,), dtype=dtype, device=dev)}

    def table(a):
        return torch.as_tensor(a, device=dev).to(dtype)

    b, r = cfg.base, cfg.residual
    fe, est = cfg.feat_encoder, cfg.estimator
    _, dts = cfm_time_schedule(cfg.cfm_steps, cfg.cfm_sway)
    params = {
        "embed": mat(cfg.vocab_size, b.hidden_size),
        "base": _init_llama_stack(b, generator, dtype),
        "base_norm": torch.ones((b.hidden_size,), dtype=dtype, device=dev),
        "residual": _init_llama_stack(r, generator, dtype),
        "fsq_down": lin(b.hidden_size, cfg.fsq_dim),
        "fsq_up": lin(cfg.fsq_dim, b.hidden_size),
        "dit_stop": lin(b.hidden_size, est.hidden_size + 32),
        "res_to_dit": {"w": mat(r.hidden_size, est.hidden_size)},
        "stop_head": lin(32, 2),
        "fe": _init_llama_stack(fe, generator, dtype),
        "fe_in_proj": lin(cfg.vae.latent_dim, fe.hidden_size),
        "fe_special": mat(1, fe.hidden_size),
        "enc_to_lm": lin(fe.hidden_size, b.hidden_size),
        "cond_proj": lin(cfg.vae.latent_dim, est.hidden_size),
        "est": _init_llama_stack(est, generator, dtype),
        "est_in_proj": lin(cfg.vae.latent_dim, est.hidden_size),
        "est_out_proj": lin(est.hidden_size, cfg.vae.latent_dim),
        "cfm_t_table": mat(cfg.cfm_steps - 1, est.hidden_size),
        "cfm_dt": table(dts),
    }
    for name, c in (("rope", b), ("fe_rope", fe), ("est_rope", est)):
        cos, sin = rope_table(c.max_seq_len, c.head_dim, c.rope_base)
        params[f"{name}_cos"], params[f"{name}_sin"] = table(cos), table(sin)
    return params
