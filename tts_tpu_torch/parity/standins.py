"""Stand-in sessions: the harness driven where no exported graphs exist.

A stand-in is an object with ONNX Runtime's session surface
(`get_inputs()`, `get_outputs()`, `run(None, feed)`) that carries a
reference graph's input names and declared shapes (the contracts of
`sessions.py` and `run_reference.py`), and runs the port's own stage
function behind it on the params it is given, inside `wrap()` (for
example a context that swaps the kernels for their plain twins), without
autograd. Each builder returns {graph file name: stand-in}; a caller that
lays empty files of those names in a family's artifact directory and makes
`run_reference._session` return `table[basename(path)]` drives
`run_reference` end to end, as tests/test_parity_runner.py does with
tts_tpu's. Those names match `run_reference._SESSION_GRAPHS`.
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import torch

from .sessions import _np, _pcm16, _placement, _put

__all__ = ["StandIn", "bigvgan_standins", "f5_standins", "kani_standins",
           "indextts_standins", "qwen_standins", "voxcpm_standins"]


class StandIn:
    """inputs: [(name, declared shape)], a str dim dynamic; fn(feed) -> the
    outputs (numpy), in `outputs` order where names are given."""

    def __init__(self, inputs, fn, outputs=(), wrap=None):
        self._inputs = [SimpleNamespace(name=n, shape=list(s)) for n, s in inputs]
        self._outputs = [SimpleNamespace(name=n) for n in outputs]
        self.fn = fn
        self.wrap = wrap or contextlib.nullcontext
        self.calls = 0

    def get_inputs(self):
        return self._inputs

    def get_outputs(self):
        return self._outputs

    def run(self, _output_names, feed):
        self.calls += 1
        with self.wrap(), torch.no_grad():
            return [np.asarray(o) for o in self.fn(feed)]


def _i16(wav: torch.Tensor) -> np.ndarray:
    return _pcm16(wav).cpu().numpy()


# ---------------------------------------------------------------- vocoders

def bigvgan_standins(params, cfg, wrap=None) -> dict:
    """BigVGAN.onnx: mel (1, num_mels, T) -> int16 waveform."""
    from ..models.bigvgan import bigvgan_apply

    dev, dt = _placement(params)

    def gen(feed):
        mel = _put(feed["mel"].transpose(0, 2, 1), dev, dt)
        return [_i16(bigvgan_apply(params, mel, cfg))]

    return {"BigVGAN.onnx": StandIn([("mel", (1, cfg.num_mels, "T"))], gen, ("audio",), wrap)}


def f5_standins(params, cfg, vparams, vcfg, seed: int = 0, wrap=None) -> dict:
    """The three-graph F5 pipeline: F5_Preprocess (int16 audio (1, 1, N),
    text ids, max_duration -> noise drawn from a generator seeded with
    `seed` at each call, cat_mel_text, cat_mel_text_drop, ref_signal_len), F5_Transformer
    (one Euler step, fed by name, the step index last -> the next noise and
    step) and F5_Decode (denoised, ref_signal_len -> int16 waveform of the
    generated span through Vocos)."""
    from ..models.f5 import f5_preprocess, f5_step
    from ..models.vocos import vocos_decode

    dev, _ = _placement(params)

    def preprocess(feed):
        audio = feed["audio"].astype(np.float32).reshape(1, -1) / 32768.0
        noise, cat, cat_drop, ref_len = f5_preprocess(
            params, _put(audio, dev), _put(feed["text_ids"], dev),
            int(feed["max_duration"][0]), cfg,
            generator=torch.Generator(dev).manual_seed(seed))
        return [_np(noise), _np(cat), _np(cat_drop), np.array([ref_len], np.int64)]

    def transformer(feed):
        idx = int(feed["time_step"][0])
        x = f5_step(params, _put(feed["noise"], dev), _put(feed["cat_mel_text"], dev),
                    _put(feed["cat_mel_text_drop"], dev), cfg, idx)
        return [_np(x), np.array([idx + 1], np.int32)]

    def decode(feed):
        den = _put(feed["denoised"], dev)
        gen_span = den[:, int(feed["ref_signal_len"][0]):]
        return [_i16(vocos_decode(vparams, gen_span, vcfg))]

    mel, cat = (1, "T", cfg.n_mels), (1, "T", cfg.n_mels + cfg.text_dim)
    return {
        "F5_Preprocess.onnx": StandIn(
            [("audio", (1, 1, "N")), ("text_ids", (1, "L")), ("max_duration", (1,))],
            preprocess, ("noise", "cat_mel_text", "cat_mel_text_drop", "ref_signal_len"), wrap),
        "F5_Transformer.onnx": StandIn(
            [("noise", mel), ("cat_mel_text", cat), ("cat_mel_text_drop", cat),
             ("time_step", (1,))], transformer, ("denoised", "time_step_next"), wrap),
        "F5_Decode.onnx": StandIn(
            [("denoised", mel), ("ref_signal_len", (1,))], decode, ("audio",), wrap),
    }


# ------------------------------------------------------------ AR families

def kani_standins(params, cfg, cparams, ccfg, wrap=None) -> dict:
    """Embed / Main (a fresh cache each call) / Codec."""
    from ..models.kani import embed_tokens, init_state, kani_step
    from ..models.nanocodec import fsq_dequantize, hifigan_decode, tokens_to_codes

    dev, dt = _placement(params)
    n_attn = cfg.num_attn_layers
    n_conv = len(cfg.layer_types) - n_attn
    kv_inputs = ([(f"in_key_{i}", (1, cfg.num_kv_heads, 1, cfg.head_dim, "hist"))
                  for i in range(n_attn)]
                 + [(f"in_value_{i}", (1, cfg.num_kv_heads, 1, "hist", cfg.head_dim))
                    for i in range(n_attn)]
                 + [(f"in_conv_{i}", (1, cfg.hidden_size, cfg.conv_kernel - 1))
                    for i in range(n_conv)])

    def embed(feed):
        return [_np(embed_tokens(params, _put(feed["input_ids"], dev)))]

    def main(feed):
        hidden = feed["hidden_states"]
        logits, _ = kani_step(params, _put(hidden, dev, dt), init_state(cfg, 1, dt, dev), cfg)
        pads = [np.zeros(1, np.float32)] * len(kv_inputs)
        return pads + [_np(logits), np.array([hidden.shape[1]], np.int64)]

    def codec(feed):
        cdev, _ = _placement(cparams)
        start = cfg.vocab_size - ccfg.num_groups * ccfg.codebook_size
        codes = tokens_to_codes(_put(feed["save_id"], cdev), ccfg, start)
        return [_i16(hifigan_decode(cparams, fsq_dequantize(codes, ccfg), ccfg))]

    return {
        "KaniTTS_Embed.onnx": StandIn([("input_ids", (1, "T"))], embed, wrap=wrap),
        "KaniTTS_Main.onnx": StandIn(
            kv_inputs + [("hidden_states", (1, "T", cfg.hidden_size)),
                         ("history_len", (1,)), ("ids_len", (1,))], main, wrap=wrap),
        "KaniTTS_Codec.onnx": StandIn([("save_id", (1, "N")), ("num_decode", (1,))], codec,
                                      wrap=wrap),
    }


def indextts_standins(params, cfg, wrap=None) -> dict:
    """B (text embed) / C (step embed) / E (a GPT step on a fresh cache)."""
    from ..kv.cache import KVCache
    from ..models.indextts import gpt_embed_mel, gpt_embed_text, gpt_step

    dev, dt = _placement(params)

    def b(feed):
        return [_np(gpt_embed_text(params, _put(feed["text_ids"], dev)))]

    def c(feed):
        return [_np(gpt_embed_mel(params, _put(feed["gpt_ids"], dev),
                                  int(feed["kv_seq_len"][0])))]

    def e(feed):
        kv = KVCache.create(cfg.gpt_layers, 1, cfg.gpt_heads, cfg.max_seq_len,
                            cfg.gpt_head_dim, dt, dev)
        hidden = feed["hidden_states"]
        logits, last, _ = gpt_step(params, _put(hidden, dev, dt), kv,
                                   _put(feed["repeat_penality"], dev), cfg)
        max_id = np.argmax(_np(logits), -1).astype(np.int64)
        pads = [np.zeros(1, np.float32)] * (2 * cfg.gpt_layers)
        return pads + [np.array([hidden.shape[1]], np.int64), _np(last), max_id]

    kv_ins = ([(f"in_key_{i}", (cfg.gpt_heads, cfg.gpt_head_dim, "T"))
               for i in range(cfg.gpt_layers)]
              + [(f"in_value_{i}", (cfg.gpt_heads, "T", cfg.gpt_head_dim))
                 for i in range(cfg.gpt_layers)])
    return {
        "IndexTTS_B.onnx": StandIn([("text_ids", (1, "T"))], b, wrap=wrap),
        "IndexTTS_C.onnx": StandIn([("gpt_ids", (1, 1)), ("kv_seq_len", (1,))], c, wrap=wrap),
        "IndexTTS_E.onnx": StandIn(
            kv_ins + [("history_len", (1,)), ("repeat_penality", (1, cfg.num_mel_codes)),
                      ("ids_len", (1,)), ("hidden_states", (1, "T", cfg.gpt_dim)),
                      ("attention_mask_flag", (1,))], e, wrap=wrap),
    }


def qwen_standins(params, cfg, cparams, ccfg, wrap=None) -> dict:
    """TTS_MAIN (a talker pass on a fresh cache, hidden and logits),
    TTS_PREDICTOR (stateful: a real cache threaded across calls, reset by
    a prefill of more than one position; every input projected through
    small_to_mtp), LmHead_g / Embed_D_g a group and TTS_DECODER."""
    from ..kv.cache import KVCache
    from ..models.qwen_codec import codec_decode
    from ..models.qwen_tts import qwen3_stack_step, talker_logits

    dev, dt = _placement(params)
    tcfg, pcfg = cfg.talker, cfg.predictor

    def main(feed):
        kv = KVCache.create(tcfg.num_layers, 1, tcfg.num_kv_heads, tcfg.max_seq_len,
                            tcfg.head_dim, dt, dev)
        s = feed["hidden_states"].shape[1]
        h, _ = qwen3_stack_step(params["talker"], _put(feed["hidden_states"], dev, dt), kv,
                                tcfg, params["rope_cos"][:s], params["rope_sin"][:s])
        pads = [np.zeros(1, np.float32)] * (2 * tcfg.num_layers)
        return pads + [_np(h), _np(talker_logits(params, h, cfg))]

    state = {"kv": None}

    def predictor(feed):
        hidden = _put(feed["hidden_states"], dev, dt)
        proj = torch.matmul(hidden, params["small_to_mtp"])
        if state["kv"] is None or hidden.shape[1] > 1:
            state["kv"] = KVCache.create(pcfg.num_layers, 1, pcfg.num_kv_heads,
                                         pcfg.max_seq_len, pcfg.head_dim, dt, dev)
        kv = state["kv"]
        pos, s = kv.length, hidden.shape[1]
        h, state["kv"] = qwen3_stack_step(params["predictor"], proj, kv, pcfg,
                                          params["pred_rope_cos"][pos:pos + s],
                                          params["pred_rope_sin"][pos:pos + s])
        return [np.zeros(1, np.float32)] * (2 * pcfg.num_layers) + [_np(h)]

    def decoder(feed):
        cdev, _ = _placement(cparams)
        codes = feed["codec_ids"].reshape(1, -1, ccfg.num_quantizers).astype(np.int32)
        return [_i16(codec_decode(cparams, _put(codes, cdev), ccfg))]

    kv_ins = ([(f"in_key_{i}", (1, pcfg.num_kv_heads, 1, pcfg.head_dim, "T"))
               for i in range(pcfg.num_layers)]
              + [(f"in_value_{i}", (1, pcfg.num_kv_heads, 1, "T", pcfg.head_dim))
                 for i in range(pcfg.num_layers)])
    table = {
        "Qwen_TTS_Main.onnx": StandIn(
            [(f"k_{i}", (1,)) for i in range(2 * tcfg.num_layers)]
            + [("hidden_states", (1, "T", tcfg.hidden_size)),
               ("rotary_cos", (1, "T", tcfg.head_dim)), ("rotary_sin", (1, "T", tcfg.head_dim)),
               ("attention_mask", (1, 1, "T", "T"))], main, wrap=wrap),
        "Qwen_TTS_Predictor.onnx": StandIn(
            kv_ins + [("hidden_states", (1, "T", tcfg.hidden_size)),
                      ("rotary_cos", (1, "T", pcfg.head_dim)),
                      ("rotary_sin", (1, "T", pcfg.head_dim)),
                      ("attention_mask", (1, 1, "T", "T"))], predictor, wrap=wrap),
        "Qwen_TTS_Decoder.onnx": StandIn([("codec_ids", (1, "N"))], decoder, wrap=wrap),
    }
    for g in range(cfg.num_code_groups - 1):
        def lm_head(feed, g=g):
            h = _put(feed["last_hidden_state"], dev, dt)
            return [_np(torch.matmul(h, params["lm_heads"][g]))]

        def embed_d(feed, g=g):
            tok = int(feed["input_ids"].reshape(-1)[0])
            return [_np(params["group_embeds"][g][tok])[None, None]]

        table[f"Qwen_LmHead_{g}.onnx"] = StandIn(
            [("last_hidden_state", (1, pcfg.hidden_size))], lm_head, wrap=wrap)
        table[f"Qwen_Embed_D_{g}.onnx"] = StandIn([("input_ids", (1, 1))], embed_d, wrap=wrap)
    return table


def voxcpm_standins(params, cfg, vae_params, wrap=None) -> dict:
    """Feat_Encoder (feat_embed, feat_cond) / Main (a dual-LM pass on fresh
    caches) / Feat_Decoder (the CFM from the fed noise) / VAE_Decoder."""
    from ..kv.cache import KVCache
    from ..models.voxcpm import cfm_feat_decoder, feat_encoder_cond, vae_decode, voxcpm_main_step

    dev, dt = _placement(params)
    n_kv = 2 * (cfg.base.num_layers + cfg.residual.num_layers)

    def feat_encoder(feed):
        fe, fc = feat_encoder_cond(params, _put(feed["audio_feat"], dev, dt), cfg)
        return [_np(fe), _np(fc)]

    def main(feed):
        b, r = cfg.base, cfg.residual
        base_kv = KVCache.create(b.num_layers, 1, b.num_kv_heads, b.max_seq_len, b.head_dim,
                                 dt, dev)
        res_kv = KVCache.create(r.num_layers, 1, r.num_kv_heads, r.max_seq_len, r.head_dim,
                                dt, dev)
        dit, stop, _, _ = voxcpm_main_step(
            params, _put(feed["hidden_states"], dev, dt), _put(feed["feat_embed"], dev, dt),
            int(feed["concat_text_len"][0]), base_kv, res_kv, cfg)
        return [np.zeros(1, np.float32)] * n_kv + [
            _np(dit), np.asarray(stop.cpu(), np.int64).reshape(1),
            np.zeros((1, cfg.patch_size, cfg.vae.latent_dim), np.float32)]

    def feat_decoder(feed):
        out = cfm_feat_decoder(params, _put(feed["random"], dev),
                               _put(feed["dit_hidden"], dev, dt),
                               _put(feed["feat_cond"], dev, dt), cfg)
        return [_np(out)]

    def vae_decoder(feed):
        vdev, _ = _placement(vae_params)
        return [_i16(vae_decode(vae_params, _put(feed["latent_pred"], vdev), cfg.vae))]

    b = cfg.base
    return {
        "VoxCPM_Feat_Encoder.onnx": StandIn(
            [("audio_feat", ("T", cfg.patch_size, cfg.vae.latent_dim))], feat_encoder,
            wrap=wrap),
        "VoxCPM_Main.onnx": StandIn(
            [(f"kv_{i}", (1,)) for i in range(n_kv)]
            + [("feat_embed", (1, "T", b.hidden_size)), ("concat_text_len", (1,)),
               ("hidden_states", (1, "T", b.hidden_size)), ("rotary_cos", (1, "T", b.head_dim)),
               ("rotary_sin", (1, "T", b.head_dim)), ("attention_mask", (1, 1, "T", "T"))],
            main, wrap=wrap),
        "VoxCPM_Feat_Decoder.onnx": StandIn(
            [("random", (1, cfg.patch_size, cfg.vae.latent_dim)),
             ("dit_hidden", (1, 1, cfg.estimator.hidden_size)),
             ("feat_cond", (2, cfg.patch_size, cfg.estimator.hidden_size)),
             ("cfg_value", (1,)), ("cfg_value_minus", (1,))], feat_decoder, wrap=wrap),
        "VoxCPM_VAE_Decoder.onnx": StandIn(
            [("latent_pred", (1, "T", cfg.vae.latent_dim))], vae_decoder, wrap=wrap),
    }
