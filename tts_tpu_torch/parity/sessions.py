"""Per-stage session parity drivers for the four AR families (counterpart
of tts_tpu/parity/sessions.py).

Wav-mode parity (run_reference.run_wav_family) only says pass/fail; these
drivers compare the port's stage functions against the reference's
exported ONNX graphs at matched inputs, so a mel-L1 failure localizes to
a stage immediately. Graph I/O contracts mirrored here:

- Kani:    Embed / Main / Codec graphs
  (Kani_TTS/Export_Kani_TTS.py:588,614-645,474-564):
  Main feed order = [*keys, *values, *convs, hidden_states, history_len,
  ids_len], outputs [*keys, *values, *convs, logits, kv_seq_len].
- IndexTTS: B (text embed), C (step embed), E (AR step), F (vocoder)
  (IndexTTS/Export_IndexTTS.py:368,389,435-459,292-314):
  E feed = [*keys, *values, history_len, repeat_penality, ids_len,
  hidden_states, attention_mask_flag].
- Qwen:    TTS_MAIN talker step, TTS_PREDICTOR 15-group frame loop
  (per-group LmHead_g / Embed_D_g sessions), TTS_DECODER codec decode
  (Qwen_TTS/Export_Qwen_TTS_ONNX.py:1696-1795):
  stack feed = [*keys, *values, hidden_states, rotary_cos, rotary_sin,
  attention_mask], outputs [*keys, *values, last_hidden(, logits)].
- VoxCPM:  Feat_Encoder_Cond, Main (dual-LM step), Feat_Decoder with
  MATCHED noise, VAE_Decoder
  (VoxCPM/v1.5/Export_VoxCPM_ONNX.py:813,882-897,920,938).

Each driver takes a dict of session objects (anything with
`.get_inputs()` -> [obj with .name/.shape] and `.run(None, feed)`), the
port's params/configs, and returns a list of StageDiff. KV-cache inputs are
zero-initialized from the session's declared shapes (dynamic time axes
resolve to the empty cache), then rebound positionally output->input
across steps exactly like the reference runtimes
(Inference_Kani_TTS_ONNX.py:344-351).

The inputs are drawn with `np.random.default_rng(seed)` in tts_tpu's
order, so both packages feed identical tensors. "Ours" runs on the device
the params lie on, in their dtype (on a card in bf16, the kernels' route);
codec and VAE waveforms become int16 through `audio/wav.to_pcm16`. KV
caches take the weights' dtype, as the pipelines' do (tts_tpu's Kani
driver keeps its cache in `init_state`'s bf16 default). The
Qwen predictor frame takes the pipeline's default decode route ("step":
kernel 12 where its gate holds; tts_tpu's driver calls the plain route,
which computes the same function).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["StageDiff", "kani_session_stages", "indextts_session_stages",
           "qwen_session_stages", "voxcpm_session_stages"]


@dataclass
class StageDiff:
    stage: str
    max_abs: float
    detail: str = ""

    @property
    def ok(self) -> bool:
        return self.max_abs <= 1e-2

    def line(self) -> str:
        flag = "PASS" if self.ok else "FAIL"
        return f"  {self.stage:24s} {flag} max|Δ|={self.max_abs:.3e} {self.detail}"


def _resolve_shape(shape, dyn: int = 0) -> tuple[int, ...]:
    """ONNX declared shape -> concrete: dynamic dims (str/None) become
    `dyn` (0 = empty cache axis)."""
    return tuple(d if isinstance(d, int) else dyn for d in shape)


def _feed(sess, pool: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Build a feed: named tensors from the pool; any input not in the
    pool (KV caches on the first call) zero-fills from its declared
    shape."""
    feed = {}
    for inp in sess.get_inputs():
        if inp.name in pool:
            feed[inp.name] = pool[inp.name]
        else:
            feed[inp.name] = np.zeros(_resolve_shape(inp.shape), np.float32)
    return feed


def _run_list(sess, tensors: list[np.ndarray]) -> list[np.ndarray]:
    """Feed positionally by the session's declared input order (the
    reference runtimes thread tensors positionally)."""
    names = [i.name for i in sess.get_inputs()]
    return sess.run(None, dict(zip(names, tensors)))


def _np(x) -> np.ndarray:
    """A tensor (any device or dtype) or array -> fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _diff(name: str, ours, theirs, detail: str = "") -> StageDiff:
    ours = _np(ours).reshape(-1)
    theirs = np.asarray(theirs, np.float32).reshape(-1)
    if ours.shape != theirs.shape:
        return StageDiff(name, float("inf"),
                         f"shape {ours.shape} vs {theirs.shape} {detail}")
    return StageDiff(name, float(np.max(np.abs(ours - theirs), initial=0.0)),
                     detail)


def _zero_kv_inputs(sess, pool: dict) -> list[np.ndarray]:
    """Zero tensors for every input NOT supplied in the pool, in declared
    order — the empty-cache prefix of a stack-step feed."""
    out = []
    for inp in sess.get_inputs():
        if inp.name not in pool:
            out.append(np.zeros(_resolve_shape(inp.shape), np.float32))
    return out


def _additive_causal_mask(s: int, kv_len: int) -> np.ndarray:
    """float additive mask (1, 1, S, kv_len): 0 where visible, -inf-ish
    where masked (the reference's int8 -128 triangle cast to float,
    Export_Qwen_TTS_ONNX.py:293)."""
    q = np.arange(s)[:, None] + (kv_len - s)
    k = np.arange(kv_len)[None, :]
    m = np.where(k <= q, 0.0, -65504.0).astype(np.float32)
    return m[None, None]


def _placement(tree) -> tuple[torch.device, torch.dtype]:
    """(device, dtype) of the first floating tensor of a params tree."""
    stack = [tree]
    while stack:
        node = stack.pop(0)
        if isinstance(node, torch.Tensor) and node.is_floating_point():
            return node.device, node.dtype
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    raise ValueError("no floating tensor in the params tree")


def _put(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a), device=device)
    return t if dtype is None else t.to(dtype)


def _pcm16(wav: torch.Tensor) -> torch.Tensor:
    """A waveform in [-1, 1] -> int16, through `to_pcm16`."""
    from ..audio.wav import to_pcm16

    return to_pcm16(torch.clamp(wav.float(), -1.0, 1.0) * 32767.0)


def _wav_diff(name: str, ours: torch.Tensor, theirs) -> StageDiff:
    return _diff(name, _pcm16(ours).float() / 32768,
                 np.asarray(theirs, np.float32).reshape(-1) / 32768)


# ------------------------------------------------------------------- Kani

@torch.no_grad()
def kani_session_stages(sessions: dict, params, cfg, cparams=None,
                        ccfg=None, seed: int = 0,
                        audio_tokens_start: int | None = None
                        ) -> list[StageDiff]:
    """Stages: embed, main_step (fresh cache), codec."""
    from ..models.kani import embed_tokens, init_state, kani_step
    dev, dt = _placement(params)
    rng = np.random.default_rng(seed)
    diffs = []

    ids = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int64)
    ours_embed = embed_tokens(params, _put(ids, dev))
    if "embed" in sessions:
        theirs = _run_list(sessions["embed"], [ids])[0]
        diffs.append(_diff("kani/embed", ours_embed, theirs))

    if "main" in sessions:
        sess = sessions["main"]
        pool = {"hidden_states": _np(ours_embed),
                "history_len": np.zeros(1, np.int64),
                "ids_len": np.array([ids.shape[1]], np.int64)}
        out = sess.run(None, _feed(sess, pool))
        # outputs = [*keys, *values, *convs, logits, kv_seq_len]
        theirs_logits = out[-2]
        logits, _ = kani_step(params, ours_embed, init_state(cfg, 1, dt, dev), cfg)
        diffs.append(_diff("kani/main_step", logits, theirs_logits))

    if "codec" in sessions and cparams is not None:
        from ..models.nanocodec import fsq_dequantize, hifigan_decode, tokens_to_codes

        start = (audio_tokens_start if audio_tokens_start is not None
                 else cfg.vocab_size - ccfg.num_groups * ccfg.codebook_size)
        frames = 6
        toks = (rng.integers(0, ccfg.codebook_size,
                             (1, frames * ccfg.num_groups))
                + np.tile(np.arange(ccfg.num_groups) * ccfg.codebook_size,
                          frames) + start).astype(np.int64)
        theirs = _run_list(sessions["codec"],
                           [toks, np.array([toks.shape[1]], np.int64)])[0]
        cdev, _ = _placement(cparams)
        codes = tokens_to_codes(_put(toks, cdev), ccfg, start)
        wav = hifigan_decode(cparams, fsq_dequantize(codes, ccfg), ccfg)
        diffs.append(_wav_diff("kani/codec", wav, theirs))
    return diffs


# --------------------------------------------------------------- IndexTTS

@torch.no_grad()
def indextts_session_stages(sessions: dict, params, cfg, seed: int = 0
                            ) -> list[StageDiff]:
    """Stages: text_embed (B), step_embed (C), gpt_step (E)."""
    from ..kv.cache import KVCache
    from ..models.indextts import gpt_embed_mel, gpt_embed_text, gpt_step
    dev, dt = _placement(params)
    rng = np.random.default_rng(seed)
    diffs = []

    text_ids = rng.integers(0, cfg.num_text_tokens, (1, 6)).astype(np.int64)
    if "b" in sessions:
        theirs = _run_list(sessions["b"], [text_ids])[0]
        ours = gpt_embed_text(params, _put(text_ids, dev))
        diffs.append(_diff("indextts/text_embed", ours, theirs))

    mel_id = np.array([[int(rng.integers(0, cfg.num_mel_codes))]], np.int64)
    if "c" in sessions:
        theirs = _run_list(
            sessions["c"], [mel_id, np.zeros(1, np.int64)])[0]
        ours = gpt_embed_mel(params, _put(mel_id, dev), 0)
        diffs.append(_diff("indextts/step_embed", ours, theirs))

    if "e" in sessions:
        hidden = rng.standard_normal(
            (1, 4, cfg.gpt_dim)).astype(np.float32)
        penalty = np.ones((1, cfg.num_mel_codes), np.float32)
        sess = sessions["e"]
        pool = {"hidden_states": hidden,
                "history_len": np.zeros(1, np.int64),
                "repeat_penality": penalty,        # reference's spelling
                "ids_len": np.array([hidden.shape[1]], np.int64),
                "attention_mask_flag": np.ones(1, np.float32)}
        out = sess.run(None, _feed(sess, pool))
        # outputs = [*keys, *values, kv_seq_len, last_hidden, max_id]
        theirs_hidden, theirs_id = out[-2], out[-1]
        kv = KVCache.create(cfg.gpt_layers, 1, cfg.gpt_heads,
                            cfg.max_seq_len, cfg.gpt_head_dim, dt, dev)
        logits, last, _ = gpt_step(params, _put(hidden, dev, dt), kv,
                                   _put(penalty, dev), cfg)
        diffs.append(_diff("indextts/gpt_step_hidden", last, theirs_hidden))
        diffs.append(_diff("indextts/gpt_step_argmax",
                           np.argmax(_np(logits), -1).astype(np.float32),
                           np.asarray(theirs_id, np.float32).reshape(-1)))
    return diffs


# ------------------------------------------------------------------- Qwen

@torch.no_grad()
def qwen_session_stages(sessions: dict, params, cfg, cparams=None,
                        ccfg=None, seed: int = 0) -> list[StageDiff]:
    """Stages: talker_step (TTS_MAIN), predictor_frame (TTS_PREDICTOR +
    LmHead_g + Embed_D_g loop, greedy; ours on the pipeline's default
    decode route), codec_decode (TTS_DECODER)."""
    from ..kv.cache import KVCache
    from ..models.qwen_tts import predictor_frame, qwen3_stack_step, talker_logits
    dev, dt = _placement(params)
    rng = np.random.default_rng(seed)
    diffs = []
    tcfg = cfg.talker

    hidden = rng.standard_normal((1, 3, tcfg.hidden_size)).astype(np.float32)
    rope_cos = _np(params["rope_cos"][:3])[None]
    rope_sin = _np(params["rope_sin"][:3])[None]
    if "main" in sessions:
        sess = sessions["main"]
        pool = {"hidden_states": hidden,
                "rotary_cos": rope_cos,
                "rotary_sin": rope_sin,
                "attention_mask": _additive_causal_mask(3, 3)}
        out = sess.run(None, _feed(sess, pool))
        # outputs = [*keys, *values, last_hidden, logits]
        theirs_hidden, theirs_logits = out[-2], out[-1]
        kv = KVCache.create(tcfg.num_layers, 1, tcfg.num_kv_heads,
                            tcfg.max_seq_len, tcfg.head_dim, dt, dev)
        h, _ = qwen3_stack_step(params["talker"], _put(hidden, dev, dt), kv, tcfg,
                                params["rope_cos"][:3], params["rope_sin"][:3])
        logits = talker_logits(params, h, cfg)
        diffs.append(_diff("qwen/talker_hidden", h, theirs_hidden))
        diffs.append(_diff("qwen/talker_logits", logits, theirs_logits))

    if "predictor" in sessions:
        talker_h = rng.standard_normal(
            (1, 1, tcfg.hidden_size)).astype(np.float32)
        tok0 = int(rng.integers(0, cfg.codec_vocab))
        # reference inner loop (Export_Qwen_TTS_ONNX.py:2485-2597):
        # prefill [talker_hidden ++ embed_b(tok0)], then 15 greedy steps
        emb0 = _np(params["talker_codec_embed"][tok0])[None, None]
        prefill = np.concatenate([talker_h, emb0], axis=1)
        pcos = _np(params["pred_rope_cos"])
        psin = _np(params["pred_rope_sin"])
        sess = sessions["predictor"]
        kv_n = sum(1 for i in sess.get_inputs()
                   if i.name not in ("hidden_states", "rotary_cos",
                                     "rotary_sin", "attention_mask"))
        kvs = _zero_kv_inputs(sess, {"hidden_states": 0, "rotary_cos": 0,
                                     "rotary_sin": 0, "attention_mask": 0})
        frame = [tok0]
        h_cur, kv_len = prefill, 0
        for g in range(cfg.num_code_groups - 1):
            s = h_cur.shape[1]
            feed = kvs + [h_cur.astype(np.float32),
                          pcos[kv_len:kv_len + s][None],
                          psin[kv_len:kv_len + s][None],
                          _additive_causal_mask(s, kv_len + s)]
            out = _run_list(sess, feed)
            kvs = list(out[:kv_n])
            last_hidden = out[kv_n]
            kv_len += s
            logits = _run_list(sessions[f"lm_head_{g}"], [last_hidden])[0]
            tok = int(np.argmax(logits.reshape(-1)))
            frame.append(tok)
            if g < cfg.num_code_groups - 2:
                h_cur = _run_list(sessions[f"embed_d_{g}"],
                                  [np.array([[tok]], np.int64)])[0]
        ours_frame, _ = predictor_frame(params, _put(talker_h, dev, dt),
                                        torch.tensor([tok0], dtype=torch.int32, device=dev),
                                        cfg, fused="step")
        diffs.append(_diff("qwen/predictor_frame", ours_frame,
                           np.asarray(frame, np.float32)))

    if "decoder" in sessions and cparams is not None:
        from ..models.qwen_codec import codec_decode

        frames = 4
        codes = rng.integers(0, ccfg.codebook_size,
                             (1, frames, ccfg.num_quantizers)).astype(np.int32)
        theirs = _run_list(
            sessions["decoder"],
            [codes.reshape(1, -1).astype(np.int64)])[0]
        cdev, _ = _placement(cparams)
        wav = codec_decode(cparams, _put(codes, cdev), ccfg)
        diffs.append(_wav_diff("qwen/codec_decode", wav, theirs))
    return diffs


# ----------------------------------------------------------------- VoxCPM

@torch.no_grad()
def voxcpm_session_stages(sessions: dict, params, cfg, vae_params=None,
                          seed: int = 0) -> list[StageDiff]:
    """Stages: feat_encoder_cond, main_step (dual-LM), feat_decoder with
    MATCHED noise, vae_decode."""
    from ..kv.cache import KVCache
    from ..models.voxcpm import (cfm_feat_decoder, feat_encoder_cond, vae_decode,
                                 voxcpm_main_step)
    dev, dt = _placement(params)
    rng = np.random.default_rng(seed)
    diffs = []

    t_patch = 3
    audio_feat = rng.standard_normal(
        (t_patch, cfg.patch_size, cfg.vae.latent_dim)).astype(np.float32)
    feat_embed, feat_cond = feat_encoder_cond(params, _put(audio_feat, dev, dt), cfg)
    if "feat_encoder" in sessions:
        out = _run_list(sessions["feat_encoder"], [audio_feat])
        diffs.append(_diff("voxcpm/feat_embed", feat_embed, out[0]))
        diffs.append(_diff("voxcpm/feat_cond", feat_cond, out[1]))

    s = 4
    hidden = rng.standard_normal(
        (1, s, cfg.base.hidden_size)).astype(np.float32)
    fe = rng.standard_normal(
        (1, s, cfg.base.hidden_size)).astype(np.float32)
    text_len = 2
    dit_hidden = None
    if "main" in sessions:
        sess = sessions["main"]
        pool = {"feat_embed": fe,
                "concat_text_len": np.array([text_len], np.int64),
                "hidden_states": hidden,
                "rotary_cos": _np(params["rope_cos"][:s])[None],
                "rotary_sin": _np(params["rope_sin"][:s])[None],
                "attention_mask": _additive_causal_mask(s, s)}
        out = sess.run(None, _feed(sess, pool))
        # outputs = [*kvs, dit_hidden, stop_flag, random]
        theirs_dit = out[-3]
        base_kv = KVCache.create(cfg.base.num_layers, 1,
                                 cfg.base.num_kv_heads, cfg.base.max_seq_len,
                                 cfg.base.head_dim, dt, dev)
        res_kv = KVCache.create(cfg.residual.num_layers, 1,
                                cfg.residual.num_kv_heads,
                                cfg.residual.max_seq_len,
                                cfg.residual.head_dim, dt, dev)
        dit_hidden, _, _, _ = voxcpm_main_step(
            params, _put(hidden, dev, dt), _put(fe, dev, dt), text_len,
            base_kv, res_kv, cfg)
        diffs.append(_diff("voxcpm/main_dit_hidden", dit_hidden, theirs_dit))

    if "feat_decoder" in sessions:
        noise = rng.standard_normal(
            (1, cfg.patch_size, cfg.vae.latent_dim)).astype(np.float32)
        dh = (_np(dit_hidden) if dit_hidden is not None else
              rng.standard_normal(
                  (1, 1, cfg.estimator.hidden_size)).astype(np.float32))
        cfg_val = cfg.cfg_value
        theirs = _run_list(
            sessions["feat_decoder"],
            [noise, dh, _np(feat_cond),
             np.array([cfg_val], np.float32),
             np.array([1.0 - cfg_val], np.float32)])[0]
        ours = cfm_feat_decoder(params, _put(noise, dev), _put(dh, dev, dt),
                                feat_cond, cfg)
        diffs.append(_diff("voxcpm/feat_decoder", ours, theirs))

    if "vae_decoder" in sessions and vae_params is not None:
        latents = rng.standard_normal(
            (1, 2 * cfg.patch_size, cfg.vae.latent_dim)).astype(np.float32)
        theirs = _run_list(sessions["vae_decoder"], [latents])[0]
        vdev, _ = _placement(vae_params)
        wav = vae_decode(vae_params, _put(latents, vdev), cfg.vae)
        diffs.append(_wav_diff("voxcpm/vae_decode", wav, theirs))
    return diffs
