"""The port's slot servers (tts_tpu_torch/serving/continuous*.py) against
tts_tpu on the CPU, fp32 on both sides, at the small configs of tts_tpu's
own serving tests (tests/test_continuous*.py): tts_tpu's init_params ->
params_from_jax, then

  * request A admitted into an empty server and request B admitted while A
    decodes (the worker held after its first chunk until B is queued) give
    the token ids (Kani, IndexTTS), frame codes (Qwen) or latents (VoxCPM,
    within 1e-4 rel L2) of tts_tpu's solo pipeline, and its int16 audio;
  * one request through tts_tpu's slot server and through the port's gives
    the same count and audio;
  * a Kani config at head dim 64 walks kernel 11's route (its twin here)
    under the masked, spliced batch;
  * streams, `continuous_server` behind `serve_http`, a router over two
    Kani servers;
  * the IndexTTS mel-position refusal, `continuous_server("f5")` without
    its reference refused, and `pipelines_for_devices` on explicit CPU
    devices;
  * F5's slot server (a diffusion decode: each row at its own NFE step)
    against tts_tpu's slot server and the port's solo `synthesize` within
    F5_LSB, a mid-flight admission, a queue past the slots, the bucket
    refusals, and `continuous_server("f5")` over HTTP and over a router.

Audio: the same codes go through the codec in both packages, which agree
to ~1e-6 in float; int16 truncation may put a sample on an integer
boundary one LSB apart, so AUDIO_LSB = 1 for every family. VoxCPM
injects tts_tpu's per-request jax.random draws as `noise=`.
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu_torch.weights.convert import params_from_jax

AUDIO_LSB = 1
F5_LSB = 2                # F5 audio: float waveforms through another route
LAT_TOL = 1e-4            # VoxCPM latents, rel L2
RESULT_S = 120            # every Future.result bound


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conv(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu", torch.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _same_audio(got, ref, lsb):
    assert got.dtype == np.int16 and got.shape == ref.shape and ref.size
    assert np.abs(ref.astype(np.int32)).max() > 1000
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= lsb


# ------------------------------------------------------------ the families

class Kani:
    """tests/test_continuous.py's config (stop -1: rows run to their caps),
    a repetition penalty on, the codec 4000x louder."""

    slot_kw = dict(slots=2, chunk=4, prompt_bucket=16)
    key = "save"
    reqs = ((np.array([[5, 17, 33]], np.int32), 24), (np.array([[8, 9, 11]], np.int32), 12))

    def __init__(self, hd64: bool = False):
        from tts_tpu.models import kani as jk
        from tts_tpu.models import nanocodec as jnc
        from tts_tpu_torch.models import kani as tk
        from tts_tpu_torch.models import nanocodec as tnc

        lm = dict(hidden_size=32, num_heads=2, num_kv_heads=1, head_dim=16, ffn_dim=64,
                  vocab_size=128, layer_types=("conv", "attn", "conv", "attn"),
                  max_seq_len=512, stop_token=-1)
        if hd64:
            # tests/test_torch_kani.py's head-dim-64 config: kernel 11's route
            lm.update(hidden_size=128, num_heads=16, num_kv_heads=8, head_dim=64,
                      ffn_dim=192, vocab_size=64, max_seq_len=256)
        codec = dict(base_channels=16, up_sample_rates=(2, 2), kernel_sizes=(3,),
                     dilations=(1, 3), activation="half_snake")
        self.jc, self.tc = jk.KaniConfig(**lm), tk.KaniConfig(**lm)
        self.jcc, self.tcc = jnc.NanoCodecConfig(**codec), tnc.NanoCodecConfig(**codec)
        self.jp = jk.init_params(self.jc, jax.random.key(0))
        self.jcp = jnc.init_params(self.jcc, jax.random.key(1))
        self.jcp["post_conv"]["w"] = self.jcp["post_conv"]["w"] * 4000.0
        self.tp, self.tcp = _conv(self.jp), _conv(self.jcp)

    def pipes(self):
        from tts_tpu.runtime.kani import KaniDecodeConfig as JD
        from tts_tpu.runtime.kani import KaniPipeline as JP
        from tts_tpu_torch.runtime.kani import KaniDecodeConfig, KaniPipeline

        d = dict(max_new_tokens=40, repeat_penalty=0.8)
        jpipe = JP(self.jp, self.jc, self.jcp, self.jcc, JD(**d), audio_tokens_start=0)
        # tts_tpu's token buffer, read where its program hands it to the codec
        self.got, real = [], jpipe._vocode_in_graph

        def vocode(save_ids, num, codec_params, fbuf):
            jax.debug.callback(lambda t, n: self.got.append(np.asarray(t)[0, :int(n)]),
                               save_ids, num)
            return real(save_ids, num, codec_params, fbuf)

        jpipe._vocode_in_graph = vocode
        return jpipe, KaniPipeline(self.tp, self.tc, self.tcp, self.tcc,
                                   KaniDecodeConfig(**d), audio_tokens_start=0)

    def solo(self, jpipe, req):
        ids, cap = req
        wav, st = jpipe.synthesize_ids(ids, max_new_tokens=cap)
        jax.effects_barrier()
        assert st["tokens"] == cap == len(self.got[-1])
        return wav, st["tokens"], self.got[-1]

    def submit(self, srv, req):
        return srv.submit(req[0], max_new_tokens=req[1])

    def stream(self, srv, req):
        return srv.submit_stream(req[0], max_new_tokens=40, window=4, left_context=2)

    def jax_slot_server(self, jpipe):
        from tts_tpu.serving.continuous import KaniSlotServer

        return KaniSlotServer(jpipe, **self.slot_kw)

    def port_slot_server(self, tpipe):
        from tts_tpu_torch.serving.continuous import KaniSlotServer

        return KaniSlotServer(tpipe, **self.slot_kw)


class Qwen:
    """tests/test_continuous_qwen.py's config (EOS -1), the codec 3e4x
    louder."""

    slot_kw = dict(slots=2, chunk=4, prompt_bucket=32, max_seq_len=256)
    key = "frames"

    def __init__(self):
        from tts_tpu.models import qwen_codec as jcm
        from tts_tpu.models import qwen_tts as jq
        from tts_tpu_torch.models import qwen_codec as tcm
        from tts_tpu_torch.models import qwen_tts as tq

        def cfg(m):
            s = m.Qwen3StackConfig
            return m.QwenTTSConfig(
                talker=s(hidden_size=32, num_heads=2, num_kv_heads=1, head_dim=16,
                         ffn_dim=64, num_layers=2, max_seq_len=1024),
                predictor=s(hidden_size=24, num_heads=2, num_kv_heads=1, head_dim=12,
                            ffn_dim=48, num_layers=2, max_seq_len=32),
                codec_vocab=64, group_vocab=32, num_code_groups=4, codec_eos_token_id=-1,
                codec_bos_id=61, codec_pad_id=60, codec_think_id=59, codec_think_bos_id=58,
                codec_think_eos_id=57, tts_bos_token_id=97, tts_eos_token_id=98,
                tts_pad_token_id=99, text_vocab=100, text_hidden=16)

        codec = dict(num_quantizers=4, codebook_size=32, codebook_dim=16, rvq_dim=8,
                     latent_dim=24, decoder_dim=32, upsampling_ratios=(2,),
                     upsample_rates=(4, 2), hidden_size=24, num_heads=2, num_kv_heads=2,
                     head_dim=12, ffn_dim=48, num_layers=2, max_seq_len=64)
        self.jc, self.tc = cfg(jq), cfg(tq)
        self.jcc = jcm.QwenCodecDecoderConfig(**codec)
        self.tcc = tcm.QwenCodecDecoderConfig(**codec)
        self.jp = {**jq.init_talker_params(self.jc, jax.random.key(0)),
                   **jq.init_predictor_params(self.jc, jax.random.key(1))}
        self.jcp = jcm.init_decoder_params(self.jcc, jax.random.key(2))
        self.jcp["dec_post"]["w"] = self.jcp["dec_post"]["w"] * 3e4
        self.tp, self.tcp = _conv(self.jp), _conv(self.jcp)
        self.reqs = tuple((*self._request(seed), cap) for seed, cap in ((1, 12), (3, 8)))

    def _request(self, seed, p=7, tt=5):
        rng = np.random.default_rng(seed)
        h = self.jc.talker.hidden_size
        return (rng.normal(size=(1, p, h)).astype(np.float32) * 0.1,
                rng.normal(size=(1, tt, h)).astype(np.float32) * 0.1)

    def pipes(self):
        from tts_tpu.runtime.qwen import QwenDecodeConfig as JD
        from tts_tpu.runtime.qwen import QwenTTSPipeline as JP
        from tts_tpu_torch.runtime.qwen import QwenDecodeConfig, QwenTTSPipeline

        self.max_frames = 12
        return (JP(self.jp, self.jc, self.jcp, self.jcc, JD(max_frames=12)),
                QwenTTSPipeline(self.tp, self.tc, self.tcp, self.tcc,
                                QwenDecodeConfig(max_frames=12)))

    def solo(self, jpipe, req):
        prefill, trailing, cap = req
        jpipe.dcfg = dataclasses.replace(jpipe.dcfg, max_frames=cap)
        jpipe._decode_fn = None
        got = []
        real = jpipe._codec_dev_fn

        def codec_fn(fb, nlive=None):
            run = real(fb, nlive)

            def rec(codec_params, frames, num):
                got.append(np.asarray(frames)[:int(num)])
                return run(codec_params, frames, num)
            return rec

        jpipe._codec_dev_fn = codec_fn
        try:
            wav, st = jpipe.synthesize_from_prefill(prefill, trailing)
        finally:
            del jpipe._codec_dev_fn
            jpipe.dcfg = dataclasses.replace(jpipe.dcfg, max_frames=self.max_frames)
            jpipe._decode_fn = None
        assert st["frames"] == cap
        return wav, st["frames"], got[-1]

    def submit(self, srv, req):
        return srv.submit(req[0], req[1], max_frames=req[2])

    def stream(self, srv, req):
        return srv.submit_stream(req[0], req[1], max_frames=req[2], window=6, left_context=2)

    def jax_slot_server(self, jpipe):
        from tts_tpu.serving.continuous_qwen import QwenSlotServer

        return QwenSlotServer(jpipe, **self.slot_kw)

    def port_slot_server(self, tpipe):
        from tts_tpu_torch.serving.continuous_qwen import QwenSlotServer

        return QwenSlotServer(tpipe, **self.slot_kw)


class IndexTTS:
    """tests/test_continuous_indextts.py's config (stop -1), the vocoder
    300x louder, the conditioning of tts_tpu's encode_reference on both
    sides."""

    slot_kw = dict(slots=2, chunk=4, text_bucket=16, max_gen=16, max_seq_len=256)
    key = "save"
    reqs = ((np.array([[5, 9, 13]], np.int32), 16), (np.array([[2, 7, 4]], np.int32), 10))

    def __init__(self):
        from tts_tpu.models import bigvgan as jbv
        from tts_tpu.models import indextts as ji
        from tts_tpu_torch.models import bigvgan as tbv
        from tts_tpu_torch.models import indextts as ti

        tiny = dict(enc_dim=32, enc_heads=2, enc_ff_dim=64, enc_layers=2, enc_conv_kernel=7,
                    num_latents=4, perceiver_heads=2, perceiver_dim_head=8, n_mels=24,
                    ecapa_channels=16, ecapa_attn_channels=8, res2net_scale=4,
                    se_channels=8, speaker_embed_dim=12, gpt_dim=32, gpt_heads=2,
                    gpt_layers=2, num_mel_codes=64, num_text_tokens=50,
                    max_text_tokens=32, max_mel_tokens=32, max_seq_len=512,
                    stop_token=-1, start_mel_token=62)
        self.jc, self.tc = ji.IndexTTSConfig(**tiny), ti.IndexTTSConfig(**tiny)
        voc = dict(num_mels=32, upsample_initial_channel=16, upsample_rates=(4, 2),
                   upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
                   resblock_dilation_sizes=((1, 3),), use_tanh_at_final=True,
                   use_bias_at_final=True)
        self.jv, self.tv = jbv.BigVGANConfig(**voc), tbv.BigVGANConfig(**voc)
        ks = jax.random.split(jax.random.key(0), 8)
        c0 = self.jv.upsample_initial_channel
        bv = jbv.init_params(self.jv, ks[4])
        bv["conv_post"]["w"] = bv["conv_post"]["w"] * 300.0
        self.jp = {
            "conformer": ji.init_conformer_params(self.jc, ks[0]),
            "perceiver": ji.init_perceiver_params(self.jc, ks[1]),
            "ecapa": ji.init_ecapa_params(self.jc, ks[2]),
            "gpt": ji.init_gpt_params(self.jc, ks[3]),
            "bigvgan": bv,
            "cond_layer": {"w": jax.random.normal(ks[5], (12, c0)) * 0.5,
                           "b": jnp.zeros((c0,))},
            "conds": [{"w": jax.random.normal(ks[6], (12, c)) * 0.5, "b": jnp.zeros((c,))}
                      for c in self.jv.stage_channels],
        }
        self.tp = _conv(self.jp)

    def pipes(self):
        from tts_tpu.runtime.indextts import IndexTTSPipeline as JP
        from tts_tpu_torch.runtime.indextts import IndexTTSPipeline

        kw = dict(sample_rate=8000, n_fft=256, hop=64)
        jpipe = JP(self.jp, self.jc, self.jv, **kw)
        audio = (np.random.default_rng(0).standard_normal(4000) * 3000).astype(np.int16)
        self.jref = jpipe.encode_reference(audio)
        self.tref = (_t(self.jref[0]), _t(self.jref[1]), [_t(c) for c in self.jref[2]])
        return jpipe, IndexTTSPipeline(self.tp, self.tc, self.tv, **kw)

    def solo(self, jpipe, req):
        ids, cap = req
        got = []
        real = jpipe._decode_fn

        def dec_fn(tb, max_gen):
            run = real(tb, max_gen)

            def rec(*a):
                hiddens, num, save = run(*a)
                got.append(np.asarray(save).reshape(-1)[:int(num)])
                return hiddens, num, save
            return rec

        jpipe._decode_fn = dec_fn
        try:
            # the slot server's buffer is max_gen 16: the solo vocoder bucket
            # (8-frame steps up to max_gen) is the same at these lengths
            wav, st = jpipe.synthesize_ids(ids, self.jref, max_gen=cap)
        finally:
            del jpipe._decode_fn
        assert st.tokens == cap
        return wav, st.tokens, got[-1]

    def submit(self, srv, req):
        ref = self.jref if srv.__module__.startswith("tts_tpu.") else self.tref
        return srv.submit(req[0], ref, max_gen=req[1])

    def jax_slot_server(self, jpipe):
        from tts_tpu.serving.continuous_indextts import IndexTTSSlotServer

        return IndexTTSSlotServer(jpipe, **self.slot_kw)

    def port_slot_server(self, tpipe):
        from tts_tpu_torch.serving.continuous_indextts import IndexTTSSlotServer

        return IndexTTSSlotServer(tpipe, **self.slot_kw)


class VoxCPM:
    """tests/test_voxcpm.py's TINY, min_latents = max_latents (the random
    stop head cannot end a row early), the VAE 300x louder; each request
    carries tts_tpu's draws for its seed."""

    slot_kw = dict(slots=2, chunk=2, prompt_bucket=16, max_seq_len=128)
    key = "latents"
    LATENTS = 8

    def __init__(self):
        from tts_tpu.models import voxcpm as jv
        from tts_tpu_torch.models import voxcpm as tv

        def cfg(m):
            s = m.LlamaStackConfig
            return m.VoxCPMConfig(
                base=s(hidden_size=32, num_heads=2, num_kv_heads=1, head_dim=16, ffn_dim=64,
                       num_layers=2, max_seq_len=512),
                residual=s(hidden_size=32, num_heads=2, num_kv_heads=1, head_dim=16,
                           ffn_dim=64, num_layers=1, max_seq_len=512),
                feat_encoder=s(hidden_size=24, num_heads=2, num_kv_heads=1, head_dim=12,
                               ffn_dim=48, num_layers=1, max_seq_len=8),
                estimator=s(hidden_size=24, num_heads=2, num_kv_heads=1, head_dim=12,
                            ffn_dim=48, num_layers=1, max_seq_len=16),
                vae=m.VaeConfig(d_model=4, latent_dim=8, strides=(2, 4), decoder_channels=16),
                patch_size=4, chunk_size=8, fsq_dim=8, vocab_size=128, audio_start_id=101,
                cfm_steps=4)

        self.jc, self.tc = cfg(jv), cfg(tv)
        self.jp = jv.init_params(self.jc, jax.random.key(0))
        self.jvae = jv.init_vae_params(self.jc.vae, jax.random.key(1))
        self.jvae["dec"]["post"]["w"] = self.jvae["dec"]["post"]["w"] * 300.0
        self.tp, self.tvae = _conv(self.jp), _conv(self.jvae)
        self.reqs = ((np.array([[5, 9]], np.int32), np.array([[11, 3, 7]], np.int32), 5),
                     (np.array([[2]], np.int32), np.array([[8, 1, 4, 9]], np.int32), 9))

    def pipes(self):
        from tts_tpu.runtime.voxcpm import VoxCPMDecodeConfig as JD
        from tts_tpu.runtime.voxcpm import VoxCPMPipeline as JP
        from tts_tpu_torch.runtime.voxcpm import VoxCPMDecodeConfig, VoxCPMPipeline

        d = dict(max_latents=self.LATENTS, min_latents=self.LATENTS, seed=11)
        return (JP(self.jp, self.jc, self.jvae, JD(**d)),
                VoxCPMPipeline(self.tp, self.tc, self.tvae, VoxCPMDecodeConfig(**d)))

    def noise(self, seed):
        """tts_tpu's per-request draws: a split of the running key, then a
        normal, a latent."""
        key, out = jax.random.key(seed), []
        for _ in range(self.LATENTS):
            key, sub = jax.random.split(key)
            out.append(np.asarray(jax.random.normal(
                sub, (1, self.jc.patch_size, self.jc.vae.latent_dim))))
        return _t(np.stack(out))

    def solo(self, jpipe, req):
        import tts_tpu.runtime.voxcpm as jrv

        p_ids, t_ids, seed = req
        got = []
        real = jrv.vae_decode

        def vae_decode(params, latents, cfg, **kw):
            jax.debug.callback(lambda x: got.append(np.asarray(x)), latents)
            return real(params, latents, cfg, **kw)

        jrv.vae_decode = vae_decode
        try:
            jpipe._dec_cache.clear()
            wav, st = jpipe.synthesize_ids(p_ids, t_ids, seed=seed)
            jax.effects_barrier()
        finally:
            jrv.vae_decode = real
            jpipe._dec_cache.clear()
        n = st["latents"]
        assert n == self.LATENTS
        lat = got[-1].reshape(-1, self.jc.patch_size, self.jc.vae.latent_dim)[:n]
        return wav, n, lat

    def submit(self, srv, req):
        p_ids, t_ids, seed = req
        if srv.__module__.startswith("tts_tpu."):
            return srv.submit(p_ids, t_ids, seed=seed)
        return srv.submit(p_ids, t_ids, noise=self.noise(seed))

    def stream(self, srv, req):
        p_ids, t_ids, seed = req
        if srv.__module__.startswith("tts_tpu."):
            return srv.submit_stream(p_ids, t_ids, seed=seed, window=3)
        return srv.submit_stream(p_ids, t_ids, noise=self.noise(seed), window=3)

    def jax_slot_server(self, jpipe):
        from tts_tpu.serving.continuous_voxcpm import VoxCPMSlotServer

        return VoxCPMSlotServer(jpipe, **self.slot_kw)

    def port_slot_server(self, tpipe):
        from tts_tpu_torch.serving.continuous_voxcpm import VoxCPMSlotServer

        return VoxCPMSlotServer(tpipe, **self.slot_kw)


FAMILIES = {"kani": Kani, "kani_hd64": lambda: Kani(hd64=True), "qwen": Qwen,
            "indextts": IndexTTS, "voxcpm": VoxCPM}


@pytest.fixture(scope="module", params=list(FAMILIES))
def fam(request):
    f = FAMILIES[request.param]()
    f.name = request.param
    f.jpipe, f.tpipe = f.pipes()
    return f


def _recorded(srv, key: str) -> dict:
    """Record each finished row's codes (s[key][row, :n]) by its future."""
    got = {}
    real = srv._finalize

    def finalize(s, b, n):
        got[s["reqs"][b].fut] = s[key][b, :n].clone()
        return real(s, b, n)

    srv._finalize = finalize
    return got


def _hold_after_first_chunk(srv):
    """Hold the worker after its first chunk until `go` is set, so a
    request queued meanwhile is admitted mid-decode."""
    first, go = threading.Event(), threading.Event()
    real = srv._post_chunk

    def post(s):
        real(s)
        if not first.is_set():
            first.set()
            go.wait(RESULT_S)

    srv._post_chunk = post
    return first, go


def _wait_first_chunk(first, fut) -> None:
    """Wait for the held worker's first chunk; a worker that failed before
    it fails the test at once."""
    deadline = time.monotonic() + RESULT_S
    while not first.wait(0.05):
        if fut.done():
            fut.result(timeout=0)
        assert time.monotonic() < deadline, "the first chunk never ran"


def _check_codes(fam, got, ref):
    got = got.numpy()
    if fam.key == "latents":
        assert got.shape == ref.shape and _rel(got, ref) < LAT_TOL
    else:
        np.testing.assert_array_equal(got, ref)


def test_slot_server_matches_jax_solo(fam, monkeypatch):
    """A alone, B admitted mid-decode: each gives tts_tpu's solo codes and
    audio."""
    calls = {"n": 0}
    if fam.name == "kani_hd64":
        import tts_tpu_torch.models.kani as mk

        real = mk.fused_qkv_rope

        def counted(*a, **k):
            calls["n"] += 1
            return real(*a, **k)

        monkeypatch.setattr(mk, "fused_qkv_rope", counted)
    solo = [fam.solo(fam.jpipe, r) for r in fam.reqs]
    srv = fam.port_slot_server(fam.tpipe)
    try:
        codes = _recorded(srv, fam.key)
        first, go = _hold_after_first_chunk(srv)
        fut_a = fam.submit(srv, fam.reqs[0])
        _wait_first_chunk(first, fut_a)
        fut_b = fam.submit(srv, fam.reqs[1])
        go.set()
        outs = [fut_a.result(timeout=RESULT_S), fut_b.result(timeout=RESULT_S)]
        assert srv.stats.admissions_mid_decode == 1
        assert srv.stats.snapshot()["completed"] == 2
    finally:
        go.set()
        srv.close()
    for (wav, n), fut, (jwav, jn, jcodes) in zip(outs, (fut_a, fut_b), solo):
        assert n == jn
        _check_codes(fam, codes[fut], jcodes)
        _same_audio(wav, jwav, AUDIO_LSB)
    if fam.name == "kani_hd64":
        # every attention layer's step of every chunk took kernel 11's route
        steps = srv.stats.chunks * srv.chunk
        assert calls["n"] == fam.tc.num_attn_layers * steps > 0


def test_single_request_matches_jax_slot_server(fam):
    """One request through tts_tpu's slot server and through the port's."""
    outs = []
    for make, pipe in ((fam.jax_slot_server, fam.jpipe), (fam.port_slot_server, fam.tpipe)):
        srv = make(pipe)
        try:
            outs.append(fam.submit(srv, fam.reqs[0]).result(timeout=RESULT_S))
        finally:
            srv.close()
    (jwav, jn), (wav, n) = outs
    assert n == jn
    _same_audio(wav, np.asarray(jwav), AUDIO_LSB)


def test_stream_matches_jax_slot_server(fam):
    """submit_stream through tts_tpu's slot server and the port's: the same
    chunks (windowed codec decodes with their left context dropped).
    IndexTTS streams in neither package (its BigVGAN is not causal)."""
    if not hasattr(fam, "stream"):
        from tts_tpu.serving.continuous_indextts import IndexTTSSlotServer as J
        from tts_tpu_torch.serving.continuous_indextts import IndexTTSSlotServer as P

        assert not hasattr(J, "submit_stream") and not hasattr(P, "submit_stream")
        return
    outs = []
    for make, pipe in ((fam.jax_slot_server, fam.jpipe), (fam.port_slot_server, fam.tpipe)):
        srv = make(pipe)
        try:
            handle = fam.stream(srv, fam.reqs[0])
            chunks = []
            box = threading.Thread(target=lambda: chunks.extend(handle), daemon=True)
            box.start()
            box.join(RESULT_S)
            assert not box.is_alive(), "the stream never ended"
            outs.append(chunks)
        finally:
            srv.close()
    ref, got = outs
    assert len(got) == len(ref) > 1
    for a, b in zip(got, ref):
        _same_audio(a, np.asarray(b), AUDIO_LSB)


BODIES = {"kani": {"ids": [[5, 17, 33]]}, "kani_hd64": {"ids": [[5, 17, 33]]},
          "qwen": {"ids": [[3, 9, 5, 7]], "language_id": 0},
          "indextts": {"ids": [[5, 9, 13]]}, "voxcpm": {"ids": [[11, 3, 7]], "prompt_ids": [[5, 9]]}}


def test_family_server_over_http(fam):
    """continuous_server(family) behind serve_http: a POST /synthesize
    returns the WAV of the same request submitted to the server directly
    (within AUDIO_LSB)."""
    import http.client
    import io
    import json
    import wave

    from tts_tpu_torch.serving.families import continuous_server
    from tts_tpu_torch.serving.server import serve_http

    family = fam.name.split("_")[0]
    kw = dict(ref=fam.tref) if family == "indextts" else {}
    slot_kw = {k: v for k, v in fam.slot_kw.items() if k not in ("slots", "max_gen")}
    tts = continuous_server(family, fam.tpipe, slots=2, max_tokens=16, **kw, **slot_kw)
    httpd = serve_http(tts, port=0)
    try:
        body = BODIES[fam.name]
        direct = tts.submit(tts.request_from_json(body)).result(timeout=RESULT_S)[0]
        conn = http.client.HTTPConnection(*httpd.server_address, timeout=RESULT_S)
        conn.request("POST", "/synthesize", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        with wave.open(io.BytesIO(resp.read())) as w:
            assert w.getframerate() == tts.sample_rate
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        conn.close()
        # the second request sits at a later shared position: the same codes,
        # float sums in another order
        assert pcm.shape == direct.shape and pcm.size
        assert np.abs(pcm.astype(np.int32) - direct.astype(np.int32)).max() <= AUDIO_LSB
        assert tts.stats()["completed"] == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        tts.close()


# ------------------------------------------------------------ the edges

def test_indextts_refuses_positions_past_the_table():
    """tts_tpu clamps mel_pos past its table; the port refuses the cap."""
    fam = IndexTTS()
    _, tpipe = fam.pipes()
    from tts_tpu_torch.serving.continuous_indextts import IndexTTSSlotServer

    table = tpipe.params["gpt"]["mel_pos"].shape[0]
    with pytest.raises(ValueError, match="mel positions"):
        IndexTTSSlotServer(tpipe, max_gen=table + 1, max_seq_len=512)
    srv = IndexTTSSlotServer(tpipe, slots=1, chunk=4, text_bucket=16, max_gen=16,
                             max_seq_len=256, ref=fam.tref)
    try:
        with pytest.raises(ValueError, match="mel positions"):
            srv.submit(np.array([[5, 9]], np.int32), max_gen=table + 1)
        assert srv.stats.requests == 0
    finally:
        srv.close()


def test_continuous_server_f5_raises():
    """F5 without its reference audio and text is refused, as in tts_tpu;
    an unknown family too."""
    from tts_tpu_torch.serving.families import continuous_server

    with pytest.raises(ValueError, match="ref_audio"):
        continuous_server("f5", object())
    with pytest.raises(ValueError, match="unknown family"):
        continuous_server("nope", object())


def test_pipelines_for_devices_on_cpu_devices():
    """Explicit CPU devices: one clone a device, params moved (here: the
    same device), configs shared; no CUDA device is taken silently."""
    from tts_tpu_torch.serving.devices import (pipeline_device, pipelines_for_devices,
                                               replicate_pipeline)

    fam = Kani()
    _, tpipe = fam.pipes()
    clones = pipelines_for_devices(tpipe, [torch.device("cpu"), "cpu"])
    assert len(clones) == 2
    for c in clones:
        assert c is not tpipe and c.cfg is tpipe.cfg
        assert pipeline_device(c) == torch.device("cpu") == c.device
        assert c.params["embed"].device.type == "cpu"
        assert c.params["layers"][1]["wqkv"].shape == tpipe.params["layers"][1]["wqkv"].shape
    # a clone's params are its own tree: replacing a leaf leaves the source alone
    r = replicate_pipeline(tpipe, "cpu")
    r.params["embed"] = None
    assert tpipe.params["embed"] is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipelines_for_devices(tpipe)


def test_kani_router_over_two_servers():
    """continuous_server over two pipelines (explicit CPU devices): one slot
    server each behind a SlotRouter; every request completes with the solo
    tokens' audio, both servers take some, and a routed submit keeps its
    server-side deadline."""
    from tts_tpu_torch.serving.devices import pipelines_for_devices
    from tts_tpu_torch.serving.families import continuous_server

    fam = Kani()
    jpipe, tpipe = fam.pipes()
    ref = fam.solo(jpipe, (fam.reqs[0][0], 16))
    tts = continuous_server("kani", pipelines_for_devices(tpipe, ["cpu", "cpu"]), slots=2,
                            max_tokens=16, chunk=4, prompt_bucket=16)
    try:
        futs = [tts.submit(fam.reqs[0][0], deadline_s=RESULT_S) for _ in range(4)]
        outs = [f.result(timeout=RESULT_S) for f in futs]
        st = tts.stats()
    finally:
        tts.close()
    assert st["servers"] == 2 and all(p["completed"] >= 1 for p in st["per_server"])
    for wav, n in outs:
        assert n == ref[1]
        assert np.abs(wav.astype(np.int32) - ref[0].astype(np.int32)).max() <= AUDIO_LSB


# ------------------------------------------------------------ F5

class F5:
    """tests/test_continuous_f5.py's setup at head dim 64 (kernel 1's route,
    its twin here, T 128) with the vocoder louder (magnitude bias e^3):
    frames=128 is the bucket _prepare picks solo, so a slot request's audio
    is its solo synthesize's. tts_tpu's per-request jax.random draw goes to
    the port as noise=."""

    CFG = dict(dim=128, depth=2, heads=2, head_dim=64, ff_mult=2, text_dim=32,
               conv_layers=1, conv_mult=2, n_mels=16, vocab_size=20, nfe_steps=8,
               n_fft=256, hop=64, win_length=256, max_signal_len=128, freq_embed_dim=16)
    VOC = dict(input_channels=16, dim=32, intermediate_dim=64, num_layers=2, n_fft=256,
               hop=64)
    VOCAB = {c: i for i, c in enumerate("abcdefghij ")}
    slot_kw = dict(chunk_steps=2, frames=128, audio_bucket=32768, text_bucket=64)
    REF = "abc def"

    def __init__(self):
        from tts_tpu.models import f5 as jf5
        from tts_tpu.models import vocos as jvo
        from tts_tpu.runtime.f5 import F5Pipeline as JP
        from tts_tpu_torch.models import f5 as tf5
        from tts_tpu_torch.models import vocos as tvo
        from tts_tpu_torch.runtime.f5 import F5Pipeline

        self.jc, tc = jf5.F5Config(**self.CFG), tf5.F5Config(**self.CFG)
        jvc, tvc = jvo.VocosConfig(**self.VOC), tvo.VocosConfig(**self.VOC)
        jp = jf5.init_params(self.jc, jax.random.key(0))
        jvp = jvo.init_params(jvc, jax.random.key(1))
        jvp["head"]["b"] = jvp["head"]["b"].at[:jvc.n_fft // 2 + 1].set(3.0)
        self.jpipe = JP(jp, self.jc, self.VOCAB, jvp, jvc)
        self.tpipe = F5Pipeline(tf5.F5Model(tc, _conv(jp)), self.VOCAB,
                                tvo.VocosModel(tvc, _conv(jvp)))
        self.audio = (np.random.default_rng(0).standard_normal(2000) * 3000).astype(np.int16)

    def noise(self, seed: int) -> np.ndarray:
        return np.asarray(jax.random.normal(jax.random.key(seed),
                                            (1, 128, self.jc.n_mels)))

    def solo(self, gen_text: str, seed: int) -> np.ndarray:
        """The port's solo synthesize with tts_tpu's draw for `seed`."""
        return self.tpipe.synthesize(self.audio, self.REF, gen_text, noise=self.noise(seed))[0]

    def server(self, slots: int = 2, **kw):
        from tts_tpu_torch.serving.continuous_f5 import F5SlotServer

        return F5SlotServer(self.tpipe, slots=slots, **{**self.slot_kw, **kw})

    def submit(self, srv, gen_text: str, seed: int):
        return srv.submit(self.audio, self.REF, gen_text, noise=self.noise(seed))


@pytest.fixture(scope="module")
def f5():
    return F5()


def test_f5_slot_server_matches_jax_slot_server_and_solo(f5):
    """One request through tts_tpu's slot server and the port's, beside the
    port's solo synthesize."""
    from tts_tpu.serving.continuous_f5 import F5SlotServer as JaxServer

    jsrv = JaxServer(f5.jpipe, slots=2, **f5.slot_kw)
    try:
        jwav, jn = jsrv.submit(f5.audio, f5.REF, "hij abc", seed=7).result(timeout=RESULT_S)
    finally:
        jsrv.close()
    srv = f5.server()
    try:
        wav, n = f5.submit(srv, "hij abc", 7).result(timeout=RESULT_S)
    finally:
        srv.close()
    solo = f5.solo("hij abc", 7)
    assert n == jn == len(wav) == len(solo)
    _same_audio(wav, np.asarray(jwav), F5_LSB)
    _same_audio(wav, solo, F5_LSB)


def test_f5_mid_flight_admission_matches_solo(f5):
    """B admitted while A is mid-integration (the worker held after its
    first chunk): each integrates its own step schedule and gives its solo
    audio."""
    srv = f5.server(chunk_steps=1)
    try:
        first, go = _hold_after_first_chunk(srv)
        fut_a = f5.submit(srv, "hij abc", 7)
        _wait_first_chunk(first, fut_a)
        fut_b = f5.submit(srv, "gij fab", 11)
        go.set()
        outs = [fut_a.result(timeout=RESULT_S), fut_b.result(timeout=RESULT_S)]
        assert srv.stats.admissions_mid_decode == 1
    finally:
        go.set()
        srv.close()
    for (wav, n), (text, seed) in zip(outs, (("hij abc", 7), ("gij fab", 11))):
        solo = f5.solo(text, seed)
        assert n == len(solo)
        _same_audio(wav, solo, F5_LSB)


def test_f5_queue_past_slots_all_complete(f5):
    srv = f5.server(chunk_steps=2)
    texts = ["hij abc", "gij fab", "abc fgh", "jih cba", "bca hij"]
    try:
        futs = [srv.submit(f5.audio, f5.REF, t, seed=3 + i) for i, t in enumerate(texts)]
        outs = [f.result(timeout=RESULT_S) for f in futs]
    finally:
        srv.close()
    assert all(n == len(wav) > 0 and wav.dtype == np.int16 for wav, n in outs)
    assert srv.stats.snapshot()["completed"] == len(texts)


def test_f5_submit_refuses_past_its_buckets(f5):
    """tts_tpu's refusals: audio, text, frame and generated-span buckets; a
    noise of another shape too. Nothing is queued."""
    for kw, args, match in (
            ({}, (np.zeros(40000, np.int16), f5.REF, "hij abc"), "audio"),
            ({}, (f5.audio, f5.REF, "hij abc " * 12), "text"),
            ({"frames": 64}, (f5.audio, f5.REF, "hij abcde"), "frame bucket"),
            ({"gen_frames": 16}, (f5.audio, f5.REF, "hij abc"), "gen_frames")):
        srv = f5.server(**kw)
        try:
            with pytest.raises(ValueError, match=match):
                srv.submit(*args)
            with pytest.raises(ValueError, match="noise"):
                srv.submit(f5.audio, f5.REF, "a", noise=np.zeros((1, 32, 16), np.float32))
            assert srv.stats.requests == 0
        finally:
            srv.close()


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]])
def test_f5_server_over_http(f5, devices):
    """continuous_server("f5") behind serve_http (one pipeline, or two
    behind a SlotRouter): a POST {"gen_text"} returns the WAV of the solo
    request at the pipeline's seed."""
    import http.client
    import io
    import json
    import wave

    from tts_tpu_torch.serving.devices import pipelines_for_devices
    from tts_tpu_torch.serving.families import continuous_server
    from tts_tpu_torch.serving.server import serve_http

    pipe = f5.tpipe if devices is None else pipelines_for_devices(f5.tpipe, devices)
    tts = continuous_server("f5", pipe, ref_audio=f5.audio, ref_text=f5.REF, slots=2,
                            **f5.slot_kw)
    httpd = serve_http(tts, port=0)
    try:
        conn = http.client.HTTPConnection(*httpd.server_address, timeout=RESULT_S)
        conn.request("POST", "/synthesize", json.dumps({"gen_text": "hij abc"}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        with wave.open(io.BytesIO(resp.read())) as w:
            assert w.getframerate() == tts.sample_rate == 24000
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        conn.close()
        st = tts.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        tts.close()
    solo, _ = f5.tpipe.synthesize(f5.audio, f5.REF, "hij abc")
    _same_audio(pcm, solo, F5_LSB)
    assert st["completed"] == 1 and st.get("servers", 1) == (1 if devices is None else 2)


def test_f5_killed_row_stays_finished(f5):
    """A row killed mid-integration (deadline or cancel) stays finished
    through later chunks: its step and latent freeze, where tts_tpu's
    chunk would set it running again."""
    srv = f5.server(chunk_steps=2)
    srv.close()
    s = srv._fresh_base()
    srv._admit_row(s, 0, srv._payload(f5.audio, f5.REF, "hij abc", seed=7), 8)
    srv._admit_row(s, 1, srv._payload(f5.audio, f5.REF, "gij fab", seed=11), 8)
    srv._step_chunk(s)
    srv._kill_row(s, 0)
    x0, t0 = s["x"][0].clone(), s["tvec"].clone()
    srv._step_chunk(s)
    assert s["fin"][0] and not s["fin"][1]
    assert s["tvec"][0] == t0[0] == 2 and s["tvec"][1] == t0[1] + 2
    torch.testing.assert_close(s["x"][0], x0, atol=0, rtol=0)
