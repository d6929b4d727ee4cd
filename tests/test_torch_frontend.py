"""The port's text frontends (tts_tpu_torch/frontend) and its Kani and
IndexTTS text entries against tts_tpu's, on the CPU.

Frontends: the same inputs through both packages give identical ids and
strings (exact equality): HFTokenizer over the three `tokenizers`-built
fixtures and the golden ids, with the `regex` wheel and with it hidden (the
hand-rolled scanner); SentencePieceModel on hand-built BPE and unigram
ModelProtos; the normalizers; IndexTTSTokenizer (a vocab= and a .model) with
split_sentences; the VoxCPM text functions and its char wrapper. The inputs
are a battery of English and Chinese text plus every string literal of
tts_tpu's own frontend tests.

Text entries: KaniPipeline.tokenize / synthesize / synthesize_long and
IndexTTSPipeline.synthesize on a two-sentence text, params carried across
by params_from_jax, at the tolerances of the existing synthesize_ids
comparisons: the same token counts and int16 audio within 2 LSB (Kani) and
4 LSB (IndexTTS), float waveforms that agree to ~1e-6 / ~1e-5 truncating to
neighbouring integers."""
import ast
import builtins
import os

import jax
import numpy as np
import pytest
import torch

import tts_tpu.frontend.hf_tokenizer as jhf
import tts_tpu.frontend.indextts_text as jit_
import tts_tpu.frontend.normalize as jnorm
import tts_tpu.frontend.spm as jspm
import tts_tpu.frontend.voxcpm_text as jvox
import tts_tpu_torch.frontend.hf_tokenizer as thf
import tts_tpu_torch.frontend.indextts_text as tit
import tts_tpu_torch.frontend.normalize as tnorm
import tts_tpu_torch.frontend.spm as tspm
import tts_tpu_torch.frontend.voxcpm_text as tvox
from tests.test_hf_tokenizer import BATTERY, NAMES
from tests.test_spm import BOS, EOS, UNK, WS, build_model
from tts_tpu_torch.weights.convert import params_from_jax

HERE = os.path.dirname(__file__)
FIXTURES = os.path.join(HERE, "fixtures")

EXTRA = [
    "# Title\n[link](http://x) and `code` \n- item\n```\nblock\n```",
    "**5** cats", "你好 世界 123", "你 好 ab cd",
    "I paid $1,234.56 on 3/14/2024 at 10:30am, and 2nd place got 50%.",
    "Call 555-123-4567 or email bob.smith@example.com, see https://example.org/a?b=1",
    "It's 25°C today: 1/2 cup, 3km, -7 degrees, 1990-1995, ~20 items.",
    "第3章 2023年5月1日 下午3点20分 价格￥45.5元，电话13812345678。",
    "Hello there. Good day to you! What now? Well…",
    "嗯，呣 zhang1 san1 和 李·白 一起 ni3 hao3。",
    "x²+y³ (bracket) 【note】 《book》 “quote” ‘single’",
    " ".join(["word"] * 150) + ".",
    "A, B, C, " * 60 + "done.",
]


def _literals(*names: str) -> list[str]:
    """Every string constant of tts_tpu's own frontend test files."""
    out = []
    for name in names:
        with open(os.path.join(HERE, name), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        out += [n.value for n in ast.walk(tree)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
                and len(n.value) <= 400]
    return out


TEXTS = sorted(set(BATTERY + EXTRA + _literals("test_normalize.py", "test_frontend.py",
                                               "test_hf_tokenizer.py")))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_regex(monkeypatch):
    """Hide the `regex` wheel, as tests/test_hf_tokenizer.py does."""
    real_import = builtins.__import__

    def block(mod, *a, **kw):
        if mod == "regex":
            raise ImportError("regex hidden for test")
        return real_import(mod, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", block)


# ------------------------------------------------------------ HFTokenizer


def _golden() -> dict:
    import json

    with open(os.path.join(FIXTURES, "hf_tokenizer_golden.json"), encoding="utf-8") as f:
        return json.load(f)


def _same_hf(tok, ref, texts) -> None:
    for text in texts:
        assert tok.encode(text) == ref.encode(text), repr(text)
        assert (tok.encode(text, add_special_tokens=False)
                == ref.encode(text, add_special_tokens=False)), repr(text)
        assert tok.tokenize(text) == ref.tokenize(text), repr(text)
        got = tok(text, return_tensors="np")["input_ids"]
        want = ref(text, return_tensors="np")["input_ids"]
        assert got.dtype == want.dtype and np.array_equal(got, want), repr(text)
        ids = tok.encode(text)
        assert tok.decode(ids) == ref.decode(ids), repr(text)
    assert tok.vocab == ref.vocab and len(tok) == len(ref)


@pytest.mark.parametrize("wheel", ["regex", "scanner"])
@pytest.mark.parametrize("name", NAMES)
def test_hf_tokenizer_matches_tts_tpu(name, wheel, request):
    """Ids, tokens, the np call and decode equal tts_tpu's on every input;
    the golden ids hold. "scanner" hides `regex` before the files load, so
    both packages split with the hand-rolled scanner."""
    if wheel == "regex":
        pytest.importorskip("regex")
    else:
        request.getfixturevalue("no_regex")
    path = os.path.join(FIXTURES, f"{name}.json")
    tok, ref = thf.HFTokenizer.load(path), jhf.HFTokenizer.load(path)
    golden = _golden()[name]
    _same_hf(tok, ref, TEXTS + list(golden))
    for text, want in golden.items():
        assert tok.encode(text) == want, repr(text)


def test_no_regex_takes_the_scanner(no_regex, monkeypatch):
    """With `regex` hidden the GPT-2 / Qwen2 split patterns run on the
    scanner (the path of a machine without the wheel)."""
    made = []

    class Recorded(thf._SplitPattern):
        def __init__(self, pattern):
            super().__init__(pattern)
            made.append(self)

    monkeypatch.setattr(thf, "_SplitPattern", Recorded)
    for name in ("gpt2_style", "qwen2_style"):
        made.clear()
        thf.HFTokenizer.load(os.path.join(FIXTURES, f"{name}.json")).encode("Hello 123 world!")
        assert made and all(p._rx is None and p._scan is not None for p in made), name


def test_scanner_table_is_tts_tpu_s():
    assert set(thf._KNOWN_SCANNERS) == set(jhf._KNOWN_SCANNERS)
    for text in TEXTS:
        for kw in ({"contractions_ci": False, "digit_run": 0, "newline_aware": False},
                   {"contractions_ci": True, "digit_run": 3, "newline_aware": True}):
            assert thf._scan_gpt2_family(text, **kw) == jhf._scan_gpt2_family(text, **kw)


# ------------------------------------------------------------ SentencePiece

_LETTERS = [(c, -5.0, 1) for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ.,!?'"]
SPM_MODELS = {
    "bpe": dict(pieces=[UNK, BOS, EOS, (WS, -10.0, 1)] + _LETTERS
                + [(WS + "HE", -1.0, 1), ("LL", -1.5, 1), ("LLO", -1.2, 1),
                   (WS + "HELLO", -0.5, 1), ("TH", -2.0, 1), ("ER", -2.1, 1),
                   (WS + "THE", -1.1, 1), ("RE", -2.2, 1), ("IN", -2.3, 1)],
                model_type=2),
    "bpe_byte_fallback": dict(pieces=[UNK, BOS, EOS, (WS, -10.0, 1)] + _LETTERS
                              + [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
                              + [(WS + "A", -1.0, 1)],
                              model_type=2, byte_fallback=True),
    "unigram": dict(pieces=[UNK, BOS, EOS, (WS, -3.0, 1)] + _LETTERS
                    + [(WS + "HELLO", -4.0, 1), ("HELL", -6.0, 1), ("O", -2.0, 1),
                       (WS + "THE", -3.5, 1), ("ING", -3.0, 1), ("你", -4.0, 1),
                       ("你好", -5.0, 1)],
                    model_type=1),
    "nfkc": dict(pieces=[UNK, (WS, -3.0, 1)] + _LETTERS + [(WS + "AB", -1.0, 1)],
                 model_type=2, normalizer="nmt_nfkc"),
}


@pytest.mark.parametrize("kind", sorted(SPM_MODELS))
def test_spm_matches_tts_tpu(kind):
    """Pieces, ids, piece ids and decode equal tts_tpu's reader's, through
    the `EncodeAsPieces` / `PieceToId` surface IndexTTSTokenizer calls."""
    blob = build_model(**SPM_MODELS[kind])
    m, ref = tspm.SentencePieceModel.from_bytes(blob), jspm.SentencePieceModel.from_bytes(blob)
    assert len(m) == len(ref) and m.unk_id == ref.unk_id and m.model_type == ref.model_type
    for text in TEXTS + [t.upper() for t in TEXTS]:
        pieces = m.EncodeAsPieces(text)
        assert pieces == ref.EncodeAsPieces(text), repr(text)
        assert [m.PieceToId(p) for p in pieces] == [ref.PieceToId(p) for p in pieces]
        ids = m.encode(text)
        assert ids == ref.encode(text) and m.decode(ids) == ref.decode(ids), repr(text)


# ------------------------------------------------------------ normalizers

NORMALIZERS = {
    "normalize_numbers": lambda mod, t: mod.normalize_numbers(t),
    "normalize_text_en": lambda mod, t: mod.normalize_text(t, language="en"),
    "normalize_text_zh": lambda mod, t: mod.normalize_text(t, language="zh"),
    "zh_normalize_numbers": lambda mod, t: mod.zh_normalize_numbers(t),
    "verbalize_emails_urls": lambda mod, t: mod.verbalize_emails_urls(t),
}


@pytest.mark.parametrize("fn", sorted(NORMALIZERS))
def test_normalize_matches_tts_tpu(fn):
    f = NORMALIZERS[fn]
    for text in TEXTS:
        assert f(tnorm, text) == f(jnorm, text), repr(text)


# ------------------------------------------------------------ IndexTTS text

# a char vocabulary in the ids tts_tpu's TINY IndexTTS takes (< 50)
CHAR_VOCAB = {c: i + 2 for i, c in enumerate("▁ABCDEFGHIJKLMNOPQRSTUVWXYZ.,!?'")}


def _index_tokenizers(kind, tmp_path):
    if kind == "vocab":
        return (tit.IndexTTSTokenizer(vocab=CHAR_VOCAB),
                jit_.IndexTTSTokenizer(vocab=CHAR_VOCAB))
    path = str(tmp_path / "bpe.model")
    with open(path, "wb") as f:
        f.write(build_model(**SPM_MODELS["bpe"]))
    return tit.IndexTTSTokenizer(path), jit_.IndexTTSTokenizer(path)


@pytest.mark.parametrize("kind", ["vocab", "model"])
def test_indextts_text_matches_tts_tpu(kind, tmp_path):
    """normalize_text, the CJK split, the tokenizer (a vocab= and a .model
    through the self-contained reader) and split_sentences at its default
    and at a short bound (the comma and length fallbacks)."""
    tok, ref = _index_tokenizers(kind, tmp_path)
    for text in TEXTS:
        assert tit.normalize_text(text) == jit_.normalize_text(text), repr(text)
        assert tit.tokenize_by_cjk_char(text) == jit_.tokenize_by_cjk_char(text)
        tokens = tok.tokenize(text)
        assert tokens == ref.tokenize(text), repr(text)
        assert tok.convert_tokens_to_ids(tokens) == ref.convert_tokens_to_ids(tokens)
        assert np.array_equal(tok.encode(text), ref.encode(text))
        for bound in (120, 7):
            _same_split(tokens, bound)


def _same_split(tokens, bound) -> None:
    """split_sentences as tts_tpu's wherever tts_tpu's returns. Where an
    overlong run's only separators sit at its first two places or its last,
    tts_tpu's recursion never ends; the port's split still partitions the
    tokens into sentences of at most `bound`."""
    got = tit.split_sentences(tokens, bound)
    try:
        want = jit_.split_sentences(tokens, bound)
    except RecursionError:
        assert [t for s in got for t in s] == tokens and max(map(len, got)) <= bound
        return
    assert got == want


def test_split_sentences_where_tts_tpu_recurses():
    """A comma only at the head of an overlong run: tts_tpu's split raises,
    the port's falls through to the length split."""
    tokens = [",", "A"] + ["B"] * 10
    with pytest.raises(RecursionError):
        jit_.split_sentences(tokens, 7)
    assert tit.split_sentences(tokens, 7) == [tokens[:7], tokens[7:]]


# ------------------------------------------------------------ VoxCPM text

VOX_FNS = ("normalize_voxcpm_text", "clean_markdown", "clean_text", "replace_corner_mark",
           "remove_bracket", "replace_blank", "contains_chinese")


@pytest.mark.parametrize("fn", VOX_FNS)
def test_voxcpm_text_matches_tts_tpu(fn):
    for text in TEXTS:
        assert getattr(tvox, fn)(text) == getattr(jvox, fn)(text), repr(text)


@pytest.mark.parametrize("name", NAMES)
def test_voxcpm_char_wrapper_matches_tts_tpu(name):
    """mask_multichar_chinese_tokens over each package's HFTokenizer, the
    call the voxcpm command makes on normalized text."""
    path = os.path.join(FIXTURES, f"{name}.json")
    tok = tvox.mask_multichar_chinese_tokens(thf.HFTokenizer.load(path))
    ref = jvox.mask_multichar_chinese_tokens(jhf.HFTokenizer.load(path))
    assert tok.multichar_tokens == ref.multichar_tokens
    for text in TEXTS:
        norm = tvox.normalize_voxcpm_text(text)
        assert tok.tokenize(norm) == ref.tokenize(norm) and tok(norm) == ref(norm), repr(text)


# ------------------------------------------------------------ Kani text entry

# tests/test_torch_kani.py's LM with a vocabulary past the prompt's head and
# tail ids (64403, 64404)
KANI_LM = dict(hidden_size=128, num_heads=16, num_kv_heads=8, head_dim=64, ffn_dim=192,
               vocab_size=64512, layer_types=("conv", "attn", "conv", "attn"),
               max_seq_len=128, stop_token=-1)
KANI_CODEC = dict(base_channels=16, up_sample_rates=(2, 2), kernel_sizes=(3,),
                  dilations=(1, 3), activation="half_snake")
SENTENCES = ["Hello there.", "Good day to you!"]


def _same_audio(got, ref, lsb):
    assert got.dtype == np.int16 and got.shape == ref.shape
    assert np.abs(ref.astype(np.int32)).max() > 1000
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= lsb


@pytest.fixture(scope="module")
def kani_pipes():
    from tts_tpu.models import kani as jk
    from tts_tpu.models import nanocodec as jnc
    from tts_tpu.runtime.kani import KaniDecodeConfig as JDec
    from tts_tpu.runtime.kani import KaniPipeline as JPipe
    from tts_tpu_torch.models import kani as tk
    from tts_tpu_torch.models import nanocodec as tnc
    from tts_tpu_torch.runtime.kani import KaniDecodeConfig, KaniPipeline

    jp = jk.init_params(jk.KaniConfig(**KANI_LM), jax.random.key(0))
    jcp = jnc.init_params(jnc.NanoCodecConfig(**KANI_CODEC), jax.random.key(1))
    jcp["post_conv"]["w"] = jcp["post_conv"]["w"] * 4000.0      # int16 sees the waveform
    tp, tcp = (params_from_jax(jax.tree.map(np.asarray, t), "cpu", torch.float32)
               for t in (jp, jcp))
    path = os.path.join(FIXTURES, "gpt2_style.json")
    dec = dict(max_new_tokens=24, repeat_penalty=0.8)
    jpipe = JPipe(jp, jk.KaniConfig(**KANI_LM), jcp, jnc.NanoCodecConfig(**KANI_CODEC),
                  JDec(fused_decode=False, **dec), tokenizer=jhf.HFTokenizer.load(path),
                  audio_tokens_start=0)
    tpipe = KaniPipeline(tp, tk.KaniConfig(**KANI_LM), tcp, tnc.NanoCodecConfig(**KANI_CODEC),
                         KaniDecodeConfig(**dec), tokenizer=thf.HFTokenizer.load(path),
                         audio_tokens_start=0)
    return jpipe, tpipe


def test_kani_tokenize_matches_tts_tpu(kani_pipes):
    from tts_tpu_torch.runtime import kani as tkani

    jpipe, tpipe = kani_pipes
    assert (tkani.HEAD_IDS, tkani.TAIL_IDS) == ((64403,), (2, 64404))
    for text in TEXTS[:40] + SENTENCES:
        got, want = tpipe.tokenize(text, "andrew"), jpipe.tokenize(text, "andrew")
        assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want), repr(text)
    with pytest.raises(ValueError, match="no tokenizer"):
        type(tpipe)(tpipe.params, tpipe.cfg, tpipe.codec_params, tpipe.codec_cfg).tokenize("a")


def test_kani_synthesize_matches_tts_tpu(kani_pipes):
    jpipe, tpipe = kani_pipes
    text = " ".join(SENTENCES)
    wj, sj = jpipe.synthesize(text, speaker="jenny")
    wt, st = tpipe.synthesize(text, speaker="jenny")
    assert st["tokens"] == sj["tokens"] == 24
    _same_audio(wt, wj, 2)


def test_kani_synthesize_long_matches_tts_tpu(kani_pipes):
    """One synthesize a sentence, each followed by 300 ms of silence."""
    jpipe, tpipe = kani_pipes
    wj, sj = jpipe.synthesize_long(SENTENCES)
    wt, st = tpipe.synthesize_long(SENTENCES)
    assert [s["tokens"] for s in st] == [s["tokens"] for s in sj]
    blank = int(tpipe.codec_cfg.sample_rate * 0.3)
    first = tpipe.synthesize(SENTENCES[0])[0]
    assert np.array_equal(wt[:len(first)], first) and not wt[len(first):len(first) + blank].any()
    _same_audio(wt, wj, 2)


# ------------------------------------------------------------ IndexTTS text entry


@pytest.mark.parametrize("kind", ["vocab", "model"])
def test_indextts_synthesize_matches_tts_tpu(kind, tmp_path):
    """tests/test_torch_indextts.py's TINY pipelines on a two-sentence text:
    the same sentences, token counts and int16 audio within 4 LSB, the
    200 ms blanks between."""
    from tests.test_torch_indextts import TINY, VOC, _conv, _jax_params
    from tts_tpu.models import bigvgan as jbv
    from tts_tpu.models import indextts as ji
    from tts_tpu.runtime.indextts import IndexTTSPipeline as JPipe
    from tts_tpu_torch.models import bigvgan as tbv
    from tts_tpu_torch.models import indextts as ti
    from tts_tpu_torch.runtime.indextts import IndexTTSPipeline

    voc = dict(VOC, num_mels=TINY["gpt_dim"])
    jp = _jax_params(ji.IndexTTSConfig(**TINY), jbv.BigVGANConfig(**voc))
    kw = dict(sample_rate=8000, n_fft=256, hop=64)
    jpipe = JPipe(jp, ji.IndexTTSConfig(**TINY), jbv.BigVGANConfig(**voc), **kw)
    tpipe = IndexTTSPipeline(_conv(jp), ti.IndexTTSConfig(**TINY), tbv.BigVGANConfig(**voc),
                             **kw)
    audio = (np.random.default_rng(0).standard_normal(4000) * 3000).astype(np.int16)
    jref, tref = jpipe.encode_reference(audio), tpipe.encode_reference(audio)
    tok, ref_tok = _index_tokenizers(kind, tmp_path)
    text = "Hello there. Good day to you!"
    assert len(tit.split_sentences(tok.tokenize(text))) == 2
    wj, sj = jpipe.synthesize(text, jref, tokenizer=ref_tok, max_gen=34)
    wt, st = tpipe.synthesize(text, tref, tokenizer=tok, max_gen=34)
    assert [s.tokens for s in st] == [s.tokens for s in sj] and len(st) == 2
    up = tpipe.vcfg.total_upsample
    assert len(wt) == sum(max(s.tokens - 2, 0) * up for s in st) + 2 * 1600
    _same_audio(wt, wj, 4)
