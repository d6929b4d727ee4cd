"""IndexTTS text frontend: normalization, CJK-aware BPE tokenization,
sentence splitting (a copy of tts_tpu/frontend/indextts_text.py, over this
package's `normalize` and `spm`).

Behavioral contract from the reference
(IndexTTS/Export_IndexTTS.py:532-1010): CJK chars are
space-separated and uppercased before sentencepiece (:532-555), punctuation
is normalized through a replacement map (:596+), token sequences are split
into sentences at punctuation tokens with a max-length bound and short
sentences merged (:924-1010).

The sentencepiece wheel is optional: given a real `.model` file the
self-contained reader (`frontend/spm.py`) produces the exact upstream
token ids without it. Only the no-model-at-all path degrades to a
char-level vocabulary, which is opt-in (`allow_degraded=True`) and warns;
the default raises so real checkpoints never silently get garbage ids.
"""
from __future__ import annotations

import re
import warnings

import numpy as np

__all__ = ["tokenize_by_cjk_char", "normalize_text", "IndexTTSTokenizer",
           "split_sentences"]

_CJK_RANGE = (
    r"([ᄀ-ᇿ⺀-꓏ꡀ-힯豈-﫿"
    r"︰-﹏･-ￜ\U00020000-\U0002FFFF])"
)

# Punctuation replacement map in the REFERENCE's exact key order
# (Export_IndexTTS.py:593-628): the map is applied as a single-pass regex
# alternation, and re picks the first (not longest) alternative, so order
# is behavior — "，" precedes "，，，", meaning "，，，" folds to ",,," in
# one pass while ",,," and "……" fold to "…".
_CHAR_REP = {
    "：": ",", "；": ",", ";": ",", "，": ",", "。": ".", "！": "!",
    "？": "?", "\n": " ", "·": "-", "、": ",",
    "...": "…", ",,,": "…", "，，，": "…", "……": "…",
    "“": "'", "”": "'", '"': "'", "‘": "'", "’": "'", "（": "'",
    "）": "'", "(": "'", ")": "'", "《": "'", "》": "'", "【": "'",
    "】": "'", "[": "'", "]": "'", "—": "-", "～": "-", "~": "-",
    "「": "'", "」": "'", ":": ",",
}
# "$" is replaced only on the Chinese path (zh_char_rep_map :630-633); the
# EN path leaves it for the number normalizer's currency expansion.
_ZH_CHAR_REP = {"$": ".", **_CHAR_REP}
_REP_PATTERN = re.compile("|".join(re.escape(p) for p in _CHAR_REP))
_ZH_REP_PATTERN = re.compile("|".join(re.escape(p) for p in _ZH_CHAR_REP))

# email shape 数字英文@数字英文.英文 (reference match_email :635-638); an
# email-only string routes to the ZH normalizer like the reference's
# use_chinese (:655-663)
_EMAIL = re.compile(r"^[a-zA-Z0-9]+@[a-zA-Z0-9]+\.[a-zA-Z]+$")


def match_email(text: str) -> bool:
    return _EMAIL.match(text) is not None


def use_chinese(text: str) -> bool:
    """Route to the ZH normalizer: any CJK char, no alpha at all, an
    email-shaped string, or pinyin-tone syllables (reference use_chinese
    :655-663)."""
    if re.search(r"[一-鿿]", text) or not re.search(r"[a-zA-Z]", text):
        return True
    if match_email(text):
        return True
    return _PINYIN_TONE.search(text) is not None


def tokenize_by_cjk_char(line: str, do_upper_case: bool = True) -> str:
    """'你好 hello' -> '你 好 HELLO' (reference :532-555)."""
    chars = re.split(_CJK_RANGE, line.strip())
    return " ".join(
        w.strip().upper() if do_upper_case else w.strip()
        for w in chars if w.strip()
    )


# pinyin-with-tone syllables like xuan4 / jve2 / ying1 (reference
# PINYIN_TONE_PATTERN :643); protected from number expansion, restored with
# the jqx u/ü -> v correction, uppercased (:722-733)
_PINYIN_TONE = re.compile(
    r"(?<![a-z])((?:[bpmfdtnlgkhjqxzcsryw]|[zcs]h)?"
    r"(?:[aeiouüv]|[ae]i|u[aio]|ao|ou|i[aue]|[uüv]e|[uvü]ang?|uai|"
    r"[aeiuv]n|[aeio]ng|ia[no]|i[ao]ng)|ng|er)([1-5])", re.IGNORECASE)
# interpunct-joined Chinese names 克里斯托弗·诺兰 (reference NAME_PATTERN :649)
_ZH_NAME = re.compile(r"[一-鿿]+(?:[-·—][一-鿿]+){1,2}")
_CONTRACTION = re.compile(
    r"(what|where|who|which|how|t?here|it|s?he|that|this)'s", re.IGNORECASE)


def _correct_pinyin(py: str) -> str:
    """jqx + u/ü finals -> v (reference correct_pinyin :722-733)."""
    if py[0] not in "jqxJQX":
        return py.upper()
    return re.sub(r"([jqx])[uü](n|e|an)*(\d)", r"\g<1>v\g<2>\g<3>", py,
                  flags=re.IGNORECASE).upper()


def normalize_text(text: str) -> str:
    """Punctuation normalization via the reference's replacement map plus
    number expansion (frontend/normalize.py — the self-contained analog of
    the reference's tn/wetext normalizers). Pinyin-tone syllables and
    interpunct-joined Chinese names are placeholder-protected through
    normalization exactly like the reference (:694-720)."""
    from .normalize import normalize_numbers, normalize_text as _norm

    text = text.replace("嗯", "恩").replace("呣", "母")
    is_zh = use_chinese(text)
    text = _CONTRACTION.sub(r"\1 is", text)

    # protect via per-MATCH regex substitution (str.replace would corrupt a
    # syllable containing a shorter protected syllable as a substring, e.g.
    # an1 inside pan1); letters keep digits out of the placeholders so the
    # zh number expansion cannot mangle them — past 26 distinct matches the
    # remainder goes through unprotected
    pinyins: list[str] = []

    def _save_py(m):
        if m.group(0) in pinyins:                 # reuse the existing slot
            return f"<pinyin_{chr(ord('a') + pinyins.index(m.group(0)))}>"
        if len(pinyins) >= 26:
            return m.group(0)
        pinyins.append(m.group(0))
        return f"<pinyin_{chr(ord('a') + len(pinyins) - 1)}>"

    text = _PINYIN_TONE.sub(_save_py, text)
    names: list[str] = []

    def _save_name(m):
        if m.group(0) in names:
            return f"<n_{chr(ord('a') + names.index(m.group(0)))}>"
        if len(names) >= 26:
            return m.group(0)
        names.append(m.group(0))
        return f"<n_{chr(ord('a') + len(names) - 1)}>"

    text = _ZH_NAME.sub(_save_name, text)

    if is_zh:
        text = _norm(text, language="zh")
    else:
        text = normalize_numbers(text)

    for i, nm in enumerate(names):
        text = text.replace(f"<n_{chr(ord('a') + i)}>", nm)
    for i, py in enumerate(pinyins):
        text = text.replace(f"<pinyin_{chr(ord('a') + i)}>",
                            _correct_pinyin(py))
    if is_zh:
        text = _ZH_REP_PATTERN.sub(lambda m: _ZH_CHAR_REP[m.group()], text)
    else:
        text = _REP_PATTERN.sub(lambda m: _CHAR_REP[m.group()], text)
    return re.sub(r"\s+", " ", text).strip()


class IndexTTSTokenizer:
    """sentencepiece BPE with CJK pre-tokenization.

    Model loading order: the sentencepiece library if importable, else the
    self-contained reader (`frontend/spm.py`) — both give exact upstream
    ids from a real `.model` file (reference Export_IndexTTS.py:809-1010).
    Degradation policy: with no model and no explicit `vocab`, token ids
    cannot match the upstream tokenizer — that path raises unless
    `allow_degraded=True`, which warns and uses a char-level vocabulary
    (pipeline mechanics identical, ids different)."""

    def __init__(self, bpe_model_path: str | None = None,
                 vocab: dict[str, int] | None = None,
                 allow_degraded: bool = False):
        self.sp = None
        self.vocab = vocab
        if bpe_model_path is not None:
            try:
                import sentencepiece as spm

                self.sp = spm.SentencePieceProcessor()
                self.sp.Load(bpe_model_path)
            except ImportError:
                # the library is optional: the self-contained reader
                # (frontend/spm.py) parses the .model protobuf and encodes
                # with the same BPE/unigram algorithms — exact ids, not a
                # degraded path.
                from .spm import SentencePieceModel

                self.sp = SentencePieceModel.load(bpe_model_path)
        if self.sp is None and self.vocab is None:
            if not allow_degraded:
                raise RuntimeError(
                    "IndexTTSTokenizer has no BPE model and no explicit"
                    " vocab: the char-level fallback produces token ids that"
                    " do NOT match the upstream sentencepiece tokenizer"
                    " (reference Export_IndexTTS.py:809-1010). Pass"
                    " bpe_model_path=/path/to/bpe.model (with sentencepiece"
                    " installed), a vocab=, or allow_degraded=True.")
            warnings.warn(
                "IndexTTSTokenizer degrading to a char-level vocabulary —"
                " token ids will NOT match the upstream tokenizer",
                RuntimeWarning, stacklevel=2)
            chars = ("▁ ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                     "abcdefghijklmnopqrstuvwxyz0123456789.,!?'-…")
            self.vocab = {c: i + 2 for i, c in enumerate(chars)}

    def tokenize(self, text: str) -> list[str]:
        text = tokenize_by_cjk_char(normalize_text(text))
        if self.sp is not None:
            return self.sp.EncodeAsPieces(text)
        return list(text.replace(" ", "▁"))

    def convert_tokens_to_ids(self, tokens: list[str]) -> list[int]:
        if self.sp is not None:
            return [self.sp.PieceToId(t) for t in tokens]
        return [self.vocab.get(t, 1) for t in tokens]

    def encode(self, text: str) -> np.ndarray:
        return np.array([self.convert_tokens_to_ids(self.tokenize(text))],
                        np.int32)


_SPLIT_TOKENS = (".", "!", "?", "…", "▁.", "▁!", "▁?", "▁…")


def split_sentences(tokens: list[str], max_tokens: int = 120,
                    split_tokens: tuple[str, ...] = _SPLIT_TOKENS
                    ) -> list[list[str]]:
    """Split a token stream into sentences at punctuation, bounding each
    sentence at max_tokens (reference split_sentences_by_token :924-1010,
    simplified: overlong sentences fall back to comma then length splits)."""
    if not tokens:
        return []
    sentences: list[list[str]] = []
    cur: list[str] = []
    for i, tok in enumerate(tokens):
        cur.append(tok)
        if len(cur) <= max_tokens:
            if tok in split_tokens and len(cur) > 2:
                sentences.append(cur)
                cur = []
            continue
        # overlong: try comma, then hyphen, then hard length split. A
        # separator splits only at positions 2 .. max_tokens - 1 of `cur`;
        # tts_tpu recurses on any separator and so, with none there, on the
        # same list without end (RecursionError): this guard changes nothing
        # where tts_tpu's split returns
        for seps in ((",", "▁,"), ("-",)):
            if any(t in seps for t in cur[2:max_tokens]):
                subs = split_sentences(cur, max_tokens, seps)
                sentences.extend(subs[:-1])
                cur = subs[-1] if subs else []
                break
        else:
            sentences.extend(
                cur[j:j + max_tokens]
                for j in range(0, len(cur) - max_tokens, max_tokens))
            cur = cur[len(cur) - (len(cur) % max_tokens or max_tokens):]
    if cur:
        # merge a trailing fragment into the previous sentence when short
        if sentences and len(cur) < 4 and len(sentences[-1]) + len(cur) <= max_tokens:
            sentences[-1].extend(cur)
        else:
            sentences.append(cur)
    return sentences
