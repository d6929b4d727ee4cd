"""VoxCPM text frontend: markdown cleaning, normalization, char-level
Chinese tokenization (a copy of tts_tpu/frontend/voxcpm_text.py).

Mirrors the reference frontend
(VoxCPM/v1.5/modeling_modified/text_normalize.py:11-184 and
Export_VoxCPM_ONNX.py:991-1025). The reference delegates number expansion
to wetext/inflect, which this package does not depend on —
frontend/normalize.py provides the equivalent expansion (cardinals,
ordinals, percents, currency for English; digit reading for Chinese).
"""
from __future__ import annotations

import re

from .normalize import normalize_numbers, normalize_text as _norm_basic

__all__ = ["clean_markdown", "clean_text", "contains_chinese",
           "replace_corner_mark", "remove_bracket", "replace_blank",
           "normalize_voxcpm_text", "CharTokenizerWrapper",
           "mask_multichar_chinese_tokens"]

_CHINESE = re.compile(r"[一-鿿]")


def contains_chinese(text: str) -> bool:
    return bool(_CHINESE.search(text))


def clean_markdown(md: str) -> str:
    """Strip markdown structure (reference text_normalize.py:122-148)."""
    md = re.sub(r"```.*?```", "", md, flags=re.DOTALL)          # code blocks
    md = re.sub(r"`[^`]*`", "", md)                             # inline code
    md = re.sub(r"!\[[^\]]*\]\([^\)]+\)", "", md)               # images
    md = re.sub(r"\[([^\]]+)\]\([^)]+\)", r"\1", md)            # links
    md = re.sub(r"^(\s*)-\s+", r"\1", md, flags=re.MULTILINE)   # bullets
    md = re.sub(r"<[^>]+>", "", md)                             # html tags
    md = re.sub(r"^#{1,6}\s*", "", md, flags=re.MULTILINE)      # headings
    md = re.sub(r"\n\s*\n", "\n", md)
    return md.strip()


# basic emoji/pictograph blocks (the reference uses \p{Emoji}; this covers
# the presentation ranges without the regex module)
_EMOJI = re.compile(
    "[\U0001F300-\U0001FAFF\U00002600-\U000027BF\U0001F000-\U0001F0FF"
    "\U0000FE0F\U0001F900-\U0001F9FF]"
)


def clean_text(text: str) -> str:
    """Markdown + emoji + newline cleanup (text_normalize.py:151-160)."""
    text = clean_markdown(text)
    text = _EMOJI.sub("", text)
    text = text.replace("\n", " ").replace("\t", " ")
    text = text.replace('"', "“")
    return text


def replace_corner_mark(text: str) -> str:
    for a, b in (("²", "平方"), ("³", "立方"), ("√", "根号"),
                 ("≈", "约等于"), ("<", "小于")):
        text = text.replace(a, b)
    return text


def remove_bracket(text: str) -> str:
    for a, b in (("（", " "), ("）", " "), ("【", " "), ("】", " "),
                 ("`", ""), ("——", " ")):
        text = text.replace(a, b)
    return text


def replace_blank(text: str) -> str:
    """Drop spaces between CJK characters, keep ascii-word spacing
    (text_normalize.py:112-120)."""
    out = []
    for i, c in enumerate(text):
        if c == " ":
            nxt = text[i + 1] if i + 1 < len(text) else ""
            prv = text[i - 1] if i > 0 else ""
            if (nxt.isascii() and nxt != " ") and (prv.isascii() and prv != " "):
                out.append(c)
        else:
            out.append(c)
    return "".join(out)


def normalize_voxcpm_text(text: str) -> str:
    """TextNormalizer.normalize equivalent (text_normalize.py:162-184):
    clean -> language-specific normalization -> symbol cleanup."""
    lang = "zh" if contains_chinese(text) else "en"
    text = clean_text(text)
    if lang == "zh":
        text = text.replace("=", "等于")
        if re.search(r"([\d$%^*_+≥≤≠×÷?=])", text):
            text = re.sub(r"(?<=[a-zA-Z0-9])-(?=\d)", " - ", text)
        text = _norm_basic(text, language="zh")
        text = replace_blank(text)
        text = replace_corner_mark(text)
        text = remove_bracket(text)
    else:
        text = normalize_numbers(text)
        text = re.sub(r"\s+", " ", text).strip()
    return text


class CharTokenizerWrapper:
    """Wraps an HF tokenizer so multi-character pure-Chinese vocab tokens
    split into single characters (reference Export_VoxCPM_ONNX.py:997-1025:
    VoxCPM models pronounce char-by-char for Chinese)."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.multichar_tokens = {
            tok for tok in tokenizer.vocab.keys()
            if len(tok) >= 2 and all("一" <= c <= "鿿" for c in tok)
        }

    def tokenize(self, text: str, **kw):
        if not isinstance(text, str):
            raise TypeError(f"expected str, got {type(text)}")
        out = []
        for tok in self.tokenizer.tokenize(text, **kw):
            clean = tok.replace("▁", "")
            if clean in self.multichar_tokens:
                out.extend(list(clean))
            else:
                out.append(tok)
        return out

    def __call__(self, text: str, **kw):
        # tokenize + convert (no special tokens), exactly the reference
        # wrapper's behavior (Export_VoxCPM_ONNX.py:1016-1023) — VoxCPM
        # prompts are assembled from raw text ids, BOS-free
        return self.tokenizer.convert_tokens_to_ids(self.tokenize(text, **kw))


def mask_multichar_chinese_tokens(tokenizer) -> CharTokenizerWrapper:
    return CharTokenizerWrapper(tokenizer)
