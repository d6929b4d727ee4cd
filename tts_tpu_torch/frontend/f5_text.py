"""F5 text frontend for the port (counterpart of tts_tpu/frontend/f5_text.py,
copied: the port imports nothing of tts_tpu).

`f5_duration`, `text_to_ids` and the jieba + pypinyin path of
`convert_char_to_pinyin` are tts_tpu's, both packages imported inside the
functions that use them. ASCII text is segmented here without jieba, by the
rules jieba applies to it, so the port runs where jieba is not installed:
jieba splits the text into runs of [a-zA-Z0-9+#&._%-] and single other
characters, and splits a run that is not a dictionary word into
alphanumeric pieces (with an optional decimal part and %) and the text
between them. Its dictionary holds ASCII words only with '#', '+' or '&'
(AT&T, C#, C++), so text with those characters also goes to jieba.

Without pypinyin, Chinese text cannot become the TONE3 pinyin tokens the F5
vocab expects, so the raw-character fallback is opt-in (`allow_degraded`)
and warns; the default raises.
"""
from __future__ import annotations

import re
import warnings

import numpy as np

__all__ = ["convert_char_to_pinyin", "f5_duration", "text_to_ids"]

_CUSTOM_TRANS = str.maketrans({";": ",", "\u201c": '"', "\u201d": '"', "\u2018": "'",
                               "\u2019": "'"})
# each pause mark adds 3 to the byte-length estimate of the duration
_ZH_PAUSE_PUNC = "[\u3002\uff0c\u3001\uff1b\uff1a\uff1f\uff01]"
_BLOCK = re.compile(r"([a-zA-Z0-9+#&\._%\-]+)")
_SPACE = re.compile(r"(\r\n|\s)")
_ALNUM = re.compile(r"([a-zA-Z0-9]+(?:\.\d+)?%?)")
_DICT_CHARS = frozenset("#+&")


def _segments(text: str):
    for blk in _BLOCK.split(text):
        if not blk:
            continue
        if _BLOCK.fullmatch(blk):
            if len(blk) == 1:
                yield blk
            else:
                yield from (s for s in _ALNUM.split(blk) if s)
        else:
            for s in _SPACE.split(blk):
                if _SPACE.fullmatch(s):
                    yield s
                else:
                    yield from s


def _is_chinese(c: str) -> bool:
    return "\u3100" <= c <= "\u9fff"


_warned_pinyin_fallback = False


def _lazy_pinyin(seg: str, allow_degraded: bool) -> list[str]:
    try:
        from pypinyin import Style, lazy_pinyin

        return lazy_pinyin(seg, style=Style.TONE3, tone_sandhi=True)
    except ImportError:
        if not allow_degraded:
            raise RuntimeError(
                "pypinyin is not installed: Chinese text cannot be converted"
                " to the TONE3 pinyin tokens the F5 vocab expects, so token"
                " ids would silently differ. Install pypinyin, or pass"
                " allow_degraded=True to fall back to raw characters.") from None
        global _warned_pinyin_fallback
        if not _warned_pinyin_fallback:
            warnings.warn("pypinyin unavailable: degrading Chinese text to raw "
                          "chars; F5 token ids will not match the upstream "
                          "frontend", RuntimeWarning, stacklevel=3)
            _warned_pinyin_fallback = True
        return list(seg)


def _convert_jieba(text: str, polyphone: bool, allow_degraded: bool) -> list[str]:
    """jieba-cut; pure-ASCII segments char-split with word-boundary spaces,
    pure-CJK segments to TONE3 pinyin with a space before each Chinese
    char, mixed segments per char."""
    import jieba

    if not jieba.dt.initialized:
        jieba.default_logger.setLevel(50)
        jieba.initialize()
    chars: list[str] = []
    for seg in jieba.cut(text.translate(_CUSTOM_TRANS)):
        seg_bytes = len(seg.encode("utf-8"))
        if seg_bytes == len(seg):                       # pure ascii/symbols
            if chars and seg_bytes > 1 and chars[-1] not in " :'\"":
                chars.append(" ")
            chars.extend(seg)
        elif polyphone and seg_bytes == 3 * len(seg):   # pure CJK
            seg_py = _lazy_pinyin(seg, allow_degraded)
            for i, c in enumerate(seg):
                if _is_chinese(c):
                    chars.append(" ")
                chars.append(seg_py[i])
        else:                                           # mixed
            for c in seg:
                if ord(c) < 256:
                    chars.extend(c)
                elif _is_chinese(c):
                    chars.append(" ")
                    chars.extend(_lazy_pinyin(c, allow_degraded))
                else:
                    chars.append(c)
    return chars


def convert_char_to_pinyin(text_list: list[str], polyphone: bool = True,
                           allow_degraded: bool = False) -> list[list[str]]:
    """Text to the F5 vocab's char tokens, as tts_tpu's."""
    final = []
    for text in text_list:
        if not text.isascii() or _DICT_CHARS.intersection(text):
            final.append(_convert_jieba(text, polyphone, allow_degraded))
            continue
        chars: list[str] = []
        for seg in _segments(text.replace(";", ",")):
            # a space before a multi-char segment, as tts_tpu inserts one
            if chars and len(seg) > 1 and chars[-1] not in " :'\"":
                chars.append(" ")
            chars.extend(seg)
        final.append(chars)
    return final


def text_to_ids(chars: list[str], vocab: dict[str, int]) -> np.ndarray:
    """char list -> (1, T) int32 ids; unknown chars -> 0."""
    return np.array([[vocab.get(c, 0) for c in chars]], dtype=np.int32)


def f5_duration(ref_audio_samples: int, ref_text: str, gen_text: str,
                hop: int = 256, speed: float = 1.0) -> tuple[int, int]:
    """(ref_signal_len, max_duration): the byte-length duration heuristic,
    each pause mark weighing 3 bytes."""
    ref_len = len(ref_text.encode("utf-8")) + 3 * len(re.findall(_ZH_PAUSE_PUNC, ref_text))
    gen_len = len(gen_text.encode("utf-8")) + 3 * len(re.findall(_ZH_PAUSE_PUNC, gen_text))
    ref_signal_len = ref_audio_samples // hop + 1
    max_duration = ref_signal_len + int(ref_signal_len / max(ref_len, 1) * gen_len / speed)
    return ref_signal_len, max_duration
