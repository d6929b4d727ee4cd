"""F5 text frontend for the port.

`f5_duration` and `text_to_ids` are tts_tpu's (its frontend imports no
JAX). `convert_char_to_pinyin` is tts_tpu's for any text with non-ASCII
characters, which needs jieba. ASCII text is segmented here without jieba,
by the rules jieba applies to it, so the port runs where jieba is not
installed: jieba splits the text into runs of [a-zA-Z0-9+#&._%-] and
single other characters, and splits a run that is not a dictionary word
into alphanumeric pieces (with an optional decimal part and %) and the
text between them. Its dictionary holds ASCII words only with '#', '+' or
'&' (AT&T, C#, C++), so text with those characters also goes to jieba.
"""
from __future__ import annotations

import re

from tts_tpu.frontend.f5_text import convert_char_to_pinyin as _convert_jieba
from tts_tpu.frontend.f5_text import f5_duration, text_to_ids

__all__ = ["convert_char_to_pinyin", "f5_duration", "text_to_ids"]

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


def convert_char_to_pinyin(text_list: list[str], polyphone: bool = True,
                           allow_degraded: bool = False) -> list[list[str]]:
    """Same result as tts_tpu.frontend.f5_text.convert_char_to_pinyin."""
    final = []
    for text in text_list:
        if not text.isascii() or _DICT_CHARS.intersection(text):
            final.append(_convert_jieba([text], polyphone, allow_degraded)[0])
            continue
        chars: list[str] = []
        for seg in _segments(text.replace(";", ",")):
            # a space before a multi-char segment, as tts_tpu inserts one
            if chars and len(seg) > 1 and chars[-1] not in " :'\"":
                chars.append(" ")
            chars.extend(seg)
        final.append(chars)
    return final
