"""Self-contained HF `tokenizer.json` reader — exact ids, zero wheels (a
copy of tts_tpu/frontend/hf_tokenizer.py).

The reference tokenizes Kani/Qwen through HF AutoTokenizer
(Kani_TTS/Export_Kani_TTS.py:982-983,
Qwen_TTS/Export_Qwen_TTS_ONNX.py:636-638) and VoxCPM
through LlamaTokenizerFast (VoxCPM/v1.5/
Export_VoxCPM_ONNX.py:991). This module reads the checkpoint's
`tokenizer.json` directly and reimplements the fast-tokenizer pipeline —
normalizer -> pre-tokenizer -> BPE model -> post-processor — so those
families produce exact upstream token ids without the `transformers` /
`tokenizers` wheels (the same standard `frontend/spm.py` set for
SentencePiece `.model` files).

Covered surface (everything the Qwen2 / LFM2 / Llama tokenizer configs
use, cross-validated against the `tokenizers` wheel in tests):
- normalizers: NFC/NFD/NFKC/NFKD, Lowercase, Prepend, Replace, Strip,
  Sequence
- pre-tokenizers: ByteLevel (add_prefix_space, use_regex), Split
  (Regex/String; Isolated/Removed/Merged*), Metaspace, Whitespace,
  Digits, Sequence
- model: BPE with merges ranking, ignore_merges, byte_fallback,
  fuse_unk/unk_token, continuing_subword_prefix/end_of_word_suffix
- post-processor: TemplateProcessing (single), ByteLevel (no-op)
- added tokens: longest-match splitting with lstrip/rstrip, raw or
  normalized matching

Unicode-property regexes (\\p{L}, \\p{N}) use the `regex` wheel when
importable; otherwise the known GPT-2 / Qwen2 / Llama-3 split patterns
run on a hand-rolled scanner over `unicodedata` categories, and unknown
patterns raise rather than degrade.
"""
from __future__ import annotations

import functools
import json
import os
import re
import unicodedata

import numpy as np

__all__ = ["HFTokenizer"]


# ------------------------------------------------------------ byte level

@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte<->unicode table (printable surrogates for
    control/whitespace bytes)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=1)
def _unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in _bytes_to_unicode().items()}


def _byte_encode(piece: str) -> str:
    enc = _bytes_to_unicode()
    return "".join(enc[b] for b in piece.encode("utf-8"))


# ------------------------------------------------- split pattern matching

_GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
                 r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
_QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
                  r"[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
_LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
                   r"[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                   r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def _is_letter(c: str) -> bool:
    return unicodedata.category(c).startswith("L")


def _is_number(c: str) -> bool:
    return unicodedata.category(c).startswith("N")


def _scan_gpt2_family(text: str, contractions_ci: bool, digit_run: int,
                      newline_aware: bool) -> list[str]:
    """Hand-rolled scanner equivalent to the GPT-2 / Qwen2 / Llama-3 split
    regexes (leftmost-first alternative semantics), used when the `regex`
    wheel is absent. digit_run: max digits per \\p{N} token (0 = unbounded).
    """
    out: list[str] = []
    i, n = 0, len(text)
    contr = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
    while i < n:
        c = text[i]
        # 1) contractions
        if c == "'":
            rest = text[i:i + 3]
            rl = rest.lower() if contractions_ci else rest
            hit = next((t for t in contr if rl.startswith(t)), None)
            if hit is not None:
                out.append(text[i:i + len(hit)])
                i += len(hit)
                continue
        # 2) [^\r\n\p{L}\p{N}]?\p{L}+   (GPT-2: " ?\p{L}+")
        j = i
        prefix_ok = (c == " " if not newline_aware else
                     (c not in "\r\n" and not _is_letter(c)
                      and not _is_number(c)))
        if prefix_ok and j + 1 < n and _is_letter(text[j + 1]):
            j += 1
        if j < n and _is_letter(text[j]):
            k = j
            while k < n and _is_letter(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        # 3) digits
        j = i
        if not newline_aware and c == " " and j + 1 < n and _is_number(text[j + 1]):
            j += 1
        if j < n and _is_number(text[j]):
            k = j
            lim = digit_run if digit_run else n
            while k < n and _is_number(text[k]) and (k - j) < lim:
                k += 1
            out.append(text[i:k])
            i = k
            continue
        # 4) " ?[^\s\p{L}\p{N}]+[\r\n]*"
        j = i + 1 if (c == " " and i + 1 < n) else i
        cj = text[j] if j < n else ""
        if cj and not cj.isspace() and not _is_letter(cj) and not _is_number(cj):
            k = j
            while (k < n and not text[k].isspace()
                   and not _is_letter(text[k]) and not _is_number(text[k])):
                k += 1
            if newline_aware:
                while k < n and text[k] in "\r\n":
                    k += 1
            out.append(text[i:k])
            i = k
            continue
        # 5) "\s*[\r\n]+" — greedy \s* means the match runs to the LAST
        # newline anywhere in the whitespace run; 6) "\s+(?!\S)"; 7) "\s+"
        if c.isspace():
            k = i
            while k < n and text[k].isspace():
                k += 1
            if newline_aware:
                last_nl = -1
                for idx in range(k - 1, i - 1, -1):
                    if text[idx] in "\r\n":
                        last_nl = idx
                        break
                if last_nl >= 0:
                    out.append(text[i:last_nl + 1])
                    i = last_nl + 1
                    continue
            if k < n:                     # run followed by non-space:
                k2 = k - 1                # leave last space for next token
                if k2 > i:
                    out.append(text[i:k2])
                    i = k2
                    continue
                out.append(text[i:k])     # single space before non-space
                i = k
                continue
            out.append(text[i:k])
            i = k
            continue
        out.append(c)                     # lone fallthrough char
        i += 1
    return out


_KNOWN_SCANNERS = {
    _GPT2_PATTERN: dict(contractions_ci=False, digit_run=0,
                        newline_aware=False),
    _QWEN2_PATTERN: dict(contractions_ci=True, digit_run=1,
                         newline_aware=True),
    _LLAMA3_PATTERN: dict(contractions_ci=True, digit_run=3,
                          newline_aware=True),
}


class _SplitPattern:
    """A split regex: the `regex` wheel when present, else the hand-rolled
    scanner for the known GPT-2-family patterns."""

    def __init__(self, pattern: str):
        self.pattern = pattern
        self._rx = None
        self._scan = None
        try:
            import regex

            self._rx = regex.compile(pattern)
        except ImportError:
            if pattern in _KNOWN_SCANNERS:
                self._scan = _KNOWN_SCANNERS[pattern]
            else:
                try:                       # plain-re patterns still work
                    self._rx = re.compile(pattern)
                except re.error:
                    raise ValueError(
                        f"split pattern {pattern!r} needs the `regex` wheel "
                        "(unicode properties) and it is not installed")

    def findall(self, text: str) -> list[tuple[int, int]]:
        if self._rx is not None:
            return [m.span() for m in self._rx.finditer(text)]
        pieces = _scan_gpt2_family(text, **self._scan)
        spans, pos = [], 0
        for p in pieces:
            spans.append((pos, pos + len(p)))
            pos += len(p)
        return spans


# ------------------------------------------------------------ normalizer

def _apply_normalizer(norm, text: str) -> str:
    if norm is None:
        return text
    t = norm["type"]
    if t == "Sequence":
        for sub in norm["normalizers"]:
            text = _apply_normalizer(sub, text)
        return text
    if t in ("NFC", "NFD", "NFKC", "NFKD"):
        return unicodedata.normalize(t, text)
    if t == "Lowercase":
        return text.lower()
    if t == "Prepend":
        return norm["prepend"] + text if text else text
    if t == "Replace":
        pat = norm["pattern"]
        if "String" in pat:
            return text.replace(pat["String"], norm["content"])
        return re.sub(pat["Regex"], norm["content"], text)
    if t == "Strip":
        if norm.get("strip_left", True) and norm.get("strip_right", True):
            return text.strip()
        if norm.get("strip_left", True):
            return text.lstrip()
        return text.rstrip()
    raise ValueError(f"unsupported normalizer type {t!r}")


# --------------------------------------------------------- pre-tokenizer

def _split_piece(piece: str, spans: list[tuple[int, int]],
                 behavior: str, invert: bool) -> list[str]:
    """Split `piece` at `spans` (the pattern matches) per tokenizers'
    SplitDelimiterBehavior."""
    if invert:
        # pattern matches the CONTENT; delimiters are the gaps
        gaps, pos = [], 0
        for s, e in spans:
            gaps.append((pos, s))
            pos = e
        gaps.append((pos, len(piece)))
        spans = [g for g in gaps if g[0] != g[1]]
    if behavior == "MergedWithNext":
        merged: list[str] = []
        pos, pending = 0, ""
        for s, e in spans:
            if piece[pos:s]:
                merged.append(pending + piece[pos:s])
                pending = ""
            pending += piece[s:e]
            pos = e
        tail = piece[pos:]
        if tail or pending:
            merged.append(pending + tail)
        return merged
    out: list[str] = []
    pos = 0
    for s, e in spans:
        between = piece[pos:s]
        match = piece[s:e]
        if behavior == "Removed":
            if between:
                out.append(between)
        elif behavior == "Isolated":
            if between:
                out.append(between)
            if match:
                out.append(match)
        elif behavior == "MergedWithPrevious":
            out.append(between + match)
        else:
            raise ValueError(f"unsupported split behavior {behavior!r}")
        pos = e
    tail = piece[pos:]
    if tail:
        out.append(tail)
    return out


def _pretokenize(pre, pieces: list[str]) -> list[str]:
    if pre is None:
        return pieces
    t = pre["type"]
    if t == "Sequence":
        for sub in pre["pretokenizers"]:
            pieces = _pretokenize(sub, pieces)
        return pieces
    if t == "ByteLevel":
        if pre.get("add_prefix_space", False) and pieces and pieces[0] \
                and not pieces[0][0].isspace():
            pieces = [" " + pieces[0]] + pieces[1:]
        if pre.get("use_regex", True):
            rx = _SplitPattern(_GPT2_PATTERN)
            pieces = [piece[s:e] for piece in pieces
                      for s, e in rx.findall(piece)]
        return [_byte_encode(p) for p in pieces]
    if t == "Split":
        pat = pre["pattern"]
        if "String" in pat:
            lit = pat["String"]
            rx_spans = lambda p: [            # noqa: E731
                (m.start(), m.end())
                for m in re.finditer(re.escape(lit), p)]
        else:
            sp = _SplitPattern(pat["Regex"])
            rx_spans = sp.findall
        behavior = pre.get("behavior", "Removed")
        invert = pre.get("invert", False)
        return [q for p in pieces
                for q in _split_piece(p, rx_spans(p), behavior, invert)]
    if t == "Metaspace":
        rep = pre.get("replacement", "▁")
        scheme = pre.get("prepend_scheme",
                         "always" if pre.get("add_prefix_space", True)
                         else "never")
        out = []
        for i, p in enumerate(pieces):
            p = p.replace(" ", rep)
            if (scheme == "always" or (scheme == "first" and i == 0)) \
                    and not p.startswith(rep):
                p = rep + p
            # split keeping rep attached to the following fragment
            segs = re.split(f"(?={re.escape(rep)})", p)
            out.extend(s for s in segs if s)
        return out
    if t == "Whitespace":
        return [m.group(0) for p in pieces
                for m in re.finditer(r"\w+|[^\w\s]+", p)]
    if t == "WhitespaceSplit":
        return [q for p in pieces for q in p.split()]
    if t == "Digits":
        individual = pre.get("individual_digits", False)
        rx = r"\d" if individual else r"\d+"
        out = []
        for p in pieces:
            out.extend(q for q in re.split(f"({rx})", p) if q)
        return out
    raise ValueError(f"unsupported pre_tokenizer type {t!r}")


# -------------------------------------------------------------- BPE model

class _BPE:
    def __init__(self, model: dict):
        self.vocab: dict[str, int] = model["vocab"]
        merges = model.get("merges", [])
        self.ranks: dict[tuple[str, str], int] = {}
        for i, m in enumerate(merges):
            pair = tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
            self.ranks[pair] = i
        self.unk = model.get("unk_token")
        self.fuse_unk = model.get("fuse_unk", False)
        self.byte_fallback = model.get("byte_fallback", False)
        self.ignore_merges = model.get("ignore_merges", False)
        self.cont_prefix = model.get("continuing_subword_prefix") or ""
        self.eow_suffix = model.get("end_of_word_suffix") or ""
        self._cache: dict[str, list[str]] = {}

    def _merge_word(self, word: str) -> list[str]:
        if self.ignore_merges and word in self.vocab:
            return [word]
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        syms = list(word)
        if self.cont_prefix:
            syms = [syms[0]] + [self.cont_prefix + s for s in syms[1:]]
        if self.eow_suffix and syms:
            syms[-1] = syms[-1] + self.eow_suffix
        while len(syms) > 1:
            best, best_rank = None, None
            for i in range(len(syms) - 1):
                r = self.ranks.get((syms[i], syms[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            syms = (syms[:best] + [syms[best] + syms[best + 1]]
                    + syms[best + 2:])
        if len(self._cache) < 32768:
            self._cache[word] = syms
        return syms

    def encode_word(self, word: str) -> list[int]:
        ids: list[int] = []
        prev_unk = False
        for sym in self._merge_word(word):
            tid = self.vocab.get(sym)
            if tid is not None:
                ids.append(tid)
                prev_unk = False
                continue
            if self.byte_fallback:
                btoks = [f"<0x{b:02X}>" for b in sym.encode("utf-8")]
                if all(b in self.vocab for b in btoks):
                    ids.extend(self.vocab[b] for b in btoks)
                    prev_unk = False
                    continue
            if self.unk is not None:
                if not (self.fuse_unk and prev_unk):
                    ids.append(self.vocab[self.unk])
                prev_unk = True
        return ids


# ----------------------------------------------------------- added tokens

class _AddedToken:
    __slots__ = ("id", "content", "lstrip", "rstrip", "special",
                 "normalized", "single_word")

    def __init__(self, spec: dict):
        self.id = spec["id"]
        self.content = spec["content"]
        self.lstrip = spec.get("lstrip", False)
        self.rstrip = spec.get("rstrip", False)
        self.special = spec.get("special", False)
        self.normalized = spec.get("normalized", False)
        self.single_word = spec.get("single_word", False)


# -------------------------------------------------------------- tokenizer

class HFTokenizer:
    """Drop-in minimal stand-in for a HF fast tokenizer: `encode`,
    `decode`, and the `tok(text, return_tensors="np")["input_ids"]`
    calling convention the runtimes use."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.normalizer = spec.get("normalizer")
        self.pre_tokenizer = spec.get("pre_tokenizer")
        model = spec.get("model") or {}
        if model.get("type") not in ("BPE", None):
            raise ValueError(
                f"unsupported model type {model.get('type')!r} — BPE only "
                "(SentencePiece .model files go through frontend/spm.py)")
        self.model = _BPE(model)
        self.added = sorted((_AddedToken(a) for a in
                             spec.get("added_tokens", [])),
                            key=lambda a: -len(a.content))
        self._added_by_content = {a.content: a for a in self.added}
        self.post = spec.get("post_processor")
        self.id_to_token: dict[int, str] = {
            v: k for k, v in self.model.vocab.items()}
        for a in self.added:
            self.id_to_token[a.id] = a.content
        self._added_rx = None
        if self.added:
            alt = "|".join(re.escape(a.content) for a in self.added)
            self._added_rx = re.compile(f"({alt})")

    # -- loading -----------------------------------------------------

    @classmethod
    def load(cls, tokenizer_json_path: str) -> "HFTokenizer":
        with open(tokenizer_json_path, encoding="utf-8") as f:
            return cls(json.load(f))

    @classmethod
    def from_pretrained(cls, ckpt_dir: str) -> "HFTokenizer":
        path = os.path.join(ckpt_dir, "tokenizer.json")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found — this reader needs the fast-tokenizer "
                "JSON; for SentencePiece checkpoints use frontend/spm.py")
        return cls.load(path)

    # -- encoding ----------------------------------------------------

    def _encode_segment(self, text: str) -> list[int]:
        if not text:
            return []
        text = _apply_normalizer(self.normalizer, text)
        pieces = _pretokenize(self.pre_tokenizer, [text])
        ids: list[int] = []
        for piece in pieces:
            ids.extend(self.model.encode_word(piece))
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        segments: list[tuple[str, _AddedToken | None]] = []
        if self._added_rx is not None:
            parts = self._added_rx.split(text)
            for part in parts:
                tok = self._added_by_content.get(part)
                segments.append((part, tok))
        else:
            segments.append((text, None))
        # lstrip/rstrip: added tokens may eat adjacent whitespace
        ids: list[int] = []
        pending_rstrip = False
        for i, (part, tok) in enumerate(segments):
            if tok is not None:
                ids.append(tok.id)
                pending_rstrip = tok.rstrip
                continue
            if pending_rstrip:
                part = part.lstrip()
                pending_rstrip = False
            nxt = segments[i + 1][1] if i + 1 < len(segments) else None
            if nxt is not None and nxt.lstrip:
                part = part.rstrip()
            ids.extend(self._encode_segment(part))
        if add_special_tokens:
            ids = self._apply_template(ids)
        return ids

    def _apply_template(self, ids: list[int]) -> list[int]:
        post = self.post
        if post is None:
            return ids
        if post["type"] == "Sequence":
            procs = post["processors"]
        else:
            procs = [post]
        for proc in procs:
            if proc["type"] == "ByteLevel":
                continue
            if proc["type"] != "TemplateProcessing":
                raise ValueError(
                    f"unsupported post_processor {proc['type']!r}")
            specials = proc.get("special_tokens", {})
            out: list[int] = []
            for item in proc.get("single", []):
                if "Sequence" in item:
                    out.extend(ids)
                elif "SpecialToken" in item:
                    name = item["SpecialToken"]["id"]
                    out.extend(specials[name]["ids"])
            ids = out
        return ids

    def __call__(self, text: str, return_tensors: str | None = None,
                 add_special_tokens: bool = True) -> dict:
        ids = self.encode(text, add_special_tokens=add_special_tokens)
        if return_tensors == "np":
            arr = np.asarray([ids], dtype=np.int64)
            return {"input_ids": arr,
                    "attention_mask": np.ones_like(arr)}
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    # -- HF-compat surface (CharTokenizerWrapper and friends) --------

    @property
    def vocab(self) -> dict[str, int]:
        v = dict(self.model.vocab)
        for a in self.added:
            v[a.content] = a.id
        return v

    def tokenize(self, text: str) -> list[str]:
        ids = self.encode(text, add_special_tokens=False)
        return [self.id_to_token.get(i, "") for i in ids]

    def convert_tokens_to_ids(self, tokens) -> list[int]:
        if isinstance(tokens, str):
            tokens = [tokens]
        out = []
        for t in tokens:
            a = self._added_by_content.get(t)
            if a is not None:
                out.append(a.id)
                continue
            tid = self.model.vocab.get(t)
            if tid is None:
                # a raw char produced by splitting a multi-char token may
                # need re-encoding (e.g. per-char Chinese)
                enc = self.model.encode_word(t)
                if len(enc) == 1:
                    out.append(enc[0])
                    continue
                unk = self.model.unk
                out.append(self.model.vocab.get(unk, 0) if unk else 0)
            else:
                out.append(tid)
        return out

    # -- decoding ----------------------------------------------------

    def convert_ids_to_tokens(self, ids) -> list[str]:
        return [self.id_to_token.get(int(i), "") for i in ids]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        dec = _unicode_to_bytes()
        out_bytes = bytearray()
        byte_level = self._is_byte_level()
        for i in ids:
            i = int(i)
            tok = self.id_to_token.get(i, "")
            if self.model.byte_fallback:
                m = re.fullmatch(r"<0x([0-9A-Fa-f]{2})>", tok)
                if m:
                    out_bytes.append(int(m.group(1), 16))
                    continue
            added = self._added_by_content.get(tok)
            if added is not None:
                if skip_special_tokens and added.special:
                    continue
                out_bytes.extend(tok.encode("utf-8"))
                continue
            if byte_level:
                out_bytes.extend(dec.get(c, ord("?")) for c in tok)
            else:
                out_bytes.extend(tok.replace("▁", " ").encode("utf-8"))
        return out_bytes.decode("utf-8", errors="replace")

    def _is_byte_level(self) -> bool:
        def scan(pre) -> bool:
            if pre is None:
                return False
            if pre["type"] == "ByteLevel":
                return True
            if pre["type"] == "Sequence":
                return any(scan(p) for p in pre["pretokenizers"])
            return False

        dec = self.spec.get("decoder")
        return scan(self.pre_tokenizer) or (
            dec is not None and dec.get("type") == "ByteLevel")

    def __len__(self) -> int:
        return max(self.id_to_token) + 1 if self.id_to_token else 0
