"""Self-contained SentencePiece model reader + encoder (zero dependencies;
a copy of tts_tpu/frontend/spm.py).

The IndexTTS frontend is the upstream sentencepiece BPE tokenizer
(IndexTTS/Export_IndexTTS.py:809-1010 loads `bpe.model`).
The `sentencepiece` wheel is not available in every deployment image, so
this module reads the `.model` protobuf directly and reimplements the two
encoding algorithms (BPE merge-by-score and unigram Viterbi) in pure
Python. With it, a real checkpoint's `.model` file produces the exact
upstream token ids without the native library.

Format: `.model` is a serialized `sentencepiece.ModelProto`
(https://github.com/google/sentencepiece/blob/master/src/sentencepiece_model.proto):

    message ModelProto {
      repeated SentencePiece pieces = 1;   // piece=1 str, score=2 float,
                                           // type=3 enum (NORMAL=1,
                                           // UNKNOWN=2, CONTROL=3,
                                           // USER_DEFINED=4, UNUSED=5,
                                           // BYTE=6)
      TrainerSpec trainer_spec = 2;        // model_type=3 (UNIGRAM=1,
                                           // BPE=2), byte_fallback=35,
                                           // unk_id=40, bos_id=41,
                                           // eos_id=42, pad_id=43,
                                           // treat_whitespace_as_suffix=24
      NormalizerSpec normalizer_spec = 3;  // name=1, precompiled_charsmap=2,
                                           // add_dummy_prefix=3,
                                           // remove_extra_whitespaces=4,
                                           // escape_whitespaces=5
    }

Only the wire features protobuf actually emits are handled (varint,
64-bit, length-delimited, 32-bit); unknown fields are skipped, so future
proto additions don't break the reader.

Normalization: the shipped models use the `nmt_nfkc` rule compiled into
`precompiled_charsmap` (a double-array trie we do not interpret). We
approximate it as documented NFKC + NMT whitespace/control rules — an
EXACT match for ASCII/CJK TTS text (the nmt_nfkc deltas beyond NFKC are
control-char stripping and unicode-space folding, both implemented); rare
compatibility codepoints may differ. `identity`-normalizer models are
handled exactly.

Encoding algorithms mirror the C++ (bpe_model.cc / unigram_model.cc):
  * BPE: repeatedly merge the adjacent symbol pair whose concatenation is
    an in-vocab NORMAL piece with the highest score (ties: leftmost),
    via a lazy-deletion heap.
  * Unigram: Viterbi over all trie matches per position; unknown chars
    score `min_score - 10.0` (kUnkPenalty); consecutive unknown pieces
    merge into one unk token.
  * byte_fallback: unmatched chars emit their UTF-8 bytes as `<0xXX>`
    pieces when the model defines BYTE pieces.
"""
from __future__ import annotations

import struct
import unicodedata

__all__ = ["SentencePieceModel"]

# SentencePiece.Type values
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6

_UNIGRAM, _BPE, _WORD, _CHAR = 1, 2, 3, 4
_UNK_PENALTY = 10.0  # unigram_model.cc kUnkPenalty
_WS = "▁"       # the sentencepiece whitespace escape


# ---------------------------------------------------------------- protobuf

def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) for one message body.
    Length-delimited values come back as bytes; varints as int;
    fixed32/64 as raw bytes."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:                       # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:                     # 64-bit
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:                     # length-delimited
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wire == 5:                     # 32-bit
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _zigzag_int32(v: int) -> int:
    """protobuf int32 fields arrive as 64-bit two's-complement varints."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------- the model

class SentencePieceModel:
    """Reader/encoder for a serialized sentencepiece ModelProto.

    API mirrors the subset of `SentencePieceProcessor` the frontends use:
    `encode`, `encode_as_pieces`, `piece_to_id`, `id_to_piece`, `decode`.
    """

    def __init__(self, pieces: list[tuple[str, float, int]],
                 model_type: int = _BPE,
                 unk_id: int = 0,
                 add_dummy_prefix: bool = True,
                 remove_extra_whitespaces: bool = True,
                 escape_whitespaces: bool = True,
                 treat_whitespace_as_suffix: bool = False,
                 byte_fallback: bool = False,
                 normalizer_name: str = "nmt_nfkc"):
        self.pieces = pieces
        self.model_type = model_type
        self.unk_id = unk_id
        self.add_dummy_prefix = add_dummy_prefix
        self.remove_extra_whitespaces = remove_extra_whitespaces
        self.escape_whitespaces = escape_whitespaces
        self.treat_whitespace_as_suffix = treat_whitespace_as_suffix
        self.normalizer_name = normalizer_name

        self._piece_to_id: dict[str, int] = {}
        self._byte_to_id: dict[int, int] = {}
        # trie for unigram/user-defined matching: nested dicts,
        # None key holds (id, score)
        self._trie: dict = {}
        self._max_piece_chars = 1
        self._min_score = 0.0
        for idx, (piece, score, typ) in enumerate(pieces):
            if piece not in self._piece_to_id:   # first wins, like the C++
                self._piece_to_id[piece] = idx
            if typ == _BYTE:
                # piece text is "<0xNN>"
                self._byte_to_id[int(piece[3:5], 16)] = idx
            if typ in (_NORMAL, _USER_DEFINED):
                node = self._trie
                for ch in piece:
                    node = node.setdefault(ch, {})
                node[None] = (idx, score)
                self._max_piece_chars = max(self._max_piece_chars, len(piece))
                self._min_score = min(self._min_score, score)
        self.byte_fallback = byte_fallback or bool(self._byte_to_id)

    # -- construction -------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    @classmethod
    def from_bytes(cls, data: bytes) -> "SentencePieceModel":
        pieces: list[tuple[str, float, int]] = []
        kw: dict = {}
        unk_id_field = None
        unk_id_from_type = None
        try:
            parsed = cls._parse_model_fields(data, pieces, kw)
        except (IndexError, ValueError, UnicodeDecodeError, struct.error) as e:
            raise ValueError(
                f"not a sentencepiece ModelProto: {e}") from None
        unk_id_field, unk_id_from_type = parsed
        if not pieces:
            raise ValueError(
                "not a sentencepiece ModelProto: no pieces found")
        if unk_id_field is not None and unk_id_field >= 0:
            kw["unk_id"] = unk_id_field
        elif unk_id_from_type is not None:
            kw["unk_id"] = unk_id_from_type
        return cls(pieces, **kw)

    @staticmethod
    def _parse_model_fields(data: bytes, pieces: list, kw: dict):
        unk_id_field = None
        unk_id_from_type = None
        for field, wire, val in _fields(data):
            if field == 1 and wire == 2:                 # SentencePiece
                piece, score, typ = "", 0.0, _NORMAL
                for f2, w2, v2 in _fields(val):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        typ = v2
                if typ == _UNKNOWN and unk_id_from_type is None:
                    unk_id_from_type = len(pieces)
                pieces.append((piece, score, typ))
            elif field == 2 and wire == 2:               # TrainerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 3:
                        kw["model_type"] = v2
                    elif f2 == 24:
                        kw["treat_whitespace_as_suffix"] = bool(v2)
                    elif f2 == 35:
                        kw["byte_fallback"] = bool(v2)
                    elif f2 == 40:
                        unk_id_field = _zigzag_int32(v2)
            elif field == 3 and wire == 2:               # NormalizerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 1:
                        kw["normalizer_name"] = v2.decode("utf-8")
                    elif f2 == 3:
                        kw["add_dummy_prefix"] = bool(v2)
                    elif f2 == 4:
                        kw["remove_extra_whitespaces"] = bool(v2)
                    elif f2 == 5:
                        kw["escape_whitespaces"] = bool(v2)
        return unk_id_field, unk_id_from_type

    # -- vocabulary ---------------------------------------------------

    def __len__(self) -> int:
        return len(self.pieces)

    def piece_to_id(self, piece: str) -> int:
        return self._piece_to_id.get(piece, self.unk_id)

    def id_to_piece(self, idx: int) -> str:
        return self.pieces[idx][0]

    # sentencepiece-compatible aliases (drop-in for SentencePieceProcessor);
    # EncodeAsPieces/EncodeAsIds are added after the methods are defined
    PieceToId = piece_to_id
    IdToPiece = id_to_piece

    # -- normalization --------------------------------------------------

    def _normalize(self, text: str) -> str:
        if self.normalizer_name != "identity":
            # nmt_nfkc approximation: NFKC, then the NMT rules — unicode
            # spaces and \t\r\n fold to ASCII space, other control/format
            # chars are dropped.
            text = unicodedata.normalize("NFKC", text)
            out = []
            for ch in text:
                if ch in "\t\r\n" or unicodedata.category(ch) == "Zs":
                    out.append(" ")
                elif unicodedata.category(ch) in ("Cc", "Cf"):
                    continue
                else:
                    out.append(ch)
            text = "".join(out)
        if self.remove_extra_whitespaces:
            text = " ".join(t for t in text.split(" ") if t)
        if not text:
            return text
        if self.add_dummy_prefix:
            text = text + " " if self.treat_whitespace_as_suffix else " " + text
        if self.escape_whitespaces:
            text = text.replace(" ", _WS)
        return text

    # -- trie matching ---------------------------------------------------

    def _matches(self, text: str, start: int):
        """Yield (end, id, score) for every vocab piece starting at start."""
        node = self._trie
        end = start
        limit = min(len(text), start + self._max_piece_chars)
        while end < limit:
            node = node.get(text[end])
            if node is None:
                return
            end += 1
            hit = node.get(None)
            if hit is not None:
                yield end, hit[0], hit[1]

    # -- encoders ---------------------------------------------------------

    def encode_as_pieces(self, text: str) -> list[str]:
        """Surface pieces: in-vocab segments verbatim, unknown segments as
        their raw surface (or expanded to `<0xXX>` byte pieces under byte
        fallback) — matching SentencePieceProcessor.EncodeAsPieces."""
        out: list[str] = []
        for s in self._segments(text):
            if s in self._piece_to_id or not self.byte_fallback:
                out.append(s)
            else:
                out.extend(self.pieces[self._byte_to_id[b]][0]
                           if b in self._byte_to_id else s
                           for b in s.encode("utf-8"))
        return out

    def encode(self, text: str) -> list[int]:
        return self._finalize(self._segments(text))

    def _segments(self, text: str) -> list[str]:
        text = self._normalize(text)
        if not text:
            return []
        if self.model_type == _BPE:
            return self._encode_bpe(text)
        if self.model_type == _UNIGRAM:
            return self._encode_unigram(text)
        if self.model_type == _CHAR:
            return list(text)
        if self.model_type == _WORD:
            return [_WS + t for t in text.split(_WS) if t]
        raise ValueError(f"unsupported model_type {self.model_type}")

    def _finalize(self, segs: list[str]) -> list[int]:
        """Surface strings -> ids, applying byte fallback for unknowns.

        Only NORMAL/USER_DEFINED pieces are reachable from raw text —
        a surface that happens to spell a CONTROL piece (user typing
        '</s>') must NOT resolve to that id, or text could inject EOS
        into the stream (matching sentencepiece, where control pieces
        are never matched by the trie)."""
        ids: list[int] = []
        for s in segs:
            idx = self._piece_to_id.get(s)
            if idx is not None and self.pieces[idx][2] in (_NORMAL,
                                                           _USER_DEFINED):
                ids.append(idx)
            elif self.byte_fallback:
                for b in s.encode("utf-8"):
                    ids.append(self._byte_to_id.get(b, self.unk_id))
            else:
                ids.append(self.unk_id)
        return ids

    def _encode_bpe(self, text: str) -> list[str]:
        """bpe_model.cc: agenda of adjacent-pair merges ordered by
        (score desc, left position asc), lazy-deletion heap."""
        import heapq

        sym = list(text)              # active symbol strings
        nxt = list(range(1, len(sym))) + [-1]
        prv = [-1] + list(range(len(sym) - 1))
        alive = [True] * len(sym)
        version = [0] * len(sym)      # bump on merge to invalidate heap rows

        heap: list[tuple[float, int, int, int, int, str]] = []

        def push(left: int, right: int):
            merged = sym[left] + sym[right]
            node = self._trie
            for ch in merged:
                node = node.get(ch)
                if node is None:
                    return
            hit = node.get(None)
            if hit is None:
                return
            heapq.heappush(heap, (-hit[1], left, version[left],
                                  version[right], right, merged))

        for i in range(len(sym) - 1):
            push(i, i + 1)

        while heap:
            _, left, vl, vr, right, merged = heapq.heappop(heap)
            if (not alive[left] or not alive[right]
                    or version[left] != vl or version[right] != vr
                    or nxt[left] != right):
                continue
            sym[left] = merged
            version[left] += 1
            alive[right] = False
            nxt[left] = nxt[right]
            if nxt[right] != -1:
                prv[nxt[right]] = left
            if prv[left] != -1:
                push(prv[left], left)
            if nxt[left] != -1:
                push(left, nxt[left])

        out: list[str] = []
        i = 0
        while i != -1:
            if alive[i]:
                out.append(sym[i])
            i = nxt[i]
        return out

    def _encode_unigram(self, text: str) -> list[str]:
        """Viterbi best segmentation; consecutive unknown chars merge into
        one surface (unigram_model.cc Model::Encode)."""
        n = len(text)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: list[tuple[int, bool] | None] = [None] * (n + 1)  # (start, is_unk)
        best[0] = 0.0
        unk_score = self._min_score - _UNK_PENALTY
        for i in range(n):
            if best[i] == NEG:
                continue
            has_single = False
            for end, _idx, score in self._matches(text, i):
                has_single = has_single or end == i + 1
                if best[i] + score > best[end]:
                    best[end] = best[i] + score
                    back[end] = (i, False)
            # the unk edge exists only where no single-char piece matches
            # (unigram_model.cc PopulateNodes `has_single_node`)
            if not has_single and best[i] + unk_score > best[i + 1]:
                best[i + 1] = best[i] + unk_score
                back[i + 1] = (i, True)
        # walk back
        segs: list[tuple[str, bool]] = []
        pos = n
        while pos > 0:
            start, is_unk = back[pos]
            segs.append((text[start:pos], is_unk))
            pos = start
        segs.reverse()
        # merge consecutive unknowns into one surface
        out: list[str] = []
        prev_unk = False
        for s, is_unk in segs:
            if is_unk and prev_unk:
                out[-1] += s
            else:
                out.append(s)
            prev_unk = is_unk
        return out

    # -- decode -----------------------------------------------------------

    def decode(self, ids: list[int]) -> str:
        out: list[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for idx in ids:
            piece, _score, typ = self.pieces[idx]
            if typ == _BYTE:
                byte_buf.append(int(piece[3:5], 16))
                continue
            flush()
            if typ in (_CONTROL, _UNUSED):
                continue
            out.append(piece)
        flush()
        text = "".join(out).replace(_WS, " ")
        return text[1:] if text.startswith(" ") and self.add_dummy_prefix else text

    EncodeAsPieces = encode_as_pieces
    EncodeAsIds = encode
    Decode = decode
    GetPieceSize = __len__
