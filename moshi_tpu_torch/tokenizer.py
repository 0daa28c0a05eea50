"""Pure-Python SentencePiece unigram tokenizer.

A copy of ``moshi_tpu/tokenizer.py`` (pure
Python; the port imports nothing of the JAX package).

The reference wraps the SentencePiece C++ library
(reference src/moshi.cpp:370-598: tokenizer_alloc/send/receive,
id_to_piece, BOS insertion).  The package takes no sentencepiece
binding, so it implements the needed subset from scratch:

  * a protobuf wire-format reader for the ``.model`` ModelProto — only
    field 1 (repeated SentencePiece {piece=1, score=2, type=3}) is needed;
  * unigram Viterbi encoding over a piece trie with whitespace -> U+2581
    normalization and dummy-prefix handling;
  * byte-fallback (<0xNN> pieces) for out-of-vocabulary characters;
  * decode back to text.

This matches SentencePiece's default unigram inference semantics (greedy
max-score segmentation via dynamic programming).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

SPACE = "▁"  # ▁

# SentencePiece piece types (sentencepiece_model.proto)
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_BYTE = 6
TYPE_UNUSED = 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _parse_sentence_piece(buf: bytes) -> Tuple[str, float, int]:
    piece, score, ptype = "", 0.0, TYPE_NORMAL
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        fieldno, wt = tag >> 3, tag & 7
        if fieldno == 1 and wt == 2:          # piece
            ln, pos = _read_varint(buf, pos)
            piece = buf[pos:pos + ln].decode("utf-8", errors="replace")
            pos += ln
        elif fieldno == 2 and wt == 5:        # score (float)
            score = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif fieldno == 3 and wt == 0:        # type
            ptype, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wt)
    return piece, score, ptype


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    pieces = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        fieldno, wt = tag >> 3, tag & 7
        if fieldno == 1 and wt == 2:          # repeated SentencePiece
            ln, pos = _read_varint(data, pos)
            pieces.append(_parse_sentence_piece(data[pos:pos + ln]))
            pos += ln
        else:
            pos = _skip_field(data, pos, wt)
    return pieces


class SentencePieceTokenizer:
    def __init__(self, pieces: List[Tuple[str, float, int]]):
        self.pieces = pieces
        self.piece_to_id: Dict[str, int] = {}
        self.byte_to_id: Dict[int, int] = {}
        self.unk_id = 0
        for i, (piece, score, ptype) in enumerate(pieces):
            if piece not in self.piece_to_id:
                self.piece_to_id[piece] = i
            if ptype == TYPE_UNKNOWN:
                self.unk_id = i
            if ptype == TYPE_BYTE and len(piece) == 6 and piece.startswith("<0x"):
                self.byte_to_id[int(piece[3:5], 16)] = i
        self.max_piece_len = max((len(p) for p, _, t in pieces
                                  if t in (TYPE_NORMAL, TYPE_USER_DEFINED)),
                                 default=1)

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceTokenizer":
        with open(path, "rb") as fh:
            return cls(parse_model_proto(fh.read()))

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def _normalize(self, text: str) -> str:
        # default SentencePiece normalization relevant to inference:
        # whitespace -> ▁ with a dummy prefix
        text = " ".join(text.split())
        return SPACE + text.replace(" ", SPACE)

    def encode(self, text: str) -> List[int]:
        """Viterbi segmentation maximizing total piece score."""
        if not text:
            return []
        s = self._normalize(text)
        n = len(s)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        unk_penalty = min((sc for _, sc, t in self.pieces
                           if t == TYPE_NORMAL), default=-10.0) - 10.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            matched = False
            upper = min(n, i + self.max_piece_len)
            for j in range(i + 1, upper + 1):
                pid = self.piece_to_id.get(s[i:j])
                if pid is None:
                    continue
                ptype = self.pieces[pid][2]
                if ptype in (TYPE_CONTROL, TYPE_UNUSED):
                    continue
                matched = True
                cand = best[i] + self.pieces[pid][1]
                if cand > best[j]:
                    best[j] = cand
                    back[j] = (i, pid)
            if not matched or back[i + 1] is None:
                # unk / byte-fallback for a single character
                ch = s[i]
                cand = best[i] + unk_penalty
                if cand > best[i + 1]:
                    best[i + 1] = cand
                    back[i + 1] = (i, -1)  # -1 marks fallback for s[i]
        # backtrack
        out: List[int] = []
        j = n
        while j > 0:
            i, pid = back[j]
            if pid == -1:
                ch = s[i:j]
                bs = ch.encode("utf-8")
                if self.byte_to_id:
                    out.extend(self.byte_to_id.get(b, self.unk_id)
                               for b in reversed(bs))
                else:
                    out.append(self.unk_id)
            else:
                out.append(pid)
            j = i
        out.reverse()
        return out

    def decode(self, ids: List[int]) -> str:
        parts: List[str] = []
        byte_acc: List[int] = []

        def flush_bytes():
            if byte_acc:
                parts.append(bytes(byte_acc).decode("utf-8", errors="replace"))
                byte_acc.clear()

        for i in ids:
            if not 0 <= i < len(self.pieces):
                continue
            piece, _, ptype = self.pieces[i]
            if ptype == TYPE_BYTE:
                byte_acc.append(int(piece[3:5], 16))
                continue
            flush_bytes()
            if ptype == TYPE_CONTROL:
                continue
            parts.append(piece)
        flush_bytes()
        return "".join(parts).replace(SPACE, " ").lstrip(" ")

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i][0] if 0 <= i < len(self.pieces) else ""


def save_model_proto(pieces: List[Tuple[str, float, int]]) -> bytes:
    """Serialize a minimal ModelProto (for tests / model authoring)."""
    def varint(v: int) -> bytes:
        out = b""
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b | 0x80])
            else:
                return out + bytes([b])

    blob = b""
    for piece, score, ptype in pieces:
        pb = piece.encode("utf-8")
        inner = (bytes([0x0A]) + varint(len(pb)) + pb +
                 bytes([0x15]) + struct.pack("<f", score) +
                 bytes([0x18]) + varint(ptype))
        blob += bytes([0x0A]) + varint(len(inner)) + inner
    return blob


class StreamingTextTokenizer:
    """Incremental word-splitting tokenizer front-end for interactive TTS.

    Capability parity with the reference's streaming tokenizer wrapper
    (reference src/moshi.cpp:489-594: tokenizer_send/receive with
    incremental word splitting, a <break time="Ns"/> parsing FSM that can
    span chunk boundaries, and BOS insertion on the first word).

    send(text) buffers; receive(frame_rate) yields (tokens, word, padding)
    triples for every *complete* word (flush() drains the remainder).
    """

    _BREAK_PREFIX = '<break'

    def __init__(self, tokenizer, insert_bos: bool = True, bos_id: int = 1,
                 padding_between: int = 1):
        self.tok = tokenizer
        self.insert_bos = insert_bos
        self.bos_id = bos_id
        self.padding_between = padding_between
        self.buffer = ""
        self.first_word = True

    def send(self, text: str):
        self.buffer += text

    def _emit(self, word: str, frame_rate: float):
        import re as _re
        m = _re.fullmatch(r'<break\s+time="([0-9]+(?:\.[0-9]*)?)s"\s*/?>',
                          word)
        if m:
            return ([], word, int(float(m.group(1)) * frame_rate))
        tokens = list(self.tok.encode(word))
        if self.first_word and self.insert_bos:
            tokens = [self.bos_id] + tokens
            self.first_word = False
        padding = 0
        if self.padding_between > 0:
            padding = max(self.padding_between + len(tokens) - 1, 0)
        return (tokens, word, padding)

    def _split_complete(self, final: bool):
        """Yield complete word strings, keeping incomplete tails."""
        out = []
        buf = self.buffer
        pos = 0
        while pos < len(buf):
            while pos < len(buf) and buf[pos].isspace():
                pos += 1
            if pos >= len(buf):
                break
            if buf.startswith(self._BREAK_PREFIX, pos) or \
                    (not final and self._BREAK_PREFIX.startswith(
                        buf[pos:pos + len(self._BREAK_PREFIX)])):
                end = buf.find(">", pos)
                if end < 0:
                    if final:
                        out.append(buf[pos:])
                        pos = len(buf)
                    break  # wait for the rest of the tag
                out.append(buf[pos:end + 1])
                pos = end + 1
                continue
            end = pos
            while end < len(buf) and not buf[end].isspace():
                end += 1
            if end == len(buf) and not final:
                break  # incomplete word
            out.append(buf[pos:end])
            pos = end
        self.buffer = buf[pos:]
        return out

    def receive(self, frame_rate: float = 12.5, final: bool = False):
        return [self._emit(w, frame_rate)
                for w in self._split_complete(final) if w]

    def flush(self, frame_rate: float = 12.5):
        return self.receive(frame_rate, final=True)
