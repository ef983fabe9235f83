"""Pure-Python SentencePiece: loads standard `.model` protobufs and encodes with
unigram Viterbi / BPE merges. No C++ dependency.

The reference uses the `sentencepiece` C++ wheel (conditioners/text.py:13-35);
tokenization runs only on the host, so a self-contained implementation is the
right dependency posture. A copy of pocket_tts_tpu/text/sentencepiece.py; tests
hold the two to the same tokens. The
`.model` file is a protobuf (ModelProto); the wire format is parsed directly —
fields used: pieces (id 1: piece=1, score=2, type=3), trainer_spec (id 2:
unk_id=40, bos_id=41, eos_id=42, model_type=3), normalizer_spec (id 3:
add_dummy_prefix=2, remove_extra_whitespaces=4, escape_whitespaces=5).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

SPACE = "▁"  # ▁

# piece types (ModelProto.SentencePiece.Type)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, BYTE, UNUSED = 1, 2, 3, 4, 6, 5


def _parse_wire(data: bytes, pos: int = 0, end: int | None = None):
    """Yield (field_number, wire_type, value) triples from a protobuf buffer."""
    if end is None:
        end = len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(data, pos)
        elif wtype == 1:  # 64-bit
            val, pos = data[pos : pos + 8], pos + 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(data, pos)
            val, pos = data[pos : pos + ln], pos + ln
        elif wtype == 5:  # 32-bit
            val, pos = data[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _f32(raw: bytes) -> float:
    import struct

    return struct.unpack("<f", raw)[0]


@dataclass
class Piece:
    text: str
    score: float
    type: int = NORMAL


@dataclass
class SentencePieceModel:
    pieces: list[Piece]
    model_type: int = 1  # 1=unigram, 2=bpe
    unk_id: int = 0
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    _index: dict[str, int] = field(default_factory=dict)
    _byte_pieces: dict[int, int] = field(default_factory=dict)
    _max_piece_len: int = 1

    def __post_init__(self):
        for i, p in enumerate(self.pieces):
            if p.type in (NORMAL, USER_DEFINED) and p.text not in self._index:
                self._index[p.text] = i
            if p.type == BYTE:
                self._byte_pieces[int(p.text[1:-1], 16)] = i
            self._max_piece_len = max(self._max_piece_len, len(p.text))

    # -- loading ------------------------------------------------------------

    @classmethod
    def load(cls, path: str | Path) -> "SentencePieceModel":
        data = Path(path).read_bytes()
        pieces: list[Piece] = []
        kw: dict = {}
        for fnum, wtype, val in _parse_wire(data):
            if fnum == 1 and wtype == 2:  # SentencePiece
                text, score, ptype = "", 0.0, NORMAL
                for f2, w2, v2 in _parse_wire(val):
                    if f2 == 1:
                        text = v2.decode("utf-8")
                    elif f2 == 2:
                        score = _f32(v2)
                    elif f2 == 3:
                        ptype = v2
                pieces.append(Piece(text, score, ptype))
            elif fnum == 2 and wtype == 2:  # TrainerSpec
                for f2, w2, v2 in _parse_wire(val):
                    if f2 == 3:  # model_type string? no: it's enum in field 3
                        kw["model_type"] = v2 if isinstance(v2, int) else kw.get("model_type", 1)
                    elif f2 == 40:
                        kw["unk_id"] = v2
            elif fnum == 3 and wtype == 2:  # NormalizerSpec
                for f2, w2, v2 in _parse_wire(val):
                    if f2 == 2:
                        kw["add_dummy_prefix"] = bool(v2)
                    elif f2 == 4:
                        kw["remove_extra_whitespaces"] = bool(v2)
                    elif f2 == 5:
                        kw["escape_whitespaces"] = bool(v2)
        return cls(pieces=pieces, **kw)

    # -- API ---------------------------------------------------------------

    def vocab_size(self) -> int:
        return len(self.pieces)

    def normalize(self, text: str) -> str:
        if self.remove_extra_whitespaces:
            text = " ".join(s for s in text.split(" ") if s != "")
        if self.add_dummy_prefix:
            text = " " + text
        if self.escape_whitespaces:
            text = text.replace(" ", SPACE)
        return text

    def encode(self, text: str) -> list[int]:
        text = self.normalize(text)
        if not text:
            return []
        if self.model_type == 2:
            return self._encode_bpe(text)
        return self._encode_unigram(text)

    def _encode_unigram(self, text: str) -> list[int]:
        """Viterbi best segmentation under piece log-probs."""
        n = len(text)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        best[0] = 0.0
        unk_penalty = min((p.score for p in self.pieces), default=0.0) - 10.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            limit = min(n, i + self._max_piece_len)
            matched = False
            for j in range(i + 1, limit + 1):
                pid = self._index.get(text[i:j])
                if pid is None:
                    continue
                matched = True
                s = best[i] + self.pieces[pid].score
                if s > best[j]:
                    best[j], back[j] = s, (i, pid)
            # unk fallback: single char
            if not matched or back[i + 1] is None:
                s = best[i] + unk_penalty
                if s > best[i + 1]:
                    best[i + 1], back[i + 1] = s, (i, -1)
        ids: list[int] = []
        j = n
        while j > 0:
            i, pid = back[j]
            if pid == -1:
                ids.extend(reversed(self._bytes_or_unk(text[i:j])))
            else:
                ids.append(pid)
            j = i
        ids.reverse()
        return ids

    def _bytes_or_unk(self, segment: str) -> list[int]:
        if self._byte_pieces:
            return [self._byte_pieces[b] for b in segment.encode("utf-8")]
        return [self.unk_id]

    def _encode_bpe(self, text: str) -> list[int]:
        """Greedy best-pair merging by piece score."""
        symbols = list(text)
        while True:
            best_score, best_i = None, -1
            for i in range(len(symbols) - 1):
                pid = self._index.get(symbols[i] + symbols[i + 1])
                if pid is not None:
                    s = self.pieces[pid].score
                    if best_score is None or s > best_score:
                        best_score, best_i = s, i
            if best_i < 0:
                break
            symbols[best_i : best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        ids = []
        for sym in symbols:
            pid = self._index.get(sym)
            if pid is None:
                ids.extend(self._bytes_or_unk(sym))
            else:
                ids.append(pid)
        return ids

    def decode(self, ids: list[int]) -> str:
        out: list[str] = []
        byte_buf: list[int] = []

        def flush_bytes():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            p = self.pieces[i]
            if p.type == BYTE:
                byte_buf.append(int(p.text[1:-1], 16))
                continue
            flush_bytes()
            if p.type in (CONTROL, UNUSED):
                continue
            if p.type == UNKNOWN:
                out.append(" ⁇ ")
                continue
            out.append(p.text)
        flush_bytes()
        text = "".join(out).replace(SPACE, " ")
        return text[1:] if text.startswith(" ") else text


class SentencePieceTokenizer:
    """Drop-in tokenizer for the text conditioner: ids in [0, n_bins)."""

    def __init__(self, n_bins: int, model_path: str | Path):
        self.model = SentencePieceModel.load(model_path)
        if self.model.vocab_size() != n_bins:
            raise ValueError(
                f"tokenizer has vocab size={self.model.vocab_size()} "
                f"but n_bins={n_bins} was specified"
            )

    def encode(self, text: str) -> list[int]:
        return self.model.encode(text)

    def decode(self, ids: list[int]) -> str:
        return self.model.decode(ids)
