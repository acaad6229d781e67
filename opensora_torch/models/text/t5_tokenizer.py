"""T5's SentencePiece unigram tokenizer, read from a checkpoint directory's
``spiece.model``: the ids that ``transformers.T5Tokenizer(legacy=True)``
gives, which the JAX package tokenizes with when that file is on disk
(opensora_tpu/models/text/conditioner.py:59-61), without ``sentencepiece``,
``protobuf`` or ``transformers``.

- The file: a ``ModelProto`` message read by hand from the protobuf wire
  format (field numbers of sentencepiece_model.proto): each piece with its
  score and type; the trainer spec's unk / bos / eos / pad ids; the
  normalizer spec's ``precompiled_charsmap``, ``add_dummy_prefix``,
  ``remove_extra_whitespaces`` and ``escape_whitespaces``.
- Normalization, as sentencepiece's ``normalizer.cc``: the charsmap blob is
  a little-endian uint32 size, a darts-clone double array of that many
  bytes, then NUL-terminated replacement strings; at each position of the
  UTF-8 input the longest key that the array holds is replaced (user-defined
  pieces are copied untouched). Leading, trailing and repeated spaces are
  dropped, a dummy-prefix space added, spaces written as U+2581.
- Segmentation: Viterbi over the normal and user-defined pieces (a
  user-defined piece scores ``length * max_score - 0.1``); a character
  that no piece starts with is unknown at ``min_score - 10``; consecutive
  unknowns merge into one ``<unk>``. Scores are summed in float64, as
  ``tokenizers``' Unigram sums them (sentencepiece sums in float32: the two
  differ only where two segmentations' float32 sums tie); a tie keeps the
  candidate whose last piece is longest, as both do.
- The special tokens ``<pad>``, ``</s>``, ``<unk>`` and the 100
  ``<extra_id_N>`` that ``T5Tokenizer`` appends (ids 32099 down to 32000 for
  a 32000-piece model) are split out of the text first and map to their
  ids; ``</s>`` is appended unless the ids already end with it.
- ``__call__(texts, max_length)``: truncated to ``max_length`` with
  ``</s>`` kept last, padded with the pad id (0), int32.

``chip_smoke.write_spiece_model`` writes such a file.
"""

from __future__ import annotations

import os
import re
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

FILE = "spiece.model"
NORMAL, UNKNOWN, CONTROL, USER_DEFINED = 1, 2, 3, 4  # SentencePiece.Type (5 unused, 6 byte: never matched)
SPACE = "▁"
UNK_PENALTY = 10.0
EXTRA_IDS = 100


# ----------------------------------------------------------------------
# the protobuf wire format
# ----------------------------------------------------------------------


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, object]]:
    """(field number, value) of a message: an int for a varint, bytes for a
    length-delimited or fixed-width field."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 2:
            size, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + size], pos + size
        elif wire in (1, 5):
            width = 8 if wire == 1 else 4
            value, pos = buf[pos:pos + width], pos + width
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, value


def _int32(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


@dataclass
class ModelProto:
    """What the tokenizer reads of a ``spiece.model``."""

    pieces: List[Tuple[str, float, int]] = field(default_factory=list)  # (piece, score, type)
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    model_type: int = 1
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    treat_whitespace_as_suffix: bool = False  # not supported: parse_model refuses it


_TRAINER = {3: "model_type", 24: "treat_whitespace_as_suffix", 40: "unk_id", 41: "bos_id", 42: "eos_id", 43: "pad_id"}
_NORMALIZER = {2: "precompiled_charsmap", 3: "add_dummy_prefix", 4: "remove_extra_whitespaces",
               5: "escape_whitespaces"}


def parse_model(data: bytes) -> ModelProto:
    m = ModelProto()
    for number, value in _fields(data):
        if number == 1:  # SentencePiece: piece = 1, score = 2 (float), type = 3
            piece, score, kind = "", 0.0, NORMAL
            for n, v in _fields(value):
                if n == 1:
                    piece = v.decode("utf-8")
                elif n == 2:
                    score = struct.unpack("<f", v)[0]
                elif n == 3:
                    kind = v
            m.pieces.append((piece, score, kind))
        elif number in (2, 3):  # TrainerSpec, NormalizerSpec
            names = _TRAINER if number == 2 else _NORMALIZER
            for n, v in _fields(value):
                if n in names:
                    name = names[n]
                    setattr(m, name, v if isinstance(v, bytes) else
                            bool(v) if isinstance(getattr(m, name), bool) else _int32(v))
    if m.model_type != 1:
        raise ValueError(f"not a unigram model (model_type {m.model_type})")
    if m.treat_whitespace_as_suffix:
        raise ValueError("treat_whitespace_as_suffix models are not supported")
    return m


# ----------------------------------------------------------------------
# the precompiled charsmap (a darts-clone double array + replacements)
# ----------------------------------------------------------------------


class Charsmap:
    """Longest-key replacement over a ``precompiled_charsmap`` blob."""

    def __init__(self, blob: bytes):
        if len(blob) <= 4:
            raise ValueError("precompiled_charsmap too short")
        size = struct.unpack_from("<I", blob)[0]
        if size >= len(blob) or size % 4:
            raise ValueError("precompiled_charsmap: bad trie size")
        self.units = np.frombuffer(blob, "<u4", size // 4, 4).tolist()
        self.normalized = blob[4 + size:]

    def match(self, data: bytes, pos: int) -> Tuple[Optional[bytes], int]:
        """(replacement, bytes consumed) of the longest key that starts at
        ``data[pos]``; (None, 0) when none does."""
        units, node = self.units, 0
        node ^= (units[0] >> 10) << ((units[0] & (1 << 9)) >> 6)
        best, length = None, 0
        for i in range(pos, len(data)):
            node ^= data[i]
            unit = units[node] if node < len(units) else 0
            if unit & ((1 << 31) | 0xFF) != data[i]:
                break
            node ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:  # a key ends here: its value is the leaf unit's
                best, length = units[node] & ((1 << 31) - 1), i + 1 - pos
        if best is None:
            return None, 0
        return self.normalized[best:self.normalized.index(b"\0", best)], length


# ----------------------------------------------------------------------
# the tokenizer
# ----------------------------------------------------------------------


class _PieceTrie:
    """Pieces by their UTF-8 bytes, for the prefix search of the Viterbi."""

    def __init__(self, pieces: Dict[str, int]):
        self.root: dict = {}
        for piece, i in pieces.items():
            node = self.root
            for b in piece.encode("utf-8"):
                node = node.setdefault(b, {})
            node[-1] = i

    def prefixes(self, data: bytes, pos: int) -> Iterator[Tuple[int, int]]:
        """(end byte, piece id) of every piece that ``data[pos:]`` starts with,
        shortest first."""
        node = self.root
        for i in range(pos, len(data)):
            node = node.get(data[i])
            if node is None:
                return
            if -1 in node:
                yield i + 1, node[-1]


def _utf8_len(lead: int) -> int:
    return 1 if lead < 0x80 else 2 if lead < 0xE0 else 3 if lead < 0xF0 else 4


class T5Tokenizer:
    """Text -> T5 token ids from ``spiece.model`` in ``path`` (a directory
    or the file itself; module docstring)."""

    def __init__(self, path: str, max_length: int = 512, extra_ids: int = EXTRA_IDS):
        with open(os.path.join(path, FILE) if os.path.isdir(path) else path, "rb") as f:
            self.model = m = parse_model(f.read())
        self.charsmap = Charsmap(m.precompiled_charsmap) if m.precompiled_charsmap else None
        self.model_max_length = max_length
        n = len(m.pieces)
        self.pieces = {p: i for i, (p, _, kind) in enumerate(m.pieces) if kind in (NORMAL, USER_DEFINED)}
        self.user_defined = sorted((p for p, _, kind in m.pieces if kind == USER_DEFINED), key=len, reverse=True)
        normal = [s for _, s, kind in m.pieces if kind == NORMAL]
        self.min_score, self.max_score = min(normal), max(normal)
        self.scores = [s for _, s, _ in m.pieces]
        self.trie = _PieceTrie(self.pieces)
        self.unk_id, self.eos_token_id = m.unk_id, m.eos_id
        self.pad_token_id = m.pad_id if m.pad_id >= 0 else m.unk_id  # T5Tokenizer: an absent <pad> is unknown
        specials = {m.pieces[i][0]: i for i in (m.pad_id, m.eos_id, m.unk_id) if i >= 0}
        specials.update({f"<extra_id_{k}>": n + extra_ids - 1 - k for k in range(extra_ids)})
        self.special_ids = specials
        self._special_split = re.compile("(" + "|".join(map(re.escape, sorted(specials, key=len, reverse=True))) + ")")
        self.vocab_size = n + extra_ids

    # -- normalization (sentencepiece's Normalizer::Normalize) --

    def _prefix(self, data: bytes, pos: int) -> Tuple[bytes, int]:
        for p in self.user_defined:
            pb = p.encode("utf-8")
            if data.startswith(pb, pos):
                return pb, len(pb)
        if self.charsmap is not None:
            repl, n = self.charsmap.match(data, pos)
            if n:
                return repl, n
        n = _utf8_len(data[pos])
        return data[pos:pos + n], n

    def normalize(self, text: str) -> str:
        m = self.model
        data, pos = text.encode("utf-8"), 0
        if m.remove_extra_whitespaces:
            while pos < len(data):
                chunk, n = self._prefix(data, pos)
                if chunk != b" ":
                    break
                pos += n
        if pos == len(data):
            return ""
        space = SPACE.encode("utf-8") if m.escape_whitespaces else b" "
        out = bytearray(space if m.add_dummy_prefix and not m.treat_whitespace_as_suffix else b"")
        prev_space = m.remove_extra_whitespaces
        while pos < len(data):
            chunk, n = self._prefix(data, pos)
            if prev_space:
                chunk = chunk.lstrip(b" ")
            if chunk:
                out += chunk.replace(b" ", space) if m.escape_whitespaces else chunk
                prev_space = chunk.endswith(b" ")
            pos += n
            if not m.remove_extra_whitespaces:
                prev_space = False
        if m.remove_extra_whitespaces:
            while out.endswith(space):
                del out[-len(space):]
        return out.decode("utf-8")

    # -- segmentation --

    def _viterbi(self, normalized: str) -> List[int]:
        data = normalized.encode("utf-8")
        size = len(data)
        best = [(0.0, -1, -1)] + [None] * size  # per end byte: (score, start byte, id)
        unk_score = self.min_score - UNK_PENALTY
        pos = 0
        while pos < size:
            base, char_end = best[pos][0], pos + _utf8_len(data[pos])
            single = False
            for end, i in self.trie.prefixes(data, pos):
                piece_len = len(data[pos:end].decode("utf-8"))
                s = base + (piece_len * self.max_score - 0.1 if self.model.pieces[i][2] == USER_DEFINED
                            else self.scores[i])
                if best[end] is None or s > best[end][0]:
                    best[end] = (s, pos, i)
                single = single or end == char_end
            if not single and (best[char_end] is None or base + unk_score > best[char_end][0]):
                best[char_end] = (base + unk_score, pos, self.unk_id)
            pos = char_end
        ids, end = [], size
        while end > 0:
            _, start, i = best[end]
            if not (i == self.unk_id and ids and ids[-1] == self.unk_id):  # consecutive unknowns: one <unk>
                ids.append(i)
            end = start
        return ids[::-1]

    def encode(self, text: str) -> List[int]:
        """Token ids of ``text``, without the final ``</s>``."""
        ids = []
        for part in self._special_split.split(text):
            if part in self.special_ids:
                ids.append(self.special_ids[part])
            elif part:
                ids += self._viterbi(self.normalize(part))
        return ids

    def __call__(self, texts: Sequence[str], max_length: Optional[int] = None) -> np.ndarray:
        max_length = max_length or self.model_max_length
        out = np.full((len(texts), max_length), self.pad_token_id, np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)[:max_length - 1]
            if not ids or ids[-1] != self.eos_token_id:
                ids.append(self.eos_token_id)
            out[i, :len(ids)] = ids
        return out
