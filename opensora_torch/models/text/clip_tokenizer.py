"""CLIP's byte-level BPE tokenizer, read from a checkpoint directory's
``vocab.json`` and ``merges.txt``: the ids that ``transformers.CLIPTokenizer``
gives, which the JAX package tokenizes with when those files are on disk
(opensora_tpu/models/text/conditioner.py:53-58), without ``transformers``,
``regex`` or ``ftfy``.

- Special tokens: ``<|startoftext|>`` and ``<|endoftext|>`` and the pad
  token, from ``special_tokens_map.json`` / ``tokenizer_config.json`` where
  those files are present (openai's files: pad = ``<|endoftext|>``, id
  49407; without them the same defaults). Text is split on them first;
  each maps to its id.
- Text cleanup: transformers cleans with ``ftfy`` where it is installed and
  otherwise with ``BasicTokenizer(strip_accents=False,
  do_split_on_punc=False)``. ``ftfy`` is installed on none of the machines
  the two packages run on, so this copies the second path: control
  characters dropped, whitespace made single spaces, spaces around CJK
  ideographs, NFC, lowercasing, accents kept.
- Words: transformers splits with ``regex``'s ``<\\|startoftext\\|>|
  <\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
  [^\\s\\p{L}\\p{N}]+`` (IGNORECASE). Here the literal alternatives are the
  same pattern in stdlib ``re`` and the classes are
  ``unicodedata.category``: ``L*`` letters, ``Nd``/``Nl``/``No`` digits.
- Encoding: each word's UTF-8 bytes through the byte-to-unicode table,
  ``</w>`` on its last symbol, merges applied by rank (at most the first
  48894 lines after the header, as transformers reads them), unknown
  symbols to the unk token's id.
- ``__call__(texts, max_length)``: ``<|startoftext|>`` + ids +
  ``<|endoftext|>``, truncated to ``max_length`` with ``<|endoftext|>``
  kept last, padded with the pad id (``truncation=True,
  padding="max_length"``), int32.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FILES = ("vocab.json", "merges.txt")
MAX_MERGES = 49152 - 256 - 2  # merges.txt lines transformers reads after its header
_WORD_LITERALS = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d", re.IGNORECASE)
_NUMBER = ("Nd", "Nl", "No")
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F), (0x2B740, 0x2B81F),
        (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table (the printable Latin-1
    bytes map to themselves, the rest to U+0100 upward)."""
    bs = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1), *range(ord("®"), ord("ÿ") + 1)]
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def basic_clean(text: str) -> str:
    """transformers' ``BasicTokenizer(strip_accents=False,
    do_split_on_punc=False).tokenize`` joined by spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif any(lo <= cp <= hi for lo, hi in _CJK):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    return " ".join(tok.lower() for tok in unicodedata.normalize("NFC", "".join(out)).split())


def _kind(ch: str) -> str:
    cat = unicodedata.category(ch)
    return "L" if cat[0] == "L" else "N" if cat in _NUMBER else " " if ch.isspace() else "P"


def split_words(text: str) -> List[str]:
    """``re.findall`` of CLIP's word pattern (module docstring) on ``text``."""
    words, i, n = [], 0, len(text)
    while i < n:
        m = _WORD_LITERALS.match(text, i)
        if m:
            words.append(m.group())
            i = m.end()
            continue
        kind = _kind(text[i])
        j = i + 1
        if kind in "LP":  # a run of letters, or of characters that are neither letter, digit nor space
            while j < n and _kind(text[j]) == kind:
                j += 1
        if kind != " ":
            words.append(text[i:j])
        i = j
    return words


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _token_content(tok) -> Optional[str]:
    return tok.get("content") if isinstance(tok, dict) else tok


class CLIPTokenizer:
    """Text -> CLIP token ids from the files in ``path`` (module docstring)."""

    def __init__(self, path: str, max_length: Optional[int] = None):
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:MAX_MERGES + 1]
        self.bpe_ranks: Dict[Tuple[str, ...], int] = {tuple(m.split()): i for i, m in enumerate(merges)}
        config = _read_json(os.path.join(path, "tokenizer_config.json"))
        special_map = _read_json(os.path.join(path, "special_tokens_map.json"))

        def special(name: str, default: str) -> str:
            return _token_content(special_map.get(name, config.get(name))) or default

        self.bos_token = special("bos_token", "<|startoftext|>")
        self.eos_token = special("eos_token", "<|endoftext|>")
        self.unk_token = special("unk_token", "<|endoftext|>")
        self.pad_token = special("pad_token", "<|endoftext|>")
        added = {_token_content(tok): int(i) for i, tok in config.get("added_tokens_decoder", {}).items()}
        self.special_ids = {t: self.encoder.get(t, added.get(t)) for t in
                            (self.bos_token, self.eos_token, self.unk_token, self.pad_token, *added)}
        missing = [t for t, i in self.special_ids.items() if i is None]
        if missing:
            raise ValueError(f"{path}: special tokens {missing} have no id in vocab.json")
        self._special_split = re.compile("(" + "|".join(map(re.escape, sorted(self.special_ids, key=len,
                                                                                reverse=True))) + ")")
        self.bos_token_id = self.special_ids[self.bos_token]
        self.eos_token_id = self.special_ids[self.eos_token]
        self.pad_token_id = self.special_ids[self.pad_token]
        self.unk_token_id = self.special_ids[self.unk_token]
        self.model_max_length = max_length or int(config.get("model_max_length", 77))
        self.byte_encoder = bytes_to_unicode()
        self._cache = {"<|startoftext|>": ("<|startoftext|>",), "<|endoftext|>": ("<|endoftext|>",)}

    def bpe(self, token: str) -> Tuple[str, ...]:
        """The BPE symbols of one word (its characters, ``</w>`` on the last,
        merged by rank)."""
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        """Token ids of ``text``, without the start and end tokens."""
        ids = []
        for part in self._special_split.split(text):
            if part in self.special_ids:
                ids.append(self.special_ids[part])
                continue
            for word in split_words(basic_clean(part)):
                symbols = self.bpe("".join(self.byte_encoder[b] for b in word.encode("utf-8")))
                ids += [self.encoder.get(s, self.unk_token_id) for s in symbols]
        return ids

    def __call__(self, texts: Sequence[str], max_length: Optional[int] = None) -> np.ndarray:
        max_length = max_length or self.model_max_length
        out = np.full((len(texts), max_length), self.pad_token_id, np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos_token_id] + self.encode(text)[:max(max_length - 2, 0)] + [self.eos_token_id]
            out[i, :len(ids)] = ids[:max_length]
        return out
