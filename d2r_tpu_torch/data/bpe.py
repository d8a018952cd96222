"""Byte-level BPE tokenizer, RoBERTa/GPT-2 family (counterpart of
``d2r_tpu/data/bpe.py``).

The GPT-2 byte-level BPE scheme over the standard local asset pair
(``vocab.json`` + ``merges.txt``), loaded the way the WordPiece path loads
``vocab.txt``: user-supplied files only. It exposes the surface the data
pipeline consumes (``encode_ids`` / ``tokenize`` / ``convert_tokens_to_ids``
and the ``pad/unk/cls/sep_token_id`` attributes, for RoBERTa
``<pad>``/``<unk>``/``<s>``/``</s>``).

Pre-tokenisation needs the ``regex`` package (Unicode letter and number classes),
which is imported when a tokenizer is built, not with this module: only a
run that finds a ``vocab.json`` + ``merges.txt`` directory needs it.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

# GPT-2 pre-tokenization pattern: contractions, letter runs, number runs,
# other-symbol runs (each optionally preceded by one space), then whitespace.
# ``regex`` caches the compiled pattern itself.
PRETOKENIZE = (r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"""
               r"""|\s+(?!\S)|\s+""")


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 reversible byte -> printable-unicode-char map: printable
    ASCII/latin-1 bytes map to themselves; the rest shift to 256+."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class RobertaBPETokenizer:
    """Byte-level BPE with RoBERTa special tokens.

    Construct from local ``vocab.json`` (token -> id) and ``merges.txt``
    (one space-separated pair per line, rank = line order, optional
    ``#version`` header).
    """

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]]):
        import regex  # stdlib `re` has no Unicode letter/number classes
        self._pretokenize = functools.partial(regex.findall, PRETOKENIZE)
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self._cache: Dict[str, List[str]] = {}
        # RoBERTa specials; fall back to the conventional 0..3 ids so a
        # vocab that omits them still produces a usable pipeline
        self.cls_token_id = vocab.get("<s>", 0)
        self.pad_token_id = vocab.get("<pad>", 1)
        self.sep_token_id = vocab.get("</s>", 2)
        self.unk_token_id = vocab.get("<unk>", 3)

    @classmethod
    def from_pretrained_dir(cls, path: str) -> Optional["RobertaBPETokenizer"]:
        vocab_file = os.path.join(path, "vocab.json")
        merges_file = os.path.join(path, "merges.txt")
        if not (os.path.exists(vocab_file) and os.path.exists(merges_file)):
            return None
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges)

    def _bpe(self, token: str) -> List[str]:
        """Merge the byte-unicode chars of ``token`` by ascending merge
        rank until no ranked pair remains (the standard BPE loop)."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token)
        while len(word) > 1:
            pairs = _get_pairs(word)
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = list(word)
        if len(self._cache) < 65536:
            self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self._pretokenize(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            out.extend(self._bpe(mapped))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def encode_ids(self, text: str, max_ids: int) -> List[int]:
        """BPE ids WITHOUT specials, truncated to ``max_ids`` — the same
        contract as BertTokenizer.encode_ids (data/dataset.py wraps with
        cls/sep itself)."""
        return self.convert_tokens_to_ids(self.tokenize(text))[:max_ids]
