"""BERT-style tokenization (counterpart of ``d2r_tpu/data/tokenizer.py``).

A standalone WordPiece implementation with the semantics of HF's
``BertTokenizer`` for a given ``vocab.txt``: basic tokenisation (lowercase,
accent strip, punctuation/CJK split) followed by greedy longest-match-first
WordPiece with '##' continuations. When no vocab file is available a
deterministic hash-bucket tokenizer stands in, so every pipeline stage runs
without a downloaded asset. For any text the ids are the JAX package's.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Optional, Sequence

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F)
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting with lowercasing + accent strip."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            tokens.extend(self._split_punct(tok))
        return [t for t in tokens if t]

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(tok: str) -> List[str]:
        out: List[str] = []
        current: List[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if current:
                    out.append("".join(current))
                    current = []
                out.append(ch)
            else:
                current.append(ch)
        if current:
            out.append("".join(current))
        return out


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a fixed vocab."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces


class BertTokenizer:
    """BasicTokenizer + WordPiece, mirroring HF BertTokenizer semantics.

    Construct from a local ``vocab.txt`` (one token per line, id = line no).
    """

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 vocab_path: Optional[str] = None):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordPieceTokenizer(vocab)
        self.pad_token_id = vocab.get("[PAD]", 0)
        self.unk_token_id = vocab.get("[UNK]", 1)
        self.cls_token_id = vocab.get("[CLS]", 2)
        self.sep_token_id = vocab.get("[SEP]", 3)
        # native (C) fast path for ASCII text — only when the vocab came
        # from a file (the C side builds its own hash table from it) and
        # semantics match (lower_case; ASCII has no accents to strip)
        self._native_handle = None
        if vocab_path is not None and do_lower_case:
            from d2r_tpu_torch.data.native_text import load_native_vocab
            self._native_handle = load_native_vocab(vocab_path)

    def encode_ids(self, text: str, max_ids: int) -> List[int]:
        """WordPiece ids WITHOUT specials, truncated to ``max_ids`` —
        identical to ``convert_tokens_to_ids(tokenize(text))[:max_ids]``.
        ASCII text takes the GIL-free C path (``native/wordpiece.c``) when
        the library is available; everything else (and any native miss) uses
        the Python implementation."""
        if self._native_handle is not None:
            from d2r_tpu_torch.data.native_text import native_encode
            ids = native_encode(self._native_handle, text, max_ids)
            if ids is not None:
                return ids
        return self.convert_tokens_to_ids(self.tokenize(text))[:max_ids]

    @classmethod
    def from_vocab_file(cls, path: str, do_lower_case: bool = True) -> "BertTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, do_lower_case, vocab_path=path)

    @classmethod
    def from_pretrained_dir(cls, path: str, do_lower_case: bool = True
                            ) -> Optional["BertTokenizer"]:
        vocab_file = os.path.join(path, "vocab.txt")
        if os.path.exists(vocab_file):
            return cls.from_vocab_file(vocab_file, do_lower_case)
        if os.path.isfile(path) and path.endswith(".txt"):
            return cls.from_vocab_file(path, do_lower_case)
        return None

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(word))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]


class HashTokenizer:
    """Deterministic hash-bucket fallback when no vocab.txt exists.

    Keeps the whole pipeline (padding, masks, special tokens) exercisable
    without any downloaded asset; NOT intended for accuracy-parity runs.
    """

    def __init__(self, vocab_size: int = 30522, do_lower_case: bool = True):
        self.vocab_size = vocab_size
        self.basic = BasicTokenizer(do_lower_case)
        self.pad_token_id = 0
        self.unk_token_id = 1
        self.cls_token_id = 2
        self.sep_token_id = 3
        self._reserved = 5

    def tokenize(self, text: str) -> List[str]:
        return self.basic.tokenize(text)

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        span = self.vocab_size - self._reserved
        ids = []
        for t in tokens:
            h = 2166136261
            for ch in t.encode("utf-8"):  # FNV-1a, stable across runs
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids.append(self._reserved + (h % span))
        return ids


def load_tokenizer(bert_name: str, vocab_size: int = 30522,
                   allow_hash_fallback: bool = True):
    """Resolve a tokenizer: a local vocab dir/file if one exists, else the
    hash-bucket fallback.

    The fallback keeps pipelines runnable with zero downloaded assets, but it
    destroys accuracy parity — so it is LOUD (one warning) and can be refused
    outright with ``allow_hash_fallback=False`` (accuracy-parity runs).

    Resolution order: ``vocab.txt`` -> WordPiece (BERT family, what the
    reference uses); ``vocab.json`` + ``merges.txt`` -> byte-level BPE
    (RoBERTa family); else the hash fallback."""
    tok = BertTokenizer.from_pretrained_dir(bert_name)
    if tok is not None:
        return tok
    if os.path.isdir(bert_name):
        from d2r_tpu_torch.data.bpe import RobertaBPETokenizer
        bpe = RobertaBPETokenizer.from_pretrained_dir(bert_name)
        if bpe is not None:
            return bpe
    if not allow_hash_fallback:
        raise FileNotFoundError(
            f"no vocab.txt (WordPiece) or vocab.json+merges.txt (BPE) found "
            f"for {bert_name!r} and the hash-tokenizer fallback is disabled "
            f"for this run (accuracy-parity mode). Point --bert_name at a "
            f"directory containing the tokenizer assets.")
    import logging
    logging.getLogger(__name__).warning(
        "no vocab.txt found for %r — using the DETERMINISTIC HASH tokenizer "
        "fallback. Pipelines run, but results are NOT accuracy-comparable "
        "to the reference.", bert_name)
    return HashTokenizer(vocab_size=vocab_size)
