"""SenticNet affective graph (counterpart of ``d2r_tpu/data/sentic.py``).

The port's own copy of the 39,891-entry word -> polarity lexicon lives at
``d2r_tpu_torch/data/assets/senticnet_word.txt`` (byte for byte the JAX
package's); :func:`load_sentic_lexicon` defaults to it. The adjacency is
built on the host in numpy, per item, and feeds the optional GCN of
``models/graph.py``.

The reference's construction, kept exactly: the adjacency is over the
text's whitespace words, not its tokens; a word's polarity + 1 (plus 1 more
when the word is in the aspect string) is added to its whole row AND its
whole column; zero diagonal entries are set to 1; in the padded batch,
padding rows get a unit diagonal so the GCN's degree normalisation stays
defined.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

DEFAULT_LEXICON_PATH = os.path.join(os.path.dirname(__file__), "assets",
                                    "senticnet_word.txt")


def load_sentic_lexicon(path: Optional[str] = None) -> Dict[str, float]:
    """``word<TAB>polarity`` lines, polarity in [-1, 1]; the port's asset
    unless ``path`` names another file."""
    lex: Dict[str, float] = {}
    with open(path or DEFAULT_LEXICON_PATH, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            word, sentic = line.split("\t")
            lex[word] = float(sentic)
    return lex


def affective_adjacency(text: str, aspect: str,
                        lexicon: Dict[str, float]) -> np.ndarray:
    """The (n_words, n_words) fp32 affective adjacency of ``text``."""
    words = text.split()
    n = len(words)
    matrix = np.zeros((n, n), np.float32)
    for i, word in enumerate(words):
        sentic = float(lexicon[word]) + 1.0 if word in lexicon else 0.0
        if word in aspect:      # a substring test, as the reference's
            sentic += 1.0
        matrix[i, :] += sentic  # the row and the column: the diagonal gets it twice
        matrix[:, i] += sentic
    for i in range(n):
        if matrix[i, i] == 0:
            matrix[i, i] = 1.0
    return matrix


def batched_affective_adjacency(texts: Sequence[str], lexicon: Dict[str, float],
                                max_seq: int,
                                aspects: Optional[Sequence[str]] = None) -> np.ndarray:
    """(B, max_seq, max_seq) fp32: each text's adjacency cut to its first
    ``max_seq`` words, zero beyond them, with a unit diagonal on the padding
    rows."""
    batch = np.zeros((len(texts), max_seq, max_seq), np.float32)
    for b, text in enumerate(texts):
        adj = affective_adjacency(text, aspects[b] if aspects is not None else "", lexicon)
        n = min(adj.shape[0], max_seq)
        batch[b, :n, :n] = adj[:n, :n]
        for i in range(n, max_seq):
            batch[b, i, i] = 1.0
    return batch
