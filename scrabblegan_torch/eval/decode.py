"""Greedy CTC decoding and the character error rate.

The port's copy of scrabblegan_tpu/eval/decode.py (numpy), file for file:
best-path decoding with the blank at id K-1 (the CTC convention of
`ops/ctc.py`) and the Levenshtein character error rate.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def greedy_ctc_decode(logits: np.ndarray,
                      logit_lengths: Optional[np.ndarray] = None) -> List[List[int]]:
    """Best-path decode: per-frame argmax, collapse repeats, drop blanks.

    logits: (B, T, K) with blank id K-1; logit_lengths: (B,) valid frame counts."""
    logits = np.asarray(logits)
    b, t, k = logits.shape
    blank = k - 1
    frames = logits.argmax(-1)  # (B, T)
    out: List[List[int]] = []
    for i in range(b):
        length = int(logit_lengths[i]) if logit_lengths is not None else t
        seq = []
        prev = -1
        for f in frames[i, :length]:
            f = int(f)
            if f != prev and f != blank:
                seq.append(f)
            prev = f
        out.append(seq)
    return out


def levenshtein(a: Sequence, b: Sequence) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def character_error_rate(predictions: Sequence[Sequence[int]],
                         references: Sequence[Sequence[int]]) -> float:
    """Total edit distance / total reference length."""
    edits = sum(levenshtein(p, r) for p, r in zip(predictions, references))
    total = sum(len(r) for r in references)
    return edits / max(total, 1)
