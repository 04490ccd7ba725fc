"""Word encoding and the random-word lexicon.

The port's own copies of `encode_word`, `decode_label`,
`load_random_word_list` and `sample_fake_labels` from
scrabblegan_tpu/data/loaders.py (framework-free numpy; copied so that the
port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from scrabblegan_torch.config import CHAR_VECTOR


def encode_word(word: str, char_vector: str = CHAR_VECTOR) -> List[int]:
    """'auto' -> [0, 20, 19, 14]: each character's index in char_vector."""
    return [char_vector.index(ch) for ch in word]


def decode_label(label: Sequence[int], char_vector: str = CHAR_VECTOR) -> str:
    return "".join(char_vector[i] for i in label)


def load_random_word_list(words_file: str, bucket_size: int,
                          char_vector: str = CHAR_VECTOR) -> List[List[List[int]]]:
    """Lexicon -> per-length buckets of encoded words: random_words[k] holds
    the words of length k+1. Words longer than bucket_size or with characters
    outside char_vector are dropped."""
    buckets: List[List[List[int]]] = [[] for _ in range(bucket_size)]
    with open(words_file, encoding="utf8") as f:
        for line in f:
            word = line.strip()
            if not word or len(word) > bucket_size:
                continue
            if not all(ch in char_vector for ch in word):
                continue
            buckets[len(word) - 1].append(encode_word(word, char_vector))
    return buckets


def sample_fake_labels(rng: np.random.Generator, random_words, batch_size: int,
                       bucket: int) -> np.ndarray:
    """batch_size encoded words of length `bucket` drawn from the lexicon, or
    uniform character ids where the lexicon has no word of that length."""
    pool = random_words[bucket - 1]
    if not pool:
        return rng.integers(0, 52, size=(batch_size, bucket)).astype(np.int32)
    idx = rng.integers(0, len(pool), size=batch_size)
    return np.asarray([pool[i] for i in idx], np.int32)
