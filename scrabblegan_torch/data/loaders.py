"""Host-side loaders: the bucketed word-image data set, the style images,
word encoding and the random-word lexicon.

The port's own copy of scrabblegan_tpu/data/loaders.py (framework-free
numpy; copied so that the port imports nothing of the JAX package), with
its images read by `data.images` (numpy + zlib) in place of cv2. Every draw
is the JAX module's, from the same seeded `np.random.default_rng` in the
same order, so a seed gives the same batches array for array. Batches are
gathered and normalised with numpy (the JAX module's fallback path, whose
numerics its native C++ assembler shares).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from scrabblegan_torch.config import CHAR_VECTOR
from scrabblegan_torch.data.images import read_grayscale, resize


def encode_word(word: str, char_vector: str = CHAR_VECTOR) -> List[int]:
    """'auto' -> [0, 20, 19, 14]: each character's index in char_vector."""
    return [char_vector.index(ch) for ch in word]


def decode_label(label: Sequence[int], char_vector: str = CHAR_VECTOR) -> str:
    return "".join(char_vector[i] for i in label)


class BucketedDataset:
    """In-RAM bucketed data set with population-weighted bucket sampling.

    `reading_dir` is one data set directory in the GAN-Reading layout
    (<dir>/<length>/<stem>.png + <stem>.txt) or a list of them, merged into
    one pool. Images are held as uint8 (H, 16 * length, C) per bucket."""

    def __init__(self, reading_dir, input_dim: Tuple[int, int, int],
                 bucket_size: int, char_vector: str = CHAR_VECTOR, seed: int = 0):
        self.h, self.w_max, self.c = input_dim
        self.bucket_size = bucket_size
        self.char_vector = char_vector
        self._rng = np.random.default_rng(seed)
        reading_dirs = ([reading_dir] if isinstance(reading_dir, (str, os.PathLike))
                        else list(reading_dir))

        self.images: Dict[int, np.ndarray] = {}
        self.labels: Dict[int, np.ndarray] = {}
        total = 0
        for b in range(1, bucket_size + 1):
            imgs, labs = [], []
            for rd in reading_dirs:
                bucket_dir = os.path.join(rd, str(b))
                if not os.path.isdir(bucket_dir):
                    continue
                for fn in sorted(os.listdir(bucket_dir)):
                    if not fn.endswith(".txt"):
                        continue
                    stem = os.path.splitext(fn)[0]
                    with open(os.path.join(bucket_dir, fn), encoding="utf8") as f:
                        word = f.readline().strip()
                    img = read_grayscale(os.path.join(bucket_dir, stem + ".png"))
                    if img is None or len(word) != b:
                        continue
                    imgs.append(img)
                    labs.append(encode_word(word, char_vector))
            width = (self.h // 2) * b
            if imgs:
                self.images[b] = np.ascontiguousarray(
                    np.stack(imgs).reshape(-1, self.h, width, self.c), np.uint8)
                self.labels[b] = np.asarray(labs, np.int32)
            else:
                self.images[b] = np.zeros((0, self.h, width, self.c), np.uint8)
                self.labels[b] = np.zeros((0, b), np.int32)
            total += len(imgs)

        self.num_samples = total
        if total == 0:
            raise ValueError(f"no samples found under {reading_dir}")
        self.bucket_weights = np.array(
            [len(self.labels[b]) / total for b in range(1, bucket_size + 1)])
        self.nonempty = [b for b in range(1, bucket_size + 1) if len(self.labels[b])]

    def sample_bucket(self) -> int:
        """A bucket (1-based) drawn by population weight."""
        return int(self._rng.choice(self.bucket_size, p=self.bucket_weights)) + 1

    def sample_batch(self, batch_size: int, bucket: int | None = None,
                     raw: bool = False) -> Tuple[np.ndarray, np.ndarray, int]:
        """(images (B, 32, 16 * bucket, C) in [-1, 1], labels (B, bucket),
        bucket), drawn with replacement inside the bucket. raw=True returns
        the gathered uint8 bytes instead (the 'uint8' wire format; the step
        normalises them on the device by the same formula)."""
        if bucket is None:
            bucket = self.sample_bucket()
        n = len(self.labels[bucket])
        idx = self._rng.integers(0, n, size=batch_size)
        if raw:
            return self.images[bucket][idx].copy(), self.labels[bucket][idx].copy(), bucket
        imgs = (self.images[bucket][idx].astype(np.float32) - 127.5) / 127.5
        return imgs, self.labels[bucket][idx].copy(), bucket


def _fit_canvas(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Right-crop or white-pad (255) to exactly (h, w). A validate-rule
    image whose height came out below h is white-padded at the bottom, as
    in the JAX package (its docstring gives the reason)."""
    height, width = img.shape
    if width > w:
        img = img[:, :w]
    if img.shape != (h, w):
        out = np.ones((h, w), np.float32) * 255.0
        out[:height, : img.shape[1]] = img
        return out
    return img


def load_style_images(style_dir: str, input_dim: Tuple[int, int, int],
                      train_fraction: float = 0.95, seed: int = 0
                      ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """The target-style folder as (train, validate) lists of (h, w) float32
    arrays in [-1, 1]: the sorted file names shuffled by the seed, 95/5.

    - train: height-fit (rate = h / height) with 'area', then right-crop or
      white-pad the width;
    - validate: rate = min(h / height, w / width) with 'cubic': a wide image
      is width-fit to w with its height int(height * rate) <= h, then
      white-padded to the canvas (`_fit_canvas`)."""
    h, w, _c = input_dim
    files = sorted(os.listdir(style_dir))
    rng = np.random.default_rng(seed)
    rng.shuffle(files)
    split = int(len(files) * train_fraction)

    def _load(fn: str, quality: str, validate_rule: bool) -> np.ndarray | None:
        img = read_grayscale(os.path.join(style_dir, fn))
        if img is None:
            return None
        ht, wt = img.shape
        if validate_rule and w / float(wt) < h / float(ht):
            rate = w / float(wt)
            new_w, new_h = w, max(1, int(ht * rate))
        else:
            rate = h / float(ht)
            new_w, new_h = max(1, int(wt * rate)), h
        resized = resize(img.astype(np.float32), new_w, new_h, quality=quality)
        final = _fit_canvas(resized.astype(np.float32), h, w)
        assert final.shape == (h, w)
        return (final - 127.5) / 127.5

    train = [x for fn in files[:split] if (x := _load(fn, "area", False)) is not None]
    validate = [x for fn in files[split:] if (x := _load(fn, "cubic", True)) is not None]
    return train, validate


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
