"""The train cells' data set: seeded word images written as PNG files.

The layout the program's data path reads (GAN-Reading: <root>/words-Reading/
<length>/s<length>_<i>.png with the word in a .txt beside it, a lexicon file,
a folder of style images). The rows are spread over the word lengths by a
weight a length, the stand-in for IAM's length skew; each word's letters are
drawn from the seed and drawn as one striped 16-px cell a letter with pixel
noise, on white. Written with numpy and zlib alone.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

CHAR_VECTOR = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit grey PNG of a (H, W) uint8 array, filter 0 on every row."""
    h, w = img.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def draw_word(word: str, h: int = 32) -> np.ndarray:
    """(h, 16 len) float32 on a white page: a letter's cell is a stripe
    pattern keyed by its index in the alphabet."""
    cw = h // 2
    img = np.full((h, cw * len(word)), 255.0, np.float32)
    ys = np.arange(h)[:, None]
    xs = np.arange(cw)[None, :]
    for i, ch in enumerate(word):
        code = CHAR_VECTOR.index(ch)
        pattern = 127.5 + 127.5 * np.sin(0.35 * (code + 1) * xs + 0.2 * (code % 7 + 1) * ys)
        img[:, i * cw:(i + 1) * cw] = np.minimum(img[:, i * cw:(i + 1) * cw], pattern)
    return img


def _write(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(np.clip(img, 0, 255).astype(np.uint8)))


def write_dataset(root: str, seed: int, rows: int, length_weights, style_images: int,
                  noise_sd: float, h: int = 32) -> tuple[str, str, str]:
    """Write the data set under `root`; returns (read_dir, words_file,
    style_dir). Every length gets round(rows * weight) rows, at least one."""
    rng = np.random.default_rng(seed)
    weights = np.asarray(length_weights, np.float64)
    counts = np.maximum(np.round(rows * weights / weights.sum()).astype(int), 1)
    read_dir = os.path.join(root, "words-Reading")
    style_dir = os.path.join(root, "style_imgs")
    words_file = os.path.join(root, "random_words.txt")
    os.makedirs(style_dir, exist_ok=True)
    chars = np.array(list(CHAR_VECTOR))
    lexicon = set()
    for length, count in enumerate(counts, start=1):
        bucket = os.path.join(read_dir, str(length))
        os.makedirs(bucket, exist_ok=True)
        for i in range(count):
            word = "".join(rng.choice(chars, size=length))
            lexicon.add(word)
            img = draw_word(word, h)
            _write(os.path.join(bucket, f"s{length}_{i}.png"), img + rng.normal(0, noise_sd, img.shape))
            with open(os.path.join(bucket, f"s{length}_{i}.txt"), "w") as f:
                f.write(word)
    with open(words_file, "w") as f:
        f.write("\n".join(sorted(lexicon)))
    for i in range(style_images):
        word = "".join(rng.choice(chars, size=int(rng.integers(3, 10))))
        _write(os.path.join(style_dir, f"style_{i}.png"), draw_word(word, h))
    return read_dir, words_file, style_dir


def style_pages(seed: int, count: int, width: int = 160, h: int = 32) -> np.ndarray:
    """(count, h, width) float32 style pages in [-1, 1]: a seeded word of 3-9
    letters drawn on white, right-padded with white to the canvas."""
    rng = np.random.default_rng(seed)
    chars = np.array(list(CHAR_VECTOR))
    out = np.full((count, h, width), 1.0, np.float32)
    for i in range(count):
        word = "".join(rng.choice(chars, size=int(rng.integers(3, 10))))
        img = (draw_word(word, h) - 127.5) / 127.5
        out[i, :, : img.shape[1]] = img[:, :width]
    return out
