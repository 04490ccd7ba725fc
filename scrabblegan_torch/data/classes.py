"""Class-labelled image data sets for BigGAN: an .npz of uint8 images and
int labels, and the seeded synthetic writer of the tests and the benchmark.

The file holds `images` (N, H, W, 3) uint8 and `labels` (N,) int, as a
converted ImageNet crop set would (ImageNet itself is not in the repository).
`write_synthetic_classes` makes one from a seed: each class a colour, each
image its class colour under a coarse random pattern and fine noise, so that
labels and pixels are related and every pixel value occurs.
"""

from __future__ import annotations

import numpy as np


def load_classes(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(images (N, H, W, 3) uint8, labels (N,) int64) of an .npz; raises on
    another layout."""
    with np.load(path) as f:
        images, labels = f["images"], f["labels"]
    if images.dtype != np.uint8 or images.ndim != 4 or images.shape[3] != 3:
        raise ValueError(f"{path}: images must be (N, H, W, 3) uint8, got "
                         f"{images.shape} {images.dtype}")
    if labels.shape != images.shape[:1] or not np.issubdtype(labels.dtype, np.integer):
        raise ValueError(f"{path}: labels must be (N,) int, got {labels.shape} {labels.dtype}")
    return images, labels.astype(np.int64)


def synthetic_classes(rows: int, resolution: int, n_classes: int,
                      seed: int) -> tuple[np.ndarray, np.ndarray]:
    """`rows` seeded images (rows, resolution, resolution, 3) uint8 and their
    labels, uniform over `n_classes`."""
    rng = np.random.default_rng([seed % (2 ** 63), 1])
    labels = rng.integers(0, n_classes, rows, dtype=np.int64)
    colours = rng.integers(32, 224, (n_classes, 3), dtype=np.int16)
    cells = resolution // 8
    coarse = rng.integers(-48, 48, (rows, cells, cells, 3), dtype=np.int16)
    images = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)
    images += colours[labels][:, None, None, :]
    images += rng.integers(-32, 32, images.shape, dtype=np.int16)
    return np.clip(images, 0, 255).astype(np.uint8), labels


def write_synthetic_classes(path: str, rows: int, resolution: int, n_classes: int,
                            seed: int) -> str:
    """`synthetic_classes` written as an .npz at `path`; returns the path."""
    images, labels = synthetic_classes(rows, resolution, n_classes, seed)
    np.savez(path, images=images, labels=labels)
    return path
