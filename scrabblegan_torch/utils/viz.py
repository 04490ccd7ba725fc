"""A labelled grid of word images, the port's copy of
scrabblegan_tpu/utils/viz.py `save_image_grid`. matplotlib is imported when
a grid is drawn, so the port runs without it."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from scrabblegan_torch.config import CHAR_VECTOR


def save_image_grid(images: np.ndarray, labels: Sequence[Sequence[int]],
                    out_path: str, char_vector: str = CHAR_VECTOR,
                    grid: tuple = (4, 4)) -> None:
    """images: (N, H, W) or (N, H, W, 1) in [-1, 1], each titled with its
    decoded label."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = np.asarray(images)
    if images.ndim == 4:
        images = images[..., 0]
    images = (images + 1.0) / 2.0

    rows, cols = grid
    fig = plt.figure(figsize=(cols * 2.2, rows * 1.2))
    for i in range(min(len(images), rows * cols)):
        ax = fig.add_subplot(rows, cols, i + 1)
        ax.imshow(images[i], cmap="gray", vmin=0, vmax=1)
        ax.text(0, -1, "".join(char_vector[int(c)] for c in labels[i]))
        ax.axis("off")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
