"""BigGAN's inputs to the train CLI's steps mode (train/cli.py): the
class-labelled images and their prefetching feed.

The data is an .npz of uint8 (N, H, W, 3) images and int labels
(data/classes.py); without one a seeded synthetic set of `SYNTHETIC_ROWS`
rows is made in memory. The feed is `train.loop._Prefetcher` over pinned
chunks of `train.batches.ClassBatches`, `parallel.prefetch_depth` calls
ahead, traced as the word feed is (`feed.wait`, `feed.make`, `feed.empty`).
"""

from __future__ import annotations

import numpy as np
import torch

from scrabblegan_torch.config import BigGANConfig, Config
from scrabblegan_torch.data.classes import load_classes, synthetic_classes
from scrabblegan_torch.train.batches import ClassBatches
from scrabblegan_torch.train.loop import _Prefetcher

SYNTHETIC_ROWS = 2048
SKIPPED = ("BigGAN: the ScrabbleGAN Trainer's word-specific epoch artifacts (word grids, CER, "
           "rFID on R's features, the export gate) do not apply and are skipped")


def class_data(spec: BigGANConfig, data: str | None, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The images and labels of the .npz `data`, or the seeded synthetic set;
    raises when the images are not the config's resolution."""
    if data:
        images, labels = load_classes(data)
    else:
        images, labels = synthetic_classes(SYNTHETIC_ROWS, spec.resolution, spec.n_classes, seed)
    if images.shape[1:3] != (spec.resolution, spec.resolution):
        raise ValueError(f"images are {images.shape[1:3]}, the config's resolution "
                         f"{spec.resolution}")
    return images, labels


def class_feed(cfg: Config, spec: BigGANConfig, images: np.ndarray, labels: np.ndarray,
               batch_size: int, seed: int, steps: int, device: torch.device) -> _Prefetcher:
    """A prefetching feed of `steps` steps' batches in chunks of K =
    `parallel.steps_per_call` (the last one the steps left), pinned for the
    card."""
    batches = ClassBatches(images, labels, batch_size, spec.n_classes, spec.dim_z, seed)
    k = max(1, int(cfg.parallel.steps_per_call))
    pin = device.type == "cuda"
    left = steps

    def make():
        nonlocal left
        n, left = min(k, left), left - min(k, left)
        return {key: (torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v))
                for key, v in batches.next_chunk(n).items()}
    return _Prefetcher(make, -(-steps // k), cfg.parallel.prefetch_depth)
