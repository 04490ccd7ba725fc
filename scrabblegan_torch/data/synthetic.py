"""Seeded synthetic train batches, made with numpy in the JAX bench's layout
(bench.py): uint8 images and integer labels, with true lengths in 'padded'
shape mode."""

from __future__ import annotations

import numpy as np
import torch


def synthetic_batch(cfg, batch_size: int, length: int, rng: np.random.Generator) -> dict:
    """A uint8 batch in the JAX bench's layout; in 'padded' mode words of
    random true length padded with the PAD id to io.bucket_size."""
    h, w_style, c = cfg.io.input_dim
    n = cfg.io.n_classes
    if cfg.parallel.shape_mode != "padded":
        return {"real_imgs": rng.integers(0, 256, (batch_size, h, 16 * length, c), np.uint8),
                "real_labels": rng.integers(0, n, (batch_size, length)),
                "style_imgs": rng.integers(0, 256, (batch_size, h, w_style, c), np.uint8),
                "fake_labels": rng.integers(0, n, (batch_size, length))}
    top = cfg.io.bucket_size
    batch = {"real_imgs": rng.integers(0, 256, (batch_size, h, 16 * top, c), np.uint8),
             "style_imgs": rng.integers(0, 256, (batch_size, h, w_style, c), np.uint8)}
    for side in ("real", "fake"):
        lengths = rng.integers(1, top + 1, batch_size)
        labels = rng.integers(0, n, (batch_size, top))
        labels[np.arange(top)[None, :] >= lengths[:, None]] = n  # the PAD id
        batch[f"{side}_labels"], batch[f"{side}_lengths"] = labels, lengths
    return batch


def synthetic_noise(cfg, batch_size: int, rng: np.random.Generator) -> torch.Tensor | None:
    """z (batch_size, latent_dim), float32 N(0, 1) from rng, for
    z_source='noise'; None for 'style', whose z G encodes itself."""
    if cfg.shared.z_source != "noise":
        return None
    return torch.from_numpy(rng.standard_normal((batch_size, cfg.shared.latent_dim))
                            .astype(np.float32))


def synthetic_feed(cfg, batch_size: int, length: int, seed: int):
    """Endless (batch, z) pairs, drawn from one generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    while True:
        yield synthetic_batch(cfg, batch_size, length, rng), synthetic_noise(cfg, batch_size, rng)
