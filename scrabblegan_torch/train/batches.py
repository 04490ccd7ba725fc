"""The Trainer's host-side batches: the data it loads and the batches it
assembles from them, in numpy.

Port of the batch half of scrabblegan_tpu/train/loop.py (`Trainer.load_data`,
`_assemble`, `_assemble_mixed`, `_pad_batch`, `next_batch`). Every draw
is JAX's, in JAX's order: the data set's own generator
(seeded with `cfg.seed`) picks buckets and rows, and one
`np.random.default_rng(cfg.seed)` (`np_rng`) draws the fixed visualisation
seed at load time, then each batch's fake labels, fake bucket
('independent' pairing) and style rows. A seed therefore gives the JAX
Trainer's batches array for array.

Shape modes: 'bucketed' (one word length a batch, drawn by population
weight, or `io.seq_len`), 'padded' (images white-padded to the longest
bucket, labels padded with the PAD id `io.n_classes`, true lengths
attached) and, in padded mode, `parallel.batch_mix='sample'` (each sample's
length drawn on its own). `parallel.bucket_pairing` 'matched' gives the
fake words the real words' length, 'independent' draws it uniformly.
`parallel.transfer_dtype` 'uint8' ships raw image bytes (the step
normalises them on the device), anything else float32 in [-1, 1].
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from scrabblegan_torch.config import Config
from scrabblegan_torch.data.loaders import (BucketedDataset, load_random_word_list,
                                            load_style_images, sample_fake_labels)


class Batches:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.np_rng = np.random.default_rng(cfg.seed)
        self.u8 = cfg.parallel.transfer_dtype == "uint8"
        if cfg.parallel.batch_mix not in ("bucket", "sample"):
            raise ValueError(f"unknown batch_mix {cfg.parallel.batch_mix!r}")
        if cfg.parallel.batch_mix == "sample" and cfg.parallel.shape_mode != "padded":
            raise ValueError("batch_mix='sample' requires shape_mode='padded' "
                             "(bucketed batches are single-width by construction)")
        self.mixed = cfg.parallel.batch_mix == "sample"
        self.dataset: Optional[BucketedDataset] = None

    def load(self, read_dir: Optional[str] = None, style_dir: Optional[str] = None,
             words_file: Optional[str] = None) -> None:
        """Load the data set, the style images and the lexicon (the config's
        paths by default) and draw the fixed seed of the epoch grids:
        `seed_style` (num_gen validate-split style images), `seed_labels`
        (num_gen lexicon words of one length, from [4, bucket_size - 1] or
        `io.seq_len`) and `seed_z` (for z_source='noise')."""
        cfg = self.cfg
        self.dataset = BucketedDataset(read_dir or cfg.io.read_dir, cfg.io.input_dim,
                                       cfg.io.bucket_size, cfg.io.char_vec, seed=cfg.seed)
        self.style_train, self.style_validate = load_style_images(
            style_dir or cfg.io.style_dir, cfg.io.input_dim, seed=cfg.seed)
        if not self.style_validate:
            self.style_validate = self.style_train[:1]
        self.random_words = load_random_word_list(words_file or cfg.io.words_file,
                                                  cfg.io.bucket_size, cfg.io.char_vec)
        if self.u8:  # the style bank quantised for the uint8 wire format
            self.style_u8 = np.clip(np.rint(np.stack(self.style_train) * 127.5 + 127.5),
                                    0, 255).astype(np.uint8)
        k = cfg.shared.num_gen
        idx = self.np_rng.integers(0, len(self.style_validate), size=k)
        self.seed_style = np.stack([self.style_validate[i] for i in idx])[..., None]
        lo = min(4, cfg.io.bucket_size - 1)
        seed_bucket = (int(cfg.io.seq_len) - 1 if cfg.io.seq_len
                       else int(self.np_rng.integers(lo, cfg.io.bucket_size)))
        self.seed_labels = sample_fake_labels(self.np_rng, self.random_words, k,
                                              seed_bucket + 1)
        self.seed_z = self.np_rng.standard_normal((k, cfg.shared.latent_dim)).astype(np.float32)

    def _style_batch(self, bsz: int) -> np.ndarray:
        style_idx = self.np_rng.integers(0, len(self.style_train), size=bsz)
        if self.u8:
            return self.style_u8[style_idx][..., None]
        return np.stack([self.style_train[i] for i in style_idx])[..., None].astype(np.float32)

    def assemble(self, bucket: Optional[int] = None, fake_bucket: Optional[int] = None) -> dict:
        """One batch. `bucket` and `fake_bucket` pin the real and fake word
        lengths (bucketed mode); by default they are drawn."""
        if self.mixed:
            return self._assemble_mixed()
        cfg = self.cfg
        bsz = cfg.shared.batch_size
        if bucket is None and cfg.io.seq_len:
            bucket = int(cfg.io.seq_len)
        real_imgs, real_labels, bucket = self.dataset.sample_batch(bsz, bucket=bucket,
                                                                   raw=self.u8)
        if fake_bucket is None:
            if cfg.io.seq_len:
                fake_bucket = int(cfg.io.seq_len)
            elif cfg.parallel.bucket_pairing == "matched":
                fake_bucket = bucket
            else:  # 'independent'
                fake_bucket = int(self.np_rng.integers(1, cfg.io.bucket_size + 1))
        fake_labels = sample_fake_labels(self.np_rng, self.random_words, bsz, fake_bucket)
        batch = {"real_imgs": real_imgs, "real_labels": real_labels,
                 "style_imgs": self._style_batch(bsz), "fake_labels": fake_labels}
        if cfg.parallel.shape_mode == "padded":
            batch = self.pad_batch(batch, bucket, fake_bucket)
        return batch

    def next_chunk(self, k: int) -> dict:
        """JAX's `next_batch`: k batches, every leaf stacked with a leading k.
        For k > 1 the chunk shares one bucket: drawn once ('matched'), or a
        bucket and an independent fake bucket ('independent'), or
        `io.seq_len`; batch_mix='sample' batches share the padded shape and
        need no pinning."""
        cfg = self.cfg
        if k == 1 or self.mixed:
            batches = [self.assemble() for _ in range(k)]
        else:
            if cfg.io.seq_len:
                bucket = fake_bucket = int(cfg.io.seq_len)
            else:
                bucket = self.dataset.sample_bucket()
                fake_bucket = (bucket if cfg.parallel.bucket_pairing == "matched"
                               else int(self.np_rng.integers(1, cfg.io.bucket_size + 1)))
            batches = [self.assemble(bucket=bucket, fake_bucket=fake_bucket)
                       for _ in range(k)]
        return {key: np.stack([b[key] for b in batches]) for key in batches[0]}

    def _assemble_mixed(self) -> dict:
        """batch_mix='sample': each sample's real length drawn by population
        weight; 'matched' pairing gives each fake word its sample's length,
        'independent' a uniform one."""
        cfg = self.cfg
        bsz = cfg.shared.batch_size
        h, _, c = cfg.io.input_dim
        l_max = cfg.io.bucket_size
        w_max = (h // 2) * l_max
        pad_id = cfg.io.n_classes
        ds = self.dataset
        if cfg.io.seq_len:
            real_buckets = np.full((bsz,), int(cfg.io.seq_len))
        else:
            real_buckets = np.array([ds.sample_bucket() for _ in range(bsz)])
        if self.u8:
            real_imgs = np.full((bsz, h, w_max, c), 255, np.uint8)
        else:
            real_imgs = np.full((bsz, h, w_max, c), 1.0, np.float32)
        real_labels = np.full((bsz, l_max), pad_id, np.int32)
        for b in np.unique(real_buckets):
            rows = np.flatnonzero(real_buckets == b)
            imgs, labs, _ = ds.sample_batch(len(rows), bucket=int(b), raw=self.u8)
            real_imgs[rows, :, :imgs.shape[2]] = imgs
            real_labels[rows, :b] = labs
        if cfg.io.seq_len or cfg.parallel.bucket_pairing == "matched":
            fake_buckets = real_buckets.copy()
        else:
            fake_buckets = self.np_rng.integers(1, l_max + 1, size=bsz)
        fake_labels = np.full((bsz, l_max), pad_id, np.int32)
        for b in np.unique(fake_buckets):
            rows = np.flatnonzero(fake_buckets == b)
            fake_labels[rows, :b] = sample_fake_labels(self.np_rng, self.random_words,
                                                       len(rows), int(b))
        return {"real_imgs": real_imgs, "real_labels": real_labels,
                "style_imgs": self._style_batch(bsz), "fake_labels": fake_labels,
                "real_lengths": real_buckets.astype(np.int32),
                "fake_lengths": fake_buckets.astype(np.int32)}

    def pad_batch(self, batch: dict, real_len: int, fake_len: int) -> dict:
        """'padded' mode: white-pad the images to the widest bucket, pad the
        labels with the PAD id, attach the true lengths."""
        cfg = self.cfg
        l_max = cfg.io.bucket_size
        w_max = (cfg.io.input_dim[0] // 2) * l_max
        bsz = batch["real_labels"].shape[0]
        pad_id = cfg.io.n_classes

        def pad_imgs(imgs):
            pad_w = w_max - imgs.shape[2]
            if pad_w <= 0:
                return imgs
            fill = 255 if imgs.dtype == np.uint8 else 1.0  # white either way
            return np.pad(imgs, ((0, 0), (0, 0), (0, pad_w), (0, 0)), constant_values=fill)

        def pad_labels(labels):
            pad_l = l_max - labels.shape[1]
            if pad_l <= 0:
                return labels
            return np.pad(labels, ((0, 0), (0, pad_l)), constant_values=pad_id)

        batch["real_imgs"] = pad_imgs(batch["real_imgs"])
        batch["real_labels"] = pad_labels(batch["real_labels"])
        batch["fake_labels"] = pad_labels(batch["fake_labels"])
        batch["real_lengths"] = np.full((bsz,), real_len, np.int32)
        batch["fake_lengths"] = np.full((bsz,), fake_len, np.int32)
        return batch


class ClassBatches:
    """BigGAN's host-side batches from a class-labelled image set
    (data/classes.py): each step `batch_size` real images and their labels,
    drawn without replacement through a seeded permutation of the rows
    (a fresh one each pass), fake labels uniform over `n_classes` and z
    (batch, dim_z) ~ N(0, I), all from one `np.random.default_rng(seed)`, so
    a seed gives the same stream. `next_chunk(k)` stacks k steps' batches:
    real_imgs (k, B, H, W, 3) uint8, real_labels and fake_labels (k, B)
    int64, z (k, B, dim_z) float32."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int,
                 n_classes: int, dim_z: int, seed: int):
        if len(images) < batch_size:
            raise ValueError(f"{len(images)} rows cannot fill a batch of {batch_size}")
        self.images, self.labels = images, labels
        self.batch_size, self.n_classes, self.dim_z = batch_size, n_classes, dim_z
        self.rng = np.random.default_rng([seed % (2 ** 63), 2])
        self._order = np.empty(0, dtype=np.int64)

    def _rows(self) -> np.ndarray:
        if len(self._order) < self.batch_size:
            self._order = self.rng.permutation(len(self.images))
        rows, self._order = self._order[:self.batch_size], self._order[self.batch_size:]
        return np.sort(rows)

    def next_batch(self) -> dict[str, np.ndarray]:
        rows = self._rows()
        b = self.batch_size
        return {"real_imgs": self.images[rows], "real_labels": self.labels[rows],
                "fake_labels": self.rng.integers(0, self.n_classes, b, dtype=np.int64),
                "z": self.rng.standard_normal((b, self.dim_z), dtype=np.float32)}

    def next_chunk(self, k: int) -> dict[str, np.ndarray]:
        batches = [self.next_batch() for _ in range(k)]
        return {key: np.stack([b[key] for b in batches]) for key in batches[0]}
