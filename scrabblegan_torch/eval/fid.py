"""Fréchet distances between generated and real word images.

The port of scrabblegan_tpu/eval/fid.py:
- `frechet_distance`: |mu_a - mu_b|^2 + tr(Ca + Cb - 2 sqrtm(Ca Cb)) in
  float64 with `scipy.linalg.sqrtm`, as in JAX (the card's machine has
  scipy);
- `recognizer_features`: the pooled 512-d conv features of the port's R
  (`return_features=True`), in eval mode;
- `random_features`: a fixed random conv net (four 3x3 stride-2 convs,
  widths 64/128/256/512, ReLU, global average pool). Its kernels are the
  JAX package's `jax.random` draws for seed 0, stored once in
  `rfid_rand_seed0.npz` beside this module (HWIO, float32), because the
  export gate's threshold was calibrated on exactly those weights. JAX's
  stride-2 SAME padding is reproduced: it pads (0, 1) on an even size and
  (1, 1) on an odd one, where torch's padding=1 would pad (1, 1) always;
- `compute_rfid`: the distance under an extractor, in chunks.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

RFID_RAND_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "rfid_rand_seed0.npz")


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6) -> float:
    """Fréchet distance between feature sets (N_a, D) and (N_b, D)."""
    import scipy.linalg

    feats_a = np.asarray(feats_a, np.float64)
    feats_b = np.asarray(feats_b, np.float64)
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    cov_a = np.cov(feats_a, rowvar=False)
    cov_b = np.cov(feats_b, rowvar=False)
    diff = mu_a - mu_b
    # no `disp` argument: SciPy 1.17 deprecates it, and without it every
    # version returns the root alone
    covmean = scipy.linalg.sqrtm(cov_a @ cov_b)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov_a.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((cov_a + offset) @ (cov_b + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov_a) + np.trace(cov_b) - 2.0 * np.trace(covmean))


def _nchw(images, device: torch.device) -> torch.Tensor:
    """(N, H, W) or (N, H, W, C) images in [-1, 1] -> float32 (N, C, H, W)."""
    x = torch.as_tensor(np.asarray(images, np.float32))
    if x.dim() == 3:
        x = x[..., None]
    return x.permute(0, 3, 1, 2).contiguous().to(device)


def recognizer_features(recognizer: torch.nn.Module) -> Callable:
    """images (N, H, W, C) in [-1, 1] -> (N, 512) features of `recognizer`
    in eval mode (its mode is restored after each call)."""
    device = next(recognizer.parameters()).device

    def extractor(images: np.ndarray) -> np.ndarray:
        was_training = recognizer.training
        recognizer.eval()
        try:
            with torch.inference_mode():
                return recognizer(_nchw(images, device), return_features=True).cpu().numpy()
        finally:
            recognizer.train(was_training)

    return extractor


def _same_pad(n: int) -> tuple[int, int]:
    """XLA's SAME padding of a 3-tap stride-2 window over n pixels."""
    total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


def load_random_kernels() -> list[np.ndarray]:
    """The four HWIO kernels of the seed-0 random extractor."""
    with np.load(RFID_RAND_WEIGHTS) as data:
        return [data[f"kernel{i}"] for i in range(len(data.files))]


def random_features(device: str | torch.device = "cpu") -> Callable:
    """images (N, H, W[, C]) in [-1, 1] -> (N, 512) features of the fixed
    random conv net, in float32 (TF32 off on a card)."""
    device = torch.device(device)
    kernels = [torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(device)
               for k in load_random_kernels()]

    def extractor(images: np.ndarray) -> np.ndarray:
        x = _nchw(images, device)
        with torch.inference_mode(), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
            for kern in kernels:
                (top, bottom), (left, right) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
                x = torch.relu(F.conv2d(F.pad(x, (left, right, top, bottom)), kern, stride=2))
            return x.mean(dim=(2, 3)).cpu().numpy()

    return extractor


def compute_rfid(gen_images: np.ndarray, real_images: np.ndarray, extractor: Callable,
                 batch_size: Optional[int] = None) -> float:
    """Fréchet distance between generated and real images (of one shape)
    under `extractor`, fed `batch_size` images at a time (all at once by
    default)."""
    def feats(images):
        if batch_size is None:
            return extractor(images)
        return np.concatenate([extractor(images[i:i + batch_size])
                               for i in range(0, len(images), batch_size)], 0)

    return frechet_distance(feats(gen_images), feats(real_images))
