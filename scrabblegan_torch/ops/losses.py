"""GAN losses: hinge and non-saturating, per sample.

Port of scrabblegan_tpu/ops/losses.py (the decomposed registries the train
step uses): a disc loss maps (real logits, fake logits) to per-sample
(loss, real term, fake term); a gen loss maps fake logits to a per-sample
loss. Both adversaries, D and the style promoter W, use the disc form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_bce_ones(logits: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy(logits, 1) = -log_sigmoid(logits)."""
    return -F.logsigmoid(logits)


def sigmoid_bce_zeros(logits: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy(logits, 0) = -log_sigmoid(-logits)."""
    return -F.logsigmoid(-logits)


def hinge_disc(real: torch.Tensor, fake: torch.Tensor):
    real_term = torch.relu(1.0 - real)
    fake_term = torch.relu(1.0 + fake)
    return real_term + fake_term, real_term, fake_term


def hinge_gen(fake: torch.Tensor) -> torch.Tensor:
    return -fake


def not_saturating_disc(real: torch.Tensor, fake: torch.Tensor):
    real_term = sigmoid_bce_ones(real)
    fake_term = sigmoid_bce_zeros(fake)
    return real_term + fake_term, real_term, fake_term


def not_saturating_gen(fake: torch.Tensor) -> torch.Tensor:
    return sigmoid_bce_ones(fake)


DISC_LOSS_REGISTRY = {"hinge": hinge_disc, "not_saturating": not_saturating_disc}
GEN_LOSS_REGISTRY = {"hinge": hinge_gen, "not_saturating": not_saturating_gen}
