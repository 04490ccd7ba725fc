"""The port's CTC (`scrabblegan_torch.ops.ctc`, optax's recursion in plain
PyTorch) against `optax.ctc_loss` as the JAX package calls it
(`scrabblegan_tpu.ops.ctc`), on the CPU, on numpy-seeded logits.

Tolerances: losses 1e-5 relative; gradients 5e-5 relative and 2e-6
absolute where an alignment exists (the float32 recursion's error grows
with the frames: 2.9e-5 at T = 39, the longest word's). Where none exists the loss is optax's
finite floor, about 1e5 per missing frame (the same float32 value, 1e-6
relative); its gradient is held to 1e-2 absolute: at 1e5 a float32 ulp is
7.8e-3, so one rounding of a log-probability near the floor moves the
weight exp(a - logaddexp(a, b)) by about that much, whichever side rounds.
"""

import jax
import numpy as np
import pytest
import torch

from scrabblegan_tpu.ops import ctc as jctc
from scrabblegan_torch.ops import ctc

torch.set_num_threads(1)

PAD = 52  # the PAD id is the blank, K - 1


def case(seed: int, batch: int, max_len: int, frames=None):
    """Labels of ragged lengths 1..max_len padded with PAD, T = 4 max_len - 1
    frames, each sample's logit length 4 len - 1 (the train step's), some
    labels with repeated neighbours."""
    rng = np.random.default_rng(seed)
    t = 4 * max_len - 1
    logits = (rng.standard_normal((batch, t, PAD + 1)) * 2).astype(np.float32)
    lengths = rng.integers(1, max_len + 1, batch).astype(np.int32)
    lengths[0] = max_len
    labels = rng.integers(0, PAD, (batch, max_len)).astype(np.int32)
    labels[0, 1:] = labels[0, 0]  # all repeats
    for i, n in enumerate(lengths):
        labels[i, n:] = PAD
    logit_lengths = (4 * lengths - 1 if frames is None else frames(lengths)).astype(np.int32)
    return logits, labels, logit_lengths, lengths


def both(logits, labels, logit_lengths, lengths):
    def jax_sum(x):
        return jctc.ctc_loss(x, labels, logit_lengths, lengths).sum()
    want = np.asarray(jctc.ctc_loss(logits, labels, logit_lengths, lengths))
    want_grad = np.asarray(jax.grad(jax_sum)(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = ctc.ctc_loss(x, *map(torch.from_numpy, (labels, logit_lengths, lengths)))
    got.sum().backward()
    return got.detach().numpy(), x.grad.numpy(), want, want_grad


@pytest.mark.parametrize("seed,batch,max_len", [(0, 4, 2), (1, 6, 5), (2, 3, 10)])
def test_ctc_values_and_gradients_match_optax(seed, batch, max_len):
    got, grad, want, want_grad = both(*case(seed, batch, max_len))
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(grad, want_grad, rtol=5e-5, atol=2e-6)


def test_ctc_frames_past_the_logit_length_are_ignored():
    logits, labels, logit_lengths, lengths = case(3, 4, 4)
    got = both(logits, labels, logit_lengths, lengths)[0]
    noisy = logits.copy()
    for i, t in enumerate(logit_lengths):
        noisy[i, t:] = 50.0  # what a padded frame holds does not matter
    np.testing.assert_array_equal(both(noisy, labels, logit_lengths, lengths)[0], got)


def test_ctc_infeasible_alignment_matches_optax():
    """Two frames for labels that need up to 2 len - 1: most samples have no
    alignment; optax floors them, and so does the port."""
    got, grad, want, want_grad = both(*case(4, 5, 5, frames=lambda n: np.full_like(n, 2)))
    assert np.isfinite(got).all() and (want > 1e5).sum() >= 3
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(grad, want_grad, atol=1e-2)
