"""The port's losses, CTC, gradient balancing, optimizers and schedules
against the JAX package and optax (CPU), on the same numpy-seeded inputs.

Tolerances: 1e-6 on the losses and balancing (a few float32 operations);
CTC 1e-5 relative on losses of ~10-30 and on its gradient; the optimizers
1e-6 relative on three updates (the same float32 formulas, summed in another
order), and bf16 second moments to one bf16 ulp (4e-3 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scrabblegan_tpu.config import load_config
from scrabblegan_tpu.ops import balance as jbalance
from scrabblegan_tpu.ops import ctc as jctc
from scrabblegan_tpu.ops import losses as jlosses
from scrabblegan_tpu.train.optim import lean_adam
from scrabblegan_tpu.train.state import make_optimizers as jax_make_optimizers
from scrabblegan_torch.ops import balance, ctc, losses
from scrabblegan_torch.train import optim

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("name", ["hinge", "not_saturating"])
def test_gan_losses_match_jax(name):
    real, fake = rand(0, (16,), 3), rand(1, (16,), 3)
    want = jlosses.DISC_LOSS_REGISTRY[name](real, fake)
    got = losses.DISC_LOSS_REGISTRY[name](torch.from_numpy(real), torch.from_numpy(fake))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(losses.GEN_LOSS_REGISTRY[name](torch.from_numpy(fake)).numpy(),
                               np.asarray(jlosses.GEN_LOSS_REGISTRY[name](fake)),
                               rtol=1e-6, atol=1e-6)


def ctc_case():
    """B = 4, K = 53 (blank 52), T = 4L - 1 frames for L = 3: repeated
    characters, and padded labels carrying the PAD id (= the blank)."""
    logits = rand(2, (4, 11, 53), 2)
    labels = np.array([[5, 5, 7], [1, 2, 3], [9, 9, 9], [4, 52, 52]], np.int32)
    label_lengths = np.array([3, 3, 3, 1], np.int32)
    logit_lengths = 4 * label_lengths - 1
    return logits, labels, logit_lengths, label_lengths


def test_ctc_matches_optax():
    args = ctc_case()
    jgrad = jax.grad(lambda x: jctc.ctc_loss(x, *args[1:]).sum())(args[0])
    jper = jctc.ctc_loss(*args)
    logits = torch.from_numpy(args[0]).requires_grad_()
    got = ctc.ctc_loss(logits, *map(torch.from_numpy, args[1:]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jper), rtol=1e-5)
    got.sum().backward()
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6)


def test_ctc_infeasible_alignment_is_inf():
    """Three repeated characters need 5 frames; 4 give no alignment. optax
    returns a finite loss floored by its log epsilon, the port inf."""
    logits = rand(3, (1, 4, 53))
    labels = np.array([[7, 7, 7]], np.int32)
    n, t = np.array([3], np.int32), np.array([4], np.int32)
    assert np.isfinite(np.asarray(jctc.ctc_loss(logits, labels, t, n))).all()
    got = ctc.ctc_loss(*map(torch.from_numpy, (logits, labels, t, n)))
    assert torch.isinf(got).all()


def test_gradient_balance_matches_jax():
    r_fake, g_loss = rand(4, (16,), 5), rand(5, (16,))
    want = jbalance.gradient_balance(r_fake, g_loss, alpha=0.7)
    got = balance.gradient_balance(torch.from_numpy(r_fake), torch.from_numpy(g_loss), 0.7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6)
    # the population std, not torch's unbiased default
    np.testing.assert_allclose(float(got[3]), r_fake.std(), rtol=1e-6)


def test_balanced_fanout_backward_matches_jax_vjp():
    imgs, adv, ctc_cot = rand(6, (2, 1, 4, 8)), rand(7, (2, 1, 4, 8)), rand(8, (2, 1, 4, 8), 30)
    _, vjp = jax.vjp(lambda x: jbalance.balanced_fanout(x, 0.5), imgs)
    (want,) = vjp((adv, ctc_cot))
    x = torch.from_numpy(imgs).requires_grad_()
    a, b = balance.balanced_fanout(x, 0.5)
    torch.testing.assert_close(a, x)
    torch.testing.assert_close(b, x)
    torch.autograd.backward([a, b], [torch.from_numpy(adv), torch.from_numpy(ctc_cot)])
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def run_optimizers(jax_tx, port_tx, steps=3):
    """`steps` updates of both on the same gradients; returns the updates."""
    shapes = [(3, 4), (5,), (2, 3, 3)]
    params = [rand(10 + i, s) for i, s in enumerate(shapes)]
    jstate = jax_tx.init(params)
    pstate = port_tx.init([torch.from_numpy(p) for p in params])
    out = []
    for step in range(steps):
        grads = [rand(100 * step + i, s, 10.0 ** (i - 1)) for i, s in enumerate(shapes)]
        jupd, jstate = jax_tx.update(grads, jstate, params)
        pupd, pstate = port_tx.update([torch.from_numpy(g) for g in grads], pstate)
        out.append((jupd, pupd, jstate, pstate))
    return out


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_lean_adam_matches_jax(moment_dtype):
    sched = optax.constant_schedule(2e-4)
    jtx = lean_adam(sched, b1=0.0, b2=0.999, moment_dtype=moment_dtype)
    ptx = optim.adam(optim.constant_schedule(2e-4), 0.0, 0.999, moment_dtype=moment_dtype,
                     elide_mu=True)
    for jupd, pupd, jstate, pstate in run_optimizers(jtx, ptx):
        assert pstate.mu is None and jstate[0].mu is None
        for j, p in zip(jupd, pupd):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-6 if moment_dtype ==
                                       "float32" else 4e-3, atol=0)
        for j, p in zip(jstate[0].nu, pstate.nu):
            assert str(p.dtype).endswith(moment_dtype)
            np.testing.assert_allclose(p.float().numpy(), np.asarray(j, np.float32), rtol=1e-6)


@pytest.mark.parametrize("which", ["optax_adam", "rmsprop"])
def test_optax_layout_adam_and_rmsprop_match_optax(which):
    if which == "optax_adam":
        jtx, ptx = (optax.adam(1e-3, b1=0.5, b2=0.9),
                    optim.adam(optim.constant_schedule(1e-3), 0.5, 0.9))
    else:  # optax's defaults: decay 0.9, eps 1e-8 inside the root
        jtx, ptx = optax.rmsprop(1e-3), optim.rmsprop(optim.constant_schedule(1e-3))
    for jupd, pupd, _, _ in run_optimizers(jtx, ptx):
        for j, p in zip(jupd, pupd):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "warmup_cosine"])
def test_schedules_and_make_optimizers_match_optax(schedule):
    cfg = load_config(None, {"optimizer.lr_schedule": schedule, "optimizer.warmup_steps": 3,
                             "optimizer.decay_steps": 10, "optimizer.rmsprop": True})
    jtx, ptx = jax_make_optimizers(cfg)["r"], optim.make_optimizers(cfg)["r"]
    out = run_optimizers(jtx, ptx, steps=12)
    for jupd, pupd, _, _ in out:
        np.testing.assert_allclose(pupd[0].numpy(), np.asarray(jupd[0]), rtol=1e-5, atol=1e-12)
    port = optim.make_optimizers(cfg)
    assert set(port) == {"g", "d", "r", "w"}
