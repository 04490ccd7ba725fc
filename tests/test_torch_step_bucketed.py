"""One train step of the port against one of the JAX package, bucketed shape
mode (every word of a batch has the same length), batch 2, length 2, on the
CPU; see tests/test_torch_step_parity.py for how the two are compared. Also the
stats commit rule and the disc_iters cadence on the port alone.

Tolerances (float32): metrics 1e-5 (a few sums of per-sample losses);
statistics and the G EMA 1e-4; gradients in the norm of each leaf 1e-1 for G,
5e-3 for D and W and 1e-4 for R (G's are ill-conditioned at this state, see
the helper's docstring; the largest errors measured were 4.3%, 1.1e-3,
5.8e-4 and 4.9e-6)."""

import pytest
import torch

import test_torch_step_parity as parity
from scrabblegan_torch.convert import state_from_flax
from scrabblegan_torch.ops import layers
from scrabblegan_torch.train.step import make_train_step

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

GRAD_TOL = {"g": 1e-1, "d": 5e-3, "w": 5e-3, "r": 1e-4}


@pytest.fixture(scope="module")
def f32_pair():
    return parity.run_both(parity.config(padded=False), length=2)


def test_step_metrics_match_jax(f32_pair):
    parity.check_metrics(f32_pair, rtol=1e-5, atol=1e-5)


def test_step_statistics_and_ema_match_jax(f32_pair):
    assert parity.check_stats(f32_pair, rtol=1e-4, atol=1e-4) > 100  # the step moved them
    parity.check_ema(f32_pair, rtol=1e-4, atol=1e-6)


def test_step_gradients_match_jax(f32_pair):
    for net, tol in GRAD_TOL.items():
        largest = parity.check_gradients_of(f32_pair, net, tol)
        assert largest > 1e-3, net  # every network received a gradient


def test_stats_commit_rule():
    """D runs three times a step (real, fake for D, fake for G, frozen); its
    SN u must advance by exactly one power iteration from the start value,
    the one of the pass on real images, and its buffers must not move during
    the forward passes."""
    cfg = parity.config(padded=False, **{"shared.use_recognizer": False,
                                         "shared.use_style_promoter": False})
    trees = {n: parity.fake_tree(cfg, n) for n in "gdrw"}
    state = state_from_flax(cfg, {n: t["params"] for n, t in trees.items()},
                            {n: t.get("batch_stats", {}) for n, t in trees.items()})
    D = state.models.discriminator
    conv = D.trunk.block_B2.conv1
    u0, w0 = conv.u.clone(), conv.weight.detach().clone()
    mat = w0.movedim(0, -1).reshape(-1, w0.shape[0])
    want = layers.l2_normalize(layers.l2_normalize(u0 @ mat.T) @ mat)
    make_train_step(cfg, state.models)(state, parity.make_batch(cfg, 2))
    torch.testing.assert_close(conv.u, want, rtol=1e-6, atol=1e-7)
    # a second power iteration would have moved u beyond the tolerance above,
    # so the check tells one iteration from two or three
    again = layers.l2_normalize(layers.l2_normalize(want @ mat.T) @ mat)
    assert (again - want).abs().max() > 1e-5


def test_disc_iters_cadence_and_ema():
    """disc_iters=2: G and its EMA move on the second step only; D every step
    (R and W, whose cadence is D's, are off)."""
    cfg = parity.config(padded=False, **{"optimizer.disc_iters": 2,
                                         "shared.use_recognizer": False,
                                         "shared.use_style_promoter": False})
    trees = {n: parity.fake_tree(cfg, n) for n in "gdrw"}
    state = state_from_flax(cfg, {n: t["params"] for n, t in trees.items()},
                            {n: t.get("batch_stats", {}) for n, t in trees.items()})
    step = make_train_step(cfg, state.models)
    G, D = state.models.generator, state.models.discriminator
    g0 = G.to_image.weight.detach().clone()
    d0 = D.head.weight.detach().clone()
    step(state, parity.make_batch(cfg, 2))
    assert torch.equal(G.to_image.weight, g0) and not torch.equal(D.head.weight, d0)
    assert state.opt_states["g"].count == 0 and state.opt_states["d"].count == 1
    ema = [e.clone() for e in state.g_ema]
    step(state, parity.make_batch(cfg, 2, seed=1))
    assert not torch.equal(G.to_image.weight, g0) and state.opt_states["g"].count == 1
    params = list(G.parameters())
    for e0, e1, p in zip(ema, state.g_ema, params):
        torch.testing.assert_close(e1, 0.999 * e0 + 0.001 * p.detach())
    assert state.step == 2
