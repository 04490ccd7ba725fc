"""The train step's other branches against the JAX package, one step each at
batch 2, length 2, bucketed, on the CPU (tests/test_torch_step_parity.py):

- style_loss_mode 'style_vs_iam' with the non-saturating loss and the paper's
  gradient balancing (balance_mode 'grad_norm', `balanced_fanout`);
- style_loss_mode 'bug_compatible' with the reference's loss rescaling
  applied (apply_gradient_balance), optax-layout Adam and RMSprop for R.

Compared: the 16 metrics (1e-5) and every statistic (1e-4), float32."""

import pytest

import test_torch_step_parity as parity


@pytest.mark.parametrize("overrides", [
    {"optimizer.style_loss_mode": "style_vs_iam", "optimizer.loss_fn": "not_saturating",
     "optimizer.apply_gradient_balance": True, "optimizer.balance_mode": "grad_norm"},
    {"optimizer.style_loss_mode": "bug_compatible", "optimizer.apply_gradient_balance": True,
     "optimizer.adam_impl": "optax", "optimizer.rmsprop": True},
], ids=["style_vs_iam-not_saturating-grad_norm", "bug_compatible-rescale-optax-rmsprop"])
def test_step_branch_matches_jax(overrides):
    pair = parity.run_both(parity.config(padded=False, **overrides), length=2, seed=2)
    parity.check_metrics(pair, rtol=1e-5, atol=1e-5)
    parity.check_stats(pair, rtol=1e-4, atol=1e-4)
