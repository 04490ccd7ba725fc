"""One train step of the port against one of the JAX package in padded shape
mode (one static width, true lengths riding with the batch: width masks on
D and W, CTC lengths 4 len - 1, G's white-out), batch 2, length 2 with the
second word one character shorter, on the CPU; and one bucketed step with
the recommended bf16 trunks (D, W and the style encoder in bfloat16). See
tests/test_torch_step_parity.py for how the steps are compared.

Tolerances as in test_torch_step_bucketed.py (float32): metrics 1e-5,
statistics and the G EMA 1e-4, gradients in the norm 1e-1 for G, 5e-3 for D
and W and 1e-4 for R. The bf16-trunk step holds the metrics at 2e-2 and the
statistics at 2e-2: the frameworks round bfloat16 at other places."""

import pytest

import test_torch_step_parity as parity

GRAD_TOL = {"g": 1e-1, "d": 5e-3, "w": 5e-3, "r": 1e-4}


@pytest.fixture(scope="module")
def padded_pair():
    return parity.run_both(parity.config(padded=True), length=2)


def test_padded_step_metrics_match_jax(padded_pair):
    parity.check_metrics(padded_pair, rtol=1e-5, atol=1e-5)


def test_padded_step_statistics_and_ema_match_jax(padded_pair):
    assert parity.check_stats(padded_pair, rtol=1e-4, atol=1e-4) > 100
    parity.check_ema(padded_pair, rtol=1e-4, atol=1e-6)


def test_padded_step_gradients_match_jax(padded_pair):
    for net, tol in GRAD_TOL.items():
        assert parity.check_gradients_of(padded_pair, net, tol) > 1e-3, net


def test_bf16_trunk_step_matches_jax():
    pair = parity.run_both(parity.config(padded=False, **{"shared.trunk_dtype": "bfloat16"}),
                           length=2, seed=1)
    parity.check_metrics(pair, rtol=2e-2, atol=2e-2)
    parity.check_stats(pair, rtol=2e-2, atol=2e-2)
