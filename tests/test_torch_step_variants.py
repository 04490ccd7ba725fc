"""One train step of the port with the DCGAN discriminator and the BiLSTM
recognizer (`shared.my_disc`, `shared.my_rec`) against one of the JAX
package, bucketed, batch 2, length 2, float32, on the CPU; see
tests/test_torch_step_parity.py for how the two are compared. Dropout is
replaced by the identity on both sides (flax's `nn.Dropout` and the port's
`dropout` monkeypatched): the frameworks draw other bits, and the port's
stream is tested in tests/test_torch_bilstm.py. One JAX step is jitted for
the file.

Tolerances as tests/test_torch_step_bucketed.py (float32): metrics 1e-5,
statistics and the G EMA 1e-4, gradients in the norm 1e-1 for G, 5e-3 for D
and W and 1e-4 for R; but g_loss_std and the two balanced metrics, which
divide by it, at 1e-4 relative: here g_loss is 0.0156 and its std over the
batch of two 0.0036, a difference of two close numbers that leaves 2.9e-5
of it (JAX 0.00360099, the port 0.00360088), where g_loss itself agrees to
8e-7."""

import flax.linen as flax_nn
import numpy as np
import pytest
import torch

import test_torch_step_parity as parity
from scrabblegan_torch.models import recognizer
from scrabblegan_torch.train.step import METRIC_NAMES

torch.set_num_threads(1)

GRAD_TOL = {"g": 1e-1, "d": 5e-3, "w": 5e-3, "r": 1e-4}


@pytest.fixture(scope="module")
def variant_pair():
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(flax_nn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
        patch.setattr(recognizer, "dropout", lambda x, rate, deterministic: x)
        yield parity.run_both(parity.config(padded=False, **{"shared.my_disc": True,
                                                              "shared.my_rec": True}),
                              length=2)


def test_variant_step_builds_the_variants(variant_pair):
    models = variant_pair.port_state.models
    assert type(models.discriminator).__name__ == "DCGANDiscriminator"
    assert type(models.recognizer).__name__ == "BiLSTMRecognizer"


BY_STD = ("g_loss_std", "r_loss_balanced", "g_loss_balanced")


def test_variant_step_metrics_match_jax(variant_pair):
    for name in METRIC_NAMES:
        got, want = variant_pair.port_metrics[name], variant_pair.jax_metrics[name]
        assert np.isfinite(got), name
        parity.assert_close(got, want, 1e-4 if name in BY_STD else 1e-5, 1e-5, name)


def test_variant_step_statistics_and_ema_match_jax(variant_pair):
    assert parity.check_stats(variant_pair, rtol=1e-4, atol=1e-4) > 50  # the step moved them
    parity.check_ema(variant_pair, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("net", list(GRAD_TOL))
def test_variant_step_gradients_match_jax(variant_pair, net):
    assert parity.check_gradients_of(variant_pair, net, GRAD_TOL[net]) > 1e-3, net
