"""The port's fresh train state against flax's `init` on the CPU: flax's
`SpectralNorm` runs one power iteration inside `init` (it has no
initialising guard, and `create_train_state` inits with train=True), so a
fresh JAX state holds the normalised first iterate as u and its estimate as
sigma. The port's `create_train_state` runs that iteration and commits it
(`ops/layers.py` `init_power_iteration`).

- From the same kernel and the same starting u0, the port's init iteration
  gives the u and sigma flax's `SpectralNorm` gives with update_stats=True,
  within 1e-5 (float32; a dense and a 3x3 conv kernel).
- Every u of a fresh port state (the DCGAN D and BiLSTM R variant) has unit
  norm, within 1e-5, and every sigma is 1 within 1e-5, the estimate for the
  orthogonal kernels flax draws.
- The state's dropout stream is seeded with the state's seed.
"""

import flax.linen as flax_nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrabblegan_tpu.config import load_config
from scrabblegan_torch.convert import load_flax
from scrabblegan_torch.ops.layers import SNConv, SNDense, _SNLayer, init_power_iteration
from scrabblegan_torch.train.state import create_train_state

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_init_iteration_matches_flax_spectral_norm(kind):
    rng = np.random.default_rng(0)
    if kind == "dense":
        inner, x = flax_nn.Dense(24, use_bias=False), jnp.zeros((1, 40))
        port = SNDense(40, 24)
        kernel = rng.standard_normal((40, 24)).astype(np.float32)
    else:
        inner, x = flax_nn.Conv(24, (3, 3), use_bias=False), jnp.zeros((1, 4, 4, 16))
        port = SNConv(16, 24, (3, 3), use_bias=False)
        kernel = rng.standard_normal((3, 3, 16, 24)).astype(np.float32)
    u0 = rng.standard_normal((1, 24)).astype(np.float32)
    stem = f"{'Dense_0' if kind == 'dense' else 'Conv_0'}/kernel"
    sn = flax_nn.SpectralNorm(inner)
    variables = {"params": {"layer_instance": {"kernel": kernel}},
                 "batch_stats": {"layer_instance/kernel/u": u0,
                                 "layer_instance/kernel/sigma": np.float32(1)}}
    _, muts = sn.apply(variables, x, update_stats=True, mutable=["batch_stats"])
    want_u = np.asarray(muts["batch_stats"]["layer_instance/kernel/u"])
    want_sigma = float(muts["batch_stats"]["layer_instance/kernel/sigma"])
    load_flax(port, {"params": {port.flax_inner: {"kernel": kernel}},
                     "batch_stats": {"SpectralNorm_0": {f"{stem}/u": u0,
                                                        f"{stem}/sigma": np.float32(1)}}})
    init_power_iteration(port)
    np.testing.assert_allclose(port.u.numpy(), want_u, rtol=1e-5, atol=1e-5)
    assert abs(float(port.sigma) - want_sigma) <= 1e-5 * max(1.0, abs(want_sigma))
    assert abs(float(np.linalg.norm(u0)) - 1) > 0.1  # the check tells drawn from iterated


@pytest.fixture(scope="module")
def fresh_state():
    return create_train_state(load_config(None, {"shared.my_disc": True,
                                                 "shared.my_rec": True}), seed=5)


def test_fresh_state_u_is_the_first_iterate(fresh_state):
    """u has unit norm (the drawn u ~ N(0, 1) has a norm near sqrt(out));
    sigma is the iterate's estimate, 1 for the orthogonal kernels flax
    draws (orthonormal columns, or rows where there are fewer)."""
    layers = [m for module in fresh_state.modules().values() for m in module.modules()
              if isinstance(m, _SNLayer) and m.use_sn]
    assert len(layers) > 50
    for layer in layers:
        assert abs(float(layer.u.double().norm()) - 1.0) < 1e-5
        assert abs(float(layer.sigma) - 1.0) < 1e-5


def test_fresh_state_seeds_its_dropout_stream(fresh_state):
    assert int(fresh_state.dropout_seed) == 5 and int(fresh_state.step_t) == 0
