"""The port's analytic FLOP count (`scrabblegan_torch.utils.flops`) against
the JAX package's (`scrabblegan_tpu.utils.flops.matmul_flops`) on the CPU.

- Known counts, restated from tests/test_flops.py: a matmul, a batched
  einsum, a conv, the backward of a matmul; the attention ops' formulas
  against the products of the plain core.
- Each network's forward at small shapes (batch 2, images 32 x 48, G at
  length 3; JAX on its plain attention path, the port on the CPU, zero
  weights): G, the BigGAN D, W, the conv R, the DCGAN D and the BiLSTM R.
  The counts are equal, exactly.
- One train step with `shared.my_disc` and `shared.my_rec` (bucketed,
  batch 2, length 2), the two counts side by side: within 0.05 of each
  other, and the port's step plus one forward of W on the real images
  within 1e-4 of JAX's. That term is JAX's W pass on IAM images, which the
  'adversarial' style mode does not read: the jaxpr JAX counts still holds
  it (XLA removes it when it compiles the step), and the port's step skips
  it (train/step.py); it is 2.8% of the step here. What remains, 4.6e-5 of
  the step: the DCGAN D's stride-2 convs pad their input explicitly
  (ops/layers.py `same_padding`), so the port counts their input gradients
  over the padded input (+13,584,960); and optax's CTC takes its label
  log-probabilities by a one-hot einsum, a product JAX counts, where the
  port's CTC picks them elementwise (-13,616).
- The persistent cache, restated from tests/test_flops.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

import test_torch_step_parity as parity
from scrabblegan_tpu.config import Config, SharedSpecs
from scrabblegan_tpu.train.state import build_models as jax_build_models
from scrabblegan_tpu.train.step import make_train_step as jax_make_train_step
from scrabblegan_tpu.utils.flops import matmul_flops as jax_matmul_flops
from scrabblegan_torch.convert import state_from_flax
from scrabblegan_torch.kernels import attention
from scrabblegan_torch.models.build import build_generator, build_models, noise_config
from scrabblegan_torch.ops.layers import record_stats
from scrabblegan_torch.train.step import make_train_step
from scrabblegan_torch.utils import flops
from scrabblegan_torch.utils.flops import matmul_flops

torch.set_num_threads(1)


class TestKnownCounts:
    def test_plain_matmul(self):
        assert matmul_flops(torch.matmul, torch.zeros(8, 32), torch.zeros(32, 16)) == \
            2 * 8 * 16 * 32

    def test_batched_einsum(self):
        got = matmul_flops(lambda x, y: torch.einsum("bij,bjk->bik", x, y),
                           torch.zeros(4, 8, 32), torch.zeros(4, 32, 16))
        assert got == 2 * 4 * 8 * 16 * 32

    def test_conv2d(self):
        got = matmul_flops(lambda x, k: F.conv2d(x, k, padding="same"),
                           torch.zeros(2, 8, 16, 16), torch.zeros(4, 8, 3, 3))
        assert got == 2 * (2 * 16 * 16 * 4) * (3 * 3 * 8)

    def test_grad_adds_backward_flops(self):
        a = torch.zeros(8, 32)
        w = torch.zeros(32, 16, requires_grad=True)
        fwd = matmul_flops(lambda: (a @ w).sum())
        fwd_bwd = matmul_flops(lambda: (a @ w).sum().backward())
        assert fwd_bwd == 2 * fwd  # the weight's gradient; a needs none

    def test_inference_mode_is_refused(self):
        """Its aten ops bypass the dispatch mode: a count there would be 0."""
        with torch.inference_mode(), pytest.raises(RuntimeError, match="no_grad"):
            matmul_flops(torch.matmul, torch.zeros(2, 2), torch.zeros(2, 2))

    @pytest.mark.parametrize("grad", [False, True])
    def test_attention_ops_count_the_plain_core_s_products(self, grad):
        """The registered forward counts the plain core's two products; its
        backward the four of the plain backward."""
        ops = [torch.randn(2, c, n, requires_grad=grad) for c, n in ((8, 64), (8, 16), (32, 16))]
        d = torch.randn(2, 32, 64)

        def plain():
            out = attention.attention_reference(*ops)
            if grad:
                out.backward(d)

        def registered():
            out = attention.attention_fwd(*ops)
            if grad:
                attention.attention_bwd(*ops, d)

        assert matmul_flops(registered) == matmul_flops(plain) == \
            (3 if grad else 1) * 2 * 2 * 64 * 16 * (8 + 32)


def jax_zero_variables(module, *args, **kwargs):
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0),
                                                 "dropout": jax.random.PRNGKey(1)},
                                                *args, **kwargs))
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def test_generator_forward_equals_jax():
    cfg = Config(shared=dataclasses.replace(SharedSpecs(), z_source="noise",
                                            use_pallas_attention=False))
    gen = jax_build_models(cfg).generator
    labels, z = jnp.zeros((2, 3), jnp.int32), jnp.zeros((2, 128))
    v = jax_zero_variables(gen, labels, z=z, train=False)
    want = jax_matmul_flops(lambda vv, l, zz: gen.apply(vv, l, z=zz, train=False), v, labels, z)
    g = build_generator(noise_config(None, {}), "cpu")
    with torch.no_grad():
        got = matmul_flops(g, torch.zeros(2, 3, dtype=torch.long), torch.zeros(2, 128))
    assert got == want


@pytest.mark.parametrize("variant", [False, True], ids=["biggan-conv", "dcgan-bilstm"])
def test_d_w_r_forwards_equal_jax(variant):
    over = {"shared.use_pallas_attention": False}
    if variant:
        over.update({"shared.my_disc": True, "shared.my_rec": True})
    cfg = parity.config(padded=False, **over)
    jax_models, port_models = jax_build_models(cfg), build_models(cfg, "cpu")
    x = jnp.zeros((2, 32, 48, 1))
    for net in ("discriminator", "style_promoter", "recognizer"):
        module = getattr(jax_models, net)
        v = jax_zero_variables(module, x, False)
        want = jax_matmul_flops(lambda vv, xx: module.apply(vv, xx, False), v, x)
        with torch.no_grad():
            got = matmul_flops(getattr(port_models, net).eval(), torch.zeros(2, 1, 32, 48))
        assert got == want, net


def test_variant_train_step_beside_jax():
    cfg = parity.config(padded=False, **{"shared.use_pallas_attention": False,
                                         "shared.my_disc": True, "shared.my_rec": True})
    models, jstate, trees = parity.jax_start_state(cfg)
    batch = parity.make_batch(cfg, 2)
    want = jax_matmul_flops(jax_make_train_step(cfg, models), jstate, batch,
                            jax.random.PRNGKey(1))
    state = state_from_flax(cfg, {n: t[0] for n, t in trees.items()},
                            {n: t[1] for n, t in trees.items()})
    real = torch.from_numpy(batch["real_imgs"]).permute(0, 3, 1, 2).float()
    with record_stats():  # W in train mode, its statistics discarded
        dead_w_pass = matmul_flops(state.models.style_promoter, (real - 127.5) / 127.5)
    got = matmul_flops(make_train_step(cfg, state.models), state, batch)
    assert abs(got / want - 1) < 0.05
    assert abs((got + dead_w_pass) / want - 1) < 1e-4


class TestFlopsCache:
    """matmul_flops_cached: a persistent JSON cache keyed on the salt, the
    args' shapes and dtypes and the torch version."""

    @staticmethod
    def _fn(x):
        return x @ x

    def test_hit_skips_recount(self, tmp_path, monkeypatch):
        path = str(tmp_path / "cache.json")
        x = torch.zeros(8, 8)
        a = flops.matmul_flops_cached(self._fn, x, salt="s", cache_path=path)
        assert a == 2 * 8 * 8 * 8
        calls = []
        monkeypatch.setattr(flops, "matmul_flops", lambda *a, **k: calls.append(1) or 0)
        b = flops.matmul_flops_cached(self._fn, x, salt="s", cache_path=path)
        assert b == a and not calls  # served from disk, no recount

    def test_salt_and_shape_invalidate(self, tmp_path):
        import json

        path = str(tmp_path / "cache.json")
        x = torch.zeros(8, 8)
        flops.matmul_flops_cached(self._fn, x, salt="a", cache_path=path)
        n1 = len(json.load(open(path)))
        flops.matmul_flops_cached(self._fn, x, salt="b", cache_path=path)
        flops.matmul_flops_cached(self._fn, torch.zeros(4, 4), salt="a", cache_path=path)
        assert len(json.load(open(path))) == n1 + 2

    def test_no_cache_path_passthrough(self):
        assert flops.matmul_flops_cached(self._fn, torch.zeros(2, 2)) == 16
