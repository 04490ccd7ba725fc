"""Parity of the PyTorch port's layers and blocks with the JAX package (CPU).

The same numpy-seeded inputs and weights go through each flax module in eval
mode and through its port in eval mode (train mode: test_torch_train_layers.py). Weights come from `jax.eval_shape(init)` filled by
`scrabblegan_torch.convert.fake_fill` (random spectral-norm u, non-trivial BN
statistics), so a wrong conversion or a stored-sigma shortcut shows.
Activations are NHWC on the JAX side and NCHW in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrabblegan_tpu.ops import blocks as jblocks
from scrabblegan_tpu.ops import embedding as jembedding
from scrabblegan_tpu.ops import layers as jlayers
from scrabblegan_torch.convert import fake_fill, flatten, load_flax
from scrabblegan_torch.ops import blocks, embedding, layers

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

TOL = 1e-5  # float32 both sides; sums of at most a few thousand products


def flax_variables(module, *args, seed=0, method=None, **kwargs):
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, *args, method=method, **kwargs))
    return fake_fill({p: s.shape for p, s in flatten(shapes).items()}, seed)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kernel,use_bias,use_sn", [
    ((3, 3), True, True), ((1, 1), False, True), ((3, 3), True, False)])
def test_snconv(kernel, use_bias, use_sn):
    x = rand(1, (2, 6, 10, 16))
    jm = jlayers.SNConv(12, kernel, use_bias=use_bias, use_sn=use_sn)
    v = flax_variables(jm, x, train=False)
    ref = np.asarray(jm.apply(v, x, train=False))
    port = load_flax(layers.SNConv(16, 12, kernel, use_bias=use_bias, use_sn=use_sn), v)
    np.testing.assert_allclose(nhwc(port(nchw(x))), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kernel", [(3, 3), (1, 1)])
@pytest.mark.parametrize("strides", [(2, 2), (2, 1)])
@pytest.mark.parametrize("lowering", ["dilated", "subpixel"])
def test_snconv_transpose(kernel, strides, lowering):
    """flax 'SAME' transposed conv: output exactly input * stride, in phase."""
    x = rand(2, (2, 4, 6, 16))
    jm = jlayers.SNConvTranspose(8, kernel, strides=strides, lowering=lowering)
    v = flax_variables(jm, x, train=False)
    ref = np.asarray(jm.apply(v, x, train=False))
    port = load_flax(layers.SNConvTranspose(16, 8, kernel, strides, lowering=lowering), v)
    got = nhwc(port(nchw(x)))
    assert got.shape == (2, 4 * strides[0], 6 * strides[1], 8)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_sndense_uses_power_iteration_sigma():
    x = rand(3, (4, 32))
    jm = jlayers.SNDense(24)
    v = flax_variables(jm, x, train=False)
    # the stored sigma leaf must not be read: make it absurd
    stats = v["batch_stats"]["SpectralNorm_0"]
    stats["Dense_0/kernel/sigma"] = np.float32(1e6)
    ref = np.asarray(jm.apply(v, x, train=False))
    port = load_flax(layers.SNDense(32, 24), v)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), ref,
                               rtol=TOL, atol=TOL)


def test_conditional_batch_norm():
    x, cond = rand(4, (2, 4, 6, 16)), rand(5, (2, 32))
    jm = jblocks.ConditionalBatchNorm()
    v = flax_variables(jm, x, cond, train=False)
    ref = np.asarray(jm.apply(v, x, cond, train=False))
    port = load_flax(blocks.ConditionalBatchNorm(16, 32), v).eval()
    got = nhwc(port(nchw(x), torch.from_numpy(cond)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("is_last", [False, True])
def test_resnet_block_up(is_last):
    x, cond = rand(6, (2, 4, 6, 16)), rand(7, (2, 32))
    jm = jblocks.ResNetBlockUp(8, is_last_block=is_last)
    v = flax_variables(jm, x, cond, train=False)
    ref = np.asarray(jm.apply(v, x, cond, train=False))
    port = load_flax(blocks.ResNetBlockUp(16, 8, 32, is_last_block=is_last), v).eval()
    got = nhwc(port(nchw(x), torch.from_numpy(cond)))
    assert got.shape == (2, 8, 6 if is_last else 12, 8)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 2e-2)])
def test_filter_bank_contract(dtype, tol):
    """One-hot matrix product; an id past the bank gives a zero row in both."""
    ids = np.array([[0, 3, 6], [2, 7, 1]], np.int32)  # 7 is outside a 7-row bank
    z0 = rand(8, (2, 32))
    jm = jembedding.FilterBank(7, (32, 64), dtype=getattr(jnp, dtype))
    v = flax_variables(jm, ids, z0, method=jembedding.FilterBank.contract)
    ref = np.asarray(jm.apply(v, ids, z0, method=jembedding.FilterBank.contract), np.float32)
    port = load_flax(embedding.FilterBank(7, (32, 64), getattr(torch, dtype)), v)
    got = port.contract(torch.from_numpy(ids), torch.from_numpy(z0)).detach().float().numpy()
    assert not got[1, 1].any()
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
