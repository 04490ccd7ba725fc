"""Train mode of the PyTorch port's layers and blocks against flax (CPU):
spectral norm's new u and sigma and its weight gradient (u and v held
constant, as flax's `stop_gradient` holds them), batch norm and conditional
batch norm with batch statistics and the running update flax's
`mutable=['batch_stats']` returns, and ResNetBlockDown; each with the
parameter gradients of a fixed weighting of its output.

Inputs and weights are numpy-seeded (weights from `jax.eval_shape(init)`
filled by `convert.fake_fill`); activations are NHWC in JAX and NCHW in the
port. Tolerance 1e-5 (float32 both sides, small sums), on gradients 1e-5
relative to the largest gradient of the module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrabblegan_tpu.ops import attention as jattention
from scrabblegan_tpu.ops import blocks as jblocks
from scrabblegan_tpu.ops import layers as jlayers
from scrabblegan_torch.convert import fake_fill, flatten, load_flax, to_flax
from scrabblegan_torch.ops import attention, blocks, layers
from scrabblegan_torch.ops.layers import commit_stats, record_stats

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

TOL = 1e-5


def rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def run_pair(jm, port, args, port_args, seed=0, **kwargs):
    """Train-mode forward and gradient of sum(out * w) on both sides;
    returns (jax out, port out NHWC, jax new stats, port new stats, jax grads,
    port grads, port stats before), all flat numpy."""
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, *args,
                                            **kwargs))
    v = fake_fill({p: s.shape for p, s in flatten(shapes).items()}, seed)
    load_flax(port, v).train()

    def jloss(params):
        out, muts = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, *args,
                             mutable=["batch_stats"], **kwargs)
        return (out * wj(out.shape)).sum(), (out, muts["batch_stats"])

    def wj(shape):
        return np.random.default_rng(99).standard_normal(shape).astype(np.float32)

    (_, (jout, jstats)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, v["params"]))
    before = flatten(to_flax(port)["batch_stats"])
    with record_stats() as record:
        out = port(*port_args)
    out_nhwc = out.permute(0, 2, 3, 1) if out.dim() == 4 else out
    (out_nhwc * torch.from_numpy(wj(tuple(out_nhwc.shape)))).sum().backward()
    # the forward wrote nothing: the buffers still hold the start values
    np.testing.assert_equal(flatten(to_flax(port)["batch_stats"]), before)
    commit_stats(record)
    pgrads = to_flax(port, {n: p.grad for n, p in port.named_parameters()})["params"]
    return (np.asarray(jout), out_nhwc.detach().numpy(), flatten(jstats),
            flatten(to_flax(port)["batch_stats"]), flatten(jgrads), flatten(pgrads), before)


def check(res, tol=TOL):
    jout, pout, jstats, pstats, jgrads, pgrads, before = res
    np.testing.assert_allclose(pout, jout, rtol=tol, atol=tol)
    assert sorted(jstats) == sorted(pstats)
    for path, arr in jstats.items():
        np.testing.assert_allclose(pstats[path], np.asarray(arr), rtol=tol, atol=tol,
                                   err_msg="/".join(path))
        assert not np.array_equal(np.asarray(arr), before[path]) or path[-1].endswith("sigma")
    scale = max(np.abs(np.asarray(g)).max() for g in jgrads.values())
    for path, g in jgrads.items():
        np.testing.assert_allclose(pgrads[path], np.asarray(g), rtol=tol, atol=tol * scale,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("kind", ["conv3", "conv1_nobias", "dense", "transpose"])
def test_spectral_norm_train_mode(kind):
    """New u and sigma = one power iteration from the stored u; the weight
    gradient has u and v stopped. The stored sigma is 1 before the step."""
    if kind == "dense":
        x = rand(1, (4, 32))
        jm, port, px = jlayers.SNDense(24), layers.SNDense(32, 24), torch.from_numpy(x)
    elif kind == "transpose":
        x = rand(2, (2, 4, 6, 16))
        jm, port, px = jlayers.SNConvTranspose(8), layers.SNConvTranspose(16, 8), nchw(x)
    else:
        x = rand(3, (2, 6, 10, 16))
        k, bias = ((3, 3), True) if kind == "conv3" else ((1, 1), False)
        jm = jlayers.SNConv(12, k, use_bias=bias)
        port, px = layers.SNConv(16, 12, k, use_bias=bias), nchw(x)
    check(run_pair(jm, port, (x,), (px,), train=True))


def test_spectral_norm_gradient_stops_u_and_v():
    """Repair: autograd must not flow through the power iteration. Compare
    with the gradient when u and v are differentiated, which flax rules out."""
    x = rand(4, (4, 32))
    jm = jlayers.SNDense(24)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, x))
    v = fake_fill({p: s.shape for p, s in flatten(shapes).items()}, 5)
    port = load_flax(layers.SNDense(32, 24), v).train()
    port(torch.from_numpy(x)).square().sum().backward()
    got = port.weight.grad.clone()
    ref = jax.grad(lambda p: jm.apply({"params": p, "batch_stats": v["batch_stats"]}, x,
                                      mutable=["batch_stats"])[0].__pow__(2).sum())(
        jax.tree.map(jnp.asarray, v["params"]))
    want = np.asarray(ref["Dense_0"]["kernel"]).T
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())

    w = port.weight.detach().clone().requires_grad_()  # u and v differentiated instead
    u = port.u.float()
    vv = layers.l2_normalize(u @ w)
    uu = layers.l2_normalize(vv @ w.T)
    sigma = ((vv @ w.T) @ uu.T)[0, 0]
    (torch.from_numpy(x) @ (w / sigma).T).square().sum().backward()
    assert (w.grad - got).abs().max() > 1e-3 * got.abs().max()


@pytest.mark.parametrize("scale_bias", [True, False])
def test_batch_norm_train_mode(scale_bias):
    """flax BatchNorm with batch statistics, fast variance and the running
    update with the biased variance (torch's would use the unbiased one)."""
    x = rand(6, (3, 5, 7, 16)) * 2 + 0.5
    if scale_bias:
        import flax.linen as nn

        jm, port = nn.BatchNorm(use_running_average=False), blocks.BatchNorm(16)
        res = run_pair(jm, port, (x,), (nchw(x),))
    else:
        cond = rand(7, (3, 32))
        jm, port = jblocks.ConditionalBatchNorm(), blocks.ConditionalBatchNorm(16, 32)
        res = run_pair(jm, port, (x, cond), (nchw(x), torch.from_numpy(cond)), train=True)
    check(res)
    var = x.reshape(-1, 16).var(axis=0)  # biased
    path = ("var",) if scale_bias else ("BatchNorm_0", "var")
    np.testing.assert_allclose(res[3][path], 0.99 * res[6][path] + 0.01 * var, rtol=1e-5)


@pytest.mark.parametrize("is_last", [False, True])
def test_resnet_block_down(is_last):
    x = rand(8, (2, 8, 12, 16))
    jm = jblocks.ResNetBlockDown(24, is_last_block=is_last)
    res = run_pair(jm, blocks.ResNetBlockDown(16, 24, is_last_block=is_last), (x,),
                   (nchw(x),), train=True)
    assert res[1].shape == ((2, 8, 12, 24) if is_last else (2, 4, 6, 24))
    check(res)


def test_resnet_block_down_rejects_odd_widths():
    with pytest.raises(ValueError, match="even"):
        blocks.ResNetBlockDown(4, 8)(torch.zeros(1, 4, 8, 7))
    assert blocks.ResNetBlockDown(4, 8, is_last_block=True)(torch.zeros(1, 4, 8, 7)).shape \
        == (1, 8, 8, 7)


@pytest.mark.parametrize("is_last", [False, True])
def test_resnet_block_up_train_mode(is_last):
    x, cond = rand(9, (2, 4, 6, 16)), rand(10, (2, 32))
    jm = jblocks.ResNetBlockUp(8, is_last_block=is_last)
    res = run_pair(jm, blocks.ResNetBlockUp(16, 8, 32, is_last_block=is_last), (x, cond),
                   (nchw(x), torch.from_numpy(cond)), train=True)
    check(res)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_nonlocal_block_train_mode(use_pallas):
    """G's B3 widths (C = 64), sigma != 0 (fake_fill draws it in [0.5, 1]);
    gradients reach theta, phi and g through the plain core."""
    x = rand(11, (2, 8, 24, 64))
    jm = jattention.NonLocalBlock(use_pallas=use_pallas)
    res = run_pair(jm, attention.NonLocalBlock(64, use_kernel=use_pallas), (x,), (nchw(x),),
                   train=True)
    check(res)
    assert np.abs(res[4][("theta", "Conv_0", "kernel")]).max() > 0
