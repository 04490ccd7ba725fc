"""Parity of the PyTorch port's four networks with the JAX modules in train
mode (CPU): outputs, the statistics flax's `mutable=['batch_stats']` returns,
and the parameter gradients of a scalar of the output.

Each network runs at its full widths (fixed by the architecture) at batch 2
and word length 2 (images 32 x 32; style images 32 x 160). JAX variables come
from `jax.eval_shape(init)` filled by `convert.fake_fill` (random SN u, BN
statistics, attention sigma != 0).

Tolerances, float32 both sides: outputs and statistics 1e-4 absolute and
relative (sums of up to ~10^4 products through up to twenty layers); gradients
2e-4 relative to the largest gradient of the network, since a gradient that
cancels to ~0 (a conv bias before a batch norm) has no relative precision.
The bf16-trunk discriminator is held at 2e-2, where the frameworks round at
other places."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrabblegan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from scrabblegan_tpu.models.generator import Generator as JaxGenerator
from scrabblegan_tpu.models.generator import StyleEncoder as JaxStyleEncoder
from scrabblegan_tpu.models.recognizer import Recognizer as JaxRecognizer
from scrabblegan_tpu.models.style import StylePromoter as JaxStylePromoter
from scrabblegan_torch.convert import fake_fill, flatten, load_flax, to_flax
from scrabblegan_torch.models.discriminator import Discriminator
from scrabblegan_torch.models.generator import Generator, StyleEncoder
from scrabblegan_torch.models.recognizer import Recognizer, ctc_time_steps
from scrabblegan_torch.models.style import StylePromoter
from scrabblegan_torch.ops.layers import commit_stats, record_stats

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

TOL = 1e-4
GRAD_TOL = 2e-4


def rand(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def jax_train(module, args, kwargs, seed, scalar):
    """Variables, train-mode output, mutated stats and the gradient of
    scalar(output) with respect to the params."""
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, *args,
                                                **kwargs))
    v = fake_fill({p: s.shape for p, s in flatten(shapes).items()}, seed)

    def loss(params):
        out, muts = module.apply({"params": params, "batch_stats": v.get("batch_stats", {})},
                                 *args, mutable=["batch_stats"], **kwargs)
        return scalar(out.astype(jnp.float32)), (out, muts)

    (_, (out, muts)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, v["params"]))
    return v, np.asarray(out.astype(jnp.float32)), muts.get("batch_stats", {}), grads


def port_train(port, args, scalar):
    port.train()
    with record_stats() as record:
        out = port(*args)
    scalar(out.float()).backward()
    grads = to_flax(port, {n: p.grad for n, p in port.named_parameters()})["params"]
    before = flatten(to_flax(port).get("batch_stats", {}))
    assert flatten(to_flax(port).get("batch_stats", {})).keys() == before.keys()
    commit_stats(record)
    return out.detach().float(), flatten(to_flax(port).get("batch_stats", {})), before, grads


def check(jax_out, port_out, jax_stats, port_stats, jax_grads, port_grads,
          tol=TOL, grad_tol=GRAD_TOL, in_norm=False):
    """Elementwise, or with in_norm each gradient leaf in the Frobenius norm
    within grad_tol of max(its norm, 1e-2 x the largest leaf norm)."""
    np.testing.assert_allclose(port_out, jax_out, rtol=tol, atol=tol)
    jax_stats = flatten(jax_stats)
    assert sorted(jax_stats) == sorted(port_stats)
    for path, arr in jax_stats.items():
        np.testing.assert_allclose(port_stats[path], np.asarray(arr), rtol=tol, atol=tol,
                                   err_msg="/".join(path))
    jax_grads = {p: np.asarray(g) for p, g in flatten(jax_grads).items()}
    port_grads = flatten(port_grads)
    assert sorted(jax_grads) == sorted(port_grads)
    scale = max(np.abs(g).max() for g in jax_grads.values())
    norm = max(np.linalg.norm(g) for g in jax_grads.values())
    for path, g in jax_grads.items():
        if in_norm:
            err = np.linalg.norm(port_grads[path] - g)
            assert err <= grad_tol * max(np.linalg.norm(g), 1e-2 * norm), "/".join(path)
        else:
            np.testing.assert_allclose(port_grads[path], g, rtol=grad_tol,
                                       atol=grad_tol * scale, err_msg="/".join(path))


def logit_loss(out):
    return (out * jnp.arange(1, out.shape[0] + 1)).sum() if isinstance(out, jax.Array) else \
        (out * torch.arange(1, out.shape[0] + 1)).sum()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cls,jax_cls", [(Discriminator, JaxDiscriminator),
                                         (StylePromoter, JaxStylePromoter)])
def test_adversaries_match_jax(cls, jax_cls, masked):
    """D and W at len 2; masked: the padded mode's GAP over the true widths."""
    x = rand(1, (2, 32, 32, 1))
    mask = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.float32) if masked else None
    v, out, stats, grads = jax_train(jax_cls(use_pallas_attention=True), (x, True),
                                     {"width_mask": mask}, 2, logit_loss)
    port = load_flax(cls(use_kernel=True), v)
    args = (nchw(x), None if mask is None else torch.from_numpy(mask))
    p_out, p_stats, before, p_grads = port_train(port, args, logit_loss)
    assert any(not np.array_equal(p_stats[k], before[k]) for k in p_stats)
    check(out, p_out.numpy(), stats, p_stats, grads, p_grads)


def image_loss(shape_nhwc):
    w = np.random.default_rng(5).standard_normal(shape_nhwc).astype(np.float32)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(0, 3, 1, 2)))
    return lambda out: (out * w).sum() if isinstance(out, jax.Array) else (out * wt).sum()


def test_recognizer_matches_jax():
    """The conv CRNN at len 2: T = 4L - 1 = 7 frames of 53 classes; bn5 and
    bn6 in train mode; and return_features."""
    x = rand(6, (2, 32, 32, 1))
    w = np.random.default_rng(7).standard_normal((2, 7, 53)).astype(np.float32)
    loss = lambda out: (out * (w if isinstance(out, jax.Array) else torch.from_numpy(w))).sum()  # noqa: E731
    v, out, stats, grads = jax_train(JaxRecognizer(num_classes=53), (x, True), {}, 8, loss)
    port = load_flax(Recognizer(53), v)
    p_out, p_stats, before, p_grads = port_train(port, (nchw(x),), loss)
    assert p_out.shape == (2, ctc_time_steps(32), 53)
    check(out, p_out.numpy(), stats, p_stats, grads, p_grads)
    # eval mode reads the running statistics both sides committed
    feats = JaxRecognizer(num_classes=53).apply({"params": v["params"], "batch_stats": stats},
                                                x, False, return_features=True)
    with torch.no_grad():
        got = port.eval()(nchw(x), return_features=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(feats), rtol=TOL, atol=TOL)


def test_style_encoder_matches_jax():
    """Style images (32 x 160) -> z (2, 128); attention on the plain core."""
    x = rand(9, (2, 32, 160, 1))
    w = np.random.default_rng(10).standard_normal((2, 128)).astype(np.float32)
    loss = lambda out: (out * (w if isinstance(out, jax.Array) else torch.from_numpy(w))).sum()  # noqa: E731
    v, out, stats, grads = jax_train(JaxStyleEncoder(), (x, True), {}, 11, loss)
    port = load_flax(StyleEncoder(), v)
    assert not port.attn.use_kernel
    p_out, p_stats, _, p_grads = port_train(port, (nchw(x),), loss)
    check(out, p_out.numpy(), stats, p_stats, grads, p_grads)


def test_generator_style_source_matches_jax():
    """G with z_source='style' in train mode, len 2: outputs and statistics
    at 1e-4; gradients in the norm at 5e-2, because JAX's own float32
    gradients of G differ from its float64 ones by up to 1.5% of a leaf's
    largest entry at this state (tests/test_torch_step_parity.py)."""
    labels = np.random.default_rng(0).integers(0, 52, (2, 2)).astype(np.int32)
    style = rand(3, (2, 32, 160, 1))
    loss = image_loss((2, 32, 32, 1))
    v, out, stats, grads = jax_train(
        JaxGenerator(vocab_size=52, z_source="style", use_pallas_attention=True),
        (labels,), {"style_imgs": style, "train": True}, 4, loss)
    port = load_flax(Generator(52, z_source="style"), v)
    p_out, p_stats, _, p_grads = port_train(
        port, (torch.from_numpy(labels).long(), None, None, nchw(style)),
        loss)
    check(out, p_out.permute(0, 2, 3, 1).numpy(), stats, p_stats, grads, p_grads,
          grad_tol=5e-2, in_norm=True)
