"""The style extractor of the port against the JAX `StyleExtractor` on the
CPU: the BigGAN down trunk on the plain attention path and an SN-Dense(128),
on style images (32 x 160) at batch 2, in train mode (the embedding, the
spectral-norm statistics, the parameter gradients of a scalar of it) and in
eval mode; and its flax leaves, which `fake_flax_variables`-style trees fill.

Tolerances as tests/test_torch_models.py: float32 outputs and statistics
1e-4, gradients 2e-4 of the network's largest."""

import jax
import numpy as np
import torch

import test_torch_models as tm
from scrabblegan_tpu.models.style import StyleExtractor as JaxStyleExtractor
from scrabblegan_torch.convert import flatten, flax_shapes, load_flax
from scrabblegan_torch.models.style import StyleExtractor

torch.set_num_threads(1)


def test_style_extractor_matches_jax():
    x = tm.rand(41, (2, 32, 160, 1))
    w = np.random.default_rng(42).standard_normal((2, 128)).astype(np.float32)
    loss = lambda out: (out * (w if isinstance(out, jax.Array) else torch.from_numpy(w))).sum()  # noqa: E731
    module = JaxStyleExtractor()
    v, out, stats, grads = tm.jax_train(module, (x, True), {}, 43, loss)
    port = StyleExtractor()
    assert flax_shapes(port) == {p: np.shape(a) for p, a in flatten(v).items()}
    load_flax(port, v)
    assert not port.trunk.attn_B1.use_kernel  # JAX builds it without use_pallas
    p_out, p_stats, before, p_grads = tm.port_train(port, (tm.nchw(x),), loss)
    assert p_out.shape == (2, 128) and p_out.dtype == torch.float32
    assert any(not np.array_equal(p_stats[k], before[k]) for k in p_stats)
    tm.check(out, p_out.numpy(), stats, p_stats, grads, p_grads)
    want = module.apply({"params": v["params"], "batch_stats": stats}, x, False)
    with torch.no_grad():
        got = port.eval()(tm.nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tm.TOL, atol=tm.TOL)
