"""The DCGAN discriminator (`shared.my_disc`) of the port against the JAX
module in train mode on the CPU: logits, the spectral-norm statistics flax
returns, and the parameter gradients of a scalar of the logits, at word
lengths 1 and 3 and at the padded 32 x 160 canvas with a width mask, with a
float32 and a bfloat16 trunk; and the stride-2 'SAME' conv it is built from.

Tolerances: float32 as tests/test_torch_models.py (outputs and statistics
1e-4, gradients 2e-4 of the network's largest); the bfloat16 trunk holds
outputs and statistics at 2e-2 and the gradients at 1e-1 in each leaf's
norm, because the frameworks round bfloat16 at other places (the largest
leaf error measured was 5.3%, in the attention's g kernel at length 1; a
wrong mapping is off by the leaf's whole norm).
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_models as tm
from scrabblegan_tpu.models.discriminator import DCGANDiscriminator as JaxDCGAN
from scrabblegan_tpu.ops.layers import SNConv as JaxSNConv
from scrabblegan_torch.convert import fake_fill, flatten, load_flax
from scrabblegan_torch.models.discriminator import DCGANDiscriminator
from scrabblegan_torch.ops.layers import SNConv, same_padding

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jax.numpy.float32), "bfloat16": (torch.bfloat16,
                                                                      jax.numpy.bfloat16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [16, 48, "padded"])
def test_dcgan_discriminator_matches_jax(width, dtype):
    """Widths 16 and 48 (lengths 1 and 3) and the padded canvas 160, whose
    width mask both sides take and ignore."""
    padded = width == "padded"
    w = 160 if padded else width
    x = tm.rand(21, (2, 32, w, 1))
    mask = np.array([[1] * 20, [1] * 6 + [0] * 14], np.float32) if padded else None
    torch_dt, jax_dt = DTYPES[dtype]
    v, out, stats, grads = tm.jax_train(JaxDCGAN(dtype=jax_dt), (x, True),
                                        {"width_mask": mask}, 22, tm.logit_loss)
    port = load_flax(DCGANDiscriminator(dtype=torch_dt), v)
    assert not port.attn_B1.use_kernel  # JAX builds it without use_pallas
    args = (tm.nchw(x), None if mask is None else torch.from_numpy(mask))
    p_out, p_stats, before, p_grads = tm.port_train(port, args, tm.logit_loss)
    assert p_out.shape == (2,)
    assert any(not np.array_equal(p_stats[k], before[k]) for k in p_stats)
    if dtype == "float32":
        tm.check(out, p_out.numpy(), stats, p_stats, grads, p_grads)
    else:
        tm.check(out, p_out.numpy(), stats, p_stats, grads, p_grads, tol=2e-2,
                 grad_tol=1e-1, in_norm=True)
    if padded:  # the mask changes nothing
        with torch.no_grad():
            torch.testing.assert_close(port(args[0], args[1]), port(args[0]), rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(32, 16), (16, 8), (8, 4), (4, 2), (7, 5)])
def test_strided_same_conv_matches_jax_padding(hw):
    """lax's 'SAME' at stride 2 pads (0, 1) on every even size the DCGAN D
    meets (32 -> 16 -> 8 -> 4 and 16L -> ... -> 2L), and (1, 1) on odd ones;
    the port pads the same, where `F.conv2d(stride=2, padding=1)` takes
    other pixels."""
    h, w = hw
    x = tm.rand(23, (2, h, w, 3))
    conv = JaxSNConv(5, (3, 3), strides=(2, 2))
    shapes = jax.eval_shape(lambda: conv.init(jax.random.PRNGKey(0), x, False))
    v = fake_fill({p: s.shape for p, s in flatten(shapes).items()}, 24)
    want = np.asarray(conv.apply(v, x, False)).transpose(0, 3, 1, 2)
    port = load_flax(SNConv(3, 5, (3, 3), strides=(2, 2)).eval(), v)
    with torch.no_grad():
        got = port(tm.nchw(x))
        torch_pad1 = F.conv2d(tm.nchw(x), port.normalized_weight(), port.bias, stride=2,
                              padding=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert same_padding(h, 3, 2) == ((0, 1) if h % 2 == 0 else (1, 1))
    if h % 2 == 0:  # the case padding=1 fails
        assert torch_pad1.shape == got.shape
        assert (torch_pad1 - got).abs().max() > 1e-2
