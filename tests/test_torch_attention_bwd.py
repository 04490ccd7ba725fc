"""The attention backward of the PyTorch port against the JAX package (CPU):
the plain backward `attention_backward_reference` and the CUDA kernel's
two-launch algorithm emulated in torch (`attention_bwd_emulation`), held to
`_xla_backward` and to the Pallas backward kernel run by the Pallas
interpreter; the autograd Function `AttentionCore` with the emulations in
place of its launchers, held to autograd through `attention_reference`; and
the CUDA dispatch, which must return the Function's output with a grad_fn.

The CUDA kernel itself cannot run here; chip_smoke.py holds it to the plain
backward on the card. Tolerances: 2e-4 in float32, the JAX backward tests'
(tests/test_kernels.py), and 2e-2 in bfloat16 (the grads are stored in
bfloat16: one ulp at |g| ~ 4 is 1.6e-2); against the interpreted Pallas
kernel, whose float32 scores are split into three bfloat16 products, 1e-3 in
float32 (5.3e-4 measured at (5120, 1280))."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrabblegan_tpu.kernels.attention import _pallas_backward, _xla_backward
from scrabblegan_torch.kernels import attention

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

TOLS = {"float32": 2e-4, "bfloat16": 2e-2}
PALLAS_F32_TOL = 1e-3
SHAPES = [(512, 128),    # G's B3 at len 1
          (640, 160),    # D's and W's B1 at len 5
          (5120, 1280),  # G's B3 at len 10: ten key tiles, forty query tiles
          (300, 75)]     # ragged: neither Q nor K a multiple of the 128-row tile


def operands(seed, b, q, k, dtype):
    """(jax arrays, torch tensors) rounded to `dtype` once, so both sides
    see the same inputs; the fourth is the output cotangent doutT."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, c, n)).astype(np.float32)
            for c, n in ((8, q), (8, k), (32, k), (32, q))]
    jax_ops = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    torch_ops = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
                 for a in jax_ops]
    return jax_ops, torch_ops


def assert_grads_close(got, want, tol):
    for g, w in zip(got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g, np.float32)
        np.testing.assert_allclose(g, np.asarray(w.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q,k", SHAPES)
def test_plain_backward_and_emulation_match_jax(q, k, dtype):
    jax_ops, torch_ops = operands(q + k, 2, q, k, dtype)
    tol = TOLS[dtype]
    want = _xla_backward(*jax_ops)
    plain = attention.attention_backward_reference(*torch_ops)
    emulated = attention.attention_bwd_emulation(*torch_ops)
    for got in (plain, emulated):
        assert [t.dtype for t in got] == [torch_ops[0].dtype] * 3
        assert [t.shape for t in got] == [t.shape for t in torch_ops[:3]]
        assert_grads_close(got, want, tol)
    # the Pallas kernel body, interpreted: its f32 scores are a bf16x3 split
    # (_scores_dot), up to 5.3e-4 off here at (5120, 1280) with dout ~ N(0, 1)
    assert_grads_close(emulated, _pallas_backward(*jax_ops, interpret=True),
                       max(tol, PALLAS_F32_TOL))


def test_emulation_uses_the_kernels_tile():
    src = (Path(attention.__file__).parents[1] / "csrc" / "attention_bwd.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))  # noqa: E731
    assert re.search(r"constexpr int kTile = kThreads;", src)
    assert const("kThreads") == attention.BWD_TILE
    assert (const("kCa"), const("kCg")) == (attention.KERNEL_CA, attention.KERNEL_CG)


@pytest.fixture
def emulated_launchers(monkeypatch):
    """The CPU emulations in place of the CUDA launchers; returns the calls."""
    calls = []

    def fwd(*ops):
        calls.append("fwd")
        return attention.attention_tiled_emulation(*ops)

    def bwd(*ops):
        calls.append("bwd")
        return attention.attention_bwd_emulation(*ops)

    monkeypatch.setattr(attention, "_launch_kernel", fwd)
    monkeypatch.setattr(attention, "_launch_backward", bwd)
    return calls


@pytest.mark.parametrize("q,k", [(640, 160), (300, 75)])
def test_autograd_function_matches_autograd_of_the_plain_core(emulated_launchers, q, k):
    _, (th, ph, g, d) = operands(7, 2, q, k, "float32")
    xs = [t.clone().requires_grad_() for t in (th, ph, g)]
    out = attention.AttentionCore.apply(*xs)
    out.backward(d)
    ys = [t.clone().requires_grad_() for t in (th, ph, g)]
    ref = attention.attention_reference(*ys)
    ref.backward(d)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    for x, y in zip(xs, ys):
        torch.testing.assert_close(x.grad, y.grad, rtol=2e-4, atol=2e-4)
    assert emulated_launchers == ["fwd", "bwd"]


class OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the dispatch takes its
    CUDA branch; every torch operation on it sees the plain CPU tensor."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_dispatch_carries_gradients(emulated_launchers):
    """Repair: the kernel path used to return a tensor without a grad_fn, so
    a NonLocalBlock on a card passed no gradient to theta, phi and g."""
    _, (th, ph, g, d) = operands(8, 1, 128, 32, "float32")
    xs = [t.clone().as_subclass(OnCard).requires_grad_() for t in (th, ph, g)]
    assert xs[0].device.type == "cuda"
    out = attention.nonlocal_attention_packed(*xs)
    assert out.grad_fn is not None and "AttentionCore" in type(out.grad_fn).__name__
    out.backward(d)
    assert all(x.grad is not None and x.grad.abs().max() > 0 for x in xs)
    assert emulated_launchers == ["fwd", "bwd"]


def test_backward_wrapper_checks_before_launching():
    _, (th, ph, g, d) = operands(9, 1, 128, 32, "float32")
    before = attention.bwd_launches
    with pytest.raises(ValueError, match="doutT"):
        attention._launch_backward(th, ph, g, d[:, :, :64])
    with pytest.raises(ValueError, match="Ca=8"):
        attention._launch_backward(th.repeat(1, 2, 1), ph.repeat(1, 2, 1), g, d)
    assert attention.bwd_launches == before
