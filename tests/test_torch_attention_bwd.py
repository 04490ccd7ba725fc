"""The attention backward of the PyTorch port against the JAX package (CPU):
the plain backward `attention_backward_reference` and the CUDA kernels'
algorithm emulated in torch (`attention_bwd_emulation`: the statistics, the
gradients with keys as rows and their partial sums in the order the
reduction kernel adds them, every product a sum of bfloat16 products as the
tensor cores form it), held to `_xla_backward` and to the Pallas backward
kernel run by the Pallas interpreter; the plan that cuts a call into
blocks; the autograd Function `AttentionCore` with the emulations in place
of its launchers, held to autograd through `attention_reference`; and the
CUDA dispatch, which must return the Function's output with a grad_fn.

The CUDA kernels themselves cannot run here; chip_smoke.py holds them to the
plain backward on the card. Tolerances: 2e-4 in float32, the JAX backward
tests' (tests/test_kernels.py), and 2e-2 in bfloat16 (the grads are stored
in bfloat16: one ulp at |g| ~ 4 is 1.6e-2); against the interpreted Pallas
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
SHAPES = [(2, 512, 128),    # G's B3 at len 1
          (2, 640, 160),    # D's and W's B1 at len 5: 2.5 blocks of keys, 5 query splits
          (2, 5120, 1280),  # G's B3 at len 10: twenty key tiles, forty query tiles in 20 splits
          (2, 300, 75),     # ragged: neither Q nor K a multiple of a tile
          (2, 640, 75),     # K not a multiple of 8: staged element by element on the card
          (2, 128, 129),    # K one past a key tile of the statistics kernel
          (2, 72, 40),      # Q not a multiple of the warp's 16 rows
          (1, 640, 160),    # batch 1
          (8, 256, 96)]     # 1.5 blocks of keys, the last with two idle warps


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
@pytest.mark.parametrize("b,q,k", SHAPES)
def test_plain_backward_and_emulation_match_jax(b, q, k, dtype):
    jax_ops, torch_ops = operands(q + k, b, q, k, dtype)
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


def test_emulation_uses_the_kernels_constants():
    """The tile sizes, the plan's targets and the numbers of bfloat16 parts,
    read from the CUDA sources, are the emulation's and the plan's."""
    csrc = Path(attention.__file__).parents[1] / "csrc"
    bwd, mma = (csrc / "attention_bwd.cu").read_text(), (csrc / "attention_mma.cuh").read_text()
    const = lambda src, name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))  # noqa: E731
    assert (const(mma, "kCa"), const(mma, "kCg")) == (attention.KERNEL_CA, attention.KERNEL_CG)
    assert (const(mma, "kKt"), const(mma, "kKs")) == (attention.KEY_TILE, attention.KEY_CHUNK)
    assert re.search(r"constexpr int kWarps = kThreads / 32;", bwd)
    assert const(mma, "kThreads") // 32 == attention.BWD_WARPS
    assert const(bwd, "kRows") == attention.BWD_WARP_ROWS
    assert re.search(r"constexpr int kKeys = kWarps \* kRows;", bwd)
    assert attention.BWD_KEYS == attention.BWD_WARPS * attention.BWD_WARP_ROWS
    assert re.search(r"constexpr int kQt = kKt;", bwd)
    assert attention.BWD_QUERY_TILE == attention.KEY_TILE
    assert const(bwd, "kStatsBlocksPerSm") == attention.BWD_STATS_BLOCKS_PER_SM
    assert const(bwd, "kGradsBlocksPerSm") == attention.BWD_GRADS_BLOCKS_PER_SM
    parts = {name: tuple(map(int, re.search(
        rf"struct Parts<{name}> {{ static constexpr int kParts = (\d), kRegParts = (\d); }};",
        bwd).groups())) for name in ("float", "bf16")}
    assert parts == {"float": (attention.BWD_PARTS[torch.float32],
                               attention.BWD_REG_PARTS[torch.float32]),
                     "bf16": (attention.BWD_PARTS[torch.bfloat16],
                              attention.BWD_REG_PARTS[torch.bfloat16])}
    assert float(re.search(r"constexpr float kSlack = ([\d.]+)f;", mma).group(1)) == attention.MAX_SLACK


@pytest.mark.parametrize("b,q,k,want", [
    # the train step at batch 16: both kernels get a block for every SM and more
    (16, 640, 160, dict(query_warps=2, key_tiles=3, tiles_per_split=1, query_splits=5)),
    (16, 2560, 640, dict(query_warps=4, key_tiles=10, tiles_per_split=3, query_splits=7)),
    (16, 128, 32, dict(query_warps=1, key_tiles=1, tiles_per_split=1, query_splits=1)),
    # a large batch fills the card without a split
    (1024, 2560, 640, dict(query_warps=4, key_tiles=10, tiles_per_split=20, query_splits=1)),
    (2, 300, 75, dict(query_warps=1, key_tiles=2, tiles_per_split=1, query_splits=3)),
])
def test_backward_plan_fills_the_card(b, q, k, want):
    plan = attention.backward_plan(b, q, k, sms=132)
    assert plan == want
    query_tiles = -(-q // attention.BWD_QUERY_TILE)
    assert (plan["query_splits"] - 1) * plan["tiles_per_split"] < query_tiles \
        <= plan["query_splits"] * plan["tiles_per_split"]  # every split has a tile, every tile a split
    rows = attention.BWD_WARP_ROWS
    stats_blocks = b * -(-q // (rows * plan["query_warps"]))
    grads_blocks = b * plan["key_tiles"] * plan["query_splits"]
    if b * q >= 132 * rows:  # the shape has the rows for a block an SM
        assert stats_blocks >= 132
    if b * k >= 132 * rows:
        assert grads_blocks >= 132


@pytest.mark.parametrize("sms", [1, 132, 100000])
def test_emulation_does_not_depend_on_the_split(sms):
    """The plan changes the order of the sums, not what is summed: one block
    for all (1 SM), the H100's plan, and every tile a split of its own agree
    far inside the tolerance."""
    _, torch_ops = operands(3, 2, 640, 160, "float32")
    want = attention.attention_backward_reference(*torch_ops)
    got = attention.attention_bwd_emulation(*torch_ops, sms=sms)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=5e-5, atol=5e-5)


def test_bfloat16_needs_two_parts_of_the_probabilities(monkeypatch):
    """Why the kernel splits A and dS in two for bfloat16 operands: rounded
    once, dtheta and dphi leave the 2e-2 tolerance; in two parts they stay
    four times inside it."""
    _, torch_ops = operands(5, 16, 640, 160, "bfloat16")
    want = attention.attention_backward_reference(*torch_ops)

    def worst(got):
        return max(((g.float() - w.float()).abs() / (1 + w.float().abs())).max().item()
                   for g, w in zip(got, want))

    assert worst(attention.attention_bwd_emulation(*torch_ops)) < 1e-2
    monkeypatch.setitem(attention.BWD_REG_PARTS, torch.bfloat16, 1)
    assert worst(attention.attention_bwd_emulation(*torch_ops)) > 2e-2


@pytest.fixture
def emulated_launchers(monkeypatch):
    """The CPU emulations in place of the CUDA kernels' ops; returns the calls."""
    calls = []

    def fwd(*ops):
        calls.append("fwd")
        return attention.attention_tiled_emulation(*ops)

    def bwd(*ops):
        calls.append("bwd")
        return attention.attention_bwd_emulation(*ops)

    monkeypatch.setattr(attention, "attention_fwd", fwd)
    monkeypatch.setattr(attention, "attention_bwd", bwd)
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


@pytest.mark.parametrize("ca,cg", [(12, 48), (24, 96)])
@pytest.mark.parametrize("b,q,k", [(2, 512, 128), (2, 300, 75), (3, 128, 129)])
def test_emulation_at_biggan_widths_matches_the_plain_backward(ca, cg, b, q, k):
    """The backward kernels' emulation at BigGAN's widths (three k16 steps of
    dA at Cg = 48, dtheta and dphi over the padded k8 steps at Ca = 12)
    against the plain backward, in bfloat16 at its 2e-2 tolerance."""
    gen = torch.Generator().manual_seed(q + ca)
    ops = [torch.randn(b, c, n, generator=gen).bfloat16()
           for c, n in ((ca, q), (ca, k), (cg, k), (cg, q))]
    got = attention.attention_bwd_emulation(*ops)
    want = attention.attention_backward_reference(*ops)
    for g, w, op in zip(got, want, ops[:3]):
        assert g.shape == w.shape == op.shape and g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), rtol=2e-2, atol=2e-2)
