"""The whole non-local block of the PyTorch port ('packed' and 'fused'
attention dataflows) against the JAX package (CPU).

- `fused_block_emulation`, the CUDA kernel's algorithm in torch, against the
  Pallas kernel `_fused_block_forward` run by the Pallas interpreter, at
  5e-4 in float32 and 1e-1 in bfloat16, the JAX kernel test's tolerances
  (tests/test_kernels.py): log2(e) is folded into the bf16 theta weight, and
  JAX's bf16 kernel takes its softmax sum from bf16-rounded weights;
- `fused_block_reference` against `_fused_block_reference` (float32, 1e-5);
- the gradients of `fused_nonlocal_block` in all six arguments against
  `jax.grad` of JAX's (2e-4 relative, 2e-5 absolute, as the JAX test);
- `NonLocalBlock` under each dataflow against JAX's block under the same one,
  selected by $SCRABBLEGAN_ATTN_DATAFLOW: output, the SN statistics proposed
  in train mode and the gradients, in float32 (1e-4) and bfloat16 (2e-2);
- the autograd Function `FusedBlock` with the emulation in place of its
  launcher, against autograd through the plain composition;
- one train step under 'fused' against one under 'nhwc1' on the port.

JAX's x_flat is (B, N, C); the port's x is (B, C, N), the NCHW activation
viewed flat, so the tests swap those two axes at the boundary. The CUDA
kernel itself cannot run here; chip_smoke.py holds it to the plain version
on the card."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrabblegan_tpu.kernels.attention import _fused_block_forward, _fused_block_reference
from scrabblegan_tpu.kernels.attention import fused_nonlocal_block as jax_fused_nonlocal_block
from scrabblegan_tpu.ops.attention import NonLocalBlock as JaxNonLocalBlock
from scrabblegan_torch.config import load_config
from scrabblegan_torch.convert import (fake_fill, fake_flax_variables, flatten, load_flax,
                                       state_from_flax, to_flax)
from scrabblegan_torch.data.synthetic import synthetic_batch
from scrabblegan_torch.kernels import attention, fused_block
from scrabblegan_torch.ops.attention import NonLocalBlock
from scrabblegan_torch.ops.layers import commit_stats, record_stats
from scrabblegan_torch.train import compare
from scrabblegan_torch.train.step import METRIC_NAMES, make_train_step

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

C, CA, CG = 64, 8, 32
BLOCK_TOLS = {"float32": 1e-4, "bfloat16": 2e-2}


def block_operands(seed, b, n, k, dtype):
    """(jax arrays, torch tensors) of (x, w_theta, phiT, gT, w_out), rounded to
    `dtype` once; x is (B, N, C) for JAX and (B, C, N) for the port."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, n, C)), 0.2 * rng.standard_normal((C, CA)),
            rng.standard_normal((b, CA, k)), rng.standard_normal((b, CG, k)),
            0.2 * rng.standard_normal((CG, C))]
    jax_ops = [jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype)) for a in arrs]
    torch_ops = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
                 for a in jax_ops]
    torch_ops[0] = torch_ops[0].transpose(1, 2).contiguous()
    return jax_ops, torch_ops


def port_layout(a) -> np.ndarray:
    """A JAX (B, N, C) result as the port's (B, C, N), float32."""
    return np.swapaxes(np.asarray(a.astype(jnp.float32)), 1, 2)


@pytest.mark.parametrize("n,k,dtype,tol", [
    (512, 128, "float32", 5e-4),
    (512, 128, "bfloat16", 1e-1),
    (300, 75, "float32", 5e-4),  # ragged: N not a multiple of the 128-query tile
    (640, 75, "bfloat16", 1e-1),  # K not a multiple of 8: staged element by element
    (256, 129, "bfloat16", 1e-1),  # K one past a key tile
    (256, 136, "float32", 5e-4),  # K a multiple of 8 just past a key tile
    (72, 136, "bfloat16", 1e-1),  # N not a multiple of a warp's 32 rows
])
def test_emulation_matches_the_interpreted_pallas_kernel(n, k, dtype, tol):
    jops, tops = block_operands(0, 2, n, k, dtype)
    ref = _fused_block_forward(*jops, interpret=True)
    got = fused_block.fused_block_emulation(*tops)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, C, n)
    np.testing.assert_allclose(got.float().numpy(), port_layout(ref), rtol=tol, atol=tol)


def test_plain_version_matches_the_jax_composition():
    jops, tops = block_operands(1, 2, 256, 64, "float32")
    got = fused_block.fused_block_reference(*tops)
    np.testing.assert_allclose(got.numpy(), port_layout(_fused_block_reference(*jops)),
                               rtol=1e-5, atol=1e-5)


def test_emulation_uses_the_kernels_widths_and_tiles():
    csrc = Path(fused_block.__file__).parents[1] / "csrc"
    src = (csrc / "fused_block_fwd.cu").read_text() + (csrc / "attention_mma.cuh").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))  # noqa: E731
    assert (const("kC"), const("kCa"), const("kCg")) == (
        fused_block.KERNEL_C, fused_block.KERNEL_CA, fused_block.KERNEL_CG)
    assert (const("kKt"), const("kKs")) == (attention.KEY_TILE, attention.KEY_CHUNK)
    assert 16 * const("kMt") == attention.WARP_QUERIES
    assert "kwalk_mma<true>" in src  # log2(e) is folded into the theta weight, as emulated


def test_gradients_in_all_six_arguments_match_jax():
    jops, tops = block_operands(2, 1, 256, 64, "float32")
    sigma = 0.7
    jgrads = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_fused_nonlocal_block(*a))),
                      argnums=tuple(range(6)))(*jops, jnp.asarray(sigma))
    xs = [t.clone().requires_grad_() for t in (*tops, torch.tensor(sigma))]
    torch.sin(fused_block.fused_nonlocal_block(*xs)).sum().backward()
    for i, (x, g) in enumerate(zip(xs, jgrads)):
        want = port_layout(g) if i == 0 else np.asarray(g)
        np.testing.assert_allclose(x.grad.numpy(), want, rtol=2e-4, atol=2e-5,
                                   err_msg=f"argument {i}")


def run_block(monkeypatch, dataflow, dtype, train):
    """NonLocalBlock of JAX and of the port at G's B3 width (C = 64), sigma
    0.7, both built with dataflow '' and told which one by the environment.
    Returns (x, jax out, port out, jax stats, port stats, jax grads, port
    grads), flat numpy in JAX's layouts; the grads are of sum(out * w) in the
    parameters and in x."""
    monkeypatch.setenv("SCRABBLEGAN_ATTN_DATAFLOW", dataflow)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 24, 64)).astype(np.float32)
    w = rng.standard_normal((2, 8, 24, 64)).astype(np.float32)
    jm = JaxNonLocalBlock(use_pallas=True, dtype=jdt)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, x, train=False))
    v = fake_fill({p: s.shape for p, s in flatten(shapes).items()}, seed=4)
    v["params"]["sigma"] = np.float32(0.7)
    xj = jnp.asarray(x).astype(jdt)

    def jloss(params, xj):
        out, muts = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, xj,
                             train=train, mutable=["batch_stats"])
        return (out.astype(jnp.float32) * w).sum(), (out, muts["batch_stats"])

    (_, (jout, jstats)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, v["params"]), xj)
    port = load_flax(NonLocalBlock(64, dtype=tdt), v).train(train)
    assert port.dataflow == ""
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)).transpose(0, 3, 1, 2).copy())
    xt = xt.to(tdt).requires_grad_()
    with record_stats() as record:
        out = port(xt)
    (out.float().permute(0, 2, 3, 1) * torch.from_numpy(w)).sum().backward()
    commit_stats(record)
    pgrads = flatten(to_flax(port, {n: p.grad for n, p in port.named_parameters()})["params"])
    pgrads[("x",)] = xt.grad.float().permute(0, 2, 3, 1).numpy()
    jgrads = {p: np.asarray(g, np.float32) for p, g in flatten(jgp).items()}
    jgrads[("x",)] = np.asarray(jgx.astype(jnp.float32))
    return (np.asarray(xj.astype(jnp.float32)), np.asarray(jout.astype(jnp.float32)),
            out.detach().float().permute(0, 2, 3, 1).numpy(), flatten(jstats),
            flatten(to_flax(port)["batch_stats"]), jgrads, pgrads)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dataflow", ["packed", "fused"])
def test_nonlocal_block_matches_jax(monkeypatch, dataflow, dtype, train):
    x, jout, pout, jstats, pstats, jgrads, pgrads = run_block(monkeypatch, dataflow, dtype,
                                                             train)
    tol = BLOCK_TOLS[dtype]
    assert np.abs(jout - x).max() > 0.1  # the block is not the identity
    np.testing.assert_allclose(pout, jout, rtol=tol, atol=tol)
    assert sorted(jstats) == sorted(pstats)
    for path, arr in jstats.items():  # SN's u and sigma: proposed in train mode only
        np.testing.assert_allclose(pstats[path], np.asarray(arr), rtol=1e-5, atol=1e-5,
                                   err_msg="/".join(path))
    scale = max(np.abs(g).max() for g in jgrads.values())
    assert sorted(jgrads) == sorted(pgrads)
    for path, g in jgrads.items():
        np.testing.assert_allclose(pgrads[path], g, rtol=tol, atol=tol * scale,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("dataflow,error", [("fused", None), ("bogus", ValueError)])
def test_dataflow_from_the_environment(monkeypatch, dataflow, error):
    """'' resolves at each call, as JAX's block resolves it at each trace."""
    block = NonLocalBlock(64).eval()
    monkeypatch.setenv("SCRABBLEGAN_ATTN_DATAFLOW", dataflow)
    x = torch.zeros(1, 64, 4, 8)
    if error is None:
        assert block(x).shape == x.shape
    else:
        with pytest.raises(error):
            block(x)


def test_cpu_dispatch_launches_nothing():
    _, tops = block_operands(5, 1, 128, 32, "float32")
    before = (fused_block.launches, attention.launches, attention.bwd_launches)
    for fuse in (True, False):
        xs = [t.clone().requires_grad_() for t in (*tops, torch.tensor(0.7))]
        fused_block.fused_nonlocal_block(*xs, fuse=fuse).sum().backward()
    assert (fused_block.launches, attention.launches, attention.bwd_launches) == before
    with pytest.raises(TypeError):
        fused_block.fused_nonlocal_block(*(t.double() for t in tops), torch.tensor(0.7))
    with pytest.raises(ValueError, match="mismatched"):
        fused_block.fused_nonlocal_block(tops[0], tops[1][:, :4], *tops[2:], torch.tensor(0.7))
    with pytest.raises(ValueError, match="C=64"):
        fused_block._launch_fused(tops[0][:, :32], tops[1][:32], tops[2], tops[3],
                                  tops[4][:, :32])
    assert fused_block.launches == before[0]


class OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the dispatch takes its
    CUDA branch; every torch operation on it sees the plain CPU tensor."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def emulated_launcher(monkeypatch):
    calls = []

    def launch(*ops):
        calls.append(tuple(t.dtype for t in ops))
        return fused_block.fused_block_emulation(*ops)

    monkeypatch.setattr(fused_block, "fused_block_fwd", launch)
    return calls


@pytest.mark.parametrize("n,k", [(640, 160), (300, 75)])
def test_autograd_function_matches_autograd_of_the_composition(emulated_launcher, n, k):
    """The backward differentiates the composition, and only in the inputs
    that need it: here the weights arrive detached, as a frozen network's."""
    _, (x, wt, phiT, gT, wo) = block_operands(6, 2, n, k, "float32")
    d = torch.from_numpy(np.random.default_rng(7).standard_normal((2, C, n)).astype(np.float32))
    xs = [x.clone().requires_grad_(), wt, phiT.clone().requires_grad_(),
          gT.clone().requires_grad_(), wo]
    out = fused_block.FusedBlock.apply(*xs)
    out.backward(d)
    ys = [t.detach().clone().requires_grad_(t.requires_grad) for t in xs]
    ref = fused_block.fused_block_reference(*ys)
    ref.backward(d)
    torch.testing.assert_close(out, ref, rtol=5e-4, atol=5e-4)
    for a, b in zip(xs, ys):
        if a.requires_grad:
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)
        else:
            assert a.grad is None
    assert len(emulated_launcher) == 1


def test_cuda_dispatch_carries_gradients(emulated_launcher):
    _, tops = block_operands(8, 1, 128, 32, "float32")
    xs = [t.clone().as_subclass(OnCard).requires_grad_() for t in tops]
    out = fused_block.fused_nonlocal_block(*xs, torch.tensor(0.7))
    assert "FusedBlock" in type(out.grad_fn).__name__ and len(emulated_launcher) == 1
    out.sum().backward()
    assert all(x.grad is not None and x.grad.abs().max() > 0 for x in xs)


def test_train_step_fused_matches_nhwc1(monkeypatch):
    """One float32 step at batch 2, len 2, from one seeded start and batch:
    'fused' (on the CPU, the plain composition) against 'nhwc1'. The two
    round the block's sums in other orders only: metrics within 1e-5 x
    (1 + |value|), the two balanced ones within 5e-2 (they scale by a std
    over two nearly equal values, as chip_smoke.py states); each network's
    gradients (|g| from Adam's second moment) within 1e-3 of its scale, by
    the rule of train/compare.py (5.6e-5 measured on G)."""
    cfg = load_config(None, {"shared.batch_size": 2, "io.seq_len": 2})
    trees = {n: fake_flax_variables(cfg, 1, name) for n, name in
             (("g", "generator"), ("d", "discriminator"), ("r", "recognizer"),
              ("w", "style_promoter"))}
    batch = synthetic_batch(cfg, 2, 2, np.random.default_rng(1))
    runs = {}
    for dataflow in ("fused", "nhwc1"):
        monkeypatch.setenv("SCRABBLEGAN_ATTN_DATAFLOW", dataflow)
        state = state_from_flax(cfg, {n: t["params"] for n, t in trees.items()},
                                {n: t.get("batch_stats", {}) for n, t in trees.items()})
        runs[dataflow] = (state, make_train_step(cfg, state.models)(state, batch))
    (fused, m_fused), (nhwc1, m_nhwc1) = runs["fused"], runs["nhwc1"]
    for k in METRIC_NAMES:
        a, b = float(m_fused[k]), float(m_nhwc1[k])
        tol = 5e-2 if k.endswith("_balanced") else 1e-5
        assert np.isfinite(a) and abs(a - b) <= tol * (1 + abs(b)), k
    for net in "gdrw":
        got, want = (compare.abs_grads([v.float().numpy() for v in s.opt_states[net].nu],
                                       cfg.optimizer.beta_2) for s in (fused, nhwc1))
        errs, _ = compare.gradient_errors(got, want)
        assert max(errs) < 1e-3, (net, max(errs))
