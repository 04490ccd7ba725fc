"""Parity of the PyTorch port's attention core and NonLocalBlock with the JAX
package (CPU), and the checks around the CUDA kernel's wrapper.

The CUDA kernel cannot run here; `attention_tiled_emulation` runs its
algorithm (key tiles, chunked online softmax with a lazily moving max,
bfloat16 probabilities on the tensor-core path, deferred division) in plain
torch and is held to JAX at shapes where K spans many tiles and at the
staging's edges. The kernel itself is held to the plain version on the card
by chip_smoke.py.

Tolerances: 1e-4 in float32 and 2e-2 in bfloat16, those of the JAX kernel's
own tests (tests/test_kernels.py)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrabblegan_tpu.kernels.attention import _pallas_forward, _xla_attention
from scrabblegan_tpu.kernels.attention import nonlocal_attention as jax_nonlocal_attention
from scrabblegan_tpu.ops.attention import NonLocalBlock as JaxNonLocalBlock
from scrabblegan_torch import resolve_device
from scrabblegan_torch.convert import fake_fill, flatten, load_flax
from scrabblegan_torch.kernels import attention, build
from scrabblegan_torch.ops.attention import NonLocalBlock

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

TOLS = {"float32": 1e-4, "bfloat16": 2e-2}


def packed_operands(seed, b, q, k, dtype, ca=8, cg=32):
    rng = np.random.default_rng(seed)
    mk = lambda c, n: rng.standard_normal((b, c, n)).astype(np.float32)  # noqa: E731
    ops = (mk(ca, q), mk(ca, k), mk(cg, k))
    # round to the working dtype once, so both sides see the same inputs
    jax_ops = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in ops]
    torch_ops = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
                 for a in jax_ops]
    return jax_ops, torch_ops


def as_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def xla_packed(thetaT, phiT, gT):
    T = lambda a: jnp.swapaxes(a, 1, 2)  # noqa: E731
    return T(_xla_attention(T(thetaT), T(phiT), T(gT)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q,k", [(512, 128), (1280, 320)])
def test_plain_core_matches_pallas_and_xla(q, k, dtype):
    (jt, jp, jg), (tt, tp, tg) = packed_operands(0, 2, q, k, dtype)
    got = attention.attention_reference(tt, tp, tg)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 32, q)
    tol = TOLS[dtype]
    for ref in (_pallas_forward(jt, jp, jg, interpret=True), xla_packed(jt, jp, jg)):
        np.testing.assert_allclose(as_np(got), as_np(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("q,k,dtype", [
    (5120, 1280, "float32"),   # len 10 at G's B3: ten key tiles
    (1280, 320, "bfloat16"),
    (300, 75, "float32"),      # ragged: Q not a multiple of 128, K one partial tile
    (640, 200, "float32"),     # K past a tile edge: a partial second tile
    (5120, 1280, "bfloat16"),  # the tensor-core walk over ten key tiles
    (640, 75, "bfloat16"),     # K not a multiple of 8: staged element by element
    (640, 129, "bfloat16"),    # K one past a tile: a second tile of one key
    (640, 136, "bfloat16"),    # K a multiple of 8 just past a tile
    (72, 136, "bfloat16"),     # Q not a multiple of a warp's 32 rows
    (300, 75, "bfloat16"),     # both ragged
])
def test_kernel_tiling_emulation_matches_jax(q, k, dtype):
    (jt, jp, jg), (tt, tp, tg) = packed_operands(1, 2, q, k, dtype)
    got = attention.attention_tiled_emulation(tt, tp, tg)
    tol = TOLS[dtype]
    np.testing.assert_allclose(as_np(got), as_np(xla_packed(jt, jp, jg)), rtol=tol, atol=tol)


CSRC = Path(attention.__file__).parents[1] / "csrc"


def test_emulation_uses_the_kernels_tiles():
    src = (CSRC / "attention_mma.cuh").read_text()
    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([\d.]+)f?;", src).group(1)

    assert (int(const("kKt")), int(const("kKs"))) == (attention.KEY_TILE, attention.KEY_CHUNK)
    assert (int(const("kCa")), int(const("kCg"))) == (attention.KERNEL_CA, attention.KERNEL_CG)
    assert re.search(r"constexpr int kWarpQ = 16 \* kMt;", src)
    assert 16 * int(const("kMt")) == attention.WARP_QUERIES
    assert float(const("kSlack")) == attention.MAX_SLACK
    assert int(const("kQb")) == int(const("kThreads")) == attention.KEY_TILE


def test_both_forward_kernels_share_one_k_walk():
    """attention_fwd.cu and fused_block_fwd.cu include the shared header, which
    alone holds the walk over the keys: the tensor-core instructions, the
    exponentials and the running max appear in no .cu file."""
    header = (CSRC / "attention_mma.cuh").read_text()
    assert "mma.sync.aligned.m16n8k8" in header and "mma.sync.aligned.m16n8k16" in header
    assert len(re.findall(r"void kwalk_(?:mma|fma)\(", header)) == 2
    for name, walks in (("attention_fwd.cu", 2), ("fused_block_fwd.cu", 2)):
        src = (CSRC / name).read_text()
        code = "\n".join(ln for ln in src.splitlines() if not ln.lstrip().startswith("//"))
        assert '#include "attention_mma.cuh"' in code
        assert len(re.findall(r"\bkwalk_(?:mma<\w+>|fma)\(", code)) == walks
        for walk_only in ("exp2f", "ex2(", "asm", "INFINITY", "fmaxf", "__shfl"):
            assert walk_only not in code, (name, walk_only)


def test_unpacked_entry_matches_jax():
    rng = np.random.default_rng(2)
    theta, phi, g = (rng.standard_normal(s).astype(np.float32)
                     for s in [(2, 256, 8), (2, 64, 8), (2, 64, 32)])
    ref = np.asarray(jax_nonlocal_attention(theta, phi, g))
    got = attention.nonlocal_attention(*map(torch.from_numpy, (theta, phi, g)))
    assert got.shape == (2, 256, 32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_nonlocal_block_matches_jax(dtype, use_kernel):
    """G's B3 widths (C=64: Ca=8, Cg=32), sigma = 0.7 so the attention shows."""
    x = np.random.default_rng(3).standard_normal((2, 8, 24, 64)).astype(np.float32)
    jm = JaxNonLocalBlock(use_pallas=True, dtype=getattr(jnp, dtype))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, x, train=False))
    v = fake_fill({p: s.shape for p, s in flatten(shapes).items()}, seed=4)
    v["params"]["sigma"] = np.float32(0.7)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref = np.asarray(jm.apply(v, xj, train=False).astype(jnp.float32))
    port = load_flax(NonLocalBlock(64, use_kernel=use_kernel, dtype=getattr(torch, dtype)), v)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)).transpose(0, 3, 1, 2).copy())
    with torch.inference_mode():
        got = port(xt.to(getattr(torch, dtype))).float().permute(0, 2, 3, 1).numpy()
    without_attention = np.asarray(xj.astype(jnp.float32))
    assert np.abs(ref - without_attention).max() > 0.1  # the block is not the identity
    tol = TOLS[dtype]
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dataflow,error", [("fused", None), ("bogus", ValueError)])
def test_nonlocal_block_dataflows(dataflow, error):
    for ok in ("nhwc", "nhwc1", "packed"):
        NonLocalBlock(64, dataflow=ok)
    if error is None:
        assert NonLocalBlock(64, dataflow=dataflow).dataflow == dataflow
    else:
        with pytest.raises(error):
            NonLocalBlock(64, dataflow=dataflow)


def test_wrapper_checks_and_cpu_dispatch():
    (_, _, _), (tt, tp, tg) = packed_operands(5, 1, 128, 32, "float32")
    before = attention.launches
    out = attention.nonlocal_attention_packed(tt, tp, tg)
    assert attention.launches == before  # the CPU takes the plain version
    torch.testing.assert_close(out, attention.attention_reference(tt, tp, tg))
    with pytest.raises(TypeError):
        attention.nonlocal_attention_packed(tt.half(), tp.half(), tg.half())
    with pytest.raises(ValueError):
        attention.nonlocal_attention_packed(tt, tp[:, :, :16], tg)
    with pytest.raises(ValueError):
        attention.nonlocal_attention_packed(tt[:, :, :0], tp, tg)


def test_kernel_bench_needs_a_card_and_covers_the_staging_edges(monkeypatch):
    from scrabblegan_torch.kernels import bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])
    ks = [k for _, k in bench.SHAPES]
    assert any(k % 8 for k in ks) and attention.KEY_TILE + 8 in ks and attention.KEY_TILE + 1 in ks
    assert any(q % attention.WARP_QUERIES for q, _ in bench.SHAPES)


def test_cuda_requests_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load_library.__wrapped__()


@pytest.mark.parametrize("ca,cg", [(12, 48), (24, 96)])
@pytest.mark.parametrize("q,k", [(512, 128), (300, 75)])
def test_emulation_at_biggan_widths_matches_the_plain_core(ca, cg, q, k):
    """The forward walk's emulation at BigGAN's widths (D's 12/48, G's 24/96;
    Ca = 12 padded to two k8 steps on the card, which adds zeros) against
    the plain core, in bfloat16 at its 2e-2 tolerance."""
    gen = torch.Generator().manual_seed(q + ca)
    th, ph, g = (torch.randn(2, c, n, generator=gen).bfloat16()
                 for c, n in ((ca, q), (ca, k), (cg, k)))
    got = attention.attention_tiled_emulation(th, ph, g)
    want = attention.attention_reference(th, ph, g)
    assert got.shape == want.shape == (2, cg, q) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=2e-2, atol=2e-2)
