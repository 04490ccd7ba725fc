"""The down-block's 2x2/2 average pool (`scrabblegan_torch.kernels.pool`,
csrc/down_pool.cu) and `ResNetBlockDown` on it.

CPU, tiny shapes:
- every form of the block (a pre-activated block with a pooled 1x1 skip,
  BigGAN's first block that pools before its skip, a last block with a
  learned or an identity skip and no pool; the first block on one-channel
  NHWC images, whose skip conv returns channels_last) equals the
  composition it ran before the op (`F.avg_pool2d` of each path, then the
  add), bit for bit, forward and backward (the input's and every
  parameter's gradient), in float32 and bfloat16;
- a block whose input is channels_last (BigGAN's D on a card) equals the
  block on the same input NCHW, forward and backward, within float32's
  rounding of the convs' other order of summation, and keeps the layout;
- the op's CPU path against `F.avg_pool2d`, with a strided incoming
  gradient (a sum's backward);
- the fakes give the CUDA path's shapes, dtypes and device on fake CUDA
  tensors;
- an odd height or width raises, in the op and in the block.

Card (`card`, skips without one; `python -m pytest --noconftest -m card
tests/test_torch_pool.py`): the kernel against the plain version at BigGAN
D's five pooled blocks (batch 256, bf16) and at ScrabbleGAN's pooled widths
4, 12, 20, 80, 160 (and 1, 2, 3, 6, which take the narrower vector paths),
float32 and bfloat16: forward and backward bit for bit (the kernel sums
each window in PyTorch's order and rounds where the composition rounds;
x 1/4 is exact), the widths reaching every vector width of the kernel; the
channels_last instance likewise against the composition on channels_last
inputs, at BigGAN D's pooled blocks and at channel counts that reach each
of its vector widths, its output and gradient channels_last; channels_last
is taken, while mixed layouts, other strides, a misaligned or a float16
input raise; an input of more than 2**32 elements takes the 64-bit index
path and matches too; the launch counters of the captured recommended
train step equal the eager step's and the block structure's on every
replay, none of them the channels_last instance's.
"""

from __future__ import annotations

import re

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from scrabblegan_torch.kernels import pool
from scrabblegan_torch.ops import blocks
from scrabblegan_torch.utils.layout import memory_format

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]
FORMS = {  # ResNetBlockDown's options for each form of the block
    "pooled skip": {},
    "first block": {"preactivation": False},
    "last block": {"is_last_block": True},
    "identity last": {"is_last_block": True, "learnable_skip": False},
}


def composed_forward(block: blocks.ResNetBlockDown, x: torch.Tensor) -> torch.Tensor:
    """The block's forward as it was before the op: `F.avg_pool2d` of each
    path, then the add."""
    h = block.conv1(torch.relu(x) if block.preactivation else x)
    h = block.conv2(torch.relu(h))
    if block.is_last_block:
        return h + (x if block.skip is None else block.skip(x))
    if block.preactivation:
        return F.avg_pool2d(h, 2) + F.avg_pool2d(block.skip(x), 2)
    return F.avg_pool2d(h, 2) + block.skip(F.avg_pool2d(x, 2))


def random_block(cin: int, cout: int, dtype, **options) -> blocks.ResNetBlockDown:
    block = blocks.ResNetBlockDown(cin, cout, dtype=dtype, **options)
    with torch.no_grad():  # the layers start at zero
        for p in block.parameters():
            p.normal_(0, 0.3)
    return block


def check_block_against_composition(block, x, dtype) -> torch.Tensor:
    """The block and its old composition on x: outputs, and the gradients of
    x and of every parameter, bit for bit; returns the output."""
    params = [p for p in block.parameters() if p.requires_grad]
    outs, grads = [], []
    for forward in (block, lambda t: composed_forward(block, t)):
        out = forward(x)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
        outs.append(out)
        grads.append(torch.autograd.grad(out, [x, *params], g))
    assert outs[0].dtype == dtype
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    return outs[0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", list(FORMS))
def test_block_equals_the_composition_bitwise(form, dtype):
    torch.manual_seed(0)
    cin, cout = (5, 5) if form == "identity last" else (6, 7)
    block = random_block(cin, cout, dtype, **FORMS[form])
    x = torch.randn(2, cin, 8, 12).to(dtype).requires_grad_()
    out = check_block_against_composition(block, x, dtype)
    assert out.shape == ((2, cout, 8, 12) if "last" in form else (2, cout, 4, 6))


@pytest.mark.parametrize("dtype", DTYPES)
def test_first_block_on_nhwc_images_equals_the_composition_bitwise(dtype):
    """ScrabbleGAN's first block takes one-channel images as an NCHW view of
    NHWC (train/step.py), and its 1x1 skip conv returns channels_last: the
    block hands the op an NCHW copy, and nothing changes."""
    torch.manual_seed(1)
    block = random_block(1, 6, dtype)
    x = torch.randn(2, 8, 12, 1).to(dtype).permute(0, 3, 1, 2).requires_grad_()
    assert not block.skip(x).is_contiguous()
    out = check_block_against_composition(block, x, dtype)
    assert out.shape == (2, 6, 4, 6)


@pytest.mark.parametrize("form", ["pooled skip", "first block"])
def test_channels_last_block_equals_the_nchw_block(form):
    """A channels_last input keeps its layout through the convs and the
    pool (the op's CPU path is `F.avg_pool2d`, which keeps it too), and the
    values are the NCHW block's up to the convs' order of summation."""
    torch.manual_seed(2)
    cin = 3 if form == "first block" else 6
    block = random_block(cin, 8, torch.float32, **FORMS[form])
    x = torch.randn(2, cin, 8, 8)
    outs, grads = [], []
    for layout in (torch.contiguous_format, torch.channels_last):
        leaf = x.contiguous(memory_format=layout).requires_grad_()
        out = block(leaf)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
        outs.append(out)
        grads.append(torch.autograd.grad(out, [leaf, *block.parameters()], g))
    assert memory_format(outs[1]) == torch.channels_last
    assert memory_format(grads[1][0]) == torch.channels_last
    torch.testing.assert_close(outs[1], outs[0])
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("two", [False, True])
def test_op_on_the_cpu_is_the_plain_pool(two, dtype):
    gen = torch.Generator().manual_seed(2)
    a, b = (torch.randn(2, 3, 6, 10, generator=gen).to(dtype).requires_grad_()
            for _ in range(2))
    out = pool.down_pool(a, b if two else None)
    want = F.avg_pool2d(a, 2) + F.avg_pool2d(b, 2) if two else F.avg_pool2d(a, 2)
    assert torch.equal(out, want) and out.dtype == dtype
    inputs = [a, b] if two else [a]
    # a sum's backward hands the op an expanded (stride 0) gradient
    got = torch.autograd.grad(out.float().sum(), inputs)
    ref = torch.autograd.grad(want.float().sum(), inputs, retain_graph=True)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    g = torch.randn(out.shape, generator=gen).to(dtype)
    assert torch.equal(pool.down_pool_bwd(g), pool.down_pool_bwd_reference(g))
    assert torch.equal(pool.down_pool_bwd(g), torch.autograd.grad(want, a, g)[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_fakes_give_the_cuda_path_s_outputs(dtype):
    with FakeTensorMode():
        a = torch.empty(2, 4, 8, 6, dtype=dtype, device="cuda")
        outs = {"one": pool.down_pool(a), "two": pool.down_pool(a, a),
                "bwd": pool.down_pool_bwd(a)}
    assert {k: tuple(v.shape) for k, v in outs.items()} == {
        "one": (2, 4, 4, 3), "two": (2, 4, 4, 3), "bwd": (2, 4, 16, 12)}
    assert all(v.dtype == dtype and v.device.type == "cuda" for v in outs.values())


@pytest.mark.parametrize("hw", [(8, 7), (7, 8)])
def test_odd_heights_and_widths_raise(hw):
    x = torch.zeros(1, 4, *hw)
    with pytest.raises(ValueError, match="even"):
        pool.down_pool(x)
    with pytest.raises(ValueError, match="even"):
        pool.down_pool(x, x)
    with pytest.raises(ValueError, match="even"):
        blocks.ResNetBlockDown(4, 8)(x)
    with pytest.raises(ValueError, match="even"):
        blocks.ResNetBlockDown(4, 8, preactivation=False)(x)
    with FakeTensorMode(), pytest.raises(ValueError, match="even"):
        pool.down_pool(torch.empty(1, 4, *hw, device="cuda"))
    assert blocks.ResNetBlockDown(4, 8, is_last_block=True)(x).shape == (1, 8, *hw)


def test_mismatched_inputs_raise():
    with pytest.raises(ValueError, match="differ"):
        pool.down_pool(torch.zeros(1, 4, 8, 8), torch.zeros(1, 4, 8, 6))
    with pytest.raises(ValueError, match="differ"):
        pool.down_pool(torch.zeros(1, 4, 8, 8), torch.zeros(1, 4, 8, 8).bfloat16())


# ---- the card --------------------------------------------------------------------

# BigGAN D's pooled inputs at batch 256 (configs/biggan128.json): block 0's h
# and its 3-channel input, then h and the skip conv's output of blocks 1-4
BIGGAN = [((256, 96, 128, 128), False), ((256, 3, 128, 128), False),
          ((256, 192, 64, 64), True), ((256, 384, 32, 32), True),
          ((256, 768, 16, 16), True), ((256, 1536, 8, 8), True)]
# ScrabbleGAN's pooled widths (32 x 16L images, L = 1 ... 10), and narrow ones
SCRABBLE_WIDTHS = [4, 12, 20, 80, 160, 1, 2, 3, 6]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def check_against_plain(shape, two: bool, dtype, device) -> None:
    gen = torch.Generator(device=device).manual_seed(sum(shape))
    a, b = (torch.randn(shape, generator=gen, device=device).to(dtype) for _ in range(2))
    b = b if two else None
    got = pool.down_pool(a, b)
    assert torch.equal(got, pool.down_pool_reference(a, b))
    g = torch.randn(got.shape, generator=gen, device=device).to(dtype)
    d = pool.down_pool_bwd(g)
    leaf = a.detach().requires_grad_()
    assert torch.equal(d, torch.autograd.grad(F.avg_pool2d(leaf, 2), leaf, g)[0])


@pytest.mark.card
@pytest.mark.parametrize("shape,two", BIGGAN, ids=[str(s[1:]) for s, _ in BIGGAN])
def test_kernel_at_biggan_shapes(card, shape, two):
    check_against_plain(shape, two, torch.bfloat16, card)
    torch.cuda.synchronize(card)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wo", SCRABBLE_WIDTHS)
def test_kernel_at_scrabblegan_widths(card, wo, dtype):
    for two in (False, True):
        check_against_plain((16, 64, 4, 2 * wo), two, dtype, card)
    torch.cuda.synchronize(card)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_scrabblegan_widths_take_every_vector_path(card, dtype):
    """The widths above reach each vector width the kernel has: 8, 4, 2 and 1
    outputs a thread in bfloat16, 4, 2 and 1 in float32, read from the
    template arguments of the kernels each launch ran (in the profiler's
    trace), forward and backward alike."""
    from torch.profiler import ProfilerActivity, profile

    widths = {"fwd": set(), "bwd": set()}
    for wo in SCRABBLE_WIDTHS:
        a = torch.zeros(16, 64, 4, 2 * wo, dtype=dtype, device=card)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pool.down_pool_bwd(pool.down_pool(a, a))
            torch.cuda.synchronize(card)
        for event in prof.events():
            found = re.search(r"down_pool_(fwd|bwd)_kernel<[^,<>]+, (\d+)", event.name)
            if found:
                widths[found[1]].add(int(found[2]))
    want = {8, 4, 2, 1} if dtype == torch.bfloat16 else {4, 2, 1}
    assert widths == {"fwd": want, "bwd": want}


@pytest.mark.card
def test_kernel_past_32_bit_indices(card):
    """An input of more than 2**32 elements (8.6 GB in bfloat16), NCHW and
    channels_last in turn, takes each instance's 64-bit index path, named
    in the profiler's trace, and matches the plain version bit for bit,
    forward and backward."""
    from torch.profiler import ProfilerActivity, profile

    shape = (4, 1025, 1024, 1024)
    for layout in (torch.contiguous_format, torch.channels_last):
        a = torch.randn(shape, generator=torch.Generator(device=card).manual_seed(3),
                        device=card, dtype=torch.bfloat16).contiguous(memory_format=layout)
        assert a.numel() > 2**32 and memory_format(a) == layout
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = pool.down_pool(a)
            d = pool.down_pool_bwd(out)
            torch.cuda.synchronize(card)
        names = {e.name for e in prof.events() if "down_pool_" in e.name and "_kernel<" in e.name}
        assert {n.split("_kernel<")[0][-3:] for n in names} == {"fwd", "bwd"}
        assert all(("_nhwc_" in n) == (layout == torch.channels_last) for n in names), names
        assert all("unsigned long long>" in n for n in names), names
        assert memory_format(out) == memory_format(d) == layout
        assert torch.equal(out, pool.down_pool_reference(a))
        del a
        assert torch.equal(d, pool.down_pool_bwd_reference(out))
        del out, d
        torch.cuda.empty_cache()


@pytest.mark.card
def test_kernel_takes_only_contiguous_aligned_float32_or_bfloat16(card):
    """NCHW-contiguous and channels_last-contiguous tensors are taken, each
    returning its layout; mixed layouts and any other strides raise, as do a
    misaligned and a float16 input."""
    x = torch.randn(2, 8, 8, 16, device=card)
    cl = x.to(memory_format=torch.channels_last)
    for out in (pool.down_pool(cl), pool.down_pool(cl, cl), pool.down_pool_bwd(cl)):
        assert memory_format(out) == torch.channels_last
    with pytest.raises(ValueError, match="both in one layout"):
        pool.down_pool(x, cl)
    with pytest.raises(ValueError, match="both in one layout"):
        pool.down_pool(cl, x)
    with pytest.raises(ValueError, match="NCHW-contiguous or channels_last-contiguous"):
        pool.down_pool(x, x.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="NCHW-contiguous or channels_last-contiguous"):
        pool.down_pool(x.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="NCHW-contiguous or channels_last-contiguous"):
        pool.down_pool_bwd(torch.randn(2, 8, 16, 8, device=card).transpose(2, 3))
    with pytest.raises(ValueError, match="aligned"):
        pool.down_pool(torch.empty(x.numel() + 1, device=card)[1:].view(x.shape))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pool.down_pool(x.half())


def check_channels_last_against_plain(shape, two: bool, dtype, device) -> None:
    """The channels_last instance against `F.avg_pool2d` composed on the same
    channels_last inputs: forward and backward bit for bit, the output and
    the gradient channels_last, one launch each counted as such."""
    gen = torch.Generator(device=device).manual_seed(sum(shape))
    a, b = (torch.randn(shape, generator=gen, device=device).to(dtype)
            .contiguous(memory_format=torch.channels_last) for _ in range(2))
    b = b if two else None
    before = (pool.nhwc_launches, pool.nhwc_bwd_launches)
    got = pool.down_pool(a, b)
    assert memory_format(got) == torch.channels_last
    assert torch.equal(got, pool.down_pool_reference(a, b))
    g = torch.randn(got.shape, generator=gen, device=device).to(dtype).contiguous(
        memory_format=torch.channels_last)
    d = pool.down_pool_bwd(g)
    assert memory_format(d) == torch.channels_last
    leaf = a.detach().requires_grad_()
    assert torch.equal(d, torch.autograd.grad(F.avg_pool2d(leaf, 2), leaf, g)[0])
    assert (pool.nhwc_launches, pool.nhwc_bwd_launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.card
@pytest.mark.parametrize("shape,two", BIGGAN, ids=[str(s[1:]) for s, _ in BIGGAN])
def test_channels_last_kernel_at_biggan_shapes(card, shape, two):
    check_channels_last_against_plain(shape, two, torch.bfloat16, card)
    torch.cuda.synchronize(card)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_channels_last_kernel_takes_every_vector_path(card, dtype):
    """Channel counts 96, 4, 2 and 3 reach each vector width of the
    channels_last instance (8, 4, 2, 1 channels a thread in bfloat16; 4, 2, 1
    in float32; read from the kernels' names in the profiler's trace), and
    each matches the composition bit for bit, one and two inputs."""
    from torch.profiler import ProfilerActivity, profile

    widths = {"fwd": set(), "bwd": set()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for c in (96, 4, 2, 3):
            for two in (False, True):
                check_channels_last_against_plain((4, c, 8, 12), two, dtype, card)
        torch.cuda.synchronize(card)
    for event in prof.events():
        found = re.search(r"down_pool_nhwc_(fwd|bwd)_kernel<[^,<>]+, (\d+)", event.name)
        if found:
            widths[found[1]].add(int(found[2]))
    want = {8, 4, 2, 1} if dtype == torch.bfloat16 else {4, 2, 1}
    assert widths == {"fwd": want, "bwd": want}


@pytest.mark.card
def test_launch_counters_are_exact_under_replay(card):
    """The recommended step pools 3 blocks in each of D's 3 passes, W's 3
    and the style encoder's 1, forward and backward: 21 and 21 launches a
    step, eager or replayed, all of the NCHW instance (its networks take
    NCHW inputs)."""
    from scrabblegan_torch.config import load_config
    from scrabblegan_torch.models.build import build_models
    from scrabblegan_torch.train.graphs import WARMUP_STEPS
    from scrabblegan_torch.train.state import new_train_state
    from scrabblegan_torch.train.step import make_chunked_train_step

    cfg = load_config("configs/recommended.json")
    models = build_models(cfg, card)
    state = new_train_state(cfg, models)
    chunk = make_chunked_train_step(cfg, models)
    gen = torch.Generator().manual_seed(0)
    img = lambda: torch.randint(0, 256, (1, 2, 32, 160, 1), generator=gen,  # noqa: E731
                                dtype=torch.uint8)
    batch = {"real_imgs": img(), "style_imgs": img(),
             "real_labels": torch.randint(0, 52, (1, 2, 10), generator=gen),
             "fake_labels": torch.randint(0, 52, (1, 2, 10), generator=gen),
             "real_lengths": torch.full((1, 2), 3), "fake_lengths": torch.full((1, 2), 3)}
    counts = []
    for _ in range(WARMUP_STEPS + 1 + 3):  # the eager warm-up, the capture, 3 replays
        pool.launches = pool.bwd_launches = pool.nhwc_launches = pool.nhwc_bwd_launches = 0
        chunk(state, batch)
        torch.cuda.synchronize(card)
        counts.append((pool.launches, pool.bwd_launches, pool.nhwc_launches,
                       pool.nhwc_bwd_launches))
    eager, replays = counts[:WARMUP_STEPS], counts[WARMUP_STEPS + 1:]
    assert eager == replays[:WARMUP_STEPS] and set(replays) == {(21, 21, 0, 0)}, counts
