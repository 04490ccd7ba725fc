"""The down-block's 2x2/2 average pool and the sum of its two pooled paths:
the plain PyTorch version and the CUDA kernels.

`ResNetBlockDown` (ops/blocks.py) pools its residual path h and, in a
pre-activated block, the output s of its 1x1 skip conv, and adds them:
pool(h) + pool(s). `down_pool(a, b)` is that sum in one pass, and
`down_pool(a)` the pool of a alone:

    out[n, c, i, j] = (sum of a's 2x2 window at (2i, 2j) + the same of b) / 4

The CUDA kernels (`scrabblegan_torch/csrc/down_pool.cu`) replace no TPU
kernel: the JAX package leaves the pool to XLA. They come in two instances,
one for NCHW-contiguous tensors and one for channels_last-contiguous ones
(the layout of BigGAN's D), each returning its inputs' layout; a tensor
that is both (one channel, or one pixel) takes the NCHW instance, and any
other strides raise. They read each input once
and write the result once, and round where the composition rounds (each
pooled path to the inputs' dtype, float32 or bfloat16, then their sum), so
the forward equals it bit for bit; the backward writes g / 4 into each
window's four positions of one full-resolution gradient, which is a's and
b's alike (the pool is linear).

The forward and the backward are registered ops, `scrabblegan::down_pool`
and `scrabblegan::down_pool_bwd` (`torch.library.custom_op`), joined by an
autograd registration, as kernels/attention.py registers the attention's:
a CUDA implementation that launches the kernel, a CPU implementation that
is the plain version (`F.avg_pool2d` of each input, then the add; g / 4
spread over each window), which gives the composition's results bit for
bit, and a fake that gives the shapes, so that `torch.export` keeps the op
in an exported program (train/export.py). Registering builds nothing.
Dispatch has no fallback: a CUDA tensor launches the kernel or raises.
`launches` and `bwd_launches` count kernel launches of both instances,
`nhwc_launches` and `nhwc_bwd_launches` those of the channels_last one;
utils/capture.py keeps them exact under CUDA graph replay. The launch paths
read nothing from the device and take their outputs from `torch.empty`, so
a capture takes them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from scrabblegan_torch.kernels.build import load_library
from scrabblegan_torch.utils.layout import memory_format

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0      # forward kernel launches since the last reset; the caller resets it
bwd_launches = 0  # backward kernel launches, likewise
nhwc_launches = 0      # of `launches`, those of the channels_last instance
nhwc_bwd_launches = 0  # of `bwd_launches`, likewise


def _check(a: torch.Tensor, b: Optional[torch.Tensor]) -> None:
    if a.dim() != 4:
        raise ValueError(f"down_pool takes (N, C, H, W) tensors, got {tuple(a.shape)}")
    if b is not None and (b.shape != a.shape or b.dtype != a.dtype or b.device != a.device):
        raise ValueError(f"down_pool's two inputs differ: {tuple(a.shape)} {a.dtype} on "
                         f"{a.device}, {tuple(b.shape)} {b.dtype} on {b.device}")
    if a.shape[2] % 2 or a.shape[3] % 2:
        raise ValueError(f"down_pool pools even heights and widths only, got "
                         f"{tuple(a.shape[2:])}")
    if a.numel() == 0:
        raise ValueError("down_pool of an empty tensor")


def _check_kernel_operand(name: str, t: torch.Tensor, layout: torch.memory_format) -> None:
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA pool takes float32 or bfloat16, got {name} in {t.dtype}")
    if not t.is_contiguous(memory_format=layout):
        raise ValueError(f"the CUDA pool takes NCHW-contiguous or channels_last-contiguous "
                         f"tensors, both in one layout; {name} has strides {t.stride()} for "
                         f"shape {tuple(t.shape)}")
    if t.data_ptr() % (2 * t.element_size()):
        raise ValueError(f"the CUDA pool takes tensors aligned to two elements; {name} "
                         f"starts at {t.data_ptr():#x}")


def down_pool_reference(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version, the composition ResNetBlockDown ran: `F.avg_pool2d`
    of each input, then the add."""
    out = F.avg_pool2d(a, 2)
    return out if b is None else out + F.avg_pool2d(b, 2)


def down_pool_bwd_reference(g: torch.Tensor) -> torch.Tensor:
    """The plain backward: g (N, C, H, W) / 4 into each position of its 2x2
    window of the (N, C, 2H, 2W) gradient; `F.avg_pool2d`'s backward, bit for
    bit (the division by 4 is exact)."""
    n, c, h, w = g.shape
    d = (g * 0.25)[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(n, c, 2 * h, 2 * w)
    return d.contiguous(memory_format=memory_format(g))


def _launch_forward(a: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    global launches, nhwc_launches
    _check(a, b)
    layout = memory_format(a)
    for name, t in (("a", a), ("b", b)):
        if t is not None:
            _check_kernel_operand(name, t, layout)
    n, c, h, w = a.shape
    out = torch.empty((n, c, h // 2, w // 2), dtype=a.dtype, device=a.device,
                      memory_format=layout)
    nhwc = layout == torch.channels_last
    lib = load_library()
    launch, sizes = ((lib.down_pool_nhwc_fwd, (n * (h // 2), w // 2, c)) if nhwc
                     else (lib.down_pool_fwd, (n * c * (h // 2), w // 2)))
    err = launch(a.data_ptr(), b.data_ptr() if b is not None else None, out.data_ptr(), *sizes,
                 _DTYPE_CODE[a.dtype], a.device.index,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"down_pool_fwd launch failed with CUDA error {err}")
    launches += 1
    nhwc_launches += nhwc
    return out


def _launch_backward(g: torch.Tensor) -> torch.Tensor:
    global bwd_launches, nhwc_bwd_launches
    if g.dim() != 4 or g.numel() == 0:
        raise ValueError(f"down_pool_bwd takes a non-empty (N, C, H, W) gradient, got "
                         f"{tuple(g.shape)}")
    layout = memory_format(g)
    _check_kernel_operand("g", g, layout)
    n, c, h, w = g.shape
    d = torch.empty((n, c, 2 * h, 2 * w), dtype=g.dtype, device=g.device, memory_format=layout)
    nhwc = layout == torch.channels_last
    lib = load_library()
    launch, sizes = ((lib.down_pool_nhwc_bwd, (n * h, w, c)) if nhwc
                     else (lib.down_pool_bwd, (n * c * h, w)))
    err = launch(g.data_ptr(), d.data_ptr(), *sizes, _DTYPE_CODE[g.dtype], g.device.index,
                 torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"down_pool_bwd launch failed with CUDA error {err}")
    bwd_launches += 1
    nhwc_bwd_launches += nhwc
    return d


@torch.library.custom_op("scrabblegan::down_pool", mutates_args=(), device_types="cuda")
def down_pool(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(pool(a) + pool(b)) as a registered op, b optional: on CUDA the
    kernel (float32 or bfloat16, NCHW-contiguous or channels_last-contiguous,
    the output in that layout; anything else raises), on the CPU the plain
    version; differentiable through `down_pool_bwd`."""
    return _launch_forward(a, b)


@down_pool.register_kernel("cpu")
def _down_pool_cpu(a, b=None):
    _check(a, b)
    return down_pool_reference(a, b)


@down_pool.register_fake
def _down_pool_fake(a, b=None):
    _check(a, b)
    n, c, h, w = a.shape
    return torch.empty((n, c, h // 2, w // 2), dtype=a.dtype, device=a.device,
                       memory_format=memory_format(a))


@torch.library.custom_op("scrabblegan::down_pool_bwd", mutates_args=(), device_types="cuda")
def down_pool_bwd(g: torch.Tensor) -> torch.Tensor:
    """The pool's backward as a registered op: g (N, C, H, W) -> the
    (N, C, 2H, 2W) gradient of each pooled input, in g's layout; on CUDA the
    kernel (g NCHW-contiguous or channels_last-contiguous), on the CPU the
    plain version."""
    return _launch_backward(g)


@down_pool_bwd.register_kernel("cpu")
def _down_pool_bwd_cpu(g):
    return down_pool_bwd_reference(g)


@down_pool_bwd.register_fake
def _down_pool_bwd_fake(g):
    n, c, h, w = g.shape
    return torch.empty((n, c, 2 * h, 2 * w), dtype=g.dtype, device=g.device,
                       memory_format=memory_format(g))


def _setup_context(ctx, inputs, output):
    ctx.two = inputs[1] is not None
    ctx.layout = memory_format(inputs[0])


def _backward(ctx, grad):
    # a gradient may arrive strided (a sum's backward); the inputs' layout
    d = down_pool_bwd(grad.contiguous(memory_format=ctx.layout))
    return d, d if ctx.two else None


torch.library.register_autograd("scrabblegan::down_pool", _backward,
                                setup_context=_setup_context)
