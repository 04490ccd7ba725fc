"""Spectrally normalized conv, transposed conv and dense layers, the plain
conv and dense layers of the recognizer, and the train-mode statistics record.

Port of scrabblegan_tpu/ops/layers.py (SNConv, SNConvTranspose, SNDense) and
of the flax `nn.Conv` / `nn.Dense` the recognizer uses. Parameters are
float32, as in flax; each call casts the normalized weight and the bias to the
layer's compute dtype, as flax's `dtype=` does.

Spectral norm follows flax `nn.SpectralNorm` (flax 0.12.3), not
`torch.nn.utils.parametrizations.spectral_norm`, which differs in the matrix
shape, the epsilon and when it iterates:
- the kernel is viewed as a (-1, out) matrix and u is (1, out);
- every call runs one power-iteration step from the stored u, eval included,
  in float32 with eps 1e-12, and divides by the sigma of that step; the stored
  `sigma` leaf is written in train mode and never read;
- u and v are constants for autograd (flax's `stop_gradient`), so the weight
  gradient flows through W and through sigma = v W u^T by W only.

Train-mode statistics (spectral norm's u and sigma here, batch norm's running
mean and variance in ops/blocks.py) are never written during a forward. A
layer in train mode proposes its new values to the record that
`record_stats()` opened, if any, and `commit_stats` writes a record into the
buffers. So every pass of a train step reads the statistics from the start of
the step, and the step commits only the passes whose statistics JAX keeps, as
`apply(..., mutable=['batch_stats'])` returns them (scrabblegan_tpu/train/
step.py). A pass outside any record discards its statistics.

Under tensor parallelism (parallel/tp.py) a layer whose kernel the layout
splits over the model axis computes this rank's output channels of the
whole normalised kernel and gathers them (`split_call`); otherwise, and in
one process, the call is the plain one.

The torch layouts are OIHW for a conv, (I, O, kh, kw) for a transposed conv
and (out, in) for a dense kernel. The transposed conv's kernel is stored
flipped in both spatial axes (see `SNConvTranspose`). Each layer names the
flax leaves it holds (`flax_leaves`), which `scrabblegan_torch.convert` maps.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections.abc import Iterator
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scrabblegan_torch.parallel.tp import split_call

SN_EPS = 1e-12


class FlaxLeaf(NamedTuple):
    """One leaf of a flax variable tree that a port module holds.

    `path` is relative to the module's flax scope, whose names the port's module
    names mirror. `attr` is the torch parameter or buffer it loads into.
    `layout` names the array transform in `scrabblegan_torch.convert`."""

    collection: str  # 'params' | 'batch_stats'
    path: tuple[str, ...]
    attr: str
    layout: str  # 'same' | 'conv' | 'conv_transpose' | 'dense'
    # flax's initializer of the leaf (scrabblegan_torch.train.state.init_fill):
    # 'orthogonal' | 'lecun_normal' | 'glorot_uniform' | 'normal' | 'zeros' | 'ones'
    init: str = "zeros"


StatRecord = dict[tuple[nn.Module, str], torch.Tensor]
_RECORD: contextvars.ContextVar[StatRecord | None] = contextvars.ContextVar(
    "scrabblegan_torch_stat_record", default=None)


@contextlib.contextmanager
def record_stats() -> Iterator[StatRecord]:
    """Collect the statistics the train-mode layers compute inside the block:
    {(module, buffer name): new value}, detached. Nothing is written."""
    record: StatRecord = {}
    token = _RECORD.set(record)
    try:
        yield record
    finally:
        _RECORD.reset(token)


def propose_stats(module: nn.Module, **values: torch.Tensor) -> None:
    """Offer a train-mode layer's new statistics to the open record, if any."""
    record = _RECORD.get()
    if record is not None:
        for name, value in values.items():
            record[(module, name)] = value.detach()


@torch.no_grad()
def commit_stats(record: StatRecord) -> None:
    """Write a record's statistics into the modules' buffers."""
    for (module, name), value in record.items():
        getattr(module, name).copy_(value)


def l2_normalize(x: torch.Tensor, eps: float = SN_EPS) -> torch.Tensor:
    """flax.linen.normalization._l2_normalize over the whole array."""
    return x * torch.rsqrt((x * x).sum() + eps)


class _SNLayer(nn.Module):
    """Weight, optional bias and the spectral-norm u vector and sigma of one
    layer."""

    flax_inner = ""  # the flax submodule wrapped by SpectralNorm; '' for a plain layer
    layout = ""
    out_axis = 0  # the torch weight's output-channel axis
    kernel_init = "orthogonal"  # scrabblegan_tpu.ops.layers.orthogonal_init
    tp_whole = False  # True: never split over the model axis (parallel/tp.py)

    def __init__(self, weight_shape: Sequence[int], features: int, use_bias: bool,
                 use_sn: bool, dtype: torch.dtype, device):
        super().__init__()
        self.use_sn = use_sn
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(tuple(weight_shape), device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)
        if use_sn:
            self.register_buffer("u", torch.zeros(1, features, device=device))
            self.register_buffer("sigma", torch.ones((), device=device))

    def normalized_weight(self) -> torch.Tensor:
        """W / sigma(W) in the compute dtype.

        One power-iteration step from the stored u, u and v held constant; in
        train mode the new u and sigma go to the open stat record. It is
        recomputed on each call, like flax does, rather than cached: three
        small matrix-vector products next to the layer's own work."""
        w = self.weight.float()
        if not self.use_sn:
            return w.to(self.dtype)
        u, sigma = self.power_iteration(w)
        if self.training:
            propose_stats(self, u=u, sigma=sigma)
        return (w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))).to(self.dtype)

    def power_iteration(self, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One step from the stored u on the float32 weight `w`: (new u,
        sigma), u constant for autograd, sigma differentiable in `w`."""
        # rows in torch order, a permutation of flax's (-1, out) rows: the
        # power iteration and sigma do not depend on the row order
        mat = w.movedim(self.out_axis, -1).reshape(-1, w.shape[self.out_axis])
        with torch.no_grad():
            v = l2_normalize(self.u.float() @ mat.T)
            u = l2_normalize(v @ mat)
        return u, ((v @ mat) @ u.T)[0, 0]

    def cast_bias(self) -> torch.Tensor | None:
        return None if self.bias is None else self.bias.to(self.dtype)

    def flax_leaves(self) -> list[FlaxLeaf]:
        scope = (self.flax_inner,) if self.flax_inner else ()
        leaves = [FlaxLeaf("params", (*scope, "kernel"), "weight", self.layout,
                           self.kernel_init)]
        if self.bias is not None:
            leaves.append(FlaxLeaf("params", (*scope, "bias"), "bias", "same"))
        if self.use_sn:
            stem = f"{self.flax_inner}/kernel"
            leaves += [
                FlaxLeaf("batch_stats", ("SpectralNorm_0", f"{stem}/u"), "u", "same", "normal"),
                FlaxLeaf("batch_stats", ("SpectralNorm_0", f"{stem}/sigma"), "sigma", "same",
                         "ones"),
            ]
        return leaves


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of one spatial axis under lax's 'SAME': the total
    max((ceil(n / s) - 1) * s + k - n, 0), the low side its floor half. On
    the even sizes a stride-2 3x3 conv meets that is (0, 1), where
    `F.conv2d(stride=2, padding=1)` pads (1, 1) and samples other pixels."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SNConv(_SNLayer):
    """Conv, 'SAME' (lax's padding, explicit, for any stride) or 'VALID'."""

    flax_inner = "Conv_0"
    layout = "conv"
    out_axis = 0

    def __init__(self, in_features: int, features: int,
                 kernel_size: tuple[int, int] = (3, 3), use_bias: bool = True,
                 use_sn: bool = True, dtype: torch.dtype = torch.float32,
                 device=None, padding: str = "same", strides: tuple[int, int] = (1, 1)):
        if padding not in ("same", "valid"):
            raise ValueError(f"padding must be 'same' or 'valid', got {padding!r}")
        super().__init__((features, in_features, *kernel_size), features,
                         use_bias, use_sn, dtype, device)
        self.padding = padding
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.padding == "same" and self.strides != (1, 1):
            (kh, kw), (sh, sw) = self.kernel_size, self.strides
            x = F.pad(x, (*same_padding(x.shape[3], kw, sw), *same_padding(x.shape[2], kh, sh)))
            conv = lambda x, w, b: F.conv2d(x, w, b, stride=self.strides)  # noqa: E731
        else:
            conv = lambda x, w, b: F.conv2d(x, w, b, padding=self.padding,  # noqa: E731
                                            stride=self.strides)
        return split_call(self, conv, x, self.normalized_weight(), self.cast_bias(), 0, 1)


class Conv(SNConv):
    """flax `nn.Conv` as the recognizer uses it: stride 1, bias, no spectral
    norm, lecun-normal kernel."""

    flax_inner = ""
    kernel_init = "lecun_normal"

    def __init__(self, in_features: int, features: int,
                 kernel_size: tuple[int, int] = (3, 3), padding: str = "same",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_features, features, kernel_size, use_bias=True, use_sn=False,
                         dtype=dtype, device=device, padding=padding)


def same_transpose_padding(k: int, s: int) -> tuple[int, int]:
    """(padding, output_padding) of F.conv_transpose2d for one spatial axis.

    lax.conv_transpose(padding='SAME'), which flax's ConvTranspose calls, is a
    correlation of the stride-dilated input, padded by (pad_a, pad_b), with the
    kernel as stored. F.conv_transpose2d correlates with the kernel flipped,
    padded by k-1-padding on the left, so with the flipped kernel stored,
    padding = k-1-pad_a aligns the first output, and output_padding supplies
    any right padding torch lacks. The output is then cropped to in*s: at
    k=3, s=2 torch gives one extra trailing row. Padding 1 with output padding
    1 instead would shift the output by one pixel."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    padding = k - 1 - pad_a
    return padding, max(0, s - k + 2 * padding)


class SNConvTranspose(_SNLayer):
    """Transposed conv whose output is exactly input * stride, as flax 'SAME'.

    The weight is (I, O, kh, kw) and holds the flax kernel flipped in both
    spatial axes (`scrabblegan_torch.convert` flips it). `lowering='subpixel'`
    is a TPU lowering of the same function; it computes the one transposed
    conv here."""

    flax_inner = "ConvTranspose_0"
    layout = "conv_transpose"
    out_axis = 1

    def __init__(self, in_features: int, features: int,
                 kernel_size: tuple[int, int] = (3, 3),
                 strides: tuple[int, int] = (2, 2), use_bias: bool = True,
                 use_sn: bool = True, lowering: str = "dilated",
                 dtype: torch.dtype = torch.float32, device=None):
        if lowering not in ("dilated", "subpixel"):
            raise ValueError(f"Unknown conv-transpose lowering: {lowering!r}")
        super().__init__((in_features, features, *kernel_size), features,
                         use_bias, use_sn, dtype, device)
        self.strides = tuple(strides)
        pads = [same_transpose_padding(k, s) for k, s in zip(kernel_size, strides)]
        self.padding = tuple(p for p, _ in pads)
        self.output_padding = tuple(o for _, o in pads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sh, sw = self.strides

        def conv(x, w, b):
            y = F.conv_transpose2d(x, w, b, stride=self.strides, padding=self.padding,
                                   output_padding=self.output_padding)
            return y[..., : x.shape[2] * sh, : x.shape[3] * sw]
        return split_call(self, conv, x.to(self.dtype), self.normalized_weight(),
                          self.cast_bias(), 1, 1)


class SNDense(_SNLayer):
    flax_inner = "Dense_0"
    layout = "dense"
    out_axis = 0

    def __init__(self, in_features: int, features: int, use_bias: bool = False,
                 use_sn: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__((features, in_features), features, use_bias, use_sn,
                         dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return split_call(self, F.linear, x.to(self.dtype), self.normalized_weight(),
                          self.cast_bias(), 0, -1)


class SNEmbedding(_SNLayer):
    """A lookup table (num_embeddings, features), spectrally normalised over
    the whole table as BigGAN's SNEmbedding is (its u has num_embeddings
    entries); `use_sn=False` is a plain embedding. Rows are gathered from the
    normalised table in the compute dtype."""

    def __init__(self, num_embeddings: int, features: int, use_sn: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__((num_embeddings, features), num_embeddings, False, use_sn, dtype,
                         device)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return F.embedding(y, self.normalized_weight())


class Dense(SNDense):
    """flax `nn.Dense` as the recognizer uses it: bias, no spectral norm,
    lecun-normal kernel."""

    flax_inner = ""
    kernel_init = "lecun_normal"

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_features, features, use_bias=True, use_sn=False, dtype=dtype,
                         device=device)


@torch.no_grad()
def init_power_iteration(module: nn.Module) -> None:
    """One committed power iteration on every spectrally normalised layer of
    `module`, as flax's `init` runs one (its `SpectralNorm` has no
    initialising guard and `create_train_state` inits with train=True): u
    becomes the normalised first iterate from the drawn u and sigma its
    estimate."""
    with record_stats() as record:
        for layer in module.modules():
            if isinstance(layer, _SNLayer) and layer.use_sn:
                u, sigma = layer.power_iteration(layer.weight.float())
                propose_stats(layer, u=u, sigma=sigma)
    commit_stats(record)
