"""Tensor (model) parallelism: output channels split over the 'model' axis.

Port of scrabblegan_tpu/parallel/tp.py. The rule (`leaf_tp_spec`) is JAX's,
on the flax shape of each leaf: a leaf of rank >= 2 and at least
`min_size` elements is split on its last axis, the output channels (a
conv's cout, a dense layer's out, the filter bank's 8192 seed axis), when
the model axis's size divides it; everything else stays whole.

JAX lets GSPMD keep the computation channel-sharded. Here a layer whose
kernel the rule splits computes only this rank's output channels, between
Megatron's two regions (`enter`, `leave`):
- entering: the identity forward; the backward sums the input's gradient
  over the model axis (each rank's channels contribute a part);
- leaving: the channels all-gathered forward; the backward takes this
  rank's own slice of the gradient, since every model rank runs the same
  layers after it on the whole activation. (An all-gather whose backward
  reduce-scatters would count that gradient once per model rank.)
So the activations between layers are whole on every model rank: batch
norm and the losses run there as in one process (their data-axis
all-reduce still applies). The layer adds this rank's slice of the bias
inside its own call, as the whole layer adds the bias (one rounding in
bf16); the bias enters the region as the input does.
Spectral norm is one sigma of the whole kernel: the layer sees the whole
kernel (parallel/fsdp.py `gathered_params`), so its power iteration, u and
sigma are the single process's, and takes the normalised kernel's slice.

The layers that split (`SPLIT_TYPES`): SNConv, SNConvTranspose, SNDense
(the recognizers' Conv and Dense among them, the CBN's gamma and beta),
and the filter bank, whose slice of the 8192 axis is gathered back before
the seed reshape (that reshape's NHWC order is not a slice of the NCHW
channels). Layers the port cannot split run whole on the gathered kernel:
the LSTM cells stacked for `torch.lstm` and the attention block's 1x1
convs, which feed the CUDA kernels whole tensors (`tp_whole`).
"""

from __future__ import annotations

import dataclasses

import torch

from scrabblegan_torch.parallel import mesh as pmesh


def leaf_tp_spec(mesh_shape, shape, min_size: int = 4096, axis: str = "model") -> tuple:
    """JAX's `leaf_tp_sharding`: the output-channel (last) axis, or ()."""
    mp = mesh_shape.get(axis, 1)
    size = 1
    for d in shape:
        size *= d
    if mp > 1 and size >= min_size and len(shape) >= 2 and shape[-1] % mp == 0:
        spec = [None] * len(shape)
        spec[-1] = axis
        return tuple(spec)
    return ()


@dataclasses.dataclass(frozen=True)
class Split:
    """A layer's place on the model axis."""

    rank: int
    size: int
    group: object


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return pmesh.all_reduce(grad.contiguous().clone(), ctx.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim, group):
        ctx.dim, ctx.group = dim, group
        return pmesh.all_gather(y, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return pmesh.piece(grad, ctx.dim, ctx.group), None, None


def split_of(module) -> Split | None:
    """The layer's split in the open parallel step, or None (whole)."""
    ctx = pmesh.current()
    return None if ctx is None else ctx.split.get(module)


def split_call(module, fn, x, weight, bias, w_axis: int, y_axis: int):
    """fn(x, weight, bias): whole, or, for a split layer, on this rank's
    output channels (`weight` sliced along `w_axis`, the 1-D bias with it),
    the output's channels (`y_axis`) gathered."""
    split = split_of(module)
    if split is None:
        return fn(x, weight, bias)
    if bias is not None:
        bias = _Enter.apply(bias, split.group).chunk(split.size)[split.rank]
    y = fn(_Enter.apply(x, split.group), weight.chunk(split.size, w_axis)[split.rank], bias)
    return _Leave.apply(y, y_axis % y.dim(), split.group)


def split_modules(models, layout) -> dict:
    """{module: Split} of every layer of `models` (a ModelBundle) whose
    kernel the layout splits over the model axis and that can split."""
    from scrabblegan_torch.ops.embedding import FilterBank
    from scrabblegan_torch.ops.layers import SNConv, SNConvTranspose, SNDense

    mesh = layout.mesh
    if mesh.size("model") == 1:
        return {}
    out = {}
    from scrabblegan_torch.train.state import NETWORKS

    for net, (_, module) in zip(NETWORKS, models.items()):
        for name, places in zip(layout.names[net], layout.places[net]):
            owner_name, _, attr = name.rpartition(".")
            owner = module.get_submodule(owner_name) if owner_name else module
            if (attr in ("weight", "bank") and any(a == "model" for _, a in places)
                    and isinstance(owner, (SNConv, SNConvTranspose, SNDense, FilterBank))
                    and not getattr(owner, "tp_whole", False)):
                out[owner] = Split(mesh.rank("model"), mesh.size("model"), mesh.group("model"))
    return out
