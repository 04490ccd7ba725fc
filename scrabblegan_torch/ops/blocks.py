"""BigGAN-style ResNet blocks, batch norm and conditional batch norm, NCHW.

Port of scrabblegan_tpu/ops/blocks.py (ConditionalBatchNorm, ResNetBlockUp,
ResNetBlockDown) and of flax `nn.BatchNorm` as the repo uses it (defaults:
momentum 0.99, eps 1e-5).

- Eval mode normalises by the running `mean`/`var` from `batch_stats`, in
  float32, cast to the compute dtype.
- Train mode normalises by the batch statistics over (N, H, W), in float32,
  with flax's fast variance max(0, E[x^2] - E[x]^2), and proposes the running
  update ra = 0.99 ra + 0.01 stat with the biased variance to the open stat
  record (ops/layers.py `record_stats`); nothing is written during the
  forward. In a parallel step the moments are the global batch's
  (parallel/mesh.py `global_moments`), so every rank commits the same
  statistics. `F.batch_norm(training=True)` is not used: it updates the running
  variance with the unbiased variance, in place, on every call.

BigGAN's blocks (models/biggan.py) take the same classes through options:
a batch norm `momentum` (BigGAN's PyTorch momentum 0.1 is flax's 0.9), a
CBN gain of 1 + the gamma layer (`gain_offset`), an up-block that upsamples
by nearest neighbours before plain SN convs (`upsample='nearest'`), and a
down-block without the first ReLU whose skip pools before its conv
(`preactivation=False`) or is the identity (`learnable_skip=False`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scrabblegan_torch.kernels.pool import down_pool
from scrabblegan_torch.ops.layers import (FlaxLeaf, SNConv, SNConvTranspose, SNDense,
                                          propose_stats)
from scrabblegan_torch.parallel.mesh import global_moments
from scrabblegan_torch.utils.layout import memory_format

BN_EPS = 1e-5
BN_MOMENTUM = 0.99


def batch_norm_eval(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                    scale: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias over channel axis 1, with
    float32 statistics; the result keeps x's dtype."""
    return F.batch_norm(x, mean, var, scale, bias, training=False, eps=BN_EPS)


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor | None = None,
                     bias: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """flax BatchNorm's train-mode forward over channel axis 1: returns (y in
    x's dtype, batch mean, biased batch variance), the statistics in float32
    and differentiable, as flax's `_compute_stats` and `_normalize` do."""
    xf = x.float()
    mean, mean_sq = global_moments(xf, (0, 2, 3))  # over the global batch in a parallel step
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    mul = torch.rsqrt(var + BN_EPS)
    if scale is not None:
        mul = mul * scale
    y = (xf - mean[None, :, None, None]) * mul[None, :, None, None]
    if bias is not None:
        y = y + bias[None, :, None, None]
    return y.to(x.dtype), mean, var


class _BatchNormStats(nn.Module):
    """The running statistics of a batch norm and its normalisation."""

    def __init__(self, features: int, device=None, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.momentum = momentum
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def normalize(self, x: torch.Tensor, scale: torch.Tensor | None = None,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
        if not self.training:
            return batch_norm_eval(x, self.running_mean, self.running_var, scale, bias)
        y, mean, var = batch_norm_train(x, scale, bias)
        with torch.no_grad():
            propose_stats(
                self,
                running_mean=self.momentum * self.running_mean + (1 - self.momentum) * mean,
                running_var=self.momentum * self.running_var + (1 - self.momentum) * var)
        return y


class BatchNorm(_BatchNormStats):
    """flax nn.BatchNorm with scale and bias."""

    def __init__(self, features: int, device=None, momentum: float = BN_MOMENTUM):
        super().__init__(features, device, momentum)
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def flax_leaves(self) -> list[FlaxLeaf]:
        return [FlaxLeaf("params", ("scale",), "weight", "same", "ones"),
                FlaxLeaf("params", ("bias",), "bias", "same"),
                FlaxLeaf("batch_stats", ("mean",), "running_mean", "same"),
                FlaxLeaf("batch_stats", ("var",), "running_var", "same", "ones")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.normalize(x, self.weight, self.bias)


class ConditionalBatchNorm(_BatchNormStats):
    """Non-affine batch norm, then gamma and beta from SN-Dense layers on the
    conditioning vector: h * (gain_offset + gamma) + beta, per channel
    (`gain_offset` 1 is BigGAN's gain)."""

    def __init__(self, features: int, cond_features: int, use_sn: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 momentum: float = BN_MOMENTUM, gain_offset: float = 0.0):
        super().__init__(features, device, momentum)
        self.gain_offset = gain_offset
        self.gamma = SNDense(cond_features, features, use_sn=use_sn, dtype=dtype,
                             device=device)
        self.beta = SNDense(cond_features, features, use_sn=use_sn, dtype=dtype,
                            device=device)

    def flax_leaves(self) -> list[FlaxLeaf]:
        return [FlaxLeaf("batch_stats", ("BatchNorm_0", "mean"), "running_mean", "same"),
                FlaxLeaf("batch_stats", ("BatchNorm_0", "var"), "running_var", "same",
                         "ones")]

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.normalize(x)
        gamma = self.gamma(cond)[:, :, None, None]
        if self.gain_offset:
            gamma = gamma + self.gain_offset
        beta = self.beta(cond)[:, :, None, None]
        return h * gamma + beta


class ResNetBlockUp(nn.Module):
    """CBN -> relu -> 3x3 transposed conv -> CBN -> relu -> 3x3 conv, plus a
    1x1 transposed-conv skip. Strides (2, 2), or (2, 1) on the last block, so
    that the generator's width is 16 px per character.

    `upsample='nearest'` is BigGAN's GBlock: a 2x nearest-neighbour upsample
    of both paths, then `upconv` and `skip` are plain 3x3 and 1x1 SN convs.
    `cbn` holds further options of both CBNs (momentum, gain_offset)."""

    def __init__(self, in_features: int, features: int, cond_features: int,
                 is_last_block: bool = False, use_sn: bool = True,
                 conv_lowering: str = "dilated", dtype: torch.dtype = torch.float32,
                 device=None, upsample: str = "transpose", cbn: dict | None = None):
        super().__init__()
        if upsample not in ("transpose", "nearest"):
            raise ValueError(f"Unknown upsample {upsample!r}")
        self.upsample = upsample
        strides = (2, 1) if is_last_block else (2, 2)
        kw = dict(use_sn=use_sn, dtype=dtype, device=device)
        self.cbn1 = ConditionalBatchNorm(in_features, cond_features, **kw, **(cbn or {}))
        if upsample == "nearest":
            self.upconv = SNConv(in_features, features, (3, 3), **kw)
        else:
            self.upconv = SNConvTranspose(in_features, features, (3, 3), strides,
                                          lowering=conv_lowering, **kw)
        self.cbn2 = ConditionalBatchNorm(features, cond_features, **kw, **(cbn or {}))
        self.conv = SNConv(features, features, (3, 3), **kw)
        if upsample == "nearest":
            self.skip = SNConv(in_features, features, (1, 1), **kw)
        else:
            self.skip = SNConvTranspose(in_features, features, (1, 1), strides,
                                        lowering=conv_lowering, **kw)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.cbn1(x, cond))
        if self.upsample == "nearest":
            h, x = (F.interpolate(t, scale_factor=2, mode="nearest") for t in (h, x))
        h = self.upconv(h)
        h = torch.relu(self.cbn2(h, cond))
        h = self.conv(h)
        return h + self.skip(x)


class ResNetBlockDown(nn.Module):
    """relu -> 3x3 SN conv -> relu -> 3x3 SN conv -> 2x2 average pool, plus a
    1x1 SN conv skip with the same pool; no pool on the last block. No
    normalisation, like BigGAN's D blocks.

    BigGAN's first D block (`preactivation=False`) has no first relu and its
    skip pools before the conv; its last (`learnable_skip=False`, no pool)
    adds its input as it is.

    flax's 'SAME' 2x2/2 average pool equals `F.avg_pool2d(2)` on even heights
    and widths, which is every shape the networks give it; an odd one
    raises rather than silently pooling differently. The pools and the sum of
    the two pooled paths are `kernels/pool.py`'s `down_pool`: on a card one
    CUDA pass forward and one backward, on the CPU the plain composition.
    The pool takes the layout of the block's input: channels_last where x is
    channels_last and not NCHW-contiguous (BigGAN's D), else NCHW (every
    ScrabbleGAN network, one-channel images included)."""

    def __init__(self, in_features: int, features: int, is_last_block: bool = False,
                 use_sn: bool = True, dtype: torch.dtype = torch.float32, device=None,
                 preactivation: bool = True, learnable_skip: bool = True):
        super().__init__()
        if not learnable_skip and (in_features != features or not is_last_block):
            raise ValueError("an identity skip needs as many features out as in and no pool")
        kw = dict(use_sn=use_sn, dtype=dtype, device=device)
        self.is_last_block = is_last_block
        self.preactivation = preactivation
        self.conv1 = SNConv(in_features, features, (3, 3), **kw)
        self.conv2 = SNConv(features, features, (3, 3), **kw)
        self.skip = SNConv(in_features, features, (1, 1), **kw) if learnable_skip else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(torch.relu(x) if self.preactivation else x)
        h = self.conv2(torch.relu(h))
        if self.is_last_block:
            return h + (x if self.skip is None else self.skip(x))
        layout = memory_format(x)
        if self.preactivation:
            return down_pool(_laid_out(h, layout), _laid_out(self.skip(x), layout))
        return down_pool(_laid_out(h, layout)) + self.skip(down_pool(_laid_out(x, layout)))


def _laid_out(t: torch.Tensor, layout: torch.memory_format) -> torch.Tensor:
    """t as the tensor the pool takes in `layout`: a copy only where a conv
    returned another layout (a conv of one-channel images, an NCHW view of
    NHWC, comes back channels_last). The copy's gradient then goes back in
    t's layout, as `F.avg_pool2d`'s backward gave it, so the conv's backward
    sums what it summed before, in the same order."""
    if t.is_contiguous(memory_format=layout):
        return t
    if t.requires_grad:
        own = (torch.channels_last if t.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        t.register_hook(lambda g: g.contiguous(memory_format=own))
    return t.contiguous(memory_format=layout)
