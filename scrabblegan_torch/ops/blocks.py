"""BigGAN-style up block and conditional batch norm (eval mode), NCHW.

Port of scrabblegan_tpu/ops/blocks.py (ConditionalBatchNorm, ResNetBlockUp).
ResNetBlockDown, which only the discriminators and the style encoder use, is
not ported yet.

Batch norm follows flax `nn.BatchNorm` in eval mode: eps 1e-5, the running
`mean`/`var` from `batch_stats`, computed in float32 and cast to the compute
dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scrabblegan_torch.ops.layers import FlaxLeaf, SNConv, SNConvTranspose, SNDense

BN_EPS = 1e-5


def batch_norm_eval(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                    scale: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias over channel axis 1, with
    float32 statistics; the result keeps x's dtype."""
    return F.batch_norm(x, mean, var, scale, bias, training=False, eps=BN_EPS)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm (scale and bias on) in eval mode."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def flax_leaves(self) -> list[FlaxLeaf]:
        return [FlaxLeaf("params", ("scale",), "weight", "same"),
                FlaxLeaf("params", ("bias",), "bias", "same"),
                FlaxLeaf("batch_stats", ("mean",), "running_mean", "same"),
                FlaxLeaf("batch_stats", ("var",), "running_var", "same")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm_eval(x, self.running_mean, self.running_var,
                               self.weight, self.bias)


class ConditionalBatchNorm(nn.Module):
    """Non-affine batch norm, then gamma and beta from SN-Dense layers on the
    conditioning vector: h * gamma + beta, per channel."""

    def __init__(self, features: int, cond_features: int, use_sn: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))
        self.gamma = SNDense(cond_features, features, use_sn=use_sn, dtype=dtype,
                             device=device)
        self.beta = SNDense(cond_features, features, use_sn=use_sn, dtype=dtype,
                            device=device)

    def flax_leaves(self) -> list[FlaxLeaf]:
        return [FlaxLeaf("batch_stats", ("BatchNorm_0", "mean"), "running_mean", "same"),
                FlaxLeaf("batch_stats", ("BatchNorm_0", "var"), "running_var", "same")]

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = batch_norm_eval(x, self.running_mean, self.running_var)
        gamma = self.gamma(cond)[:, :, None, None]
        beta = self.beta(cond)[:, :, None, None]
        return h * gamma + beta


class ResNetBlockUp(nn.Module):
    """CBN -> relu -> 3x3 transposed conv -> CBN -> relu -> 3x3 conv, plus a
    1x1 transposed-conv skip. Strides (2, 2), or (2, 1) on the last block, so
    that the generator's width is 16 px per character."""

    def __init__(self, in_features: int, features: int, cond_features: int,
                 is_last_block: bool = False, use_sn: bool = True,
                 conv_lowering: str = "dilated", dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        strides = (2, 1) if is_last_block else (2, 2)
        kw = dict(use_sn=use_sn, dtype=dtype, device=device)
        self.cbn1 = ConditionalBatchNorm(in_features, cond_features, **kw)
        self.upconv = SNConvTranspose(in_features, features, (3, 3), strides,
                                      lowering=conv_lowering, **kw)
        self.cbn2 = ConditionalBatchNorm(features, cond_features, **kw)
        self.conv = SNConv(features, features, (3, 3), **kw)
        self.skip = SNConvTranspose(in_features, features, (1, 1), strides,
                                    lowering=conv_lowering, **kw)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.cbn1(x, cond))
        h = self.upconv(h)
        h = torch.relu(self.cbn2(h, cond))
        h = self.conv(h)
        return h + self.skip(x)
