"""SAGAN non-local (self-attention) block, NCHW.

Port of scrabblegan_tpu/ops/attention.py (NonLocalBlock): 1x1 SN convs theta
(C/8), phi (C/8) and g (C/2); 2x2 max-pool of phi and g; the softmax core;
the out 1x1 SN conv; `sigma * out + x`. Train mode is the SN layers' (their
new u and sigma go to the open stat record); the core carries gradients on
both of its paths.

The three projections run as one 1x1 conv on their concatenated weights (x is
read once, as in the JAX 'nhwc1' dataflow). An NCHW activation (B, C, H, W)
viewed as (B, C, H*W) is already the core's channel-packed layout, and its
query order h*W + w is the JAX NHWC flatten order, so no transposes are needed.
The JAX dataflows 'nhwc', 'nhwc1' and 'packed' are layouts of this one
function. 'fused' would need the fused-block kernel, which is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scrabblegan_torch.kernels.attention import attention_reference, nonlocal_attention_packed
from scrabblegan_torch.ops.layers import FlaxLeaf, SNConv

DATAFLOWS = ("nhwc", "nhwc1", "packed")


class NonLocalBlock(nn.Module):
    """`use_kernel` selects the attention core: the CUDA kernels for a CUDA
    tensor (the plain version for a CPU one), or always the plain version.
    JAX's G B3 and D/W B1 blocks take `use_pallas_attention`; its style
    encoder's block is built without it and takes the plain core."""

    def __init__(self, features: int, use_sn: bool = True, use_kernel: bool = True,
                 dataflow: str = "nhwc1", dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if dataflow == "fused":
            raise NotImplementedError(
                "dataflow 'fused' needs the fused-block kernel (_fused_block_kernel), "
                "which is not ported yet")
        if dataflow not in DATAFLOWS:
            raise ValueError(f"Unknown attention dataflow: {dataflow!r}")
        self.use_kernel = use_kernel
        self.dtype = dtype
        c_attn, c_g = features // 8, features // 2
        kw = dict(use_bias=False, use_sn=use_sn, dtype=dtype, device=device)
        self.theta = SNConv(features, c_attn, (1, 1), **kw)
        self.phi = SNConv(features, c_attn, (1, 1), **kw)
        self.g = SNConv(features, c_g, (1, 1), **kw)
        self.out = SNConv(c_g, features, (1, 1), **kw)
        self.sigma = nn.Parameter(torch.zeros((), device=device))

    def flax_leaves(self) -> list[FlaxLeaf]:
        return [FlaxLeaf("params", ("sigma",), "sigma", "same")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        c_attn = c // 8
        w3 = torch.cat([conv.normalized_weight() for conv in (self.theta, self.phi, self.g)])
        proj = F.conv2d(x, w3)  # (B, 2*Ca + Cg, H, W)
        thetaT = proj[:, :c_attn].reshape(b, c_attn, h * w)  # a view: batch-strided
        pooled = F.max_pool2d(proj[:, c_attn:], 2)  # (B, Ca + Cg, H/2, W/2)
        phiT = pooled[:, :c_attn].reshape(b, c_attn, -1)
        gT = pooled[:, c_attn:].reshape(b, c // 2, -1)
        core = nonlocal_attention_packed if self.use_kernel else attention_reference
        attn_g = core(thetaT, phiT, gT).reshape(b, -1, h, w)
        return self.sigma.to(self.dtype) * self.out(attn_g) + x
