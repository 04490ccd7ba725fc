"""SAGAN non-local (self-attention) block, NCHW.

Port of scrabblegan_tpu/ops/attention.py (NonLocalBlock): 1x1 SN convs theta
(C/8), phi (C/8) and g (C/2); 2x2 max-pool of phi and g; the softmax core;
the out 1x1 SN conv; `sigma * out + x`. Train mode is the SN layers' (their
new u and sigma go to the open stat record); every path carries gradients.

`dataflow` selects how the ops around the core run, as in JAX; '' resolves,
at each call, to $SCRABBLEGAN_ATTN_DATAFLOW or 'nhwc1', JAX's own selector.
All compute the same function on one parameter tree:
- 'nhwc1' and 'nhwc' (two layouts of one function here): the three
  projections as one 1x1 conv on their concatenated weights, the core, the
  out conv, `sigma * out + x`. An NCHW activation (B, C, H, W) viewed as
  (B, C, H*W) is already the core's channel-packed layout, and its query
  order h*W + w is the JAX NHWC flatten order, so no transposes are needed;
- 'packed': phi and g from one 1x1 conv and the pool; then the theta
  projection, the core, the out projection with sigma folded into its
  weight, and the residual, as JAX's composition `fused_nonlocal_block(...,
  fuse=False)` rounds them (kernels/fused_block.py);
- 'fused': the same, with theta, the core, the out projection and the
  residual in one CUDA kernel on a card.
With `use_kernel` False every dataflow takes the plain path, as JAX's blocks
built without `use_pallas` do.

A channels_last x (BigGAN's trunks) keeps its layout through 'nhwc1' and
'nhwc': the projections come out channels_last, so theta and the pooled phi
and g are copied into the dense per-batch (C, N) blocks the kernels take,
and the core's output is laid out channels_last for the out conv. 'packed'
and 'fused' take such an x as an NCHW copy.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from scrabblegan_torch.kernels.attention import attention_reference, nonlocal_attention_packed
from scrabblegan_torch.kernels.fused_block import fused_nonlocal_block
from scrabblegan_torch.ops.layers import FlaxLeaf, SNConv
from scrabblegan_torch.utils.layout import memory_format

DATAFLOWS = ("nhwc", "nhwc1", "packed", "fused")


def resolve_dataflow(dataflow: str) -> str:
    """`dataflow`, or $SCRABBLEGAN_ATTN_DATAFLOW or 'nhwc1' for ''; raises
    on an unknown name."""
    dataflow = dataflow or os.environ.get("SCRABBLEGAN_ATTN_DATAFLOW", "nhwc1")
    if dataflow not in DATAFLOWS:
        raise ValueError(f"Unknown attention dataflow: {dataflow!r}")
    return dataflow


class NonLocalBlock(nn.Module):
    """`use_kernel` selects the kernels: the CUDA ones for a CUDA tensor (the
    plain version for a CPU one), or always the plain path. JAX's G B3 and
    D/W B1 blocks take `use_pallas_attention`; its style encoder's block is
    built without it and takes the plain path."""

    def __init__(self, features: int, use_sn: bool = True, use_kernel: bool = True,
                 dataflow: str = "", dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if dataflow:
            resolve_dataflow(dataflow)
        self.dataflow = dataflow
        self.use_kernel = use_kernel
        self.dtype = dtype
        c_attn, c_g = features // 8, features // 2
        kw = dict(use_bias=False, use_sn=use_sn, dtype=dtype, device=device)
        self.theta = SNConv(features, c_attn, (1, 1), **kw)
        self.phi = SNConv(features, c_attn, (1, 1), **kw)
        self.g = SNConv(features, c_g, (1, 1), **kw)
        self.out = SNConv(c_g, features, (1, 1), **kw)
        for conv in (self.theta, self.phi, self.g, self.out):
            conv.tp_whole = True  # whole tensors for the kernels (parallel/tp.py)
        self.sigma = nn.Parameter(torch.zeros((), device=device))

    def flax_leaves(self) -> list[FlaxLeaf]:
        return [FlaxLeaf("params", ("sigma",), "sigma", "same")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dataflow = resolve_dataflow(self.dataflow)
        b, c, h, w = x.shape
        c_attn = c // 8
        if self.use_kernel and dataflow in ("packed", "fused"):
            x = x.contiguous()
            w_theta, w_phi, w_g, w_out = (conv.normalized_weight()[:, :, 0, 0] for conv in
                                          (self.theta, self.phi, self.g, self.out))
            pooled = F.max_pool2d(F.conv2d(x, torch.cat([w_phi, w_g])[:, :, None, None]), 2)
            phiT = pooled[:, :c_attn].reshape(b, c_attn, -1)  # views: batch-strided
            gT = pooled[:, c_attn:].reshape(b, c // 2, -1)
            out = fused_nonlocal_block(x.reshape(b, c, h * w), w_theta.t(), phiT, gT,
                                       w_out.t(), self.sigma.to(self.dtype),
                                       fuse=dataflow == "fused")
            return out.reshape(b, c, h, w)
        w3 = torch.cat([conv.normalized_weight() for conv in (self.theta, self.phi, self.g)])
        proj = F.conv2d(x, w3)  # (B, 2*Ca + Cg, H, W)
        thetaT = proj[:, :c_attn].reshape(b, c_attn, h * w)  # a view: batch-strided
        pooled = F.max_pool2d(proj[:, c_attn:], 2)  # (B, Ca + Cg, H/2, W/2)
        phiT = pooled[:, :c_attn].reshape(b, c_attn, -1)
        gT = pooled[:, c_attn:].reshape(b, c // 2, -1)
        if self.use_kernel:
            attn_g = nonlocal_attention_packed(*(_dense(t) for t in (thetaT, phiT, gT)))
            attn_g = attn_g.reshape(b, -1, h, w).contiguous(memory_format=memory_format(x))
        else:
            attn_g = attention_reference(thetaT, phiT, gT).reshape(b, -1, h, w)
        return self.sigma.to(self.dtype) * self.out(attn_g) + x


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t (B, C, N) with each batch's (C, N) block dense, as the kernels take
    it: t itself where it is (an NCHW projection's view, batch-strided), a
    copy where a channels_last projection strides it."""
    return t if t.stride(2) == 1 and t.stride(1) == t.shape[2] else t.contiguous()
