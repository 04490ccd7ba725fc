"""The style promoter W, NCHW.

Port of scrabblegan_tpu/models/style.py (`StylePromoter`): a third adversary
with the discriminator's architecture and flax scope names (trunk, head) and
parameters of its own, trained to tell target-style images from others;
and `StyleExtractor`, built nowhere on the train path, in JAX or here: the
down trunk on the plain attention path and an SN-Dense(128) style
embedding, float32 out.
"""

from __future__ import annotations

import torch
from torch import nn

from scrabblegan_torch.models.discriminator import Discriminator, DownTrunk
from scrabblegan_torch.models.generator import disc_channels
from scrabblegan_torch.ops.layers import SNDense


class StylePromoter(Discriminator):
    """W: x (B, C, 32, W) -> logits (B,), float32."""


class StyleExtractor(nn.Module):
    """x (B, C, 32, W) -> style embedding (B, embedding_dim), float32."""

    def __init__(self, embedding_dim: int = 128, img_channels: int = 1,
                 blocks_with_attention: str = "B1", use_sn: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.trunk = DownTrunk(img_channels, blocks_with_attention, use_sn, use_kernel=False,
                               dtype=dtype, device=device)
        self.head = SNDense(disc_channels(img_channels)[1][-1], embedding_dim, use_sn=use_sn,
                            dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(x)).float()
