"""The BigGAN discriminator D and its down trunk, NCHW.

Port of scrabblegan_tpu/models/discriminator.py (`_DownTrunk`,
`Discriminator`): four ResNetBlockDown (64/512/1024/1024), non-local
attention after the blocks named in `blocks_with_attention` (B1), relu, a
global average pool accumulated in float32 (masked by width in 'padded'
shape mode), and an SN-Dense(1) head whose logits are float32. Fully
convolutional over width: one parameter set serves every word length.

The DCGAN variant (`shared.my_disc`, `DCGANDiscriminator`): four stride-2
3x3 'SAME' SN convs (16/32/64/128), each followed by LeakyReLU 0.3 (keras'
default slope), a plain-path non-local block after the second (JAX builds
it without `use_pallas`), a second LeakyReLU after the loop, a float32 GAP
and the SN-Dense(1) head. It takes `width_mask` and ignores it, as JAX does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scrabblegan_torch.models.generator import disc_channels
from scrabblegan_torch.ops.attention import NonLocalBlock
from scrabblegan_torch.ops.blocks import ResNetBlockDown
from scrabblegan_torch.ops.layers import SNConv, SNDense


class DownTrunk(nn.Module):
    """x (B, C, 32, W) -> pooled features (B, 1024), float32."""

    def __init__(self, img_channels: int = 1, blocks_with_attention: str = "B1",
                 use_sn: bool = True, use_kernel: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        ins, outs = disc_channels(img_channels)
        kw = dict(use_sn=use_sn, dtype=dtype, device=device)
        self.names = [f"B{idx + 1}" for idx in range(len(outs))]
        self.attention_after = [n for n in self.names if n in blocks_with_attention]
        for idx, (name, cin, cout) in enumerate(zip(self.names, ins, outs)):
            self.add_module(f"block_{name}", ResNetBlockDown(
                cin, cout, is_last_block=idx == len(outs) - 1, **kw))
            if name in self.attention_after:
                self.add_module(f"attn_{name}", NonLocalBlock(cout, use_kernel=use_kernel, **kw))

    def forward(self, x: torch.Tensor, width_mask: torch.Tensor | None = None) -> torch.Tensor:
        """width_mask: optional (B, W_feat) in {0, 1} over the last block's
        width ('padded' mode); the pool then averages the unmasked columns,
        over H * sum(mask) values clipped at 1."""
        net = x.to(self.dtype)
        for name in self.names:
            net = getattr(self, f"block_{name}")(net)
            if name in self.attention_after:
                net = getattr(self, f"attn_{name}")(net)
        net = torch.relu(net).float()
        if width_mask is None:
            return net.mean(dim=(2, 3))
        m = width_mask.float()[:, None, None, :]  # (B, 1, 1, W)
        denom = (net.shape[2] * width_mask.float().sum(dim=1)).clamp(min=1.0)
        return (net * m).sum(dim=(2, 3)) / denom[:, None]


class Discriminator(nn.Module):
    """D: the down trunk and an SN-Dense(1) logit head; x (B, C, 32, W) ->
    logits (B,), float32."""

    def __init__(self, img_channels: int = 1, blocks_with_attention: str = "B1",
                 use_sn: bool = True, use_kernel: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.trunk = DownTrunk(img_channels, blocks_with_attention, use_sn, use_kernel,
                               dtype, device)
        self.head = SNDense(disc_channels(img_channels)[1][-1], 1, use_sn=use_sn,
                            dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, width_mask: torch.Tensor | None = None) -> torch.Tensor:
        return self.head(self.trunk(x, width_mask))[:, 0].float()


class DCGANDiscriminator(nn.Module):
    """D for `shared.my_disc`: x (B, C, 32, W) -> logits (B,), float32."""

    FEATURES = (16, 32, 64, 128)

    def __init__(self, img_channels: int = 1, use_sn: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(use_sn=use_sn, dtype=dtype, device=device)
        cin = img_channels
        for idx, feats in enumerate(self.FEATURES, start=1):
            self.add_module(f"conv{idx}", SNConv(cin, feats, (3, 3), strides=(2, 2), **kw))
            cin = feats
        self.attn_B1 = NonLocalBlock(self.FEATURES[1], use_kernel=False, **kw)
        self.head = SNDense(cin, 1, **kw)

    def forward(self, x: torch.Tensor, width_mask: torch.Tensor | None = None) -> torch.Tensor:
        net = x.to(self.dtype)
        for idx in range(1, len(self.FEATURES) + 1):
            net = F.leaky_relu(getattr(self, f"conv{idx}")(net), 0.3)
            if idx == 2:
                net = self.attn_B1(net)
        net = F.leaky_relu(net, 0.3).float().mean(dim=(2, 3))
        return self.head(net)[:, 0].float()
