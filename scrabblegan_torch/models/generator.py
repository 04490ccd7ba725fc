"""The ScrabbleGAN generator with the noise z source, NCHW, eval mode.

Port of scrabblegan_tpu/models/generator.py (Generator, z_source='noise'):
z (B, 128) is split 4 x 32; z0 contracts the filter bank into one 4x4x512
seed per character, laid side by side along the width; three CBN up-blocks
conditioned on z1..z3 (channels 256/128/64, strides (2,2), (2,2), (2,1));
non-local attention after B3; final BN, relu, 3x3 SN conv, tanh. Labels
(B, L) give images (B, C, 32, 16L) in [-1, 1].

The style z source needs ResNetBlockDown and is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from scrabblegan_torch.ops.attention import NonLocalBlock
from scrabblegan_torch.ops.blocks import BatchNorm, ResNetBlockUp
from scrabblegan_torch.ops.embedding import FilterBank
from scrabblegan_torch.ops.layers import SNConv

GEN_IN_CHANNELS = (512, 256, 128)  # scrabblegan_tpu gen_channels(32)
GEN_OUT_CHANNELS = (256, 128, 64)


class Generator(nn.Module):
    """`num_pad_tokens=1` adds the filter bank's PAD row ('padded' shape mode).
    `use_kernel` picks the attention core (see NonLocalBlock)."""

    def __init__(self, vocab_size: int, latent_dim: int = 128,
                 embed_y: tuple[int, int] = (32, 8192),
                 blocks_with_attention: str = "B3", z_source: str = "noise",
                 img_channels: int = 1, img_height: int = 32, use_sn: bool = True,
                 use_kernel: bool = True, conv_lowering: str = "dilated",
                 num_pad_tokens: int = 0, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if z_source == "style":
            raise NotImplementedError(
                "z_source='style' needs the style encoder (ResNetBlockDown), "
                "which is not ported yet")
        if z_source != "noise":
            raise ValueError(f"Unknown z_source: {z_source!r}")
        if img_height != 32:
            raise ValueError(f"Unsupported resolution: {img_height}")
        num_blocks = len(GEN_OUT_CHANNELS)
        self.seed_hw = img_height // 2 ** num_blocks  # 4
        self.seed_ch = GEN_IN_CHANNELS[0]
        self.chunk = latent_dim // (num_blocks + 1)
        if self.chunk * (num_blocks + 1) != latent_dim or embed_y[0] != self.chunk:
            raise ValueError(f"latent_dim {latent_dim} must split into "
                             f"{num_blocks + 1} chunks of embed_y[0]={embed_y[0]}")
        if embed_y[1] != self.seed_ch * self.seed_hw ** 2:
            raise ValueError(f"embed_y[1] must be {self.seed_ch * self.seed_hw ** 2}")
        self.dtype = dtype
        self.filter_bank = FilterBank(vocab_size + num_pad_tokens, embed_y, dtype, device)
        self.attention_after = []
        for idx, (cin, cout) in enumerate(zip(GEN_IN_CHANNELS, GEN_OUT_CHANNELS)):
            name = f"B{idx + 1}"
            self.add_module(f"up_{name}", ResNetBlockUp(
                cin, cout, self.chunk, is_last_block=idx == num_blocks - 1,
                use_sn=use_sn, conv_lowering=conv_lowering, dtype=dtype, device=device))
            if name in blocks_with_attention:  # a substring test, as in JAX
                self.add_module(f"attn_{name}", NonLocalBlock(
                    cout, use_sn=use_sn, use_kernel=use_kernel, dtype=dtype,
                    device=device))
                self.attention_after.append(name)
        self.final_bn = BatchNorm(GEN_OUT_CHANNELS[-1], device=device)
        self.to_image = SNConv(GEN_OUT_CHANNELS[-1], img_channels, (3, 3),
                               use_sn=use_sn, dtype=dtype, device=device)

    def forward(self, labels: torch.Tensor, z: torch.Tensor,
                lengths: torch.Tensor | None = None) -> torch.Tensor:
        """labels (B, L) char ids, z (B, latent_dim) -> (B, C, 32, 16L).

        lengths: optional (B,) true word lengths ('padded' mode); columns at or
        past 16*len are set to white (+1)."""
        z = z.to(self.dtype)
        z0, *z_blocks = torch.split(z, self.chunk, dim=1)
        net = self.filter_bank.contract(labels, z0)  # (B, L, 8192)
        # The JAX chain reshape (B, 512, 4, 4, L) -> (B, 4L, 512, 4) ->
        # transpose (0, 3, 1, 2) is one row-major reshape to (B, 4L, 512, 4)
        # followed by the transpose; in NCHW: (B, 512, 4, 4L)
        b = net.shape[0]
        net = net.reshape(b, -1, self.seed_ch, self.seed_hw).permute(0, 2, 3, 1).contiguous()
        for idx, cond in enumerate(z_blocks):
            name = f"B{idx + 1}"
            net = getattr(self, f"up_{name}")(net, cond)
            if name in self.attention_after:
                net = getattr(self, f"attn_{name}")(net)
        net = torch.relu(self.final_bn(net))
        out = torch.tanh(self.to_image(net)).to(self.dtype)
        if lengths is not None:
            cols = torch.arange(out.shape[3], device=out.device)
            valid = cols[None, None, None, :] < 16 * lengths.to(out.device)[:, None, None, None]
            out = torch.where(valid, out, torch.ones((), dtype=out.dtype, device=out.device))
        return out
