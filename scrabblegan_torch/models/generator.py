"""The ScrabbleGAN generator with both z sources, and its style encoder, NCHW.

Port of scrabblegan_tpu/models/generator.py (StyleEncoder, Generator):
z (B, 128), drawn ('noise') or encoded from a style image ('style'), is split
4 x 32; z0 contracts the filter bank into one 4x4x512 seed per character,
laid side by side along the width; three CBN up-blocks conditioned on z1..z3
(channels 256/128/64, strides (2,2), (2,2), (2,1)); non-local attention after
B3; final BN, relu, 3x3 SN conv, tanh. Labels (B, L) give images
(B, C, 32, 16L) in [-1, 1]. Train mode (`.train()`) is the layers' own.
On a card, an inference call replays a CUDA graph of the forward, captured
on the second call of its signature (models/forward_graphs.py).
"""

from __future__ import annotations

import torch
from torch import nn

from scrabblegan_torch.models.forward_graphs import ForwardGraphs
from scrabblegan_torch.ops.attention import NonLocalBlock
from scrabblegan_torch.ops.blocks import BatchNorm, ResNetBlockDown, ResNetBlockUp
from scrabblegan_torch.ops.embedding import FilterBank
from scrabblegan_torch.ops.layers import SNConv, SNDense
from scrabblegan_torch.utils.profiling import span

GEN_IN_CHANNELS = (512, 256, 128)  # scrabblegan_tpu gen_channels(32)
GEN_OUT_CHANNELS = (256, 128, 64)


def disc_channels(colors: int = 1, resolution: int = 32) -> tuple[list[int], list[int]]:
    """Down-block channels (in, out) of D, W and the style encoder;
    scrabblegan_tpu/models/discriminator.py `disc_channels`."""
    if colors not in (1, 3):
        raise ValueError(f"Unsupported color channels: {colors}")
    if resolution != 32:
        raise ValueError(f"Unsupported resolution: {resolution}")
    out_channels = [64 * m for m in (1, 8, 16, 16)]
    return [colors] + out_channels[:-1], out_channels


class StyleEncoder(nn.Module):
    """Style image (B, C, 32, W) -> 128-d z (B, 128), in its own compute
    dtype: four ResNetBlockDown (64/512/1024/1024), attention after the first
    on the plain core (JAX builds this block without `use_pallas`), relu,
    global average pool accumulated in float32, SN-Dense 128."""

    def __init__(self, img_channels: int = 1, latent_dim: int = 128, use_sn: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        ins, outs = disc_channels(img_channels)
        kw = dict(use_sn=use_sn, dtype=dtype, device=device)
        for idx, (cin, cout) in enumerate(zip(ins, outs)):
            self.add_module(f"block{idx + 1}", ResNetBlockDown(
                cin, cout, is_last_block=idx == len(outs) - 1, **kw))
        self.attn = NonLocalBlock(outs[0], use_kernel=False, **kw)
        self.proj = SNDense(outs[-1], latent_dim, **kw)

    def forward(self, style_imgs: torch.Tensor) -> torch.Tensor:
        net = self.attn(self.block1(style_imgs.to(self.dtype)))
        for name in ("block2", "block3", "block4"):
            net = getattr(self, name)(net)
        net = torch.relu(net).float().mean(dim=(2, 3))
        return self.proj(net)


class Generator(nn.Module):
    """`num_pad_tokens=1` adds the filter bank's PAD row ('padded' shape mode).
    `use_kernel` picks the attention core of B3 (see NonLocalBlock).
    `style_encoder_dtype` is the style encoder's compute dtype (the trunk
    dtype; default `dtype`); its z is cast back to `dtype`."""

    def __init__(self, vocab_size: int, latent_dim: int = 128,
                 embed_y: tuple[int, int] = (32, 8192),
                 blocks_with_attention: str = "B3", z_source: str = "noise",
                 img_channels: int = 1, img_height: int = 32, use_sn: bool = True,
                 use_kernel: bool = True, conv_lowering: str = "dilated",
                 num_pad_tokens: int = 0, dtype: torch.dtype = torch.float32,
                 style_encoder_dtype: torch.dtype | None = None, device=None):
        super().__init__()
        if z_source not in ("noise", "style"):
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
        self.z_source = z_source
        if z_source == "style":
            self.style_encoder = StyleEncoder(
                img_channels, latent_dim, use_sn=use_sn,
                dtype=style_encoder_dtype or dtype, device=device)
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
        self.forward_graphs = ForwardGraphs()  # not a submodule: outside state_dict, not copied

    def forward(self, labels: torch.Tensor, z: torch.Tensor | None = None,
                lengths: torch.Tensor | None = None,
                style_imgs: torch.Tensor | None = None) -> torch.Tensor:
        """labels (B, L) char ids and z (B, latent_dim), or style_imgs
        (B, C, 32, W) with z_source='style' -> (B, C, 32, 16L).

        lengths: optional (B,) true word lengths ('padded' mode); columns at or
        past 16*len are set to white (+1).

        In eval mode with gradients off on a card, a CUDA graph of the
        forward serves the call (models/forward_graphs.py); the output is a
        fresh tensor either way.

        Traced (utils/profiling.py): span `g.forward` around the call, with
        `g.style_encoder` inside it for style z when the forward runs
        eagerly (not on a replay)."""
        with span("g.forward"):
            return self.forward_graphs(self, self._forward, (labels, z, lengths, style_imgs))

    def _forward(self, labels, z, lengths, style_imgs) -> torch.Tensor:
        if self.z_source == "style":
            if style_imgs is None:
                raise ValueError("z_source='style' requires style_imgs")
            with span("g.style_encoder"):
                z = self.style_encoder(style_imgs)
        elif z is None:
            raise ValueError("z_source='noise' requires z")
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
