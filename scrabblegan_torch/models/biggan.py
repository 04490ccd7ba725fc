"""BigGAN at 128 x 128: the class-conditional G and the projection D, their
conv trunks channels_last on a card.

Brock, Donahue, Simonyan, "Large Scale GAN Training for High Fidelity Natural
Image Synthesis" (arXiv:1809.11096), as the authors' code builds it
(BigGAN-PyTorch, `BigGAN.py` `G_arch` / `D_arch`); the widths come from
`config.BigGANConfig` (ch 96 at 128 x 128). The blocks are the port's shared
layers with BigGAN's options (ops/blocks.py, ops/layers.py, ops/attention.py):

- G: y -> e = a shared plain embedding (shared_dim); z (dim_z) split into
  len(g_mult) chunks; h = SNLinear(z_0) as (g_mult[0] ch, 4, 4); one up-block
  a chunk after the first, each 2x nearest upsample, 3x3 SN convs, a 1x1 SN
  skip and two CBNs on c_i = [e, z_i] with gain 1 + SNLinear(c_i); the
  non-local block after the block whose output is `g_attention` pixels wide;
  BN with an affine, relu, a 3x3 SN conv to RGB, tanh.
- D: len(d_mult) down-blocks (the first without the leading relu and with
  its skip pooled before the conv, the last without a pool and with the
  identity skip); the non-local block after the block whose output is
  `d_attention` pixels wide; relu, a sum over the pixels, then SNLinear(h) +
  <SNEmbed(y), h>, in float32.

The convs and the attention compute in `dtype` (parameters float32), the
attention core on the CUDA kernels at (Ca, Cg) = (C/8, C/2) on a card.

Each network lays its activations out at its entry (G after the linear's
view, D with the cast of its input) in `trunk_format`: channels_last on a
card, the layout cuDNN computes its bf16 convs in, so that it converts no
activation to NHWC and back. The blocks keep the layout they are given
(ops/blocks.py, the pool of kernels/pool.py, ops/attention.py).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from scrabblegan_torch.config import BigGANConfig, Config
from scrabblegan_torch.ops.attention import NonLocalBlock
from scrabblegan_torch.ops.blocks import BatchNorm, ResNetBlockDown, ResNetBlockUp
from scrabblegan_torch.ops.layers import SNConv, SNDense, SNEmbedding


def trunk_format(device: torch.device) -> torch.memory_format:
    """The layout of the networks' activations on `device`: channels_last on
    a card, where cuDNN would otherwise convert every NCHW conv input to NHWC
    and the output back; NCHW on the CPU, where the port is held to the plain
    NCHW reference in float32 and another layout would sum in another order."""
    return torch.channels_last if device.type == "cuda" else torch.contiguous_format


class BigGANGenerator(nn.Module):
    """(y (B,) int, z (B, dim_z) float) -> images (B, 3, R, R) in [-1, 1], in
    the compute dtype."""

    def __init__(self, spec: BigGANConfig, use_sn: bool = True, use_kernel: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        ch, mult = spec.ch, spec.g_mult
        self.z_chunk = spec.dim_z // len(mult)
        if self.z_chunk * len(mult) != spec.dim_z:
            raise ValueError(f"dim_z {spec.dim_z} does not split into {len(mult)} chunks")
        self.bottom = spec.resolution >> (len(mult) - 1)
        kw = dict(use_sn=use_sn, dtype=dtype, device=device)
        self.shared = SNEmbedding(spec.n_classes, spec.shared_dim, use_sn=False, device=device)
        self.linear = SNDense(self.z_chunk, mult[0] * ch * self.bottom ** 2, use_bias=True, **kw)
        cbn = dict(momentum=spec.bn_momentum, gain_offset=1.0)
        self.blocks = nn.ModuleList(
            ResNetBlockUp(mult[i] * ch, mult[i + 1] * ch, spec.shared_dim + self.z_chunk,
                          upsample="nearest", cbn=cbn, **kw)
            for i in range(len(mult) - 1))
        self.attn_after = next(i for i in range(len(mult) - 1)
                               if self.bottom << (i + 1) == spec.g_attention)
        self.attn = NonLocalBlock(mult[self.attn_after + 1] * ch, use_kernel=use_kernel, **kw)
        self.out_bn = BatchNorm(ch, device=device, momentum=spec.bn_momentum)
        self.out_conv = SNConv(ch, 3, (3, 3), **kw)

    def forward(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        zs = z.float().split(self.z_chunk, dim=1)
        e = self.shared(y)
        h = self.linear(zs[0]).view(z.shape[0], -1, self.bottom, self.bottom)
        h = h.contiguous(memory_format=trunk_format(h.device))
        for i, block in enumerate(self.blocks):
            h = block(h, torch.cat([e, zs[i + 1]], dim=1))
            if i == self.attn_after:
                h = self.attn(h)
        return torch.tanh(self.out_conv(torch.relu(self.out_bn(h))))


class BigGANDiscriminator(nn.Module):
    """(x (B, 3, R, R) float, y (B,) int) -> logits (B,) float32."""

    def __init__(self, spec: BigGANConfig, use_sn: bool = True, use_kernel: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        ch, mult = spec.ch, spec.d_mult
        self.dtype = dtype
        ins = [3] + [m * ch for m in mult[:-1]]
        outs = [m * ch for m in mult]
        kw = dict(use_sn=use_sn, dtype=dtype, device=device)
        last = len(outs) - 1
        self.blocks = nn.ModuleList(
            ResNetBlockDown(cin, cout, is_last_block=i == last, preactivation=i > 0,
                            learnable_skip=i < last, **kw)
            for i, (cin, cout) in enumerate(zip(ins, outs)))
        self.attn_after = next(i for i in range(last) if spec.resolution >> (i + 1)
                               == spec.d_attention)
        self.attn = NonLocalBlock(outs[self.attn_after], use_kernel=use_kernel, **kw)
        head = dict(use_sn=use_sn, device=device)  # the head computes in float32
        self.linear = SNDense(outs[-1], 1, use_bias=True, **head)
        self.embed = SNEmbedding(spec.n_classes, outs[-1], **head)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype, memory_format=trunk_format(x.device))
        for i, block in enumerate(self.blocks):
            h = block(h)
            if i == self.attn_after:
                h = self.attn(h)
        h = torch.relu(h).float().sum(dim=(2, 3))
        return self.linear(h)[:, 0] + (self.embed(y) * h).sum(dim=1)


@dataclasses.dataclass(frozen=True)
class ClassBundle:
    """BigGAN's two networks, in the order of train/state.py's NETWORKS."""

    generator: BigGANGenerator
    discriminator: BigGANDiscriminator

    def items(self) -> list[tuple[str, torch.nn.Module]]:
        return [(f.name, getattr(self, f.name)) for f in dataclasses.fields(self)]


def build_biggan(cfg: Config, spec: BigGANConfig, device: torch.device) -> ClassBundle:
    """G and D in train mode with zero weights, G in `shared.dtype` and D in
    `shared.trunk_dtype` (default `shared.dtype`); `shared.kernel_reg` and
    `shared.use_pallas_attention` as for ScrabbleGAN."""
    from scrabblegan_torch.models.build import _dtype

    kw = dict(use_sn=cfg.shared.kernel_reg == "spectral_norm",
              use_kernel=cfg.shared.use_pallas_attention, device=device)
    bundle = ClassBundle(
        BigGANGenerator(spec, dtype=_dtype(cfg, "dtype", cfg.shared.dtype), **kw),
        BigGANDiscriminator(spec, dtype=_dtype(cfg, "trunk_dtype", cfg.shared.trunk_dtype
                                               or cfg.shared.dtype), **kw))
    for _, module in bundle.items():
        module.train()
    return bundle


@torch.no_grad()
def init_biggan(module: nn.Module, seed: int) -> None:
    """BigGAN's initialisation (`--G_init ortho --D_init ortho`): every
    weight of two or more axes orthogonal over (out, -1) rows, embeddings
    included; biases 0; BN scale 1 and shift 0; spectral norm's u ~ N(0, 1),
    then one committed power iteration (sigma its estimate); the non-local
    blocks' sigma (BigGAN's gamma) 0. Drawn in `named_parameters` order from
    a torch.Generator seeded with `seed`."""
    from scrabblegan_torch.ops.layers import init_power_iteration

    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            w = torch.empty(p.shape[0], p[0].numel())
            nn.init.orthogonal_(w, generator=gen)
            p.copy_(w.view_as(p))
        elif name.endswith("out_bn.weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    for name, b in module.named_buffers():
        if name.endswith(".u"):
            b.copy_(torch.randn(b.shape, generator=gen))
    init_power_iteration(module)
