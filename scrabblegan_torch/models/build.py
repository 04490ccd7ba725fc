"""Build the port's networks from a Config (`scrabblegan_torch.config`).

Port of scrabblegan_tpu/train/state.py `build_models`: G, D, R and W with
their compute dtypes (G and R in `shared.dtype`; D, W and G's style encoder
in `shared.trunk_dtype`, which defaults to `shared.dtype`; parameters are
float32 either way) and `shared.use_pallas_attention` choosing the attention
core of G's B3 and D's and W's B1 on a card. `shared.my_disc` builds the
DCGAN D (its attention on the plain path, as JAX builds it) and
`shared.my_rec` the BiLSTM R; W stays the BigGAN trunk either way.
"""

from __future__ import annotations

import dataclasses

import torch

from scrabblegan_torch.config import BigGANConfig, Config, load_config
from scrabblegan_torch import resolve_device
from scrabblegan_torch.models.discriminator import DCGANDiscriminator, Discriminator
from scrabblegan_torch.models.generator import Generator
from scrabblegan_torch.models.recognizer import BiLSTMRecognizer, Recognizer
from scrabblegan_torch.models.style import StylePromoter

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """The four networks."""

    generator: Generator
    discriminator: Discriminator | DCGANDiscriminator
    recognizer: Recognizer | BiLSTMRecognizer
    style_promoter: StylePromoter

    def items(self) -> list[tuple[str, torch.nn.Module]]:
        return [(f.name, getattr(self, f.name)) for f in dataclasses.fields(self)]


def noise_config(path: str | None = None, overrides: dict | None = None) -> Config:
    """`load_config(path, overrides)` with the noise z source: G from
    (labels, z), the reference's serving path."""
    cfg = load_config(path, overrides)
    return dataclasses.replace(cfg, shared=dataclasses.replace(cfg.shared, z_source="noise"))


def _dtype(cfg: Config, key: str, value: str) -> torch.dtype:
    if value not in DTYPES:
        raise ValueError(f"shared.{key} must be 'float32' or 'bfloat16', got {value!r}")
    return DTYPES[value]


def _generator(cfg: Config, dev: torch.device) -> Generator:
    h, _, c = cfg.io.input_dim
    return Generator(
        vocab_size=cfg.io.n_classes,
        latent_dim=cfg.shared.latent_dim,
        embed_y=tuple(cfg.shared.embed_y),
        blocks_with_attention=cfg.shared.g_bw_attention,
        z_source=cfg.shared.z_source,
        img_channels=c,
        img_height=h,
        use_sn=cfg.shared.kernel_reg == "spectral_norm",
        use_kernel=cfg.shared.use_pallas_attention,
        conv_lowering=cfg.shared.conv_lowering,
        num_pad_tokens=1 if cfg.parallel.shape_mode == "padded" else 0,
        dtype=_dtype(cfg, "dtype", cfg.shared.dtype),
        style_encoder_dtype=_dtype(cfg, "trunk_dtype",
                                   cfg.shared.trunk_dtype or cfg.shared.dtype),
        device=dev,
    )


def build_generator(cfg: Config, device: str | torch.device = "cpu") -> Generator:
    """An eval-mode Generator with zero weights; load them with
    `scrabblegan_torch.convert`. `shared.use_pallas_attention` selects the
    attention CUDA kernel (True) or the plain core (False) on a card."""
    return _generator(cfg, resolve_device(device)).eval()


def build_models(cfg: Config, device: str | torch.device = "cpu",
                 biggan: BigGANConfig | None = None):
    """The four networks in train mode, with zero weights: load them with
    `scrabblegan_torch.convert` or fill them with `train.state`'s
    initialisers. With `biggan` (a config file's "biggan" section,
    `config.load_biggan`) BigGAN's G and D instead
    (models/biggan.py `ClassBundle`)."""
    dev = resolve_device(device)
    if biggan is not None:
        from scrabblegan_torch.models.biggan import build_biggan

        return build_biggan(cfg, biggan, dev)
    trunk = _dtype(cfg, "trunk_dtype", cfg.shared.trunk_dtype or cfg.shared.dtype)
    use_sn = cfg.shared.kernel_reg == "spectral_norm"
    c = cfg.io.input_dim[2]
    adversary = dict(img_channels=c, blocks_with_attention=cfg.shared.d_bw_attention,
                     use_sn=use_sn, use_kernel=cfg.shared.use_pallas_attention, dtype=trunk,
                     device=dev)
    rec_cls = BiLSTMRecognizer if cfg.shared.my_rec else Recognizer
    bundle = ModelBundle(
        generator=_generator(cfg, dev),
        discriminator=(DCGANDiscriminator(c, use_sn=use_sn, dtype=trunk, device=dev)
                       if cfg.shared.my_disc else Discriminator(**adversary)),
        recognizer=rec_cls(cfg.io.n_classes + 1, img_channels=c,
                           dtype=_dtype(cfg, "dtype", cfg.shared.dtype), device=dev),
        style_promoter=StylePromoter(**adversary),
    )
    for _, module in bundle.items():
        module.train()
    return bundle
