"""Build the port's generator from the JAX package's Config.

Port of the generator half of scrabblegan_tpu/train/state.py build_models.
"""

from __future__ import annotations

import dataclasses

import torch

from scrabblegan_tpu.config import Config, load_config
from scrabblegan_torch import resolve_device
from scrabblegan_torch.models.generator import Generator

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def noise_config(path: str | None = None, overrides: dict | None = None) -> Config:
    """`load_config(path, overrides)` with the noise z source, the one the
    port serves."""
    cfg = load_config(path, overrides)
    return dataclasses.replace(cfg, shared=dataclasses.replace(cfg.shared, z_source="noise"))


def build_generator(cfg: Config, device: str | torch.device = "cpu") -> Generator:
    """An eval-mode Generator with zero weights; load them with
    `scrabblegan_torch.convert`. `shared.use_pallas_attention` selects the
    attention CUDA kernel (True) or the plain core (False) on a card."""
    if cfg.shared.dtype not in DTYPES:
        raise ValueError(f"shared.dtype must be 'float32' or 'bfloat16', "
                         f"got {cfg.shared.dtype!r}")
    dev = resolve_device(device)
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
        dtype=DTYPES[cfg.shared.dtype],
        device=dev,
    ).eval()
