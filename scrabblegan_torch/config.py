"""Typed configuration tree of the port.

The port's own copy of what it uses from scrabblegan_tpu/config.py, so that
it imports nothing of the JAX package: the four section dataclasses with the
same fields and defaults, `Config`, `CHAR_VECTOR`, `load_config` (a JSON file
plus dotted-path overrides, with the `adam_impl` back-compat rule),
`apply_overrides`, `save_config` and `discover_config`. A config.json written
by either package loads in the other to an equal tree (tested). The JAX
module's field comments give each option's rationale.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

CHAR_VECTOR = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


@dataclass(frozen=True)
class OptimizerConfig:
    g_lr: float = 2e-4
    d_lr: float = 2e-4
    r_lr: float = 2e-4
    w_lr: float = 2e-4
    beta_1: float = 0.0
    beta_2: float = 0.999
    loss_fn: str = "hinge"  # 'hinge' | 'not_saturating'
    disc_iters: int = 1
    apply_gradient_balance: bool = False
    balance_alpha: float = 1.0
    balance_mode: str = "loss_rescale"  # 'loss_rescale' | 'grad_norm'
    rmsprop: bool = False  # RMSprop for the recognizer
    lr_schedule: str = "constant"  # 'constant' | 'cosine' | 'warmup_cosine'
    warmup_steps: int = 1000
    decay_steps: int = 50240
    style_loss_mode: str = "adversarial"  # 'adversarial' | 'style_vs_iam' | 'bug_compatible'
    bug_compatible_style_loss: bool = False  # deprecated alias of 'bug_compatible'
    g_ema_decay: float = 0.0  # EMA of G's weights; 0 = off
    # train-mode G forwards under the EMA weights that refresh the statistics
    # an EMA export serves (BigGAN's standing statistics); 0 = the live ones
    ema_standing_stat_batches: int = 100
    adam_impl: str = "lean"  # 'lean' | 'optax' (checkpoint-coupled)
    moment_dtype: str = "float32"  # lean Adam's moment storage


@dataclass(frozen=True)
class SharedSpecs:
    epochs: int = 10
    batch_size: int = 16
    latent_dim: int = 128
    embed_y: Tuple[int, int] = (32, 8192)  # filter bank patch dims
    num_gen: int = 16
    kernel_reg: str = "spectral_norm"  # 'spectral_norm' | 'none'
    g_bw_attention: str = "B3"
    d_bw_attention: str = "B1"
    my_rec: bool = False  # BiLSTM recognizer variant
    my_disc: bool = False  # DCGAN discriminator variant
    z_source: str = "style"  # 'style' | 'noise'
    dtype: str = "float32"  # compute dtype; parameters are float32
    trunk_dtype: str = ""  # compute dtype of D, W and G's style encoder; '' = dtype
    use_pallas_attention: bool = True  # the attention kernels (the port's CUDA ones)
    conv_lowering: str = "dilated"  # 'dilated' | 'subpixel'
    remat: bool = False
    use_recognizer: bool = True
    use_style_promoter: bool = True


@dataclass(frozen=True)
class IOConfig:
    base_path: str = "./runs/"
    dataset: str = "iam"
    checkpoint_dir: str = "checkpoints/"
    gen_imgs_dir: str = "output/"
    model_dir: str = "model/"
    raw_dir: str = "data/IAM_mygan/img/"
    read_dir: str = "data/IAM_mygan/words-Reading/"
    style_dir: str = "data/style_imgs/"
    words_file: str = "data/random_words.txt"
    input_dim: Tuple[int, int, int] = (32, 160, 1)  # (H, W_max, C)
    buf_size: int = 80377
    n_classes: int = 52
    seq_len: Optional[int] = None
    bucket_size: int = 10
    char_vec: str = CHAR_VECTOR
    log_every: Optional[int] = None
    ckpt_every: int = 1  # full-state checkpoint cadence in epochs; 0 = none
    export_quality_samples: int = 64
    stall_timeout_s: float = 0.0
    compile_grace_s: float = 2700.0


@dataclass(frozen=True)
class ParallelConfig:
    num_devices: int = -1
    shape_mode: str = "bucketed"  # 'bucketed' | 'padded'
    bucket_pairing: str = "matched"  # 'matched' | 'independent'
    batch_mix: str = "bucket"  # 'bucket' | 'sample'
    steps_per_call: int = 1
    prefetch_depth: int = 2
    transfer_dtype: str = "uint8"
    fsdp: bool = False
    fsdp_min_size: int = 65536
    model_parallel: int = 1


@dataclass(frozen=True)
class BigGANConfig:
    """The widths of BigGAN (models/biggan.py), read from a config file's
    "biggan" section (`load_biggan`). It is not a field of `Config`, whose
    tree stays the JAX package's; a file with the section trains BigGAN.
    Defaults: 128 x 128, ch 96, as the authors' `G_arch[128]` / `D_arch[128]`."""
    resolution: int = 128
    ch: int = 96
    n_classes: int = 1000
    dim_z: int = 120
    shared_dim: int = 128
    g_mult: Tuple[int, ...] = (16, 16, 8, 4, 2, 1)  # G's channels / ch, from 4 x 4 up
    d_mult: Tuple[int, ...] = (1, 2, 4, 8, 16, 16)  # D's blocks' channels / ch
    g_attention: int = 64  # the width G's non-local block runs at
    d_attention: int = 64  # likewise D's
    bn_momentum: float = 0.9  # flax's convention: PyTorch's momentum 0.1


def load_biggan(path: Optional[str]) -> Optional[BigGANConfig]:
    """The "biggan" section of a JSON config file as a BigGANConfig, or None
    when the file has none (a ScrabbleGAN config)."""
    if not path:
        return None
    with open(path) as f:
        data = json.load(f).get("biggan")
    return None if data is None else _dataclass_from_dict(BigGANConfig, data)


_SECTIONS = {"optimizer": OptimizerConfig, "shared": SharedSpecs, "io": IOConfig,
             "parallel": ParallelConfig}


@dataclass(frozen=True)
class Config:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    shared: SharedSpecs = field(default_factory=SharedSpecs)
    io: IOConfig = field(default_factory=IOConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    seed: int = 0


def _dataclass_from_dict(cls, data: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        if f.name in _SECTIONS and cls is Config:
            value = _dataclass_from_dict(_SECTIONS[f.name], value)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[f.name] = value
    return cls(**kwargs)


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """A Config from an optional JSON file plus dotted-path overrides
    ('optimizer.g_lr' -> 1e-4; string values are parsed by the field's type).

    A file with an optimizer section but no `adam_impl` predates that key and
    was written when 'optax' was the only optimizer-state layout, so it loads
    as 'optax', not as today's default."""
    data: dict = {}
    if path:
        with open(path) as f:
            data = json.load(f)
        opt = data.get("optimizer")
        if isinstance(opt, dict) and "adam_impl" not in opt:
            opt["adam_impl"] = "optax"
    cfg = _dataclass_from_dict(Config, data)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    for dotted, value in overrides.items():
        cfg = _replace_path(cfg, dotted.split("."), value)
    return cfg


def _replace_path(obj: Any, parts, value):
    if len(parts) == 1:
        current = getattr(obj, parts[0])
        if isinstance(current, bool) and isinstance(value, str):
            value = value.lower() in ("1", "true", "yes")
        elif isinstance(current, int) and not isinstance(current, bool) and isinstance(value, str):
            value = int(value)
        elif isinstance(current, float) and isinstance(value, str):
            value = float(value)
        elif isinstance(current, tuple) and isinstance(value, (list, str)):
            if isinstance(value, str):
                value = tuple(int(v) for v in value.strip("()[] ").split(","))
            else:
                value = tuple(value)
        return dataclasses.replace(obj, **{parts[0]: value})
    sub = getattr(obj, parts[0])
    return dataclasses.replace(obj, **{parts[0]: _replace_path(sub, parts[1:], value)})


def save_config(cfg: Config, path: str) -> str:
    """Write the full config as JSON (the format `load_config` reads).

    Checkpoints and exports carry it beside them, since their layout depends
    on it: 'padded' shape mode adds the filter bank's PAD row, g_ema_decay > 0
    adds the EMA, adam_impl sets the optimizer state's leaves."""
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
        f.write("\n")
    return path


def discover_config(start: str, max_up: int = 4) -> Optional[str]:
    """The config.json describing a checkpoint, export or workdir path: the
    first found walking up from `start` (a file or a directory) at most
    `max_up` levels, enough to reach the workdir from
    <workdir>/model/generator/<n>. None if there is none."""
    d = os.path.abspath(start)
    if os.path.isfile(d):
        d = os.path.dirname(d)
    for _ in range(max_up + 1):
        candidate = os.path.join(d, "config.json")
        if os.path.isfile(candidate):
            return candidate
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return None
