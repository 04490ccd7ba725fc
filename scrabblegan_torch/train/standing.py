"""BigGAN's standing statistics for the EMA export, and the exports of a run.

Port of `Trainer.standing_stats` and of the export half of
`Trainer.save_epoch_artifacts` (scrabblegan_tpu/train/loop.py). G's running
statistics are collected under its live weights; served with the EMA
weights they are wrong (the JAX package measured it, see its docstring).
So before an export N train-mode forwards of G run under the EMA weights,
each from the statistics the previous one left, and the export serves the
EMA weights with those. As JAX's `mutable=['batch_stats']`, a forward keeps
every statistic of that collection: the batch norms' running mean and
variance and spectral norm's u and sigma (power-iterated on the EMA
weights). The live network is not touched.
"""

from __future__ import annotations

import itertools
from collections.abc import Iterable

import torch
from torch.func import functional_call

from scrabblegan_torch.config import Config
from scrabblegan_torch.convert import to_flax
from scrabblegan_torch.ops.layers import record_stats
from scrabblegan_torch.train import checkpoint
from scrabblegan_torch.train.state import TrainState
from scrabblegan_torch.train.step import normalize_images


def standing_stats(cfg: Config, state: TrainState, batches: Iterable[tuple[dict, object]]
                   ) -> dict[str, torch.Tensor] | None:
    """G's statistics after a train-mode forward under the EMA weights on each
    (batch, z) of `batches`, as {buffer name: tensor}; None when the EMA is
    off or `optimizer.ema_standing_stat_batches` is 0 (the export then serves
    the live statistics). Draws at most that many batches."""
    n = cfg.optimizer.ema_standing_stat_batches
    if state.g_ema is None or n <= 0:
        return None
    G = state.models.generator
    if not G.training:
        raise ValueError("standing statistics need G in train mode")
    device = next(G.parameters()).device
    params = dict(zip((name for name, _ in G.named_parameters()), state.g_ema))
    stats = {name: b.detach().clone() for name, b in G.named_buffers()}
    prefix = {module: name for name, module in G.named_modules()}
    padded = cfg.parallel.shape_mode == "padded"
    style_z = cfg.shared.z_source == "style"
    for batch, z in itertools.islice(batches, n):
        labels = torch.as_tensor(batch["fake_labels"]).to(device).long()
        lengths = torch.as_tensor(batch["fake_lengths"]).to(device) if padded else None
        style = normalize_images(batch["style_imgs"], device) if style_z else None
        with torch.no_grad(), record_stats() as record:
            functional_call(G, {**params, **stats},
                            (labels, None if style_z else z.to(device), lengths),
                            {"style_imgs": style})
        for (module, name), value in record.items():
            stats[f"{prefix[module]}.{name}" if prefix[module] else name] = value
    return stats


def serving_override(state: TrainState, stats: dict[str, torch.Tensor] | None
                     ) -> dict[str, torch.Tensor]:
    """The entries of G's state_dict that an export serves in place of the
    live ones: the EMA parameters when the EMA is on, and `stats` (standing
    statistics) when given."""
    G = state.models.generator
    override: dict[str, torch.Tensor] = {}
    if state.g_ema is not None:
        override.update(zip((name for name, _ in G.named_parameters()), state.g_ema))
        override.update(stats or {})
    return override


def export_models(cfg: Config, state: TrainState, model_dir: str,
                  batches: Iterable[tuple[dict, object]]) -> dict[str, str]:
    """Export G and, when the config trains one, R as export number
    `state.step` (the train CLI's `--steps` mode). G is served with its EMA
    weights when the EMA is on, with standing statistics from `batches`
    when they are configured, as the JAX Trainer's exports are; returns
    {'generator': dir, 'recognizer': dir}."""
    stats = standing_stats(cfg, state, batches) if state.g_ema is not None else None
    out = {"generator": checkpoint.save_generator(
        model_dir, to_flax(state.models.generator, serving_override(state, stats)),
        state.step, cfg)}
    if cfg.shared.use_recognizer:
        out["recognizer"] = checkpoint.save_recognizer(
            model_dir, to_flax(state.models.recognizer), state.step, cfg)
    return out
