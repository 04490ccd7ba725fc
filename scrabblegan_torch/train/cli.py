"""Train entry point of the port: N train steps on synthetic batches.

    python -m scrabblegan_torch.train --device cuda --steps N
        [--config configs/recommended.json] [--set KEY=VALUE ...] [--length L]
        [--batch-size B] [--seed S] [--init vars.npz] [--export-g g.npz]

It builds the train state with flax's initialisers (or loads it from a
flax-layout .npz, `--init`), takes N steps of `make_train_step` on seeded
uint8 batches made with numpy in the layout of the JAX bench (bench.py),
prints the 16 metrics of every step and, at the end, steps/s. In 'padded'
shape mode the words are padded to `io.bucket_size` characters with true
lengths drawn from 1..bucket_size; in 'bucketed' mode every word has
`--length` characters. `--export-g` writes G's live weights as the .npz
that `python -m scrabblegan_torch.infer --weights` serves (pass it the same
`--config`/`--set`, so the shape mode matches).

The `--init` .npz holds the four networks' flax trees under the keys
'g', 'd', 'r' and 'w' (G, D, R, W), each {"params", "batch_stats"}, joined
with '.' as `convert.save_flax_npz` writes them. The Trainer (epochs, data
sets, checkpoints, sample grids) is not ported yet.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from scrabblegan_tpu.config import load_config
from scrabblegan_torch import resolve_device
from scrabblegan_torch.convert import load_flax_npz, save_flax_npz, state_from_flax, to_flax
from scrabblegan_torch.train.state import create_train_state
from scrabblegan_torch.train.step import METRIC_NAMES, make_train_step

DEFAULT_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "recommended.json"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train steps of the PyTorch port on synthetic "
                                            "batches.")
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--config", default=str(DEFAULT_CONFIG) if DEFAULT_CONFIG.is_file() else None,
                   help="JSON config (default: configs/recommended.json, as train.py; "
                        "'none' for the library defaults)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--length", type=int, default=5,
                   help="word length of every batch in 'bucketed' shape mode")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: shared.batch_size")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init", default=None, help="flax-layout .npz of the four networks")
    p.add_argument("--export-g", default=None, help="write G's weights to this .npz")
    return p.parse_args(argv)


def synthetic_batch(cfg, batch_size: int, length: int, rng: np.random.Generator) -> dict:
    """A uint8 batch in the JAX bench's layout; in 'padded' mode words of
    random true length padded with the PAD id to io.bucket_size."""
    h, w_style, c = cfg.io.input_dim
    n = cfg.io.n_classes
    if cfg.parallel.shape_mode != "padded":
        return {"real_imgs": rng.integers(0, 256, (batch_size, h, 16 * length, c), np.uint8),
                "real_labels": rng.integers(0, n, (batch_size, length)),
                "style_imgs": rng.integers(0, 256, (batch_size, h, w_style, c), np.uint8),
                "fake_labels": rng.integers(0, n, (batch_size, length))}
    top = cfg.io.bucket_size
    batch = {"real_imgs": rng.integers(0, 256, (batch_size, h, 16 * top, c), np.uint8),
             "style_imgs": rng.integers(0, 256, (batch_size, h, w_style, c), np.uint8)}
    for side in ("real", "fake"):
        lengths = rng.integers(1, top + 1, batch_size)
        labels = rng.integers(0, n, (batch_size, top))
        labels[np.arange(top)[None, :] >= lengths[:, None]] = n  # the PAD id
        batch[f"{side}_labels"], batch[f"{side}_lengths"] = labels, lengths
    return batch


def main(argv=None) -> int:
    args = parse_args(argv)
    config = None if args.config in (None, "none") else args.config
    cfg = load_config(config, dict(kv.split("=", 1) for kv in args.set))
    device = resolve_device(args.device)
    if args.init:
        tree = load_flax_npz(args.init)
        state = state_from_flax(cfg, {n: tree[n]["params"] for n in "gdrw"},
                                {n: tree[n].get("batch_stats", {}) for n in "gdrw"}, device)
    else:
        state = create_train_state(cfg, args.seed, device)
    step = make_train_step(cfg, state.models)
    batch_size = args.batch_size or cfg.shared.batch_size
    rng = np.random.default_rng(args.seed)
    noise = cfg.shared.z_source == "noise"
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{args.steps} steps on {device} ({where}), batch {batch_size}, "
          f"{cfg.parallel.shape_mode}", flush=True)
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = synthetic_batch(cfg, batch_size, args.length, rng)
        z = (torch.from_numpy(rng.standard_normal((batch_size, cfg.shared.latent_dim))
                              .astype(np.float32)) if noise else None)
        metrics = step(state, batch, z)
        print(f"step {state.step}: " + " ".join(f"{k}={float(metrics[k]):.4f}"
                                                for k in METRIC_NAMES), flush=True)
        if i == 0:
            t0 = time.perf_counter()  # the first step pays the kernels' build
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if args.steps > 1:
        print(f"{(args.steps - 1) / (time.perf_counter() - t0):.3f} steps/s after the first "
              f"step", flush=True)
    if args.export_g:
        save_flax_npz(args.export_g, to_flax(state.models.generator))
        print(f"wrote G to {args.export_g}", flush=True)
    return 0
