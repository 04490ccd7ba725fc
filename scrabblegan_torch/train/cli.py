"""Train entry point of the port: N train steps on synthetic batches.

    python -m scrabblegan_torch.train --device cuda --steps N
        [--workdir W [--no-resume]] [--config configs/recommended.json]
        [--set KEY=VALUE ...] [--length L] [--batch-size B] [--seed S]
        [--init vars.npz] [--export-g g.npz]

It builds the train state with flax's initialisers (or loads it from a
flax-layout .npz, `--init`), takes N steps of `make_train_step` on seeded
uint8 batches made with numpy in the layout of the JAX bench (bench.py),
prints the 16 metrics of every step and, at the end, steps/s. In 'padded'
shape mode the words are padded to `io.bucket_size` characters with true
lengths drawn from 1..bucket_size; in 'bucketed' mode every word has
`--length` characters. Step s draws its batch and z from a generator seeded
with (seed, s), so a resumed run sees the batches an uninterrupted one does.

With `--workdir W`, laid out as the JAX Trainer's workdir:
- W/config.json (and a copy in the checkpoint and model directories);
- resume from the newest checkpoint under W/<io.checkpoint_dir> unless
  `--no-resume` (the steps then continue from the restored step);
- the run's steps count as one epoch: the final state is saved as a full
  checkpoint when `io.ckpt_every` > 0 (the newest three are kept);
- at the end, G and R are exported under W/<io.model_dir> as export number
  <step>, G with its EMA weights and standing statistics where configured,
  the directory `python -m scrabblegan_torch.infer --model-dir` serves.

`--export-g` writes G's live weights as the .npz that `infer --weights`
serves (pass it the same `--config`/`--set`, so the shape mode matches).
The `--init` .npz holds the four networks' flax trees under the keys 'g',
'd', 'r' and 'w' (G, D, R, W), each {"params", "batch_stats"}, joined with
'.' as `convert.save_flax_npz` writes them. The Trainer loop (epochs over a
data set, sample grids, the export gate) is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from scrabblegan_torch import resolve_device
from scrabblegan_torch.config import load_config, save_config
from scrabblegan_torch.convert import load_flax_npz, save_flax_npz, state_from_flax, to_flax
from scrabblegan_torch.data.synthetic import synthetic_batch, synthetic_feed, synthetic_noise
from scrabblegan_torch.train import checkpoint
from scrabblegan_torch.train.standing import export_models
from scrabblegan_torch.train.state import create_train_state
from scrabblegan_torch.train.step import METRIC_NAMES, make_train_step

DEFAULT_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "recommended.json"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train steps of the PyTorch port on synthetic "
                                            "batches.")
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=10, help="steps this run takes")
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
    p.add_argument("--workdir", default=None,
                   help="run directory: config, checkpoints (resume) and exports")
    p.add_argument("--no-resume", action="store_true",
                   help="start from the initial state even if --workdir holds a checkpoint")
    p.add_argument("--export-g", default=None, help="write G's live weights to this .npz")
    return p.parse_args(argv)


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
    if args.workdir:
        ckpt_dir = os.path.join(args.workdir, cfg.io.checkpoint_dir)
        model_dir = os.path.join(args.workdir, cfg.io.model_dir)
        for d in (args.workdir, ckpt_dir, model_dir):
            os.makedirs(d, exist_ok=True)
            save_config(cfg, os.path.join(d, "config.json"))
        if not args.no_resume and checkpoint.restore_state(ckpt_dir, state)[0] is not None:
            print(f"resumed from checkpoint at step {state.step}", flush=True)
    step = make_train_step(cfg, state.models)
    batch_size = args.batch_size or cfg.shared.batch_size
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{args.steps} steps on {device} ({where}), batch {batch_size}, "
          f"{cfg.parallel.shape_mode}", flush=True)
    t0 = time.perf_counter()
    for i in range(args.steps):
        rng = np.random.default_rng([args.seed, state.step])
        batch = synthetic_batch(cfg, batch_size, args.length, rng)
        metrics = step(state, batch, synthetic_noise(cfg, batch_size, rng))
        print(f"step {state.step}: " + " ".join(f"{k}={float(metrics[k]):.4f}"
                                                for k in METRIC_NAMES), flush=True)
        if i == 0:
            t0 = time.perf_counter()  # the first step pays the kernels' build
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if args.steps > 1:
        print(f"{(args.steps - 1) / (time.perf_counter() - t0):.3f} steps/s after the first "
              f"step", flush=True)
    if args.workdir:
        if cfg.io.ckpt_every > 0:
            print(f"saved checkpoint {checkpoint.save_state(ckpt_dir, state, state.step)}",
                  flush=True)
        feed = synthetic_feed(cfg, batch_size, args.length, seed=args.seed + 1)
        for name, path in export_models(cfg, state, model_dir, feed).items():
            print(f"exported {name} to {path}", flush=True)
    if args.export_g:
        save_flax_npz(args.export_g, to_flax(state.models.generator))
        print(f"wrote G to {args.export_g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
