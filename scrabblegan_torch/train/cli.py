"""Train entry point of the port: the epoch Trainer, or N bare steps.

Trainer mode (the root train.py's flags):

    python -m scrabblegan_torch.train [--device cuda] [--workdir W]
        [--config configs/recommended.json] [--set KEY=VALUE ...]
        [--epochs E] [--batches-per-epoch N] [--no-resume] [--profile N]
        [--synthetic | --read-dir D --style-dir S --words-file F]

runs `train.loop.Trainer` on a data set: `--synthetic` first writes
`data.synthetic.make_synthetic_dataset` under <workdir>/synthetic_data, as
train.py does; otherwise the paths (default: the config's io.read_dir,
io.style_dir, io.words_file) hold a data set in the GAN-Reading layout.
When io.read_dir does not exist and `io.dataset` has a converter
(`data/iam.DATASET_HANDLERS`: 'iam', 'rimes'), the raw data under
`io.raw_dir` is converted into it first, as train.py does. It writes the
JAX Trainer's artifacts under the workdir: output/ (batch_summary.txt and
.csv, epoch_summary.txt, image_at_epoch_NNNN.png with its labels in a
.txt, biggan.gif), checkpoints/<step>/, model/{generator,recognizer}/<epoch>/
with quality_<epoch>.json and the latest_good link, and config.json; it
resumes from the newest checkpoint unless `--no-resume`.

Steps mode (no data set, no counterpart in the JAX package):

    python -m scrabblegan_torch.train --steps N [--device cuda]
        [--workdir W [--no-resume]] [--config ...] [--set KEY=VALUE ...]
        [--length L] [--batch-size B] [--seed S] [--init vars.npz]
        [--export-g g.npz]

builds the train state with flax's initialisers (or loads it from a
flax-layout .npz, `--init`), takes N steps of `make_chunked_train_step`,
K = `parallel.steps_per_call` a call (CUDA graphs on the card, as the
Trainer runs them), on seeded uint8 random-pixel batches in the layout of
the JAX bench (bench.py) and prints the 16 metrics of every step (fetched
from the device in one copy a call) and, at the end, steps/s over the calls
after the last capture. In 'padded' shape mode the words are padded
to `io.bucket_size` characters with true lengths drawn from
1..bucket_size; in 'bucketed' mode every word has `--length` characters.
Step s draws its batch and z from a generator seeded with (seed, s), so a
resumed run sees the batches an uninterrupted one does. With `--workdir W`:
W/config.json (and a copy in the checkpoint and model directories); resume
from the newest checkpoint unless `--no-resume`; the final state as a full
checkpoint when `io.ckpt_every` > 0; G (EMA weights and standing statistics
where configured) and R exported as export number <step>, which
`python -m scrabblegan_torch.infer --model-dir` serves. `--export-g`
writes G's live weights as the .npz that `infer --weights` serves. The
`--init` .npz holds the four networks' flax trees under the keys 'g', 'd',
'r' and 'w', each {"params", "batch_stats"}, joined with '.' as
`convert.save_flax_npz` writes them.
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
from scrabblegan_torch.train.step import METRIC_NAMES, make_chunked_train_step

DEFAULT_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "recommended.json"


STEPS_ONLY = ("length", "batch_size", "init", "export_g")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train the PyTorch port: the epoch Trainer on a "
                                            "data set, or --steps N on random batches.")
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=None,
                   help="steps mode: take N steps on random-pixel batches, no data set")
    p.add_argument("--epochs", type=int, default=None, help="default: shared.epochs")
    p.add_argument("--batches-per-epoch", type=int, default=None,
                   help="default: io.buf_size / shared.batch_size + 1")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="trace the first N Trainer steps with torch.profiler (written to "
                        "<workdir>/output/trace) and print steps/s")
    p.add_argument("--synthetic", action="store_true",
                   help="write a synthetic data set under <workdir>/synthetic_data and "
                        "train on it")
    p.add_argument("--read-dir", default=None, help="bucketed data set (default io.read_dir)")
    p.add_argument("--style-dir", default=None, help="style images (default io.style_dir)")
    p.add_argument("--words-file", default=None, help="lexicon (default io.words_file)")
    p.add_argument("--config", default=str(DEFAULT_CONFIG) if DEFAULT_CONFIG.is_file() else None,
                   help="JSON config (default: configs/recommended.json, as train.py; "
                        "'none' for the library defaults)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--length", type=int, default=None,
                   help="word length of every batch in 'bucketed' shape mode")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: shared.batch_size")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init", default=None, help="flax-layout .npz of the four networks")
    p.add_argument("--workdir", default=None,
                   help="run directory: config, checkpoints (resume) and exports "
                        "(default io.base_path in Trainer mode)")
    p.add_argument("--no-resume", action="store_true",
                   help="start from the initial state even if --workdir holds a checkpoint")
    p.add_argument("--export-g", default=None, help="write G's live weights to this .npz")
    args = p.parse_args(argv)
    if args.steps is None:
        given = [f"--{k.replace('_', '-')}" for k in STEPS_ONLY if getattr(args, k) is not None]
        if given:
            p.error(f"{', '.join(given)} belong to the --steps mode")
    elif args.synthetic or args.epochs is not None or args.batches_per_epoch is not None:
        p.error("--synthetic, --epochs and --batches-per-epoch belong to the Trainer mode")
    return args


def train_epochs(args, cfg, device) -> int:
    """Trainer mode: load or write the data set, run the Trainer."""
    from scrabblegan_torch.train.loop import Trainer

    workdir = args.workdir or cfg.io.base_path
    trainer = Trainer(cfg, workdir=workdir, device=device)
    if args.synthetic:
        from scrabblegan_torch.data.synthetic import make_synthetic_dataset

        read_dir, words_file, style_dir = make_synthetic_dataset(
            os.path.join(workdir, "synthetic_data"))
    else:
        read_dir = args.read_dir or cfg.io.read_dir
        style_dir, words_file = args.style_dir, args.words_file
        if not os.path.exists(read_dir):
            from scrabblegan_torch.data.iam import DATASET_HANDLERS

            if cfg.io.dataset not in DATASET_HANDLERS:
                print(f"no data set at {read_dir} and no converter for io.dataset "
                      f"{cfg.io.dataset!r}; pass --synthetic", file=sys.stderr)
                return 2
            print("converting dataset to GAN-Reading format...", flush=True)
            DATASET_HANDLERS[cfg.io.dataset](cfg.io.raw_dir, read_dir, cfg.io.input_dim,
                                             cfg.io.bucket_size)
    trainer.load_data(read_dir=read_dir, style_dir=style_dir, words_file=words_file)
    trainer.train(epochs=args.epochs, batches_per_epoch=args.batches_per_epoch,
                  resume=not args.no_resume, profile_steps=args.profile)
    return 0


def graph_marks(chunk):
    """What a call changes while the chunked step warms up on the card: its
    eager warm-up steps and its captures (None on the CPU)."""
    return chunk.graphs and (chunk.graphs.warmup_steps, len(chunk.graphs.captured))


def main(argv=None) -> int:
    args = parse_args(argv)
    config = None if args.config in (None, "none") else args.config
    cfg = load_config(config, dict(kv.split("=", 1) for kv in args.set))
    device = resolve_device(args.device)
    if args.steps is None:
        return train_epochs(args, cfg, device)
    length = args.length or 5
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
    chunk = make_chunked_train_step(cfg, state.models)
    k = max(1, int(cfg.parallel.steps_per_call))
    batch_size = args.batch_size or cfg.shared.batch_size
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{args.steps} steps on {device} ({where}), batch {batch_size}, "
          f"{cfg.parallel.shape_mode}, {k} a call", flush=True)
    t0, timed, done = time.perf_counter(), 0, 0
    while done < args.steps:
        n = min(k, args.steps - done)
        drawn = []
        for i in range(n):
            rng = np.random.default_rng([args.seed, state.step + i])
            drawn.append((synthetic_batch(cfg, batch_size, length, rng),
                          synthetic_noise(cfg, batch_size, rng)))
        batches = {key: np.stack([b[key] for b, _ in drawn]) for key in drawn[0][0]}
        z = None if drawn[0][1] is None else torch.stack([z for _, z in drawn])
        marks = graph_marks(chunk)
        rows = chunk(state, batches, z).T.tolist()  # one fetch a call
        for i, values in enumerate(rows):
            print(f"step {state.step - n + i + 1}: " + " ".join(
                f"{name}={v:.4f}" for name, v in zip(METRIC_NAMES, values)), flush=True)
        done += n
        if done == n or graph_marks(chunk) != marks:
            t0, timed = time.perf_counter(), 0  # the kernels' build, warm-up steps, a capture
        else:
            timed += n
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if timed:
        print(f"{timed / (time.perf_counter() - t0):.3f} steps/s over the {timed} steps after "
              f"the first call, the warm-up steps and the capture", flush=True)
    if args.workdir:
        if cfg.io.ckpt_every > 0:
            print(f"saved checkpoint {checkpoint.save_state(ckpt_dir, state, state.step)}",
                  flush=True)
        feed = synthetic_feed(cfg, batch_size, length, seed=args.seed + 1)
        for name, path in export_models(cfg, state, model_dir, feed).items():
            print(f"exported {name} to {path}", flush=True)
    if args.export_g:
        save_flax_npz(args.export_g, to_flax(state.models.generator))
        print(f"wrote G to {args.export_g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
