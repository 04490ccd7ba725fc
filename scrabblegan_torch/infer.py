"""Inference entry point of the port: a word -> handwritten word images.

Port of infer.py for the noise z source: load a generator's flax variables,
convert them, generate n images of one word and write them. The variables
come from the newest export of a train run's model directory (`--model-dir`,
written by `python -m scrabblegan_torch.train --workdir`, with the run's
config.json found beside it, as `infer.py --model-dir` finds it), or from a
flat .npz (`--weights`, e.g. written by scripts/export_generator_npz.py from
a JAX export).

Usage:
  python -m scrabblegan_torch.infer (--model-dir W/model | --weights g.npz)
      --word machinelearning -n 10 --device cuda --out out.npy
      [--config cfg.json] [--set KEY=VALUE]

`--out` ending in .png writes an image grid (needs matplotlib); any other
name writes a float32 .npy of shape (n, 32, 16*len(word), C) in [-1, 1], the
layout of the JAX generator's output.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from scrabblegan_torch import resolve_device
from scrabblegan_torch.config import discover_config
from scrabblegan_torch.convert import generator_from_flax, load_flax_npz
from scrabblegan_torch.data.loaders import encode_word
from scrabblegan_torch.models.build import noise_config
from scrabblegan_torch.train.checkpoint import latest_generator_export, load_export
from scrabblegan_torch.utils.viz import save_image_grid


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Generate handwritten word images with the PyTorch port.",
        epilog="z is drawn from numpy's np.random.default_rng(--seed), so a seed "
               "gives other images than the JAX infer.py, whose z comes from "
               "jax.random.")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model-dir",
                     help="model dir holding generator/<n>/ exports (the newest is "
                          "served), or one export's directory")
    src.add_argument("--weights",
                     help="flat .npz of the generator's flax variables, keyed by "
                          "flax paths joined with '.'")
    p.add_argument("--word", default="machinelearning")
    p.add_argument("-n", "--num-samples", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="inference.npy")
    p.add_argument("--config", default=None,
                   help="the config the generator was trained with (its shape "
                        "mode and dtype); default: the one beside a --model-dir "
                        "export, else the library defaults")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg_path = args.config
    if args.model_dir:
        export = latest_generator_export(args.model_dir) or args.model_dir
        variables = load_export(export)
        if cfg_path is None:
            cfg_path = discover_config(export)
            print(f"serving {export} with config {cfg_path}")
    else:
        variables = load_flax_npz(args.weights)
    cfg = noise_config(cfg_path, dict(kv.split("=", 1) for kv in args.set))
    device = resolve_device(args.device)
    generator = generator_from_flax(variables, cfg, device)

    n = args.num_samples
    labels = np.asarray([encode_word(args.word, cfg.io.char_vec)] * n, np.int64)
    z = np.random.default_rng(args.seed).standard_normal((n, cfg.shared.latent_dim))
    with torch.inference_mode():
        images = generator(torch.from_numpy(labels).to(device),
                           torch.from_numpy(z.astype(np.float32)).to(device))
    preds = images.float().permute(0, 2, 3, 1).cpu().numpy()  # NHWC
    if args.out.endswith(".png"):
        save_image_grid(preds, labels, args.out, cfg.io.char_vec, grid=(n, 1))
    else:
        np.save(args.out, preds)
    print(f"wrote {args.out}: {n} samples of '{args.word}' "
          f"({preds.shape[1]}x{preds.shape[2]}px) on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
