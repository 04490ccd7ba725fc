"""Inference entry point of the port: a word -> handwritten word images.

Port of infer.py. The generator's flax variables come from an export of a
train run (`--model-dir`, written by `python -m scrabblegan_torch.train`;
its config.json is found beside it) or from a flat .npz (`--weights`, e.g.
written by scripts/export_generator_npz.py from a JAX export). G is served
with the z source it was trained with (the config's `shared.z_source`;
`--z-source` overrides):
- 'style': z is encoded from `--style-image` (read as grey, height-fit to
  32 px with 'area', right-cropped or white-padded to the 32 x 160 canvas),
  or from a blank white page without one;
- 'noise': z is drawn from numpy's `np.random.default_rng(--seed)`, so a
  seed gives other images than the JAX infer.py, whose z comes from
  jax.random.
A `--weights` tree without a style encoder is served with noise z unless
`--z-source style` asks otherwise (which then fails).

`--export auto` (the default) serves the newest export the training-time
gate flagged 'ok' (model/generator/latest_good) when the newest epoch is
flagged; `--export latest` serves the newest epoch regardless.

Usage:
  python -m scrabblegan_torch.infer (--model-dir W/model | --weights g.npz)
      --word machinelearning -n 10 [--device cuda] [--out out.png]
      [--z-source noise|style] [--style-image s.png] [--export auto|latest]
      [--config cfg.json] [--set KEY=VALUE]

`--out` ending in .png writes an image grid (one image a row) with the word
in a .txt beside it; any other name writes a float32 .npy of shape
(n, 32, 16*len(word), C) in [-1, 1], the layout of the JAX generator's
output.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from scrabblegan_torch import resolve_device
from scrabblegan_torch.config import Config, discover_config, load_config
from scrabblegan_torch.convert import generator_from_flax, load_flax_npz
from scrabblegan_torch.data.images import read_grayscale, resize
from scrabblegan_torch.data.loaders import encode_word
from scrabblegan_torch.eval.gate import latest_good_export
from scrabblegan_torch.train.checkpoint import latest_generator_export, load_export
from scrabblegan_torch.utils.viz import save_image_grid


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Generate handwritten word images with the "
                                            "PyTorch port.")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model-dir",
                     help="model dir holding generator/<n>/ exports, or one export's directory")
    src.add_argument("--weights",
                     help="flat .npz of the generator's flax variables, keyed by flax paths "
                          "joined with '.'")
    p.add_argument("--word", default="machinelearning")
    p.add_argument("-n", "--num-samples", type=int, default=10)
    p.add_argument("--z-source", default=None, choices=["noise", "style"],
                   help="default: the config the generator was trained with")
    p.add_argument("--style-image", default=None,
                   help="style image for z-source 'style' (default: a blank white page)")
    p.add_argument("--export", default="auto", choices=["auto", "latest"],
                   help="'auto' serves the newest export the quality gate flagged 'ok' "
                        "(model/generator/latest_good); 'latest' the newest epoch")
    p.add_argument("--seed", type=int, default=0, help="seed of the noise z")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="inference.png")
    p.add_argument("--config", default=None,
                   help="the config the generator was trained with; default: the one "
                        "beside a --model-dir export, else the library defaults")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    return p.parse_args(argv)


def pick_export(model_dir: str, mode: str) -> str:
    """The export to serve: the newest one, or under 'auto' the newest the
    gate flagged 'ok' when that is another."""
    export = latest_generator_export(model_dir) or model_dir
    if mode == "auto":
        good = latest_good_export(model_dir)
        if good and os.path.realpath(good) != os.path.realpath(export):
            print(f"serving latest KNOWN-GOOD export {good} (newest epoch is gate-flagged; "
                  "--export latest overrides)")
            export = good
    return export


def style_canvas(cfg: Config, path: str | None) -> np.ndarray:
    """The (h, w) style page in [-1, 1]: the image height-fit with 'area'
    and right-cropped or white-padded to the canvas, or a white page."""
    h, w, _ = cfg.io.input_dim
    if not path:
        return np.ones((h, w), np.float32)
    img = read_grayscale(path)
    if img is None:
        raise FileNotFoundError(f"cannot read the style image {path}")
    img = img.astype(np.float32)
    img = resize(img, max(1, int(img.shape[1] * h / img.shape[0])), h)
    canvas = np.full((h, w), 255.0, np.float32)
    canvas[:, : min(w, img.shape[1])] = img[:, :w]
    return (canvas - 127.5) / 127.5


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg_path = args.config
    if args.model_dir:
        export = pick_export(args.model_dir, args.export)
        variables = load_export(export)
        if cfg_path is None:
            cfg_path = discover_config(export)
        print(f"serving {export} with config {cfg_path}")
    else:
        variables = load_flax_npz(args.weights)
    cfg = load_config(cfg_path, dict(kv.split("=", 1) for kv in args.set))
    z_source = args.z_source or cfg.shared.z_source
    if z_source == "style" and "style_encoder" not in variables.get("params", {}):
        if args.z_source:
            raise SystemExit("--z-source style: the weights hold no style encoder")
        print("the weights hold no style encoder: serving noise z")
        z_source = "noise"
    cfg = dataclasses.replace(cfg, shared=dataclasses.replace(cfg.shared, z_source=z_source))
    device = resolve_device(args.device)
    generator = generator_from_flax(variables, cfg, device)

    n = args.num_samples
    labels = np.asarray([encode_word(args.word, cfg.io.char_vec)] * n, np.int64)
    labels_t = torch.from_numpy(labels).to(device)
    with torch.inference_mode():
        if z_source == "style":
            style = torch.from_numpy(style_canvas(cfg, args.style_image))
            style = style[None, None].expand(n, cfg.io.input_dim[2], -1, -1).to(device)
            images = generator(labels_t, style_imgs=style)
        else:
            z = np.random.default_rng(args.seed).standard_normal((n, cfg.shared.latent_dim))
            images = generator(labels_t, torch.from_numpy(z.astype(np.float32)).to(device))
    preds = images.float().permute(0, 2, 3, 1).cpu().numpy()  # NHWC
    if args.out.endswith(".png"):
        save_image_grid(preds, labels, args.out, cfg.io.char_vec, grid=(n, 1))
    else:
        np.save(args.out, preds)
    print(f"wrote {args.out}: {n} samples of '{args.word}' "
          f"({preds.shape[1]}x{preds.shape[2]}px, z {z_source}) on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
