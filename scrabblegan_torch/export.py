"""Export a trained generator of the port as a serving bundle.

Port of export_model.py, on `scrabblegan_torch.train.export`: the
generator's flax variables come from the newest export under `--model-dir`
(written by `python -m scrabblegan_torch.train`), or the newest one the
training-time gate flagged 'ok' when the newest epoch is flagged; its config
from `--config`, else the config.json beside the export; `--set` applies on
top. The bundle (generator.pt2 and meta.json) is traced on `--device` (the
card by default) under the attention dataflow of
$SCRABBLEGAN_ATTN_DATAFLOW ('nhwc1' when unset), so a bundle exported on a
card launches the hand-written attention kernel when it serves.

Usage:
  python -m scrabblegan_torch.export --model-dir runs/demo/model --out runs/demo/export \
      --batch-size 16 --length 5 [--z-source noise|style] [--config cfg.json] \
      [--set KEY=VALUE] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from scrabblegan_torch import resolve_device
from scrabblegan_torch.config import discover_config, load_config
from scrabblegan_torch.convert import generator_from_flax
from scrabblegan_torch.infer import pick_export
from scrabblegan_torch.train.checkpoint import load_export
from scrabblegan_torch.train.export import export_generator


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-dir", required=True,
                   help="dir containing generator/<n>/ exports (or a direct path)")
    p.add_argument("--out", required=True)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--length", type=int, default=5)
    p.add_argument("--z-source", default=None, choices=["noise", "style"])
    p.add_argument("--config", default=None)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    export = pick_export(args.model_dir, "auto")
    # model dirs are self-describing (a config.json beside every export); an
    # explicit --config wins, --set applies on top either way
    cfg_path = args.config or discover_config(export)
    if cfg_path and not args.config:
        print(f"using discovered config: {cfg_path}")
    cfg = load_config(cfg_path, dict(kv.split("=", 1) for kv in args.set))
    if args.z_source:
        cfg = dataclasses.replace(cfg, shared=dataclasses.replace(cfg.shared,
                                                                  z_source=args.z_source))
    generator = generator_from_flax(load_export(export), cfg, resolve_device(args.device))
    h, w, _ = cfg.io.input_dim
    out = export_generator(args.out, generator, args.batch_size, args.length,
                           cfg.shared.z_source, cfg.shared.latent_dim, (h, w))
    print(f"wrote serving bundle: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
