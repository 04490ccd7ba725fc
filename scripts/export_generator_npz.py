#!/usr/bin/env python
"""Flatten a JAX generator export (Orbax) into the .npz the PyTorch port loads.

  python scripts/export_generator_npz.py --model-dir runs/demo/model --out g.npz
  python -m scrabblegan_torch.infer --weights g.npz --config <its config.json> ...

Keys are the flax paths joined by '.', values float32 numpy arrays; this is
the format `scrabblegan_torch.convert.load_flax_npz` reads. The config the
generator was trained with (shape mode, dtype) is printed when it can be
found; pass it to the port's infer with --config.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def flatten_npz_dict(tree, prefix=()):
    """{'.'-joined flax path: numpy array} of a nested variables tree."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten_npz_dict(value, prefix + (key,)))
        else:
            out[".".join(prefix + (key,))] = np.asarray(value, np.float32)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", required=True,
                   help="model dir containing generator/<epoch>/, or a direct export path")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    from scrabblegan_tpu.utils.platform import apply_env_platform

    apply_env_platform()
    from scrabblegan_tpu.config import discover_config
    from scrabblegan_tpu.train.checkpoint import latest_generator_export, load_generator

    export = latest_generator_export(args.model_dir) or args.model_dir
    flat = flatten_npz_dict(load_generator(export))
    np.savez(args.out, **flat)
    print(f"wrote {args.out}: {len(flat)} arrays from {export}")
    cfg = discover_config(args.model_dir)
    if cfg:
        print(f"its config: {cfg}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
