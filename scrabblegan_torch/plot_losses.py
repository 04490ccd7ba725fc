"""Loss plots of a run: the port of the root plot_losses.py.

    python -m scrabblegan_torch.plot_losses --base-path runs/output
        [--gradient-balance] [--no-per-batch]

writes utils/plotting.py's PNGs next to the run's batch_summary.csv and
prints one `wrote <path>` line a file. Needs neither matplotlib nor pandas.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Plot a run's losses from batch_summary.csv.")
    p.add_argument("--base-path", required=True, help="the directory of batch_summary.csv")
    p.add_argument("--gradient-balance", action="store_true",
                   help="the gradient-balancing runs' longer column lists")
    p.add_argument("--no-per-batch", action="store_true", help="skip the per-batch plot")
    args = p.parse_args(argv)

    from scrabblegan_torch.utils.plotting import plot_losses

    for path in plot_losses(args.base_path, info_per_batch=not args.no_per_batch,
                            gradient_balance=args.gradient_balance):
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
