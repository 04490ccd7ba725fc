"""Readings that the limits of `correct` are set from, on the card.

    python3 perfbench/control.py --workload <name> --seeds 1 2 3 ... [--seconds 3]

For each seed, in one process: a run of the cell as `perfbench/run.py` makes
it (set-up, a short window of its traffic, the program freed), then the
numbers the benchmark compares for the program (the lower readings), for the
control (the reference in the nearest precision below the configuration's,
in the program's place) and, for a train cell, for the fault of half of each
batch left out (the reference in the program's place). One JSON line a seed
and reading; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import common, run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = common.find_cell(common.manifest(), args.workload)[0]
    kind = common.traffic_file(cell["traffic"])["kind"]
    also = ("control", "half_batch") if kind == "train_steps" else ("control",)
    for seed in args.seeds:
        result = run.execute(args.workload, seed, args.seconds, False, "cuda:0", also=also)
        for reading in result["readings"]:
            reading["per_unit"] = reading["per_unit"][:64]
            print(json.dumps({"workload": args.workload, "seed": seed, **reading}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
