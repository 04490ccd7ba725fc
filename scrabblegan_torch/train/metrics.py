"""Per-batch and per-epoch summaries of the 16 step metrics.

The port's copy of scrabblegan_tpu/train/metrics.py (framework-free), file
for file: batch_summary.txt and epoch_summary.txt, ';'-separated, the
reference's 16 columns in its order and names (`_COLUMN_SOURCES` maps each
to a step metric), and batch_summary.csv with an epoch,batch prefix for the
plotter. `append=True` continues the files of a resumed run. The same rows
give byte-identical files in both packages.
"""

from __future__ import annotations

import os
from typing import Dict, List

HEADER_COLUMNS = (
    "disc_loss", "disc_loss_real", "disc_loss_fake",
    "r_loss_real", "r_loss_fake", "r_loss_balanced",
    "g_loss", "g_lossT", "g_lossS", "g_loss_final",
    "alpha", "r_loss_fake_std", "g_loss_std",
    "s_loss", "s_loss_real", "s_loss_fake",
)

# step-metric key -> summary column (reference naming quirk: g_lossT is the
# added/traditional term, g_lossS the balanced one; see data_utils.py:254,296-300)
_COLUMN_SOURCES = {
    "disc_loss": "d_loss", "disc_loss_real": "d_loss_real",
    "disc_loss_fake": "d_loss_fake",
    "r_loss_real": "r_loss_real", "r_loss_fake": "r_loss_fake",
    "r_loss_balanced": "r_loss_balanced",
    "g_loss": "g_loss", "g_lossT": "g_loss_added", "g_lossS": "g_loss_balanced",
    "g_loss_final": "g_loss_final",
    "alpha": "alpha", "r_loss_fake_std": "r_loss_fake_std",
    "g_loss_std": "g_loss_std",
    "s_loss": "s_loss", "s_loss_real": "s_loss_real", "s_loss_fake": "s_loss_fake",
}


class SummaryWriter:
    """Writes batch_summary.txt / epoch_summary.txt / batch_summary.csv."""

    def __init__(self, gen_path: str, append: bool = False):
        """append=True continues existing summaries (checkpoint resume) instead of
        truncating them."""
        os.makedirs(gen_path, exist_ok=True)
        mode = "a" if append else "w"
        fresh = not append or not os.path.exists(
            os.path.join(gen_path, "batch_summary.txt"))
        self.batch_txt = open(os.path.join(gen_path, "batch_summary.txt"), mode)
        self.epoch_txt = open(os.path.join(gen_path, "epoch_summary.txt"), mode)
        self.batch_csv = open(os.path.join(gen_path, "batch_summary.csv"), mode)
        if fresh:
            header = ";".join(HEADER_COLUMNS) + "\n"
            self.batch_txt.write(header)
            self.epoch_txt.write(header)
            self.batch_csv.write("epoch,batch," + ",".join(HEADER_COLUMNS) + "\n")
        self._epoch_acc: Dict[str, float] = {c: 0.0 for c in HEADER_COLUMNS}
        self._epoch_count = 0

    def _row(self, metrics: Dict[str, float]) -> List[float]:
        return [float(metrics[_COLUMN_SOURCES[c]]) for c in HEADER_COLUMNS]

    def write_batch(self, epoch: int, batch: int, metrics: Dict[str, float]) -> None:
        row = self._row(metrics)
        self.batch_txt.write(";".join(str(v) for v in row) + "\n")
        self.batch_csv.write(f"{epoch},{batch}," + ",".join(f"{v:.6g}" for v in row) + "\n")
        for c, v in zip(HEADER_COLUMNS, row):
            self._epoch_acc[c] += v
        self._epoch_count += 1

    def end_epoch(self) -> Dict[str, float]:
        n = max(self._epoch_count, 1)
        means = {c: self._epoch_acc[c] / n for c in HEADER_COLUMNS}
        self.epoch_txt.write(";".join(str(means[c]) for c in HEADER_COLUMNS) + "\n")
        self.batch_txt.flush()
        self.epoch_txt.flush()
        self.batch_csv.flush()
        self._epoch_acc = {c: 0.0 for c in HEADER_COLUMNS}
        self._epoch_count = 0
        return means

    def close(self) -> None:
        self.batch_txt.close()
        self.epoch_txt.close()
        self.batch_csv.close()
