"""Loss curves from the Trainer's summaries, drawn without matplotlib.

Port of scrabblegan_tpu/utils/plotting.py (`plot_losses`): it reads
<base_path>/batch_summary.csv (train/metrics.py writes it), takes the
per-epoch means as pandas' `groupby("epoch").mean()` does, and writes the
JAX package's files with the JAX package's series:
- disc_loss_vis_per_epoch.png: disc_loss, disc_loss_fake, disc_loss_real;
- rec_gen_vis_per_epoch.png and rec_loss_vis_per_epoch.png: the recognizer
  and generator terms (`gradient_balance` picks the longer lists);
- with `info_per_batch`, disc_loss_vis_per_batch.png: the three disc terms
  of every row against the row's index.

Neither matplotlib nor pandas is on the card's machine: the CSV is read with
`csv`, and each plot is a small numpy raster (axes with ticks, one polyline
a series in its own grey level, a legend of swatches in the series' order,
no text) written by the port's PNG writer (data/images.py). The pixels
differ from matplotlib's; the series are `loss_series`'s.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from scrabblegan_torch.data.images import write_grayscale

DISC = ["disc_loss", "disc_loss_fake", "disc_loss_real"]
SIZE = (480, 640)  # matplotlib's default figure in pixels, (H, W)
MARGIN = 40
GREYS = (0, 96, 160, 48, 128, 192)  # a series' grey level, in the series' order


def plot_columns(info_per_batch: bool = True, gradient_balance: bool = False
                 ) -> list[tuple[str, str, list[str]]]:
    """(file name, x column, y columns) of each plot, in JAX's order; x is
    'epoch' for the per-epoch means and 'index' (the row) per batch."""
    if gradient_balance:
        rec_gen = ["r_loss_fake", "g_loss", "r_loss_balanced", "g_loss_final",
                   "r_loss_fake_std", "g_loss_std"]
        rec = ["r_loss_fake", "r_loss_real", "r_loss_balanced", "r_loss_fake_std",
               "g_loss_std"]
    else:
        rec_gen = ["r_loss_fake", "g_loss", "g_loss_final"]
        rec = ["r_loss_fake", "r_loss_real"]
    plots = [("disc_loss_vis_per_epoch.png", "epoch", DISC),
             ("rec_gen_vis_per_epoch.png", "epoch", rec_gen),
             ("rec_loss_vis_per_epoch.png", "epoch", rec)]
    if info_per_batch:
        plots.append(("disc_loss_vis_per_batch.png", "index", DISC))
    return plots


def read_summary(base_path: str) -> dict[str, np.ndarray]:
    """batch_summary.csv as {column: float64 values}."""
    with open(os.path.join(base_path, "batch_summary.csv"), newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    values = np.array([[float(v) for v in r] for r in body], np.float64).reshape(-1, len(header))
    return {name: values[:, i] for i, name in enumerate(header)}


def epoch_means(table: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """`groupby("epoch").mean().reset_index()`: one row an epoch, ascending;
    a NaN is skipped as pandas skips it (an infinity is not)."""
    epochs = np.unique(table["epoch"])
    out = {"epoch": epochs}
    for name, col in table.items():
        if name != "epoch":
            groups = [col[table["epoch"] == e] for e in epochs]
            out[name] = np.array([g[~np.isnan(g)].mean() if (~np.isnan(g)).any() else np.nan
                                  for g in groups])
    return out


def loss_series(base_path: str, info_per_batch: bool = True, gradient_balance: bool = False
                ) -> dict[str, dict[str, np.ndarray]]:
    """{file name: {x column: x, y column: y, ...}}, the numbers each plot
    draws."""
    table = read_summary(base_path)
    means = epoch_means(table)
    rows = {**table, "index": np.arange(len(table["epoch"]), dtype=np.float64)}
    out = {}
    for name, x, ys in plot_columns(info_per_batch, gradient_balance):
        frame = means if x == "epoch" else rows
        out[name] = {x: frame[x], **{y: frame[y] for y in ys}}
    return out


def _segment(canvas: np.ndarray, p0, p1, grey: int, width: int = 2) -> None:
    (y0, x0), (y1, x1) = p0, p1
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    ys = np.rint(np.linspace(y0, y1, n)).astype(int)
    xs = np.rint(np.linspace(x0, x1, n)).astype(int)
    h, w = canvas.shape
    for dy in range(width):
        for dx in range(width):
            yy, xx = np.clip(ys + dy, 0, h - 1), np.clip(xs + dx, 0, w - 1)
            canvas[yy, xx] = grey


def render(x: np.ndarray, series: list[np.ndarray], size: tuple[int, int] = SIZE) -> np.ndarray:
    """A (H, W) uint8 line plot: white ground, black axes with 5 ticks each,
    each series a polyline in GREYS' order (a non-finite point breaks its
    line), a legend of swatches at the top right."""
    h, w = size
    canvas = np.full(size, 255, np.uint8)
    left, right, top, bottom = MARGIN, w - MARGIN // 2, MARGIN // 2, h - MARGIN
    ys = np.concatenate([s[np.isfinite(s)] for s in series] + [np.zeros(0)])
    xf = x[np.isfinite(x)]
    x_lo, x_hi = (xf.min(), xf.max()) if xf.size else (0.0, 1.0)
    y_lo, y_hi = (ys.min(), ys.max()) if ys.size else (0.0, 1.0)
    x_hi, y_hi = (x_hi if x_hi > x_lo else x_lo + 1.0), (y_hi if y_hi > y_lo else y_lo + 1.0)

    def to_px(xv, yv):
        return (bottom - (yv - y_lo) / (y_hi - y_lo) * (bottom - top),
                left + (xv - x_lo) / (x_hi - x_lo) * (right - left))

    _segment(canvas, (bottom, left), (bottom, right), 0, 1)
    _segment(canvas, (top, left), (bottom, left), 0, 1)
    for t in np.linspace(0.0, 1.0, 5):
        px = left + t * (right - left)
        py = bottom - t * (bottom - top)
        _segment(canvas, (bottom, px), (bottom + 5, px), 0, 1)
        _segment(canvas, (py, left - 5), (py, left), 0, 1)
    for i, s in enumerate(series):
        grey = GREYS[i % len(GREYS)]
        for j in range(len(s) - 1):
            if np.isfinite(s[j]) and np.isfinite(s[j + 1]) and np.isfinite(x[j:j + 2]).all():
                _segment(canvas, to_px(x[j], s[j]), to_px(x[j + 1], s[j + 1]), grey)
        if len(s) == 1 and np.isfinite(s[0]):
            py, px = to_px(x[0], s[0])
            _segment(canvas, (py, px - 2), (py, px + 2), grey, 3)
        ly = top + 6 + 10 * i
        canvas[ly:ly + 6, right - 30:right - 6] = grey
    return canvas


def plot_losses(base_path: str, info_per_batch: bool = True,
                gradient_balance: bool = False) -> list:
    """Write the loss plots into base_path; returns their paths, in JAX's
    order."""
    outputs = []
    for name, series in loss_series(base_path, info_per_batch, gradient_balance).items():
        x, *ys = series.values()
        path = os.path.join(base_path, name)
        write_grayscale(path, render(np.asarray(x, np.float64), ys))
        outputs.append(path)
    return outputs
