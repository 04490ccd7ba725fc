"""The port's loss plots against the JAX package's (scrabblegan_tpu/utils/plotting.py).

On one batch_summary.csv written by the port's SummaryWriter (3 epochs of
uneven length, one NaN): the port writes the file names the JAX function
writes (matplotlib and pandas exist here, so the JAX function itself runs),
in both balance modes and without the per-batch plot; its series equal
pandas' `groupby("epoch").mean()` and the raw rows within 1e-6; the CLI
writes them with matplotlib and pandas unimportable. The pixels are the
port's own raster, not matplotlib's (a known divergence).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from scrabblegan_tpu.utils.plotting import plot_losses as jax_plot_losses
from scrabblegan_torch.data.images import read_grayscale
from scrabblegan_torch.train.metrics import SummaryWriter
from scrabblegan_torch.train.step import METRIC_NAMES
from scrabblegan_torch.utils.plotting import loss_series, plot_losses

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def summary(tmp_path_factory) -> Path:
    base = tmp_path_factory.mktemp("run") / "output"
    writer = SummaryWriter(str(base))
    rng = np.random.default_rng(0)
    for epoch, batches in enumerate((5, 3, 7)):
        for b in range(batches):
            row = dict(zip(METRIC_NAMES, rng.normal(size=len(METRIC_NAMES)) * (epoch + 1)))
            if (epoch, b) == (1, 2):
                row["g_loss"] = float("nan")
            writer.write_batch(epoch, b, row)
        writer.end_epoch()
    writer.close()
    return base


def _copy(summary: Path, dest: Path) -> Path:
    dest.mkdir()
    shutil.copy(summary / "batch_summary.csv", dest / "batch_summary.csv")
    return dest


@pytest.mark.parametrize("per_batch,balance", [(True, False), (True, True), (False, False)])
def test_same_files_as_jax(summary, tmp_path, per_batch, balance):
    jax_dir, port_dir = _copy(summary, tmp_path / "jax"), _copy(summary, tmp_path / "port")
    want = [os.path.basename(p) for p in jax_plot_losses(str(jax_dir), per_batch, balance)]
    got = [os.path.basename(p) for p in plot_losses(str(port_dir), per_batch, balance)]
    assert got == want
    for name in got:
        img = read_grayscale(str(port_dir / name))
        assert img.shape == (480, 640) and img.min() == 0 and img.max() == 255
        assert len(np.unique(img)) >= 3  # axes, ground and the series' greys


@pytest.mark.parametrize("balance", [False, True])
def test_series_equal_pandas(summary, balance):
    df = pd.read_csv(summary / "batch_summary.csv")
    means = df.groupby("epoch").mean().reset_index()
    rows = df.astype({"batch": "int32"}).reset_index()
    series = loss_series(str(summary), True, balance)
    assert len(series) == 4
    for name, cols in series.items():
        frame = rows if name.endswith("per_batch.png") else means
        for col, values in cols.items():
            np.testing.assert_allclose(values, frame[col].to_numpy(np.float64), rtol=1e-6,
                                       atol=1e-6, equal_nan=True, err_msg=f"{name} {col}")


def test_cli_without_matplotlib_or_pandas(summary, tmp_path):
    base = _copy(summary, tmp_path / "cli")
    code = (
        "import sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('matplotlib', 'pandas'):\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "from scrabblegan_torch.plot_losses import main\n"
        f"sys.exit(main(['--base-path', {str(base)!r}, '--gradient-balance']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert [line.split("/")[-1] for line in lines] == [
        "disc_loss_vis_per_epoch.png", "rec_gen_vis_per_epoch.png",
        "rec_loss_vis_per_epoch.png", "disc_loss_vis_per_batch.png"]
    assert all(line.startswith("wrote ") and os.path.isfile(line[6:]) for line in lines)
