"""The port's raw-data converter (`scrabblegan_torch.data.iam`) and the
real-data campaign config through the port's train CLI, on the CPU.

- A fabricated raw IAM tree (grey PNG word images of random sizes in IAM's
  nested `words/<form>/<line>/` layout, and a `words.txt` with comments,
  segmentation 'err' lines, non-alphabetic and too-long words) goes through
  the port's `init_reading` and the JAX package's: the same bucket
  directories, file names and label files, and images of the same shapes
  whose grey levels differ by at most 1 (JAX resizes through cv2's
  fixed-point uint8 path, the port in float32 and rounds). The RIMES
  handler likewise, and `DATASET_HANDLERS` / `register_dataset`.
- `configs/iam_campaign.json` (padded, EMA, 'independent' pairing,
  `io.stall_timeout_s` 900 left on) through `python -m
  scrabblegan_torch.train` on a missing `io.read_dir`: the raw tree is
  converted on the first run, then the Trainer trains at full width, cut to
  1 epoch of 2 batches of 4 words of up to 3 characters, with the watchdog
  beating its heartbeat file (the networks filled by test_torch_loop.py's
  `fast_state`; flax's initialisers are tested in test_torch_train_cli.py).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from scrabblegan_tpu.data import iam as jax_iam
from scrabblegan_torch.data import iam
from scrabblegan_torch.data.images import read_grayscale, write_grayscale
from scrabblegan_torch.data.synthetic import make_synthetic_dataset
from scrabblegan_torch.train import loop
from scrabblegan_torch.train import main as train_main
from test_torch_loop import fast_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "iam_campaign.json")
LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def fabricate_iam(root: str, n: int = 60, seed: int = 0) -> str:
    """<root>/words/aNN/aNN-000/<id>.png and <root>/gt/words.txt; returns
    the words directory."""
    rng = np.random.default_rng(seed)
    words = os.path.join(root, "words")
    lines = ["# iam words.txt: id ok/err graylevel components x y w h tag transcription"]
    for i in range(n):
        form = f"a{i % 3:02d}"
        line_dir = os.path.join(words, form, f"{form}-000")
        os.makedirs(line_dir, exist_ok=True)
        wid = f"{form}-000-{i:02d}"
        kind = i % 10
        length = int(rng.integers(1, 13))
        word = "".join(rng.choice(list(LETTERS), length))
        if kind == 7:
            word = word[:3] + "-" + word[3:]  # not alphabetic
        flag = "err" if kind == 8 else "ok"
        h, w = int(rng.integers(20, 90)), int(rng.integers(15, 400))
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        write_grayscale(os.path.join(line_dir, wid + ".png"), img)
        lines.append(f"{wid} {flag} 154 1 408 768 27 51 AT {word}")
    os.makedirs(os.path.join(root, "gt"))
    with open(os.path.join(root, "gt", "words.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return words + "/"


def tree(root: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            out[os.path.relpath(os.path.join(dirpath, fn), root)] = os.path.join(dirpath, fn)
    return out


def assert_same_tree(got_root: str, want_root: str) -> int:
    got, want = tree(got_root), tree(want_root)
    assert sorted(got) == sorted(want)
    for rel, path in want.items():
        if rel.endswith(".txt"):
            assert open(got[rel]).read() == open(path).read(), rel
        else:
            a, b = read_grayscale(got[rel]), read_grayscale(path)
            assert a.shape == b.shape, rel
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, rel
    return len(want)


def test_iam_converter_matches_jax(tmp_path):
    raw = fabricate_iam(str(tmp_path / "IAM"))
    with contextlib.redirect_stdout(io.StringIO()):
        n_port, lengths = iam.init_reading(raw, str(tmp_path / "port"), (32, 160, 1), 10)
        n_jax, jax_lengths = jax_iam.init_reading(raw, str(tmp_path / "jax"), (32, 160, 1), 10)
    assert n_port == n_jax > 20 and lengths == jax_lengths
    assert assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax")) == 2 * n_port
    for length, count in lengths.items():
        pngs = [p for p in os.listdir(tmp_path / "port" / str(length)) if p.endswith(".png")]
        assert len(pngs) == count
        assert read_grayscale(str(tmp_path / "port" / str(length) / pngs[0])).shape == (
            32, 16 * length)
    parsed = iam.parse_iam_words_txt(str(tmp_path / "IAM" / "gt" / "words.txt"))
    assert parsed == jax_iam.parse_iam_words_txt(str(tmp_path / "IAM" / "gt" / "words.txt"))
    assert "-1" in parsed.values()  # the 'err' lines


def test_rimes_handler_and_registry(tmp_path):
    rng = np.random.default_rng(1)
    raw = tmp_path / "rimes"
    raw.mkdir()
    gt = []
    for i, word in enumerate(["Madame", "le", "Directeur", "12", "votre", "a-b"]):
        img = rng.integers(0, 256, (40, 30 + 20 * i)).astype(np.uint8)
        write_grayscale(str(raw / f"w{i}.png"), img)
        gt.append(f"train/w{i}.png {word}")
    (raw / "ground_truth.txt").write_text("\n".join(gt) + "\n")
    with contextlib.redirect_stdout(io.StringIO()):
        got = iam.DATASET_HANDLERS["rimes"](str(raw), str(tmp_path / "port"), (32, 160, 1), 10)
        want = jax_iam.DATASET_HANDLERS["rimes"](str(raw), str(tmp_path / "jax"),
                                                 (32, 160, 1), 10)
    assert got == want and got[0] == 4
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    iam.register_dataset("mine", iam.init_reading)
    assert iam.DATASET_HANDLERS["mine"] is iam.init_reading and "iam" in iam.DATASET_HANDLERS


@pytest.fixture
def no_heavy_files(tmp_path):
    yield
    for heavy in (*tmp_path.rglob("state.pt"), *tmp_path.rglob("variables.npz")):
        heavy.unlink()


def test_campaign_config_converts_and_trains_with_the_watchdog(tmp_path, no_heavy_files,
                                                              monkeypatch):
    monkeypatch.setattr(loop, "create_train_state", fast_state)  # flax's initialisers: slow
    raw = fabricate_iam(str(tmp_path / "IAM"), n=120, seed=2)
    read_dir = str(tmp_path / "IAM" / "words-Reading")
    _, words_file, style_dir = make_synthetic_dataset(str(tmp_path / "synth"),
                                                      samples_per_bucket=2, bucket_size=3)
    workdir = tmp_path / "run"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_main([
            "--device", "cpu", "--config", CONFIG, "--workdir", str(workdir),
            "--epochs", "1", "--batches-per-epoch", "2",
            "--style-dir", style_dir, "--words-file", words_file,
            "--set", f"io.raw_dir={raw}", "--set", f"io.read_dir={read_dir}",
            "--set", "io.bucket_size=3", "--set", "shared.batch_size=4",
            "--set", "io.buf_size=8", "--set", "shared.num_gen=4",
            "--set", "optimizer.ema_standing_stat_batches=2",
            "--set", "io.export_quality_samples=4",
            # no 1.3 GB checkpoint: the tests of the suite share one disk
            "--set", "io.ckpt_every=0"])
    assert rc == 0
    log = out.getvalue()
    assert "converting dataset to GAN-Reading format" in log and "Time for epoch 1" in log
    assert sorted(os.listdir(read_dir)) == ["1", "2", "3"]
    assert (workdir / ".heartbeat").exists()  # the watchdog ran: stall_timeout_s 900
    with open(workdir / "config.json") as f:
        persisted = json.load(f)
    assert persisted["io"]["stall_timeout_s"] == 900
    assert persisted["parallel"]["shape_mode"] == "padded"
    assert persisted["parallel"]["bucket_pairing"] == "independent"
    assert (workdir / "output" / "image_at_epoch_0001.png").exists()
    assert (workdir / "model" / "generator" / "1").is_dir()
