"""The port's epoch Trainer (`scrabblegan_torch.train.loop`) on the CPU, at
the networks' full widths, batch 2, `io.bucket_size` 3 (images 32 x 48),
`shared.num_gen` 2, `io.export_quality_samples` 4, EMA with 2
standing-statistics batches, `io.ckpt_every` 2:

- in padded mode (here) and in bucketed mode (test_torch_loop_bucketed.py),
  2 epochs of 2 batches, then a second
  Trainer on the same workdir that resumes at step 4 (epoch 4 // 2 = 2) and
  runs epoch 3: the JAX Trainer's artifact set (summaries with 16 columns
  and appended rows, grids with their label files, the GIF, checkpoints at
  the cadence and the last epoch, G and R exports numbered by epoch,
  quality_<epoch>.json and the latest_good link where the gate said 'ok',
  config.json), the resumed state's step; in padded mode then the export
  CLI (`python -m scrabblegan_torch.export`) on the run's model dir, whose
  bundle serves the eager G's images of the export it chose, bitwise;
- host syncs: while the batch loop runs, `.cpu()`, `.item()`, `.tolist()`
  and `float()` on a tensor are counted: one call a flush block of
  `flush_every` steps (here 2), not 16 a step; the `--steps` mode of the
  CLI fetches its printed metrics once a step;
- the divergence guard: a step made to return NaN stops the run at the
  flush that shows it, before any artifact;
- `io.stall_timeout_s` > 0 no longer raises: the Trainer starts the stall
  watchdog (utils/watchdog.py; its own tests are test_torch_watchdog.py).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from scrabblegan_torch import infer
from scrabblegan_torch.config import discover_config, load_config
from scrabblegan_torch.convert import fake_flax_variables, generator_from_flax, state_from_flax
from scrabblegan_torch.data.images import read_grayscale
from scrabblegan_torch.data.synthetic import make_synthetic_dataset
from scrabblegan_torch.export import main as export_main
from scrabblegan_torch.train import checkpoint, cli, loop
from scrabblegan_torch.train.export import load_exported_generator
from scrabblegan_torch.train import main as train_main
from scrabblegan_torch.train.step import METRIC_NAMES

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

BASE = {"shared.batch_size": "2", "io.bucket_size": "3", "shared.num_gen": "2",
        "io.export_quality_samples": "4", "optimizer.g_ema_decay": "0.999",
        "optimizer.ema_standing_stat_batches": "2", "io.ckpt_every": "2", "io.log_every": "2",
        "shared.trunk_dtype": "bfloat16"}
MODES = {"padded": {"parallel.shape_mode": "padded"}, "bucketed": {}}
FETCHES = ("cpu", "item", "tolist", "__float__")


class SyncCounter:
    """Counts the calls that copy a tensor to the host, while `on`."""

    def __init__(self, monkeypatch):
        self.count, self.on = 0, True
        for name in FETCHES:
            original = getattr(torch.Tensor, name)

            def wrapper(t, *a, _original=original, **k):
                if self.on:
                    self.count += 1
                return _original(t, *a, **k)
            monkeypatch.setattr(torch.Tensor, name, wrapper)

    @contextlib.contextmanager
    def paused(self):
        self.on = False
        try:
            yield
        finally:
            self.on = True


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    read_dir, words_file, style_dir = make_synthetic_dataset(str(root), samples_per_bucket=4,
                                                             bucket_size=3)
    return {"read_dir": read_dir, "style_dir": style_dir, "words_file": words_file}


def fast_state(cfg, seed=0, device="cpu"):
    """`create_train_state`'s stand-in in these tests: the same networks and
    layout, filled by `convert.fake_flax_variables` (seconds, where flax's
    orthogonal initialisers take ~25 s on one CPU thread at full width;
    they are tested in test_torch_train_cli.py)."""
    trees = {n: fake_flax_variables(cfg, seed, name) for n, name in zip(
        "gdrw", ("generator", "discriminator", "recognizer", "style_promoter"))}
    return state_from_flax(cfg, {n: t["params"] for n, t in trees.items()},
                           {n: t.get("batch_stats", {}) for n, t in trees.items()}, device)


def run(cfg, workdir, data, epochs, resume):
    trainer = loop.Trainer(cfg, workdir=str(workdir), device="cpu")
    trainer.load_data(**data)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = trainer.train(epochs=epochs, batches_per_epoch=2, resume=resume)
    return trainer, state, out.getvalue()


def export_bundle(workdir):
    """`python -m scrabblegan_torch.export` on the run's model dir (batch 2,
    length 2, on the CPU) into <workdir>/bundle, and beside it the eager G's
    images of the export it chose, on the inputs the test serves."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert export_main(["--model-dir", str(workdir / "model"), "--out",
                            str(workdir / "bundle"), "--batch-size", "2", "--length", "2",
                            "--device", "cpu"]) == 0
    chosen = infer.pick_export(str(workdir / "model"), "auto")
    cfg = load_config(discover_config(chosen))
    g = generator_from_flax(checkpoint.load_export(chosen), cfg, "cpu")
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 52, (2, 2)).astype(np.int32)
    style = rng.uniform(-1, 1, (2, 32, 160, 1)).astype(np.float32)
    with torch.no_grad():
        want = g(torch.from_numpy(labels).long(),
                 style_imgs=torch.from_numpy(style).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.savez(workdir / "bundle_inputs.npz", labels=labels, style=style, want=want.numpy())
    return out.getvalue()


def train_and_resume(mode, data, workdir, export=False):
    """2 epochs of 2 batches, then 1 more epoch that resumes; the host
    fetches of the first run's batch loops are counted (state set-up and
    the epoch artifacts are not the loop's). With `export`, the export CLI
    then writes a serving bundle of the run's model dir (`export_bundle`)."""
    mp = pytest.MonkeyPatch()
    counter = SyncCounter(mp)
    mp.setattr(loop, "create_train_state", fast_state)
    for name in ("init_state", "save_epoch_artifacts"):
        def uncounted(self, *a, _original=getattr(loop.Trainer, name), **k):
            with counter.paused():
                return _original(self, *a, **k)
        mp.setattr(loop.Trainer, name, uncounted)
    cfg = load_config(None, {**BASE, **MODES[mode]})
    # the checkpoints (1.3 GB each) and exports take ~4 GB at full width; the
    # tests read their directories and the small files beside them, and the
    # resume reads only the checkpoint, so the first run's exports go first
    try:
        first = run(cfg, workdir, data, epochs=2, resume=False)
        fetches = counter.count
        for export in workdir.rglob("variables.npz"):
            export.unlink()
        second = run(cfg, workdir, data, epochs=3, resume=True)
        if export:
            export_bundle(workdir)
    finally:
        mp.undo()
        for heavy in (*workdir.rglob("state.pt"), *workdir.rglob("variables.npz")):
            heavy.unlink()
    return mode, cfg, workdir, first, second, fetches


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    return train_and_resume("padded", data, tmp_path_factory.mktemp("padded"), export=True)


def test_artifact_set_and_epoch_numbered_exports(runs):
    mode, cfg, workdir, first, second, _ = runs
    out = workdir / "output"
    lines = (out / "batch_summary.txt").read_text().splitlines()
    assert len(lines) == 1 + 4 + 2 and all(ln.count(";") == 15 for ln in lines)
    csv = (out / "batch_summary.csv").read_text().splitlines()
    assert csv[0].startswith("epoch,batch,") and [r.split(",")[:2] for r in csv[1:]] == [
        ["0", "0"], ["0", "1"], ["1", "0"], ["1", "1"], ["2", "0"], ["2", "1"]]
    assert len((out / "epoch_summary.txt").read_text().splitlines()) == 1 + 3
    for epoch in (1, 2, 3):
        grid = read_grayscale(str(out / f"image_at_epoch_{epoch:04d}.png"))
        assert grid is not None and grid.shape[0] == 4 * (32 + 4) + 4  # a 4 x 4 page
        words = (out / f"image_at_epoch_{epoch:04d}.txt").read_text().split()
        assert len(words) == 2 and all(w.isalpha() for w in words)
    assert (out / "biggan.gif").read_bytes()[:6] == b"GIF89a"
    ckpts = sorted(int(p) for p in os.listdir(workdir / "checkpoints") if p.isdigit())
    assert ckpts == [4, 6]  # epoch 2 (the cadence and the first run's last), epoch 3 (last)
    gens = workdir / "model" / "generator"
    for net in ("generator", "recognizer"):
        assert sorted(p for p in os.listdir(workdir / "model" / net) if p.isdigit()) == [
            "1", "2", "3"]
    flags = {}
    for epoch in (1, 2, 3):
        result = json.loads((gens / f"quality_{epoch}.json").read_text())
        assert result["metric"] == "rfid_rand" and np.isfinite(result["rfid_rand"])
        assert result["n_gen"] == 4 and result["n_real_half"] == 4
        flags[epoch] = result["flag"]
    good = [e for e, f in flags.items() if f == "ok"]
    link = gens / "latest_good"
    assert (os.readlink(link) == str(max(good))) if good else not link.exists()
    for d in ("", "checkpoints", "model", "model/generator/3"):
        assert load_config(str(workdir / d / "config.json")) == cfg
    assert "initialized networks" in first[2] and "Time for epoch 2" in first[2]


def test_resume_starts_at_the_checkpoint_s_epoch(runs):
    _, _, _, first, second, _ = runs
    assert first[1].step == 4 and second[1].step == 6
    assert "resumed from checkpoint at step 4" in second[2]
    assert ">3, 2/2" in second[2] and ">2," not in second[2] and ">1," not in second[2]
    assert len(second[0].epoch_secs) == 1 and len(second[0].artifact_secs) == 1


def test_export_cli_bundles_the_trainer_s_model_dir(runs):
    """The bundle the export CLI wrote from the Trainer's model dir (its
    config found beside the export, the style z source it was trained
    with) serves the eager G's images of that export, bitwise, and holds
    the down-block pool op of its style encoder."""
    _, cfg, workdir, *_ = runs
    call, meta = load_exported_generator(str(workdir / "bundle"))
    assert meta == {"batch_size": 2, "length": 2, "z_source": cfg.shared.z_source,
                    "latent_dim": cfg.shared.latent_dim, "img_hw": list(cfg.io.input_dim[:2]),
                    "device": "cpu", "dataflow": "nhwc1", "dtype": cfg.shared.dtype}
    inputs = np.load(workdir / "bundle_inputs.npz")
    assert cfg.shared.z_source == "style"
    np.testing.assert_array_equal(call(inputs["labels"], inputs["style"]).numpy(),
                                  inputs["want"])
    program = torch.export.load(str(workdir / "bundle" / "generator.pt2"))
    assert "scrabblegan.down_pool.default" in {str(n.target) for n in program.graph.nodes}


def test_one_host_fetch_a_flush_block(runs):
    """flush_every = min(32, log_every) = 2 and 2 batches an epoch: the
    block of each epoch is fetched once, at its end."""
    _, _, _, first, _, fetches = runs
    assert fetches == 2  # 2 epochs x 1 block; 16 a step would be 64


def test_steps_cli_fetches_its_metrics_once_a_step(monkeypatch, capsys):
    monkeypatch.setattr(cli, "create_train_state", fast_state)
    monkeypatch.setattr(cli, "make_chunked_train_step", fake_chunk_factory(nan_at=0))
    counter = SyncCounter(monkeypatch)
    assert train_main(["--device", "cpu", "--steps", "2", "--config", "none",
                       "--batch-size", "2", "--length", "2"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 2 and all(f"{m}=" in lines[1] for m in METRIC_NAMES)
    assert counter.count == 2


def test_steps_cli_runs_steps_per_call_a_call(monkeypatch, capsys):
    """`--steps 5` at `parallel.steps_per_call` 2 makes calls of 2, 2 and 1
    steps, fetches the metrics once a call, and feeds the chunk the batches
    and z that 5 calls of one step get: step s's from rng (seed, s)."""
    monkeypatch.setattr(cli, "create_train_state", fast_state)
    calls = {}
    for k in (2, 1):
        make = fake_chunk_factory(nan_at=0)
        calls[k] = []

        def recording(cfg, models, _make=make, _calls=calls[k], **kwargs):
            chunk = _make(cfg, models, **kwargs)

            def call(state, batches, z=None):
                _calls.append((batches, z))
                return chunk(state, batches, z)
            call.graphs = None
            return call
        monkeypatch.setattr(cli, "make_chunked_train_step", recording)
        counter = SyncCounter(monkeypatch)
        assert train_main(["--device", "cpu", "--steps", "5", "--config", "none",
                           "--batch-size", "2", "--length", "2",
                           "--set", f"parallel.steps_per_call={k}",
                           "--set", "shared.z_source=noise"]) == 0
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
        assert [ln.split(":")[0] for ln in lines] == [f"step {s}" for s in range(1, 6)]
        assert counter.count == len(calls[k]) == {2: 3, 1: 5}[k]
        monkeypatch.undo()
        monkeypatch.setattr(cli, "create_train_state", fast_state)
    assert [len(z) for _, z in calls[2]] == [2, 2, 1]
    for key in calls[1][0][0]:
        np.testing.assert_array_equal(np.concatenate([b[key] for b, _ in calls[2]]),
                                      np.concatenate([b[key] for b, _ in calls[1]]))
    np.testing.assert_array_equal(np.concatenate([z for _, z in calls[2]]),
                                  np.concatenate([z for _, z in calls[1]]))


def fake_step_factory(nan_at: int):
    """make_train_step's stand-in: no networks run; step `nan_at` (1-based)
    returns a NaN d_loss."""
    def make(cfg, models):
        def step(state, batch, z=None):
            state.step += 1
            bad = state.step == nan_at
            return {k: torch.tensor(float("nan") if bad and k == "d_loss" else 1.0)
                    for k in METRIC_NAMES}
        return step
    return make


def fake_chunk_factory(nan_at: int):
    """make_chunked_train_step's stand-in: K fake steps a call, their
    metrics as one (16, K) tensor."""
    make_step = fake_step_factory(nan_at)

    def make(cfg, models, **kwargs):
        step = make_step(cfg, models)

        def chunk(state, batches, z=None):
            k = len(next(iter(batches.values())))
            return torch.stack([torch.stack([m[n] for n in METRIC_NAMES])
                                for m in (step(state, None) for _ in range(k))], dim=1)
        chunk.graphs = None  # the CPU runs no graphs
        return chunk
    return make


def test_divergence_guard_stops_the_run(data, tmp_path, monkeypatch):
    monkeypatch.setattr(loop, "create_train_state", fast_state)
    monkeypatch.setattr(loop, "make_chunked_train_step", fake_chunk_factory(nan_at=2))
    cfg = load_config(None, {**BASE, "io.log_every": "1", "optimizer.g_ema_decay": "0"})
    trainer = loop.Trainer(cfg, workdir=str(tmp_path), device="cpu", verbose=False)
    trainer.load_data(**data)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer.train(epochs=2, batches_per_epoch=3, resume=False)
    assert trainer.diverged_at == (0, 1) and "DIVERGED" in out.getvalue()
    rows = (tmp_path / "output" / "batch_summary.txt").read_text().splitlines()[1:]
    # the NaN step's block is fetched one step later (the newest step stays
    # out of a fetch), so a third row is written, as in JAX
    assert len(rows) == 3 and rows[1].split(";")[0] == "nan"
    assert not [p for p in os.listdir(tmp_path / "checkpoints") if p.isdigit()]
    assert not (tmp_path / "model" / "generator").exists()
    assert not list((tmp_path / "output").glob("image_at_epoch_*"))


def test_unported_watchdog_raises(tmp_path, data, monkeypatch):
    """The watchdog is ported: `io.stall_timeout_s` > 0 raises no more. The
    Trainer starts it, it beats at each flush and after each epoch, touches
    the heartbeat file, and stops with the run."""
    monkeypatch.setattr(loop, "create_train_state", fast_state)
    monkeypatch.setattr(loop, "make_chunked_train_step", fake_chunk_factory(nan_at=0))
    cfg = load_config(None, {**BASE, "io.stall_timeout_s": "60", "io.ckpt_every": "0",
                             "io.export_quality_samples": "0"})
    trainer = loop.Trainer(cfg, workdir=str(tmp_path), device="cpu", verbose=False)
    trainer.load_data(**data)
    trainer.train(epochs=1, batches_per_epoch=2, resume=False)
    wd = trainer.watchdog
    assert wd is not None and wd._stop.is_set() and wd.beats >= 3
    assert (tmp_path / ".heartbeat").exists()
