"""Checkpoints, resume and exports of the PyTorch port (CPU).

- `python -m scrabblegan_torch.train --workdir`: 2 steps, a checkpoint, a
  second run that resumes and takes 1 more step, bitwise equal to 3 steps
  taken at once (every tensor of the two step-3 checkpoints and of the two
  exports); at full width, batch 2, len 2, G EMA on with 2 standing-stat
  batches, with the DCGAN D and the BiLSTM R (`shared.my_disc`,
  `shared.my_rec`), whose dropout is on: the resumed step 3 draws the masks
  the uninterrupted one draws (the state's dropout seed and step counter
  come back from the checkpoint);
- `python -m scrabblegan_torch.infer --model-dir --z-source noise` serves
  the newest export: the images of G under its EMA weights with standing
  statistics computed here by committing train-mode forwards into a copy of
  G;
- `save_state` keeps the newest three, writes atomically, and
  `restore_state` refuses a state of another layout; the newest complete
  export is found."""

import contextlib
import copy
import io
import itertools
import os

import numpy as np
import pytest
import torch

from scrabblegan_torch import convert, infer
from scrabblegan_torch.config import load_config
from scrabblegan_torch.data.synthetic import synthetic_feed
from scrabblegan_torch.models.build import ModelBundle, noise_config
from scrabblegan_torch.ops import dropout
from scrabblegan_torch.ops.layers import commit_stats, record_stats
from scrabblegan_torch.train import checkpoint, main
from scrabblegan_torch.train.optim import OptState
from scrabblegan_torch.train.state import NETWORKS, TrainState
from scrabblegan_torch.train.step import normalize_images

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

SETS = {"optimizer.g_ema_decay": "0.999", "optimizer.ema_standing_stat_batches": "2",
        "shared.my_disc": "1", "shared.my_rec": "1"}
ARGS = ["--device", "cpu", "--config", "none", "--batch-size", "2", "--length", "2"]
ARGS += [a for k, v in SETS.items() for a in ("--set", f"{k}={v}")]


def run(*argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main([*ARGS, *argv]) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Workdir A: 3 steps in one run. Workdir B: 2 steps, then 1 resumed."""
    root = tmp_path_factory.mktemp("runs")
    cfg = load_config(None, SETS)
    init = root / "vars.npz"
    convert.save_flax_npz(str(init), {
        net[0]: convert.fake_flax_variables(cfg, 1, net)
        for net in ("generator", "discriminator", "recognizer")} | {
        "w": convert.fake_flax_variables(cfg, 1, "style_promoter")})
    logs = {"A": run("--init", str(init), "--steps", "3", "--workdir", str(root / "A")),
            "B1": run("--init", str(init), "--steps", "2", "--workdir", str(root / "B")),
            "B2": run("--init", str(init), "--steps", "1", "--workdir", str(root / "B"))}
    yield root, cfg, logs
    # ~4.8 GB at full width, which pytest would keep in its last three base
    # temporary directories: the suite's full-width tests share one disk
    for heavy in (init, *root.rglob("state.pt"), *root.rglob("variables.npz")):
        heavy.unlink()


def assert_same(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def test_resume_is_bitwise_equal_to_an_uninterrupted_run(runs):
    root, _, logs = runs
    assert "resumed" not in logs["B1"] and "resumed from checkpoint at step 2" in logs["B2"]
    assert "step 3: d_loss=" in logs["B2"] and "step 3: d_loss=" in logs["A"]
    assert checkpoint._numbered(str(root / "B" / "checkpoints"), checkpoint.STATE_FILE) == [2, 3]
    a, b = (torch.load(root / w / "checkpoints" / "3" / checkpoint.STATE_FILE,
                       weights_only=True) for w in "AB")
    assert a["step"] == 3 and a["g_ema"] is not None
    assert_same(a, b)
    for net in ("generator", "recognizer"):
        ea, eb = (checkpoint.load_export(str(root / w / "model" / net / "3")) for w in "AB")
        fa, fb = convert.flatten(ea), convert.flatten(eb)
        assert sorted(fa) == sorted(fb)
        for path in fa:
            np.testing.assert_array_equal(fa[path], fb[path], err_msg="/".join(path))
        assert (root / "B" / "model" / net / "3" / "config.json").is_file()
    for d in ("", "checkpoints", "model"):
        assert (root / "B" / d / "config.json").is_file()


def test_infer_model_dir_serves_the_ema_export(runs, tmp_path):
    root, cfg, _ = runs
    npy = tmp_path / "cab.npy"
    # the run trained G with the style z source; served here with noise z
    assert infer.main(["--model-dir", str(root / "B" / "model"), "--word", "cab", "-n", "2",
                       "--z-source", "noise", "--device", "cpu", "--out", str(npy)]) == 0
    served = np.load(npy)

    tree = convert.load_flax_npz(str(root / "vars.npz"))
    state = convert.state_from_flax(cfg, {n: tree[n]["params"] for n in "gdrw"},
                                    {n: tree[n].get("batch_stats", {}) for n in "gdrw"})
    assert checkpoint.restore_state(str(root / "B" / "checkpoints"), state)[1] == 3
    G = copy.deepcopy(state.models.generator)  # train mode
    with torch.no_grad():
        for p, e in zip(G.parameters(), state.g_ema):
            p.copy_(e)
    for batch, _ in itertools.islice(synthetic_feed(cfg, 2, 2, seed=1), 2):
        with torch.no_grad(), record_stats() as record:
            G(torch.as_tensor(batch["fake_labels"]), None, None,
              style_imgs=normalize_images(batch["style_imgs"], torch.device("cpu")))
        commit_stats(record)
    assert not torch.equal(G.final_bn.running_mean, state.models.generator.final_bn.running_mean)
    serving = convert.generator_from_flax(convert.to_flax(G), noise_config(None, SETS))
    labels = torch.tensor([[2, 0, 1]] * 2)
    z = np.random.default_rng(0).standard_normal((2, cfg.shared.latent_dim))
    with torch.inference_mode():
        want = serving(labels, torch.from_numpy(z.astype(np.float32))).permute(0, 2, 3, 1)
    assert served.shape == (2, 32, 48, 1)
    np.testing.assert_allclose(served, want.numpy(), rtol=1e-6, atol=1e-6)


def tiny_state(seed: int, ema: bool = True, width: int = 3) -> TrainState:
    gen = torch.Generator().manual_seed(seed)
    mods = []
    for _ in NETWORKS:
        m = torch.nn.Linear(width, 2)
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))
        mods.append(m)
    opt = {n: OptState(torch.tensor(seed, dtype=torch.int32),
                       [torch.randn(2, width, generator=gen), torch.randn(2, generator=gen)])
           for n in NETWORKS}
    g_ema = [p.detach() + 1 for p in mods[0].parameters()] if ema else None
    return TrainState(ModelBundle(*mods), opt, step=seed, g_ema=g_ema)


def test_save_state_keeps_the_newest_three_and_checks_the_layout(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    assert checkpoint.restore_state(ckpt, tiny_state(0)) == (None, 0)
    for step in range(1, 6):
        checkpoint.save_state(ckpt, tiny_state(step), step)
    assert sorted(os.listdir(ckpt)) == ["3", "4", "5"]  # no temporary directory left
    checkpoint.save_state(ckpt, tiny_state(5), 5)  # a step saved again replaces it
    assert sorted(os.listdir(ckpt)) == ["3", "4", "5"]
    restored, step = checkpoint.restore_state(ckpt, tiny_state(0))
    want = tiny_state(5)
    assert step == 5 and restored.step == 5
    for net in NETWORKS:
        assert_same(restored.modules()[net].state_dict(), want.modules()[net].state_dict())
        assert restored.opt_states[net].count == 5
        assert_same(restored.opt_states[net].nu, want.opt_states[net].nu)
    assert_same(restored.g_ema, want.g_ema)
    with pytest.raises(ValueError, match="EMA"):
        checkpoint.restore_state(ckpt, tiny_state(0, ema=False))
    with pytest.raises(RuntimeError):
        checkpoint.restore_state(ckpt, tiny_state(0, width=4))


def test_resume_continues_the_dropout_stream(tmp_path):
    """The BiLSTM R's dropout masks are a function of the state's dropout
    seed and its step counter (ops/dropout.py): both come back from a
    checkpoint, so the resumed run's next step draws the masks the
    uninterrupted run's would."""
    ckpt = str(tmp_path / "ckpt")
    state = tiny_state(4)
    state.dropout_seed.fill_(11)
    checkpoint.save_state(ckpt, state, 4)
    restored, _ = checkpoint.restore_state(ckpt, tiny_state(0))
    assert int(restored.dropout_seed) == 11 and int(restored.step_t) == 4
    masks = [dropout.keep_mask(dropout.step_key(s.dropout_seed, s.step_t), 0, (64, 32), 0.5)
             for s in (state, restored)]
    assert torch.equal(*masks)


def test_latest_export_is_the_newest_complete_one(tmp_path):
    cfg = load_config(None)
    tree = {"params": {"k": np.ones((2, 2), np.float32)}}
    assert checkpoint.latest_generator_export(str(tmp_path)) is None
    for n in (2, 10):
        checkpoint.save_generator(str(tmp_path), tree, n, cfg)
    (tmp_path / "generator" / "11").mkdir()  # no variables: not an export
    latest = checkpoint.latest_generator_export(str(tmp_path))
    assert latest == str(tmp_path / "generator" / "10")
    assert checkpoint.latest_recognizer_export(str(tmp_path)) is None
    np.testing.assert_array_equal(checkpoint.load_export(latest)["params"]["k"], tree["params"]["k"])
    assert load_config(os.path.join(latest, "config.json")) == cfg
