"""The port's train entry point on the CPU: `scrabblegan_torch.train.main`
takes steps at the full widths (batch 2), exports G, and the inference CLI
serves that export with noise z, as JAX's `infer.py --z-source noise` serves
a style-trained export; `--init` loads a flax-layout .npz of the four
networks; `create_train_state` draws flax's initialisers."""

import numpy as np
import pytest
import torch

from scrabblegan_tpu.config import load_config
from scrabblegan_torch import convert, infer
from scrabblegan_torch.train import main
from scrabblegan_torch.train.state import create_train_state, init_fill
from scrabblegan_torch.train.step import METRIC_NAMES

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)


def test_train_cli_steps_exports_and_serves(tmp_path, capsys):
    g_path = tmp_path / "g.npz"
    assert main(["--device", "cpu", "--steps", "2", "--config", "none", "--batch-size", "2",
                 "--length", "2", "--export-g", str(g_path)]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 2 and all(f"{m}=" in lines[0] for m in METRIC_NAMES)
    assert "steps/s" in out and "nan" not in out
    npy = tmp_path / "cab.npy"
    assert infer.main(["--weights", str(g_path), "--word", "cab", "-n", "2", "--device", "cpu",
                       "--out", str(npy)]) == 0
    images = np.load(npy)
    assert images.shape == (2, 32, 48, 1) and np.isfinite(images).all()
    assert np.abs(images).max() <= 1.0


def test_train_cli_init_from_npz_padded(tmp_path, capsys):
    """A flax-layout .npz of the four networks, padded shape mode."""
    cfg = load_config(None, {"parallel.shape_mode": "padded", "io.bucket_size": 3})
    tree = {net[0]: convert.fake_flax_variables(cfg, 1, net)
            for net in ("generator", "discriminator", "recognizer", "style_promoter")}
    path = tmp_path / "vars.npz"
    convert.save_flax_npz(str(path), {"g": tree["g"], "d": tree["d"], "r": tree["r"],
                                      "w": tree["s"]})
    assert main(["--device", "cpu", "--steps", "1", "--config", "none", "--batch-size", "2",
                 "--set", "parallel.shape_mode=padded", "--set", "io.bucket_size=3",
                 "--init", str(path)]) == 0
    assert "step 1: d_loss=" in capsys.readouterr().out


def test_create_train_state_uses_flax_initialisers():
    state = create_train_state(load_config(None, {"optimizer.g_ema_decay": 0.5}), seed=3)
    G, R = state.models.generator, state.models.recognizer
    w = G.up_B1.conv.weight.detach()  # orthogonal over flax's (-1, out) matrix
    mat = w.movedim(0, -1).reshape(-1, w.shape[0])
    torch.testing.assert_close(mat.T @ mat, torch.eye(w.shape[0]), rtol=0, atol=1e-5)
    # sigma is the init power iteration's estimate (tests/test_torch_state.py):
    # 1 for a kernel with orthonormal columns, up to rounding
    assert float(G.attn_B3.sigma) == 0.0 and abs(float(G.up_B1.conv.sigma) - 1.0) < 1e-5
    assert float(R.conv1.bias.abs().max()) == 0.0
    fan_in = 9 * 64  # lecun normal, truncated at 2 std
    std = np.sqrt(1 / fan_in) / 0.87962566103423978
    assert float(R.conv2.weight.abs().max()) <= 2 * std + 1e-6
    assert abs(float(R.conv2.weight.std()) - np.sqrt(1 / fan_in)) < 0.1 * np.sqrt(1 / fan_in)
    bank = G.filter_bank.bank.detach()
    limit = np.sqrt(6 / (32 * 52 + 8192 * 52))
    assert float(bank.abs().max()) <= limit and float(bank.abs().max()) > 0.9 * limit
    assert state.g_ema is not None and state.step == 0
    again = init_fill({("params", "k"): ((3, 4), "orthogonal")}, seed=3)
    np.testing.assert_array_equal(again["params"]["k"],
                                  init_fill({("params", "k"): ((3, 4), "orthogonal")}, 3)["params"]["k"])
    with pytest.raises(ValueError, match="initialiser"):
        init_fill({("params", "k"): ((3,), "bogus")})
