"""The port's `infer` serves the z source G was trained with (CPU).

- A style-trained export (the default config: z_source='style', its style
  encoder in the tree) served by `python -m scrabblegan_torch.infer
  --model-dir` gives the images of JAX's infer.py path on the same
  variables: its `make_apply` on the JAX generator, with the style page
  built as infer.py builds it (cv2 read, 'area' height fit, white canvas),
  with `--style-image` (grey and RGB) and without one (a blank page); float32
  within 1e-4, the tolerance of tests/test_torch_generator.py;
- `--z-source noise` serves the same export from noise z, skipping the
  style encoder;
- `--export auto` serves `latest_good` when the newest epoch is flagged
  suspect, `--export latest` the newest;
- a .png out-file is written with matplotlib absent (the card's machine
  has none): a grey grid PNG and the words beside it.
"""

import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrabblegan_tpu.config import load_config as jax_load_config
from scrabblegan_tpu.data.images import read_grayscale as jax_read, resize as jax_resize
from scrabblegan_tpu.train.state import build_models as jax_build_models
from scrabblegan_torch import infer
from scrabblegan_torch.config import load_config
from scrabblegan_torch.convert import fake_flax_variables
from scrabblegan_torch.data.images import read_grayscale
from scrabblegan_torch.eval.gate import annotate_export
from scrabblegan_torch.train.checkpoint import save_generator

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4


@pytest.fixture(scope="module")
def jax_infer():
    """The root infer.py as a module (its `make_apply`)."""
    spec = importlib.util.spec_from_file_location("jax_infer_script", REPO / "infer.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """Exports 1 and 2 of a style-trained G (seeded weights, attention sigma
    != 0); the gate flagged epoch 1 'ok' and epoch 2 'suspect'."""
    root = tmp_path_factory.mktemp("model")
    cfg = load_config(None)
    assert cfg.shared.z_source == "style"
    for epoch in (1, 2):
        variables = fake_flax_variables(cfg, seed=epoch)
        assert "style_encoder" in variables["params"]
        save_generator(str(root), variables, epoch, cfg)
        annotate_export(str(root), epoch, {"flag": "ok" if epoch == 1 else "suspect"})
    return root


@pytest.fixture(scope="module")
def style_images(tmp_path_factory):
    root = tmp_path_factory.mktemp("style")
    rng = np.random.default_rng(3)
    grey = root / "grey.png"
    cv2.imwrite(str(grey), rng.integers(0, 256, (48, 210), np.uint8))  # shrunk to 32 x 140
    rgb = root / "rgb.png"
    cv2.imwrite(str(rgb), rng.integers(0, 256, (20, 150, 3), np.uint8))  # grown: cropped
    return {"grey": grey, "rgb": rgb}


def jax_style_page(path, h=32, w=160) -> np.ndarray:
    """infer.py's style page (infer.py:109-121)."""
    if path is None:
        return np.ones((h, w), np.float32)
    img = jax_read(str(path)).astype(np.float32)
    rate = h / img.shape[0]
    img = jax_resize(img, max(1, int(img.shape[1] * rate)), h)
    canvas = np.full((h, w), 255.0, np.float32)
    canvas[:, : min(w, img.shape[1])] = img[:, :w]
    return (canvas - 127.5) / 127.5


def serve(*argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert infer.main(["--device", "cpu", "--word", "cab", "-n", "2", *argv]) == 0
    return out.getvalue()


@pytest.mark.parametrize("style", [None, "grey", "rgb"])
def test_style_source_serves_what_jax_serves(model_dir, style_images, jax_infer, tmp_path,
                                             style):
    npy = tmp_path / "out.npy"
    args = ["--model-dir", str(model_dir), "--export", "latest", "--out", str(npy)]
    if style:
        args += ["--style-image", str(style_images[style])]
    log = serve(*args)
    assert "generator/2" in log and "z style" in log
    got = np.load(npy)

    cfg = jax_load_config(str(model_dir / "generator" / "2" / "config.json"))
    variables = fake_flax_variables(load_config(None), seed=2)
    variables = {c: jax.tree.map(jnp.asarray, t) for c, t in variables.items()}
    page = jax_style_page(style_images[style] if style else None)
    labels = np.asarray([[2, 0, 1]] * 2, np.int32)
    want = jax_infer.make_apply(jax_build_models(cfg).generator)(
        variables, labels, style_imgs=np.broadcast_to(page[None, ..., None], (2, 32, 160, 1)))
    assert got.shape == (2, 32, 48, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_noise_override_and_the_export_choice(model_dir, tmp_path):
    a, b, c = (tmp_path / f"{n}.npy" for n in "abc")
    log = serve("--model-dir", str(model_dir), "--out", str(a))  # --export auto
    assert "KNOWN-GOOD" in log and "generator/1" in log
    serve("--model-dir", str(model_dir), "--export", "latest", "--out", str(b))
    assert not np.array_equal(np.load(a), np.load(b))
    log = serve("--model-dir", str(model_dir), "--z-source", "noise", "--out", str(c))
    assert "z noise" in log and np.isfinite(np.load(c)).all()
    assert not np.array_equal(np.load(c), np.load(a))


def test_png_out_without_matplotlib(model_dir, style_images, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # `import matplotlib` raises
    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401
    png = tmp_path / "cab.png"
    serve("--model-dir", str(model_dir), "--style-image", str(style_images["grey"]),
          "--out", str(png))
    page = read_grayscale(str(png))
    assert page.shape == (2 * (32 + 4) + 4, 48 + 8)
    assert (tmp_path / "cab.txt").read_text().split() == ["cab", "cab"]
