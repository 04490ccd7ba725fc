"""The port stands alone: no module of `scrabblegan_torch/` and no line of
`chip_smoke.py` imports JAX, flax, optax, orbax or the JAX package
`scrabblegan_tpu`, nor cv2, PIL, matplotlib, imageio or pandas (the card's
machine has none of them), and the port's own
copy of the config loads every file and override to the tree the JAX
package's loader builds."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

import numpy as np

from scrabblegan_tpu import config as jax_config
from scrabblegan_tpu.data import loaders as jax_loaders
from scrabblegan_torch import config as port_config
from scrabblegan_torch.data import loaders as port_loaders

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("scrabblegan_tpu", "jax", "jaxlib", "flax", "optax", "orbax")
IMAGE_LIBS = ("cv2", "PIL", "matplotlib", "imageio", "pandas")  # not even imported lazily
SOURCES = sorted(p.relative_to(ROOT).as_posix()
                 for p in (ROOT / "scrabblegan_torch").rglob("*.py")) + ["chip_smoke.py"]


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args
                and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("source", SOURCES)
def test_no_jax_import_in_the_port(source):
    assert not imported_roots(ROOT / source) & set(FORBIDDEN)


@pytest.mark.parametrize("source", SOURCES)
def test_no_image_library_import_in_the_port(source):
    assert not imported_roots(ROOT / source) & set(IMAGE_LIBS)


def test_every_port_module_imports_with_jax_refused():
    """A fresh interpreter whose import system refuses the forbidden names
    and the image libraries imports every module of the port."""
    code = f"""
import importlib, pkgutil, sys
FORBIDDEN = {FORBIDDEN + IMAGE_LIBS!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"refused: {{name}}")
        return None

sys.meta_path.insert(0, Refuse())
import scrabblegan_torch
names = [m.name for m in pkgutil.walk_packages(scrabblegan_torch.__path__, "scrabblegan_torch.")
         if not m.name.endswith(".__main__")]  # a __main__ runs its program
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
assert not loaded, loaded
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 30


OVERRIDES = {"shared.use_pallas_attention": "false", "io.bucket_size": "3",
             "optimizer.g_lr": "1e-4", "io.input_dim": "(32, 128, 1)",
             "parallel.shape_mode": "padded", "optimizer.ema_standing_stat_batches": 7}


@pytest.mark.parametrize("path", [None] + sorted(
    p.name for p in (ROOT / "configs").glob("*.json")))
def test_config_copy_loads_what_jax_loads(path):
    full = None if path is None else str(ROOT / "configs" / path)
    for overrides in (None, OVERRIDES):
        port = port_config.load_config(full, dict(overrides or {}))
        ref = jax_config.load_config(full, dict(overrides or {}))
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_config_round_trip_and_discovery(tmp_path):
    cfg = port_config.load_config(None, OVERRIDES)
    export = tmp_path / "model" / "generator" / "7"
    export.mkdir(parents=True)
    port_config.save_config(cfg, str(tmp_path / "config.json"))
    assert port_config.discover_config(str(export)) == str(tmp_path / "config.json")
    assert port_config.discover_config(str(export), max_up=1) is None
    assert port_config.load_config(str(tmp_path / "config.json")) == cfg
    assert jax_config.load_config(str(tmp_path / "config.json")) == jax_config.load_config(
        None, OVERRIDES)
    legacy = tmp_path / "legacy.json"
    legacy.write_text('{"optimizer": {"g_lr": 0.001}}')
    assert port_config.load_config(str(legacy)).optimizer.adam_impl == "optax"


def test_loader_copies_match_jax(tmp_path):
    words = tmp_path / "words.txt"
    words.write_text("cab\nHopper\nx\n\nnaïve\nmachinelearning\nauto\n")
    port = port_loaders.load_random_word_list(str(words), 10)
    assert port == jax_loaders.load_random_word_list(str(words), 10)
    assert port_loaders.encode_word("auto") == jax_loaders.encode_word("auto") == [0, 20, 19, 14]
    assert port_loaders.decode_label(port[5][0]) == "Hopper"
    for bucket in (3, 7):  # a length with words, and one without
        got, want = (m.sample_fake_labels(np.random.default_rng(5), port, 4, bucket)
                     for m in (port_loaders, jax_loaders))
        np.testing.assert_array_equal(got, want)
