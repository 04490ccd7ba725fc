"""Nothing under perfbench/ imports JAX or the JAX package, and the reference
imports nothing of the program. Names are compared whole by their top level
(the part before the first dot): the port's name begins with the JAX
package's."""

import ast

import pytest

from perfbench import common

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "scrabblegan_tpu"}
FILES = sorted(common.BENCH_DIR.rglob("*.py"))


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(common.BENCH_DIR)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((common.BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "scrabblegan_torch" not in names
    assert names <= {"__future__", "math", "torch", "perfbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("perfbench"):
            assert node.module.startswith("perfbench.reference"), node.module


def test_the_check_compares_whole_top_level_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import scrabblegan_torch.models\nfrom jax import numpy\n")
    assert top_level_imports(src) == {"scrabblegan_torch", "jax"}
    assert "scrabblegan_torch" not in FORBIDDEN and set(common.FORBIDDEN) == FORBIDDEN
