"""What the benchmark may import: no module under bench/ names ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` at its top level, and
none under bench/reference/ the system under test, ``repro_torch``.
Names compare whole, by the part before the first dot."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_the_check_compares_whole_top_level_names(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import repro_torch.core\nfrom repro_torch import x\n"
                 "import jaxtyping\n")
    names = top_level_imports(p)
    assert names == {"repro_torch", "jaxtyping"}
    assert not names & {"jax", "repro"}
