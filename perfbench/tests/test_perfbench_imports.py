"""Nothing in the benchmark loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level names are compared
whole: ``repro_torch`` begins with ``repro``."""
import ast
from pathlib import Path

import pytest

from perfbench import spec
from perfbench.run import forbidden_modules

SOURCES = sorted(p for p in spec.HERE.rglob("*.py")
                 if "tests" not in p.relative_to(spec.HERE).parts)


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_modules_compares_whole_top_level_names():
    loaded = ["repro_torch", "repro_torch.occam", "reproduce", "jaxtyping",
              "repro", "repro.models", "jax.numpy", "jaxlib", "flax.linen",
              "torch"]
    assert forbidden_modules(loaded) == ["flax.linen", "jax.numpy",
                                         "jaxlib", "repro", "repro.models"]
    assert forbidden_modules(["repro_torch", "torch"]) == []


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        assert top_level_imports(path) <= {"__future__", "torch"}, path


def test_only_program_py_names_the_program():
    for path in SOURCES:
        if path.name != "program.py":
            assert "repro_torch" not in top_level_imports(path), path
