"""What the benchmark's files import: never JAX, the JAX package, its old
harness or the bring-up script; the plain reference nothing of the port."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    """Each imported module's top-level name (the part before the first
    dot), from ``import`` and ``from ... import`` alike."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_check_compares_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.models\nfrom repro_torch import x\n")
    assert top_level_imports(f) == {"repro_torch"}
    f.write_text("from repro.models import y\n")
    assert top_level_imports(f) & FORBIDDEN == {"repro"}


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert len(files) > 3
    for path in files:
        assert top_level_imports(path) <= {"__future__", "contextlib",
                                           "dataclasses", "importlib", "math",
                                           "types", "typing", "torch",
                                           "reference"}, path
