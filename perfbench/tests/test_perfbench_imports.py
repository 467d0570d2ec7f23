"""What perfbench/ imports, read from its sources: no module whose
top-level name (the part before the first dot, compared whole) is jax,
jaxlib, flax or latentsplat_tpu; the program's package,
latentsplat_tpu_torch, only outside the reference, which imports nothing
of the program. A run's own check of sys.modules is run.forbidden_modules."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "latentsplat_tpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def top_level_imports(path: Path) -> set:
    """Top-level names of the absolute imports anywhere in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_sources_are_found():
    assert len(SOURCES) > 40
    assert HERE / "run.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if "reference" in p.relative_to(HERE).parts],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (FORBIDDEN | {"latentsplat_tpu_torch", "perfbench"})
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            # A relative import stays inside perfbench/reference.
            depth = len(path.relative_to(HERE / "reference").parts) - 1
            assert node.level <= depth + 1, (path, node.module)


def test_the_check_compares_whole_top_level_names():
    from perfbench import run

    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "latentsplat_tpu")
    assert "latentsplat_tpu_torch".split(".")[0] not in run.FORBIDDEN
    assert run.forbidden_modules() == sorted(
        {m.split(".")[0] for m in __import__("sys").modules} & set(run.FORBIDDEN))
