"""No module of the benchmark imports JAX or the JAX package ``repro``:
each import's top-level name, the part before the first dot, is compared
whole, so ``repro_torch`` passes."""
import ast

import pytest

from perfbench import util

FILES = sorted(p for p in util.PKG.rglob("*.py"))


def top_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    util.PKG)))
def test_no_jax(path):
    assert not set(top_names(path)) & util.FORBIDDEN


def test_the_check_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_probe", types.ModuleType("x"))
    assert util.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.probe", types.ModuleType("x"))
    assert util.forbidden_loaded() == ["repro"]


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "weights.py", "counts.py", "traffic.py"):
        assert "repro_torch" not in set(top_names(util.PKG / name))


FAMILIES = sorted((util.PKG / "families").glob("*.py"))


@pytest.mark.parametrize("path", FAMILIES, ids=lambda p: p.name)
def test_a_family_imports_nothing_of_the_program(path):
    """A family file is the yardstick of its models: neither JAX nor the
    program that it judges (``test_no_jax`` covers it as well)."""
    assert path in FILES
    assert not set(top_names(path)) & (util.FORBIDDEN | {"repro_torch"})
