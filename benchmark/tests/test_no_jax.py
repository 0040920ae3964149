"""What runs on the card imports no JAX and nothing of the JAX package,
and the reference nothing of the program either: every import in the
benchmark's sources, by its top-level name compared whole (so
``mmgl_tpu_torch`` is not ``mmgl_tpu``); and the run's own look at
``sys.modules`` compares the same way."""

import ast
from pathlib import Path

from benchmark import run

HERE = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "mmgl_tpu"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def _sources(folder: Path):
    return [p for p in folder.rglob("*.py") if "tests" not in p.parts]


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources(HERE):
        assert not JAX & set(_imports(path)), path


def _program_side(path: Path) -> bool:
    rel = path.relative_to(HERE)
    return rel.parts[0] == "adapters" or rel.name == "program.py"


def test_the_reference_imports_nothing_of_the_program():
    # the reference and what it loads by name: its families, fusions and
    # assemblers, the optimizers, the weights, the families' counts
    for path in _sources(HERE):
        if not _program_side(path):
            names = set(_imports(path))
            assert not (JAX | {"mmgl_tpu_torch"}) & names, path


def test_only_the_program_side_imports_the_program():
    users = {p for p in _sources(HERE) if "mmgl_tpu_torch" in set(
        _imports(p))}
    assert users and all(_program_side(p) for p in users), users


def test_the_run_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    for name in ("mmgl_tpu_torch_fake", "jaxfake", "mmgl_tpu_torch.x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not [m for m in run.forbidden_modules()
                if m.startswith(("mmgl_tpu_torch", "jaxfake"))]
    monkeypatch.setitem(sys.modules, "mmgl_tpu.fake",
                        types.ModuleType("mmgl_tpu.fake"))
    assert "mmgl_tpu.fake" in run.forbidden_modules()
