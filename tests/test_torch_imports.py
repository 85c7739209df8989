"""Import guard of the port: nothing under `src/repro_torch/` and
nothing in `chip_smoke.py` imports jax, jaxlib or the JAX package
(`repro`, `repro.*`), not even its pure-NumPy modules."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_nothing_of_jax(path):
    bad = [f"{path.name}:{line} imports {name}"
           for line, name in _imported(ast.parse(path.read_text()))
           if _forbidden(name)]
    assert not bad, bad


def test_guard_catches_every_form():
    src = ("import jax\nimport jax.numpy as jnp\nfrom jaxlib import x\n"
           "from repro.fleet import jobs\nimport repro\n"
           "import repro_torch\nfrom repro_torch.fleet import jobs\n")
    names = [n for _, n in _imported(ast.parse(src)) if _forbidden(n)]
    assert names == ["jax", "jax.numpy", "jaxlib", "repro.fleet", "repro"]


def test_port_package_and_smoke_script_exist():
    assert (ROOT / "src" / "repro_torch" / "__init__.py").exists()
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 20
