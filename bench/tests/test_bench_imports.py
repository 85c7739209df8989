"""The import guard: nothing a run imports is JAX or the JAX package
(`repro`, compared by the whole top-level name: `repro_torch` is the
program under test), and the reference imports no part of the program."""
import ast
from pathlib import Path

import harness

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, f"{path}: {bad}"


def test_the_reference_and_the_frozen_arithmetic_import_no_program():
    for d in ("reference", "frozen"):
        for path in (BENCH / d).rglob("*.py"):
            assert not set(_imports(path)) & {"repro", "repro_torch"}, path


def test_the_runtime_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["repro.fleet", "jax._src",
                                      "flax"]) == ["flax", "jax", "repro"]
