"""CPU tests of the benchmark's harness, at smoke sizes.

The harness's modules import by their own names (`harness`, `inputs`,
`reference`, ...), as `bench/run.py` puts `bench/` on the path."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _program_registry():
    """The program's config registry as it was before the test: the
    smoke cells register their sizes under names of their own."""
    from repro_torch.configs import base
    base.list_configs()
    saved = dict(base._REGISTRY)
    yield
    base._REGISTRY.clear()
    base._REGISTRY.update(saved)
