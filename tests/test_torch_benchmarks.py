"""The port's paper benchmark suite (`repro_torch.benchmarks`) against
the JAX package's `benchmarks/`, each module run once a package on the
CPU (`device="cpu"`: the kernels' plain versions), the reference's
Pallas GEMM in interpret mode.

* Fig. 1's closed-form rows, Fig. 3, Table I and Table II are host
  NumPy in both packages: their rows are string-equal (Table I over
  1,000 s of 1 s scrapes rather than 3,000, Table II at a reduced
  `n_matmuls`; Table II's seed hashes a tuple of strings, so the two
  runs share one process).
* Fig. 5 / Table III / §V-C and §VI simulate on the engines, whose
  random streams differ (Philox against threefry and NumPy): the same
  rows, the same flags and `exact_match`, the reported MFUs equal, the
  OFU-side numbers within stated tolerances.
* fleet_engine at a small operating point (FLEET_TORCH_DEVICES and the
  ingest tier's host counts cut, the 600-job sweep cut to 60 in both
  packages; row names keep the reference's): the same row names, and
  the kernel route's counts equal its plain version's.
"""
import importlib
import os
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.benchmarks import common, run as port_run  # noqa: E402

SMALL = {"FLEET_JAX_DEVICES": "500", "FLEET_TORCH_DEVICES": "500",
         "FLEET_JAX_HOURS": "1", "FLEET_TORCH_HOURS": "1",
         "FLEET_INGEST_HOSTS": "200", "FLEET_INGEST_NPZ_HOSTS": "32"}
SWEEP_JOBS = 60
TABLE1_S = 1000.0
TABLE2_MATMULS = 40
_RUNS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The engines' small tensors gain nothing from torch's thread pool,
    whose threads would only compete with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def small_env(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    for k, v in SMALL.items():
        mp.setenv(k, v)
    mp.setenv("BENCH_FLEET_JSON",
              str(tmp_path_factory.mktemp("bench") / "BENCH_fleet.json"))
    for pkg in ("benchmarks", "repro_torch.benchmarks"):
        cs = importlib.import_module(f"{pkg}.clock_sampling")
        mp.setattr(cs, "DURATION_S", TABLE1_S)
        fe = importlib.import_module(f"{pkg}.fleet_engine")
        full = fe._sweep_specs
        mp.setattr(fe, "_sweep_specs",
                   lambda n_jobs=600, max_devices=17, _f=full:
                   _f(SWEEP_JOBS, max_devices))
    yield
    mp.undo()


def rows(pkg: str, name: str) -> list:
    """(name, derived) of one module's rows, run once a package."""
    if (pkg, name) not in _RUNS:
        mod = importlib.import_module(
            f"{'benchmarks' if pkg == 'ref' else 'repro_torch.benchmarks'}"
            f".{name}")
        kw = {} if pkg == "ref" else {"device": "cpu"}
        if name == "prediction_accuracy":
            kw["n_matmuls"] = TABLE2_MATMULS
        _RUNS[(pkg, name)] = [(r.name, r.derived) for r in mod.run(**kw)]
    return _RUNS[(pkg, name)]


def kv(derived: str) -> dict:
    return dict(f.split("=", 1) for f in derived.split() if "=" in f)


def num(s: str) -> float:
    return float(s.rstrip("%px"))


def close(a: dict, b: dict, tol: dict) -> None:
    """Fields named in `tol` within it (numbers, units stripped); the
    rest string-equal."""
    assert set(a) == set(b)
    for k in a:
        if k in tol:
            assert abs(num(a[k]) - num(b[k])) <= tol[k], (k, a[k], b[k])
        else:
            assert a[k] == b[k], (k, a[k], b[k])


@pytest.mark.parametrize("name", ["tile_quantization", "precision_scaling",
                                  "clock_sampling", "prediction_accuracy"])
def test_host_numpy_rows_are_string_equal(name):
    mine, ref = rows("port", name), rows("ref", name)
    assert len(mine) > 0
    assert mine == ref


def test_fig1_kernel_grid_holds_on_both_packages():
    want = ("fig1.kernel_grid_vs_closed_form",
            "exact_match_on=3 shapes (0 FLOP error)")
    assert rows("port", "tile_quantization")[-1] == want
    assert rows("ref", "tile_quantization")[-1] == want


def test_production_correlation_flags_and_rows():
    mine = dict(rows("port", "production_correlation"))
    ref = dict(rows("ref", "production_correlation"))
    assert list(mine) == list(ref)
    for name in ("fig5.correlation", "correlation.miscalc_scan"):
        a, b = kv(mine[name]), kv(ref[name])
        assert a["exact_match"] == b["exact_match"] == "True"
        assert a["flagged"] == b["flagged"] == "82"
        assert float(a["r_after_exclusion"]) >= 0.75
        close(a, b, {"r_all": 0.03, "r_after_exclusion": 0.03, "mae": 0.5,
                     "within10pp": 3, "over20pp": 1.5})
    assert mine["fig5.flagged_breakdown"] == ref["fig5.flagged_breakdown"]
    for name in (n for n in ref if n.startswith("table3.")):
        close(kv(mine[name]), kv(ref[name]), {"abs_err": 0.5})
    for name in ("sec5c.case1_moe_latent", "sec5c.case2_hybrid"):
        close(kv(mine[name]), kv(ref[name]),
              {"ofu": 1.0, "rel_err": 6.0, "corrected_rel_err": 4.0,
               "fixed_rel_err": 4.0})


def test_operational_rows():
    mine = dict(rows("port", "operational"))
    ref = dict(rows("ref", "operational"))
    assert list(mine) == list(ref)
    close(kv(mine["fig6.embodied_agent_regression"]),
          kv(ref["fig6.embodied_agent_regression"]),
          {"ofu_during_bug": 1.0, "ofu_after_fix": 1.5,
           "improvement": 0.15, "detected_after_samples": 3})
    close(kv(mine["fig7.mixed_precision_6144"]),
          kv(ref["fig7.mixed_precision_6144"]),
          {"r_pointwise": 0.01, "r_per_job": 0.005,
           "agreement_bf16": 0.5, "agreement_mixed": 0.5})
    close(kv(mine["sec6c.remat_accounting"]),
          kv(ref["sec6c.remat_accounting"]),
          {"ofu": 1.5, "gap_after_fix": 1.5})


def test_fleet_engine_row_names_and_kernel_route_counts():
    mine = [n for n, _ in rows("port", "fleet_engine")]
    ref = [n for n, _ in rows("ref", "fleet_engine")]
    assert mine == ref
    assert "fleet_engine.jax_500dev_1h" in mine
    import json
    with open(os.environ["BENCH_FLEET_JSON"]) as f:
        cases = {c["name"]: c for c in json.load(f)["cases"]}
    torch_case = cases["fleet_engine_torch"]["metrics"]
    assert torch_case["route"] == "plain"
    assert torch_case["kernel_counts_equal_plain"] is True
    assert torch_case["devices"] == 500
    for name in ("fleet_engine", "fleet_engine_fused", "fleet_collector",
                 "trace_store", "trace_codecs", "serve_query",
                 "ingest_tier"):
        assert name in cases
    assert cases["ingest_tier"]["metrics"]["bucketwise_identical"] is True


def test_runner_lists_the_reference_modules_and_needs_a_device(capsys):
    ref_mods = {p.stem for p in (ROOT / "benchmarks").glob("*.py")
                if "def run(" in p.read_text()}
    mine = [m.__name__.split(".")[-1] for m in port_run.modules()]
    assert set(mine) == ref_mods - {"roofline"}
    out = port_run.main(["precision_scaling", "--device", "cpu"])
    assert list(out) == ["precision_scaling"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] \
        == [n for n, _ in rows("ref", "precision_scaling")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_run.main(["precision_scaling"])


def test_merge_bench_json_merges_by_name_like_the_reference(tmp_path,
                                                            monkeypatch):
    ref_common = importlib.import_module("benchmarks.common")
    docs = []
    for i, mod in enumerate((common, ref_common)):
        path = tmp_path / f"b{i}.json"
        monkeypatch.setenv("BENCH_FLEET_JSON", str(path))
        first, second = [], []
        mod.bench_case(first, "a", 1.0, "s", x=1)
        mod.bench_case(first, "b", 2.0, "s", x=2)
        mod.merge_bench_json(first)
        mod.bench_case(second, "a", 3.0, "s", x=3)
        assert mod.merge_bench_json(second) == str(path)
        docs.append(path.read_text())
    assert docs[0] == docs[1]


def test_host_copies_tensors_and_sync_is_a_noop_off_the_card():
    t = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(common.host(t), t.numpy())
    np.testing.assert_array_equal(common.host([1.0, 2.0]), [1.0, 2.0])
    common.sync("cpu")
    common.sync(torch.device("cpu"))
