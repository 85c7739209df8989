"""The port's six fleet tools (`python -m repro_torch.tools.<name>`)
against the reference's `tools/*.py`.

  * each `main(["--self-check", "--device", "cpu"])` returns 0, and
    refuses to run without `--device` where there is no card;
  * `tests/test_scorecard.py`'s CLI cases on the port's
    `fleet_scorecard`, and `tests/test_codecs.py`'s byte-exact
    `trace_convert` round trip on the port's;
  * the port's converted files equal the reference's byte for byte on the
    same input;
  * `fleet_correlate`'s self-check report on the reference's own
    Table III grids: the served r values within 1e-12 of the reference's
    offline analysis, and the same flagged jobs.
"""
import importlib
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.telemetry.scrape import DeviceGrid  # noqa: E402
from repro_torch.telemetry.source import read_trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ("trace_convert", "fleet_serve", "fleet_ingest", "fleet_live",
         "fleet_correlate", "fleet_scorecard")


def _port(name):
    return importlib.import_module(f"repro_torch.tools.{name}")


def _ref(name):
    """The reference's tool module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def bench_json(tmp_path, monkeypatch):
    """The scorecard merges its cases into BENCH_fleet.json: keep it in
    the test's own directory."""
    monkeypatch.setenv("BENCH_FLEET_JSON", str(tmp_path / "bench.json"))


@pytest.mark.parametrize("name", TOOLS)
def test_self_check_on_the_cpu(name, capsys):
    assert _port(name).main(["--self-check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "SELF-CHECK OK" in out or "0 floor violations" in out


@pytest.mark.parametrize("name", TOOLS)
def test_self_check_needs_the_card_unless_told(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(name).main(["--self-check"])


# ---------------------------------------------------------------------------
# fleet_scorecard: tests/test_scorecard.py's CLI cases
# ---------------------------------------------------------------------------
def test_cli_single_scenario_exits_clean(tmp_path, capsys):
    out_json = tmp_path / "card.json"
    assert _port("fleet_scorecard").main([
        "--scenario", "gloo_regression_2p5x", "--json", str(out_json),
        "--device", "cpu"]) == 0
    doc = json.loads(out_json.read_text())
    assert list(doc["scenarios"]) == ["gloo_regression_2p5x"]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("BENCH ")]
    names = {json.loads(ln[6:])["name"] for ln in lines}
    assert "scorecard/gloo_regression_2p5x/regression" in names
    bench = json.loads((tmp_path / "bench.json").read_text())
    assert {c["name"] for c in bench["cases"]} == names


def test_bench_json_merges_by_case_name(tmp_path):
    merge = _port("fleet_scorecard")._merge_bench_json
    path = tmp_path / "bench.json"
    path.write_text(json.dumps({
        "schema": 1, "suite": "fleet_engine",
        "cases": [{"name": "engine/foo", "median": 1.0, "units": "ms",
                   "metrics": {}},
                  {"name": "scorecard/x/regression", "median": 0.5,
                   "units": "precision", "metrics": {}}]}))
    merge([{"name": "scorecard/x/regression", "median": 1.0,
            "units": "precision", "metrics": {}}])
    doc = json.loads(path.read_text())
    by_name = {c["name"]: c for c in doc["cases"]}
    assert len(doc["cases"]) == 2                     # no duplicates
    assert by_name["engine/foo"]["median"] == 1.0     # other suite kept
    assert by_name["scorecard/x/regression"]["median"] == 1.0  # replaced
    # a corrupt file is rewritten, not crashed on
    path.write_text("{not json")
    merge([{"name": "a", "median": 0, "units": "x", "metrics": {}}])
    assert [c["name"] for c in json.loads(path.read_text())["cases"]] \
        == ["a"]


def test_every_engine_name_runs_the_torch_engine(tmp_path):
    out_json = tmp_path / "card.json"
    assert _port("fleet_scorecard").main([
        "--scenario", "gloo_regression_2p5x", "--engine", "jax",
        "--json", str(out_json), "--no-bench-json", "--device", "cpu"]) == 0
    assert json.loads(out_json.read_text())["engine"] == "torch"


# ---------------------------------------------------------------------------
# trace_convert: tests/test_codecs.py's round trip, and the reference's bytes
# ---------------------------------------------------------------------------
SPECIALS = [np.nan, np.inf, -np.inf, -0.0, 0.0,
            np.finfo(np.float32).tiny, np.finfo(np.float32).max]


def _grid(seed=5, d=3, s=137, dtype=np.float32, interval=30.0, t0=0.0):
    """tests/test_codecs.py's adversarial grid: smooth series, noise and
    special values."""
    rng = np.random.default_rng(seed)
    clk = rng.uniform(900.0, 1500.0, size=(d, s)).astype(dtype)
    tpa = (np.cumsum(rng.standard_normal((d, s)), axis=1) * 0.01) \
        .astype(dtype)
    n_spec = min(s * d // 4, 16)
    flat = tpa.ravel()
    idx = rng.choice(flat.size, size=n_spec, replace=False)
    flat[idx] = rng.choice(SPECIALS, size=n_spec)
    return DeviceGrid(interval, tpa, clk, t0_s=t0)


def test_v1_v2_conversion_is_byte_exact_via_trace_convert(tmp_path):
    """csv -> v1 -> v2 -> v1 through the CLI-level convert(): every hop
    carries the same sample bytes (float64 once CSV parses them)."""
    tc = _port("trace_convert")
    grid = _grid(seed=9, s=101, dtype=np.float64)
    csv = str(tmp_path / "t.csv")
    v1 = str(tmp_path / "t.ctr")
    v2 = str(tmp_path / "t.ctr2")
    v1b = str(tmp_path / "back.ctr")
    tc.write_trace(grid, csv)
    tc.convert(csv, v1, chunk_samples=40)
    tc.convert(v1, v2, chunk_samples=23, codec="dbz")
    tc.convert(v2, v1b, chunk_samples=64)
    a1, a2, a1b = read_trace(v1), read_trace(v2), read_trace(v1b)
    assert a1.tpa.tobytes() == a2.tpa.tobytes() == a1b.tpa.tobytes()
    assert a1.clock_mhz.tobytes() == a2.clock_mhz.tobytes() \
        == a1b.clock_mhz.tobytes()
    assert a1.t0_s == a2.t0_s == a1b.t0_s
    assert a1.interval_s == a2.interval_s == a1b.interval_s
    # v1 refuses a codec: it has exactly one encoding
    with pytest.raises(ValueError, match="ctr-v2 feature"):
        tc.convert(csv, str(tmp_path / "x.ctr"), chunk_samples=40,
                   codec="raw")


def _tree_bytes(path: Path) -> dict:
    if path.is_dir():
        return {str(p.relative_to(path)): p.read_bytes()
                for p in sorted(path.rglob("*")) if p.is_file()}
    return {"": path.read_bytes()}


@pytest.mark.parametrize("dst, codec", [
    ("t.ctr", None), ("t.ctr2", None), ("t.ctr2", "dbz"),
    ("t.jsonl", None), ("t.csv", None)])
def test_converted_files_are_the_references_bytes(tmp_path, dst, codec):
    from repro.telemetry.scrape import DeviceGrid as R_Grid
    ref = _ref("trace_convert")
    g = _grid(seed=4, s=90)
    src = tmp_path / "in.csv"
    ref.write_trace(R_Grid(g.interval_s, g.tpa, g.clock_mhz, t0_s=600.0),
                    str(src))
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref.convert(str(src), str(tmp_path / "ref" / dst), chunk_samples=32,
                codec=codec)
    _port("trace_convert").convert(str(src), str(tmp_path / "port" / dst),
                                   chunk_samples=32, codec=codec)
    assert _tree_bytes(tmp_path / "port" / dst) \
        == _tree_bytes(tmp_path / "ref" / dst)


# ---------------------------------------------------------------------------
# fleet_correlate on the reference's grids
# ---------------------------------------------------------------------------
def test_correlate_report_is_the_references_on_its_grids():
    """The port's self-check assertions and served report on the
    reference's own Table III counters (as port `DeviceGrid`s over
    NumPy): r_all and r_after_exclusion within 1e-12 of the reference's
    offline analysis, the same flagged jobs and populations, and live
    equal to offline."""
    from repro.fleet import table3 as R
    from repro.fleet.correlation import analyze_correlation as R_corr
    from repro_torch.fleet import table3 as T
    from repro_torch.fleet.jobs import JobTelemetry
    rjobs = R.build_jobs(0)
    jobs = [T.Table3Job(spec, JobTelemetry(
        spec, DeviceGrid(j.telemetry.grid.interval_s, j.telemetry.grid.tpa,
                         j.telemetry.grid.clock_mhz,
                         t0_s=j.telemetry.grid.t0_s),
        j.telemetry.app_mfu, j.telemetry.app_mfu_exact,
        j.telemetry.step_time_s, j.telemetry.executed_tflops_per_step),
        j.mfu_t, j.mfu_v) for spec, j in zip(T.build_specs(0), rjobs)]
    rep = _port("fleet_correlate").check(jobs)
    roll, mfu = R.offline_rollups(rjobs)
    want = R_corr(mfu, roll)
    truth = R.affected_ids(rjobs)
    assert rep["jobs"] == len(rjobs) == 608 and rep["rounds"] == 4
    assert (rep["naive_moe"], rep["naive_hybrid"]) \
        == (len(truth["naive_moe"]), len(truth["naive_hybrid"]))
    assert abs(rep["r_all"] - want.r_all) <= 1e-12
    assert abs(rep["r_clean"] - want.r_clean) <= 1e-12
    assert rep["flagged"] == sorted(f.job_id for f in want.flagged)
    assert rep["mean_rel"] == 0.0 and rep["r_diff"] == 0.0


def test_tools_run_as_modules():
    """Each tool is a module with a `main(argv) -> int`, whose help
    names `--device`."""
    for name in TOOLS:
        mod = _port(name)
        with pytest.raises(SystemExit) as e:
            mod.main(["--help"])
        assert e.value.code == 0
    assert os.path.isfile(ROOT / "src" / "repro_torch" / "tools"
                          / "__init__.py")
