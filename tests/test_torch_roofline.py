"""The port's roofline and report (`repro_torch.benchmarks.{roofline,
report}`) against the reference's `benchmarks.{roofline,report}`.

  * with the TPU v5e's peaks, `roofline_terms`, `dryrun_table` and
    `roofline_table` equal the reference's on the same records: a
    reference-format record and the port's own dry-run records;
  * the reference's report reads the port's records without error (the
    schemas match), and `run()` defaults to the H100 SXM's peaks;
  * the `roofline` entry of `repro_torch.benchmarks.run` prints a row a
    record, and needs no device.
"""
import importlib
import json
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import report, roofline  # noqa: E402
from repro_torch.benchmarks import run as port_run  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core.peaks import TPU_V5E  # noqa: E402
from repro_torch.launch.dryrun import run_cell  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402

V5E = (TPU_V5E.peak_tflops("bf16") * 1e12, TPU_V5E.hbm_gbps * 1e9,
       TPU_V5E.ici_gbps * 1e9)

#: a record in the reference's own format (a 16x16 mesh, collectives)
REF_RECORD = {
    "arch": "qwen3-4b", "shape": "train_4k", "mesh": "16x16",
    "devices": 256, "lower_s": 12.3, "compile_s": 45.6,
    "memory": {"argument_bytes": 3_000_000_000, "output_bytes": 10,
               "temp_bytes": 9_000_000_000, "peak_bytes": 12_000_000_000},
    "cost_raw": {"flops": 1.0e13, "bytes_accessed": 2.0e11},
    "hlo": {"flops": 4.1e14, "traffic_bytes": 3.3e12,
            "collective_bytes": {"all-gather": 2.0e10, "all-reduce": 1.0e9,
                                 "reduce-scatter": 5.0e9, "all-to-all": 0.0,
                                 "collective-permute": 3.0e8},
            "collective_counts": {"all-gather": 144.0, "all-reduce": 2.0,
                                  "reduce-scatter": 72.0, "all-to-all": 0.0,
                                  "collective-permute": 4.0}},
    "model_flops_6nd": 2.4e17, "analytic_mxu_flops": 3.3e17,
    "analytic_vpu_flops": 1.0e15}


def _ref(name):
    return importlib.import_module(f"benchmarks.{name}")


@pytest.fixture(scope="module")
def port_records():
    """The port's dry-run records of three small cells, by tag."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        recs = {}
        for arch, kind in (("granite-3-2b", "prefill"),
                           ("mamba2-780m", "decode"),
                           ("whisper-small", "train")):
            rec = run_cell(get_config(arch).smoke(),
                           ShapeSpec(kind, 64, 2, kind),
                           mesh=make_smoke_mesh(1))
            recs[f"{arch}_{kind}_single"] = rec
        recs["qwen3-4b_long_500k_single"] = {
            "arch": "qwen3-4b", "shape": "long_500k", "skipped": True,
            "reason": "full-attention arch skips long_500k (DESIGN.md)"}
        return recs
    finally:
        torch.set_num_threads(n)


def test_roofline_terms_with_v5e_peaks_equal_the_references():
    assert roofline.roofline_terms(REF_RECORD, V5E) \
        == _ref("roofline").roofline_terms(REF_RECORD)


def test_roofline_terms_on_port_records_equal_the_references(port_records):
    ref = _ref("roofline")
    for tag, rec in port_records.items():
        if not rec.get("skipped"):
            assert roofline.roofline_terms(rec, V5E) \
                == ref.roofline_terms(rec), tag


@pytest.mark.parametrize("which", ["reference-format", "port"])
def test_tables_with_v5e_peaks_equal_the_references(which, port_records):
    ref = _ref("report")
    recs = {"qwen3-4b_train_4k_single": REF_RECORD,
            "qwen3-4b_train_4k_multi": {**REF_RECORD, "mesh": "2x16x16",
                                        "devices": 512}} \
        if which == "reference-format" else port_records
    assert report.dryrun_table(recs) == ref.dryrun_table(recs)
    assert report.roofline_table(recs, peaks=V5E) == ref.roofline_table(recs)
    assert report.roofline_table(recs, "_multi", V5E) \
        == ref.roofline_table(recs, "_multi")


def test_the_references_report_reads_port_records(port_records, tmp_path,
                                                  monkeypatch, capsys):
    for tag, rec in port_records.items():
        (tmp_path / f"{tag}.json").write_text(json.dumps(rec))
    ref = _ref("report")
    recs = ref.load(str(tmp_path))
    assert recs == report.load(str(tmp_path)) == port_records
    monkeypatch.setattr(sys, "argv", ["report", str(tmp_path)])
    ref.main()
    theirs = capsys.readouterr().out
    report.main([str(tmp_path)])
    mine = capsys.readouterr().out
    assert "whisper-small-smoke train" in theirs \
        and "whisper-small-smoke train" in mine
    assert "skipped" in theirs and "skipped" in mine


def test_h100_is_the_default_and_its_data_sheet(port_records):
    rec = port_records["granite-3-2b_prefill_single"]
    t = roofline.roofline_terms(rec)
    assert roofline.H100_SXM == (989e12, 3.35e12, 450e9)
    assert t["compute_s"] == rec["hlo"]["flops"] / 989e12
    assert t["memory_s"] == rec["hlo"]["traffic_bytes"] / 3.35e12
    assert t["collective_s"] == 0.0
    assert t["bound_s"] == max(t["compute_s"], t["memory_s"])
    assert roofline.PEAK_OPS_PER_S == {"bf16": 989e12, "fp32": 67e12,
                                       "int8": 1979e12}


def test_run_entry_prints_a_row_a_record(port_records, tmp_path,
                                         monkeypatch, capsys):
    for tag, rec in port_records.items():
        (tmp_path / f"{tag}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(roofline, "DRYRUN_DIR", str(tmp_path))
    out = port_run.main(["roofline"])
    rows, _ = out["roofline"]
    assert sorted(r.name for r in rows) \
        == sorted(f"roofline.{t}" for t in port_records)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert {ln.split(",")[0] for ln in lines[1:]} == {r.name for r in rows}
    skipped = [r for r in rows if r.name.endswith("long_500k_single")]
    assert skipped[0].derived.startswith("skipped")
    monkeypatch.setattr(roofline, "DRYRUN_DIR", str(tmp_path / "none"))
    assert [r.name for r in roofline.run()] == ["roofline.missing"]
