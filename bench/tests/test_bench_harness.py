"""The harness finds every cell, mix, limit and metric from files alone,
and a run's last line carries the driver's keys."""
import json
import sys
import types

import pytest
import torch

import harness
import run
import smoke

ROOT = smoke.ROOT


def test_every_cell_resolves_from_its_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for wl in spec["workloads"]:
        cell = harness.load_cell(ROOT, wl["name"])
        assert callable(harness.driver(ROOT, cell.mix["kind"]).run)
        numbers = ({"loss_gap", "grad_gap", "change_gap", "grad_gap_median",
                    "change_gap_median"} if cell.mix["kind"] == "train"
                   else {"logit_gap"})
        assert cell.limits and set(cell.limits) <= numbers
        for m in cell.per_layer:
            assert callable(harness.reader(ROOT, m["name"]).read)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_configs_build_the_programs_configs():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for wl in spec["workloads"]:
        cell = harness.load_cell(ROOT, wl["name"])
        cfg = harness.model_config(cell)
        harness.check_layout(cfg, cell.sizes)


def test_a_registry_that_disagrees_is_refused(tmp_path):
    root = smoke.make_root(tmp_path, {"t": ("granite-3-2b",
                                            smoke.TRAIN_MIX)})
    path = root / "bench" / "configs" / "granite-3-2b-smoke.json"
    conf = json.loads(path.read_text())
    conf["as_run"]["d_ff"] += 64
    path.write_text(json.dumps(conf))
    with pytest.raises(ValueError, match="registry differs"):
        harness.model_config(harness.load_cell(root, "t"))


def test_a_cell_and_metric_added_as_files_are_found(tmp_path):
    src = ('def read(r):\n'
           '    return 1e3 * r.window["elapsed_s"] / max(r.window["count"], 1)\n')
    root = smoke.make_root(tmp_path, {"dummy.train": ("granite-3-2b",
                                                      smoke.TRAIN_MIX)},
                           extra_metrics={"dummy_ms.train": (
                               src, "train_tokens_per_s", ["dummy.train"])})
    line = harness.run_cell(root, "dummy.train", 7, 0.2, True,
                            torch.device("cpu"), 0.0)
    assert line["metrics"]["dummy_ms.train"]["unit"] == "ms"
    assert line["metrics"]["dummy_ms.train"]["value"] > 0
    assert line["correct"] is True


def test_a_mix_key_its_driver_does_not_read_is_refused(tmp_path):
    root = smoke.make_root(tmp_path, {"p": ("granite-3-2b", dict(
        smoke.PREFILL_MIX, clients=4))})
    with pytest.raises(ValueError, match="unread \\['clients'\\]"):
        harness.load_cell(root, "p")


def test_a_driver_added_as_a_file_is_found(tmp_path):
    root = smoke.make_root(tmp_path, {"t": ("granite-3-2b",
                                            smoke.TRAIN_MIX)})
    (root / "bench" / "drivers" / "idle.py").write_text(
        'import harness\n'
        'KEYS = {"kind", "seconds"}\n'
        'def run(cell, cfg, seed, seconds, trace, dev, t0):\n'
        '    return {"attempted": 1, "failed": 0, "peak": 0,\n'
        '            "e2e": {"setup_s": cell.mix["seconds"]},\n'
        '            "run": harness.Run({}), "checks": {}}\n')
    (root / "bench" / "traffic" / "t-mix.json").write_text(
        json.dumps({"kind": "idle", "seconds": 0.5}))
    line = harness.run_cell(root, "t", 1, 0.1, False, torch.device("cpu"),
                            0.0)
    assert line["correct"] is True
    assert line["metrics"]["setup_s"]["value"] == 0.5


def _cpu_run(monkeypatch, root):
    """run.main on the CPU at `root`; its import guard looks only at the
    modules the run itself imports (a test process may hold JAX from
    other tests)."""
    before = set(sys.modules)
    guard = harness.forbidden_modules
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(run, "_device", lambda wl: torch.device("cpu"))
    monkeypatch.setattr(run, "_environment", lambda: None)
    monkeypatch.setattr(harness, "forbidden_modules", lambda mods: guard(
        [m for m in mods if m not in before]))


@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line_carries_the_five_keys(tmp_path, monkeypatch, capsys,
                                             trace):
    root = smoke.make_root(tmp_path, {"p": ("zamba2-7b",
                                            smoke.PREFILL_MIX)})
    _cpu_run(monkeypatch, root)
    rc = run.main(["--workload", "p", "--seed", str(2**33 + 5),
                   "--seconds", "0.2", "--trace", str(trace)])
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["correct"] is True and line["attempted"] > 0
    want = {"setup_s", "prefill_tokens_per_s", "prefill_p95_ms"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert "mfu.prefill" in line["metrics"]
    else:
        assert set(line["metrics"]) == want
    assert err.strip().splitlines()[-1].startswith("check logit_gap: ")


def test_no_result_when_jax_was_imported(tmp_path, monkeypatch, capsys):
    root = smoke.make_root(tmp_path, {"p": ("zamba2-7b",
                                            smoke.PREFILL_MIX)})
    _cpu_run(monkeypatch, root)
    monkeypatch.setitem(sys.modules, "jax.bench_probe",
                        types.ModuleType("jax.bench_probe"))
    rc = run.main(["--workload", "p", "--seed", "3", "--seconds", "0.1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "jax" in err


def test_no_result_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "_environment", lambda: None)
    rc = run.main(["--workload", "granite-3-2b.train_4k", "--seed", "1",
                   "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def test_same_seed_same_inputs():
    import inputs
    c = smoke.smoke_sizes("zamba2-7b")
    a = inputs.weights(c, 2**40 + 3, torch.device("cpu"))
    b = inputs.weights(c, 2**40 + 3, torch.device("cpu"))
    d = inputs.weights(c, 2**40 + 4, torch.device("cpu"))
    assert torch.equal(a["layers"]["mixer"]["in_proj"],
                       b["layers"]["mixer"]["in_proj"])
    assert not torch.equal(a["embed"], d["embed"])
    mix = dict(smoke.PREFILL_MIX, block={"256": 2, "512": 3, "768": 2,
                                         "1024": 3, "1536": 2, "2048": 3,
                                         "3072": 2, "4096": 3})
    ls = inputs.prompt_lengths(mix, 2**33, 40)
    assert sorted(ls[:20]) == sorted(ls[20:])
    assert ls[:20] != inputs.prompt_lengths(mix, 2**33 + 1, 20)
