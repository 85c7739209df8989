"""The port's examples (`python -m repro_torch.examples.<name>`) on the
CPU, against the JAX package's `examples/`.

* quickstart trains the smoke config through the port's `Trainer` into a
  temporary checkpoint directory, and a re-run with more steps resumes
  from its checkpoint;
* fleet_monitoring exits 0 and its divergence triage flags the jobs the
  reference's walkthrough flags (the engines' streams differ, the
  flagged set does not), with the same straggler and alerted jobs;
* mixed_precision_pretrain's pointwise r is the reference's within 0.02.
"""
import contextlib
import importlib.util
import io
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.examples import (fleet_monitoring,  # noqa: E402
                                  mixed_precision_pretrain, quickstart)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The engines' small tensors gain nothing from torch's thread pool,
    whose threads would only compete with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_stdout(name: str) -> str:
    """What the reference's `examples/<name>.py` prints."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        spec.loader.exec_module(mod)
        mod.main()
    return out.getvalue()


def test_quickstart_trains_then_resumes_from_its_checkpoint(tmp_path,
                                                            capsys):
    ck = str(tmp_path / "ck")
    out = quickstart.main(["--arch", "zamba2-7b", "--steps", "3",
                           "--device", "cpu", "--ckpt-dir", ck])
    assert out["final_step"] == 3 and out["restarts"] == 0
    assert "3 steps run, now at step 3" in capsys.readouterr().out
    out = quickstart.main(["--arch", "zamba2-7b", "--steps", "6",
                           "--device", "cpu", "--ckpt-dir", ck])
    assert out["final_step"] == 6
    # resumed at step 3: only step 5 is logged (log_every 5)
    assert [m["step"] for m in out["metrics"]] == [5]
    assert math.isfinite(out["final_loss"])
    printed = capsys.readouterr().out
    assert "3 steps run, now at step 6" in printed
    out = quickstart.main(["--arch", "zamba2-7b", "--steps", "6",
                           "--device", "cpu", "--ckpt-dir", ck])
    assert out["final_step"] == 6 and out["metrics"] == []
    assert "nothing to do" in capsys.readouterr().out


def test_fleet_monitoring_flags_what_the_reference_flags():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.fleet_monitoring",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                       "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = reference_stdout("fleet_monitoring")

    def flagged(text):
        return sorted(re.findall(r"FLAGGED (\S+):", text))

    def alerted(text):
        return sorted(set(re.findall(r"ALERT \[round \d+ t=\s*\d+s\] "
                                     r"(\w+) (\S+):", text)))

    def straggler(text):
        return re.search(r"flag devices (\[.*\])", text).group(1)

    assert flagged(proc.stdout) == flagged(ref) \
        == ["embodied-agent", "hybrid-8b", "moe-16b-exp3"]
    assert alerted(proc.stdout) == alerted(ref)
    assert straggler(proc.stdout) == straggler(ref)
    res = fleet_monitoring.main(["--device", "cpu"])
    assert res["flagged"] == flagged(ref)
    assert res["served_alerts"] >= 1


def test_mixed_precision_pretrain_tracks_the_reference():
    ref = reference_stdout("mixed_precision_pretrain")
    r_ref = float(re.search(r"pointwise r=([0-9.]+)", ref).group(1))
    r = mixed_precision_pretrain.main(["--device", "cpu"])
    assert r == pytest.approx(r_ref, abs=0.02)
    assert r > 0.9


def test_examples_run_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (mixed_precision_pretrain.main, fleet_monitoring.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main(["--steps", "1"])
