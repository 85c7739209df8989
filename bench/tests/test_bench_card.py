"""A cell of the benchmark on the card: one short run from the command
line, its last line correct.  Skips without a CUDA device."""
import json
import subprocess
import sys

import pytest
import torch

import smoke


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "granite-3-2b.train_4k", "--seed", str(2**33 + 17), "--seconds",
         "5", "--trace", "0"], cwd=smoke.ROOT, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
