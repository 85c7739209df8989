"""The plain reference against the program at smoke size on the CPU, in
f32, and the comparison failing when the reference is computed with fp8
matrix products in the program's place (the control)."""
import pytest
import torch

import compare
import harness
import inputs
import smoke
from reference import models, ops

CPU = torch.device("cpu")


@pytest.mark.parametrize("arch", ["zamba2-7b", "granite-3-2b"])
def test_reference_logits_match_the_program(arch):
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    c = smoke.smoke_sizes(arch)
    cfg = get_config(c["name"])
    params = inputs.weights(c, 2**35 + 1, CPU)
    tokens = torch.randint(0, c["vocab_size"], (2, 32),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = api.forward(cfg, params, {"tokens": tokens})
    want = models.all_logits(dict(c, ref_kv_block=1), params, tokens,
                             ops.Prec("f32"))
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)
    last = models.last_logits(c, params, tokens, ops.Prec("f32"))
    assert torch.allclose(last, want[:, -1], atol=1e-5)


def _cell(tmp_path, arch):
    root = smoke.make_root(tmp_path, {"t": (arch, smoke.TRAIN_MIX)})
    cell = harness.load_cell(root, "t")
    return cell, harness.model_config(cell), harness.driver(root, "train")


@pytest.mark.parametrize("arch", ["zamba2-7b", "granite-3-2b"])
def test_reference_train_steps_match_the_program(tmp_path, arch):
    cell, cfg, drv = _cell(tmp_path, arch)
    got = drv.program(cell, cfg, 11, CPU)[-1]
    ref = drv.reference(cell, 11, CPU)
    nums = compare.train_numbers(got, ref)
    assert nums["loss_gap"][0] < 1e-4
    assert nums["grad_gap"][0] < 1e-4
    assert nums["change_gap"][0] < 1e-3


@pytest.mark.parametrize("arch", ["zamba2-7b", "granite-3-2b"])
def test_the_fp8_control_fails_the_comparison(tmp_path, arch):
    cell, cfg, drv = _cell(tmp_path, arch)
    got = drv.program(cell, cfg, 12, CPU)[-1]
    ref = drv.reference(cell, 12, CPU)
    ctl = drv.reference(cell, 12, CPU, prec="fp8")
    sound = compare.train_numbers(got, ref)
    low = compare.train_numbers(ctl, ref)
    assert low["grad_gap"][0] > 10 * sound["grad_gap"][0]
    assert not all(v["ok"] for v in compare.checks(low, cell.limits)
                   .values())


def test_the_fp8_control_moves_served_tokens(tmp_path):
    """The control read on the cell's own comparison: the last positions
    of the sampled requests, against the cell's limit."""
    mix = dict(smoke.PREFILL_MIX, block={"16": 4, "32": 4}, sample=8)
    root = smoke.make_root(tmp_path, {"p": ("zamba2-7b", mix)})
    cell = harness.load_cell(root, "p")
    got = harness.driver(root, "prefill").readings(
        cell, harness.model_config(cell), 2**36, CPU)
    ok = {k: compare.checks(v, cell.limits)["logit_gap"]["ok"]
          for k, v in got.items()}
    assert ok == {"program": True, "control": False}, got
