"""A run with the timed path broken underneath comes out not correct:
for each fault a cell can have on one chip (no exchange between chips
runs there)."""
import pytest
import torch

import harness
import smoke

CPU = torch.device("cpu")


def _unchanged(monkeypatch):
    from repro_torch.optim import adamw

    def update(cfg, grads, state, params):
        return params, state, {"lr": torch.zeros(()),
                               "grad_norm": adamw.global_norm(grads)}
    monkeypatch.setattr(adamw, "update", update)


def _half_batch(monkeypatch):
    from repro_torch.train import steps
    loss_fn = steps.loss_fn

    def half(cfg, params, batch, ctx=None):
        n = batch["tokens"].shape[0] // 2
        return loss_fn(cfg, params, {k: v[:n] for k, v in batch.items()},
                       ctx)
    monkeypatch.setattr(steps, "loss_fn", half)


def _gradient_altered(monkeypatch):
    from repro_torch.kernels import grad
    flash_bwd = grad.flash_bwd

    def doubled(*a, **kw):
        dq, dk, dv = flash_bwd(*a, **kw)
        return 2 * dq, dk, dv
    monkeypatch.setattr(grad, "flash_bwd", doubled)


def _token_altered(monkeypatch, V):
    from repro_torch.train import steps
    make = steps.make_prefill_step

    def altered(cfg, ctx=None):
        step = make(cfg, ctx)
        return lambda params, batch: (step(params, batch) + 1) % V
    monkeypatch.setattr(steps, "make_prefill_step", altered)


def _half_prompt(monkeypatch):
    from repro_torch.train import steps
    make = steps.make_prefill_step

    def half(cfg, ctx=None):
        step = make(cfg, ctx)

        def run(params, batch):
            t = batch["tokens"]
            return step(params, {"tokens": t[:, t.shape[1] // 2:]})
        return run
    monkeypatch.setattr(steps, "make_prefill_step", half)


@pytest.mark.parametrize("arch", ["zamba2-7b", "granite-3-2b"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch",
                                   "gradient_altered"])
def test_train_faults_are_not_correct(tmp_path, monkeypatch, arch, fault):
    root = smoke.make_root(tmp_path, {"t": (arch, smoke.TRAIN_MIX)})
    if fault:
        globals()[f"_{fault}"](monkeypatch)
    line = harness.run_cell(root, "t", 21, 0.1, False, CPU, 0.0)
    assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.parametrize("fault", [None, "token_altered", "half_prompt"])
def test_prefill_faults_are_not_correct(tmp_path, monkeypatch, fault):
    root = smoke.make_root(tmp_path, {"p": ("zamba2-7b",
                                            smoke.PREFILL_MIX)})
    if fault == "token_altered":
        _token_altered(monkeypatch, smoke.smoke_sizes("zamba2-7b")
                       ["vocab_size"])
    elif fault:
        _half_prompt(monkeypatch)
    line = harness.run_cell(root, "p", 22, 0.2, False, CPU, 0.0)
    assert line["correct"] is (fault is None), line["checks"]
