"""The train driver: the program's train step, built once, driven from
the seed through the mix's set-up steps (the readings the comparison
takes), then step after step for the measured window, each step's batch
made by the program's data pipeline inside it.  Checkpoints are never
written.  The reference follows the first `ref_steps` steps.

Mix keys: seq_len, batch, optimizer (the program's `OptConfig` fields),
setup_steps, ref_steps (at most setup_steps), trace_steps (the traced
window after the measured one).
"""
from __future__ import annotations

import json
import math
import time

import torch

import compare
import harness
import inputs
from frozen import flops
from reference import ops
from reference.models import get, layout
from reference.train import RefTrainer, pieces, piece_norms

KEYS = {"kind", "seq_len", "batch", "optimizer", "setup_steps", "ref_steps",
        "trace_steps"}


def change_norms(lay, params, seed: int, dev) -> dict:
    """{piece: norm of (parameters − the seed's initial ones)}."""
    out = {}
    for k, lf in enumerate(lay):
        p0 = inputs.leaf(lf, k, seed, dev)
        for (name, a), (_, b) in zip(pieces(lf, get(params, lf.path)),
                                     pieces(lf, p0)):
            out[name] = float((a.float() - b.float()).norm())
        del p0
    return out


def program(cell, cfg, seed: int, dev):
    """The program's train step built once and driven from the seed
    through the set-up steps, with the readings the comparison takes
    from them.  Returns (step, params, state, batch fn, readings)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import pipeline
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    mix, c = cell.mix, cell.sizes
    o = mix["optimizer"]
    opt = adamw.OptConfig(**o)
    shape = ShapeSpec("bench", mix["seq_len"], mix["batch"], "train")
    params = inputs.weights(c, seed, dev)
    state = adamw.init(opt, params)
    step = steps.make_train_step(cfg, opt)
    lay = layout(c)

    def batch(i):
        return pipeline.to_device(
            cfg, pipeline.synthetic_batch(cfg, shape, i, seed=seed), dev)

    got = {"loss": []}
    for i in range(mix["setup_steps"]):
        _, _, aux = step(params, state, batch(i))
        got["loss"].append(float(aux["loss"]))
        if i == 0:
            gn = float(aux["grad_norm"])
            scale = min(1.0, o["clip_norm"] / (gn + 1e-9)) * (1 - o["b1"])
            m = piece_norms(lay, lambda lf: get(state["mu"], lf.path)["m"])
            got["grad"] = {k: v / scale for k, v in m.items()}
        if i + 1 == mix["ref_steps"]:
            got["change"] = change_norms(lay, params, seed, dev)
    got["loss"] = got["loss"][:mix["ref_steps"]]
    return step, params, state, batch, got


def reference(cell, seed: int, dev, prec: str = "f32",
              fault=None) -> dict:
    """The reference's readings of the first `ref_steps` steps."""
    mix, c = cell.mix, cell.sizes
    lay = layout(c)
    params = inputs.weights(c, seed, dev)
    ref = RefTrainer(c, mix["optimizer"], params, ops.Prec(prec), fault)
    got = {"loss": []}
    for i in range(mix["ref_steps"]):
        tok, lab = inputs.train_batch(seed, i, mix["batch"], mix["seq_len"],
                                      c["vocab_size"])
        loss, g = ref.grads(torch.from_numpy(tok).to(dev),
                            torch.from_numpy(lab).to(dev))
        got["loss"].append(float(loss))
        if i == 0:
            got["grad"] = piece_norms(lay, lambda lf: g[lf.path])
        ref.update(g)
        del g
    got["change"] = change_norms(lay, params, seed, dev)
    del ref, params
    harness.free(dev)
    return got


def run(cell, cfg, seed: int, seconds: float, trace: bool, dev,
        t0: float) -> dict:
    mix = cell.mix
    step, params, state, batch, got = program(cell, cfg, seed, dev)
    harness.sync(dev)
    setup_s = time.perf_counter() - t0
    harness.log(f"set-up done, losses {got['loss']}", t0)
    B, S = mix["batch"], mix["seq_len"]

    spans, losses = [], []
    i = mix["setup_steps"]

    def one():
        nonlocal i
        harness.sync(dev)
        t = time.perf_counter()
        with torch.profiler.record_function("bench.batch"):
            b = batch(i)
        spans.append(time.perf_counter() - t)
        with torch.profiler.record_function("bench.step"):
            _, _, aux = step(params, state, b)
        losses.append(aux["loss"].detach())
        i += 1

    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        one()
    harness.sync(dev)
    elapsed = time.perf_counter() - start
    n = len(losses)
    peak = harness.peak(dev)
    window = {"elapsed_s": elapsed, "count": n, "tokens": n * B * S,
              "model_flops": n * flops.train_step_flops(cell.sizes, B, S),
              "spans": {"batch": list(spans)}}
    run = harness.Run(window)
    if trace:
        k = mix["trace_steps"]
        _, run.trace = harness.traced(cell, lambda: [one() for _ in range(k)], dev)
        run.units = k
    failed = sum(not math.isfinite(float(x)) for x in losses)
    harness.log(f"window: {n} steps in {elapsed:.3f} s, peak {peak / 2**30:.2f} GiB",
        t0)
    del step, params, state, losses, batch
    harness.free(dev)

    ref = reference(cell, seed, dev)
    harness.log(f"reference done, losses {ref['loss']}", t0)
    nums = compare.train_numbers(got, ref)
    harness.log(f"readings {json.dumps(nums)}; left out of change_gap: "
        f"{compare.still(ref)}", t0)
    checks = compare.checks(nums, cell.limits)
    e2e = {"train_tokens_per_s": window["tokens"] / elapsed,
           "setup_s": setup_s}
    return {"attempted": n, "failed": failed, "peak": peak, "e2e": e2e,
            "run": run, "checks": checks}


def readings(cell, cfg, seed: int, dev) -> dict:
    """The numbers compared, of the program's set-up steps ("program"),
    of the reference computed with fp8 products ("control") and of the
    reference with the loss's mean over half the batch ("half_batch"),
    each against the f32 reference (`bench/control.py`)."""
    got = program(cell, cfg, seed, dev)[-1]
    harness.free(dev)
    ref = reference(cell, seed, dev)
    out = {"program": got,
           "control": reference(cell, seed, dev, prec="fp8"),
           "half_batch": reference(cell, seed, dev, fault="half_batch")}
    return {k: compare.train_numbers(r, ref) for k, r in out.items()}
