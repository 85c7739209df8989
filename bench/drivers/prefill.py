"""The prefill driver: a closed loop of one client sending one request at
a time (B 1) to the program's prefill step, for the measured window;
then the reference scores the served token of a sample of the finished
requests.

Mix keys: block (a multiset of prompt lengths, {length: count}; each
block of requests takes it in an order drawn from the seed), sample (how
many finished requests the reference scores, the longest always among
them), trace_requests (the traced window after the measured one),
max_rate_per_s (sizes the prompts made in set-up: the window ends early
past that rate).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

import compare
import harness
import inputs
from frozen import flops
from reference import ops
from reference.models import last_logits

KEYS = {"kind", "block", "sample", "trace_requests", "max_rate_per_s"}


def served_sample(lengths: list, n_done: int, k: int, seed: int) -> list:
    """Indices of k requests of the first n_done, drawn from the seed,
    the first of the longest among them always in."""
    longest = max(range(n_done), key=lambda j: (lengths[j], -j))
    rest = [j for j in range(n_done) if j != longest]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + sorted(rest[j] for j in pick)


def reference_gaps(c: dict, params, prompts_: list, served: list) -> list:
    """For each prompt: how far the reference's logit of the served token
    lies below the reference's best (0 where they agree)."""
    out = []
    for toks, tok in zip(prompts_, served):
        lg = last_logits(c, params, toks[None], ops.Prec("f32"))[0]
        out.append(float(lg.max() - lg[int(tok)]))
    return out


def control_tokens(c: dict, params, prompts_: list) -> list:
    """The control's served tokens: what the reference computed with fp8
    matrix products puts first at the last position of each prompt."""
    return [int(last_logits(c, params, toks[None], ops.Prec("fp8"))[0]
                .argmax()) for toks in prompts_]


def run(cell, cfg, seed: int, seconds: float, trace: bool, dev,
        t0: float) -> dict:
    from repro_torch.train import steps

    mix, c = cell.mix, cell.sizes
    block = sum(mix["block"].values())
    n_max = int(mix["max_rate_per_s"] * seconds) + 2 * block \
        + mix["trace_requests"]
    params = inputs.weights(c, seed, dev)
    prefill = steps.make_prefill_step(cfg)
    lengths, prompts_ = inputs.prompts(mix, seed, n_max, c["vocab_size"], dev)
    with torch.no_grad():
        for L in sorted(set(lengths)):
            prefill(params, {"tokens": prompts_[lengths.index(L)][None]})
    harness.sync(dev)
    setup_s = time.perf_counter() - t0
    harness.log("set-up done", t0)

    lat, served = [], []

    def one(j):
        t = time.perf_counter()
        with torch.no_grad(), torch.profiler.record_function("bench.request"):
            tok = prefill(params, {"tokens": prompts_[j][None]})
            harness.sync(dev)
        lat.append(time.perf_counter() - t)
        served.append(tok)

    start = time.perf_counter()
    limit = n_max - mix["trace_requests"] - block
    while time.perf_counter() - start < seconds and len(served) < limit:
        one(len(served))
    elapsed = time.perf_counter() - start
    n = len(served)
    done_lat = list(lat)
    peak = harness.peak(dev)
    window = {"elapsed_s": elapsed, "count": n,
              "tokens": sum(lengths[:n]),
              "model_flops": sum(flops.forward_flops(c, 1, L)
                                 for L in lengths[:n]),
              "spans": {}}
    run = harness.Run(window)
    if trace:
        j0 = -(-n // block) * block
        k = mix["trace_requests"]
        _, run.trace = harness.traced(cell, lambda: [one(j) for j in
                                              range(j0, j0 + k)], dev)
        run.units = k
    harness.log(f"window: {n} requests in {elapsed:.3f} s, peak "
        f"{peak / 2**30:.2f} GiB", t0)
    tokens = [int(t.reshape(-1)[0]) for t in served[:n]]
    failed = sum(not 0 <= t < c["vocab_size"] for t in tokens)
    del params, prefill, served
    harness.free(dev)

    pick = served_sample(lengths, n, mix["sample"], seed)
    ref_params = inputs.weights(cell.sizes, seed, dev)
    gaps = reference_gaps(cell.sizes, ref_params,
                          [prompts_[j] for j in pick], [tokens[j] for j in pick])
    del ref_params
    harness.log(f"reference done, gaps {[round(g, 4) for g in gaps]}", t0)
    checks = compare.prefill_checks(gaps, cell.limits)
    srt = sorted(done_lat)
    e2e = {"prefill_tokens_per_s": window["tokens"] / elapsed,
           "prefill_p95_ms": 1e3 * srt[math.ceil(0.95 * n) - 1],
           "setup_s": setup_s}
    return {"attempted": n, "failed": failed, "peak": peak, "e2e": e2e,
            "run": run, "checks": checks}


def readings(cell, cfg, seed: int, dev) -> dict:
    """The cell's own comparison over whole blocks of requests, as many
    as a run scores, sampled as a run samples them: the gap of the
    program's served tokens ("program") and of the tokens fp8 products
    put first at the same last positions ("control")
    (`bench/control.py`)."""
    from repro_torch.train import steps
    mix, c = cell.mix, cell.sizes
    block = sum(mix["block"].values())
    n = block * -(-mix["sample"] // block)
    lengths, prompts_ = inputs.prompts(mix, seed, n, c["vocab_size"], dev)
    params = inputs.weights(c, seed, dev)
    prefill = steps.make_prefill_step(cfg)
    with torch.no_grad():
        served = [int(prefill(params, {"tokens": p[None]}).reshape(-1)[0])
                  for p in prompts_]
    del params, prefill
    harness.free(dev)
    pick = served_sample(lengths, n, mix["sample"], seed)
    params = inputs.weights(c, seed, dev)
    mine = [prompts_[j] for j in pick]
    gaps = {"program": reference_gaps(c, params, mine,
                                      [served[j] for j in pick]),
            "control": reference_gaps(c, params, mine,
                                      control_tokens(c, params, mine))}
    return {k: {"logit_gap": (max(g), None)} for k, g in gaps.items()}
