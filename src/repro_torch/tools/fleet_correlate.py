"""Correlate application-reported MFU against hardware OFU.

Three modes:

  * fixture sweep (default) — rebuild the paper's Table III fleet
    (`repro_torch.fleet.table3`, 608 jobs incl. the §V-C miscalculated
    populations) on the device (the card unless `--device` names
    another; the histogram kernel ingests every job's grid there), run
    the offline correlation analysis, and print the headline numbers
    plus the flagged jobs:

        python -m repro_torch.tools.fleet_correlate
        python -m repro_torch.tools.fleet_correlate --seed 3 --json

  * log parse — extract a training job's reported throughput stream
    from its log (Megatron-style ``throughput per GPU (TFLOP/s/GPU):``
    lines), convert to MFU samples, and optionally ship them to a live
    fleet API's ``POST /v1/mfu``:

        python -m repro_torch.tools.fleet_correlate \
            --log train.log --job-id prod-llm-7b --peak-tflops 989 \
            --url http://fleethost:8080

  * ``--self-check`` — the gate: replay the FULL 608-job fixture
    through a live `Collector` into `FleetStore` + the HTTP query
    surface, and assert (a) the flagged set is EXACTLY the
    naive_moe/naive_hybrid populations on both the divergence and the
    correlation detector, (b) r-after-exclusion >= 0.75, (c) every
    per-job bucket count, MFU bucket and served r matches the offline
    path's (`benchmarks.production_correlation`), the OFU bucket means
    within rtol 1e-5 and the r values within 1e-5 (on a card the
    histogram kernel's sums land by atomics in no fixed order, so one
    offline launch and four live ones agree to rounding), (d) the
    log-line reporter and the ``POST /v1/mfu`` ingest round-trip.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch._device import resolve_device
from repro_torch.fleet import table3
from repro_torch.fleet.correlation import analyze_correlation
from repro_torch.fleet.divergence import analyze_rollup
from repro_torch.telemetry.mfu import MfuReporter


def sweep(args) -> int:
    """Offline fixture sweep: the Fig. 5 / Table III numbers."""
    jobs = table3.build_jobs(args.seed, device=resolve_device(args.device))
    roll, mfu = table3.offline_rollups(jobs)
    crep = analyze_correlation(mfu, roll)
    if args.json:
        print(json.dumps(crep.to_payload(), indent=2))
        return 0
    print(crep.summary())
    rep = analyze_rollup(roll, flag_rel_err=args.flag_rel_err)
    print(f"divergence @ rel_err>{args.flag_rel_err:g}: "
          f"r_all={rep.r_all:.3f} r_after_exclusion={rep.r_clean:.3f} "
          f"flagged={len(rep.flagged)}")
    for f in crep.flagged[:args.top]:
        print(f"  {f.job_id:<14} ratio={f.ratio:5.2f}x "
              f"mfu={f.mfu * 100:5.1f}% ofu_adj={f.ofu_adj * 100:5.1f}% "
              f"buckets={f.n_buckets} ({f.direction})")
    if len(crep.flagged) > args.top:
        print(f"  ... and {len(crep.flagged) - args.top} more")
    return 0


def parse_log(args) -> int:
    """Parse a training log into MFU samples; optionally POST them."""
    reporter = MfuReporter(args.job_id, peak_tflops=args.peak_tflops)
    with open(args.log) as f:
        n = reporter.feed_log(f)
    if not n:
        print(f"no throughput lines found in {args.log}", file=sys.stderr)
        return 1
    samples = reporter.samples
    mean = sum(s.mfu for s in samples) / len(samples)
    print(f"{args.job_id}: {len(samples)} samples, "
          f"mean MFU {mean * 100:.2f}%, "
          f"last {samples[-1].mfu * 100:.2f}% "
          f"({samples[-1].tflops_per_gpu:.1f} TFLOP/s/GPU "
          f"/ {args.peak_tflops:g} peak)")
    if args.url:
        from repro_torch.serve.client import FleetClient
        out = FleetClient(args.url).post_mfu(args.job_id, samples)
        print(f"POST /v1/mfu -> applied {out['applied']} rows")
    return 0


def self_check(device=None) -> int:
    """Replay the Table III fixture, simulated on `device` (the card
    when None), through the LIVE serve path and assert it matches the
    offline path bucketwise (the gate)."""
    rep = check(table3.build_jobs(0, device=resolve_device(device)))
    print(f"SELF-CHECK OK: {rep['jobs']} jobs x {rep['rounds']} rounds "
          f"through the live serve path; flagged set == "
          f"{{naive_moe: {rep['naive_moe']}, naive_hybrid: "
          f"{rep['naive_hybrid']}}} exactly on both detectors, "
          f"r_all={rep['r_all']:.3f} -> "
          f"r_after_exclusion={rep['r_clean']:.3f} (floor 0.75), "
          f"offline/live counts and MFU buckets identical, OFU means "
          f"within {rep['mean_rel']:.1e} (rel), r within "
          f"{rep['r_diff']:.1e}, reporter + POST /v1/mfu round-trip clean")
    return 0


def check(jobs) -> dict:
    """The self-check's assertions on the fixture `jobs`; the served
    report: job and round counts, the flagged sets' sizes, the served
    correlation r_all and r_clean, the flagged job ids, and the largest
    relative OFU-mean and absolute r gaps between live and offline."""
    import numpy as np

    from repro_torch.core.ofu import effective_peak
    from repro_torch.core.peaks import DEFAULT_CHIP
    from repro_torch.fleet.collector import Collector, CollectorConfig
    from repro_torch.serve import (FleetAPIServer, FleetClient, FleetStore,
                                   IngestAggregator)
    from repro_torch.telemetry.mfu import compute_mfu, reported_tflops_per_gpu

    # -- offline half (the benchmarks.production_correlation path) -----
    truth = table3.affected_ids(jobs)
    affected = set().union(*truth.values())
    roll_off, mfu_off = table3.offline_rollups(jobs)
    rep_off = analyze_rollup(roll_off, flag_rel_err=table3.FLAG_REL_ERR)
    crep_off = analyze_correlation(mfu_off, roll_off)

    # -- live half: Collector rounds -> FleetStore -> HTTP queries -----
    col = Collector(table3.to_streams(jobs),
                    CollectorConfig(round_s=table3.ROUND_S,
                                    bucket_s=table3.BUCKET_S,
                                    flag_rel_err=table3.FLAG_REL_ERR))
    reports = col.run()
    miscalc_alerts = {a.job_id for a in col.alerts if a.kind == "miscalc"}
    assert miscalc_alerts == affected, (
        f"live miscalc alerts != ground truth: "
        f"extra={sorted(miscalc_alerts - affected)[:5]} "
        f"missing={sorted(affected - miscalc_alerts)[:5]}")

    store = FleetStore()
    store.update_from(col)
    agg = IngestAggregator(n_shards=2)
    with FleetAPIServer(store, aggregator=agg) as server:
        client = FleetClient(server.url)
        div = client.divergence(flag_rel_err=table3.FLAG_REL_ERR)
        corr = client.correlation()

        flagged_div = {f["job_id"] for f in div["flagged"]}
        flagged_corr = {f["job_id"] for f in corr["flagged"]}
        assert flagged_div == affected, (
            f"divergence flags != ground truth "
            f"({len(flagged_div)} vs {len(affected)})")
        assert flagged_corr == affected, (
            f"correlation flags != ground truth "
            f"({len(flagged_corr)} vs {len(affected)})")
        assert corr["r_clean"] >= 0.75, (
            f"r after exclusion {corr['r_clean']:.3f} < 0.75")
        # live serve numbers == offline numbers, not approximately
        r_diff = 0.0
        for name, live, off in [
                ("divergence r_all", div["r_all"], rep_off.r_all),
                ("divergence r_clean", div["r_clean"], rep_off.r_clean),
                ("correlation r_all", corr["r_all"], crep_off.r_all),
                ("correlation r_clean", corr["r_clean"], crep_off.r_clean)]:
            assert abs(live - off) < 1e-5, f"{name}: {live} != {off}"
            r_diff = max(r_diff, abs(live - off))

        # bucketwise, every job: counts and mfu series identical, OFU
        # means within rtol 1e-5
        mean_rel = 0.0
        for job in jobs:
            jid = job.job_id
            key = ("job", jid)
            n = roll_off._hists[key].shape[0]
            assert np.array_equal(roll_off._hists[key],
                                  col.rollup._hists[key][:n]), \
                f"{jid}: OFU bucket counts differ"
            so = roll_off.job_stats(jid, qs=())
            sl = col.rollup.job_stats(jid, qs=())
            mo, ml = so.mean[~np.isnan(so.mean)], sl.mean[~np.isnan(sl.mean)]
            assert mo.shape == ml.shape and np.allclose(
                mo, ml, rtol=1e-5, atol=0.0), f"{jid}: OFU buckets differ"
            if mo.size:
                mean_rel = max(mean_rel,
                               float(np.max(np.abs(mo - ml) / np.abs(mo))))
            io_, vo = mfu_off.job_series(jid)
            il, vl = col.mfu.job_series(jid)
            assert np.array_equal(io_, il) and np.array_equal(vo, vl), \
                f"{jid}: MFU buckets differ"

        # reporter round-trip: synthetic Megatron-style log -> samples
        peak = effective_peak({"bf16": 1.0}, DEFAULT_CHIP)
        tfl = reported_tflops_per_gpu("llama3.2-3b", 2.0, 64)
        lines = [f" iteration {10 * (k + 1)}/ 1000 | elapsed time per "
                 f"iteration (ms): 2000.0 | throughput per GPU "
                 f"(TFLOP/s/GPU): {tfl:.3f} |" for k in range(5)]
        rep = MfuReporter.for_chip("probe-3b")
        assert len(rep.feed_log(lines)) == 5
        want = compute_mfu(float(f"{tfl:.3f}"), peak)  # log-line rounding
        got = rep.samples[-1].mfu
        assert abs(got - want) < 1e-12, f"reporter MFU {got} != {want}"

        # POST /v1/mfu ingest round-trip through the aggregator
        out = client.post_mfu("probe-3b", rep.samples)
        assert out["applied"] == 5, out
        agg.publish(store, clock_s=col.clock_s)
        stats = client._get("/v1/ingest")
        assert stats["mfu_rows"] == 5 and stats["mfu_jobs"] == 1, stats

    return {"jobs": len(jobs), "rounds": len(reports),
            "naive_moe": len(truth["naive_moe"]),
            "naive_hybrid": len(truth["naive_hybrid"]),
            "r_all": corr["r_all"], "r_clean": corr["r_clean"],
            "flagged": sorted(flagged_corr), "mean_rel": mean_rel,
            "r_diff": r_diff}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="fixture seed for the offline sweep")
    ap.add_argument("--flag-rel-err", type=float,
                    default=table3.FLAG_REL_ERR,
                    help="divergence exclusion threshold")
    ap.add_argument("--top", type=int, default=10,
                    help="flagged jobs to print")
    ap.add_argument("--json", action="store_true",
                    help="emit the full correlation payload as JSON")
    ap.add_argument("--log", default=None,
                    help="training log to parse for throughput lines")
    ap.add_argument("--job-id", default="job-0",
                    help="job id for parsed log samples")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="per-GPU peak TFLOP/s for --log MFU conversion")
    ap.add_argument("--url", default=None,
                    help="fleet API base URL to POST parsed samples to")
    ap.add_argument("--device", default=None,
                    help="torch device of the fixture's simulation and "
                    "ingest; the card when omitted")
    ap.add_argument("--self-check", action="store_true",
                    help="replay the 608-job fixture through the live "
                    "serve path and verify it against the offline path "
                    "(the gate)")
    args = ap.parse_args(argv)
    if args.self_check:
        return self_check(args.device)
    if args.log:
        if args.peak_tflops is None:
            ap.error("--log requires --peak-tflops")
        return parse_log(args)
    return sweep(args)


if __name__ == "__main__":
    sys.exit(main())
