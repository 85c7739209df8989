"""Fleet monitoring walkthrough — the paper's §II/§V/§VI story end-to-end:

1. a mixed fleet of jobs (some with buggy FLOPs counters, one with an
   injected host-sync regression, one straggler) emits ONLY hardware
   counters (one fused multi-job engine pass);
2. the collector computes per-job OFU (Eq. 11);
3. divergence triage flags the FLOPs miscalculations (§V-C);
4. the regression detector + recovery service catch the 2.5x collapse
   (§VI-A) and the straggler monitor isolates the slow device;
5. the goodput rollup shows OFU covering 100% of chip-hours;
6. the same pipeline replays a RECORDED trace (no simulator in the loop)
   and tree-reduces per-host rollups into one fleet dashboard;
7. a continuous Collector daemon polls a SimulatorSource AND a
   TraceReplaySource round after round into a windowed rollup, retimes
   scrape intervals adaptively, and prints rolling regression alerts —
   the paper's live-dashboard deployment instead of batch ingestion;
8. the serving layer puts an HTTP dashboard API in front of it: a
   ServiceDaemon paces the collector on a (simulated) wall clock,
   publishing every round into a FleetStore, and a FleetClient queries
   fleet series / top regressions / alerts over stdlib HTTP — repeat
   polls ride generation ETags as 304s.

  PYTHONPATH=src python -m repro_torch.examples.fleet_monitoring \\
      [--device cpu]

Counters are simulated on the card (unless --device names another
device), and every rollup ingests them there through the histogram
kernel; per-device series come to the host only for the scalar
detectors and the recorded traces.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.core.ofu import ofu_series
from repro_torch.fleet import (AdaptiveConfig, Collector, CollectorConfig,
                               JobSpec, JobStream, RecoveryService,
                               StragglerMonitor, StreamingRollup, analyze,
                               rollup, simulate_fleet)
from repro_torch.fleet.distributed import host_partition, tree_reduce
from repro_torch.fleet.divergence import JobPoint
from repro_torch.fleet.regression import detect_regressions, scan_rollup
from repro_torch.telemetry import (DeviceGrid, Event, SimulatorSource,
                                   StepProfile, TraceReplaySource,
                                   write_trace)
from repro_torch.telemetry.tracestore import archive_nbytes


def main(argv=None) -> dict:
    """Run the walkthrough; return what the checks read: the divergence
    triage's flagged job ids, the jobs the collector alerted on and the
    number of alerts the API served."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    device = ap.parse_args(argv).device
    specs = [
        JobSpec("dense-a", "qwen3-4b", chips=256, true_duty=0.42,
                duration_s=1200),
        JobSpec("dense-b", "llama3.2-3b", chips=512, true_duty=0.38,
                duration_s=1200),
        JobSpec("ssm-pretrain", "mamba2-780m", chips=128, true_duty=0.33,
                duration_s=1200),
        # never onboarded to app-level MFU reporting (the 80% problem, §II)
        JobSpec("legacy-job", "deepseek-moe-16b", chips=512, true_duty=0.22,
                duration_s=1200, flops_variant="none"),
        # §V-C case 1: MoE with latent projections the counter misses
        JobSpec("moe-16b-exp3", "deepseek-v3-671b", chips=288,
                flops_variant="naive_moe", true_duty=0.25, duration_s=1200),
        # §V-C case 2: hybrid billed as attention+MLP everywhere
        JobSpec("hybrid-8b", "zamba2-7b", chips=256,
                flops_variant="naive_hybrid", true_duty=0.28,
                duration_s=1200),
        # §VI-A: debug flag merged to main -> host-sync serialization
        JobSpec("embodied-agent", "phi-3-vision-4.2b", chips=256,
                true_duty=0.45, duration_s=1200,
                events=[Event(600, 1200, slowdown=2.5)]),
        # a straggling device in an otherwise healthy job
        JobSpec("straggly", "granite-3-2b", chips=64, true_duty=0.40,
                duration_s=1200, straggler_sigma=0.0, seed=9),
    ]

    print("== scraping fleet (30 s interval, hardware counters only) ==")
    # vectorized engine: every sampled device of every job in one pass
    tels = {t.spec.job_id: t
            for t in simulate_fleet(specs, max_devices=32, device=device)}
    # the regressed job's counters on the host, for the scalar detector
    # and the recorded traces
    g = tels["embodied-agent"].grid
    agent_grid = DeviceGrid(g.interval_s, g.tpa.cpu().numpy(),
                            g.clock_mhz.cpu().numpy(), t0_s=g.t0_s)
    points = [JobPoint(t.spec.job_id, t.spec.arch, t.spec.chips,
                       t.app_mfu, t.ofu, t.spec.flops_variant)
              for t in tels.values()]
    for p in points:
        print(f"  {p.job_id:16s} chips={p.chips:4d} "
              f"app_mfu={p.mfu * 100:5.1f}% ofu={p.ofu * 100:5.1f}%")

    print("\n== divergence triage (FLOPs miscalculation signature) ==")
    rep_div = analyze(points)
    for p in rep_div.flagged:
        print(f"  FLAGGED {p.job_id}: app-reported {p.mfu * 100:.1f}% vs "
              f"OFU {p.ofu * 100:.1f}% (rel err {p.rel_err * 100:.0f}%) -> "
              "audit the framework FLOPs formula, or check for a runtime "
              "regression (below)")

    print("\n== regression detection + autonomous recovery (§VI-A) ==")
    svc = RecoveryService(factor_threshold=1.8, sustain_samples=3,
                          cooldown_samples=100)
    s = agent_grid.series(0)
    ofu = ofu_series(s.tpa, s.clock_mhz)
    for i, v in enumerate(ofu):
        a = svc.observe("embodied-agent", float(v))
        if a:
            print(f"  recovery action at sample {i}: {a.reason} "
                  f"(factor {a.factor:.2f}x) -> restart from checkpoint")
    print(f"  ofu before regression: {ofu[:20].mean() * 100:.1f}%  "
          f"during: {ofu[25:].mean() * 100:.1f}%")

    print("\n== straggler isolation ==")
    per_dev = np.array(tels["straggly"].grid.tpa.mean(dim=1).tolist()
                       + [0.11])
    flagged = StragglerMonitor().flag(per_dev)
    print(f"  device duty cycles: {np.round(per_dev, 3)} -> "
          f"flag devices {flagged}")

    print("\n== streaming rollup (per-job / per-precision / fleet) ==")
    roll = StreamingRollup(bucket_s=300)
    for t in tels.values():
        roll.add_job(t)
    print(" ", roll.summary())
    f = roll.fleet_stats()
    for b in range(roll.n_buckets):
        print(f"  t={f.centers_s[b]:6.0f}s p10={f.percentiles[10][b] * 100:5.1f}% "
              f"p50={f.percentiles[50][b] * 100:5.1f}% "
              f"p90={f.percentiles[90][b] * 100:5.1f}%")
    # the bucketed per-job series feeds the same regression detector
    regs = detect_regressions(roll.job_ofu("embodied-agent"),
                              window=2, min_duration=1)
    detail = f"factor {regs[0].factor:.2f}x" if regs else "none found"
    print(f"  bucketed detector on embodied-agent: "
          f"{len(regs)} regression(s), {detail}")

    print("\n== goodput rollup (§II) ==")
    print(" ", rollup(list(tels.values())).summary())

    print("\n== trace replay (source-agnostic pipeline) ==")
    # record the regressed job's counters, then drive the SAME rollup +
    # detector from the replayed file — no simulator in the loop
    with tempfile.NamedTemporaryFile(suffix=".jsonl", delete=False) as fh:
        trace_path = fh.name
    try:
        write_trace(agent_grid, trace_path)
        replay_roll = StreamingRollup(bucket_s=120)
        replay_roll.add_grid("replayed-agent",
                             TraceReplaySource(trace_path).scrapes(),
                             group="bf16", chips=256,
                             app_mfu=tels["embodied-agent"].app_mfu)
        found = scan_rollup(replay_roll, window=2, min_duration=1)
        for jid, regs in found.items():
            print(f"  {trace_path} -> {jid}: {len(regs)} regression(s), "
                  f"factor {regs[0].factor:.2f}x")

        # the fleet-scale archive path: the same trace as a chunked
        # COLUMNAR store (telemetry/tracestore.py) — smaller on disk,
        # and replayable in O(chunk) memory instead of O(trace)
        ctr_path = trace_path + ".ctr"
        write_trace(agent_grid, ctr_path, chunk_samples=8)
        ctr_src = TraceReplaySource(ctr_path)
        ctr_roll = StreamingRollup(bucket_s=120)
        while not ctr_src.exhausted:          # stream, chunk by chunk
            grid = ctr_src.poll(240)
            if grid.tpa.size:
                ctr_roll.add_grid("archived-agent", grid, group="bf16",
                                  chips=256)
        rd = ctr_src.reader
        jsonl_b = os.path.getsize(trace_path)
        ctr_b = archive_nbytes(ctr_path)
        total = agent_grid.tpa.size
        found = scan_rollup(ctr_roll, window=2, min_duration=1)
        print(f"  columnar archive: {ctr_b:,} B vs {jsonl_b:,} B jsonl "
              f"({jsonl_b / ctr_b:.1f}x smaller), peak resident "
              f"{rd.peak_resident_samples}/{total} samples, regression "
              f"still detected: {'archived-agent' in found}")
        for f in os.listdir(ctr_path):
            os.unlink(os.path.join(ctr_path, f))
        os.rmdir(ctr_path)
    finally:
        os.unlink(trace_path)

    print("\n== distributed rollup (per-host merge -> fleet dashboard) ==")
    hosts = host_partition(list(tels.values()), 3)
    blobs = []
    for h, host_tels in enumerate(hosts):
        local = StreamingRollup(bucket_s=300)
        for t in host_tels:
            local.add_job(t)
        blob = local.to_bytes()
        blobs.append(blob)
        print(f"  host{h}: {len(host_tels)} jobs -> {len(blob)} B snapshot")
    fleet = tree_reduce(blobs)
    print(" ", fleet.summary())
    same = np.allclose(fleet.fleet_stats().mean, roll.fleet_stats().mean,
                       equal_nan=True)
    print(f"  bucketwise identical to single-process rollup: {same}")

    print("\n== continuous monitoring (collector daemon, windowed) ==")
    # the same pipeline as a LONG-LIVED loop: poll sources incrementally,
    # fold into a bounded windowed rollup, detect + alert every round,
    # and retime scrape intervals adaptively (Table I tradeoff).  One
    # stream is generative; one replays the recorded trace from above —
    # the collector never knows the difference.
    prof = StepProfile(mxu_time_s=0.84, step_time_s=2.0)
    with tempfile.NamedTemporaryFile(suffix=".csv", delete=False) as fh:
        replay_path = fh.name
    try:
        write_trace(agent_grid, replay_path)
        streams = [
            JobStream("live-healthy",
                      SimulatorSource(prof, duration_s=2400, interval_s=30,
                                      n_devices=8, seed=11, device=device),
                      chips=256, group="bf16"),
            JobStream("live-regressing",
                      SimulatorSource(prof, duration_s=2400, interval_s=30,
                                      n_devices=8, seed=12, device=device,
                                      events=[Event(1350, 2400,
                                                    slowdown=2.5)]),
                      chips=512, group="bf16"),
            JobStream("replayed-agent", TraceReplaySource(replay_path),
                      chips=256, group="bf16",
                      app_mfu=tels["embodied-agent"].app_mfu),
        ]
        col = Collector(streams, CollectorConfig(
            round_s=300, bucket_s=150, retain=8,
            detector={"window": 3, "min_duration": 1},
            adaptive=AdaptiveConfig(min_interval_s=7.5)))
        alerted = set()
        for rep in col.run():
            alerted.update(a.job_id for a in rep.alerts)
            line = (f"  round {rep.round_idx} t={rep.t_s:5.0f}s "
                    f"samples={rep.samples:4d} "
                    f"interval[live-regressing]="
                    f"{rep.intervals['live-regressing']:4.1f}s")
            print(line)
            for a in rep.alerts:
                print(f"    ALERT {a.summary()}")
        print(" ", col.rollup.summary())
        at = col.rollup.job_alltime("live-regressing")
        print(f"  live-regressing all-time OFU (survives eviction): "
              f"{at['mean'] * 100:.1f}%")
    finally:
        os.unlink(replay_path)

    print("\n== serving the fleet (daemon + HTTP dashboard API) ==")
    # the same continuous loop, deployed: a ServiceDaemon paces rounds on
    # the wall clock (simulated here, so the example finishes instantly)
    # and publishes each one into a FleetStore; dashboards poll a
    # stdlib-only JSON API whose ETags make unchanged polls free (304)
    from repro_torch.serve import (FleetAPIServer, FleetClient, ServiceDaemon,
                             SimClock)
    streams = [
        JobStream("served-healthy",
                  SimulatorSource(prof, duration_s=2400, interval_s=30,
                                  n_devices=8, seed=31, device=device),
                  chips=256),
        JobStream("served-regressing",
                  SimulatorSource(prof, duration_s=2400, interval_s=30,
                                  n_devices=8, seed=32, device=device,
                                  events=[Event(1200, 2400,
                                                slowdown=2.5)]),
                  chips=512),
    ]
    clk = SimClock()
    daemon = ServiceDaemon(
        Collector(streams,
                  CollectorConfig(round_s=300, bucket_s=300, retain=8,
                                  detector={"window": 3,
                                            "min_duration": 1})),
        clock=clk.monotonic, sleep=clk.sleep)
    with daemon, FleetAPIServer(daemon.store) as server:
        daemon.run()
        client = FleetClient(server.url)
        fleet = client.fleet()
        print(f"  GET {server.url}/v1/fleet -> generation "
              f"{fleet['generation']}, weighted OFU "
              f"{fleet['weighted_ofu'] * 100:.1f}%")
        worst = client.top_regressions(k=3, window=3, min_duration=1)
        for reg in worst["regressions"]:
            print(f"  top regression: {reg['job_id']} "
                  f"factor {reg['factor']:.2f}x "
                  f"(bucket {reg['start_bucket']}, "
                  f"{'ongoing' if reg['ongoing'] else 'recovered'})")
        alerts = client.alerts()
        print(f"  /v1/alerts: {alerts['total']} fired, "
              f"open episodes {alerts['active_episodes']}")
        client.fleet()
        print(f"  repeat poll: {client.hits_304} x 304 via ETag "
              f"(store cache hits={daemon.store.cache_hits})")
    return {"flagged": sorted(p.job_id for p in rep_div.flagged),
            "collector_alerted": sorted(alerted),
            "served_alerts": int(alerts["total"])}


if __name__ == "__main__":
    main()
