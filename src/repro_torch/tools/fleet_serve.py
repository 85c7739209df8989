"""Serve recorded fleet traces over the HTTP dashboard API.

Builds one `JobStream` per trace (job id = file stem), runs them through
a windowed `Collector` inside a `ServiceDaemon`, and serves the
`FleetStore` on `repro_torch.serve.http`'s JSON API.  Each polled grid
goes to the device (the card unless `--device` names another), where
the histogram kernel ingests it:

    python -m repro_torch.tools.fleet_serve day-a.ctr day-b.ctr \
        --port 8080 --round-s 300 --replay-fast
    curl -s localhost:8080/v1/fleet | python -m json.tool
    curl -s 'localhost:8080/v1/query?kind=top_regressions&k=3'

`--replay-fast` replays on a simulated clock (no sleeping — an archive
browser); without it rounds pace on the real wall clock like a live
deployment.  `--state-dir/--persist-every` enable restartable snapshots
(restored automatically when the state dir already holds one), and
`--tee-dir` re-records everything polled into per-job columnar archives.

`--self-check` is the smoke test: simulate a regressed trace on the
device, record it, serve it through a full daemon on an ephemeral port, hit every endpoint
family with `FleetClient`, and assert 200s plus an ETag 304 on repeat.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch._device import resolve_device
from repro_torch.fleet.collector import Collector, CollectorConfig, JobStream
from repro_torch.serve import (FleetAPIServer, FleetClient, ServiceDaemon,
                               SimClock)
from repro_torch.telemetry.source import DeviceSource, TraceReplaySource


def _streams(paths, device, interval_s=None):
    streams = []
    for path in paths:
        job_id = os.path.splitext(os.path.basename(path.rstrip("/")))[0]
        streams.append(JobStream(job_id, DeviceSource(
            TraceReplaySource(path, interval_s=interval_s), device)))
    return streams


def serve(args) -> int:
    streams = _streams(args.traces, resolve_device(args.device),
                       interval_s=args.interval_s)
    config = CollectorConfig(round_s=args.round_s, bucket_s=args.bucket_s,
                             retain=args.retain,
                             detector={"window": args.window,
                                       "min_duration": args.min_duration})
    daemon_kw = dict(persist_every=args.persist_every,
                     tee_dir=args.tee_dir)
    if args.replay_fast:
        clk = SimClock()
        daemon_kw.update(clock=clk.monotonic, sleep=clk.sleep)
    if args.state_dir and os.path.isfile(
            os.path.join(args.state_dir, "daemon_state.json")):
        daemon = ServiceDaemon.restore(args.state_dir, streams, config,
                                       **daemon_kw)
        print(f"restored daemon state from {args.state_dir} "
              f"(round {daemon.collector.round_idx})")
    else:
        daemon = ServiceDaemon(Collector(streams, config),
                               state_dir=args.state_dir, **daemon_kw)
    with daemon, FleetAPIServer(daemon.store, host=args.host,
                                port=args.port) as server:
        print(f"serving {len(streams)} job stream(s) on {server.url}")
        print(f"  {server.url}/v1/fleet")
        print(f"  {server.url}/v1/jobs")
        print(f"  {server.url}/v1/alerts")
        print(f"  {server.url}/v1/query?kind=top_regressions&k=5")
        try:
            daemon.run(n_rounds=args.rounds)
            print("replay exhausted; still serving final state "
                  "(ctrl-C to exit)" if args.serve_after else
                  "replay exhausted")
            if args.serve_after:
                import threading
                threading.Event().wait()
        except KeyboardInterrupt:
            print("\nstopping")
    return 0


def self_check(device=None) -> int:
    """Daemon over a replay archive on an ephemeral port, its grids
    ingested on `device` (the card when None); all endpoint families
    must 200 and a repeat poll must 304 (smoke test)."""
    import tempfile

    from repro_torch.fleet.engine import simulate_devices
    from repro_torch.telemetry.counters import Event, StepProfile
    from repro_torch.telemetry.scrape import DeviceGrid
    from repro_torch.telemetry.source import write_trace

    device = resolve_device(device)
    prof = StepProfile(mxu_time_s=0.84, step_time_s=2.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "selfcheck.ctr")
        grid = simulate_devices(prof, duration_s=3600, interval_s=30.0,
                                events=[Event(1800, 3600, slowdown=2.5)],
                                n_devices=4, seed=7, device=device)
        # the archive holds the simulated counters as host arrays
        write_trace(DeviceGrid(grid.interval_s, grid.tpa.cpu().numpy(),
                               grid.clock_mhz.cpu().numpy(),
                               t0_s=grid.t0_s), path, chunk_samples=64)
        clk = SimClock()
        config = CollectorConfig(round_s=300, bucket_s=300, retain=12,
                                 detector={"window": 3, "min_duration": 1})
        daemon = ServiceDaemon(Collector(_streams([path], device), config),
                               clock=clk.monotonic, sleep=clk.sleep)
        with daemon, FleetAPIServer(daemon.store) as server:
            reports = daemon.run()
            client = FleetClient(server.url)
            fleet = client.fleet()
            assert fleet["t_s"], "fleet series is empty"
            jobs = client.jobs()
            assert jobs["jobs"] == ["selfcheck"], jobs
            job = client.job("selfcheck")
            assert len(job["mean"]) == len(fleet["mean"])
            alerts = client.alerts()
            assert any(a["kind"] == "regression"
                       for a in alerts["alerts"]), alerts
            worst = client.top_regressions(k=3, window=3, min_duration=1)
            assert worst["regressions"] \
                and worst["regressions"][0]["factor"] > 1.8
            assert client.goodput()["weighted_ofu"] is not None
            # the poller pattern: unchanged generation => ETag 304
            before = client.hits_304
            again = client.fleet()
            assert client.hits_304 == before + 1, "no 304 on repeat"
            assert again == fleet
            n304 = client.hits_304
    print(f"SELF-CHECK OK: {len(reports)} rounds ingested on {device} and "
          f"served, all endpoint "
          f"families 200, repeat poll -> 304 ({n304} cache hit), "
          f"regression visible at /v1/query")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("traces", nargs="*",
                    help="trace files/archives; job id = file stem")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (printed at startup)")
    ap.add_argument("--round-s", type=float, default=300.0)
    ap.add_argument("--bucket-s", type=float, default=300.0)
    ap.add_argument("--retain", type=int, default=24)
    ap.add_argument("--window", type=int, default=4,
                    help="regression detector reference window")
    ap.add_argument("--min-duration", type=int, default=2)
    ap.add_argument("--interval-s", type=float, default=None,
                    help="scrape interval for single-poll row traces")
    ap.add_argument("--rounds", type=int, default=None,
                    help="stop after N rounds (default: run to exhaustion)")
    ap.add_argument("--replay-fast", action="store_true",
                    help="simulated clock: no sleeping between rounds")
    ap.add_argument("--serve-after", action="store_true",
                    help="keep serving the final state after replay ends")
    ap.add_argument("--state-dir", default=None,
                    help="snapshot persistence dir (auto-restores)")
    ap.add_argument("--persist-every", type=int, default=0,
                    help="persist state every N rounds")
    ap.add_argument("--tee-dir", default=None,
                    help="re-record polled grids as per-job .ctr archives")
    ap.add_argument("--device", default=None,
                    help="torch device that ingests the polled grids; "
                    "the card when omitted")
    ap.add_argument("--self-check", action="store_true",
                    help="serve a synthetic archive end-to-end and exit "
                    "(smoke test)")
    args = ap.parse_args(argv)
    if args.self_check:
        return self_check(args.device)
    if not args.traces:
        ap.error("at least one trace is required (or pass --self-check)")
    return serve(args)


if __name__ == "__main__":
    sys.exit(main())
