"""Serve LIVE counter telemetry over the HTTP dashboard API.

Where `fleet_serve` replays recorded traces, this drives the
acquisition tier (`repro_torch.telemetry.backends`): per-GPU
`DcgmFieldBackend`s over a pluggable transport feed a `BackendSource`,
and the rest of the pipeline — `Collector`, `ServiceDaemon`,
`FleetStore`, the JSON API — runs unchanged.  Each polled grid goes to
the device (the card unless `--device` names another), where the
histogram kernel ingests it; the fake transport simulates there too.

    # hardware-less demo: engine-driven fake transport, fast clock
    python -m repro_torch.tools.fleet_live --transport fake \
        --devices 4 --interval-s 30 --duration-s 3600 --replay-fast

    # real DCGM via the dcgmi CLI (one dmon snapshot per round)
    python -m repro_torch.tools.fleet_live --transport dcgmi \
        --interval-s 10 --round-s 60 --port 8080

    # NVML bindings (requires the pynvml module) on one H100: OFU over
    # the card's own f_max
    python -m repro_torch.tools.fleet_live --transport pynvml \
        --chip h100-sxm --interval-s 1 --round-s 5 --bucket-s 5 --rounds 3

`--self-check` is the gate for the whole acquisition tier: it runs the
fake-transport pipeline end-to-end over real HTTP and asserts the
served rollup is BUCKETWISE-IDENTICAL to a pure `SimulatorSource`
pipeline on the same engine seed, its chunks replayed from the host —
transport, backend, retry and source layers must be bit-transparent.
It also exercises the reconnect path (injected transport faults must
not change a single sample), and ingests the simulator's grids on the
device: the same alerts, the same histogram counts as its plain version
on CPU copies of the grids, and bucket means within rtol 1e-5 of the
host path's.  There is no TPU backend: an H100 machine has no libtpu.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.peaks import CHIPS, DEFAULT_CHIP
from repro_torch.fleet.collector import Collector, CollectorConfig, JobStream
from repro_torch.serve import (FleetAPIServer, FleetClient, ServiceDaemon,
                               SimClock)
from repro_torch.telemetry.backends import (DcgmiTransport,
                                            FakeDcgmTransport,
                                            PynvmlTransport, TransportError,
                                            make_dcgm_backends)
from repro_torch.telemetry.counters import Event, StepProfile
from repro_torch.telemetry.source import BackendSource, DeviceSource

#: the demo step profile fake mode simulates (≈42% duty training job)
DEMO_PROFILE = StepProfile(mxu_time_s=0.84, step_time_s=2.0)


def _make_transport(args, device):
    if args.transport == "fake":
        events = [Event(args.duration_s / 2, args.duration_s,
                        slowdown=args.regression)] \
            if args.regression > 1.0 else []
        return FakeDcgmTransport(
            DEMO_PROFILE, duration_s=args.duration_s,
            interval_s=args.interval_s, n_devices=args.devices,
            chunk_s=args.round_s, events=events, seed=args.seed,
            device=device)
    if args.transport == "dcgmi":
        return DcgmiTransport()
    if args.transport == "pynvml":
        return PynvmlTransport()
    raise ValueError(f"unknown transport {args.transport!r}")


def _health_line(backends) -> str:
    return (f"backends: {sum(b.healthy for b in backends)}/"
            f"{len(backends)} healthy, "
            f"polls={sum(b.polls for b in backends)} "
            f"retries={sum(b.retries for b in backends)} "
            f"reconnects={sum(b.reconnects for b in backends)} "
            f"stale={sum(b.stale_reads for b in backends)}")


def serve(args) -> int:
    device = resolve_device(args.device)
    transport = _make_transport(args, device)
    try:
        transport.connect()
    except TransportError as e:
        print(f"transport {args.transport!r} unavailable: {e}",
              file=sys.stderr)
        return 2
    n = args.devices or transport.n_devices
    backends = make_dcgm_backends(transport, n, strict=not args.degraded)
    duration = args.duration_s if args.transport == "fake" \
        else float("inf")
    source = BackendSource(backends=backends, duration_s=duration,
                           interval_s=args.interval_s,
                           strict=not args.degraded)
    config = CollectorConfig(round_s=args.round_s, bucket_s=args.bucket_s,
                             retain=args.retain)
    daemon_kw = {}
    if args.replay_fast:
        clk = SimClock()
        daemon_kw.update(clock=clk.monotonic, sleep=clk.sleep)
    daemon = ServiceDaemon(Collector(
        [JobStream(args.job_id, DeviceSource(source, device),
                   chip=CHIPS[args.chip])], config),
        **daemon_kw)
    with daemon, FleetAPIServer(daemon.store, host=args.host,
                                port=args.port) as server:
        print(f"live: {n} device(s) via {args.transport} transport, "
              f"interval {args.interval_s:g}s, round {args.round_s:g}s, "
              f"OFU over {args.chip}'s f_max")
        source_name = getattr(transport, "tpa_source", None)
        if source_name is not None:
            print(f"tensor activity from NVML: {source_name}"
                  + (" (GPU utilization, NOT tensor-pipe activity)"
                     if source_name == "utilization" else ""))
        print(f"serving on {server.url}  "
              f"({server.url}/v1/fleet, {server.url}/dashboard)")
        try:
            if args.rounds is not None or np.isfinite(duration):
                daemon.run(n_rounds=args.rounds)
            else:
                while True:          # live hardware: poll until ctrl-C
                    daemon.run(n_rounds=1)
                    print(_health_line(backends))
        except KeyboardInterrupt:
            print("\nstopping")
    print(_health_line(backends))
    return 0


def self_check(device=None) -> int:
    """The gate: the fake-transport live pipeline over real HTTP must be
    bucketwise-identical to the simulator's chunks replayed from the host
    on the same engine seed, and stay identical under injected transport
    faults; the simulator's grids ingested on `device` (the card when
    None) must fire the same alerts, count what the histogram's plain
    version counts, and keep the bucket means within rtol 1e-5."""
    from repro_torch.telemetry.source import SimulatorSource

    device = resolve_device(device)
    n_dev, interval, duration, round_s, seed = 4, 30.0, 3600.0, 300.0, 7
    events = [Event(1800, 3600, slowdown=2.5)]
    config = CollectorConfig(round_s=round_s, bucket_s=round_s, retain=12,
                             detector={"window": 3, "min_duration": 1})

    def run_pipeline(source, job_id):
        """One daemon + HTTP server over `source`; returns the fleet
        series, the job's bucket series and the alerts as served, and
        the collector."""
        clk = SimClock()
        col = Collector([JobStream(job_id, source)], config)
        daemon = ServiceDaemon(col, clock=clk.monotonic, sleep=clk.sleep)
        with daemon, FleetAPIServer(daemon.store) as server:
            daemon.run()
            client = FleetClient(server.url)
            return (client.fleet(), client.job(job_id), client.alerts(),
                    col)

    def live_source(fail_every=None):
        transport = FakeDcgmTransport(
            DEMO_PROFILE, duration_s=duration, interval_s=interval,
            n_devices=n_dev, chunk_s=round_s, events=events, seed=seed,
            fail_every=fail_every, device=device)
        backends = make_dcgm_backends(transport, n_dev,
                                      sleep=lambda s: None)
        return backends, BackendSource(backends=backends,
                                       duration_s=duration,
                                       interval_s=interval)

    def sim():
        return SimulatorSource(profile=DEMO_PROFILE, duration_s=duration,
                               interval_s=interval, n_devices=n_dev,
                               seed=seed, events=events, device=device)

    # live: FakeDcgmTransport -> DcgmFieldBackend -> BackendSource
    backends, src = live_source()
    live_fleet, live_job, live_alerts, _ = run_pipeline(src, "live")
    assert all(b.healthy for b in backends)
    assert sum(b.polls for b in backends) == n_dev * duration / interval

    # reference: the pure simulator on the same seed + chunk cadence, its
    # chunks copied to the host
    sim_fleet, sim_job, sim_alerts, host_col = run_pipeline(
        DeviceSource(sim(), None), "live")

    # bucketwise identity, as served over HTTP
    assert live_fleet["t_s"] == sim_fleet["t_s"], "bucket grid differs"
    for key in ("mean", "p10", "p90"):
        if key in live_fleet and key in sim_fleet:
            assert live_fleet[key] == sim_fleet[key], \
                f"fleet {key} differs between live and sim"
    assert live_job == sim_job, "job bucket series differ"
    n_buckets = len(live_fleet["t_s"])
    assert n_buckets == duration / round_s, n_buckets

    # the injected regression is visible through the live path
    assert any(a["kind"] == "regression"
               for a in live_alerts["alerts"]), live_alerts

    # fault injection: reconnect-with-backoff must be sample-transparent
    flaky_backends, flaky_src = live_source(fail_every=97)
    flaky_fleet, flaky_job, _, _ = run_pipeline(flaky_src, "live")
    retries = sum(b.retries for b in flaky_backends)
    assert retries > 0, "fault injection never fired"
    assert flaky_fleet == live_fleet and flaky_job == live_job, \
        "retries changed served samples"
    assert all(b.healthy for b in flaky_backends)

    # the simulator's grids ingested on the device (the histogram kernel
    # on a card) against its plain version on CPU copies of them
    _, dev_job, dev_alerts, dev_col = run_pipeline(sim(), "live")
    _, _, _, plain_col = run_pipeline(DeviceSource(sim(), "cpu"), "live")
    kinds = sorted((a["kind"], a["job_id"]) for a in dev_alerts["alerts"])
    assert kinds == sorted((a["kind"], a["job_id"])
                           for a in sim_alerts["alerts"]), dev_alerts
    assert dev_job["t_s"] == sim_job["t_s"], "device bucket grid differs"
    for key in plain_col.rollup._hists:
        assert np.array_equal(dev_col.rollup._hists[key],
                              plain_col.rollup._hists[key]), \
            f"{key}: the device's counts differ from the plain version's"
    m_dev = np.asarray(dev_job["mean"], float)
    m_host = np.asarray(sim_job["mean"], float)
    assert np.allclose(m_dev, m_host, rtol=1e-5, atol=0.0, equal_nan=True), \
        "device bucket means beyond rtol 1e-5 of the host path's"

    print(f"SELF-CHECK OK: live fake-DCGM pipeline == simulator over "
          f"{n_buckets} HTTP-served buckets (bit-identical), regression "
          f"alert visible, {retries} injected faults recovered "
          f"transparently; ingest on {device}: same alerts, counts equal "
          f"the plain version's, means within rtol 1e-5")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--transport", default="fake",
                    choices=["fake", "dcgmi", "pynvml"],
                    help="acquisition transport (default %(default)s)")
    ap.add_argument("--devices", type=int, default=0,
                    help="device count (0 = discover from transport; "
                    "fake transport defaults to 4)")
    ap.add_argument("--interval-s", type=float, default=10.0,
                    help="scrape interval (§IV-C caps at 30s)")
    ap.add_argument("--round-s", type=float, default=300.0)
    ap.add_argument("--bucket-s", type=float, default=300.0)
    ap.add_argument("--retain", type=int, default=24)
    ap.add_argument("--duration-s", type=float, default=3600.0,
                    help="fake-transport run length (real transports "
                    "poll until ctrl-C or --rounds)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="stop after N rounds")
    ap.add_argument("--regression", type=float, default=2.5,
                    help="fake mode: slowdown injected at half-run "
                    "(1.0 disables)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--job-id", default="live")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (printed at startup)")
    ap.add_argument("--replay-fast", action="store_true",
                    help="simulated clock: no sleeping between rounds "
                    "(fake transport only)")
    ap.add_argument("--degraded", action="store_true",
                    help="allow >30s intervals with a warning instead "
                    "of refusing (§IV-C strict=False)")
    ap.add_argument("--chip", default=DEFAULT_CHIP.name, choices=sorted(CHIPS),
                    help="the monitored devices' chip, whose f_max OFU "
                    "divides by (default %(default)s)")
    ap.add_argument("--device", default=None,
                    help="torch device of the ingest and the fake "
                    "transport's simulation; the card when omitted")
    ap.add_argument("--self-check", action="store_true",
                    help="prove live == sim bucketwise over HTTP and "
                    "exit (the gate)")
    args = ap.parse_args(argv)
    if args.self_check:
        return self_check(args.device)
    if args.transport == "fake" and not args.devices:
        args.devices = 4
    return serve(args)


if __name__ == "__main__":
    sys.exit(main())
