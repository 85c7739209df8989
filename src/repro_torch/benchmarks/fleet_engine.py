"""Fleet-engine throughput on the port: vectorized vs per-device scalar
simulation, and one padded multi-job grid vs the per-job engine loop.

Metric is simulated device-seconds per wall-second — how much fleet
telemetry one device (the card unless `device` names another) can
synthesize in real time.  The scalar reference is host NumPy timed on a
small slice (it is the thing being replaced); the torch engine is then
timed head-to-head on the same slice AND at the paper's operating point
(1,000 devices x 1 hour at 30 s scrapes).  The sweep case runs a
600-job / ~10k-device fleet both ways: a `simulate_job` loop against one
`simulate_fleet` call (one padded grid a group).  `run_torch` times the
engine at 100,000 devices x 1 h against the same engine on the host CPU,
and the three rollup-ingest routes over its grid.  The collector case
measures the continuous-monitoring loop's per-round overhead (scrape ->
windowed ingest -> regression/divergence detect) for a 64-job fleet.
The ingest case drives the horizontal write path (delta blobs ->
sharded aggregator -> k-way reduce) at 10k-host scale against the npz
pairwise baseline.  Trace store, codecs, serve and ingest tier are host
work.

Row names are the JAX package's, so the two suites' CSVs line up: the
`jax_*` rows time the torch engine and its ingest routes ("pallas" is
the hand-written histogram kernel, "xla" its plain PyTorch version).

Every case emits a BENCH json line for the driver AND lands in
`BENCH_fleet.json` (path overridable via the env var of the same name):
a machine-readable per-case {name, median, units, metrics} table next to
the human CSV rows.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.benchmarks.common import (Row, bench_case, host,
                                           merge_bench_json, sync, timed)

_CASES: list[dict] = []


def _bench(name: str, median: float, units: str, **metrics) -> None:
    """Record one benchmark case (BENCH line + structured row for
    `BENCH_fleet.json` — shared plumbing in benchmarks.common)."""
    bench_case(_CASES, name, median, units, **metrics)


def _write_json() -> str:
    return merge_bench_json(_CASES)


from repro_torch.fleet.collector import Collector, CollectorConfig, JobStream
from repro_torch.fleet.engine import simulate_devices
from repro_torch.fleet.jobs import JobSpec, simulate_fleet, simulate_job
from repro_torch.fleet.streaming import StreamingRollup
from repro_torch.telemetry.counters import (Event, SimulatedDeviceBackend,
                                      StepProfile)
from repro_torch.telemetry.scrape import DeviceGrid, scrape
from repro_torch.telemetry.source import SimulatorSource

PROFILE = StepProfile(mxu_time_s=0.84, step_time_s=2.0)
EVENTS = [Event(start_s=600, end_s=1200, slowdown=2.5)]
INTERVAL_S = 30.0


def _sweep_specs(n_jobs: int = 600, max_devices: int = 17):
    """The §V-B-scale sweep: 600 jobs, ~10k sampled devices, ragged
    durations, a few evented/straggling jobs."""
    return [JobSpec(f"sweep-{i}", "granite-3-2b", chips=max_devices,
                    true_duty=0.2 + 0.03 * (i % 8),
                    duration_s=600.0 + 150.0 * (i % 4),
                    scrape_interval_s=INTERVAL_S, seed=i,
                    events=[Event(300, 600, slowdown=2.5)] if i % 50 == 0
                    else (),
                    straggler_sigma=0.15 if i % 25 == 0 else 0.0)
            for i in range(n_jobs)]


def _scalar(n_dev: int, duration_s: float) -> None:
    rng = np.random.default_rng(0)
    for _ in range(n_dev):
        be = SimulatedDeviceBackend(PROFILE, events=EVENTS,
                                    seed=int(rng.integers(0, 2 ** 31)))
        scrape(be, duration_s, INTERVAL_S)


def _vector(n_dev: int, duration_s: float, device) -> None:
    simulate_devices(PROFILE, duration_s=duration_s, interval_s=INTERVAL_S,
                     events=EVENTS, n_devices=n_dev, seed=0, device=device)
    sync(device)


def run_torch(rows: list[Row] | None = None, device=None) -> list[Row]:
    """torch engine + device-side rollup ingest.

    Defaults to 100k devices x 1 hour of 30 s scrapes; the paper-scale
    1M x 24 h point is the same code one env knob away
    (FLEET_TORCH_DEVICES=1000000 FLEET_TORCH_HOURS=24, ~11 GB per f32
    grid).  Reports the torch engine on `device` head-to-head with the
    same engine on the host CPU at the SAME operating point, plus all
    three rollup-ingest routes over the device grid: the histogram kernel
    (`ofu_bucket_hist`; on a CPU device it runs its plain version), its
    plain version `bucket_hist_torch` on the same tensors, and host NumPy
    through `add_grid` on a host copy of the grid.
    """
    from repro_torch.fleet.engine import JobSlot
    from repro_torch.fleet.engine_torch import simulate_jobs_torch
    from repro_torch.kernels.fleet_hist import (bucket_hist_torch,
                                                ofu_bucket_hist)

    rows = [] if rows is None else rows
    device = resolve_device(device)
    n_dev = int(os.environ.get("FLEET_TORCH_DEVICES", "100000"))
    hours = float(os.environ.get("FLEET_TORCH_HOURS", "1"))
    dur = hours * 3600.0
    devsec = n_dev * dur
    repeat = 1 if n_dev >= 50_000 else 3
    slot = JobSlot(PROFILE, dur, INTERVAL_S, events=EVENTS,
                   stragglers=np.ones(n_dev))

    def _sim(dev):
        (g,) = simulate_jobs_torch([slot], seed=0, device=dev)
        sync(dev)
        return g

    g = _sim(device)                        # warm-up off the clock
    g, us_torch = timed(_sim, device, repeat=repeat)
    _, us_cpu = timed(_sim, "cpu", repeat=repeat)
    thr_torch = devsec / (us_torch / 1e6)
    label = f"fleet_engine.jax_{n_dev}dev_{hours:g}h"
    rows.append(Row(label, us_torch,
                    f"device_seconds_per_wall_s={thr_torch:.0f} "
                    f"cpu_wall_s={us_cpu / 1e6:.2f}"))

    # rollup ingest over the device grid: kernel vs plain vs host NumPy.
    # The kernel and its plain version get identical inputs (same grid,
    # same aligned bucket map the StreamingRollup routing would derive).
    bucket_s = 300.0
    S = int(g.tpa.shape[1])
    n_cells = n_dev * S
    spb = max(int(round(bucket_s / INTERVAL_S)), 1)
    col = np.arange(S) // spb
    roll = StreamingRollup(bucket_s=bucket_s)
    kw = dict(inv_fmax=1.0 / slot.chip.f_max_mhz, edges=roll.edges,
              col_bucket=col, n_buckets=int(col[-1]) + 1 if S else 0)

    def _ingest(fn):
        out = fn(g.tpa, g.clock_mhz, **kw)
        sync(device)
        return out

    _ingest(ofu_bucket_hist), _ingest(bucket_hist_torch)   # warm-up
    (h_kernel, _), us_kernel = timed(_ingest, ofu_bucket_hist, repeat=repeat)
    (h_plain, _), us_plain = timed(_ingest, bucket_hist_torch,
                                   repeat=repeat)
    gh = DeviceGrid(g.interval_s, host(g.tpa), host(g.clock_mhz))

    def _dev_ingest():                      # full add_grid device route
        r = StreamingRollup(bucket_s=bucket_s)
        r.add_grid("j", g, chips=n_dev)
        sync(device)
        return r

    def _host_ingest():                     # host NumPy baseline
        r = StreamingRollup(bucket_s=bucket_s)
        r.add_grid("j", gh, chips=n_dev)
        return r

    r_dev, us_dev = timed(_dev_ingest, repeat=repeat)
    r_host, us_host = timed(_host_ingest, repeat=repeat)
    route = "cuda" if device.type == "cuda" else "plain"
    rows.append(Row("fleet_engine.jax_ingest_pallas", us_kernel,
                    f"samples_per_s={n_cells / (us_kernel / 1e6):.0f} "
                    f"route={route}"))
    rows.append(Row("fleet_engine.jax_ingest_xla", us_plain,
                    f"samples_per_s={n_cells / (us_plain / 1e6):.0f}"))
    rows.append(Row("fleet_engine.jax_ingest_host_numpy", us_host,
                    f"samples_per_s={n_cells / (us_host / 1e6):.0f}"))

    # cross-route sanity on the spot the driver reads: the kernel's counts
    # equal its plain version's bitwise, and the routes agree on the OFU
    assert np.array_equal(host(h_kernel), host(h_plain))
    ofu_dev = float(r_dev.fleet_stats(qs=()).mean[0])
    ofu_host = float(r_host.fleet_stats(qs=()).mean[0])

    _bench(
        "fleet_engine_torch", round(thr_torch), "device_seconds_per_wall_s",
        devices=n_dev,
        hours=hours,
        torch_wall_s=round(us_torch / 1e6, 3),
        cpu_wall_s=round(us_cpu / 1e6, 3),
        torch_devsec_per_s=round(thr_torch),
        route=route,
        ingest_kernel_samples_per_s=round(n_cells / (us_kernel / 1e6)),
        ingest_plain_samples_per_s=round(n_cells / (us_plain / 1e6)),
        ingest_numpy_samples_per_s=round(n_cells / (us_host / 1e6)),
        ingest_device_route_wall_s=round(us_dev / 1e6, 3),
        kernel_counts_equal_plain=True,
        first_bucket_ofu_torch=round(ofu_dev, 4),
        first_bucket_ofu_numpy=round(ofu_host, 4),
    )
    return rows


def run_ingest(rows: list[Row] | None = None) -> list[Row]:
    """Ingest tier at fleet scale (ISSUE 7): 10k hosts / 1M devices of
    delta traffic through the sharded aggregator.

    Each host pre-bins ~100 devices into an 8-bucket rollup and ships
    two rounds of `delta_bytes()` blobs (round 2 is a true delta: only
    the new bucket rows), plus a slice of duplicate redeliveries — the
    at-least-once pattern.  Reported: ingest MB/s and blobs/s through
    `IngestAggregator.submit`, k-way merges/s for the two-level
    `fleet_rollup` reduce, and p99 dashboard read latency while ingest
    and publishes keep running.  The decode+merge HEAD-TO-HEAD (npz
    pairwise `from_bytes`+`merge` fold vs v2 submit + `merge_many`
    reduce) runs on a subset (`FLEET_INGEST_NPZ_HOSTS`, default 1024) —
    the npz path at 10k hosts would dominate the suite's wall clock —
    and both sides are per-host rates, so the speedup transfers.
    Correctness is checked against single-process ingestion of the
    same observations (bucketwise identical).
    """
    from repro_torch.serve import (FleetAPIServer, FleetClient, FleetStore,
                             IngestAggregator)

    rows = [] if rows is None else rows
    n_hosts = int(os.environ.get("FLEET_INGEST_HOSTS", "10000"))
    npz_hosts = min(int(os.environ.get("FLEET_INGEST_NPZ_HOSTS", "1024")),
                    n_hosts)
    dev_per_host = 100
    bins, n_buckets, bucket_s = 64, 8, 300.0
    half = n_buckets // 2
    rng = np.random.default_rng(7)

    # -- synthesize two rounds of per-host delta traffic ------------------
    # and fold the SAME observations into one single-process reference
    reference = StreamingRollup(bucket_s, bins=bins)
    deltas1, deltas2 = [], []
    sample_hosts = []                   # kept live for the head-to-head
    for i in range(n_hosts):
        roll = StreamingRollup(bucket_s, bins=bins)
        job, grp = f"job-{i % 97}", ("bf16" if i % 2 else "fp8")
        h1 = rng.poisson(3.0, (half, bins)).astype(float)
        s1 = h1.sum(axis=1) * rng.uniform(0.2, 0.6)
        roll.observe_hist(job, h1, s1, group=grp, weight=dev_per_host)
        reference.observe_hist(job, h1, s1, group=grp,
                               weight=dev_per_host)
        deltas1.append(roll.delta_bytes(0))
        acked = roll.generation
        h2 = rng.poisson(3.0, (n_buckets - half, bins)).astype(float)
        s2 = h2.sum(axis=1) * rng.uniform(0.2, 0.6)
        roll.observe_hist(job, h2, s2, b0=half, group=grp,
                          weight=dev_per_host)
        reference.observe_hist(job, h2, s2, b0=half, group=grp,
                               weight=dev_per_host)
        deltas2.append(roll.delta_bytes(acked))
        if i < npz_hosts:
            sample_hosts.append(roll)

    # -- decode+merge head-to-head: npz pairwise vs v2 submit+reduce ------
    blobs_npz = [h.to_bytes() for h in sample_hosts]
    blobs_v2 = [h.to_bytes_v2() for h in sample_hosts]

    def _npz_pairwise():
        acc = StreamingRollup(bucket_s, bins=bins)
        for b in blobs_npz:
            acc.merge(StreamingRollup.from_bytes(b))
        return acc

    def _v2_submit():
        agg = IngestAggregator(n_shards=4)
        for i, b in enumerate(blobs_v2):
            agg.submit(f"h{i}", b)
        return agg.fleet_rollup()

    acc_npz, us_npz = timed(_npz_pairwise, repeat=3)
    acc_v2, us_v2 = timed(_v2_submit, repeat=3)
    speedup = us_npz / us_v2
    npz_rate = npz_hosts / (us_npz / 1e6)
    v2_rate = npz_hosts / (us_v2 / 1e6)
    identical = all(
        np.allclose(acc_npz._hists[s], acc_v2._hists[s],
                    rtol=1e-9, atol=1e-12)
        and np.allclose(acc_npz._sums[s], acc_v2._sums[s],
                        rtol=1e-9, atol=1e-12)
        for s in acc_npz._hists)
    rows.append(Row(f"fleet_engine.ingest_npz_pairwise_{npz_hosts}host",
                    us_npz, f"hosts_per_s={npz_rate:.0f}"))
    rows.append(Row(f"fleet_engine.ingest_v2_submit_{npz_hosts}host",
                    us_v2, f"hosts_per_s={v2_rate:.0f} "
                    f"speedup={speedup:.1f}x identical={int(identical)}"))

    # -- full-scale ingest: all hosts, both rounds, a duplicate slice -----
    agg = IngestAggregator(n_shards=8, max_queue=64)
    n_blobs = ingest_bytes = 0
    t0 = time.perf_counter()
    for round_blobs in (deltas1, deltas2):
        for i, b in enumerate(round_blobs):
            agg.submit(f"host-{i}", b)
            n_blobs += 1
            ingest_bytes += len(b)
    for i in range(0, n_hosts, 37):     # at-least-once redelivery
        agg.submit(f"host-{i}", deltas2[i])
        n_blobs += 1
        ingest_bytes += len(deltas2[i])
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet = agg.fleet_rollup()
    reduce_s = time.perf_counter() - t0
    mb_per_s = ingest_bytes / 1e6 / ingest_s
    blobs_per_s = n_blobs / ingest_s
    merges_per_s = n_hosts / reduce_s
    fleet_identical = (
        set(fleet._hists) == set(reference._hists) and all(
            np.allclose(fleet._hists[s], reference._hists[s],
                        rtol=1e-9, atol=1e-12)
            and np.allclose(fleet._sums[s], reference._sums[s],
                            rtol=1e-9, atol=1e-12)
            for s in reference._hists))
    stats = agg.stats()
    rows.append(Row(f"fleet_engine.ingest_submit_{n_hosts}host",
                    ingest_s * 1e6 / n_blobs,
                    f"mb_per_s={mb_per_s:.1f} "
                    f"blobs_per_s={blobs_per_s:.0f} "
                    f"duplicates={stats['duplicates']}"))
    rows.append(Row(f"fleet_engine.ingest_reduce_{n_hosts}host",
                    reduce_s * 1e6,
                    f"merges_per_s={merges_per_s:.0f} "
                    f"identical={int(fleet_identical)}"))

    # -- p99 dashboard read latency under live ingest ---------------------
    store = FleetStore()
    agg.publish(store, clock_s=0.0)
    lat: list[float] = []
    stop = threading.Event()
    with FleetAPIServer(store, aggregator=agg) as server:
        def _reader():
            client = FleetClient(server.url, timeout_s=10.0)
            while not stop.is_set():
                t = time.perf_counter()
                client.fleet()
                lat.append(time.perf_counter() - t)

        readers = [threading.Thread(target=_reader, daemon=True)
                   for _ in range(4)]
        for th in readers:
            th.start()
        t_end = time.perf_counter() + 2.0
        i = writer_blobs = 0
        while time.perf_counter() < t_end:
            agg.submit(f"host-{i % n_hosts}", deltas2[i % n_hosts])
            i += 1
            writer_blobs += 1
            if i % 2000 == 0:           # fresh generation mid-read-storm
                agg.publish(store, clock_s=float(i))
        stop.set()
        for th in readers:
            th.join(timeout=10)
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    p99_ms = float(lat_ms[int(0.99 * (lat_ms.size - 1))])
    p50_ms = float(lat_ms[lat_ms.size // 2])
    rows.append(Row(f"fleet_engine.ingest_read_p99_{n_hosts}host",
                    p99_ms * 1e3,
                    f"p50_ms={p50_ms:.2f} p99_ms={p99_ms:.2f} "
                    f"reads={lat_ms.size} "
                    f"concurrent_blobs={writer_blobs}"))

    _bench(
        "ingest_tier", round(mb_per_s, 1), "MB_per_s",
        hosts=n_hosts,
        devices=n_hosts * dev_per_host,
        blobs=n_blobs,
        ingest_mb_per_s=round(mb_per_s, 1),
        blobs_per_s=round(blobs_per_s),
        merges_per_s=round(merges_per_s),
        reduce_wall_s=round(reduce_s, 3),
        decode_merge_speedup_x=round(speedup, 1),
        npz_hosts_per_s=round(npz_rate),
        v2_hosts_per_s=round(v2_rate),
        duplicates=stats["duplicates"],
        bucketwise_identical=bool(identical and fleet_identical),
        p99_read_ms=round(p99_ms, 2),
        p50_read_ms=round(p50_ms, 2),
        concurrent_reads=int(lat_ms.size),
    )
    return rows


def run(device=None) -> list[Row]:
    device = resolve_device(device)
    _CASES.clear()
    rows = []
    # -- head-to-head on the same slice (16 devices x 30 min) -------------
    n_dev, dur = 16, 1800.0
    devsec = n_dev * dur
    _, us_scalar = timed(_scalar, n_dev, dur, repeat=2)
    _vector(n_dev, dur, device)               # warm-up off the clock
    _, us_vector = timed(_vector, n_dev, dur, device, repeat=3)
    thr_scalar = devsec / (us_scalar / 1e6)
    thr_vector = devsec / (us_vector / 1e6)
    speedup = us_scalar / us_vector
    rows.append(Row("fleet_engine.scalar_16dev_30min", us_scalar,
                    f"device_seconds_per_wall_s={thr_scalar:.0f}"))
    rows.append(Row("fleet_engine.vector_16dev_30min", us_vector,
                    f"device_seconds_per_wall_s={thr_vector:.0f} "
                    f"speedup={speedup:.1f}x"))

    # -- the acceptance operating point: 1000 devices x 1 hour ------------
    spec = JobSpec("bench-fleet", "granite-3-2b", chips=1000,
                   true_duty=0.35, duration_s=3600.0,
                   scrape_interval_s=INTERVAL_S, seed=0)
    t0 = time.perf_counter()
    (tel,) = simulate_fleet([spec], max_devices=1000, device=device)
    roll = StreamingRollup(bucket_s=300)
    roll.add_job(tel)
    sync(device)
    wall_s = time.perf_counter() - t0
    devsec_full = 1000 * 3600.0
    thr_full = devsec_full / wall_s
    rows.append(Row("fleet_engine.vector_1000dev_1h_rollup", wall_s * 1e6,
                    f"device_seconds_per_wall_s={thr_full:.0f} "
                    f"wall_s={wall_s:.2f} ofu={tel.ofu * 100:.1f}% "
                    f"buckets={roll.n_buckets}"))

    _bench(
        "fleet_engine", round(thr_full), "device_seconds_per_wall_s",
        scalar_devsec_per_s=round(thr_scalar),
        vector_devsec_per_s=round(thr_vector),
        speedup_x=round(speedup, 1),
        fleet_1000dev_1h_wall_s=round(wall_s, 3),
        fleet_devsec_per_s=round(thr_full),
    )

    # -- one padded multi-job grid: 600 jobs / ~10k devices --------------
    # a `simulate_job` loop vs one `simulate_fleet` call, both the torch
    # engine; interleaved (per-job, fused) pairs + median pair ratio, so
    # machine load drift hits both sides of the comparison equally
    max_dev = 17
    specs = _sweep_specs(600, max_dev)
    devsec_sweep = sum(min(s.chips, max_dev) * s.duration_s for s in specs)
    tels = simulate_fleet(specs, max_devices=max_dev,
                          device=device)                     # warm caches
    pairs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for spec in specs:
            simulate_job(spec, max_devices=max_dev, device=device)
        sync(device)
        t1 = time.perf_counter()
        simulate_fleet(specs, max_devices=max_dev, device=device)
        sync(device)
        pairs.append((t1 - t0, time.perf_counter() - t1))
    us_perjob = min(p[0] for p in pairs) * 1e6
    us_fused = min(p[1] for p in pairs) * 1e6
    ratios = sorted(pj / f for pj, f in pairs)
    fused_speedup = ratios[len(ratios) // 2]
    thr_fused = devsec_sweep / (us_fused / 1e6)
    n_dev_total = sum(t.grid.n_devices for t in tels)
    rows.append(Row("fleet_engine.perjob_600job_sweep", us_perjob,
                    f"device_seconds_per_wall_s="
                    f"{devsec_sweep / (us_perjob / 1e6):.0f}"))
    rows.append(Row("fleet_engine.fused_600job_sweep", us_fused,
                    f"device_seconds_per_wall_s={thr_fused:.0f} "
                    f"speedup={fused_speedup:.1f}x devices={n_dev_total}"))
    _bench(
        "fleet_engine_fused", round(thr_fused),
        "device_seconds_per_wall_s",
        jobs=len(specs),
        devices=n_dev_total,
        perjob_wall_s=round(us_perjob / 1e6, 3),
        fused_wall_s=round(us_fused / 1e6, 3),
        fused_speedup_x=round(fused_speedup, 1),
        fused_devsec_per_s=round(thr_fused),
    )

    run_torch(rows, device)

    # -- collector round overhead: scrape -> windowed ingest -> detect -----
    # 64 monitored jobs x 16 devices, 5-minute rounds at 30 s scrapes: the
    # continuous loop must be a rounding error next to the round period.
    n_jobs, n_dev_c, round_s = 64, 16, 300.0
    n_rounds = 12

    def _collector_run():
        streams = [JobStream(
            f"mon-{i}",
            SimulatorSource(PROFILE, duration_s=n_rounds * round_s,
                            interval_s=INTERVAL_S, n_devices=n_dev_c,
                            seed=i,
                            events=EVENTS if i % 16 == 0 else (),
                            device=device),
            chips=256, group="bf16", app_mfu=0.38)
            for i in range(n_jobs)]
        col = Collector(streams, CollectorConfig(
            round_s=round_s, bucket_s=round_s, retain=8))
        reports = col.run()
        sync(device)
        return reports

    reports, us_total = timed(_collector_run, repeat=3)
    us_round = us_total / n_rounds
    samples_round = sum(r.samples for r in reports) / n_rounds
    devsec_round = n_jobs * n_dev_c * round_s
    thr_col = devsec_round / (us_round / 1e6)
    rows.append(Row("fleet_engine.collector_round_64job", us_round,
                    f"samples_per_round={samples_round:.0f} "
                    f"device_seconds_per_wall_s={thr_col:.0f} "
                    f"alerts={sum(len(r.alerts) for r in reports)}"))
    _bench(
        "fleet_collector", round(us_round / 1e3, 2), "ms_per_round",
        jobs=n_jobs,
        devices=n_jobs * n_dev_c,
        rounds=n_rounds,
        round_ms=round(us_round / 1e3, 2),
        collector_devsec_per_s=round(thr_col),
    )

    # -- trace store: columnar archive vs CSV, chunked replay throughput --
    # One day of a 16-device job at 30 s scrapes, replayed through the
    # rollup two ways: materialize-everything CSV vs O(chunk) streaming
    # over the columnar archive (hour-long polls crossing chunk bounds).
    import tempfile

    from repro_torch.telemetry.source import TraceReplaySource, read_trace, \
        write_trace
    from repro_torch.telemetry.tracestore import archive_nbytes

    n_dev_t, day_s = 16, 86400.0
    grid = simulate_devices(PROFILE, duration_s=day_s,
                            interval_s=INTERVAL_S, events=EVENTS,
                            n_devices=n_dev_t, seed=3, device=device)
    # a recorder writes host arrays: copy the day off the device once
    grid = DeviceGrid(grid.interval_s, host(grid.tpa), host(grid.clock_mhz))
    n_cells = grid.tpa.size
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "day.csv")
        ctr_path = os.path.join(tmp, "day.ctr")
        write_trace(grid, csv_path)
        write_trace(grid, ctr_path, chunk_samples=512)
        csv_b, ctr_b = os.path.getsize(csv_path), archive_nbytes(ctr_path)

        def _csv_replay():
            roll = StreamingRollup(bucket_s=1800.0)
            roll.add_grid("day", read_trace(csv_path))
            return roll

        def _chunked_replay():
            roll = StreamingRollup(bucket_s=1800.0)
            src = TraceReplaySource(ctr_path)
            while not src.exhausted:
                g = src.poll(3600.0)
                if g.tpa.size:
                    roll.add_grid("day", g)
            return src.reader, roll

        _, us_csv = timed(_csv_replay, repeat=3)
        (reader, _), us_chunk = timed(_chunked_replay, repeat=3)
    compression = csv_b / ctr_b
    thr_csv = n_cells / (us_csv / 1e6)
    thr_chunk = n_cells / (us_chunk / 1e6)
    resident_frac = reader.peak_resident_samples / n_cells
    rows.append(Row("fleet_engine.trace_replay_csv_1day", us_csv,
                    f"samples_per_s={thr_csv:.0f} bytes={csv_b}"))
    rows.append(Row("fleet_engine.trace_replay_chunked_1day", us_chunk,
                    f"samples_per_s={thr_chunk:.0f} bytes={ctr_b} "
                    f"compression={compression:.1f}x "
                    f"peak_resident_frac={resident_frac:.3f}"))
    _bench(
        "trace_store", round(thr_chunk), "samples_per_s",
        devices=n_dev_t,
        samples=n_cells,
        csv_bytes=csv_b,
        columnar_bytes=ctr_b,
        compression_x=round(compression, 1),
        csv_replay_samples_per_s=round(thr_csv),
        chunked_replay_samples_per_s=round(thr_chunk),
        peak_resident_frac=round(resident_frac, 4),
    )

    # -- codecs: ctr-v2 container compression + decode throughput ---------
    # The always-on-recording question: what does a day of live counters
    # cost on disk?  The fixture is DCGM-WIRE precision (activity at 3
    # decimals, clock in whole MHz — what dcgmi/NVML actually deliver,
    # via `quantize_wire`), because that is what a live recorder stores;
    # full-precision f32 noise has a much higher entropy floor.  The
    # acceptance bar is >= 15x smaller than CSV for the dbz codec.
    from repro_torch.telemetry.backends.fake import quantize_wire
    from repro_torch.telemetry.tracestore import read_archive, write_archive

    q_tpa, q_clk = quantize_wire(grid.tpa, grid.clock_mhz)
    wire = DeviceGrid(INTERVAL_S, q_tpa.astype(np.float32),
               q_clk.astype(np.float32))
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "wire.csv")
        write_trace(wire, csv_path)
        csv_wire_b = os.path.getsize(csv_path)
        sizes, decode_thr = {}, {}
        for tag, path, kw in (
                ("v1_npz", os.path.join(tmp, "wire.ctr"), {}),
                ("v2_raw", os.path.join(tmp, "raw.ctr2"),
                 {"codec": "raw"}),
                ("v2_dbz", os.path.join(tmp, "dbz.ctr2"),
                 {"codec": "dbz"})):
            write_trace(wire, path, chunk_samples=512, **kw)
            sizes[tag] = archive_nbytes(path)
            back, us_dec = timed(lambda p=path: read_archive(p), repeat=3)
            decode_thr[tag] = n_cells / (us_dec / 1e6)
            assert back.tpa.tobytes() == wire.tpa.tobytes(), tag
    ratio_dbz = csv_wire_b / sizes["v2_dbz"]
    ratio_v1 = csv_wire_b / sizes["v1_npz"]
    assert ratio_dbz >= 15.0, (
        f"dbz compression regressed to {ratio_dbz:.1f}x vs CSV "
        f"(acceptance floor is 15x)")
    rows.append(Row(
        "fleet_engine.trace_codecs_dbz_1day",
        n_cells / decode_thr["v2_dbz"] * 1e6,
        f"compression={ratio_dbz:.1f}x bytes={sizes['v2_dbz']} "
        f"decode_samples_per_s={decode_thr['v2_dbz']:.0f}"))
    _bench(
        "trace_codecs", round(ratio_dbz, 1), "x_vs_csv",
        devices=n_dev_t,
        samples=n_cells,
        csv_bytes=csv_wire_b,
        v1_npz_bytes=sizes["v1_npz"],
        v2_raw_bytes=sizes["v2_raw"],
        v2_dbz_bytes=sizes["v2_dbz"],
        v1_compression_x=round(ratio_v1, 1),
        dbz_compression_x=round(ratio_dbz, 1),
        dbz_decode_samples_per_s=round(decode_thr["v2_dbz"]),
        raw_decode_samples_per_s=round(decode_thr["v2_raw"]),
        v1_decode_samples_per_s=round(decode_thr["v1_npz"]),
    )

    # -- serving layer: store query latency + HTTP requests/s -------------
    # The 64-job fixture from the collector case, published into a
    # FleetStore and interrogated the way a dashboard fleet does: a COLD
    # pass (every query computed — a fresh generation just landed) and a
    # WARM pass (the common case: pollers repeating queries between
    # rounds, answered from the generation cache), plus real HTTP
    # round-trips through the stdlib server (mostly ETag 304s).
    from repro_torch.serve.client import FleetClient
    from repro_torch.serve.http import FleetAPIServer
    from repro_torch.serve.store import FleetStore

    streams = [JobStream(
        f"mon-{i}",
        SimulatorSource(PROFILE, duration_s=n_rounds * round_s,
                        interval_s=INTERVAL_S, n_devices=n_dev_c, seed=i,
                        events=EVENTS if i % 16 == 0 else (),
                        device=device),
        chips=256, group="bf16", app_mfu=0.38)
        for i in range(n_jobs)]
    col = Collector(streams, CollectorConfig(
        round_s=round_s, bucket_s=round_s, retain=8))
    col.run()
    sync(device)
    store = FleetStore()
    store.update_from(col)
    job_ids = sorted(col.rollup.jobs)

    def _query_pass():
        n = 2
        store.fleet_series()
        store.alerts()
        for jid in job_ids:
            store.job_series(jid)
            n += 1
        store.top_regressions(k=5, window=4, min_duration=2)
        store.goodput()
        store.divergence()
        return n + 3

    def _cold_pass():
        store.update_from(col)          # new generation: cache cleared
        return _query_pass()

    n_q, us_cold = timed(_cold_pass, repeat=3)
    _query_pass()                        # prime the generation cache
    reps = 10
    def _warm_passes():
        for _ in range(reps):
            _query_pass()
    _, us_warm_total = timed(_warm_passes, repeat=3)
    us_warm = us_warm_total / reps
    qps_cold = n_q / (us_cold / 1e6)
    qps_warm = n_q / (us_warm / 1e6)
    rows.append(Row("fleet_engine.serve_store_cold_64job", us_cold,
                    f"queries_per_s={qps_cold:.0f} queries={n_q}"))
    rows.append(Row("fleet_engine.serve_store_warm_64job", us_warm,
                    f"queries_per_s={qps_warm:.0f} cached=1"))

    with FleetAPIServer(store) as server:
        client = FleetClient(server.url)
        client.fleet()                   # prime the client ETag cache
        n_http = 100

        def _http_pass():
            for k in range(n_http):
                if k % 4 == 0:
                    client.job(job_ids[k % len(job_ids)])
                else:
                    client.fleet()       # repeat poll -> 304

        _, us_http = timed(_http_pass, repeat=3)
    rps_http = n_http / (us_http / 1e6)
    rows.append(Row("fleet_engine.serve_http_64job", us_http / n_http,
                    f"requests_per_s={rps_http:.0f} "
                    f"hits_304={client.hits_304}"))
    _bench(
        "serve_query", round(rps_http), "requests_per_s",
        jobs=n_jobs,
        store_queries_per_s_cold=round(qps_cold),
        store_queries_per_s=round(qps_warm),
        http_requests_per_s=round(rps_http),
        http_304_frac=round(client.hits_304 / max(client.requests, 1), 3),
    )

    run_ingest(rows)

    path = _write_json()
    print(f"BENCH-JSON {path} cases={len(_CASES)}")
    return rows


if __name__ == "__main__":
    for r in run():
        print(r.csv())
