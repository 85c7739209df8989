"""The port's serving layer (`repro_torch.serve`: store, HTTP API,
daemon) against the JAX package's.

The CPU half of the reference's `test_serve_store.py`,
`test_serve_http.py` and `test_serve_daemon.py`, run on the port
(sources simulate with `device="cpu"`, so the daemon's collector
ingests CPU tensors through the histogram kernel's plain version and its
recording tee copies them to host NumPy), then parity cases on the same
seeded grids: both daemons' HTTP payloads equal apart from the ETag
nonce, tee archives byte-identical, and a state directory the
reference's daemon persisted resumes in the port's as in the
reference's.
"""
import json
import os
import shutil
import threading
import time
from dataclasses import dataclass

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.fleet.collector as R_collector  # noqa: E402
import repro.serve as R_serve  # noqa: E402
import repro.telemetry as R_telemetry  # noqa: E402
import repro_torch.fleet.collector as T_collector  # noqa: E402
import repro_torch.serve as T_serve  # noqa: E402
from repro_torch.fleet.collector import (Alert, Collector,  # noqa: E402
                                         CollectorConfig, JobStream)
from repro_torch.fleet.divergence import analyze_rollup  # noqa: E402
from repro_torch.fleet.engine import simulate_devices as _simulate_devices  # noqa: E402
from repro_torch.fleet.regression import scan_rollup  # noqa: E402
from repro_torch.fleet.streaming import (StreamingRollup,  # noqa: E402
                                         WindowedRollup, weighted_mean)
from repro_torch.serve import (FleetAPIError, FleetAPIServer,  # noqa: E402
                               FleetClient, ServiceDaemon, SimClock)
from repro_torch.serve.store import FleetStore  # noqa: E402
from repro_torch.telemetry import (Event, StepProfile,  # noqa: E402
                                   TraceReplaySource, write_trace)
from repro_torch.telemetry.scrape import DeviceGrid  # noqa: E402
from repro_torch.telemetry.source import GridSource, read_trace  # noqa: E402
from repro_torch.telemetry.source import SimulatorSource as _SimulatorSource  # noqa: E402


@dataclass
class SimulatorSource(_SimulatorSource):
    """The port's source on the CPU (it defaults to the card)."""

    device: object = "cpu"


def simulate_devices(*args, **kw):
    """The port's engine on the CPU, its grid copied to host NumPy (the
    reference tests use it to make data for traces)."""
    kw.setdefault("device", "cpu")
    g = _simulate_devices(*args, **kw)
    return DeviceGrid(g.interval_s, g.tpa.numpy(), g.clock_mhz.numpy(),
                      t0_s=g.t0_s)


# ===========================================================================
# test_serve_store.py: FleetStore coverage: query answers are bucketwise identical
# ===========================================================================
STORE_PROFILE = StepProfile(mxu_time_s=0.84, step_time_s=2.0)


def _store_from_json(xs):
    """Payload list (nulls for NaN) back to an array for comparisons."""
    return np.array([np.nan if x is None else x for x in xs], float)


def _collector(duration_s=3600, with_event=True, app_mfu=0.38):
    streams = [
        JobStream("healthy", SimulatorSource(
            STORE_PROFILE, duration_s=duration_s, interval_s=30, n_devices=4,
            seed=1), chips=64, group="bf16", app_mfu=app_mfu),
        JobStream("regressing", SimulatorSource(
            STORE_PROFILE, duration_s=duration_s, interval_s=30, n_devices=4,
            seed=2, events=[Event(duration_s / 2, duration_s,
                                  slowdown=2.5)] if with_event else ()),
            chips=128, group="fp8"),
    ]
    cfg = CollectorConfig(round_s=300, bucket_s=300, retain=12,
                          detector={"window": 3, "min_duration": 1})
    col = Collector(streams, cfg)
    col.run()
    return col


def test_series_queries_match_direct_rollup_readout():
    col = _collector()
    store = FleetStore()
    store.update_from(col)
    roll = col.rollup

    fleet = store.fleet_series()
    direct = roll.fleet_stats()
    np.testing.assert_array_equal(_store_from_json(fleet["mean"]), direct.mean)
    np.testing.assert_array_equal(_store_from_json(fleet["weight"]),
                                  direct.weight)
    np.testing.assert_allclose(_store_from_json(fleet["t_s"]), direct.centers_s)
    for q in (10, 50, 90):
        np.testing.assert_array_equal(
            _store_from_json(fleet["percentiles"][str(q)]),
            direct.percentiles[q])
    assert fleet["weighted_ofu"] == pytest.approx(weighted_mean(direct))
    assert fleet["window"] == {"bucket0": roll.bucket0,
                               "end_bucket": roll.end_bucket,
                               "retain": roll.retain}
    at = roll.fleet_alltime()
    assert fleet["alltime"]["mean"] == pytest.approx(at["mean"])
    assert fleet["alltime"]["weight"] == pytest.approx(at["weight"])

    for jid in ("healthy", "regressing"):
        job = store.job_series(jid)
        np.testing.assert_array_equal(_store_from_json(job["mean"]),
                                      roll.job_stats(jid).mean)
        assert job["scope"] == "job" and job["id"] == jid
    assert store.job_series("healthy")["meta"]["app_mfu"] == 0.38
    assert store.job_series("regressing")["meta"] is None

    grp = store.group_series("fp8")
    np.testing.assert_array_equal(_store_from_json(grp["mean"]),
                                  roll.group_stats("fp8").mean)


def test_top_regressions_matches_scan_rollup_with_absolute_anchors():
    col = _collector()
    store = FleetStore()
    store.update_from(col)
    worst = store.top_regressions(k=3, window=3, min_duration=1)
    direct = scan_rollup(col.rollup, window=3, min_duration=1)
    assert worst["total"] == sum(len(v) for v in direct.values())
    top = worst["regressions"][0]
    assert top["job_id"] == "regressing"
    r = direct["regressing"][0]
    assert top["factor"] == pytest.approx(r.factor)
    assert top["start_bucket"] == col.rollup.bucket0 + r.start_idx
    assert top["ongoing"] == (r.end_idx is None)
    # ranked hardest-first
    factors = [d["factor"] for d in worst["regressions"]]
    assert factors == sorted(factors, reverse=True)


def test_alerts_and_divergence_queries():
    col = _collector()
    store = FleetStore()
    store.update_from(col)
    al = store.alerts()
    assert al["total"] == len(col.alerts)
    assert [(a["job_id"], a["kind"]) for a in al["alerts"]] \
        == [(a.job_id, a.kind) for a in col.alerts]
    assert al["active_episodes"] == [list(k) for k in col.deduper.active]
    assert store.alerts(limit=1)["alerts"] == al["alerts"][-1:]

    div = store.divergence()
    rep = analyze_rollup(col.rollup, empty_ok=True)
    assert div["r_all"] == pytest.approx(rep.r_all)
    assert [f["job_id"] for f in div["flagged"]] \
        == [p.job_id for p in rep.flagged]


def test_alerts_limit_validated_and_republish_is_incremental():
    col = _collector()
    store = FleetStore()
    store.update_from(col)
    with pytest.raises(ValueError, match="limit=0"):
        store.alerts(limit=0)
    with pytest.raises(ValueError, match="limit=-3"):
        store.alerts(limit=-3)
    # republishing the same append-only alert log reuses the already-
    # converted payload prefix (O(new alerts) per round, not O(all))
    first = store.alerts()["alerts"]
    store.update_from(col)
    second = store.alerts()["alerts"]
    assert len(first) == len(second) > 0
    assert all(a is b for a, b in zip(first, second))


def test_goodput_summary_weights_and_waste_ranking():
    col = _collector()
    store = FleetStore()
    store.update_from(col)
    gp = store.goodput(healthy_ofu=0.40)
    roll = col.rollup
    total_w = sum(roll.job_alltime(j, qs=())["weight"] for j in roll.jobs)
    assert gp["weight"] == pytest.approx(total_w)
    want = sum(roll.job_alltime(j, qs=())["mean"]
               * roll.job_alltime(j, qs=())["weight"]
               for j in roll.jobs) / total_w
    assert gp["weighted_ofu"] == pytest.approx(want)
    # only 'healthy' registered an app MFU
    healthy_w = roll.job_alltime("healthy", qs=())["weight"]
    assert gp["app_mfu_coverage"] == pytest.approx(healthy_w / total_w)
    assert gp["ofu_coverage"] == 1.0
    # the regressed job wastes more of its pool; ranking is waste-desc
    wastes = [j["waste"] for j in gp["jobs"]]
    assert wastes == sorted(wastes, reverse=True)
    assert gp["jobs"][0]["job_id"] == "regressing"


def test_generation_cache_serves_repeats_and_invalidates_on_update():
    col = _collector(duration_s=1200, with_event=False)
    store = FleetStore()
    store.update_from(col)
    g1 = store.generation
    first = store.fleet_series()
    assert store.cache_misses == 1 and store.cache_hits == 0
    assert store.fleet_series() is first        # cached object, not a copy
    assert store.cache_hits == 1
    # different params = different cache key
    store.fleet_series(qs=(50,))
    assert store.cache_misses == 2
    # publish invalidates: same query recomputes at the new generation
    store.update_from(col)
    assert store.generation == g1 + 1
    second = store.fleet_series()
    assert second is not first
    assert second["generation"] == g1 + 1
    assert store.cache_misses == 3


def test_update_copy_isolates_store_from_collector_mutation():
    col = _collector(duration_s=1800, with_event=False)
    store = FleetStore()
    mid = col.rollup.spawn_empty().merge(col.rollup)   # reference answer
    store.update_from(col)
    before = _store_from_json(store.fleet_series()["mean"]).copy()
    # keep collecting: the live rollup moves on, the store must not
    col.streams[0].source.duration_s = 3600           # extend the run
    col.streams[1].source.duration_s = 3600
    col.run()
    np.testing.assert_array_equal(
        _store_from_json(store.fleet_series()["mean"]), before)
    np.testing.assert_array_equal(before, mid.fleet_stats().mean)


def test_empty_store_answers_every_query():
    store = FleetStore()
    assert store.fleet_series()["t_s"] == []
    assert store.fleet_series()["weighted_ofu"] is None
    assert store.jobs() == {"jobs": [], "groups": [], "generation": 0,
                            "round_idx": 0, "clock_s": 0.0}
    assert store.top_regressions()["regressions"] == []
    assert store.alerts()["alerts"] == []
    assert store.goodput()["jobs"] == []
    assert store.divergence()["flagged"] == []


def test_unknown_scope_ids_raise_keyerror():
    col = _collector(duration_s=1200, with_event=False)
    store = FleetStore()
    store.update_from(col)
    with pytest.raises(KeyError, match="nope"):
        store.job_series("nope")
    with pytest.raises(KeyError, match="int8"):
        store.group_series("int8")


def test_payloads_are_strict_json():
    # NaN must never reach the wire: a rollup with gap buckets produces
    # NaN means, and json.dumps(allow_nan=False) proves they were cleaned
    roll = WindowedRollup(bucket_s=60, retain=10)
    t = np.array([30.0, 90.0, 570.0])          # buckets 0, 1, then a gap
    roll.observe("gappy", t, np.array([0.4, 0.5, 0.3]))
    store = FleetStore()
    store.update(roll, round_idx=1, clock_s=600.0)
    for payload in (store.fleet_series(), store.job_series("gappy"),
                    store.jobs(), store.top_regressions(),
                    store.alerts(), store.goodput(), store.divergence()):
        json.dumps(payload, allow_nan=False)
    assert None in store.job_series("gappy")["mean"]   # the gap, as null


def test_update_from_fleet_collector_serves_reduced_state():
    from repro_torch.fleet.collector import FleetCollector

    def host(jid, seed):
        src = SimulatorSource(STORE_PROFILE, duration_s=1800, interval_s=30,
                              n_devices=2, seed=seed)
        return Collector([JobStream(jid, src, chips=32)],
                         CollectorConfig(round_s=300, retain=6))

    fc = FleetCollector([host("a", 1), host("b", 2)], reduce_every=1)
    fc.run()
    store = FleetStore()
    store.update_from(fc)
    assert store.jobs()["jobs"] == ["a", "b"]
    np.testing.assert_array_equal(
        _store_from_json(store.fleet_series()["mean"]),
        fc.fleet.fleet_stats().mean)


def test_plain_rollup_publishes_without_window():
    roll = StreamingRollup(bucket_s=60)
    roll.observe("j", np.arange(1, 601, dtype=float),
                 np.full(600, 0.4))
    store = FleetStore()
    store.update(roll)
    fleet = store.fleet_series()
    assert "window" not in fleet and "alltime" not in fleet
    gp = store.goodput()
    assert gp["jobs"][0]["ofu"] == pytest.approx(0.4)


def test_stats_readout_never_mutates_shared_state():
    """Regression: _stats used to pad lazily-grown scopes by
    reassigning the SHARED per-scope arrays, so a read-only job_stats()
    resized rollup internals — a data race for HTTP readers sharing one
    published snapshot. Reads must pad locally."""
    roll = StreamingRollup(bucket_s=10)
    roll.observe("a", np.array([5.0]), np.array([0.4]), group="bf16")
    roll.observe("b", np.array([95.0]), np.array([0.5]), group="bf16")
    h_a = roll._hists[("job", "a")]
    s_a = roll._sums[("job", "a")]
    st = roll.job_stats("a")                 # short scope: needs padding
    assert len(st.mean) == roll.n_buckets == 10
    assert st.mean[0] == pytest.approx(0.4)
    assert np.isnan(st.mean[1:]).all()
    # ...but the rollup's own arrays were never resized or reassigned
    assert roll._hists[("job", "a")] is h_a and h_a.shape[0] == 1
    assert roll._sums[("job", "a")] is s_a and s_a.shape[0] == 1


def test_concurrent_readout_hammer_on_published_rollup():
    """Many reader threads hammering job/fleet stats on one shared
    rollup (the FleetStore publish model) agree with the single-threaded
    answer and never error — pins the _stats local-pad fix."""
    roll = WindowedRollup(bucket_s=10, retain=50)
    roll.observe("early", np.array([5.0, 15.0]), np.array([0.4, 0.5]),
                 group="bf16")
    for k in range(40):                       # grow well past "early"
        roll.observe("late", np.array([5.0 + 10 * k]), np.array([0.3]),
                     group="bf16")
    ref_job = roll.job_stats("early")
    ref_fleet = roll.fleet_stats()
    errors = []

    def reader():
        try:
            for _ in range(200):
                st = roll.job_stats("early")
                np.testing.assert_array_equal(st.mean, ref_job.mean)
                np.testing.assert_array_equal(st.weight, ref_job.weight)
                np.testing.assert_array_equal(roll.fleet_stats().weight,
                                              ref_fleet.weight)
        except Exception as e:                # noqa: BLE001 — collected
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors
    assert roll._hists[("job", "early")].shape[0] < roll.n_buckets


# ===========================================================================
# test_serve_http.py: HTTP serving layer: a ServiceDaemon over a
# ===========================================================================
HTTP_PROFILE = StepProfile(mxu_time_s=0.84, step_time_s=2.0)
DETECTOR = {"window": 3, "min_duration": 1}


def _http_from_json(xs):
    return np.array([np.nan if x is None else x for x in xs], float)


@pytest.fixture()
def served(tmp_path):
    """A daemon over two golden archives (one regressed, one healthy
    with app MFU), served over HTTP; yields (daemon, server, run())."""
    grids = {
        "regressed": simulate_devices(
            HTTP_PROFILE, duration_s=3600, interval_s=30.0,
            events=[Event(1800, 3600, slowdown=2.5)], n_devices=4,
            seed=21),
        "healthy": simulate_devices(
            HTTP_PROFILE, duration_s=3600, interval_s=30.0, n_devices=4,
            seed=22),
    }
    streams = []
    for name, grid in grids.items():
        path = str(tmp_path / f"{name}.ctr")
        write_trace(grid, path, chunk_samples=40)
        streams.append(JobStream(
            name, TraceReplaySource(path), chips=128, group="bf16",
            app_mfu=0.38 if name == "healthy" else None))
    clk = SimClock()
    daemon = ServiceDaemon(
        Collector(streams, CollectorConfig(round_s=300, bucket_s=300,
                                           retain=12, detector=DETECTOR)),
        clock=clk.monotonic, sleep=clk.sleep)
    server = FleetAPIServer(daemon.store).start()
    try:
        yield daemon, server
    finally:
        server.stop()
        daemon.close()


def test_end_to_end_concurrent_serving_matches_direct_readout(served):
    daemon, server = served
    poll_errors = []
    gen_lists = [[] for _ in range(3)]   # per-thread: appends stay ordered

    def poller(my_gens):
        client = FleetClient(server.url)
        while not done.is_set():
            try:
                my_gens.append(client.fleet()["generation"])
                client.alerts()
            except Exception as e:      # noqa: BLE001 — collected below
                poll_errors.append(e)

    # deterministic interleaving: a round may not advance until every
    # poller has observed the generation it just published — under
    # SimClock pacing costs no wall time, so free-running pollers could
    # otherwise miss the whole run (the PR-6 flake)
    def gate(_report):
        target = daemon.store.generation
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if all(g and g[-1] >= target for g in gen_lists):
                return
            time.sleep(0.001)

    daemon.on_round = gate
    done = threading.Event()
    threads = [threading.Thread(target=poller, args=(g,))
               for g in gen_lists]
    for t in threads:
        t.start()
    reports = daemon.run()
    done.set()
    for t in threads:
        t.join(timeout=10)
    assert not poll_errors
    assert len(reports) == 12
    # every poller watched the generation advance monotonically across
    # the run: the gate pins its first observation to round 1's publish
    # (gen ≤ 2) and its last at or past round 12's (gen 13)
    for g in gen_lists:
        assert g and g[-1] > g[0]
        assert all(b >= a for a, b in zip(g, g[1:]))

    client = FleetClient(server.url)
    roll = daemon.collector.rollup

    # fleet + job series: bucketwise identical to direct readout
    fleet = client.fleet()
    np.testing.assert_array_equal(_http_from_json(fleet["mean"]),
                                  roll.fleet_stats().mean)
    for jid in ("regressed", "healthy"):
        job = client.job(jid)
        direct = roll.job_stats(jid)
        np.testing.assert_array_equal(_http_from_json(job["mean"]), direct.mean)
        np.testing.assert_array_equal(_http_from_json(job["weight"]),
                                      direct.weight)
        for q in (10, 50, 90):
            np.testing.assert_array_equal(
                _http_from_json(job["percentiles"][str(q)]),
                direct.percentiles[q])

    # top-k regressions == scan_rollup, absolute anchors
    worst = client.top_regressions(k=5, **DETECTOR)
    direct_regs = scan_rollup(roll, **DETECTOR)
    assert {d["job_id"] for d in worst["regressions"]} \
        == set(direct_regs) == {"regressed"}
    r = direct_regs["regressed"][0]
    assert worst["regressions"][0]["factor"] == pytest.approx(r.factor)
    assert worst["regressions"][0]["start_bucket"] \
        == roll.bucket0 + r.start_idx

    # alerts match the collector's (one regression episode, fired once)
    alerts = client.alerts()
    assert [(a["job_id"], a["kind"]) for a in alerts["alerts"]] \
        == [(a.job_id, a.kind) for a in daemon.collector.alerts]
    assert ["regressed", "regression"] in alerts["active_episodes"]

    # the cache story: identical repeat queries are 304-served
    h0 = client.hits_304
    again = client.fleet()
    assert client.hits_304 == h0 + 1 and again == fleet
    client.job("healthy")
    assert client.hits_304 == h0 + 2
    # the store never recomputed for the 304s
    misses = daemon.store.cache_misses
    client.fleet()
    client.top_regressions(k=5, **DETECTOR)
    assert daemon.store.cache_misses == misses


def test_etag_rolls_over_when_generation_advances(served):
    daemon, server = served
    client = FleetClient(server.url)
    daemon.run(n_rounds=1)
    first = client.fleet()
    assert client.fleet() == first and client.hits_304 == 1
    daemon.run(n_rounds=1)                   # new generation published
    second = client.fleet()
    assert client.hits_304 == 1              # NOT a 304: fresh answer
    assert second["generation"] > first["generation"]
    assert len(second["t_s"]) >= len(first["t_s"])


def test_http_error_paths(served):
    daemon, server = served
    daemon.run(n_rounds=2)
    client = FleetClient(server.url)
    with pytest.raises(FleetAPIError, match="unknown job") as ei:
        client.job("nope")
    assert ei.value.status == 404
    with pytest.raises(FleetAPIError, match="unknown query kind") as ei:
        client.query("frobnicate")
    assert ei.value.status == 400
    with pytest.raises(FleetAPIError, match="API root") as ei:
        client._get("/v2/fleet")
    assert ei.value.status == 404
    with pytest.raises(FleetAPIError, match="percentiles") as ei:
        client.fleet(qs=(120,))
    assert ei.value.status == 400
    with pytest.raises(FleetAPIError, match="not a int") as ei:
        client.query("top_regressions", k="many")
    assert ei.value.status == 400
    with pytest.raises(FleetAPIError, match="limit=0") as ei:
        client.alerts(limit=0)
    assert ei.value.status == 400
    # non-finite numeric params never reach the store (nan would poison
    # cache keys and leak bare-NaN tokens into strict-JSON bodies)
    for bad in ("nan", "inf", "-inf"):
        with pytest.raises(FleetAPIError, match="finite") as ei:
            client.goodput(healthy_ofu=bad)
        assert ei.value.status == 400
    # group series + explicit qs through /v1/query round the API out
    grp = client.query("series", scope="group", id="bf16", qs="25,75")
    assert set(grp["percentiles"]) == {"25", "75"}


def test_etag_carries_boot_nonce_and_never_validates_invalid_paths(served):
    import urllib.error
    import urllib.request

    daemon, server = served
    daemon.run(n_rounds=1)
    gen = daemon.store.generation

    def get(path, inm=None):
        req = urllib.request.Request(server.url + path)
        if inm:
            req.add_header("If-None-Match", inm)
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.status, resp.headers.get("ETag")
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("ETag")

    status, etag = get("/v1/fleet")
    assert status == 200 and etag == f'"gen-{daemon.store.boot}-{gen}"'
    # a validator from a PREVIOUS server process (same generation count,
    # different boot) must NOT 304 into stale data
    assert get("/v1/fleet", inm=f'"gen-{gen}"')[0] == 200
    assert get("/v1/fleet", inm=f'"gen-deadbeef-{gen}"')[0] == 200
    # the real validator does 304
    assert get("/v1/fleet", inm=etag)[0] == 304
    # ...but never validates an invalid path or param into a 304
    assert get("/v1/nonsense", inm=etag)[0] == 404
    assert get("/v1/fleet?qs=120", inm=etag)[0] == 400


def test_store_cache_is_bounded_under_param_cycling(served):
    daemon, server = served
    daemon.run(n_rounds=1)
    store = daemon.store
    client = FleetClient(server.url)
    for k in range(store.max_cache_entries + 50):
        client.goodput(healthy_ofu=round(0.2 + k * 1e-4, 6))
    assert len(store._cache) <= store.max_cache_entries


def test_jobs_listing_and_divergence_over_http(served):
    daemon, server = served
    daemon.run()
    client = FleetClient(server.url)
    assert client.jobs()["jobs"] == ["healthy", "regressed"]
    assert client.jobs()["groups"] == ["bf16"]
    div = client.divergence()
    assert "r_all" in div or div["flagged"] == []
    gp = client.goodput(healthy_ofu=0.5)
    assert gp["healthy_ofu"] == 0.5
    assert gp["jobs"][0]["job_id"] == "regressed"   # biggest waste pool


def test_dashboard_page_serves_well_formed_html(served):
    import urllib.request

    daemon, server = served
    daemon.run(n_rounds=1)
    for path in ("/dashboard", "/dashboard/"):
        with urllib.request.urlopen(server.url + path,
                                    timeout=10) as resp:
            assert resp.status == 200
            ctype = resp.headers.get("Content-Type", "")
            assert ctype.startswith("text/html")
            body = resp.read().decode()
        assert int(resp.headers["Content-Length"]) == \
            len(body.encode())
    # well-formed enough for a browser: doctype, matched document
    # tags, and the JS actually polls the JSON API it claims to
    assert body.lstrip().startswith("<!DOCTYPE html>")
    for tag in ("html", "head", "body", "script", "svg", "table"):
        assert body.count(f"<{tag}") == body.count(f"</{tag}>"), tag
    assert "/v1/query?kind=series&scope=fleet" in body
    assert "/v1/query?kind=top_regressions" in body
    assert "/v1/alerts" in body
    # the JSON API's path space is untouched by the HTML route
    assert FleetClient(server.url).fleet()["scope"] == "fleet"


# ===========================================================================
# test_serve_daemon.py: ServiceDaemon lifecycle coverage: wall-clock pacing with
# ===========================================================================
DAEMON_PROFILE = StepProfile(mxu_time_s=0.84, step_time_s=2.0)


def _sim_stream(job_id, duration_s=1800, seed=0, **kw):
    return JobStream(job_id, SimulatorSource(
        DAEMON_PROFILE, duration_s=duration_s, interval_s=30, n_devices=2,
        seed=seed), chips=32, group="bf16", **kw)


def _cfg(**kw):
    kw.setdefault("round_s", 300)
    kw.setdefault("bucket_s", 300)
    kw.setdefault("retain", 8)
    kw.setdefault("detector", {"window": 3, "min_duration": 1})
    return CollectorConfig(**kw)


def _archive(tmp_path, name="trace.ctr", duration_s=3600,
             chunk_samples=40, seed=21):
    grid = simulate_devices(DAEMON_PROFILE, duration_s=duration_s,
                            interval_s=30.0,
                            events=[Event(duration_s / 2, duration_s,
                                          slowdown=2.5)],
                            n_devices=4, seed=seed)
    path = str(tmp_path / name)
    write_trace(grid, path, chunk_samples=chunk_samples)
    return path, grid


def _replay_streams(path):
    return [JobStream("traced", TraceReplaySource(path), chips=128,
                      group="bf16", app_mfu=0.38)]


# ---------------------------------------------------------------------------
# Wall-clock pacing
# ---------------------------------------------------------------------------
class _SlowRoundCollector(Collector):
    """Collector whose rounds 'take' fixed wall time on a SimClock."""

    def __init__(self, *args, clk=None, costs=(), **kw):
        super().__init__(*args, **kw)
        self._clk = clk
        self._costs = list(costs)

    def poll_round(self):
        if self._costs:
            self._clk.advance(self._costs.pop(0))
        return super().poll_round()


def test_daemon_sleeps_to_deadline_with_drift_correction():
    clk = SimClock()
    col = _SlowRoundCollector([_sim_stream("j", duration_s=1500)], _cfg(),
                              clk=clk, costs=[40.0] * 5)
    daemon = ServiceDaemon(col, clock=clk.monotonic, sleep=clk.sleep)
    reports = daemon.run()
    assert len(reports) == 5
    # each round costs 40 s; deadlines are origin + k*300, so every sleep
    # is exactly the 260 s of slack — drift never accumulates
    assert clk.sleeps == pytest.approx([260.0] * 4)   # no sleep after last
    assert daemon.overruns == 0


def test_daemon_overrun_skips_sleep_and_does_not_shift_later_deadlines():
    clk = SimClock()
    col = _SlowRoundCollector([_sim_stream("j", duration_s=1500)], _cfg(),
                              clk=clk, costs=[40.0, 350.0, 40.0, 40.0, 40.0])
    daemon = ServiceDaemon(col, clock=clk.monotonic, sleep=clk.sleep)
    daemon.run()
    assert daemon.overruns == 1
    # round 2 blows its 600 s deadline (ends at 650); round 3 ends at 690
    # and sleeps only the 210 s back to the ORIGIN-anchored 900 s deadline
    assert clk.sleeps == pytest.approx([260.0, 210.0, 260.0])


def test_daemon_unpaced_run_never_sleeps():
    clk = SimClock()
    daemon = ServiceDaemon(
        Collector([_sim_stream("j", duration_s=1200)], _cfg()),
        clock=clk.monotonic, sleep=clk.sleep, pace=False)
    daemon.run()
    assert clk.sleeps == []


def test_daemon_requires_bounded_streams_without_n_rounds():
    live = _sim_stream("live", duration_s=float("inf"))
    clk = SimClock()
    daemon = ServiceDaemon(Collector([live], _cfg()),
                           clock=clk.monotonic, sleep=clk.sleep)
    with pytest.raises(ValueError, match="unbounded"):
        daemon.run()
    assert len(daemon.run(n_rounds=2)) == 2


# ---------------------------------------------------------------------------
# Stream churn
# ---------------------------------------------------------------------------
class _RecordingSource(SimulatorSource):
    def poll(self, duration_s):
        grid = super().poll(duration_s)
        self.__dict__.setdefault("polled", []).append(grid)
        return grid


def test_stream_churn_keeps_rollup_bucketwise_consistent():
    a = JobStream("a", _RecordingSource(DAEMON_PROFILE, duration_s=2400,
                                        interval_s=30, n_devices=2,
                                        seed=1), chips=32, group="bf16")
    b = JobStream("b", _RecordingSource(DAEMON_PROFILE, duration_s=2400,
                                        interval_s=30, n_devices=2,
                                        seed=2), chips=32, group="bf16")
    c = JobStream("c", _RecordingSource(DAEMON_PROFILE, duration_s=1200,
                                        interval_s=30, n_devices=2,
                                        seed=3), chips=32, group="bf16")
    clk = SimClock()
    daemon = ServiceDaemon(Collector([a, b], _cfg()),
                           clock=clk.monotonic, sleep=clk.sleep)
    daemon.run(n_rounds=2)
    daemon.request_add_stream(c)          # joins at round 3
    daemon.run(n_rounds=2)
    daemon.request_remove_stream("b")     # leaves before round 5
    daemon.run()
    assert daemon.done

    # manual reference: ingest exactly the grids the daemon polled
    ref = WindowedRollup(bucket_s=300, retain=8)
    for st in (a, b, c):
        for grid in st.source.polled:
            ref.add_grid(st.job_id, grid, group="bf16", chips=32)
    roll = daemon.collector.rollup
    assert roll.bucket0 == ref.bucket0
    assert sorted(roll.jobs) == ["a", "b", "c"]
    for jid in ("a", "b", "c"):
        np.testing.assert_array_equal(roll.job_ofu(jid), ref.job_ofu(jid))
    np.testing.assert_array_equal(roll.fleet_stats().mean,
                                  ref.fleet_stats().mean)
    # b stopped polling when removed: 4 rounds of samples, not 8
    assert len(b.source.polled) == 4
    # the published store saw the c join
    assert daemon.store.jobs()["jobs"] == ["a", "b", "c"]


def test_duplicate_add_and_unknown_remove_fail_loudly():
    col = Collector([_sim_stream("a")], _cfg())
    with pytest.raises(ValueError, match="duplicate"):
        col.add_stream(_sim_stream("a", seed=9))
    with pytest.raises(KeyError, match="nope"):
        col.remove_stream("nope")


# ---------------------------------------------------------------------------
# Persistence + restore
# ---------------------------------------------------------------------------
def test_persist_restore_continue_matches_uninterrupted_run(tmp_path):
    path, _ = _archive(tmp_path)
    clk = SimClock()
    straight = ServiceDaemon(Collector(_replay_streams(path), _cfg()),
                             clock=clk.monotonic, sleep=clk.sleep)
    straight.run()

    state = str(tmp_path / "state")
    clk = SimClock()
    first = ServiceDaemon(Collector(_replay_streams(path), _cfg()),
                          state_dir=state, persist_every=2,
                          clock=clk.monotonic, sleep=clk.sleep)
    first.run(n_rounds=5)
    # "kill -9": no close(); the persist at round 4 is the restart point
    resumed = ServiceDaemon.restore(state, _replay_streams(path), _cfg(),
                                    clock=clk.monotonic, sleep=clk.sleep)
    assert resumed.collector.round_idx == 4
    assert resumed.collector.streams[0].source.cursor_s == 1200.0
    resumed.run()
    resumed.close()

    # every FleetStore answer matches the uninterrupted run
    for query in ("fleet_series", "top_regressions", "goodput"):
        a = getattr(straight.store, query)()
        b = getattr(resumed.store, query)()
        for key in set(a) - {"generation", "round_idx", "clock_s"}:
            assert a[key] == b[key], (query, key)
    ja = straight.store.job_series("traced")
    jb = resumed.store.job_series("traced")
    assert ja["mean"] == jb["mean"] and ja["percentiles"] \
        == jb["percentiles"]
    # alert EPISODES agree (an episode open across the restart re-fires,
    # so round indices may differ — the paged incidents must not)
    assert {(a["job_id"], a["kind"])
            for a in straight.store.alerts()["alerts"]} \
        == {(a["job_id"], a["kind"])
            for a in resumed.store.alerts()["alerts"]}


def test_alert_history_survives_kill9_without_duplicate_pages(tmp_path):
    """Alerts fired BEFORE a crash must still be in
    the restored daemon's log, and an episode that was open at the last
    persist must NOT re-page when the restarted detector sees the same
    collapse again — the restarted alert log equals the uninterrupted
    run's exactly."""
    path, _ = _archive(tmp_path)           # regression from t=1800s on
    clk = SimClock()
    straight = ServiceDaemon(Collector(_replay_streams(path), _cfg()),
                             clock=clk.monotonic, sleep=clk.sleep)
    straight.run()
    want = straight.collector.alerts
    first_round = min(a.round_idx for a in want
                      if a.kind == "regression")

    state = str(tmp_path / "state")
    clk = SimClock()
    first = ServiceDaemon(Collector(_replay_streams(path), _cfg()),
                          state_dir=state, persist_every=1,
                          clock=clk.monotonic, sleep=clk.sleep)
    # run PAST the first regression page, then kill -9 (no close():
    # persist_every=1 made every completed round a restart point)
    first.run(n_rounds=first_round + 2)
    assert any(a.kind == "regression" for a in first.collector.alerts)

    resumed = ServiceDaemon.restore(state, _replay_streams(path), _cfg(),
                                    clock=clk.monotonic, sleep=clk.sleep)
    # the pre-crash log is already there at restore time
    assert [(a.round_idx, a.job_id, a.kind, a.message)
            for a in resumed.collector.alerts] \
        == [(a.round_idx, a.job_id, a.kind, a.message)
            for a in first.collector.alerts]
    resumed.run()
    resumed.close()
    # ...and the finished log matches the uninterrupted run alert for
    # alert: nothing lost, nothing paged twice
    assert [(a.round_idx, a.job_id, a.kind, a.message) for a in want] \
        == [(a.round_idx, a.job_id, a.kind, a.message)
            for a in resumed.collector.alerts]
    # the HTTP-facing store agrees
    assert straight.store.alerts()["alerts"] \
        == resumed.store.alerts()["alerts"]


def test_collector_alert_state_roundtrip():
    """Collector-level: alert_state()/restore_alert_state() round-trip
    the log (NaN factors included) and the open-episode hysteresis."""
    src = Collector([_sim_stream("a", duration_s=600)], _cfg())
    src.alerts = [
        Alert(3, 900.0, "a", "regression", "2.5x collapse", factor=2.5),
        Alert(4, 1200.0, "a", "divergence", "audit", factor=float("nan")),
    ]
    src.deduper._active = {("a", "regression"): [[7, 0]],
                           ("a", "divergence"): [[None, 1]]}
    state = json.loads(json.dumps(src.alert_state()))  # JSON-safe
    dst = Collector([_sim_stream("a", duration_s=600)], _cfg())
    dst.restore_alert_state(state)
    assert [(a.round_idx, a.t_s, a.job_id, a.kind, a.message)
            for a in dst.alerts] \
        == [(a.round_idx, a.t_s, a.job_id, a.kind, a.message)
            for a in src.alerts]
    assert dst.alerts[0].factor == 2.5
    assert np.isnan(dst.alerts[1].factor)
    assert dst.deduper._active == src.deduper._active


def test_restore_rejects_missing_state_and_unseekable_sources(tmp_path):
    with pytest.raises(ValueError, match="no daemon state"):
        ServiceDaemon.restore(str(tmp_path / "empty"), [], _cfg())
    path, _ = _archive(tmp_path)
    state = str(tmp_path / "state")
    clk = SimClock()
    daemon = ServiceDaemon(Collector(_replay_streams(path), _cfg()),
                           state_dir=state, persist_every=1,
                           clock=clk.monotonic, sleep=clk.sleep)
    daemon.run(n_rounds=2)
    daemon.close()
    with pytest.raises(ValueError, match="cannot seek"):
        ServiceDaemon.restore(state, [_sim_stream("traced")], _cfg())


def test_fleet_collector_daemon_serves_but_rejects_persist_and_tee(tmp_path):
    from repro_torch.fleet.collector import FleetCollector

    def host(jid, seed):
        return Collector([_sim_stream(jid, seed=seed, duration_s=1200)],
                         _cfg())

    fc = FleetCollector([host("a", 1), host("b", 2)], reduce_every=1)
    with pytest.raises(ValueError, match="plain Collector"):
        ServiceDaemon(fc, state_dir=str(tmp_path), persist_every=1)
    clk = SimClock()
    daemon = ServiceDaemon(FleetCollector([host("a", 1), host("b", 2)],
                                          reduce_every=1),
                           clock=clk.monotonic, sleep=clk.sleep)
    with pytest.raises(ValueError, match="plain Collector"):
        daemon.request_add_stream(_sim_stream("c"))
    daemon.run()
    assert daemon.store.jobs()["jobs"] == ["a", "b"]
    assert clk.sleeps          # fleet daemon paces too


# ---------------------------------------------------------------------------
# Recording tee (the ROADMAP recording-Collector mode), crash-safe
# ---------------------------------------------------------------------------
def test_tee_records_exact_replayable_archives(tmp_path):
    path, grid = _archive(tmp_path)
    tee = str(tmp_path / "tee")
    clk = SimClock()
    daemon = ServiceDaemon(Collector(_replay_streams(path), _cfg()),
                           tee_dir=tee, tee_chunk_samples=32,
                           clock=clk.monotonic, sleep=clk.sleep)
    daemon.run()
    daemon.close()
    back = read_trace(os.path.join(tee, "traced.ctr"))
    np.testing.assert_array_equal(back.tpa,
                                  grid.tpa.astype(back.tpa.dtype))
    np.testing.assert_array_equal(back.clock_mhz,
                                  grid.clock_mhz.astype(back.tpa.dtype))
    assert back.t0_s == 0.0 and back.interval_s == 30.0


def test_killed_tee_leaves_replayable_archive_and_restore_completes_it(
        tmp_path):
    """The satellite case: kill the daemon mid-run.  The archive must be
    valid and replayable up to the last persistence point, and a
    restored daemon must continue it into the full exact trace (skipping
    whatever a mid-flight chunk flush already archived)."""
    path, grid = _archive(tmp_path)
    state, tee = str(tmp_path / "state"), str(tmp_path / "tee")
    clk = SimClock()
    # chunk_samples=10 == one round of samples: round 5's append flushes
    # a chunk on its own, putting the archive AHEAD of the persisted
    # round-4 cursor — the overlap case a real crash can always produce
    daemon = ServiceDaemon(Collector(_replay_streams(path), _cfg()),
                           state_dir=state, persist_every=2,
                           tee_dir=tee, tee_chunk_samples=10,
                           clock=clk.monotonic, sleep=clk.sleep)
    daemon.run(n_rounds=5)
    del daemon                               # kill: no close(), no flush

    arch = os.path.join(tee, "traced.ctr")
    partial = read_trace(arch)               # manifest must validate
    assert partial.tpa.shape[1] >= 40        # >= everything persisted
    np.testing.assert_array_equal(
        partial.tpa, grid.tpa[:, :partial.tpa.shape[1]].astype(
            partial.tpa.dtype))

    # the partial archive replays through the normal pipeline
    col = Collector([JobStream("re", TraceReplaySource(arch))],
                    _cfg(retain=12))
    assert sum(r.samples for r in col.run()) == partial.tpa.size

    # restore + finish: the tee continues gaplessly to the exact trace
    resumed = ServiceDaemon.restore(state, _replay_streams(path), _cfg(),
                                    tee_dir=tee, tee_chunk_samples=10,
                                    persist_every=2, clock=clk.monotonic,
                                    sleep=clk.sleep)
    resumed.run()
    resumed.close()
    full = read_trace(arch)
    np.testing.assert_array_equal(full.tpa,
                                  grid.tpa.astype(full.tpa.dtype))


def test_tee_flushes_manifest_at_every_persist(tmp_path):
    path, grid = _archive(tmp_path)
    state, tee = str(tmp_path / "state"), str(tmp_path / "tee")
    clk = SimClock()
    # huge chunks: WITHOUT the persist-point flush nothing would ever
    # reach the manifest before close
    daemon = ServiceDaemon(Collector(_replay_streams(path), _cfg()),
                           state_dir=state, persist_every=3,
                           tee_dir=tee, tee_chunk_samples=100_000,
                           clock=clk.monotonic, sleep=clk.sleep)
    daemon.run(n_rounds=4)
    del daemon                               # kill
    back = read_trace(os.path.join(tee, "traced.ctr"))
    # rounds 1-3 were persisted (and flushed); round 4 died in the buffer
    assert back.tpa.shape[1] == 30
    np.testing.assert_array_equal(back.tpa,
                                  grid.tpa[:, :30].astype(back.tpa.dtype))


def test_daemon_guards(tmp_path):
    col = Collector([_sim_stream("j")], _cfg())
    with pytest.raises(ValueError, match="state_dir"):
        ServiceDaemon(col, persist_every=2)
    with pytest.raises(ValueError, match="persist_every"):
        ServiceDaemon(col, persist_every=-1)
    col.on_grid = lambda st, g: None
    with pytest.raises(ValueError, match="on_grid"):
        ServiceDaemon(col, tee_dir=str(tmp_path / "tee"))


def test_stop_interrupts_real_clock_pacing_sleep():
    # default clock/sleep: stop() must wake the inter-round sleep (the
    # SIGTERM path), not leave the daemon dozing toward a 300 s deadline
    import time

    daemon = ServiceDaemon(
        Collector([_sim_stream("j", duration_s=3600)], _cfg()))
    out = {}

    def run():
        out["reports"] = daemon.run(n_rounds=5)

    t = threading.Thread(target=run)
    t0 = time.monotonic()
    t.start()
    time.sleep(0.3)                   # first round done, daemon asleep
    daemon.stop()
    t.join(timeout=10)
    assert not t.is_alive()
    assert time.monotonic() - t0 < 5.0
    assert 1 <= len(out["reports"]) < 5


def test_empty_publish_reports_null_weighted_ofu_not_zero():
    # before the first round the daemon publishes an empty rollup; the
    # dashboard must read "no data yet" (null), never 0% OFU
    daemon = ServiceDaemon(
        Collector([_sim_stream("j")], _cfg()),
        clock=SimClock().monotonic, sleep=SimClock().sleep)
    fleet = daemon.store.fleet_series()
    assert fleet["generation"] == 1
    assert fleet["weighted_ofu"] is None and fleet["t_s"] == []


def test_tee_rejects_adaptive_retiming_up_front(tmp_path):
    # archives are uniform-cadence; the first retiming would crash the
    # loop mid-round, so the combination must fail at construction
    from repro_torch.fleet.collector import AdaptiveConfig
    col = Collector([_sim_stream("j")],
                    _cfg(adaptive=AdaptiveConfig(min_interval_s=5.0)))
    with pytest.raises(ValueError, match="adaptive"):
        ServiceDaemon(col, tee_dir=str(tmp_path / "tee"))


# ===========================================================================
# parity: both packages' daemons on the same seeded grids
# ===========================================================================
#: job -> (base duty, collapse from sample, app MFU)
PARITY_JOBS = {"steady": (0.45, None, 0.41), "slow": (0.42, 240, 0.40),
               "liar": (0.40, None, 0.75)}
PARITY_CFG = dict(round_s=1800.0, bucket_s=300.0, retain=48,
                  detector={"window": 4, "min_duration": 2})


def _parity_grids(seed, n_dev=4, n_samples=480):
    rng = np.random.default_rng(seed)
    out = {}
    for jid, (duty, cut, _) in PARITY_JOBS.items():
        tpa = duty + 0.03 * rng.standard_normal((n_dev, n_samples))
        if cut is not None:
            tpa[:, cut:] /= 2.5
        clk = 1500.0 - 60.0 * rng.random((n_dev, n_samples))
        out[jid] = (np.clip(tpa, 0, 1).astype(np.float32),
                    clk.astype(np.float32))
    return out


def _streams(pkg, grids, *, as_tensor=False):
    """JobStreams of package `pkg` over GridSources of `grids` (the
    port's optionally over CPU tensors)."""
    if pkg == "ref":
        C, src, G = R_collector, R_telemetry.GridSource, \
            R_telemetry.DeviceGrid
    else:
        C, src, G = T_collector, GridSource, DeviceGrid
    wrap = torch.from_numpy if as_tensor else (lambda a: a)
    return [C.JobStream(jid, src(G(30.0, wrap(t), wrap(c))),
                        chips=4 * t.shape[0], group="bf16",
                        app_mfu=PARITY_JOBS[jid][2])
            for jid, (t, c) in grids.items()]


def _daemon(pkg, grids, *, as_tensor=False, **kw):
    C, S = (R_collector, R_serve) if pkg == "ref" \
        else (T_collector, T_serve)
    col = C.Collector(_streams(pkg, grids, as_tensor=as_tensor),
                      C.CollectorConfig(**PARITY_CFG))
    clk = S.SimClock()
    return S.ServiceDaemon(col, clock=clk.monotonic, sleep=clk.sleep, **kw)


def _get_all(client):
    """Every read endpoint of the API, as one dict."""
    return {"fleet": client.fleet(), "jobs": client.jobs(),
            "job": client.job("slow", qs=(50,)),
            "alerts": client.alerts(),
            "top": client.top_regressions(k=3, window=4, min_duration=2),
            "goodput": client.goodput(),
            "divergence": client.divergence(),
            "correlation": client.correlation(),
            "group": client.query("series", scope="group", id="bf16")}


@pytest.mark.parametrize("as_tensor", [False, True])
def test_http_payloads_equal_the_reference_daemons(as_tensor):
    """Both daemons over the same grids (the port's over host arrays and
    over CPU tensors), each behind its own HTTP server: every endpoint's
    payload is equal, and the ETags differ only in the boot nonce."""
    grids = _parity_grids(1)
    out = {}
    for pkg, S, tensor in (("port", T_serve, as_tensor),
                           ("ref", R_serve, False)):
        d = _daemon(pkg, grids, as_tensor=tensor)
        d.run()
        with S.FleetAPIServer(d.store, port=0) as srv:
            cl = S.FleetClient(srv.url)
            payloads = _get_all(cl)
            again = cl.fleet()
            assert cl.hits_304 == 1 and again == payloads["fleet"]
            etags = sorted(e.replace(d.store.boot, "<boot>")
                           for e, _ in cl._cache.values())
        out[pkg] = (payloads, etags)
    mine, ref = out["port"], out["ref"]
    if not as_tensor:
        assert mine[0] == ref[0]
    else:
        # f32 OFU sums on the tensor path: equal alerts, equal counts,
        # means to f32 precision
        ma, ra = mine[0]["alerts"]["alerts"], ref[0]["alerts"]["alerts"]
        assert [(a["round_idx"], a["job_id"], a["kind"]) for a in ma] \
            == [(a["round_idx"], a["job_id"], a["kind"]) for a in ra]
        np.testing.assert_allclose([a["factor"] for a in ma],
                                   [a["factor"] for a in ra], rtol=1e-6)
        assert mine[0]["jobs"]["jobs"] == ref[0]["jobs"]["jobs"]
        np.testing.assert_allclose(
            _from_json(mine[0]["fleet"]["mean"]),
            _from_json(ref[0]["fleet"]["mean"]), rtol=1e-6)
        assert [r["job_id"] for r in mine[0]["top"]["regressions"]] \
            == [r["job_id"] for r in ref[0]["top"]["regressions"]]
    assert mine[1] == ref[1]
    assert ref[0]["alerts"]["alerts"] and ref[0]["top"]["regressions"]


def _from_json(xs):
    return np.array([np.nan if x is None else x for x in xs], dtype=float)


def _archive_members(path):
    """A v1 tee archive's manifest bytes and each chunk's stored .npy
    members, decompressed (the zip container stamps its write time)."""
    import zipfile
    out = {"manifest.json": open(os.path.join(path, "manifest.json"),
                                 "rb").read()}
    for name in sorted(os.listdir(path)):
        if name.endswith(".npz"):
            with zipfile.ZipFile(os.path.join(path, name)) as z:
                for m in sorted(z.namelist()):
                    out[f"{name}/{m}"] = z.read(m)
    return out


@pytest.mark.parametrize("as_tensor", [False, True])
def test_tee_archives_byte_identical_to_the_reference(tmp_path, as_tensor):
    """Recording tees of both daemons over the same samples: each job's
    archive holds the same manifest and the same stored array bytes,
    whether the port's grids are arrays or CPU tensors (the tee copies a
    tensor slice to the host before it appends)."""
    grids = _parity_grids(2)
    for pkg, tensor in (("port", as_tensor), ("ref", False)):
        d = _daemon(pkg, grids, as_tensor=tensor,
                    tee_dir=str(tmp_path / pkg), tee_chunk_samples=50,
                    state_dir=str(tmp_path / f"{pkg}-state"),
                    persist_every=3)
        d.run()
        d.close()
    for jid in PARITY_JOBS:
        mine = _archive_members(str(tmp_path / "port" / f"{jid}.ctr"))
        ref = _archive_members(str(tmp_path / "ref" / f"{jid}.ctr"))
        assert mine == ref
        np.testing.assert_array_equal(
            read_trace(str(tmp_path / "port" / f"{jid}.ctr")).tpa,
            grids[jid][0])


@pytest.mark.parametrize("cut", [3, 5])
def test_reference_state_dir_resumes_in_the_port(tmp_path, cut):
    """A state directory the reference's daemon persisted mid-run, then
    `ServiceDaemon.restore` in each package over fresh streams: the
    port's run continues exactly as the reference's (alerts, persisted
    state, snapshot bytes), and ends where an uninterrupted run does."""
    grids = _parity_grids(3)
    state = str(tmp_path / "state")
    first = _daemon("ref", grids, state_dir=state, persist_every=1)
    first.run(n_rounds=cut)               # a crash: no close()
    assert os.path.isfile(os.path.join(state, "daemon_state.json"))
    for pkg, S, C in (("port", T_serve, T_collector),
                      ("ref", R_serve, R_collector)):
        copy = str(tmp_path / f"{pkg}-state")
        shutil.copytree(state, copy)
        clk = S.SimClock()
        d = S.ServiceDaemon.restore(copy, _streams(pkg, grids),
                                    C.CollectorConfig(**PARITY_CFG),
                                    clock=clk.monotonic, sleep=clk.sleep)
        assert d.collector.round_idx == cut
        d.run()
        d.close()
    rd = {}
    for pkg in ("port", "ref"):
        with open(tmp_path / f"{pkg}-state" / "daemon_state.json") as fh:
            st = json.load(fh)
        with open(tmp_path / f"{pkg}-state" / "rollup.snapshot", "rb") as fh:
            rd[pkg] = (st, fh.read())
    assert rd["port"] == rd["ref"]
    whole = _daemon("ref", grids)
    whole.run()
    assert rd["port"][0]["alerts"] == whole.collector.alert_state()
    assert rd["port"][1] == whole.collector.snapshot()


def test_http_threads_read_only_the_store():
    """Requests are answered from the published store generation: a
    server whose daemon's collector is gone still answers, so no HTTP
    thread reaches the collector (or a device)."""
    grids = _parity_grids(4)
    d = _daemon("port", grids, as_tensor=True)
    d.run()
    store = d.store
    d.collector.streams = None            # any collector access would fail
    with FleetAPIServer(store, port=0) as srv:
        payloads = _get_all(FleetClient(srv.url))
    assert payloads["alerts"]["alerts"]
    assert payloads["fleet"]["generation"] == store.generation
