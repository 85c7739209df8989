"""The port's ingest tier (`repro_torch.serve`: `IngestAggregator`,
`POST /v1/ingest` on `FleetAPIServer`, `IngestClient`, `Backpressure`,
`backoff_delays`) against the JAX package's.

The reference's `test_ingest.py`, run on the port (host rollups of the
port's `StreamingRollup`), then parity cases: the same seeded hosts'
delta blobs reduce to bitwise the same fleet rollup through either
package's aggregator, each package's blobs are taken by the other's
aggregator and HTTP endpoint, and backpressure reports the same
counters and Retry-After.
"""
import socket
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.fleet.streaming as R_streaming  # noqa: E402
import repro.serve as R_serve  # noqa: E402
from repro_torch.fleet.streaming import StreamingRollup  # noqa: E402
from repro_torch.serve import (Backpressure, FleetAPIError,  # noqa: E402
                               FleetAPIServer, FleetClient, FleetStore,
                               IngestAggregator, IngestClient, SnapshotGap,
                               backoff_delays)

BINS, BUCKET_S = 32, 300.0


def _mk_host(seed, rounds=2, jobs=2):
    """A host rollup plus the list of (job, hist, sums, b0, group)
    observations that built it (to replay into a reference)."""
    rng = np.random.default_rng(seed)
    roll = StreamingRollup(BUCKET_S, bins=BINS)
    obs = []
    for r in range(rounds):
        for j in range(jobs):
            hist = rng.poisson(2.0, (2, BINS)).astype(float)
            sums = hist.sum(axis=1) * rng.uniform(0.2, 0.6)
            rec = (f"job-{j}", hist, sums, 2 * r,
                   "bf16" if j % 2 else "fp8")
            roll.observe_hist(rec[0], rec[1], rec[2], b0=rec[3],
                              group=rec[4], weight=8)
            obs.append(rec)
    return roll, obs


def _reference(all_obs):
    ref = StreamingRollup(BUCKET_S, bins=BINS)
    for job, hist, sums, b0, group in all_obs:
        ref.observe_hist(job, hist, sums, b0=b0, group=group, weight=8)
    return ref


def _assert_matches(fleet, ref):
    """Bucketwise equality, padding short scope arrays with the zero
    rows they implicitly hold (reduction grows every scope to the
    global bucket count; per-scope ingest only grows on touch)."""
    assert set(fleet._hists) == set(ref._hists)

    def grow(x, rows):
        out = np.zeros((rows,) + x.shape[1:])
        out[:x.shape[0]] = x
        return out

    for scope in ref._hists:
        n = max(fleet._hists[scope].shape[0], ref._hists[scope].shape[0])
        np.testing.assert_allclose(grow(fleet._hists[scope], n),
                                   grow(ref._hists[scope], n),
                                   rtol=1e-9, atol=1e-12,
                                   err_msg=f"scope {scope}")
        np.testing.assert_allclose(grow(fleet._sums[scope], n),
                                   grow(ref._sums[scope], n),
                                   rtol=1e-9, atol=1e-12)


# -- aggregator (no HTTP) -------------------------------------------------
def test_aggregator_totals_match_single_process():
    agg = IngestAggregator(n_shards=4)
    all_obs = []
    for h in range(12):
        roll, obs = _mk_host(h)
        all_obs += obs
        agg.submit(f"host-{h}", roll.to_bytes_v2())
    _assert_matches(agg.fleet_rollup(), _reference(all_obs))
    assert agg.hosts == 12


def test_aggregator_delta_rounds_and_duplicates():
    agg = IngestAggregator(n_shards=2)
    roll = StreamingRollup(BUCKET_S, bins=BINS)
    rng = np.random.default_rng(0)
    acked = 0
    blobs = []
    for r in range(3):
        hist = rng.poisson(2.0, (2, BINS)).astype(float)
        roll.observe_hist("job-0", hist, hist.sum(axis=1), b0=2 * r)
        blob = roll.delta_bytes(acked)
        out = agg.submit("h", blob)
        assert out["applied"] is True
        acked = out["acked"]
        blobs.append(blob)
    # redeliver every round's blob: all duplicates, state unchanged
    mirror = agg._shards[agg.shard_of("h")].mirrors["h"]
    frozen = {s: mirror._hists[s].copy() for s in mirror._hists}
    for blob in blobs:
        assert agg.submit("h", blob)["applied"] is False
    for s, h in frozen.items():
        np.testing.assert_array_equal(mirror._hists[s], h)
    _assert_matches(agg.fleet_rollup(), roll)
    assert agg.stats()["duplicates"] == 3


def test_aggregator_gap_then_full_resync():
    agg = IngestAggregator(n_shards=1)
    roll, _ = _mk_host(1, rounds=1)
    cut = roll.generation
    agg.submit("h", roll.to_bytes_v2())
    # aggregator loses the mirror (restart); host keeps advancing
    agg._shards[0].mirrors.clear()
    roll.observe_hist("job-0", np.ones((1, BINS)), np.ones(1), b0=4)
    with pytest.raises(SnapshotGap) as ei:
        agg.submit("h", roll.delta_bytes(cut))
    assert ei.value.acked == 0
    assert agg.stats()["gaps"] == 1
    # re-encode from the acked cursor -> applies, state is exact
    out = agg.submit("h", roll.delta_bytes(ei.value.acked))
    assert out["applied"] is True
    _assert_matches(agg.fleet_rollup(), roll)


def test_backpressure_when_shard_is_saturated():
    agg = IngestAggregator(n_shards=1, max_queue=3, retry_after_s=0.07)
    roll, _ = _mk_host(2)
    blob = roll.to_bytes_v2()
    shard = agg._shards[0]
    done = []
    with shard.lock:                   # stall applies; submits pile up
        threads = [threading.Thread(
            target=lambda i=i: done.append(agg.submit(f"h{i}", blob)),
            daemon=True) for i in range(3)]
        for t in threads:
            t.start()
        deadline = time.time() + 10
        while shard.inflight < 3:
            assert time.time() < deadline, "submits never queued"
            time.sleep(0.002)
        with pytest.raises(Backpressure) as ei:
            agg.submit("h-overflow", blob)
        assert ei.value.retry_after_s == 0.07
        assert agg.stats()["rejected"] == 1
    for t in threads:
        t.join(timeout=10)
    assert len(done) == 3              # the queued ones all landed
    assert agg.hosts == 3


def test_publish_feeds_the_read_path():
    agg = IngestAggregator(n_shards=2)
    all_obs = []
    for h in range(4):
        roll, obs = _mk_host(h)
        all_obs += obs
        agg.submit(f"host-{h}", roll.to_bytes_v2())
    store = FleetStore()
    agg.publish(store, clock_s=12.5)
    series = store.fleet_series()
    assert series["t_s"], "published fleet series is empty"
    ref = _reference(all_obs).fleet_stats(qs=())
    np.testing.assert_allclose(series["weight"], ref.weight)


# -- HTTP layer -----------------------------------------------------------
@pytest.fixture
def served():
    agg = IngestAggregator(n_shards=2, max_queue=8, retry_after_s=0.01)
    store = FleetStore()
    with FleetAPIServer(store, aggregator=agg) as server:
        yield server, agg, store


def test_http_ingest_end_to_end(served):
    server, agg, store = served
    all_obs, pushers = [], []
    for h in range(6):
        roll, obs = _mk_host(h, rounds=1)
        all_obs += obs
        pusher = IngestClient(server.url, f"host-{h}", roll,
                              timeout_s=10.0)
        out = pusher.push()
        assert out["applied"] is True and out["acked"] == roll.generation
        pushers.append((pusher, roll))
    # second round of deltas through the same cursors
    rng = np.random.default_rng(99)
    for pusher, roll in pushers:
        hist = rng.poisson(2.0, (1, BINS)).astype(float)
        rec = ("job-0", hist, hist.sum(axis=1), 5, "bf16")
        roll.observe_hist(rec[0], rec[1], rec[2], b0=rec[3],
                          group=rec[4], weight=8)
        all_obs.append(rec)
        assert pusher.push()["applied"] is True
    _assert_matches(agg.fleet_rollup(), _reference(all_obs))
    # counters endpoint agrees
    stats = FleetClient(server.url)._get("/v1/ingest")
    assert stats["hosts"] == 6 and stats["applied"] == 12


def test_http_duplicate_push_is_noop(served):
    server, agg, _ = served
    roll, _ = _mk_host(0, rounds=1)
    pusher = IngestClient(server.url, "h", roll, timeout_s=10.0)
    pusher.push()
    acked = pusher.acked
    pusher.acked = 0                   # stale cursor: full redelivery
    out = pusher.push()
    assert out["applied"] is False and pusher.acked == acked
    assert agg.stats()["duplicates"] == 1


def test_http_gap_recovery_is_transparent(served):
    server, agg, _ = served
    roll, _ = _mk_host(3, rounds=1)
    pusher = IngestClient(server.url, "h", roll, timeout_s=10.0)
    pusher.push()
    agg._shards[agg.shard_of("h")].mirrors.clear()     # server restart
    roll.observe_hist("job-0", np.ones((1, BINS)), np.ones(1), b0=4)
    out = pusher.push()                # 409 -> resync -> success
    assert out["applied"] is True
    _assert_matches(agg.fleet_rollup(), roll)
    assert agg.stats()["gaps"] == 1


def test_http_backpressure_429_retry_after(served):
    server, agg, _ = served
    roll, _ = _mk_host(4, rounds=1)
    sid = agg.shard_of("h")
    shard = agg._shards[sid]
    shard.inflight = agg.max_queue     # saturate without real traffic
    slept = []

    def unblock(delay):
        slept.append(delay)
        shard.inflight = 0             # pressure clears while we wait

    pusher = IngestClient(server.url, "h", roll, timeout_s=10.0,
                          retries=3, backoff_s=0.05, sleep=unblock)
    out = pusher.push()
    assert out["applied"] is True
    assert pusher.backpressure_hits == 1
    # the wait honoured the server's Retry-After (0.01) or the local
    # backoff step (0.05), whichever is larger
    assert slept == [0.05]
    assert agg.stats()["rejected"] == 1


def test_http_backpressure_gives_up_after_retries(served):
    server, agg, _ = served
    roll, _ = _mk_host(5, rounds=1)
    shard = agg._shards[agg.shard_of("h")]
    shard.inflight = agg.max_queue     # and never clears
    slept = []
    pusher = IngestClient(server.url, "h", roll, timeout_s=10.0,
                          retries=2, backoff_s=0.05, sleep=slept.append)
    with pytest.raises(FleetAPIError) as ei:
        pusher.push()
    assert ei.value.status == 429
    assert slept == [0.05, 0.1]        # capped exponential schedule
    shard.inflight = 0


def test_http_post_without_host_header_is_400(served):
    server, _, _ = served
    import urllib.error
    import urllib.request
    req = urllib.request.Request(server.url + "/v1/ingest", data=b"x",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400


def test_http_post_corrupt_blob_is_400(served):
    server, _, _ = served
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        server.url + "/v1/ingest", data=b"not a v2 blob at all",
        method="POST", headers={"X-Fleet-Host": "h"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400


def test_ingest_404_without_aggregator():
    store = FleetStore()
    with FleetAPIServer(store) as server:        # read-only deployment
        import urllib.error
        import urllib.request
        req = urllib.request.Request(
            server.url + "/v1/ingest", data=b"x", method="POST",
            headers={"X-Fleet-Host": "h"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 404


# -- backoff + stalled sockets (satellite: client timeout regression) -----
def test_backoff_delays_schedule():
    assert list(backoff_delays(5, base_s=0.05, cap_s=0.4)) == \
        [0.05, 0.1, 0.2, 0.4, 0.4]
    assert list(backoff_delays(0)) == []
    with pytest.raises(ValueError):
        list(backoff_delays(-1))
    with pytest.raises(ValueError):
        list(backoff_delays(2, base_s=0.0))


@pytest.fixture
def stalled_server():
    """A socket that accepts connections and then says NOTHING — the
    pathological peer a missing socket timeout would hang on forever."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    srv.settimeout(0.1)
    conns = []
    stop = threading.Event()

    def accept_loop():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
                conns.append(conn)     # hold it open, never respond
            except socket.timeout:
                continue
            except OSError:
                return

    t = threading.Thread(target=accept_loop, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.getsockname()[1]}"
    stop.set()
    t.join(timeout=5)
    for c in conns:
        c.close()
    srv.close()


def test_fleet_client_fails_fast_on_stalled_socket(stalled_server):
    slept = []
    client = FleetClient(stalled_server, timeout_s=0.2, retries=2,
                         backoff_s=0.05, sleep=slept.append)
    t0 = time.perf_counter()
    with pytest.raises(FleetAPIError) as ei:
        client.fleet()
    wall = time.perf_counter() - t0
    assert ei.value.status == 0
    assert slept == [0.05, 0.1]        # both retries took the schedule
    assert client.requests == 3
    # 3 attempts x 0.2 s timeout + scheduling slack — NOT a hang
    assert wall < 5.0


def test_ingest_client_fails_fast_on_stalled_socket(stalled_server):
    roll, _ = _mk_host(6, rounds=1)
    slept = []
    pusher = IngestClient(stalled_server, "h", roll, timeout_s=0.2,
                          retries=1, backoff_s=0.05, sleep=slept.append)
    t0 = time.perf_counter()
    with pytest.raises(FleetAPIError) as ei:
        pusher.push()
    assert ei.value.status == 0
    assert slept == [0.05]
    assert time.perf_counter() - t0 < 5.0
    assert pusher.acked == 0           # nothing was acked


# ===========================================================================
# parity with the reference on the same seeded hosts
# ===========================================================================
def _hosts(pkg_rollup, n=12):
    """`_mk_host`'s observations, replayed into `pkg_rollup` rollups."""
    out = []
    for h in range(n):
        _, obs = _mk_host(h)
        roll = pkg_rollup(BUCKET_S, bins=BINS)
        for job, hist, sums, b0, group in obs:
            roll.observe_hist(job, hist, sums, b0=b0, group=group, weight=8)
        out.append(roll)
    return out


def _state_equal(a, b):
    assert set(a._hists) == set(b._hists)
    for scope in a._hists:
        np.testing.assert_array_equal(a._hists[scope], b._hists[scope])
        np.testing.assert_array_equal(a._sums[scope], b._sums[scope])


@pytest.mark.parametrize("wire", ["to_bytes_v2", "delta_bytes"])
def test_fleet_rollup_equals_reference_and_blobs_cross(wire):
    port_hosts = _hosts(StreamingRollup)
    ref_hosts = _hosts(R_streaming.StreamingRollup)

    def blob(roll):
        return roll.to_bytes_v2() if wire == "to_bytes_v2" \
            else roll.delta_bytes(0)

    port_blobs = [blob(r) for r in port_hosts]
    ref_blobs = [blob(r) for r in ref_hosts]
    assert port_blobs == ref_blobs           # byte-identical encodings
    fleets = []
    for Agg, blobs in ((IngestAggregator, port_blobs),
                       (R_serve.IngestAggregator, port_blobs),
                       (IngestAggregator, ref_blobs)):
        agg = Agg(n_shards=4)
        for h, b in enumerate(blobs):
            agg.submit(f"host-{h}", b)
        fleets.append((agg.fleet_rollup(), agg.stats()))
    ref = R_serve.IngestAggregator(n_shards=4)
    for h, b in enumerate(ref_blobs):
        ref.submit(f"host-{h}", b)
    want, want_stats = ref.fleet_rollup(), ref.stats()
    for fleet, stats in fleets:
        _state_equal(fleet, want)
        assert stats == want_stats


def test_backpressure_and_gap_equal_reference():
    """A saturated shard rejects with the same Retry-After and counters,
    and a lost mirror raises the same gap, in both packages."""
    out = []
    for Agg, Roll, Gap, Bp in (
            (IngestAggregator, StreamingRollup, SnapshotGap, Backpressure),
            (R_serve.IngestAggregator, R_streaming.StreamingRollup,
             R_serve.SnapshotGap, R_serve.Backpressure)):
        agg = Agg(n_shards=1, max_queue=2, retry_after_s=0.25)
        roll = Roll(BUCKET_S, bins=BINS)
        roll.observe_hist("job-0", np.ones((2, BINS)), np.full(2, 3.0))
        agg.submit("h", roll.to_bytes_v2())
        agg._shards[0].inflight = agg.max_queue
        with pytest.raises(Bp) as bp:
            agg.submit("h2", roll.to_bytes_v2())
        agg._shards[0].inflight = 0
        cut = roll.generation
        agg._shards[0].mirrors.clear()
        roll.observe_hist("job-0", np.ones((1, BINS)), np.ones(1), b0=4)
        with pytest.raises(Gap) as gap:
            agg.submit("h", roll.delta_bytes(cut))
        out.append((bp.value.retry_after_s, gap.value.acked,
                    str(gap.value), agg.stats()))
    assert out[0] == out[1]


@pytest.mark.parametrize("client_pkg", ["port", "reference"])
def test_http_ingest_crosses_packages(client_pkg):
    """An `IngestClient` of one package pushes two rounds of deltas to
    the other package's `POST /v1/ingest`; the served fleet rollup is
    the one a same-package push builds."""
    Client, Server, Agg, Store, Roll = (
        (IngestClient, R_serve.FleetAPIServer, R_serve.IngestAggregator,
         R_serve.FleetStore, StreamingRollup) if client_pkg == "port" else
        (R_serve.IngestClient, FleetAPIServer, IngestAggregator,
         FleetStore, R_streaming.StreamingRollup))
    agg = Agg(n_shards=2)
    all_obs = []
    with Server(Store(), aggregator=agg) as server:
        for h in range(3):
            _, obs = _mk_host(h, rounds=2)
            roll = Roll(BUCKET_S, bins=BINS)
            pusher = Client(server.url, f"host-{h}", roll, timeout_s=10.0)
            for rnd in (obs[:2], obs[2:]):
                for job, hist, sums, b0, group in rnd:
                    roll.observe_hist(job, hist, sums, b0=b0, group=group,
                                      weight=8)
                assert pusher.push()["applied"] is True
            all_obs += obs
    _assert_matches(agg.fleet_rollup(), _reference(all_obs))
    assert agg.stats()["applied"] == 6


def test_backoff_delays_equal_reference():
    for n, base, cap in ((5, 0.05, 0.4), (8, 0.01, 1.0), (0, 0.1, 1.0)):
        assert list(backoff_delays(n, base_s=base, cap_s=cap)) \
            == list(R_serve.backoff_delays(n, base_s=base, cap_s=cap))
