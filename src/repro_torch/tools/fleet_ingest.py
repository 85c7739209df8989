"""Run the fleet ingest tier: sharded aggregator behind POST /v1/ingest.

Serves a `FleetStore` + `IngestAggregator` on the dashboard API so
per-host daemons can ship `StreamingRollup.delta_bytes()` blobs at it:

    python -m repro_torch.tools.fleet_ingest --port 8080 \
        --shards 8 --publish-every 5
    # on each host:
    #   IngestClient("http://collector:8080", host_id, rollup).push()
    curl -s localhost:8080/v1/ingest | python -m json.tool   # counters
    curl -s localhost:8080/v1/fleet | python -m json.tool    # readout

`--publish-every N` reduces the host mirrors into a fresh `FleetStore`
generation every N seconds, so the read half stays a cache hit between
publishes no matter how hard ingest runs.

`--self-check` is the smoke test: spin up the server on an ephemeral
port, run N fake host daemon threads pushing delta rounds over real
HTTP (with deliberate duplicate redeliveries), publish, and assert the
fleet totals match single-process ingestion of the same observations
bucketwise.  Each host daemon bins its own counter grids on the device
(the card unless `--device` names another) with the histogram kernel,
as a host's daemon bins its cards' counters, and ships the deltas.
"""
from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.fleet.streaming import StreamingRollup
from repro_torch.kernels.fleet_hist import ofu_bucket_hist
from repro_torch.serve import (FleetAPIServer, FleetClient, FleetStore,
                               IngestAggregator, IngestClient)

#: a host's counter grid a round: devices x scrapes, over two buckets
GRID_DEVICES, GRID_SCRAPES = 8, 20


def serve(args) -> int:
    agg = IngestAggregator(n_shards=args.shards, max_queue=args.max_queue)
    store = FleetStore()
    with FleetAPIServer(store, host=args.host, port=args.port,
                        aggregator=agg) as server:
        print(f"ingest tier on {server.url} "
              f"({args.shards} shards, max_queue={args.max_queue})")
        print(f"  POST {server.url}/v1/ingest   (X-Fleet-Host: <id>)")
        print(f"  GET  {server.url}/v1/ingest   (counters)")
        print(f"  GET  {server.url}/v1/fleet    (published readout)")
        try:
            while True:
                time.sleep(args.publish_every)
                if agg.hosts:
                    agg.publish(store, clock_s=time.time())
                    print(f"published generation {store.generation}: "
                          f"{agg.hosts} hosts, "
                          f"{agg.stats()['applied']} deltas applied")
        except KeyboardInterrupt:
            print("\nstopping")
    return 0


def _host_hist(rng, device, edges, grid_lock):
    """One round of a host's counters, binned on `device`: (hist (2,
    bins), sums (2,)) host arrays over two buckets of scrapes."""
    tpa = rng.uniform(0.1, 0.7, (GRID_DEVICES, GRID_SCRAPES))
    clk = rng.uniform(900.0, 1411.0, (GRID_DEVICES, GRID_SCRAPES))
    col = np.arange(GRID_SCRAPES) * 2 // GRID_SCRAPES
    with grid_lock:       # one launch at a time from the daemon threads
        hist, sums = ofu_bucket_hist(
            torch.as_tensor(tpa, dtype=torch.float32, device=device),
            torch.as_tensor(clk, dtype=torch.float32, device=device),
            inv_fmax=1 / 1411.0, edges=edges, col_bucket=col, n_buckets=2)
        return hist.cpu().numpy().astype(float), sums.cpu().numpy()


def self_check(n_hosts: int = 8, rounds: int = 3, device=None) -> int:
    """N host daemons push delta rounds over real HTTP (some twice);
    the published fleet readout must match single-process ingestion of
    the same observations bucketwise (smoke test).  Each round's
    histograms are binned on `device` (the card when None)."""
    device = resolve_device(device)
    bins, bucket_s = 64, 300.0
    grid_lock = threading.Lock()
    agg = IngestAggregator(n_shards=4, max_queue=16)
    store = FleetStore()
    reference = StreamingRollup(bucket_s, bins=bins)
    ref_lock = threading.Lock()
    errors: list[BaseException] = []

    def host_daemon(url: str, h: int) -> None:
        rng = np.random.default_rng(h)
        roll = StreamingRollup(bucket_s, bins=bins)
        pusher = IngestClient(url, f"host-{h:02d}", roll, timeout_s=10.0)
        job, grp = f"job-{h % 3}", ("bf16" if h % 2 else "fp8")
        try:
            for r in range(rounds):
                hist, sums = _host_hist(rng, device, roll.edges, grid_lock)
                roll.observe_hist(job, hist, sums, b0=2 * r, group=grp,
                                  weight=16)
                with ref_lock:
                    reference.observe_hist(job, hist, sums, b0=2 * r,
                                           group=grp, weight=16)
                pusher.push()
                if h % 3 == 0:          # at-least-once: redeliver
                    stale = pusher.acked
                    pusher.acked = max(0, stale - 1)
                    pusher.push()
                    assert pusher.acked == stale, \
                        f"redelivery moved the cursor: {pusher.acked}"
        except BaseException as e:      # noqa: BLE001 — surfaced below
            errors.append(e)

    with FleetAPIServer(store, aggregator=agg) as server:
        threads = [threading.Thread(target=host_daemon,
                                    args=(server.url, h), daemon=True)
                   for h in range(n_hosts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        if errors:
            raise errors[0]
        agg.publish(store, clock_s=1.0)

        fleet = agg.fleet_rollup()
        assert set(fleet._hists) == set(reference._hists), \
            "scope sets differ from single-process ingestion"
        for scope in reference._hists:
            np.testing.assert_allclose(
                fleet._hists[scope], reference._hists[scope],
                rtol=1e-9, atol=1e-12, err_msg=f"scope {scope}")
            np.testing.assert_allclose(
                fleet._sums[scope], reference._sums[scope],
                rtol=1e-9, atol=1e-12, err_msg=f"scope {scope}")

        stats = agg.stats()
        n_redelivered = sum(rounds for h in range(n_hosts) if h % 3 == 0)
        assert stats["hosts"] == n_hosts, stats
        # a redelivered delta carries an already-acked seq: the mirror
        # must shrug it off as a duplicate, never double-count
        assert stats["duplicates"] == n_redelivered, \
            f"expected {n_redelivered} duplicate redeliveries, " \
            f"aggregator saw {stats['duplicates']}"
        assert stats["gaps"] == 0 and stats["rejected"] == 0, stats

        client = FleetClient(server.url)
        readout = client.fleet()
        assert readout["t_s"], "published fleet series is empty"
        counters = client._get("/v1/ingest")
        assert counters["applied"] == stats["applied"], counters
    ref_w = float(sum(reference._hists[s].sum()
                      for s in reference._hists))
    print(f"SELF-CHECK OK: {n_hosts} host daemons x {rounds} delta "
          f"rounds binned on {device}, over HTTP ({stats['applied']} applied, "
          f"{stats['duplicates']} duplicate redeliveries dropped), "
          f"fleet totals match single-process ingestion bucketwise "
          f"(total weight {ref_w:.0f})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (printed at startup)")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=32,
                    help="per-shard in-flight submits before 429")
    ap.add_argument("--publish-every", type=float, default=5.0,
                    help="seconds between FleetStore publishes")
    ap.add_argument("--device", default=None,
                    help="torch device of the self-check's host daemons; "
                    "the card when omitted")
    ap.add_argument("--self-check", action="store_true",
                    help="fake host daemons over real HTTP, assert "
                    "fleet totals match single-process (smoke test)")
    args = ap.parse_args(argv)
    if args.self_check:
        return self_check(device=args.device)
    return serve(args)


if __name__ == "__main__":
    sys.exit(main())
