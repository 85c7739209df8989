"""Sharded ingest aggregator: the write half of the fleet API.

Per-host daemons ship `StreamingRollup.delta_bytes()` blobs (the v2 wire
format, `fleet.wire`); this tier turns thousands of those streams into
one queryable fleet rollup without ever centralizing raw scrapes:

  * hosts hash onto SHARDS (stable `crc32(host_id) % n_shards`), each
    shard owning an independent lock + per-host MIRROR rollups, so
    ingest scales across server threads with no global write lock;
  * a delta REPLACES the touched bucket rows of its host's mirror
    (`apply_snapshot`) — idempotent under at-least-once delivery, with
    the blob's `seq`/`since` generations ordering retries and exposing
    lost deltas as explicit gaps (HTTP 409, client re-encodes from the
    acked generation);
  * BACKPRESSURE is per shard: when more submits are in flight on one
    shard than `max_queue`, further submits are refused with a
    retry-after hint (HTTP 429 + `Retry-After`; `serve.client`'s capped
    exponential backoff honours it);
  * `fleet_rollup()` tree-reduces per-shard first, then cross-shard —
    both levels through the vectorized k-way `merge_many` — and
    `publish()` pushes the result into a `FleetStore` generation for
    the dashboard read path.

Decode happens OUTSIDE the shard lock (it is `np.frombuffer` views, but
corrupt blobs must not poison the lock), apply inside it.
"""
from __future__ import annotations

import threading
import zlib
from typing import Optional

from repro_torch.fleet import wire
from repro_torch.fleet.correlation import MfuRollup
from repro_torch.fleet.streaming import StreamingRollup


class Backpressure(Exception):
    """Shard ingest queue is deep: retry after `retry_after_s`."""

    def __init__(self, shard: int, depth: int, retry_after_s: float):
        super().__init__(f"ingest shard {shard} has {depth} submits in "
                         f"flight; retry after {retry_after_s:g}s")
        self.shard = int(shard)
        self.depth = int(depth)
        self.retry_after_s = float(retry_after_s)


class SnapshotGap(Exception):
    """A delta arrived whose base generation is ahead of the mirror —
    an earlier delta was lost.  Carries the generation the aggregator
    HAS acked so the sender can re-encode from there."""

    def __init__(self, host: str, acked: int, message: str):
        super().__init__(message)
        self.host = host
        self.acked = int(acked)


class _Shard:
    __slots__ = ("lock", "gate", "mirrors", "inflight", "applied",
                 "duplicates", "gaps", "rejected", "bytes_in")

    def __init__(self):
        self.lock = threading.Lock()      # serializes mirror mutation
        self.gate = threading.Lock()      # guards the inflight counter
        self.mirrors: dict = {}           # host_id -> StreamingRollup
        self.inflight = 0
        self.applied = 0
        self.duplicates = 0
        self.gaps = 0
        self.rejected = 0
        self.bytes_in = 0


class IngestAggregator:
    """Accepts per-host delta blobs, maintains host mirrors per shard,
    reduces to one fleet rollup on demand.

    Thread-safe: `submit` from any number of server threads; shards
    contend only within themselves.  `max_queue` bounds the submits a
    single shard will hold in flight (queued on its lock) before
    refusing with `Backpressure`.
    """

    def __init__(self, *, n_shards: int = 4, max_queue: int = 32,
                 retry_after_s: float = 0.05,
                 mfu_bucket_s: float = 300.0):
        if n_shards < 1:
            raise ValueError(f"n_shards={n_shards} must be >= 1")
        if max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1")
        self.n_shards = int(n_shards)
        self.max_queue = int(max_queue)
        self.retry_after_s = float(retry_after_s)
        self._shards = [_Shard() for _ in range(self.n_shards)]
        # app-MFU samples (POST /v1/mfu) are per-JOB, not per-host, and
        # orders of magnitude lighter than counter deltas — one store
        # under one lock is plenty, no sharding needed
        self._mfu = MfuRollup(mfu_bucket_s)
        self._mfu_lock = threading.Lock()
        self.mfu_rows = 0
        self.publishes = 0

    def shard_of(self, host_id: str) -> int:
        """Stable host -> shard map (survives restarts and rescaling
        only by whole-fleet agreement — it is just crc32 mod shards)."""
        return zlib.crc32(host_id.encode()) % self.n_shards

    # -- ingest ---------------------------------------------------------
    def submit(self, host_id: str, blob) -> dict:
        """Decode + apply one delta blob from `host_id`.

        Returns ``{"applied": bool, "acked": int, "shard": int}`` where
        `acked` is the mirror's generation after the call — the cursor
        the host should delta from next.  Raises `Backpressure` when the
        shard is saturated, `SnapshotGap` on a lost-delta sequence gap,
        `ValueError` on a corrupt blob or bucketing mismatch.
        """
        if not host_id:
            raise ValueError("host_id must be non-empty")
        sid = self.shard_of(host_id)
        shard = self._shards[sid]
        with shard.gate:
            if shard.inflight >= self.max_queue:
                shard.rejected += 1
                raise Backpressure(sid, shard.inflight, self.retry_after_s)
            shard.inflight += 1
        try:
            snap = wire.decode(blob)          # zero-copy, outside the lock
            with shard.lock:
                mirror = shard.mirrors.get(host_id)
                if mirror is None:
                    mirror = StreamingRollup(
                        snap.bucket_s, bins=snap.bins,
                        lo=float(snap.edges[0]), hi=float(snap.edges[-1]))
                    mirror.edges = snap.edges.copy()
                    shard.mirrors[host_id] = mirror
                try:
                    applied = mirror.apply_snapshot(snap)
                except ValueError as e:
                    if snap.since > mirror.generation:
                        shard.gaps += 1
                        raise SnapshotGap(host_id, mirror.generation,
                                          str(e)) from None
                    raise
                shard.bytes_in += snap.nbytes
                if applied:
                    shard.applied += 1
                else:
                    shard.duplicates += 1
                acked = mirror.generation
            return {"applied": applied, "acked": acked, "shard": sid}
        finally:
            with shard.gate:
                shard.inflight -= 1

    def submit_mfu(self, payload: dict) -> dict:
        """Accumulate one POST /v1/mfu body — raw samples
        ({"job_id", "samples": [[t_s, mfu], ...]}) or a pre-bucketed
        `MfuRollup.to_payload()` dump.  Returns {"applied": rows};
        raises ValueError on a malformed body (HTTP 400)."""
        with self._mfu_lock:
            n = self._mfu.apply_payload(payload)
            self.mfu_rows += n
        return {"applied": n}

    # -- reduction + publish --------------------------------------------
    def fleet_rollup(self) -> Optional[StreamingRollup]:
        """Reduce every host mirror to one fleet rollup (None when no
        host has reported yet): per-shard k-way `merge_many` under each
        shard's lock, then one cross-shard `merge_many` — the two-level
        tree `fleet.distributed.tree_reduce` proves bucketwise-identical
        to single-process ingestion."""
        shard_views = []
        template = None
        for shard in self._shards:
            with shard.lock:
                if not shard.mirrors:
                    continue
                mirrors = list(shard.mirrors.values())
                if template is None:
                    template = mirrors[0]
                shard_views.append(
                    mirrors[0].spawn_empty().merge_many(mirrors))
        if not shard_views:
            return None
        return template.spawn_empty().merge_many(shard_views)

    def publish(self, store, *, clock_s: float = 0.0) -> int:
        """Reduce and push a new `FleetStore` generation (the rollup is
        freshly built and the MFU store snapshot-copied under its lock,
        so no further defensive copy is taken)."""
        roll = self.fleet_rollup()
        with self._mfu_lock:
            mfu = self._mfu.copy() if self._mfu.jobs else None
        self.publishes += 1
        return store.update(roll, mfu=mfu, round_idx=self.publishes,
                            clock_s=clock_s, copy=False)

    # -- observability --------------------------------------------------
    @property
    def hosts(self) -> int:
        return sum(len(s.mirrors) for s in self._shards)

    def stats(self) -> dict:
        """JSON-ready counters (the GET /v1/ingest payload)."""
        shards = [{"hosts": len(s.mirrors), "inflight": s.inflight,
                   "applied": s.applied, "duplicates": s.duplicates,
                   "gaps": s.gaps, "rejected": s.rejected,
                   "bytes_in": s.bytes_in} for s in self._shards]
        with self._mfu_lock:
            mfu_jobs = len(self._mfu.jobs)
        return {"n_shards": self.n_shards, "max_queue": self.max_queue,
                "hosts": self.hosts,
                "applied": sum(s["applied"] for s in shards),
                "duplicates": sum(s["duplicates"] for s in shards),
                "gaps": sum(s["gaps"] for s in shards),
                "rejected": sum(s["rejected"] for s in shards),
                "bytes_in": sum(s["bytes_in"] for s in shards),
                "mfu_jobs": mfu_jobs, "mfu_rows": self.mfu_rows,
                "publishes": self.publishes,
                "shards": shards}
