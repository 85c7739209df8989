"""Distributed rollup reduction: per-host rollups → one fleet dashboard.

`StreamingRollup` is a monoid element — per-bucket histogram weights and
value sums ADD — so any reduction tree over per-host rollups reproduces
single-process ingestion bucket for bucket.  This module models the
multi-host wiring: each host folds only its own devices' scrapes into a
local rollup, ships the fixed-size `to_bytes()` snapshot (kilobytes,
independent of device count), and `tree_reduce` folds the snapshots level
by level — raw scrapes never leave their host.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.fleet.streaming import StreamingRollup


def _empty_like(roll: StreamingRollup) -> StreamingRollup:
    # polymorphic: a WindowedRollup reduces to a WindowedRollup (same
    # retention), so collector snapshots tree-reduce like batch rollups
    return roll.spawn_empty()


def host_partition(items: Sequence, n_hosts: int) -> list:
    """Round-robin items (specs, telemetries, device ids) across hosts."""
    if n_hosts < 1:
        raise ValueError(f"n_hosts={n_hosts} must be >= 1")
    return [list(items[h::n_hosts]) for h in range(n_hosts)]


def tree_reduce(rollups: Sequence, *, fanin: int = 2) -> StreamingRollup:
    """Reduce per-host rollups to one fleet rollup, `fanin` at a time.

    Elements may be StreamingRollup/WindowedRollup objects or their
    `to_bytes()` blobs (deserialized on arrival, as a reducer host would —
    the wire format is self-describing).  Inputs are never mutated; the
    result is a fresh rollup.  Because merge is associative and
    commutative — windowed merges align by absolute bucket index and
    evict identically regardless of order — every (fanin, ordering)
    choice yields bucketwise-identical fleet stats.
    """
    if fanin < 2:
        raise ValueError(f"fanin={fanin} must be >= 2")
    level = [StreamingRollup.from_bytes(r)
             if isinstance(r, (bytes, bytearray)) else r for r in rollups]
    if not level:
        raise ValueError("tree_reduce needs at least one rollup")
    if len(level) == 1:
        return _empty_like(level[0]).merge(level[0])
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), fanin):
            group = level[i:i + fanin]
            # accumulate into a windowed rollup whenever the group has
            # one: windowed absorbs plain (a window starting at bucket 0)
            # but not vice versa, so the choice must not depend on which
            # host happens to come first
            seed = next((r for r in group
                         if getattr(r, "retain", None) is not None),
                        group[0])
            # one vectorized k-way fold per group (falls back to the
            # pairwise loop automatically when the group is windowed)
            acc = _empty_like(seed).merge_many(group)
            nxt.append(acc)
        level = nxt
    return level[0]
