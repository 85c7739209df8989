"""Rollup wire format v2 (``FRU2``): the zero-copy ingest hot path.

The v1 snapshot (`StreamingRollup.to_bytes`) is a compressed npz: self-
describing and portable, but every blob pays zip framing + zlib on both
ends and every array is copied out of the archive.  At fleet scale the
reducer decodes thousands of blobs per second, so v2 trades generality
for speed:

  * raw little-endian header + contiguous column layout — the decoder is
    `np.frombuffer` views into the blob, no decompression, no copies;
  * DELTA framing — a blob can carry only the bucket rows touched since
    a base generation (`since`), stamped with the encoder's generation
    (`seq`), so a host ships O(new buckets) per round, not O(history);
  * REPLACE semantics — a delta row holds the scope's full cumulative
    histogram for that bucket, so applying a delta to a mirror of the
    base state is idempotent (at-least-once delivery needs no dedup
    bookkeeping beyond the `seq` ordering check).

Layout (all integers little-endian, arrays 8-byte aligned)::

    offset  size          field
    0       4             magic  b"FRU2"
    4       2             version (u16, currently 1)
    6       2             flags   (u16; bit0 = delta, i.e. since > 0)
    8       8             since   (u64: base generation, 0 = full)
    16      8             seq     (u64: encoder generation)
    24      4             bins    (u32)
    28      4             n_buckets (u32: total rows at encode time)
    32      8             bucket_s (f64)
    40      4             meta_len (u32: JSON byte count)
    44      4             zero pad
    48      meta_len      meta JSON {"scopes", "rows", "job_meta"}
    -- pad to 8 --
    (bins+1) * 8          edges (f64)
    per scope, in meta order:
      n_rows * 4          row indices (u32, absolute bucket index), pad to 8
      n_rows * bins * 8   histogram rows (f64, C order)
      n_rows * 8          weighted value sums (f64)

npz (v1) stays the compatibility format — it alone carries windowed
retention state — and `StreamingRollup.from_bytes` dispatches on the
leading magic, so a reducer accepts either through one entry point.
"""
from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np

MAGIC = b"FRU2"
VERSION = 1
FLAG_DELTA = 1

_HEADER = struct.Struct("<4sHHQQIIdI4x")      # 48 bytes, meta follows
assert _HEADER.size == 48


def _pad8(n: int) -> int:
    return (-n) % 8


@dataclass
class WireSnapshot:
    """A decoded v2 blob: header fields + per-scope array VIEWS.

    The arrays are read-only `np.frombuffer` views into the original
    blob — zero copies until the rows are written into a destination
    rollup.  Keep the blob alive as long as the views are in use.
    """

    version: int
    flags: int
    since: int                   # base generation (0 = full snapshot)
    seq: int                     # encoder generation
    bins: int
    n_buckets: int
    bucket_s: float
    edges: np.ndarray            # (bins + 1,) f64 view
    scopes: list                 # [(scope_tuple, idx u32, hist, sums), ...]
    job_meta: dict
    nbytes: int

    @property
    def is_delta(self) -> bool:
        return bool(self.flags & FLAG_DELTA)


def is_v2(blob) -> bool:
    return bytes(blob[:4]) == MAGIC


def encode(roll, since: int = 0) -> bytes:
    """Serialize `roll`'s bucket rows touched after generation `since`.

    `since=0` is a full snapshot (every row ever written); any later cut
    ships only the rows whose cumulative state changed — the caller's
    ack cursor decides.  Rollups with retention/eviction state cannot be
    delta-framed (an evicted row has no cumulative value to replace);
    they stay on the npz format.
    """
    if getattr(roll, "retain", None) is not None:
        raise ValueError("wire format v2 carries plain StreamingRollup "
                         "snapshots; a WindowedRollup's eviction state "
                         "needs the npz format (to_bytes)")
    since = int(since)
    if since < 0:
        raise ValueError(f"since={since} must be >= 0")
    scopes, rows, arrays = [], [], []
    for scope, touched in roll._touched.items():
        idx = np.flatnonzero(touched > since)
        if idx.size == 0:
            continue
        scopes.append(list(scope))
        rows.append(int(idx.size))
        arrays.append((idx.astype("<u4"),
                       np.ascontiguousarray(roll._hists[scope][idx],
                                            dtype="<f8"),
                       np.ascontiguousarray(roll._sums[scope][idx],
                                            dtype="<f8")))
    meta = json.dumps({"scopes": scopes, "rows": rows,
                       "job_meta": roll._job_meta},
                      separators=(",", ":"),
                      default=lambda o: o.item()).encode()
    flags = FLAG_DELTA if since > 0 else 0
    parts = [_HEADER.pack(MAGIC, VERSION, flags, since, int(roll.generation),
                          roll.bins, roll.n_buckets, roll.bucket_s,
                          len(meta)),
             meta, b"\0" * _pad8(len(meta)),
             np.ascontiguousarray(roll.edges, dtype="<f8").tobytes()]
    for idx, hist, sums in arrays:
        parts.append(idx.tobytes())
        parts.append(b"\0" * _pad8(idx.nbytes))
        parts.append(hist.tobytes())
        parts.append(sums.tobytes())
    return b"".join(parts)


def decode(blob) -> WireSnapshot:
    """Parse a v2 blob into header fields + zero-copy array views."""
    blob = bytes(blob) if isinstance(blob, bytearray) else blob
    if len(blob) < _HEADER.size:
        raise ValueError(f"blob too short for a v2 header "
                         f"({len(blob)} bytes)")
    magic, version, flags, since, seq, bins, n_buckets, bucket_s, \
        meta_len = _HEADER.unpack_from(blob, 0)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic!r} (want {MAGIC!r})")
    if version != VERSION:
        raise ValueError(f"unsupported wire format v2 version {version}")
    off = _HEADER.size
    try:
        meta = json.loads(blob[off:off + meta_len].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"corrupt v2 meta block: {e}") from None
    off += meta_len + _pad8(meta_len)
    rows = meta["rows"]
    if len(rows) != len(meta["scopes"]):
        raise ValueError("corrupt v2 meta: scopes/rows length mismatch")
    need = off + (bins + 1) * 8 + sum(
        r * 4 + _pad8(r * 4) + r * bins * 8 + r * 8 for r in rows)
    if len(blob) < need:
        raise ValueError(f"truncated v2 blob: {len(blob)} bytes, "
                         f"layout needs {need}")
    edges = np.frombuffer(blob, "<f8", count=bins + 1, offset=off)
    off += (bins + 1) * 8
    scopes = []
    for key, n_rows in zip(meta["scopes"], rows):
        idx = np.frombuffer(blob, "<u4", count=n_rows, offset=off)
        off += n_rows * 4 + _pad8(n_rows * 4)
        hist = np.frombuffer(blob, "<f8", count=n_rows * bins,
                             offset=off).reshape(n_rows, bins)
        off += n_rows * bins * 8
        sums = np.frombuffer(blob, "<f8", count=n_rows, offset=off)
        off += n_rows * 8
        if n_rows and int(idx.max()) >= n_buckets:
            raise ValueError(f"corrupt v2 blob: row index {int(idx.max())}"
                             f" >= n_buckets {n_buckets}")
        scopes.append((tuple(key), idx, hist, sums))
    return WireSnapshot(version, flags, since, seq, bins, n_buckets,
                        bucket_s, edges, scopes, meta["job_meta"],
                        len(blob))


def restore(blob):
    """Full v2 blob -> fresh `StreamingRollup` (the from_bytes v2 arm)."""
    from repro_torch.fleet.streaming import StreamingRollup

    snap = decode(blob)
    if snap.is_delta:
        raise ValueError(
            f"blob is a delta (covers generations {snap.since}->"
            f"{snap.seq}]); apply_delta() it to a mirror of the base "
            "state — only since=0 blobs restore standalone")
    roll = StreamingRollup(snap.bucket_s, bins=snap.bins,
                           lo=float(snap.edges[0]),
                           hi=float(snap.edges[-1]))
    roll.edges = snap.edges.copy()
    roll.apply_snapshot(snap)
    return roll
