"""Columnar trace archives: the fleet-scale storage layer under
`TraceReplaySource` (months of archived counter scrapes are where fleet
tooling lives or dies).

Two on-disk formats behind one reader/writer API:

**ctr-v1** — a DIRECTORY of compressed npz column chunks plus a JSON
manifest (the original format, kept fully read/write compatible):

    trace.ctr/
      manifest.json          # format, interval_s, n_devices, chunk index
      chunk-000000.npz       # {"tpa": (D, S), "clock_mhz": (D, S)}
      ...

**ctr-v2** — ONE appendable file with a footer-indexed chunk table, for
many-small-files-hostile filesystems (one fd per archive however long
the recording runs) and pluggable column codecs (`telemetry.codecs`:
raw / zlib / delta+bitshuffle — the always-on-recording point):

    [8B magic][u32 len][header json]          # immutable geometry
    [chunk blocks ...]                        # codec-encoded columns
    [footer json][u32 crc][u64 len][8B magic] # cumulative chunk table
    [chunk blocks ...]                        # appended after a reopen
    [footer json][u32 crc][u64 len][8B magic] # newer footer wins

Every flush appends new chunk blocks THEN a new footer indexing all
chunks so far — earlier footers are never overwritten, so a recorder
killed mid-append leaves garbage only AFTER the last durable footer and
the archive reopens valid at that footer (readers scan backward for the
newest intact one; a reopening writer truncates the unindexed tail).
Dead footers cost tens of bytes per flush — the v2 analogue of v1's
manifest rewrite.  Reads are mmap-backed: the raw codec decodes as a
zero-copy view over the mapping.

Counters are stored in their NATIVE dtype (the engine emits float32),
with timestamps IMPLICIT: the grid is uniform, so `t0_s`/`interval_s`
plus each chunk's sample offset reconstruct every poll instant exactly —
a multi-day archive spends zero bytes on time or device columns.

Writers are append-only (buffer → full chunk → flush; the index is
rewritten after every flush, so a killed recorder leaves a valid archive
minus its buffered tail).  Readers random-access sample ranges by
decoding only the chunks that span them — peak decoded state is
O(chunk), never O(trace) — and instrument themselves
(`peak_resident_samples`, `chunks_decoded`) so tests can ASSERT the
memory bound instead of trusting it.

`TraceReader(path)` dispatches transparently: a directory opens as v1, a
`CTR2`-magic file as v2.  `write_archive` picks the version from the
path suffix (`.ctr` → v1, `.ctr2` → v2) unless told explicitly.
CSV/JSONL (`source.write_trace`/`read_trace`) remain the interchange
path; `tools/trace_convert.py` converts between all formats.
"""
from __future__ import annotations

import json
import mmap
import os
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional, Union

import numpy as np

from repro_torch.telemetry import codecs as _codecs
from repro_torch.telemetry.scrape import DeviceGrid

MANIFEST_NAME = "manifest.json"
FORMAT_TAG = "ctr-v1"
FORMAT_TAG_V2 = "ctr-v2"
#: directory suffix `_resolve_fmt` sniffs as columnar even before the
#: archive exists (so a writer target can be format-inferred too)
COLUMNAR_SUFFIX = ".ctr"
#: single-file container suffix (ctr-v2)
V2_SUFFIX = ".ctr2"
DEFAULT_CHUNK_SAMPLES = 4096

#: ctr-v2 wire constants — the header magic doubles as the sniff byte
#: sequence for suffix-less files; the footer magic terminates every
#: chunk-table record so readers can walk back to the newest intact one
V2_MAGIC = b"CTR2\x00\x01\r\n"
V2_FOOTER_MAGIC = b"CTR2FTR\n"
_V2_TAIL = 4 + 8 + len(V2_FOOTER_MAGIC)      # crc32 + len + magic


def is_archive(path: str) -> bool:
    """True if path names a columnar trace archive (v1 directory or
    ctr-v2 file)."""
    return os.path.isfile(os.path.join(path, MANIFEST_NAME)) \
        or is_v2_archive(path)


def is_v2_archive(path: str) -> bool:
    """True if path is a ctr-v2 single-file archive (magic sniff)."""
    if not os.path.isfile(path):
        return False
    with open(path, "rb") as fh:
        return fh.read(len(V2_MAGIC)) == V2_MAGIC


def sample_time(t0_s: float, interval_s: float, k: int) -> float:
    """Poll instant of 0-based sample k (window END, matching
    `DeviceGrid.times_s` bit-for-bit: t0 + (k+1)·interval in float64)."""
    return t0_s + (k + 1) * interval_s


def uniform_searchsorted(t0_s: float, interval_s: float, n: int,
                         x: float) -> int:
    """`np.searchsorted(times, x)` over the IMPLICIT uniform times array
    — O(1), no materialization.  Returns the smallest k in [0, n] with
    sample_time(k) >= x (side='left' semantics)."""
    if n <= 0:
        return 0
    # start provably at-or-below the answer, then walk up (float division
    # error is < 1 ulp, so this loop runs at most a few steps)
    k = min(max(int((x - t0_s) / interval_s) - 2, 0), n)
    while k < n and sample_time(t0_s, interval_s, k) < x:
        k += 1
    return k


@dataclass
class ChunkInfo:
    """One v1 chunk's manifest entry."""

    file: str
    t0_s: float                  # absolute start of the chunk's first window
    n_samples: int


@dataclass
class ChunkInfoV2:
    """One ctr-v2 chunk's footer entry: where its two codec-encoded
    column blocks live in the file."""

    offset: int                  # absolute file offset of the tpa block
    t0_s: float
    n_samples: int
    codec: str                   # codec tag both blocks were written with
    tpa_nbytes: int
    clk_nbytes: int


def _check(cond: bool, path: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"corrupt trace archive {path!r}: {msg}")


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------
class _ChunkedWriterBase:
    """Shared buffered-append machinery for both archive versions.

    Samples accumulate in a buffer; full `chunk_samples`-column chunks
    flush through `_emit_chunk` and the index is rewritten by `_commit`,
    so the on-disk archive is valid after every flush.  Use as a context
    manager (`close()` flushes the final partial chunk).

    `append(tpa, clock_mhz)` takes aligned `(n_devices,)` or
    `(n_devices, s)` counter columns; `append_grid(grid)` additionally
    enforces that the grid CONTINUES the archive (same interval and
    device count, `t0_s` equal to the archive's current end) — the shape
    a `poll()`-driven recorder produces round after round.

    `append=True` reopens an existing archive and continues it (the
    restart path for a long-lived recorder).
    """

    def __init__(self, path: str, interval_s: float, n_devices: int, *,
                 chunk_samples: int = DEFAULT_CHUNK_SAMPLES,
                 t0_s: float = 0.0):
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s} must be positive")
        if n_devices < 1:
            raise ValueError(f"n_devices={n_devices} must be >= 1")
        if chunk_samples < 1:
            raise ValueError(f"chunk_samples={chunk_samples} must be >= 1")
        self.path = str(path)
        self.interval_s = float(interval_s)
        self.n_devices = int(n_devices)
        self.chunk_samples = int(chunk_samples)
        self.t0_s = float(t0_s)
        self.chunks: list = []
        self.n_samples = 0           # flushed samples (excludes the buffer)
        self._buf: list = []
        self._buffered = 0
        self._dtype = None
        self._closed = False

    # -- version hooks --------------------------------------------------
    def _emit_chunk(self, tpa: np.ndarray, clk: np.ndarray) -> None:
        """Write one full chunk and record its index entry."""
        raise NotImplementedError

    def _commit(self) -> None:
        """Make everything emitted so far durable (manifest/footer)."""
        raise NotImplementedError

    def _on_close(self) -> None:
        """Release version-specific resources (file handles)."""

    # -- recording ------------------------------------------------------
    @property
    def total_samples(self) -> int:
        """Flushed + buffered samples (what close() will have written)."""
        return self.n_samples + self._buffered

    @property
    def end_s(self) -> float:
        """Absolute time the archive will cover through after close()."""
        return sample_time(self.t0_s, self.interval_s,
                           self.total_samples - 1) \
            if self.total_samples else self.t0_s

    def append(self, tpa: np.ndarray, clock_mhz: np.ndarray) -> None:
        """Append aligned counter columns: (n_devices,) or (n_devices, s)."""
        if self._closed:
            raise ValueError(f"{type(self).__name__} is closed")
        tpa = np.atleast_2d(np.asarray(tpa).T).T   # (D,) -> (D, 1)
        clk = np.atleast_2d(np.asarray(clock_mhz).T).T
        if tpa.shape != clk.shape or tpa.shape[0] != self.n_devices:
            raise ValueError(
                f"misaligned append: tpa {tpa.shape} / clock {clk.shape} "
                f"vs n_devices={self.n_devices}")
        if tpa.shape[1] == 0:
            return
        want = np.result_type(tpa, clk)
        if self._dtype is None:
            self._dtype = want
        elif not np.can_cast(want, self._dtype, casting="safe"):
            # never quantize silently: a float64 append into a float32
            # archive would corrupt the exact-roundtrip contract
            raise ValueError(
                f"cannot append {want} samples to a "
                f"{np.dtype(self._dtype).name} archive without losing "
                "precision; write a new archive at the wider dtype")
        self._buf.append((tpa.astype(self._dtype, copy=False),
                          clk.astype(self._dtype, copy=False)))
        self._buffered += tpa.shape[1]
        if self._buffered >= self.chunk_samples:
            self._drain()

    def append_grid(self, grid: DeviceGrid) -> None:
        """Append a DeviceGrid that CONTINUES the archive exactly."""
        if grid.tpa.shape[1] == 0:
            return
        tol = 1e-6 * self.interval_s
        if abs(grid.interval_s - self.interval_s) > tol:
            raise ValueError(
                f"grid interval {grid.interval_s}s does not match archive "
                f"interval {self.interval_s}s")
        if grid.n_devices != self.n_devices:
            raise ValueError(f"grid has {grid.n_devices} devices, archive "
                             f"has {self.n_devices}")
        if abs(grid.t0_s - self.end_s) > tol:
            raise ValueError(
                f"grid t0_s={grid.t0_s}s does not continue the archive "
                f"(current end {self.end_s}s) — archives must be gapless "
                "so timestamps stay implicit")
        self.append(grid.tpa, grid.clock_mhz)

    def _drain(self, final: bool = False) -> None:
        """Flush every full chunk in the buffer (all of it when final).

        One concatenation per drain, then sliced chunk writes — each
        sample is copied O(1) times however large the one-shot append
        was, instead of re-concatenating the shrinking tail per chunk.
        The index is committed once per drain; chunk data written
        before a crash mid-drain is simply not indexed yet (v1
        overwrites it on the next run, v2 truncates it on reopen).
        """
        if not self._buffered:
            return
        tpa = self._buf[0][0] if len(self._buf) == 1 \
            else np.concatenate([t for t, _ in self._buf], axis=1)
        clk = self._buf[0][1] if len(self._buf) == 1 \
            else np.concatenate([c for _, c in self._buf], axis=1)
        pos = 0
        while self._buffered - pos >= self.chunk_samples \
                or (final and self._buffered > pos):
            take = min(self.chunk_samples, self._buffered - pos)
            self._emit_chunk(tpa[:, pos:pos + take],
                             clk[:, pos:pos + take])
            self.n_samples += take
            pos += take
        self._buf = [(tpa[:, pos:], clk[:, pos:])] if pos < self._buffered \
            else []
        self._buffered -= pos
        self._commit()

    def flush(self, *, partial: bool = False) -> None:
        """Flush buffered samples and rewrite the index, keeping the
        writer open.

        With `partial=False` only full chunks are written (what `append`
        already does opportunistically) — this just forces the index
        rewrite.  `partial=True` also writes the buffered tail as a short
        chunk: the crash-safety point for a recording daemon.  After
        `flush(partial=True)` a kill loses NOTHING already appended — the
        on-disk archive replays through `TraceReplaySource` up to the
        flush, and later appends simply continue in new chunks (chunk
        sizes may vary; readers only require contiguity).
        """
        if self._closed:
            raise ValueError(f"{type(self).__name__} is closed")
        if self._buffered:
            self._drain(final=partial)
        else:
            self._commit()

    def close(self) -> None:
        if self._closed:
            return
        if self._buffered:
            self._drain(final=True)
        else:
            self._commit()              # valid even with zero samples
        self._closed = True
        self._on_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TraceWriter(_ChunkedWriterBase):
    """Append-only ctr-v1 recorder: npz chunk files + JSON manifest,
    rewritten after every flush so a killed recorder leaves a valid
    archive minus its buffered tail."""

    def __init__(self, path: str, interval_s: float, n_devices: int, *,
                 chunk_samples: int = DEFAULT_CHUNK_SAMPLES,
                 t0_s: float = 0.0, append: bool = False):
        super().__init__(path, interval_s, n_devices,
                         chunk_samples=chunk_samples, t0_s=t0_s)
        if append and is_archive(self.path):
            rd = TraceReader(self.path)
            if rd.interval_s != self.interval_s \
                    or rd.n_devices != self.n_devices:
                raise ValueError(
                    f"cannot append to {path!r}: archive has "
                    f"interval_s={rd.interval_s}/n_devices={rd.n_devices}, "
                    f"writer asked for {self.interval_s}/{self.n_devices}")
            self.t0_s = rd.t0_s
            self.chunks = list(rd.chunks)
            self.n_samples = rd.n_samples
            self._dtype = rd.dtype
        elif is_archive(self.path):
            raise ValueError(f"{path!r} is already a trace archive; pass "
                             "append=True to continue it")
        os.makedirs(self.path, exist_ok=True)

    def _emit_chunk(self, tpa: np.ndarray, clk: np.ndarray) -> None:
        name = f"chunk-{len(self.chunks):06d}.npz"
        np.savez_compressed(os.path.join(self.path, name),
                            tpa=tpa, clock_mhz=clk)
        self.chunks.append(ChunkInfo(
            name, sample_time(self.t0_s, self.interval_s,
                              self.n_samples - 1), tpa.shape[1]))

    def _commit(self) -> None:
        manifest = {
            "format": FORMAT_TAG,
            "interval_s": self.interval_s,
            "n_devices": self.n_devices,
            "t0_s": self.t0_s,
            "dtype": np.dtype(self._dtype or np.float64).name,
            "chunk_samples": self.chunk_samples,
            "n_samples": self.n_samples,
            "chunks": [{"file": c.file, "t0_s": c.t0_s,
                        "n_samples": c.n_samples} for c in self.chunks],
        }
        tmp = os.path.join(self.path, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, indent=1)
            fh.write("\n")
        os.replace(tmp, os.path.join(self.path, MANIFEST_NAME))


class TraceWriterV2(_ChunkedWriterBase):
    """Append-only ctr-v2 recorder: one file, codec-encoded chunk
    blocks, a cumulative footer per flush.

    `codec` picks the column codec for NEW chunks (`"auto"` → the best
    always-available one, delta+bitshuffle; see `telemetry.codecs`).
    Appending to an existing archive may use a different codec — every
    chunk carries its own tag.

    Durability contract: earlier footers are never overwritten, so the
    newest INTACT footer always indexes a valid prefix.  A crash between
    chunk emission and the footer write leaves unindexed bytes that the
    next `append=True` open truncates away.
    """

    def __init__(self, path: str, interval_s: float, n_devices: int, *,
                 chunk_samples: int = DEFAULT_CHUNK_SAMPLES,
                 t0_s: float = 0.0, append: bool = False,
                 codec: Optional[str] = "auto"):
        super().__init__(path, interval_s, n_devices,
                         chunk_samples=chunk_samples, t0_s=t0_s)
        self.codec = _codecs.get_codec(codec)
        if append and is_v2_archive(self.path):
            rd = TraceReaderV2(self.path)
            try:
                if rd.interval_s != self.interval_s \
                        or rd.n_devices != self.n_devices:
                    raise ValueError(
                        f"cannot append to {path!r}: archive has "
                        f"interval_s={rd.interval_s}/"
                        f"n_devices={rd.n_devices}, writer asked for "
                        f"{self.interval_s}/{self.n_devices}")
                self.t0_s = rd.t0_s
                self.chunks = list(rd.chunks)
                self.n_samples = rd.n_samples
                if rd.n_samples:
                    self._dtype = rd.dtype
                data_end = rd.footer_end
            finally:
                rd.close()
            self._fh = open(self.path, "r+b")
            # drop any unindexed tail a crashed writer left behind
            self._fh.truncate(data_end)
            self._fh.seek(data_end)
        elif is_v2_archive(self.path):
            raise ValueError(f"{path!r} is already a trace archive; pass "
                             "append=True to continue it")
        else:
            self._fh = open(self.path, "wb")
            header = json.dumps({
                "format": FORMAT_TAG_V2,
                "interval_s": self.interval_s,
                "n_devices": self.n_devices,
                "t0_s": self.t0_s,
                "chunk_samples": self.chunk_samples,
            }, sort_keys=True, separators=(",", ":")).encode()
            self._fh.write(V2_MAGIC)
            self._fh.write(np.uint32(len(header)).tobytes())
            self._fh.write(header)

    def _emit_chunk(self, tpa: np.ndarray, clk: np.ndarray) -> None:
        tb = self.codec.encode(tpa)
        cb = self.codec.encode(clk)
        off = self._fh.tell()
        self._fh.write(tb)
        self._fh.write(cb)
        self.chunks.append(ChunkInfoV2(
            off, sample_time(self.t0_s, self.interval_s,
                             self.n_samples - 1),
            tpa.shape[1], self.codec.name, len(tb), len(cb)))

    def _commit(self) -> None:
        footer = json.dumps({
            "format": FORMAT_TAG_V2,
            "interval_s": self.interval_s,
            "n_devices": self.n_devices,
            "t0_s": self.t0_s,
            "dtype": np.dtype(self._dtype or np.float64).name,
            "chunk_samples": self.chunk_samples,
            "n_samples": self.n_samples,
            "chunks": [{"off": c.offset, "t0_s": c.t0_s,
                        "n": c.n_samples, "codec": c.codec,
                        "tb": c.tpa_nbytes, "cb": c.clk_nbytes}
                       for c in self.chunks],
        }, sort_keys=True, separators=(",", ":")).encode()
        self._fh.write(footer)
        self._fh.write(np.uint32(zlib.crc32(footer)).tobytes())
        self._fh.write(np.uint64(len(footer)).tobytes())
        self._fh.write(V2_FOOTER_MAGIC)
        self._fh.flush()

    def _on_close(self) -> None:
        self._fh.close()


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------
class _ArchiveReaderBase:
    """Shared random-access machinery over a validated chunk index.

    Subclasses populate geometry (`interval_s`, `n_devices`, `t0_s`,
    `dtype`, `chunks`, `n_samples`) and implement `_load_chunk(k)`; this
    base provides range reads decoding only the spanning chunks (with a
    one-chunk cache for boundary-crossing polls), chunk streaming, and
    the residency instrumentation tests assert against.
    """

    path: str
    interval_s: float
    n_devices: int
    t0_s: float
    dtype: np.dtype
    chunks: list
    n_samples: int

    def _init_index(self) -> None:
        """Call after `chunks` is final: builds the sample-offset index
        and zeroes the instrumentation counters."""
        #: chunk k covers global samples [_starts[k], _starts[k+1])
        self._starts = np.concatenate(
            [[0], np.cumsum([c.n_samples for c in self.chunks])]).astype(int)
        self._cache: Optional[tuple] = None    # (chunk_idx, tpa, clk)
        self.chunks_decoded = 0
        self.peak_resident_samples = 0

    def _load_chunk(self, k: int) -> tuple:
        """Decode chunk k to (tpa, clk) arrays of the manifest shape."""
        raise NotImplementedError

    # -- geometry -------------------------------------------------------
    @property
    def duration_s(self) -> float:
        return self.n_samples * self.interval_s

    @property
    def end_s(self) -> float:
        """Poll instant of the last sample (== t0_s for an empty archive)."""
        return sample_time(self.t0_s, self.interval_s, self.n_samples - 1) \
            if self.n_samples else self.t0_s

    def chunk_start(self, k: int) -> int:
        """Global index of chunk k's first sample."""
        return int(self._starts[k])

    def searchsorted(self, x: float) -> int:
        """Global index of the first sample whose poll instant is >= x."""
        return uniform_searchsorted(self.t0_s, self.interval_s,
                                    self.n_samples, x)

    # -- decoding -------------------------------------------------------
    def _decode(self, k: int) -> tuple:
        if self._cache is not None and self._cache[0] == k:
            return self._cache[1], self._cache[2]
        tpa, clk = self._load_chunk(k)
        want = (self.n_devices, self.chunks[k].n_samples)
        _check(tpa.shape == want and clk.shape == want, self.path,
               f"chunk #{k} arrays are {tpa.shape}/{clk.shape}, "
               f"{self._index_name} says {want}")
        self.chunks_decoded += 1
        self._cache = (k, tpa, clk)
        return tpa, clk

    def read_samples(self, i0: int, i1: int) -> tuple:
        """(tpa, clock_mhz) for global samples [i0, i1) — decodes only
        the spanning chunks."""
        i0 = max(int(i0), 0)
        i1 = min(int(i1), self.n_samples)
        if i1 <= i0:
            shape = (self.n_devices, 0)
            return (np.empty(shape, self.dtype), np.empty(shape, self.dtype))
        k0 = int(np.searchsorted(self._starts, i0, side="right")) - 1
        k1 = int(np.searchsorted(self._starts, i1, side="left"))
        parts_t, parts_c, resident = [], [], 0
        for k in range(k0, k1):
            tpa, clk = self._decode(k)
            lo = i0 - self.chunk_start(k)
            hi = i1 - self.chunk_start(k)
            parts_t.append(tpa[:, max(lo, 0):hi])
            parts_c.append(clk[:, max(lo, 0):hi])
            resident += self.chunks[k].n_samples * self.n_devices
        self.peak_resident_samples = max(self.peak_resident_samples,
                                         resident)
        if len(parts_t) == 1:
            return parts_t[0], parts_c[0]
        return (np.concatenate(parts_t, axis=1),
                np.concatenate(parts_c, axis=1))

    # -- streaming / batch views ---------------------------------------
    def iter_chunks(self, start_s: Optional[float] = None,
                    stop_s: Optional[float] = None) -> Iterator[DeviceGrid]:
        """Stream the archive chunk by chunk as `DeviceGrid`s (whole
        chunks whose time span overlaps [start_s, stop_s]; use
        `read_samples` for exact sub-chunk slicing)."""
        for k, info in enumerate(self.chunks):
            lo = sample_time(self.t0_s, self.interval_s,
                             self.chunk_start(k))
            hi = sample_time(self.t0_s, self.interval_s,
                             self.chunk_start(k) + info.n_samples - 1)
            if (stop_s is not None and lo > stop_s) \
                    or (start_s is not None and hi < start_s):
                continue
            tpa, clk = self._decode(k)
            self.peak_resident_samples = max(
                self.peak_resident_samples,
                info.n_samples * self.n_devices)
            yield DeviceGrid(self.interval_s, tpa, clk, t0_s=info.t0_s)

    def read_all(self) -> DeviceGrid:
        """Materialize the whole archive (the batch `scrapes()` view —
        O(trace) memory by definition; prefer iter_chunks/read_samples
        for long archives)."""
        if not self.n_samples:
            return DeviceGrid(self.interval_s,
                              np.empty((self.n_devices, 0), self.dtype),
                              np.empty((self.n_devices, 0), self.dtype),
                              t0_s=self.t0_s)
        tpa, clk = self.read_samples(0, self.n_samples)
        return DeviceGrid(self.interval_s, tpa, clk, t0_s=self.t0_s)

    def summary(self) -> str:
        span_h = self.duration_s / 3600.0
        return (f"{self._summary_tag} devices={self.n_devices} "
                f"samples={self.n_samples} interval={self.interval_s:g}s "
                f"span={span_h:.2f}h chunks={len(self.chunks)} "
                f"dtype={self.dtype.name}{self._summary_extra()}")

    _summary_tag = "ctr_archive"
    _index_name = "manifest"     # what the chunk table is called in errors

    def _summary_extra(self) -> str:
        return ""


class TraceReaderV1(_ArchiveReaderBase):
    """Random-access view over a v1 archive directory; loads O(chunk)
    at a time.

    The manifest is validated up front (format tag, chunk contiguity,
    file presence, sample-count consistency) so a truncated or
    hand-edited archive fails loudly at open, not as silently wrong
    replay.
    """

    def __init__(self, path: str):
        self.path = str(path)
        mf = os.path.join(self.path, MANIFEST_NAME)
        if not os.path.isfile(mf):
            raise ValueError(f"{self.path!r} is not a columnar trace "
                             f"archive (no {MANIFEST_NAME})")
        try:
            with open(mf) as fh:
                m = json.load(fh)
        except json.JSONDecodeError as e:
            raise ValueError(f"corrupt trace archive {self.path!r}: "
                             f"unreadable manifest ({e})") from e
        _check(isinstance(m, dict) and m.get("format") == FORMAT_TAG,
               self.path, f"manifest format is {m.get('format')!r}, "
               f"expected {FORMAT_TAG!r}")
        for key in ("interval_s", "n_devices", "t0_s", "n_samples",
                    "chunks"):
            _check(key in m, self.path, f"manifest missing key {key!r}")
        self.interval_s = float(m["interval_s"])
        _check(self.interval_s > 0, self.path,
               f"interval_s={self.interval_s} must be positive")
        self.n_devices = int(m["n_devices"])
        self.t0_s = float(m["t0_s"])
        self.dtype = np.dtype(m.get("dtype", "float64"))
        self.chunks = []
        cum = 0
        tol = 1e-6 * self.interval_s
        for k, c in enumerate(m["chunks"]):
            _check(isinstance(c, dict)
                   and all(f in c for f in ("file", "t0_s", "n_samples")),
                   self.path, f"malformed chunk entry #{k}: {c!r}")
            info = ChunkInfo(str(c["file"]), float(c["t0_s"]),
                             int(c["n_samples"]))
            _check(info.n_samples > 0, self.path,
                   f"chunk {info.file!r} has n_samples={info.n_samples}")
            _check(os.path.isfile(os.path.join(self.path, info.file)),
                   self.path, f"chunk file {info.file!r} is missing")
            want_t0 = sample_time(self.t0_s, self.interval_s, cum - 1)
            _check(abs(info.t0_s - want_t0) <= tol, self.path,
                   f"chunk {info.file!r} starts at {info.t0_s}s, expected "
                   f"{want_t0}s (chunks must be contiguous)")
            self.chunks.append(info)
            cum += info.n_samples
        self.n_samples = int(m["n_samples"])
        _check(self.n_samples == cum, self.path,
               f"manifest n_samples={self.n_samples} but chunks hold {cum}")
        self._init_index()

    def _load_chunk(self, k: int) -> tuple:
        info = self.chunks[k]
        with np.load(os.path.join(self.path, info.file)) as z:
            _check("tpa" in z and "clock_mhz" in z, self.path,
                   f"chunk {info.file!r} is missing counter arrays")
            return z["tpa"], z["clock_mhz"]


class TraceReaderV2(_ArchiveReaderBase):
    """Random-access view over a ctr-v2 single-file archive.

    The file is mmap'd once; chunk decodes slice the mapping (the raw
    codec yields zero-copy read-only views).  The newest INTACT footer
    wins: a crash-truncated tail is skipped by walking the footer magic
    backward, so an archive is readable up to its last durable flush.
    `footer_end` is where that footer ends — the append point a
    reopening writer truncates to.
    """

    _summary_tag = "ctr2_archive"
    _index_name = "footer"

    def __init__(self, path: str):
        self.path = str(path)
        if not os.path.isfile(self.path):
            raise ValueError(f"{self.path!r} is not a ctr-v2 trace "
                             "archive (no such file)")
        self._fh = open(self.path, "rb")
        try:
            self._mm = mmap.mmap(self._fh.fileno(), 0,
                                 access=mmap.ACCESS_READ)
        except ValueError as e:
            self._fh.close()
            raise ValueError(f"corrupt trace archive {self.path!r}: "
                             f"cannot map ({e})") from e
        try:
            self._parse()
        except Exception:
            self.close()
            raise

    def _parse(self) -> None:
        mm = self._mm
        _check(mm[:len(V2_MAGIC)] == V2_MAGIC, self.path,
               f"bad magic (not a {FORMAT_TAG_V2} file)")
        hoff = len(V2_MAGIC)
        _check(len(mm) >= hoff + 4, self.path, "truncated header")
        hlen = int(np.frombuffer(mm[hoff:hoff + 4], np.uint32)[0])
        _check(len(mm) >= hoff + 4 + hlen, self.path, "truncated header")
        try:
            header = json.loads(mm[hoff + 4:hoff + 4 + hlen].decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"corrupt trace archive {self.path!r}: "
                             f"unreadable header ({e})") from e
        _check(header.get("format") == FORMAT_TAG_V2, self.path,
               f"header format is {header.get('format')!r}, expected "
               f"{FORMAT_TAG_V2!r}")
        self._data_start = hoff + 4 + hlen

        footer, self.footer_end = self._find_footer()
        for key in ("interval_s", "n_devices", "t0_s", "n_samples",
                    "chunks", "dtype"):
            _check(key in footer, self.path,
                   f"footer missing key {key!r}")
        self.interval_s = float(footer["interval_s"])
        _check(self.interval_s > 0, self.path,
               f"interval_s={self.interval_s} must be positive")
        self.n_devices = int(footer["n_devices"])
        _check(self.n_devices >= 1, self.path,
               f"n_devices={self.n_devices} must be >= 1")
        self.t0_s = float(footer["t0_s"])
        self.dtype = np.dtype(footer["dtype"])
        # header/footer geometry must agree — a footer from some OTHER
        # archive spliced onto this file is rejected, not trusted
        for key in ("interval_s", "n_devices", "t0_s"):
            _check(float(header.get(key, footer[key]))
                   == float(footer[key]), self.path,
                   f"header/footer disagree on {key}")
        self.chunks = []
        cum = 0
        tol = 1e-6 * self.interval_s
        for k, c in enumerate(footer["chunks"]):
            _check(isinstance(c, dict)
                   and all(f in c for f in ("off", "t0_s", "n", "codec",
                                            "tb", "cb")),
                   self.path, f"malformed chunk entry #{k}: {c!r}")
            info = ChunkInfoV2(int(c["off"]), float(c["t0_s"]),
                               int(c["n"]), str(c["codec"]),
                               int(c["tb"]), int(c["cb"]))
            _check(info.n_samples > 0, self.path,
                   f"chunk #{k} has n_samples={info.n_samples}")
            _check(self._data_start <= info.offset
                   and info.offset + info.tpa_nbytes + info.clk_nbytes
                   <= len(self._mm), self.path,
                   f"chunk #{k} block [{info.offset}, "
                   f"+{info.tpa_nbytes + info.clk_nbytes}) is out of "
                   "bounds")
            want_t0 = sample_time(self.t0_s, self.interval_s, cum - 1)
            _check(abs(info.t0_s - want_t0) <= tol, self.path,
                   f"chunk #{k} starts at {info.t0_s}s, expected "
                   f"{want_t0}s (chunks must be contiguous)")
            self.chunks.append(info)
            cum += info.n_samples
        self.n_samples = int(footer["n_samples"])
        _check(self.n_samples == cum, self.path,
               f"footer n_samples={self.n_samples} but chunks hold {cum}")
        self._init_index()

    def _try_footer(self, end: int):
        """Validate a footer whose magic ends at byte `end`; returns the
        parsed dict or None."""
        if end - _V2_TAIL < self._data_start:
            return None
        tail = self._mm[end - _V2_TAIL:end]
        if tail[-len(V2_FOOTER_MAGIC):] != V2_FOOTER_MAGIC:
            return None
        flen = int(np.frombuffer(tail[4:12], np.uint64)[0])
        crc = int(np.frombuffer(tail[:4], np.uint32)[0])
        start = end - _V2_TAIL - flen
        if start < self._data_start:
            return None
        blob = self._mm[start:end - _V2_TAIL]
        if zlib.crc32(blob) != crc:
            return None
        try:
            footer = json.loads(blob.decode())
        except (UnicodeDecodeError, json.JSONDecodeError):
            return None
        if not isinstance(footer, dict) \
                or footer.get("format") != FORMAT_TAG_V2:
            return None
        return footer

    def _find_footer(self) -> tuple:
        """Newest intact footer: try EOF first (the no-crash fast path),
        then walk the footer magic backward past any torn tail."""
        pos = len(self._mm)
        footer = self._try_footer(pos)
        if footer is not None:
            return footer, pos
        while pos > self._data_start:
            idx = self._mm.rfind(V2_FOOTER_MAGIC, self._data_start,
                                 pos - 1)
            if idx < 0:
                break
            pos = idx + len(V2_FOOTER_MAGIC)
            footer = self._try_footer(pos)
            if footer is not None:
                return footer, pos
            pos = idx  # torn footer: keep walking back
        raise ValueError(f"corrupt trace archive {self.path!r}: no "
                         "intact footer (file truncated before the "
                         "first flush completed?)")

    def _load_chunk(self, k: int) -> tuple:
        info = self.chunks[k]
        codec = _codecs.get_codec(info.codec)
        shape = (self.n_devices, info.n_samples)
        lo = info.offset
        mid = lo + info.tpa_nbytes
        hi = mid + info.clk_nbytes
        tpa = codec.decode(self._mm[lo:mid], self.dtype, shape)
        clk = codec.decode(self._mm[mid:hi], self.dtype, shape)
        return tpa, clk

    def _summary_extra(self) -> str:
        tags = sorted({c.codec for c in self.chunks})
        return f" codecs={','.join(tags) if tags else '-'}"

    def close(self) -> None:
        """Release the mapping and file handle (readers are also closed
        by GC; call this for deterministic cleanup, e.g. on Windows)."""
        if getattr(self, "_mm", None) is not None:
            self._mm.close()
            self._mm = None
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
            self._fh = None


def TraceReader(path: str) -> Union[TraceReaderV1, TraceReaderV2]:
    """Open a columnar archive, dispatching on its format: a directory
    with a manifest reads as ctr-v1, a `CTR2`-magic file as ctr-v2."""
    if os.path.isdir(path):
        return TraceReaderV1(path)
    if os.path.isfile(path):
        return TraceReaderV2(path)
    raise ValueError(f"{path!r} is not a columnar trace archive "
                     "(neither a v1 directory nor a ctr-v2 file)")


# ---------------------------------------------------------------------------
# One-shot helpers (the write_trace/read_trace dispatch targets)
# ---------------------------------------------------------------------------
def write_archive(grid: DeviceGrid, path: str, *,
                  chunk_samples: int = DEFAULT_CHUNK_SAMPLES,
                  codec: Optional[str] = None,
                  version: Optional[int] = None) -> None:
    """One-shot archive write of a DeviceGrid.

    `version=None` infers from the path: `.ctr2` writes the single-file
    ctr-v2 container, anything else the v1 directory.  `codec` selects
    the v2 column codec (v1 is always npz and rejects one).
    """
    if grid.n_devices < 1 or grid.interval_s <= 0:
        # e.g. the empty grid read_trace returns for a header-only CSV:
        # row formats round-trip it, but an archive needs real geometry
        raise ValueError(
            f"cannot write a columnar archive from an empty/degenerate "
            f"trace ({grid.n_devices} devices, interval "
            f"{grid.interval_s}s); keep empty traces in CSV/JSONL")
    if version is None:
        version = 2 if str(path).lower().endswith(V2_SUFFIX) else 1
    if version == 1:
        if codec not in (None, "auto"):
            raise ValueError(
                f"codec={codec!r} is a ctr-v2 feature; v1 archives are "
                "always npz chunks (write a .ctr2 path or pass "
                "version=2)")
        with TraceWriter(path, grid.interval_s, grid.n_devices,
                         chunk_samples=chunk_samples, t0_s=grid.t0_s) as w:
            w.append(grid.tpa, grid.clock_mhz)
    elif version == 2:
        with TraceWriterV2(path, grid.interval_s, grid.n_devices,
                           chunk_samples=chunk_samples, t0_s=grid.t0_s,
                           codec=codec) as w:
            w.append(grid.tpa, grid.clock_mhz)
    else:
        raise ValueError(f"unknown archive version {version!r} "
                         "(want 1 or 2)")


def read_archive(path: str,
                 interval_s: Optional[float] = None) -> DeviceGrid:
    """One-shot archive read (the `read_trace` dispatch target)."""
    rd = TraceReader(path)
    try:
        if interval_s is not None \
                and abs(interval_s - rd.interval_s) > 1e-6 * rd.interval_s:
            raise ValueError(
                f"explicit interval_s={interval_s} contradicts the "
                f"archive ({rd.interval_s}s) — columnar archives carry "
                "their own interval")
        return rd.read_all()
    finally:
        if isinstance(rd, TraceReaderV2):
            rd.close()


def archive_nbytes(path: str) -> int:
    """Total on-disk size of an archive (v1 directory or v2 file)."""
    if os.path.isdir(path):
        return sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
    return os.path.getsize(path)
