"""The port's storage and source layer (`repro_torch.telemetry`:
codecs, tracestore, source) against the JAX package's.

The CPU half of the reference's `test_codecs.py`, `test_tracestore.py`,
`test_trace_golden.py` and `test_telemetry_source.py`, run on the port
(sources simulate with `device="cpu"`; the port's `simulate_devices`
returns float32 tensors, so the data-making helper below copies them to
host NumPy, the form archives and row traces take), then parity cases
that feed both packages the same seeded inputs: codec bytes, archive
bytes, the golden fixtures (`golden_rollup.fru2` included) read through
both, and the two engines' `SimulatorSource` draws compared
statistically at `test_torch_engine.py`'s tolerances.
"""
import json
from dataclasses import dataclass
import os
import struct
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from _propcheck import given, settings, st  # noqa: E402

torch = pytest.importorskip("torch")

import repro.fleet.streaming as R_streaming  # noqa: E402
import repro.telemetry as R_telemetry  # noqa: E402
import repro.telemetry.codecs as R_codecs  # noqa: E402
import repro.telemetry.tracestore as R_ts  # noqa: E402
from repro.fleet import wire as R_wire  # noqa: E402
from repro_torch.fleet import wire  # noqa: E402
from repro_torch.fleet.divergence import analyze_rollup  # noqa: E402
from repro_torch.fleet.engine import simulate_devices as _simulate_devices  # noqa: E402
from repro_torch.fleet.regression import scan_rollup  # noqa: E402
from repro_torch.fleet.streaming import StreamingRollup  # noqa: E402
from repro_torch.telemetry import (BackendSource, DeviceGrid, Event,  # noqa: E402
                                   SimulatedDeviceBackend, StepProfile,
                                   TraceReader, TraceReplaySource,
                                   TraceWriter, read_trace, scrape,
                                   write_trace)
from repro_torch.telemetry import codecs  # noqa: E402
from repro_torch.telemetry import tracestore as ts  # noqa: E402
from repro_torch.telemetry.source import SimulatorSource as _SimulatorSource  # noqa: E402
from repro_torch.telemetry.tracestore import (archive_nbytes,  # noqa: E402
                                              uniform_searchsorted,
                                              write_archive)


@dataclass
class SimulatorSource(_SimulatorSource):
    """The port's source on the CPU (it defaults to the card)."""

    device: object = "cpu"


def simulate_devices(*args, **kw):
    """The port's engine on the CPU, its grid copied to host NumPy: the
    reference tests use it to make data for traces and archives."""
    kw.setdefault("device", "cpu")
    g = _simulate_devices(*args, **kw)
    return DeviceGrid(g.interval_s, g.tpa.numpy(), g.clock_mhz.numpy(),
                      t0_s=g.t0_s)


def _convert(src, dst, *, chunk_samples, codec=None):
    """`tools/trace_convert.py`'s convert() on the port's API: read one
    format, write another."""
    write_trace(read_trace(src), dst, chunk_samples=chunk_samples,
                codec=codec)


# ===========================================================================
# test_codecs.py: Codec + ctr-v2 container properties: encode/
# ===========================================================================
DTYPES = ["float32", "float64", "int32", "uint16", "int64"]

#: special float bit patterns the transform must carry UNCHANGED
SPECIALS = [np.nan, np.inf, -np.inf, -0.0, 0.0,
            np.finfo(np.float32).tiny, np.finfo(np.float32).max]


def _column(rng, dtype, d, s):
    """A (d, s) column of `dtype` mixing smooth series, noise and (for
    floats) special values — the adversarial recording."""
    dt = np.dtype(dtype)
    if dt.kind == "f":
        base = np.cumsum(rng.standard_normal((d, s)), axis=1) * 0.01
        arr = base.astype(dt)
        n_spec = min(s * d // 4, 16)
        if n_spec:
            flat = arr.ravel()
            idx = rng.choice(flat.size, size=n_spec, replace=False)
            flat[idx] = rng.choice(SPECIALS, size=n_spec)
        return arr
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=(d, s),
                        endpoint=True).astype(dt)


@settings(max_examples=60, deadline=None)
@given(st.integers(min_value=1, max_value=5),
       st.integers(min_value=0, max_value=70),
       st.sampled_from(DTYPES),
       st.sampled_from(codecs.codec_names()),
       st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_codec_roundtrip_is_bit_exact(d, s, dtype, name, seed):
    arr = _column(np.random.default_rng(seed), dtype, d, s)
    codec = codecs.get_codec(name)
    blob = codec.encode(arr)
    out = codec.decode(blob, arr.dtype, arr.shape)
    assert out.dtype == arr.dtype and out.shape == arr.shape
    # bit identity, not value closeness: NaN != NaN but its BYTES match
    assert out.tobytes() == arr.tobytes(), (name, dtype, arr.shape)


@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=0, max_value=300),
       st.sampled_from([2, 4, 8]),
       st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_bit_transpose_inverts(n, itemsize, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2 ** (8 * itemsize), size=n,
                     dtype=f"u{itemsize}")
    back = codecs.bit_untranspose(codecs.bit_transpose(u), n, itemsize)
    assert back.tobytes() == u.tobytes()


def test_codec_registry_contract():
    assert codecs.DEFAULT_CODEC in codecs.codec_names()
    assert codecs.get_codec(None).name == codecs.DEFAULT_CODEC
    assert codecs.get_codec("auto").name == codecs.DEFAULT_CODEC
    assert codecs.get_codec("dbz").name.startswith("dbz-")
    with pytest.raises(ValueError, match="unknown codec"):
        codecs.get_codec("lz4-fantasy")
    if not codecs.HAVE_ZSTD:
        with pytest.raises(ValueError, match="zstandard"):
            codecs.get_codec("dbz-zstd")
        with pytest.raises(ValueError, match="zstandard"):
            codecs.DeltaBitshuffleCodec("zstd")
    with pytest.raises(ValueError, match="codec supports"):
        codecs.get_codec("dbz-zlib").encode(
            np.zeros((2, 3), dtype=np.uint8))


def _codec_grid(seed=5, d=3, s=137, dtype=np.float32, interval=30.0, t0=0.0):
    rng = np.random.default_rng(seed)
    clk = rng.uniform(900.0, 1500.0, size=(d, s)).astype(dtype)
    return DeviceGrid(interval, _column(rng, dtype, d, s), clk, t0_s=t0)


@settings(max_examples=12, deadline=None)
@given(st.sampled_from(codecs.codec_names()),
       st.integers(min_value=1, max_value=64),
       st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_v2_archive_roundtrip_any_codec_and_chunking(name, chunk, seed):
    import tempfile
    grid = _codec_grid(seed=seed, s=1 + seed % 150)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "a.ctr2")
        ts.write_archive(grid, path, chunk_samples=chunk, codec=name)
        back = ts.read_archive(path)
    assert back.tpa.tobytes() == grid.tpa.tobytes()
    assert back.clock_mhz.tobytes() == grid.clock_mhz.tobytes()
    assert back.interval_s == grid.interval_s and back.t0_s == grid.t0_s


def test_v1_v2_conversion_is_byte_exact(tmp_path):
    """csv -> v1 -> v2 -> v1 through read_trace + write_trace (what the
    CLI's convert() does): every hop must carry the same sample bytes
    (float64 once CSV parses them)."""
    grid = _codec_grid(seed=9, s=101, dtype=np.float64)
    csv = str(tmp_path / "t.csv")
    v1 = str(tmp_path / "t.ctr")
    v2 = str(tmp_path / "t.ctr2")
    v1b = str(tmp_path / "back.ctr")
    write_trace(grid, csv)
    _convert(csv, v1, chunk_samples=40)
    _convert(v1, v2, chunk_samples=23, codec="dbz")
    _convert(v2, v1b, chunk_samples=64)
    a1, a2, a1b = read_trace(v1), read_trace(v2), read_trace(v1b)
    assert a1.tpa.tobytes() == a2.tpa.tobytes() == a1b.tpa.tobytes()
    assert a1.clock_mhz.tobytes() == a2.clock_mhz.tobytes() \
        == a1b.clock_mhz.tobytes()
    assert a1.t0_s == a2.t0_s == a1b.t0_s
    assert a1.interval_s == a2.interval_s == a1b.interval_s
    # v1 refuses a codec: it has exactly one encoding
    with pytest.raises(ValueError, match="ctr-v2 feature"):
        _convert(csv, str(tmp_path / "x.ctr"),
                              chunk_samples=40, codec="raw")


def test_v2_crash_mid_flush_opens_valid_at_last_footer(tmp_path):
    """Truncate the file at EVERY byte position after the first flush:
    the reader must either open with all first-flush samples intact or
    (only while the first footer itself is torn) refuse loudly."""
    path = str(tmp_path / "crash.ctr2")
    g1 = _codec_grid(seed=1, s=32, interval=30.0)
    with ts.TraceWriterV2(path, 30.0, 3, chunk_samples=16,
                          codec="dbz-zlib") as w:
        w.append(g1.tpa, g1.clock_mhz)
    flush1_end = os.path.getsize(path)
    base = ts.read_archive(path)
    # now a second flush that a crash will tear
    g2 = _codec_grid(seed=2, s=48, interval=30.0, t0=base.times_s[-1])
    with ts.TraceWriterV2(path, 30.0, 3, chunk_samples=16,
                          append=True, codec="raw") as w:
        w.append_grid(g2)
    full = os.path.getsize(path)
    blob = open(path, "rb").read()
    assert full > flush1_end

    step = 7            # every 7th cut point keeps the test fast
    for cut in range(flush1_end, full, step):
        torn = str(tmp_path / "torn.ctr2")
        with open(torn, "wb") as fh:
            fh.write(blob[:cut])
        rd = ts.TraceReaderV2(torn)
        try:
            assert rd.footer_end <= cut
            assert rd.n_samples >= 32     # never loses flushed data
            grid = rd.read_all()
        finally:
            rd.close()
        assert grid.tpa[:, :32].tobytes() == base.tpa.tobytes()
    # the untorn file serves both flushes
    whole = ts.read_archive(path)
    assert whole.n_devices == 3 and whole.tpa.shape[1] == 80
    assert whole.tpa[:, 32:].tobytes() == g2.tpa.tobytes()


def test_v2_append_reopen_truncates_unindexed_tail(tmp_path):
    path = str(tmp_path / "resume.ctr2")
    g1 = _codec_grid(seed=3, s=20, interval=10.0)
    with ts.TraceWriterV2(path, 10.0, 3, chunk_samples=8) as w:
        w.append(g1.tpa, g1.clock_mhz)
    durable = os.path.getsize(path)
    # a crashed writer's unindexed garbage after the last footer
    with open(path, "ab") as fh:
        fh.write(b"\x00garbage torn chunk bytes" * 9)
    g2 = _codec_grid(seed=4, s=12, interval=10.0, t0=200.0)
    with ts.TraceWriterV2(path, 10.0, 3, chunk_samples=8,
                          append=True) as w:
        assert os.path.getsize(path) == durable   # tail dropped
        w.append_grid(g2)
    out = ts.read_archive(path)
    assert out.tpa.shape == (3, 32)
    assert out.tpa[:, :20].tobytes() == g1.tpa.tobytes()
    assert out.tpa[:, 20:].tobytes() == g2.tpa.tobytes()


def test_v2_truncated_before_first_footer_fails_loudly(tmp_path):
    path = str(tmp_path / "dead.ctr2")
    g = _codec_grid(seed=6, s=8)
    with ts.TraceWriterV2(path, 30.0, 3, chunk_samples=4) as w:
        w.append(g.tpa, g.clock_mhz)
    # find where the first footer STARTS and cut inside the header/data
    blob = open(path, "rb").read()
    first_magic = blob.index(ts.V2_FOOTER_MAGIC)
    flen = struct.unpack("<Q", blob[first_magic - 8:first_magic])[0]
    footer_start = first_magic + len(ts.V2_FOOTER_MAGIC) \
        - ts._V2_TAIL - flen
    with open(path, "wb") as fh:
        fh.write(blob[:footer_start + 3])
    with pytest.raises(ValueError, match="no intact footer"):
        ts.TraceReaderV2(path)


def test_v2_reader_residency_stays_per_chunk(tmp_path):
    """The O(chunk) memory contract holds for the mmap'd container just
    as it does for v1 directories."""
    path = str(tmp_path / "big.ctr2")
    grid = _codec_grid(seed=8, d=4, s=400)
    ts.write_archive(grid, path, chunk_samples=50, codec="dbz-zlib")
    rd = ts.TraceReaderV2(path)
    try:
        for k in range(0, 400, 37):
            rd.read_samples(k, min(k + 30, 400))
        assert rd.peak_resident_samples <= 2 * 50 * 4
        assert rd.chunks_decoded >= 8
        # a mid-archive read touches only its spanning chunks
        before = rd.chunks_decoded
        rd.read_samples(55, 60)
        assert rd.chunks_decoded <= before + 1
    finally:
        rd.close()


def _flip_last_footer_bit(path):
    blob = bytearray(open(path, "rb").read())
    tail = len(blob) - ts._V2_TAIL
    flen = struct.unpack("<Q", blob[tail + 4:tail + 12])[0]
    blob[tail - flen + 5] ^= 0x40
    with open(path, "wb") as fh:
        fh.write(blob)


def test_v2_footer_crc_rejects_bitrot(tmp_path):
    # s < chunk_samples: the ONLY footer is the close() one — bitrot in
    # its json must fail the crc and, with nothing to fall back to,
    # refuse loudly
    path = str(tmp_path / "rot.ctr2")
    g = _codec_grid(seed=10, s=5)
    ts.write_archive(g, path, chunk_samples=8, codec="raw")
    _flip_last_footer_bit(path)
    with pytest.raises(ValueError, match="intact footer"):
        ts.TraceReaderV2(path)

    # s == chunk_samples: append() committed an EARLIER cumulative
    # footer indexing the same chunk, so bitrot in the newest one falls
    # back instead of losing the archive
    path2 = str(tmp_path / "rot2.ctr2")
    g2 = _codec_grid(seed=10, s=8)
    ts.write_archive(g2, path2, chunk_samples=8, codec="raw")
    _flip_last_footer_bit(path2)
    out = ts.read_archive(path2)
    assert out.tpa.tobytes() == g2.tpa.tobytes()


def test_mixed_codec_archive_reads_transparently(tmp_path):
    path = str(tmp_path / "mixed.ctr2")
    g1 = _codec_grid(seed=12, s=16, interval=30.0)
    with ts.TraceWriterV2(path, 30.0, 3, chunk_samples=8,
                          codec="raw") as w:
        w.append(g1.tpa, g1.clock_mhz)
    g2 = _codec_grid(seed=13, s=16, interval=30.0, t0=16 * 30.0)
    with ts.TraceWriterV2(path, 30.0, 3, chunk_samples=8, append=True,
                          codec="dbz-zlib") as w:
        w.append_grid(g2)
    rd = ts.TraceReaderV2(path)
    try:
        assert sorted({c.codec for c in rd.chunks}) \
            == ["dbz-zlib", "raw"]
        assert "codecs=dbz-zlib,raw" in rd.summary()
        out = rd.read_all()
    finally:
        rd.close()
    assert out.tpa.tobytes() == np.concatenate(
        [g1.tpa, g2.tpa], axis=1).tobytes()


# ===========================================================================
# test_tracestore.py: Chunked columnar trace store: exact round-trips for arbitrary
# ===========================================================================
def _store_grid(n_dev=3, n_samples=40, interval_s=30.0, t0_s=0.0, seed=0,
          dtype=np.float64, collapse_from=None):
    """Synthetic counter grid; collapse_from injects a 2.5x duty drop at
    that sample index (detector material)."""
    rng = np.random.default_rng(seed)
    tpa = 0.4 + 0.02 * rng.standard_normal((n_dev, n_samples))
    if collapse_from is not None:
        tpa[:, collapse_from:] /= 2.5
    clk = 1350.0 + 20.0 * rng.standard_normal((n_dev, n_samples))
    return DeviceGrid(interval_s, np.clip(tpa, 0, 1).astype(dtype),
                      clk.astype(dtype), t0_s=t0_s)


def _assert_same_rollup(a: StreamingRollup, b: StreamingRollup, job: str):
    """Bucketwise identity, repo convention: histogram-derived state is
    bit-exact; value means match to 1e-12 (summation-order regrouping)."""
    for roll_s in ((a.job_stats(job), b.job_stats(job)),
                   (a.fleet_stats(), b.fleet_stats())):
        sa, sb = roll_s
        np.testing.assert_array_equal(sa.weight, sb.weight)
        np.testing.assert_allclose(sa.mean, sb.mean, atol=1e-12)
        for q in (10, 50, 90):
            np.testing.assert_array_equal(sa.percentiles[q],
                                          sb.percentiles[q])


def _assert_same_detections(a: StreamingRollup, b: StreamingRollup):
    ra = scan_rollup(a, window=3, min_duration=1, factor_threshold=1.5)
    rb = scan_rollup(b, window=3, min_duration=1, factor_threshold=1.5)
    assert sorted(ra) == sorted(rb)
    for jid in ra:
        assert [(r.start_idx, r.end_idx) for r in ra[jid]] \
            == [(r.start_idx, r.end_idx) for r in rb[jid]]
        np.testing.assert_allclose([r.factor for r in ra[jid]],
                                   [r.factor for r in rb[jid]], atol=1e-9)
    da = analyze_rollup(a, empty_ok=True)
    db = analyze_rollup(b, empty_ok=True)
    assert (da is None) == (db is None)
    if da is not None:
        assert [p.job_id for p in da.flagged] \
            == [p.job_id for p in db.flagged]


# ---------------------------------------------------------------------------
# Writer/reader round-trips
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("chunk", [1, 7, 40, 1000])
def test_archive_roundtrip_exact(tmp_path, dtype, chunk):
    grid = _store_grid(n_dev=2, n_samples=40, t0_s=900.0, dtype=dtype)
    path = str(tmp_path / "t.ctr")
    write_archive(grid, path, chunk_samples=chunk)
    rd = TraceReader(path)
    assert rd.n_samples == 40 and rd.n_devices == 2
    assert len(rd.chunks) == -(-40 // chunk)
    back = rd.read_all()
    assert back.tpa.dtype == dtype and back.t0_s == 900.0
    np.testing.assert_array_equal(back.tpa, grid.tpa)
    np.testing.assert_array_equal(back.clock_mhz, grid.clock_mhz)
    np.testing.assert_array_equal(back.times_s, grid.times_s)
    # chunk concatenation covers the archive exactly once
    parts = list(rd.iter_chunks())
    np.testing.assert_array_equal(
        np.concatenate([g.tpa for g in parts], axis=1), grid.tpa)
    assert [g.t0_s for g in parts] \
        == [900.0 + k * chunk * 30.0 for k in range(len(parts))]


def test_incremental_append_matches_oneshot(tmp_path):
    """A poll()-driven recorder (many small append_grid calls, then a
    reopen-append) produces the identical archive a one-shot write does."""
    grid = _store_grid(n_dev=2, n_samples=60, seed=3)
    one = str(tmp_path / "one.ctr")
    write_archive(grid, one, chunk_samples=16)
    inc = str(tmp_path / "inc.ctr")
    with TraceWriter(inc, 30.0, 2, chunk_samples=16) as w:
        for lo in range(0, 32, 4):
            w.append_grid(DeviceGrid(30.0, grid.tpa[:, lo:lo + 4],
                                     grid.clock_mhz[:, lo:lo + 4],
                                     t0_s=lo * 30.0))
    # restart the recorder: append=True resumes where the manifest ends
    with TraceWriter(inc, 30.0, 2, chunk_samples=16, append=True) as w:
        assert w.total_samples == 32
        w.append(grid.tpa[:, 32:], grid.clock_mhz[:, 32:])
    a, b = TraceReader(one), TraceReader(inc)
    assert [c.n_samples for c in a.chunks] == [c.n_samples for c in b.chunks]
    np.testing.assert_array_equal(a.read_all().tpa, b.read_all().tpa)
    np.testing.assert_array_equal(a.read_all().clock_mhz,
                                  b.read_all().clock_mhz)


def test_writer_validates_continuity(tmp_path):
    w = TraceWriter(str(tmp_path / "t.ctr"), 30.0, 2, chunk_samples=8)
    g = _store_grid(n_dev=2, n_samples=4)
    w.append_grid(g)
    with pytest.raises(ValueError, match="does not continue"):
        w.append_grid(g)                       # t0 rewinds to 0
    with pytest.raises(ValueError, match="interval"):
        w.append_grid(DeviceGrid(15.0, g.tpa, g.clock_mhz, t0_s=120.0))
    with pytest.raises(ValueError, match="devices"):
        w.append_grid(DeviceGrid(30.0, g.tpa[:1], g.clock_mhz[:1],
                                 t0_s=120.0))
    with pytest.raises(ValueError, match="misaligned"):
        w.append(g.tpa, g.clock_mhz[:1])
    w.close()
    with pytest.raises(ValueError, match="closed"):
        w.append(g.tpa, g.clock_mhz)
    with pytest.raises(ValueError, match="already a trace archive"):
        TraceWriter(str(tmp_path / "t.ctr"), 30.0, 2)


def test_writer_never_quantizes_silently(tmp_path):
    """A float64 append into a float32 archive must raise, not round;
    the narrowing direction (f32 data into an f64 archive) is exact and
    allowed."""
    g32 = _store_grid(n_dev=2, n_samples=4, dtype=np.float32)
    g64 = _store_grid(n_dev=2, n_samples=4, dtype=np.float64, t0_s=120.0)
    w = TraceWriter(str(tmp_path / "f32.ctr"), 30.0, 2)
    w.append_grid(g32)
    with pytest.raises(ValueError, match="without losing precision"):
        w.append_grid(g64)
    w.close()
    w = TraceWriter(str(tmp_path / "f64.ctr"), 30.0, 2)
    w.append_grid(_store_grid(n_dev=2, n_samples=4, dtype=np.float64))
    w.append_grid(DeviceGrid(30.0, g32.tpa, g32.clock_mhz, t0_s=120.0))
    w.close()
    back = TraceReader(str(tmp_path / "f64.ctr")).read_all()
    np.testing.assert_array_equal(back.tpa[:, 4:],
                                  g32.tpa.astype(np.float64))


def test_degenerate_grid_rejected_for_columnar(tmp_path):
    """write_trace of the empty grid a header-only CSV yields must fail
    with a clear message on the columnar path (row formats round-trip
    empty traces; an archive needs real geometry)."""
    empty_csv = tmp_path / "empty.csv"
    empty_csv.write_text("t_s,device,tpa,clock_mhz\n")
    grid = read_trace(str(empty_csv))
    assert grid.n_devices == 0
    with pytest.raises(ValueError, match="empty/degenerate"):
        write_trace(grid, str(tmp_path / "empty.ctr"))


def test_empty_archive(tmp_path):
    path = str(tmp_path / "empty.ctr")
    TraceWriter(path, 30.0, 2).close()
    rd = TraceReader(path)
    assert rd.n_samples == 0 and rd.duration_s == 0.0
    assert rd.read_all().tpa.shape == (2, 0)
    src = TraceReplaySource(path)
    assert src.exhausted


# ---------------------------------------------------------------------------
# Corruption is loud
# ---------------------------------------------------------------------------
def _valid_archive(tmp_path) -> str:
    path = str(tmp_path / "v.ctr")
    write_archive(_store_grid(n_dev=2, n_samples=10), path, chunk_samples=4)
    return path


def _edit_manifest(path, fn):
    mf = os.path.join(path, "manifest.json")
    with open(mf) as fh:
        m = json.load(fh)
    fn(m)
    with open(mf, "w") as fh:
        json.dump(m, fh)


def test_reader_rejects_corrupt_archives(tmp_path):
    with pytest.raises(ValueError, match="no manifest.json"):
        TraceReader(str(tmp_path))
    path = _valid_archive(tmp_path)

    _edit_manifest(path, lambda m: m.update(format="ctr-v99"))
    with pytest.raises(ValueError, match="format is 'ctr-v99'"):
        TraceReader(path)
    _edit_manifest(path, lambda m: m.update(format="ctr-v1", n_samples=99))
    with pytest.raises(ValueError, match="chunks hold"):
        TraceReader(path)
    _edit_manifest(path, lambda m: m.update(
        n_samples=10,
        chunks=[dict(c, t0_s=c["t0_s"] + 30.0) if i == 1 else c
                for i, c in enumerate(m["chunks"])]))
    with pytest.raises(ValueError, match="contiguous"):
        TraceReader(path)

    # regenerate a clean one, then break chunk files
    path2 = str(tmp_path / "v2.ctr")
    write_archive(_store_grid(n_dev=2, n_samples=10), path2, chunk_samples=4)
    os.remove(os.path.join(path2, "chunk-000001.npz"))
    with pytest.raises(ValueError, match="missing"):
        TraceReader(path2)

    path3 = str(tmp_path / "v3.ctr")
    write_archive(_store_grid(n_dev=2, n_samples=10), path3, chunk_samples=4)
    np.savez_compressed(os.path.join(path3, "chunk-000001.npz"),
                        tpa=np.zeros((2, 1)), clock_mhz=np.zeros((2, 1)))
    rd = TraceReader(path3)                    # manifest still consistent
    with pytest.raises(ValueError, match="manifest says"):
        rd.read_all()

    mf = os.path.join(path3, "manifest.json")
    with open(mf, "w") as fh:
        fh.write("{not json")
    with pytest.raises(ValueError, match="unreadable manifest"):
        TraceReader(path3)


def test_read_trace_rejects_interval_contradicting_manifest(tmp_path):
    path = _valid_archive(tmp_path)
    with pytest.raises(ValueError, match="contradicts"):
        read_trace(path, interval_s=15.0)
    assert read_trace(path, interval_s=30.0).tpa.shape == (2, 10)


# ---------------------------------------------------------------------------
# Streaming replay: O(chunk) memory, identical output
# ---------------------------------------------------------------------------
def test_uniform_searchsorted_matches_numpy():
    t0, iv, n = 570.0, 30.0, 200
    times = t0 + (np.arange(n) + 1) * iv
    for x in [0.0, t0, t0 + 1e-9, 600.0, 600.0 + 1e-9, 615.1, 5999.99,
              6000.0, 6570.0, 7000.0, -5.0]:
        assert uniform_searchsorted(t0, iv, n, x) \
            == int(np.searchsorted(times, x)), x


def test_multiday_chunked_replay_is_o_chunk_and_identical(tmp_path):
    """The acceptance case: a simulated multi-day trace replays through
    the collector-shaped poll loop holding O(chunk) samples — asserted
    via reader instrumentation — with detector output bucketwise
    identical to a fully-materialized replay."""
    iv, n_dev = 30.0, 4
    n_samples = 2 * 86400 // int(iv)             # two days of scrapes
    grid = _store_grid(n_dev=n_dev, n_samples=n_samples, interval_s=iv, seed=5,
                 collapse_from=n_samples // 2)
    chunk = 512
    path = str(tmp_path / "twoday.ctr")
    write_archive(grid, path, chunk_samples=chunk)

    round_s = 3600.0                             # 120 samples per round
    chunked = StreamingRollup(bucket_s=1800.0)
    src = TraceReplaySource(path)
    rounds = 0
    while not src.exhausted:
        g = src.poll(round_s)
        rounds += 1
        if g.tpa.size:
            chunked.add_grid("day-job", g, chips=64, app_mfu=0.30)
    assert rounds == 48

    rd = src.reader
    total_cells = n_dev * n_samples
    # a poll spans at most ceil(round/chunk_span)+1 = 2 chunks here
    assert rd.peak_resident_samples <= 2 * chunk * n_dev
    assert rd.peak_resident_samples < total_cells / 5
    # ... and exhaustion checks never forced extra decodes: every chunk
    # is decoded about once (cache carries boundary-crossing polls)
    assert rd.chunks_decoded <= len(rd.chunks) + rounds

    batch = StreamingRollup(bucket_s=1800.0)
    batch.add_grid("day-job", TraceReader(path).read_all(), chips=64,
                   app_mfu=0.30)
    _assert_same_rollup(chunked, batch, "day-job")
    _assert_same_detections(chunked, batch)
    # the injected mid-trace collapse is actually detected on both paths
    assert "day-job" in scan_rollup(chunked, window=3, min_duration=1)


def test_columnar_beats_csv_by_4x(tmp_path):
    """Acceptance: the columnar archive is >= 4x smaller than the same
    trace as CSV (float32 counters, implicit timestamps, compressed
    chunks vs ~50 B/sample of repr'd text)."""
    grid = _store_grid(n_dev=16, n_samples=480, dtype=np.float32, seed=2)
    csv_path = str(tmp_path / "t.csv")
    ctr_path = str(tmp_path / "t.ctr")
    write_trace(grid, csv_path)
    write_trace(grid, ctr_path, chunk_samples=2048)
    ratio = os.path.getsize(csv_path) / archive_nbytes(ctr_path)
    assert ratio >= 4.0, f"compression ratio {ratio:.2f}x < 4x"
    # and the smaller file still reads back exactly
    np.testing.assert_array_equal(read_trace(ctr_path).tpa, grid.tpa)


# ---------------------------------------------------------------------------
# Properties: arbitrary geometry, arbitrary cursors
# ---------------------------------------------------------------------------
@settings(max_examples=20, deadline=None)
@given(n_dev=st.integers(1, 3), n_samples=st.integers(1, 50),
       chunk=st.integers(1, 17), iv=st.sampled_from([5.0, 15.0, 30.0]),
       t0_steps=st.integers(0, 40), seed=st.integers(0, 2 ** 16),
       use_f32=st.booleans())
def test_property_roundtrip_exact(n_dev, n_samples, chunk, iv, t0_steps,
                                  seed, use_f32):
    # no pytest fixtures here: under the _propcheck shim @given-wrapped
    # tests take strategy kwargs only
    grid = _store_grid(n_dev=n_dev, n_samples=n_samples, interval_s=iv,
                 t0_s=t0_steps * iv, seed=seed,
                 dtype=np.float32 if use_f32 else np.float64)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.ctr")
        write_archive(grid, path, chunk_samples=chunk)
        back = TraceReader(path).read_all()
    assert back.tpa.dtype == grid.tpa.dtype
    assert back.t0_s == grid.t0_s and back.interval_s == iv
    np.testing.assert_array_equal(back.tpa, grid.tpa)
    np.testing.assert_array_equal(back.clock_mhz, grid.clock_mhz)


@settings(max_examples=15, deadline=None)
@given(n_samples=st.integers(4, 80), chunk=st.integers(1, 13),
       iv=st.sampled_from([15.0, 30.0]), t0_steps=st.integers(0, 10),
       seed=st.integers(0, 2 ** 16),
       poll_steps=st.lists(st.floats(0.4, 4.7), min_size=1, max_size=6),
       with_collapse=st.booleans())
def test_property_chunked_replay_matches_inmemory(
        n_samples, chunk, iv, t0_steps, seed, poll_steps, with_collapse):
    """For ANY chunk size, scrape interval, and mid-chunk poll-cursor
    pattern, streaming replay through the rollup + both detectors is
    bucketwise identical to materializing the whole trace."""
    grid = _store_grid(n_dev=2, n_samples=n_samples, interval_s=iv,
                 t0_s=t0_steps * iv, seed=seed,
                 collapse_from=n_samples // 2 if with_collapse else None)
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "t.ctr")
    write_archive(grid, path, chunk_samples=chunk)

    chunked = StreamingRollup(bucket_s=4 * iv)
    src = TraceReplaySource(path)
    k = 0
    # cycle the (fractional-interval) poll durations: cursors land mid
    # sample, mid chunk, and past the end
    while not src.exhausted:
        g = src.poll(poll_steps[k % len(poll_steps)] * iv)
        k += 1
        if g.tpa.size:
            chunked.add_grid("job", g, chips=16, app_mfu=0.30)
    batch = StreamingRollup(bucket_s=4 * iv)
    batch.add_grid("job", TraceReader(path).read_all(), chips=16,
                   app_mfu=0.30)
    _assert_same_rollup(chunked, batch, "job")
    _assert_same_detections(chunked, batch)
    # every sample was replayed exactly once (weights conserve mass)
    assert float(np.nansum(chunked.job_stats("job").weight)) \
        == pytest.approx(grid.tpa.size * 16 / 2)


@settings(max_examples=10, deadline=None)
@given(chunk=st.integers(1, 9), seed=st.integers(0, 2 ** 16),
       cut_steps=st.integers(1, 30))
def test_property_seek_resumes_exactly(chunk, seed, cut_steps):
    """poll-to-T on one source == poll-to-cut + seek(cut) on another:
    the restart path loses no samples and duplicates none."""
    iv, n_samples = 30.0, 32
    grid = _store_grid(n_dev=2, n_samples=n_samples, interval_s=iv, seed=seed)
    path = os.path.join(tempfile.mkdtemp(), "t.ctr")
    write_archive(grid, path, chunk_samples=chunk)

    straight = TraceReplaySource(path)
    parts_a = []
    while not straight.exhausted:
        parts_a.append(straight.poll(5 * iv))

    cut = min(cut_steps, n_samples) * iv
    first = TraceReplaySource(path)
    parts_b = []
    while first.cursor_s < cut:
        parts_b.append(first.poll(min(5 * iv, cut - first.cursor_s)))
    resumed = TraceReplaySource(path)          # fresh process, same file
    resumed.seek(first.cursor_s)
    while not resumed.exhausted:
        parts_b.append(resumed.poll(5 * iv))

    got_a = np.concatenate([g.tpa for g in parts_a if g.tpa.size], axis=1)
    got_b = np.concatenate([g.tpa for g in parts_b if g.tpa.size], axis=1)
    np.testing.assert_array_equal(got_a, grid.tpa)
    np.testing.assert_array_equal(got_b, grid.tpa)
    times_b = np.concatenate([g.times_s for g in parts_b if g.tpa.size])
    np.testing.assert_allclose(times_b, grid.times_s)


# ===========================================================================
# test_trace_golden.py: Golden-trace compatibility: the wire formats are frozen by committed
# ===========================================================================
DATA = os.path.join(os.path.dirname(__file__), "data")

# the exact samples the fixtures hold: awkward floats on purpose
# (non-terminating binary fractions, repr-precision stress, exact zeros)
GOLD_TPA = np.array([
    [0.1, 1.0 / 3.0, 0.4123456789012345, 0.0, 1.0],
    [0.25, 0.5, 0.75, 0.125, 0.0078125],
])
GOLD_CLK = np.array([
    [1328.5, 1411.0, 1234.56789, 987.654321, 1300.0],
    [1400.0, 1111.125, 1250.0, 1327.9998779296875, 1399.25],
])
GOLD_IV, GOLD_T0 = 30.0, 600.0          # a mid-run slice: t in (600, 750]

# frozen bucket readout: bucket_s=60 over the grid above (buckets 0-9
# empty — the trace starts at t=600)
GOLD_BUCKET_WEIGHT = [0.0] * 10 + [4.0, 4.0, 2.0]
GOLD_BUCKET_MEAN = [float("nan")] * 10 + [
    0.2514576388888889, 0.2687614532488209, 0.4369772135416667]
GOLD_BUCKET_P50 = [float("nan")] * 10 + [
    0.24062500000000003, 0.11171875, 0.00859375]


def _gold_grid() -> DeviceGrid:
    return DeviceGrid(GOLD_IV, GOLD_TPA.copy(), GOLD_CLK.copy(),
                      t0_s=GOLD_T0)


@pytest.mark.parametrize("name", ["golden.csv", "golden.jsonl",
                                  "golden.ctr", "golden.ctr2"])
def test_golden_reads_are_exact(name):
    grid = read_trace(os.path.join(DATA, name))
    assert grid.interval_s == GOLD_IV
    assert grid.t0_s == GOLD_T0
    np.testing.assert_array_equal(grid.tpa, GOLD_TPA)
    np.testing.assert_array_equal(grid.clock_mhz, GOLD_CLK)
    np.testing.assert_array_equal(grid.times_s,
                                  GOLD_T0 + GOLD_IV * np.arange(1, 6))


@pytest.mark.parametrize("name", ["golden.csv", "golden.jsonl"])
def test_golden_row_writes_are_byte_identical(tmp_path, name):
    """Serialization itself is frozen: re-writing the golden grid must
    reproduce the committed fixture BYTE for byte."""
    out = tmp_path / name
    write_trace(_gold_grid(), str(out))
    with open(os.path.join(DATA, name), "rb") as fh:
        want = fh.read()
    assert out.read_bytes() == want


def test_golden_archive_layout_is_frozen():
    """The columnar manifest (format tag, geometry, chunk index) is part
    of the wire contract; npz chunk BYTES may vary across numpy/zlib, so
    the chunk contract is pinned by exact array reads instead."""
    with open(os.path.join(DATA, "golden.ctr", "manifest.json")) as fh:
        m = json.load(fh)
    assert m == {
        "format": "ctr-v1", "interval_s": 30.0, "n_devices": 2,
        "t0_s": 600.0, "dtype": "float64", "chunk_samples": 2,
        "n_samples": 5,
        "chunks": [
            {"file": "chunk-000000.npz", "t0_s": 600.0, "n_samples": 2},
            {"file": "chunk-000001.npz", "t0_s": 660.0, "n_samples": 2},
            {"file": "chunk-000002.npz", "t0_s": 720.0, "n_samples": 1},
        ],
    }
    rd = TraceReader(os.path.join(DATA, "golden.ctr"))
    assert [c.n_samples for c in rd.chunks] == [2, 2, 1]
    for k, grid in enumerate(rd.iter_chunks()):
        lo = 2 * k
        np.testing.assert_array_equal(grid.tpa,
                                      GOLD_TPA[:, lo:lo + 2])
        np.testing.assert_array_equal(grid.clock_mhz,
                                      GOLD_CLK[:, lo:lo + 2])
        assert grid.t0_s == GOLD_T0 + lo * GOLD_IV


def test_golden_v2_container_is_frozen(tmp_path):
    """The ctr-v2 single-file layout is part of the wire contract.

    `tests/data/golden.ctr2` was written once with the raw codec (whose
    encoding is deterministic native bytes, unlike zlib streams which
    may vary across library versions), so a re-write of the golden grid
    must reproduce the committed file BYTE for byte — magic, header
    json, chunk blocks, both cumulative footers, crcs and all.

    Regenerate (only after a deliberate, versioned format change):

        PYTHONPATH=src python tools/trace_convert.py \\
            tests/data/golden.csv tests/data/golden.ctr2 \\
            --chunk-samples 2 --codec raw
    """
    import struct

    from repro_torch.telemetry import tracestore as ts

    fixture = os.path.join(DATA, "golden.ctr2")
    with open(fixture, "rb") as fh:
        blob = fh.read()

    # the immutable prelude: magic + header length + header json
    assert blob[:8] == ts.V2_MAGIC == b"CTR2\x00\x01\r\n"
    hlen = struct.unpack("<I", blob[8:12])[0]
    assert json.loads(blob[12:12 + hlen]) == {
        "format": "ctr-v2", "interval_s": 30.0, "n_devices": 2,
        "t0_s": 600.0, "chunk_samples": 2}

    # the newest footer: crc-guarded cumulative chunk table at EOF
    assert blob.endswith(ts.V2_FOOTER_MAGIC)
    tail = len(blob) - ts._V2_TAIL
    flen = struct.unpack("<Q", blob[tail + 4:tail + 12])[0]
    footer = json.loads(blob[tail - flen:tail])
    assert footer == {
        "format": "ctr-v2", "interval_s": 30.0, "n_devices": 2,
        "t0_s": 600.0, "dtype": "float64", "chunk_samples": 2,
        "n_samples": 5,
        "chunks": [
            {"off": 94, "t0_s": 600.0, "n": 2, "codec": "raw",
             "tb": 32, "cb": 32},
            {"off": 158, "t0_s": 660.0, "n": 2, "codec": "raw",
             "tb": 32, "cb": 32},
            {"off": 488, "t0_s": 720.0, "n": 1, "codec": "raw",
             "tb": 16, "cb": 16},
        ],
    }

    # writing the same grid again is byte-identical to the fixture
    out = tmp_path / "golden.ctr2"
    ts.write_archive(_gold_grid(), str(out), chunk_samples=2,
                     codec="raw")
    assert out.read_bytes() == blob

    # and the chunk contract reads back through the shared reader API
    rd = TraceReader(fixture)
    try:
        assert [c.n_samples for c in rd.chunks] == [2, 2, 1]
        for k, grid in enumerate(rd.iter_chunks()):
            lo = 2 * k
            np.testing.assert_array_equal(grid.tpa,
                                          GOLD_TPA[:, lo:lo + 2])
            assert grid.t0_s == GOLD_T0 + lo * GOLD_IV
    finally:
        rd.close()


@pytest.mark.parametrize("name", ["golden.csv", "golden.jsonl",
                                  "golden.ctr", "golden.ctr2"])
def test_golden_bucket_readout_is_frozen(name):
    """Bucketing semantics ride the same golden contract: the fixture
    through a bucket_s=60 rollup must land these exact buckets."""
    roll = StreamingRollup(bucket_s=60.0)
    roll.add_grid("golden", read_trace(os.path.join(DATA, name)))
    s = roll.job_stats("golden", qs=(50,))
    np.testing.assert_array_equal(s.weight, GOLD_BUCKET_WEIGHT)
    np.testing.assert_array_equal(s.mean, GOLD_BUCKET_MEAN)
    np.testing.assert_array_equal(s.percentiles[50], GOLD_BUCKET_P50)


# ===========================================================================
# test_telemetry_source.py: TelemetrySource abstraction: simulator/backend/replay sources all emit
# ===========================================================================
PROF = StepProfile(mxu_time_s=0.8, step_time_s=2.0)


def test_simulator_source_matches_engine():
    src = SimulatorSource(PROF, duration_s=600, interval_s=30.0,
                          n_devices=4, seed=3)
    grid = src.scrapes()
    ref = simulate_devices(PROF, duration_s=600, interval_s=30.0,
                           n_devices=4, seed=3)
    assert isinstance(grid, DeviceGrid)
    np.testing.assert_array_equal(grid.tpa, ref.tpa)
    np.testing.assert_array_equal(grid.clock_mhz, ref.clock_mhz)


def test_sources_enforce_scrape_interval_identically():
    """Interchangeable sources, one §IV-C policy: both reject an
    average-of-averages interval by default; strict=False degrades."""
    sim = SimulatorSource(PROF, duration_s=120, interval_s=60.0,
                          n_devices=1, seed=0)
    be = BackendSource([SimulatedDeviceBackend(PROF, seed=0)],
                       duration_s=120, interval_s=60.0)
    for src in (sim, be):
        with pytest.raises(ValueError, match="average-of-averages"):
            src.scrapes()
    sim.strict = be.strict = False
    for src in (sim, be):
        with pytest.warns(RuntimeWarning, match="average-of-averages"):
            assert src.scrapes().tpa.shape == (1, 2)


def test_series_roundtrip_preserves_t0():
    grid = simulate_devices(PROF, duration_s=300, interval_s=30.0,
                            n_devices=2, seed=0)
    shifted = DeviceGrid(grid.interval_s, grid.tpa, grid.clock_mhz,
                         t0_s=900.0)
    s = shifted.series(1)
    assert s.t0_s == 900.0 and s.subsample(2).t0_s == 900.0
    back = DeviceGrid.from_series(shifted.to_series_list())
    assert back.t0_s == 900.0
    np.testing.assert_allclose(back.times_s, shifted.times_s)


def test_backend_source_matches_scalar_scrape():
    src = BackendSource([SimulatedDeviceBackend(PROF, seed=s)
                         for s in (1, 2)], duration_s=300, interval_s=30.0)
    grid = src.scrapes()
    assert grid.n_devices == 2 and grid.tpa.shape == (2, 10)
    ref = scrape(SimulatedDeviceBackend(PROF, seed=1), 300, 30.0)
    np.testing.assert_array_equal(grid.tpa[0], ref.tpa)
    np.testing.assert_array_equal(grid.clock_mhz[0], ref.clock_mhz)


def test_grid_series_stack_roundtrip():
    grid = simulate_devices(PROF, duration_s=300, interval_s=30.0,
                            n_devices=3, seed=0)
    back = DeviceGrid.from_series(grid.to_series_list())
    np.testing.assert_array_equal(back.tpa, grid.tpa)
    assert back.interval_s == grid.interval_s
    with pytest.raises(ValueError, match="misaligned"):
        DeviceGrid.from_series([grid.series(0),
                                grid.series(1).subsample(2)])


@pytest.mark.parametrize("fmt,suffix", [("csv", ".csv"), ("jsonl", ".jsonl")])
def test_trace_roundtrip_exact(tmp_path, fmt, suffix):
    grid = simulate_devices(PROF, duration_s=600, interval_s=30.0,
                            events=[Event(200, 400, slowdown=2.0)],
                            n_devices=3, seed=7)
    path = str(tmp_path / f"trace{suffix}")
    write_trace(grid, path)                      # fmt inferred from suffix
    replay = TraceReplaySource(path).scrapes()
    assert replay.interval_s == grid.interval_s
    np.testing.assert_array_equal(replay.tpa, grid.tpa)
    np.testing.assert_array_equal(replay.clock_mhz, grid.clock_mhz)
    # explicit fmt agrees with inference
    explicit = read_trace(path, fmt=fmt)
    np.testing.assert_array_equal(explicit.tpa, grid.tpa)


def test_trace_format_validation(tmp_path):
    grid = simulate_devices(PROF, duration_s=60, interval_s=30.0, seed=0)
    with pytest.raises(ValueError, match="cannot infer"):
        write_trace(grid, str(tmp_path / "trace.parquet"))
    with pytest.raises(ValueError, match="unknown trace format"):
        write_trace(grid, str(tmp_path / "t.csv"), fmt="xml")
    # ragged trace (device 1 missing one poll) is rejected
    p = tmp_path / "ragged.csv"
    p.write_text("t_s,device,tpa,clock_mhz\n"
                 "30.0,0,0.4,1300.0\n60.0,0,0.4,1300.0\n"
                 "30.0,1,0.4,1300.0\n")
    with pytest.raises(ValueError, match="ragged"):
        read_trace(str(p))
    # empty trace -> empty grid
    q = tmp_path / "empty.jsonl"
    q.write_text("")
    assert read_trace(str(q)).n_devices == 0
    # a single poll instant cannot pin down the interval: explicit only
    one = tmp_path / "one.csv"
    one.write_text("t_s,device,tpa,clock_mhz\n630.0,0,0.4,1300.0\n")
    with pytest.raises(ValueError, match="single poll instant"):
        read_trace(str(one))
    g1 = TraceReplaySource(str(one), interval_s=30.0).scrapes()
    assert g1.interval_s == 30.0 and g1.times_s[0] == pytest.approx(630.0)


def test_read_trace_rejects_malformed_files(tmp_path):
    """fmt='auto' sniffing must fail LOUD: every malformed-input mode
    gets a clear error naming the offending line, never a silently
    mis-parsed grid (regression tests for the former failure modes)."""
    # headerless CSV: first row is data — skipping it used to drop one
    # poll per device and shift the inferred t0
    p = tmp_path / "headerless.csv"
    p.write_text("30.0,0,0.4,1300.0\n60.0,0,0.41,1310.0\n")
    with pytest.raises(ValueError, match="no header row"):
        read_trace(str(p))
    # header present but a data row is truncated
    p = tmp_path / "truncated.csv"
    p.write_text("t_s,device,tpa,clock_mhz\n30.0,0,0.4,1300.0\n60.0,0\n")
    with pytest.raises(ValueError, match="line 3: truncated row"):
        read_trace(str(p))
    # unparseable cell
    p = tmp_path / "badval.csv"
    p.write_text("t_s,device,tpa,clock_mhz\n30.0,zero,0.4,1300.0\n")
    with pytest.raises(ValueError, match="line 2: malformed value"):
        read_trace(str(p))
    # invalid JSON line
    p = tmp_path / "bad.jsonl"
    p.write_text('{"t_s": 30.0, "device": 0, "tpa": 0.4, '
                 '"clock_mhz": 1300.0}\n{oops\n')
    with pytest.raises(ValueError, match="line 2: invalid JSON"):
        read_trace(str(p))
    # a whole-file JSON array is not JSONL
    p = tmp_path / "array.json"
    p.write_text('[{"t_s": 30.0, "device": 0, "tpa": 0.4, '
                 '"clock_mhz": 1300.0}]\n')
    with pytest.raises(ValueError, match="not a JSONL trace"):
        read_trace(str(p))
    # JSONL record missing a key
    p = tmp_path / "missing.jsonl"
    p.write_text('{"t_s": 30.0, "device": 0, "tpa": 0.4}\n')
    with pytest.raises(ValueError, match=r"missing key\(s\) \['clock_mhz'\]"):
        read_trace(str(p))
    # JSONL value of the wrong type
    p = tmp_path / "badtype.jsonl"
    p.write_text('{"t_s": 30.0, "device": 0, "tpa": [0.4], '
                 '"clock_mhz": 1300.0}\n')
    with pytest.raises(ValueError, match="line 1: malformed value"):
        read_trace(str(p))
    # a directory that isn't a columnar archive
    with pytest.raises(ValueError, match="not a columnar trace archive"):
        read_trace(str(tmp_path))


def test_trace_tolerates_per_device_timestamp_jitter(tmp_path):
    """Real pollers stamp devices a few ms apart; alignment is by poll
    rank, not exact float time equality."""
    p = tmp_path / "jitter.csv"
    p.write_text("t_s,device,tpa,clock_mhz\n"
                 "30.001,0,0.40,1300.0\n60.002,0,0.41,1310.0\n"
                 "30.003,1,0.42,1320.0\n59.999,1,0.43,1330.0\n")
    grid = read_trace(str(p))
    assert grid.tpa.shape == (2, 2)
    np.testing.assert_allclose(grid.tpa, [[0.40, 0.41], [0.42, 0.43]])
    assert grid.interval_s == pytest.approx(30.0, abs=0.01)


def test_midrun_trace_replays_at_recorded_times(tmp_path):
    """A trace sliced from the middle of a run must keep its clock: the
    replayed samples land in the rollup buckets they were recorded in."""
    from repro_torch.fleet.streaming import StreamingRollup
    from repro_torch.telemetry.scrape import DeviceGrid

    grid = simulate_devices(PROF, duration_s=600, interval_s=30.0,
                            n_devices=2, seed=1)
    shifted = DeviceGrid(grid.interval_s, grid.tpa, grid.clock_mhz,
                         t0_s=600.0)                 # second 10 minutes
    assert shifted.times_s[0] == pytest.approx(630.0)
    path = str(tmp_path / "midrun.csv")
    write_trace(shifted, path)
    replay = read_trace(path)
    np.testing.assert_allclose(replay.times_s, shifted.times_s)
    np.testing.assert_array_equal(replay.tpa, shifted.tpa)
    roll = StreamingRollup(bucket_s=300)
    roll.add_grid("midrun", replay)
    stats = roll.job_stats("midrun", qs=())
    assert len(stats.mean) == 4                      # buckets 0-4 spanned
    assert np.isnan(stats.mean[:2]).all()            # nothing before 600 s
    assert np.isfinite(stats.mean[2:]).all()


def test_replay_through_rollup_and_detectors(tmp_path):
    """A recorded regression survives the disk round-trip: the replayed
    trace trips the same detector the simulated grid does."""
    grid = simulate_devices(PROF, duration_s=3600, interval_s=30.0,
                            events=[Event(1800, 3600, slowdown=2.5)],
                            n_devices=4, seed=11)
    path = str(tmp_path / "regressed.jsonl")
    write_trace(grid, path)
    roll = StreamingRollup(bucket_s=120)
    roll.add_grid("replayed", TraceReplaySource(path).scrapes(),
                  group="bf16", chips=256, app_mfu=0.38)
    found = scan_rollup(roll, factor_threshold=1.5)
    assert list(found) == ["replayed"]
    assert 2.0 < found["replayed"][0].factor < 2.6
    # and the bridge to divergence carries the trace-supplied app MFU
    (pt,) = roll.to_job_points()
    assert pt.mfu == 0.38 and pt.chips == 256


def test_replay_pipeline_needs_no_simulator(tmp_path):
    """End-to-end acceptance: trace -> rollup -> regression + divergence in
    a fresh interpreter that never imports the simulator (engine/jobs)."""
    grid = simulate_devices(PROF, duration_s=3600, interval_s=30.0,
                            events=[Event(1800, 3600, slowdown=2.5)],
                            n_devices=2, seed=5)
    path = tmp_path / "trace.csv"
    write_trace(grid, str(path))
    script = f"""
import sys
from repro_torch.telemetry.source import TraceReplaySource
from repro_torch.fleet import DeviceGrid, StreamingRollup   # lazy: no simulator
from repro_torch.fleet.regression import scan_rollup
from repro_torch.fleet.divergence import analyze_rollup

roll = StreamingRollup(bucket_s=120)
roll.add_grid("traced", TraceReplaySource({str(path)!r}).scrapes(),
              chips=128, app_mfu=0.38)
regs = scan_rollup(roll, factor_threshold=1.5)
rep = analyze_rollup(roll)
assert "traced" in regs, "regression not detected from replayed trace"
assert rep.flagged, "divergence triage missed the collapsed job"
for banned in ("repro_torch.fleet.engine", "repro_torch.fleet.jobs"):
    assert banned not in sys.modules, f"simulator leaked: {{banned}}"
print("REPLAY_OK", round(regs["traced"][0].factor, 2))
"""
    src_dir = str(Path(__file__).resolve().parent.parent / "src")
    res = subprocess.run([sys.executable, "-c", script],
                         env={"PYTHONPATH": src_dir, "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert "REPLAY_OK" in res.stdout


# ---------------------------------------------------------------------------
# Stateful scrape cursors (incremental collection)
# ---------------------------------------------------------------------------
def test_simulator_poll_cursor_covers_run_without_gaps():
    src = SimulatorSource(PROF, duration_s=600, interval_s=30.0,
                          n_devices=3, seed=7,
                          events=[Event(300, 600, slowdown=2.5)])
    grids = []
    while not src.exhausted:
        grids.append(src.poll(150))
    assert src.cursor_s == 600
    times = np.concatenate([g.times_s for g in grids])
    np.testing.assert_allclose(times, np.arange(1, 21) * 30.0)
    # events stay on the ABSOLUTE timeline across chunk boundaries
    tpa = np.concatenate([g.tpa for g in grids], axis=1)
    assert tpa[:, 10:].mean() < tpa[:, :10].mean() / 2
    # polls are deterministic given (seed, poll count)
    src2 = SimulatorSource(PROF, duration_s=600, interval_s=30.0,
                           n_devices=3, seed=7,
                           events=[Event(300, 600, slowdown=2.5)])
    np.testing.assert_array_equal(src2.poll(150).tpa, grids[0].tpa)


def test_poll_shorter_than_interval_rejected():
    src = SimulatorSource(PROF, duration_s=600, interval_s=30.0)
    with pytest.raises(ValueError, match="shorter than"):
        src.poll(10)


def test_set_interval_enforces_scrape_policy():
    src = SimulatorSource(PROF, duration_s=600, interval_s=30.0, seed=1)
    src.poll(60)
    src.set_interval(10.0)
    grid = src.poll(60)
    assert grid.interval_s == 10.0 and grid.tpa.shape[1] == 6
    assert np.isclose(grid.t0_s, 60.0)      # cursor carried across retiming
    with pytest.raises(ValueError, match="averaging window"):
        src.set_interval(45.0)              # §IV-C
    with pytest.raises(ValueError, match="positive"):
        src.set_interval(0.0)


def test_backend_source_poll_is_resumable():
    def series(chunks):
        bes = [SimulatedDeviceBackend(PROF, seed=s) for s in (0, 1)]
        src = BackendSource(bes, duration_s=180, interval_s=30.0)
        grids = [src.poll(c) for c in chunks]
        assert src.exhausted
        return np.concatenate([g.tpa for g in grids], axis=1)

    # backends advance their own clock: chunking must not change the data
    np.testing.assert_array_equal(series([180]), series([60, 60, 60]))
    # duration_s=inf makes a poll-only live source that never exhausts
    live = BackendSource([SimulatedDeviceBackend(PROF)],
                         duration_s=float("inf"), interval_s=30.0)
    assert live.poll(60).tpa.shape == (1, 2) and not live.exhausted


def test_trace_replay_poll_slices_recorded_times(tmp_path):
    grid = simulate_devices(PROF, duration_s=300, interval_s=30.0,
                            n_devices=2, seed=5)
    path = tmp_path / "t.csv"
    write_trace(grid, str(path))
    src = TraceReplaySource(str(path))
    assert not src.retimable
    with pytest.raises(ValueError, match="fixed"):
        src.set_interval(10.0)
    chunks = []
    while not src.exhausted:
        chunks.append(src.poll(120))
    got = np.concatenate([c.tpa for c in chunks if c.tpa.size], axis=1)
    np.testing.assert_array_equal(got, grid.tpa)
    times = np.concatenate([c.times_s for c in chunks if c.tpa.size])
    np.testing.assert_allclose(times, grid.times_s)


def test_set_interval_honors_source_strictness():
    # a strict=False source already runs degraded past the averaging
    # window; retiming within that same policy must not be rejected
    src = SimulatorSource(PROF, duration_s=600, interval_s=45.0,
                          n_devices=1, strict=False)
    with pytest.warns(RuntimeWarning, match="averaging window"):
        src.set_interval(40.0)
    assert src.interval_s == 40.0
    strict_src = SimulatorSource(PROF, duration_s=600, interval_s=30.0)
    with pytest.raises(ValueError, match="averaging window"):
        strict_src.set_interval(40.0)


# ===========================================================================
# parity: the same seeded inputs through both packages
# ===========================================================================
def _r_grid(g):
    """A port DeviceGrid as the reference's (host arrays, same fields)."""
    return R_telemetry.DeviceGrid(g.interval_s, np.asarray(g.tpa),
                                  np.asarray(g.clock_mhz), t0_s=g.t0_s)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", codecs.codec_names())
def test_codec_bytes_equal_reference(name, dtype):
    arr = _column(np.random.default_rng(17), dtype, 3, 57)
    blob = codecs.get_codec(name).encode(arr)
    assert blob == R_codecs.get_codec(name).encode(arr)
    out = R_codecs.get_codec(name).decode(blob, arr.dtype, arr.shape)
    assert out.tobytes() == arr.tobytes()


@pytest.mark.parametrize("suffix,codec", [(".ctr", None), (".ctr2", "raw"),
                                          (".ctr2", "dbz-zlib")])
def test_archives_cross_read_and_match_reference(tmp_path, suffix, codec):
    """One seeded grid archived by each package: every v2 byte is the
    same, v1 manifests are equal, and each package reads the other's
    archive back to the identical samples."""
    grid = _store_grid(n_dev=3, n_samples=70, t0_s=600.0, seed=4,
                       dtype=np.float32)
    mine, theirs = (str(tmp_path / f"{w}{suffix}") for w in ("t", "r"))
    write_archive(grid, mine, chunk_samples=16, codec=codec)
    R_ts.write_archive(_r_grid(grid), theirs, chunk_samples=16, codec=codec)
    if suffix == ".ctr2":
        assert Path(mine).read_bytes() == Path(theirs).read_bytes()
    else:
        assert json.loads(Path(mine, "manifest.json").read_text()) \
            == json.loads(Path(theirs, "manifest.json").read_text())
    for back in (ts.read_archive(theirs), R_ts.read_archive(mine)):
        assert back.tpa.tobytes() == grid.tpa.tobytes()
        assert back.clock_mhz.tobytes() == grid.clock_mhz.tobytes()
        assert back.t0_s == grid.t0_s and back.interval_s == 30.0


@pytest.mark.parametrize("suffix", [".csv", ".jsonl"])
def test_row_traces_byte_identical_to_reference(tmp_path, suffix):
    grid = simulate_devices(PROF, duration_s=600, interval_s=30.0,
                            events=[Event(200, 400, slowdown=2.0)],
                            n_devices=3, seed=7)
    mine, theirs = tmp_path / f"t{suffix}", tmp_path / f"r{suffix}"
    write_trace(grid, str(mine))
    R_telemetry.write_trace(_r_grid(grid), str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("name", ["golden.csv", "golden.jsonl",
                                  "golden.ctr", "golden.ctr2"])
def test_golden_fixtures_read_as_the_reference_reads_them(name):
    mine = read_trace(os.path.join(DATA, name))
    ref = R_telemetry.read_trace(os.path.join(DATA, name))
    assert (mine.interval_s, mine.t0_s) == (ref.interval_s, ref.t0_s)
    assert mine.tpa.dtype == ref.tpa.dtype
    assert mine.tpa.tobytes() == ref.tpa.tobytes()
    assert mine.clock_mhz.tobytes() == ref.clock_mhz.tobytes()
    a, b = StreamingRollup(bucket_s=60.0), R_streaming.StreamingRollup(60.0)
    a.add_grid("golden", mine)
    b.add_grid("golden", ref)
    assert a.to_bytes_v2() == b.to_bytes_v2()


def test_golden_rollup_blob_reads_through_the_port():
    """`tests/data/golden_rollup.fru2` (the reference's frozen FRU2 blob)
    decodes through the port's wire module to the reference's decode,
    and re-encodes byte for byte after a port rollup restores it."""
    with open(os.path.join(DATA, "golden_rollup.fru2"), "rb") as fh:
        blob = fh.read()
    mine, ref = wire.decode(blob), R_wire.decode(blob)
    assert (mine.version, mine.seq, mine.bins, mine.n_buckets,
            mine.bucket_s, mine.is_delta, mine.since) \
        == (ref.version, ref.seq, ref.bins, ref.n_buckets, ref.bucket_s,
            ref.is_delta, ref.since) == (wire.VERSION, 2, 8, 3, 60.0,
                                         False, 0)
    assert mine.job_meta == ref.job_meta
    assert [s[0] for s in mine.scopes] == [s[0] for s in ref.scopes]
    for (_, i1, h1, s1), (_, i2, h2, s2) in zip(mine.scopes, ref.scopes):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(h1, h2)
        np.testing.assert_array_equal(s1, s2)
    roll = StreamingRollup.from_bytes(blob)
    assert roll.to_bytes_v2() == blob
    assert roll.to_bytes_v2() \
        == R_streaming.StreamingRollup.from_bytes(blob).to_bytes_v2()


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_replay_polls_match_reference(tmp_path, chunk):
    """A `TraceReplaySource` over one archive polls the same samples at
    the same times in both packages, round after round."""
    grid = _store_grid(n_dev=2, n_samples=90, seed=8, dtype=np.float32)
    path = str(tmp_path / "t.ctr")
    write_archive(grid, path, chunk_samples=chunk)
    mine, ref = TraceReplaySource(path), R_telemetry.TraceReplaySource(path)
    while not ref.exhausted:
        a, b = mine.poll(330.0), ref.poll(330.0)
        assert a.t0_s == b.t0_s and a.tpa.tobytes() == b.tpa.tobytes()
    assert mine.exhausted and mine.cursor_s == ref.cursor_s


def test_simulator_source_statistics_match_reference():
    """`SimulatorSource` draws differ between the engines (Philox vs
    NumPy), so its polls are held statistically, at the tolerances
    `test_torch_engine.py` holds the engines to: tpa mean 0.005 before
    and after an event, clock mean 15 MHz, OFU mean 0.005."""
    kw = dict(duration_s=3600, interval_s=30.0, n_devices=16, seed=5)
    mine = SimulatorSource(PROF, events=[Event(1800, 3600, slowdown=2.5)],
                           **kw)
    ref = R_telemetry.SimulatorSource(
        R_telemetry.StepProfile(mxu_time_s=0.8, step_time_s=2.0),
        events=[R_telemetry.Event(1800, 3600, slowdown=2.5)], **kw)
    for _ in range(2):
        a, b = mine.poll(1800), ref.poll(1800)
        assert isinstance(a.tpa, torch.Tensor) and a.tpa.device.type == "cpu"
        assert tuple(a.tpa.shape) == b.tpa.shape == (16, 60)
        assert a.t0_s == b.t0_s
        tpa, clk = a.tpa.numpy(), a.clock_mhz.numpy()
        assert tpa.mean() == pytest.approx(b.tpa.mean(), abs=0.005)
        assert clk.mean() == pytest.approx(b.clock_mhz.mean(), abs=15.0)
        assert (tpa * clk / 1558.0).mean() == pytest.approx(
            (b.tpa * b.clock_mhz / 1558.0).mean(), abs=0.005)
    assert mine.exhausted and ref.exhausted


def test_simulator_source_runs_on_the_card_unless_asked():
    """Without `device` the source simulates on the current CUDA device:
    where there is none, it raises instead of falling back to the CPU."""
    src = _SimulatorSource(PROF, duration_s=600, interval_s=30.0)
    assert src.device is None
    if torch.cuda.is_available():
        assert src.poll(300).tpa.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            src.poll(300)
