"""Convert scrape traces between CSV / JSONL (interchange) and the
columnar archive formats (`repro_torch.telemetry.tracestore`): the
ctr-v1 chunk directory and the ctr-v2 single-file container, with a
stats summary for sizing archives.

    python -m repro_torch.tools.trace_convert fleet.csv fleet.ctr \
        --chunk-samples 4096
    python -m repro_torch.tools.trace_convert fleet.ctr fleet.ctr2 \
        --codec dbz-zlib
    python -m repro_torch.tools.trace_convert fleet.ctr2 fleet.jsonl
    python -m repro_torch.tools.trace_convert --self-check [--device cpu]

Formats are inferred from the path (`.csv`, `.jsonl`/`.ndjson`/`.json`,
`.ctr` directory or `.ctr2` file — an existing archive of either
version is sniffed regardless of suffix) unless forced with
`--from/--to`.  `--codec` selects the ctr-v2 column codec (see
`repro_torch.telemetry.codecs`; v1 output is always npz).
`--self-check` round-trips a synthetic trace through all formats in a
temp dir and verifies exact equality plus a chunked replay onto the
device (the card unless `--device` names another) — the smoke test of
the storage layer.  Conversion itself is host file I/O.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.telemetry import codecs, tracestore
from repro_torch.telemetry.source import (DeviceSource, _resolve_fmt,
                                          read_trace, write_trace)


def _nbytes(path: str) -> int:
    return tracestore.archive_nbytes(path) if os.path.isdir(path) \
        else os.path.getsize(path)


def _describe(tag: str, path: str, grid) -> None:
    n = grid.tpa.shape[1]
    span_h = n * grid.interval_s / 3600.0 if n else 0.0
    size = _nbytes(path)
    per = size / max(grid.tpa.size, 1)
    print(f"  {tag}: {path}")
    print(f"    devices={grid.n_devices} samples/device={n} "
          f"interval={grid.interval_s:g}s span={span_h:.2f}h "
          f"t0={grid.t0_s:g}s")
    print(f"    {size:,} bytes ({per:.1f} B/sample)")


def convert(src: str, dst: str, *, src_fmt: str = "auto",
            dst_fmt: str = "auto", chunk_samples: int,
            interval_s: float | None = None,
            codec: str | None = None) -> None:
    grid = read_trace(src, fmt=src_fmt, interval_s=interval_s)
    write_trace(grid, dst, fmt=dst_fmt, chunk_samples=chunk_samples,
                codec=codec)
    _describe("in ", src, grid)
    _describe("out", dst, grid)
    ratio = _nbytes(src) / max(_nbytes(dst), 1)
    print(f"    size ratio in/out: {ratio:.1f}x")
    if _resolve_fmt(dst, dst_fmt) == "columnar":
        print(f"    {tracestore.TraceReader(dst).summary()}")


def self_check(device=None) -> int:
    """Round-trip a synthetic trace csv -> ctr -> ctr2 -> jsonl and
    verify exact equality, then replay the archive chunk by chunk onto
    `device` (the card when None); returns a process exit code."""
    import tempfile

    from repro_torch.telemetry.scrape import DeviceGrid
    from repro_torch.telemetry.source import TraceReplaySource

    device = resolve_device(device)
    rng = np.random.default_rng(7)
    grid = DeviceGrid(
        30.0,
        rng.uniform(0.0, 1.0, (3, 50)).astype(np.float32),
        rng.uniform(900.0, 1411.0, (3, 50)).astype(np.float32),
        t0_s=600.0)
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "t.csv")
        ctr = os.path.join(tmp, "t.ctr")
        ctr2 = os.path.join(tmp, "t.ctr2")
        jsonl = os.path.join(tmp, "t.jsonl")
        write_trace(grid, csv)
        convert(csv, ctr, chunk_samples=8)
        convert(ctr, ctr2, chunk_samples=8)
        convert(ctr2, jsonl, chunk_samples=8)
        a = read_trace(ctr)
        a2 = read_trace(ctr2)
        b = read_trace(jsonl)
        np.testing.assert_array_equal(a.tpa, grid.tpa)
        np.testing.assert_array_equal(a.clock_mhz, grid.clock_mhz)
        # v1 -> v2 conversion is bit-exact, not just value-equal
        assert a2.tpa.tobytes() == a.tpa.tobytes()
        assert a2.clock_mhz.tobytes() == a.clock_mhz.tobytes()
        np.testing.assert_array_equal(b.tpa, grid.tpa.astype(np.float64))
        assert a.t0_s == a2.t0_s == b.t0_s == 600.0
        # chunked replay onto the device covers every sample exactly once
        replay = TraceReplaySource(ctr)
        src = DeviceSource(replay, device)
        parts = []
        while not src.exhausted:
            g = src.poll(250.0)
            assert g.tpa.device == device, g.tpa.device
            if g.tpa.numel():
                parts.append(g.tpa.cpu().numpy())
        np.testing.assert_array_equal(np.concatenate(parts, axis=1),
                                      grid.tpa)
        assert replay.reader.peak_resident_samples < grid.tpa.size
    print(f"SELF-CHECK OK: csv -> ctr -> ctr2 -> jsonl exact, chunked "
          f"replay onto {device} complete, peak residency O(chunk)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", nargs="?", help="input trace (csv/jsonl/ctr)")
    ap.add_argument("dst", nargs="?", help="output trace (csv/jsonl/ctr)")
    ap.add_argument("--from", dest="src_fmt", default="auto",
                    choices=["auto", "csv", "jsonl", "columnar"])
    ap.add_argument("--to", dest="dst_fmt", default="auto",
                    choices=["auto", "csv", "jsonl", "columnar"])
    ap.add_argument("--chunk-samples", type=int,
                    default=tracestore.DEFAULT_CHUNK_SAMPLES,
                    help="samples per columnar chunk (columnar output "
                    "only; default %(default)s)")
    ap.add_argument("--interval-s", type=float, default=None,
                    help="scrape interval for single-poll row traces")
    ap.add_argument("--codec", default=None,
                    choices=[None, "auto"] + codecs.codec_names(),
                    help="ctr-v2 column codec (default: auto — "
                    f"{codecs.DEFAULT_CODEC}; .ctr2 output only)")
    ap.add_argument("--device", default=None,
                    help="torch device of the self-check's replay; the "
                    "card when omitted")
    ap.add_argument("--self-check", action="store_true",
                    help="round-trip a synthetic trace through all "
                    "formats and exit (smoke test)")
    args = ap.parse_args(argv)
    if args.self_check:
        return self_check(args.device)
    if not args.src or not args.dst:
        ap.error("src and dst are required (or pass --self-check)")
    convert(args.src, args.dst, src_fmt=args.src_fmt,
            dst_fmt=args.dst_fmt, chunk_samples=args.chunk_samples,
            interval_s=args.interval_s, codec=args.codec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
