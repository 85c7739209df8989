"""Pluggable column codecs for always-on counter recording.

A codec turns one aligned counter column — a `(n_devices, n_samples)`
array in its native dtype — into bytes and back, EXACTLY (bit-for-bit,
including NaN/Inf payloads).  The `ctr-v2` single-file container
(`telemetry.tracestore`) tags every chunk block with the codec that
wrote it, so archives mix codecs freely and readers never guess.

Three families:

  * ``raw`` — the array's native bytes.  Zero transform, zero copy on
    the mmap read path (`decode` returns a read-only view over the
    container's buffer), the speed-of-light baseline.
  * ``zlib`` — DEFLATE over the native bytes; what v1's `.npz` chunks
    effectively do, kept as the compatibility/back-compat point.
  * ``dbz`` — xor-delta along the time axis, then a bit-plane transpose
    (bitshuffle), then zstd when the optional ``zstandard`` module is
    present, zlib otherwise (tagged ``dbz-zstd`` / ``dbz-zlib`` so a
    reader knows which inner compressor to undo).  Counter series move
    slowly, so consecutive samples share high bits: the xor-delta zeroes
    them and the bit transpose lines the zeroed planes up into long runs
    the byte compressor eats.  On DCGM-wire-precision counters (tensor
    activity at ~3 decimals, SM clock in whole MHz — what `dcgmi`/NVML
    actually deliver) this lands ≥15x smaller than CSV; on synthetic
    full-precision f32 noise it still beats the zlib-npz path, pinned by
    the `trace_codecs` BENCH case.

The transform is LOSSLESS by construction: it permutes and xors bit
patterns, never rounds values — NaN payloads, signed zeros and Inf all
round-trip (the property suite in `tests/test_codecs.py` asserts bit
identity, not value closeness).
"""
from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

try:                                     # optional: the container image
    import zstandard as _zstd            # does not ship zstandard
except ImportError:                      # pragma: no cover - env specific
    _zstd = None

HAVE_ZSTD = _zstd is not None

#: zlib/zstd effort levels — decode speed is flat in these, so they only
#: trade encode time for bytes; 6 is zlib's sweet spot on shuffled planes
ZLIB_LEVEL = 6
ZSTD_LEVEL = 7


def _uint_view(arr: np.ndarray) -> np.ndarray:
    """Reinterpret a numeric array as same-width unsigned ints (the
    domain the delta/shuffle transform operates in)."""
    kind = arr.dtype.kind
    if kind not in "fiu" or arr.dtype.itemsize not in (2, 4, 8):
        raise ValueError(
            f"codec supports 2/4/8-byte int and float columns, not "
            f"{arr.dtype}")
    return arr.view(f"u{arr.dtype.itemsize}")


def bit_transpose(u: np.ndarray) -> bytes:
    """Bitshuffle: regroup an unsigned-int array by BIT PLANE.

    Element k's bit b moves to position (b * n + k) of the output
    stream — all the sign bits together, then all the top-exponent
    bits, and so on.  Near-constant planes become runs of identical
    bytes; pure numpy (unpackbits/packbits), no compiled extension.
    """
    n, isz = u.size, u.dtype.itemsize
    if n == 0:
        return b""
    bits = np.unpackbits(u.reshape(-1).view(np.uint8).reshape(n, isz),
                         axis=1, bitorder="little")        # (n, 8*isz)
    return np.packbits(bits.T, bitorder="little").tobytes()


def bit_untranspose(data: bytes, n: int, itemsize: int) -> np.ndarray:
    """Invert `bit_transpose` back to n unsigned ints of `itemsize`."""
    if n == 0:
        return np.empty(0, dtype=f"u{itemsize}")
    nbits = 8 * itemsize
    bits = np.unpackbits(np.frombuffer(data, np.uint8),
                         bitorder="little")[:n * nbits]
    planes = bits.reshape(nbits, n)
    packed = np.packbits(planes.T, bitorder="little")
    # nbits is a multiple of 8, so the packed stream is exactly
    # n * itemsize bytes — no tail padding to trim
    return np.frombuffer(packed.tobytes(), dtype=f"u{itemsize}")


class Codec:
    """Interface: encode a column to bytes, decode it back exactly.

    `decode` receives the dtype and (n_devices, n_samples) shape the
    container recorded — codecs carry no geometry of their own.
    """

    #: tag written into the container's chunk table
    name: str = ""

    def encode(self, arr: np.ndarray) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes, dtype: np.dtype,
               shape: tuple) -> np.ndarray:
        raise NotImplementedError


class RawCodec(Codec):
    """Native array bytes; decode is a zero-copy view over the input
    buffer (read-only when the buffer is, e.g. an mmap'd archive)."""

    name = "raw"

    def encode(self, arr: np.ndarray) -> bytes:
        return np.ascontiguousarray(arr).tobytes()

    def decode(self, data, dtype, shape) -> np.ndarray:
        return np.frombuffer(data, dtype=dtype).reshape(shape)


class ZlibCodec(Codec):
    """DEFLATE over native bytes — the v1 `.npz` behaviour as a plain
    block codec (the back-compat point for tooling that expects it)."""

    name = "zlib"

    def encode(self, arr: np.ndarray) -> bytes:
        return zlib.compress(np.ascontiguousarray(arr).tobytes(),
                             ZLIB_LEVEL)

    def decode(self, data, dtype, shape) -> np.ndarray:
        return np.frombuffer(zlib.decompress(data),
                             dtype=dtype).reshape(shape)


class DeltaBitshuffleCodec(Codec):
    """xor-delta (time axis) + bit-plane transpose + zstd-or-zlib.

    The delta is an XOR of each sample with its predecessor IN THE SAME
    DEVICE ROW — exactly invertible in integer space with no overflow
    cases, and it zeroes every bit the two float patterns share.
    """

    def __init__(self, inner: str = "zstd" if HAVE_ZSTD else "zlib"):
        if inner == "zstd" and not HAVE_ZSTD:
            raise ValueError(
                "dbz-zstd codec requires the 'zstandard' module, which "
                "is not installed; use dbz-zlib (decoders pick the "
                "right inner compressor from the chunk's codec tag)")
        if inner not in ("zstd", "zlib"):
            raise ValueError(f"unknown inner compressor {inner!r}")
        self.inner = inner
        self.name = f"dbz-{inner}"

    # -- inner byte compressor -----------------------------------------
    def _squeeze(self, data: bytes) -> bytes:
        if self.inner == "zstd":
            return _zstd.ZstdCompressor(level=ZSTD_LEVEL).compress(data)
        return zlib.compress(data, ZLIB_LEVEL)

    def _unsqueeze(self, data: bytes) -> bytes:
        if self.inner == "zstd":
            return _zstd.ZstdDecompressor().decompress(data)
        return zlib.decompress(data)

    # -- Codec ----------------------------------------------------------
    def encode(self, arr: np.ndarray) -> bytes:
        arr = np.ascontiguousarray(arr)
        u = _uint_view(arr)
        d = u.copy()
        if d.ndim >= 1 and d.shape[-1] > 1:
            d[..., 1:] ^= u[..., :-1]
        return self._squeeze(bit_transpose(d))

    def decode(self, data, dtype, shape) -> np.ndarray:
        dtype = np.dtype(dtype)
        n = int(np.prod(shape)) if shape else 0
        u = bit_untranspose(self._unsqueeze(data) if n else b"",
                            n, dtype.itemsize).reshape(shape).copy()
        if u.ndim >= 1 and u.shape[-1] > 1:
            np.bitwise_xor.accumulate(u, axis=-1, out=u)
        return u.view(dtype)


#: the registry the container resolves chunk tags against
_CODECS: dict = {}
for _c in (RawCodec(), ZlibCodec(), DeltaBitshuffleCodec("zlib")):
    _CODECS[_c.name] = _c
if HAVE_ZSTD:                            # pragma: no cover - env specific
    _CODECS["dbz-zstd"] = DeltaBitshuffleCodec("zstd")

#: what `codec="auto"` resolves to: the best always-available recorder
DEFAULT_CODEC = "dbz-zstd" if HAVE_ZSTD else "dbz-zlib"


def get_codec(name: Optional[str]) -> Codec:
    """Resolve a codec tag (or None/'auto' for the default)."""
    if name in (None, "auto"):
        name = DEFAULT_CODEC
    if name == "dbz":                    # family alias -> concrete tag
        name = DEFAULT_CODEC
    codec = _CODECS.get(name)
    if codec is None:
        if name == "dbz-zstd":
            raise ValueError(
                "archive chunk was written with dbz-zstd but the "
                "'zstandard' module is not installed in this "
                "environment; install it to read this archive")
        raise ValueError(f"unknown codec {name!r} "
                         f"(have {sorted(_CODECS)})")
    return codec


def codec_names() -> list:
    """Registered codec tags (environment-dependent: dbz-zstd appears
    only when zstandard is installed)."""
    return sorted(_CODECS)
