"""The port's rollup wire formats (`repro_torch.fleet.wire`, FRU2, and
`StreamingRollup`'s npz snapshots, deltas and `merge_many`) against the
JAX package's.

The cases of the reference's `test_rollup_wire.py` that
`test_torch_slice.py` (npz snapshots and v2 deltas across the packages)
and `test_torch_telemetry.py` (`golden_rollup.fru2` decoded and
re-encoded) do not hold already, run on the port; each property also
builds the same rollup in the reference from the same draws and holds
the port's bytes and merged state equal to the reference's.
"""
import os

import numpy as np
import pytest

from _propcheck import given, settings, st

pytest.importorskip("torch")

import repro.fleet.streaming as R_streaming  # noqa: E402
from repro.fleet import wire as R_wire  # noqa: E402
import repro_torch.fleet.streaming as T_streaming  # noqa: E402
from repro_torch.fleet import wire  # noqa: E402
from repro_torch.fleet.streaming import StreamingRollup, WindowedRollup  # noqa: E402

GOLD_PATH = os.path.join(os.path.dirname(__file__), "data",
                         "golden_rollup.fru2")
GOLD_T_A = np.array([10.0, 30.0, 70.0])
GOLD_V_A = np.array([0.1, 1.0 / 3.0, 0.4123456789012345])
GOLD_T_B = np.array([70.0, 130.0])
GOLD_V_B = np.array([0.25, 0.0078125])
GOLD_META = {"job-a": {"chips": 256, "app_mfu": 0.381,
                       "arch": "granite-3-2b", "flops_variant": "bf16"}}


def _gold_rollup() -> StreamingRollup:
    roll = StreamingRollup(60.0, bins=8, lo=0.0, hi=1.1)
    roll.observe("job-a", GOLD_T_A, GOLD_V_A, group="bf16")
    roll.observe("job-b", GOLD_T_B, GOLD_V_B, group="fp8", weight=2.0)
    roll._job_meta = {k: dict(v) for k, v in GOLD_META.items()}
    return roll


def _rand_rollup(rng, *, bins=8, n_jobs=2, rounds=3, pkg=T_streaming):
    roll = pkg.StreamingRollup(60.0, bins=bins, lo=0.0, hi=1.1)
    for r in range(rounds):
        for j in range(n_jobs):
            n = int(rng.integers(1, 6))
            t = rng.uniform(r * 120.0, (r + 1) * 120.0, n)
            roll.observe(f"job-{j}", t, rng.uniform(0.0, 1.0, n),
                         group="bf16" if j % 2 else "fp8",
                         weight=float(rng.integers(1, 4)))
    return roll


def _both(seed, **kw):
    """The same seeded rollup built in the port and in the reference."""
    return (_rand_rollup(np.random.default_rng(seed), **kw),
            _rand_rollup(np.random.default_rng(seed), pkg=R_streaming, **kw))


def _assert_same_state(a, b, exact: bool = True) -> None:
    assert set(a._hists) == set(b._hists)
    for scope in a._hists:
        ah, bh = a._hists[scope], b._hists[scope]
        n = max(ah.shape[0], bh.shape[0])

        def grow(x, rows):
            out = np.zeros((rows,) + x.shape[1:])
            out[:x.shape[0]] = x
            return out
        if exact:
            np.testing.assert_array_equal(grow(ah, n), grow(bh, n),
                                          err_msg=f"scope {scope}")
            np.testing.assert_array_equal(grow(a._sums[scope], n),
                                          grow(b._sums[scope], n))
        else:
            np.testing.assert_allclose(grow(ah, n), grow(bh, n),
                                       rtol=1e-12, atol=1e-12,
                                       err_msg=f"scope {scope}")
            np.testing.assert_allclose(grow(a._sums[scope], n),
                                       grow(b._sums[scope], n),
                                       rtol=1e-12, atol=1e-12)


# -- golden blob: byte-exact encode from the observations -----------------
def test_golden_encode_is_byte_exact():
    with open(GOLD_PATH, "rb") as f:
        frozen = f.read()
    assert _gold_rollup().to_bytes_v2() == frozen


# -- zero-copy + validation ----------------------------------------------
def test_decode_returns_views_into_the_blob():
    blob = _gold_rollup().to_bytes_v2()
    raw = np.frombuffer(blob, np.uint8)
    snap = wire.decode(blob)
    for arr in (snap.edges, *(a for s in snap.scopes for a in s[1:])):
        assert not arr.flags.writeable
        assert np.shares_memory(arr, raw), \
            "decode must alias the blob, not copy out of it"


def test_decode_rejects_corruption():
    blob = _gold_rollup().to_bytes_v2()
    cases = [(b"XXXX" + blob[4:], "magic"), (blob[:-16], "truncated"),
             (blob[:12], "too short"),
             (blob[:4] + b"\x63\x00" + blob[6:], "version")]
    for bad, match in cases:
        with pytest.raises(ValueError, match=match) as mine:
            wire.decode(bad)
        with pytest.raises(ValueError) as ref:
            R_wire.decode(bad)
        assert str(mine.value) == str(ref.value)


def test_windowed_rollups_stay_on_npz():
    win = WindowedRollup(60.0, bins=8, retain=4)
    win.observe("j", np.array([30.0]), np.array([0.5]))
    with pytest.raises(ValueError, match="npz"):
        win.to_bytes_v2()
    with pytest.raises(ValueError, match="npz|windowed"):
        win.apply_snapshot(wire.decode(_gold_rollup().to_bytes_v2()))
    # but the npz path still round-trips it through the same entry point
    back = StreamingRollup.from_bytes(win.to_bytes())
    assert isinstance(back, WindowedRollup)


def test_restore_refuses_delta_blobs():
    roll = _gold_rollup()
    gen = roll.generation
    roll.observe("job-a", np.array([200.0]), np.array([0.9]),
                 group="bf16")
    with pytest.raises(ValueError, match="delta"):
        StreamingRollup.from_bytes(roll.delta_bytes(gen))


# -- cross-format round-trip ---------------------------------------------
@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_v2_and_npz_round_trip_identically(seed):
    roll, ref = _both(seed)
    via_npz = StreamingRollup.from_bytes(roll.to_bytes())
    via_v2 = StreamingRollup.from_bytes(roll.to_bytes_v2())
    _assert_same_state(via_npz, roll)
    _assert_same_state(via_v2, roll)
    assert via_v2._job_meta == roll._job_meta
    # and the restored rollup re-encodes to the byte-identical v2 blob,
    # the reference's blob of the same observations
    assert via_v2.to_bytes_v2() == roll.to_bytes_v2() == ref.to_bytes_v2()


# -- delta algebra --------------------------------------------------------
@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=2 ** 31 - 1),
       st.integers(min_value=1, max_value=4))
def test_delta_applied_to_base_reproduces_target(seed, extra_rounds):
    """apply(mirror_at_a, delta(a -> b)) == b, bucketwise exact, and the
    delta is the reference's, byte for byte."""
    rolls = []
    for pkg in (T_streaming, R_streaming):
        rng = np.random.default_rng(seed)
        roll = _rand_rollup(rng, pkg=pkg)
        mirror = pkg.StreamingRollup.from_bytes(roll.to_bytes_v2())
        cut = roll.generation
        for r in range(extra_rounds):
            n = int(rng.integers(1, 5))
            roll.observe(f"job-{int(rng.integers(0, 3))}",
                         rng.uniform(0.0, 600.0, n),
                         rng.uniform(0.0, 1.0, n), group="bf16")
        rolls.append((roll, mirror, roll.delta_bytes(cut)))
    (roll, mirror, delta), (_, _, ref_delta) = rolls
    assert delta == ref_delta
    assert len(delta) <= len(roll.to_bytes_v2())
    assert mirror.apply_delta(delta) is True
    _assert_same_state(mirror, roll)
    assert mirror.generation == roll.generation


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_duplicate_delivery_is_idempotent(seed):
    roll, ref = _both(seed)
    mirror = roll.spawn_empty()
    full = roll.delta_bytes(0)
    assert full == ref.delta_bytes(0)
    assert mirror.apply_delta(full) is True
    before = {s: mirror._hists[s].copy() for s in mirror._hists}
    # at-least-once: the same blob again, and a stale re-cut
    assert mirror.apply_delta(full) is False
    assert mirror.apply_delta(roll.delta_bytes(0)) is False
    for s, h in before.items():
        np.testing.assert_array_equal(mirror._hists[s], h)
    _assert_same_state(mirror, roll)


def test_gap_detection_names_the_generations():
    msgs = []
    for pkg in (T_streaming, R_streaming):
        roll = _rand_rollup(np.random.default_rng(0), pkg=pkg)
        mirror = roll.spawn_empty()
        cut = roll.generation
        roll.observe("job-0", np.array([50.0]), np.array([0.5]))
        with pytest.raises(ValueError, match="gap") as ei:
            mirror.apply_delta(roll.delta_bytes(cut))
        msgs.append(str(ei.value))
        # recovery: a full blob (since=0) always applies
        assert mirror.apply_delta(roll.delta_bytes(0)) is True
        _assert_same_state(mirror, roll)
    assert msgs[0] == msgs[1]


# -- merge_many == pairwise fold ------------------------------------------
@settings(max_examples=15, deadline=None)
@given(st.integers(min_value=0, max_value=2 ** 31 - 1),
       st.integers(min_value=1, max_value=9))
def test_merge_many_matches_pairwise_fold(seed, k):
    merged = []
    for pkg in (T_streaming, R_streaming):
        rng = np.random.default_rng(seed)
        parts = [_rand_rollup(rng, rounds=int(rng.integers(1, 4)), pkg=pkg)
                 for _ in range(k)]
        pairwise = parts[0].spawn_empty()
        for p in parts:
            pairwise.merge(p)
        kway = parts[0].spawn_empty().merge_many(parts)
        _assert_same_state(kway, pairwise, exact=False)
        assert kway._job_meta == pairwise._job_meta
        merged.append(kway)
    _assert_same_state(*merged)
    assert merged[0].to_bytes_v2() == merged[1].to_bytes_v2()


def test_merge_many_windowed_falls_back_to_pairwise():
    merged = []
    for pkg in (T_streaming, R_streaming):
        rng = np.random.default_rng(3)
        parts = []
        for i in range(4):
            win = pkg.WindowedRollup(60.0, bins=8, retain=4)
            t = rng.uniform(0.0, 600.0, 8)
            win.observe(f"job-{i % 2}", t, rng.uniform(0.0, 1.0, 8))
            parts.append(win)
        pairwise = parts[0].spawn_empty()
        for p in parts:
            pairwise.merge(p)
        kway = parts[0].spawn_empty().merge_many(parts)
        assert isinstance(kway, pkg.WindowedRollup)
        for scope in pairwise._hists:
            np.testing.assert_allclose(kway._hists[scope],
                                       pairwise._hists[scope], rtol=1e-12)
        merged.append(kway)
    _assert_same_state(*merged)


def test_merge_many_rejects_mismatched_bucketing():
    a = StreamingRollup(60.0, bins=8)
    b = StreamingRollup(60.0, bins=16)
    b.observe("j", np.array([30.0]), np.array([0.5]))
    with pytest.raises(ValueError, match="bucketing"):
        a.merge_many([b])
