"""The train step's phases as the program's own spans mark them, read
from a traced run: the profiler's record functions, by name
(`train.step`, `train.forward`, `train.backward`, `train.recompute`,
`train.optimizer`, `data.synthetic_batch`, `data.to_device`).

A device event belongs to the host call that issued it: a kernel to its
launch, and a copy or a memset, whose runtime call the trace's
`launches` leave out, to the launch issued just before it (the runtime
numbers its calls in the order they are made).  Every reading is a
step's share, over the `train.step` spans in the trace; a program that
opens no such span reads None.
"""
from __future__ import annotations

import bisect

STEP = "train.step"


def steps(t) -> int:
    """The number of `train.step` spans in trace `t` (0 without one)."""
    return 0 if t is None else sum(1 for op in t.ops if op[3] == STEP)


def _merged(spans: list) -> tuple:
    """(starts, [start, end] intervals) of spans, overlaps merged."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [s for s, _ in out], out


def _inside(merged: tuple, ts: float) -> bool:
    starts, iv = merged
    i = bisect.bisect_right(starts, ts) - 1
    return i >= 0 and ts <= iv[i][1]


def _issuers(t) -> dict:
    """{correlation: (tid, host µs)} of the call that issued each device
    event."""
    order = sorted((c, v) for c, v in t.launches.items() if c is not None)
    keys = [c for c, _ in order]
    out = {}
    for _, _, _, c in t.kernels:
        if c is None:
            continue
        i = bisect.bisect_right(keys, c) - 1
        if i >= 0:
            out[c] = order[i][1]
    return out


def device_ms(r, name: str, *, any_thread: bool = False):
    """Device ms a step issued inside the spans named `name`: from the
    span's own thread, or with `any_thread` from any thread while one is
    open.  None without a `train.step`."""
    t = r.trace
    n = steps(t)
    if not n:
        return None
    by_tid = {}
    for tid, ts, end, op, _ in t.ops:
        if op == name:
            by_tid.setdefault(None if any_thread else tid, []).append(
                (ts, end))
    spans = {tid: _merged(v) for tid, v in by_tid.items()}
    issuers = _issuers(t)
    total = 0.0
    for _, d, _, c in t.kernels:
        tid, ts = issuers.get(c, (None, None))
        m = spans.get(None if any_thread else tid)
        if m and ts is not None and _inside(m, ts):
            total += d
    return total / 1e3 / n


def host_ms(r, names: tuple):
    """Host ms a step inside the spans named in `names` (overlaps on a
    thread counted once).  None without a `train.step`."""
    t = r.trace
    n = steps(t)
    if not n:
        return None
    by_tid = {}
    for tid, ts, end, op, _ in t.ops:
        if op in names:
            by_tid.setdefault(tid, []).append((ts, end))
    total = sum(e - s for v in by_tid.values() for s, e in _merged(v)[1])
    return total / 1e3 / n
