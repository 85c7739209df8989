"""The device trace of a traced run and the reductions the per-layer
metrics read from it.

`record` runs a callable under `torch.profiler` (CPU and CUDA
activities), exports the Chrome trace into a fixed file inside the
checkout, reads it back into a `Trace` and deletes the file.  A kernel
belongs to a host op when the runtime call that launched it lies inside
that op's interval on the same thread (autograd's backward runs on its
own thread, with its nodes, such as `FlashAttentionBackward`, as ops).
"""
from __future__ import annotations

import bisect
import json
import os
import sys
import time
from pathlib import Path

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation")
_LAUNCH_WORDS = ("LaunchKernel", "LaunchCooperativeKernel", "GraphLaunch")
#: the host annotation around the traced window
WINDOW = "bench.window"


def record(fn, path: Path, *, record_shapes: bool, device):
    """(fn's result, Trace of the call).  The window is the call, with
    the device synchronised at its end, as the trace times it (the host
    clock's time where the trace lacks the annotation); device activity
    is counted inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts, record_shapes=record_shapes) as prof:
        sync()
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            out = fn()
            sync()
            window = time.perf_counter() - t0
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    t = Trace(events, window)
    print(f"trace: {len(t.kernels)} device events, {t.n_launches} launches, "
          f"{len(t.ops)} host ops, window {t.window_s:.3f} s",
          file=sys.stderr)
    return out, t


class Trace:
    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        self.kernels = []       # (ts µs, dur µs, name, correlation)
        self.launches = {}      # correlation -> (tid, ts µs)
        self.ops = []           # (tid, ts, end, name, args)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            if cat in _DEVICE_CATS:
                self.kernels.append((float(e["ts"]), float(e.get("dur", 0)),
                                     e["name"], args.get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if any(w in e["name"] for w in _LAUNCH_WORDS):
                    self.launches[args.get("correlation")] = (
                        e.get("tid"), float(e["ts"]))
            elif cat in _HOST_CATS:
                ts = float(e["ts"])
                self.ops.append((e.get("tid"), ts, ts + float(e.get("dur", 0)),
                                 e["name"], args))
        marks = [(ts, end) for _, ts, end, n, _ in self.ops if n == WINDOW]
        if marks:
            lo, hi = marks[0]
            self.window_s = (hi - lo) / 1e6
            self.kernels = [(max(ts, lo), min(ts + d, hi) - max(ts, lo), n, c)
                            for ts, d, n, c in self.kernels
                            if ts < hi and ts + d > lo]
        self.kernels.sort()

    # -- the device as a whole ----------------------------------------------
    def busy_intervals(self) -> list:
        out = []
        for ts, dur, _, _ in self.kernels:
            end = ts + dur
            if out and ts <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([ts, end])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    @property
    def n_launches(self) -> int:
        return len(self.launches)

    def device_s(self, pred) -> float:
        """Seconds of device activity in kernels whose name `pred` keeps."""
        return sum(d for _, d, n, _ in self.kernels if pred(n)) / 1e6

    # -- under host ops -------------------------------------------------------
    def calls(self, name: str) -> list:
        """(args, device seconds) of each host op named exactly `name`."""
        by_tid = {}
        for corr, (tid, ts) in self.launches.items():
            by_tid.setdefault(tid, []).append((ts, corr))
        for v in by_tid.values():
            v.sort()
        dur = {}
        for _, d, _, corr in self.kernels:
            dur[corr] = dur.get(corr, 0.0) + d
        out = []
        for tid, ts, end, n, args in self.ops:
            if n != name:
                continue
            lst = by_tid.get(tid, [])
            i = bisect.bisect_left(lst, (ts, -1))
            s = 0.0
            while i < len(lst) and lst[i][0] <= end:
                s += dur.get(lst[i][1], 0.0)
                i += 1
            out.append((args, s / 1e6))
        return out

    def device_s_under(self, word: str) -> float:
        """Seconds of device activity launched inside host ops whose name
        holds `word` (nested ops counted once)."""
        spans = {}
        for tid, ts, end, n, _ in self.ops:
            if word in n:
                spans.setdefault(tid, []).append((ts, end))
        merged = {}
        for tid, v in spans.items():
            v.sort()
            m = []
            for s, e in v:
                if m and s <= m[-1][1]:
                    m[-1][1] = max(m[-1][1], e)
                else:
                    m.append([s, e])
            merged[tid] = m
        total = 0.0
        starts = {tid: [s for s, _ in m] for tid, m in merged.items()}
        for _, d, _, corr in self.kernels:
            tid, ts = self.launches.get(corr, (None, None))
            m = merged.get(tid)
            if not m:
                continue
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and ts <= m[i][1]:
                total += d
        return total / 1e6

    # -- the breakdown a result line carries --------------------------------
    def breakdown(self, n: int = 10) -> dict:
        by_name = {}
        for _, d, name, _ in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        busy = self.busy_intervals()
        gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])),
                      reverse=True)[:n]
        named = []
        for gap, at in gaps:
            inner = None            # the innermost host op open at the gap
            for _, ts, end, name, _ in self.ops:
                if ts <= at <= end and (inner is None or ts >= inner[0]):
                    inner = (ts, name)
            named.append([inner[1] if inner else "no host op", gap / 1e6])
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k[:160], v] for k, v in named]}
