"""Per-step FLOPs, memory traffic and peak memory from a fake trace.

The reference reads these from XLA's compiled program (its HLO text,
with while-loop trip counts).  PyTorch runs eagerly and has no compiled
program to ask, so the port runs the step itself, once, on fake tensors
(`torch._subclasses.fake_tensor.FakeTensorMode`): every op computes its
output's shape, dtype and device and allocates nothing, and the kernels'
ops (`repro_torch::flash_attention`, `repro_torch::ssd_intra`) pass
through their fake versions, so the trace follows the card's own route.
On that trace:

  * FLOPs come from `torch.utils.flop_counter.FlopCounterMode`, which
    counts the matrix products and convolutions, and the kernels' ops by
    their registered formulas (the work their tilings compute);
  * HBM traffic follows the reference's rule for ops outside a fusion:
    output bytes x 2 (write, and an operand read of equal size) for
    every op that allocates; views and in-place ops allocate nothing;
  * peak memory comes from `LiveBytes`, which adds each new storage's
    bytes when an op allocates it and subtracts them when it dies
    (a weakref on the storage), the arguments live from the start;
  * collectives: one device, so every kind counts 0.

There is no HLO text here, so the reference's parser (`parse_module`,
`multiplicities`, `analyze`) has no counterpart.
"""
from __future__ import annotations

import contextlib
import functools
import time
import weakref
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
#: the caching allocator's block size: a storage holds its bytes rounded
#: up to it
ALLOC_ROUND = 512


@dataclass
class HloStats:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: dict = field(default_factory=dict)
    collective_counts: dict = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


@dataclass
class StepStats(HloStats):
    """`HloStats` of one traced step, with the FLOPs of each op and the
    step's memory: the bytes of the arguments it reads (as XLA, which
    drops an unused argument) and of its outputs (storages that are not
    the arguments'), both exact; the peak of the live bytes, each storage
    rounded as the caching allocator rounds it, every argument included
    (all are resident); and the temporaries' part of that peak (the peak
    less the arguments' rounded bytes)."""

    flops_by_op: dict = field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0
    temp_bytes: int = 0
    trace_s: float = 0.0


def rounded(n: int) -> int:
    """Bytes the caching allocator hands out for an n-byte storage."""
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


class LiveBytes(TorchDispatchMode):
    """Live and peak bytes of the storages that ops allocate.

    An op's output whose storage this mode has not seen is a new
    allocation: its bytes (rounded as the caching allocator rounds them)
    join the live total, and a weakref on the storage takes them out when
    it dies.  `hold` counts storages that exist already (a step's
    arguments).  `new_bytes` sums the new storages' exact bytes, the
    traffic rule's input."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.new_bytes = 0
        self._refs: dict = {}
        #: storages some op read (its inputs')
        self.read: set = set()

    def hold(self, tensors) -> tuple:
        """Count these tensors' storages as live: (exact, rounded) bytes
        of the storages."""
        sizes = [self._add(t) for t in tensors]
        return sum(n for n, _ in sizes), sum(r for _, r in sizes)

    def _add(self, t: torch.Tensor) -> tuple:
        """(exact, rounded) bytes of t's storage if it is new, else 0s."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return 0, 0
        n = st.nbytes()
        r = rounded(n)
        self._refs[key] = weakref.ref(st, functools.partial(self._free, key,
                                                            r))
        self.live += r
        self.peak = max(self.peak, self.live)
        return n, r

    def _free(self, key, n: int, _ref) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for t in _tensors([args, kwargs or {}]):
            self.read.add(t.untyped_storage()._cdata)
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self.new_bytes += self._add(t)[0]
        return out


def fake_mode() -> FakeTensorMode:
    """A fake mode that takes the real tensors it meets as constants."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def analyze_step(fn, *args, trackers=()) -> StepStats:
    """Run fn(*args) once, under the fake mode whose tensors `args` are
    (or plain meta tensors), counting FLOPs, traffic and peak memory.
    `trackers`: more `LiveBytes` to watch the same trace (each holding
    the arguments), read by the caller afterwards."""
    leaves = _tensors(args)
    mode = next((t.fake_mode for t in leaves
                 if hasattr(t, "fake_mode")), None)
    st = StepStats(collective_bytes=dict.fromkeys(_COLL_KINDS, 0.0),
                   collective_counts=dict.fromkeys(_COLL_KINDS, 0.0))
    tracker, *others = (LiveBytes(), *trackers)
    _, held = tracker.hold(leaves)
    for tr in others:
        tr.hold(leaves)
    arg_storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                    for t in leaves}
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if mode is not None:
            stack.enter_context(mode)
        counter = stack.enter_context(FlopCounterMode(display=False))
        for tr in (tracker, *others):
            stack.enter_context(tr)
        out = fn(*args)
    st.trace_s = time.perf_counter() - t0
    st.flops = float(counter.get_total_flops())
    st.flops_by_op = {str(op): float(n) for op, n in
                      counter.get_flop_counts().get("Global", {}).items()}
    st.argument_bytes = sum(n for key, n in arg_storages.items()
                            if key in tracker.read)
    st.traffic_bytes = 2.0 * tracker.new_bytes
    st.peak_bytes = tracker.peak
    st.temp_bytes = tracker.peak - held
    seen = set()
    for t in _tensors(out):
        key = t.untyped_storage()._cdata
        if key not in arg_storages and key not in seen:
            seen.add(key)
            st.output_bytes += t.untyped_storage().nbytes()
    return st
