"""Per-device FLOPs, memory traffic, peak memory and collectives from a
fake trace.

The reference reads these from XLA's compiled SPMD program (its HLO
text, with while-loop trip counts).  PyTorch runs eagerly and has no
compiled program to ask, so the port runs the step itself, once, on fake
tensors (`torch._subclasses.fake_tensor.FakeTensorMode`, or meta
tensors): every op computes its output's shape, dtype and device and
allocates nothing, and the kernels' ops (`repro_torch::flash_attention`,
`repro_torch::ssd_intra`) pass through their fake versions, so the trace
follows the card's own route.  On a mesh the step's tensors are DTensors
over a fake process group (`launch.mesh.fake_world`), and the trace is
one device's: every mode here steps aside for a DTensor-level op
(returns NotImplemented, so DTensor dispatches it) and counts the ops
DTensor then runs on the local shards, the collectives among them; the
ops DTensor runs on global shapes to propagate its metadata (on fake
tensors, or on meta tensors that carry its spec) are no device's, and
are left out (`_propagating`).  On that trace:

  * FLOPs come from `torch.utils.flop_counter.FlopCounterMode`, which
    counts the matrix products and convolutions, and the kernels' ops by
    their registered formulas (the work their tilings compute);
  * HBM traffic follows the reference's rule for ops outside a fusion:
    output bytes x 2 (write, and an operand read of equal size) for
    every op that allocates; views and in-place ops allocate nothing;
  * peak memory comes from `LiveBytes`, which adds each new storage's
    bytes when an op allocates it and subtracts them when it dies
    (a weakref on the storage), the arguments live from the start, and
    names the storages live at the peak (`at_peak`);
  * collectives come from `Collectives`, which reads each functional
    collective that redistribution issues (`_c10d_functional`, and
    DTensor's own all-to-all) under the reference's five kinds: its
    result bytes x (g-1)/g on the wire, twice that for an all-reduce,
    x 1 for a permute, g the op's group size (the reference's rule).

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
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode

from repro_torch.kernels.sharding import dtensor_type, is_dtensor

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
    #: the storages live at the peak by label (`LiveBytes.at_peak`)
    at_peak: list = field(default_factory=list)
    trace_s: float = 0.0


def rounded(n: int) -> int:
    """Bytes the caching allocator hands out for an n-byte storage."""
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


#: whether the trace's tensors are DTensors over meta shards
_PLACED = [False]


def _steps_aside(types) -> bool:
    """A mode lets DTensor dispatch a DTensor-level op (and then sees its
    ops on the local shards)."""
    cls = dtensor_type()
    return any(issubclass(t, cls) for t in types)


def _propagating(tensors) -> bool:
    """The op is DTensor's own, run on global shapes to learn an output's
    shape and placements, no device's work: on fake tensors (the shape),
    or on meta tensors that carry a DTensor spec while it traces an op's
    decomposition (the placements of an op with no rule).  In a trace
    over meta shards no other tensor is either."""
    return _PLACED[0] and any(is_fake(t) or hasattr(t, "_spec")
                              for t in tensors)


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, a DTensor's local
    shard in its place."""
    if isinstance(tree, torch.Tensor):
        return [tree.to_local()] if is_dtensor(tree) else [tree]
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
    traffic rule's input.  `at_peak` names what is live at the peak."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.new_bytes = 0
        self._refs: dict = {}
        #: storages some op read (its inputs')
        self.read: set = set()
        #: each storage's [label, rounded bytes, born, died] on a clock
        #: that ticks at each allocation and each free (`at_peak`)
        self._log: list = []
        self._clock = self._peak_clock = 0
        #: the DTensor-level op whose local ops run now
        self._outer = "-"

    def hold(self, tensors) -> tuple:
        """Count these tensors' storages as live: (exact, rounded) bytes
        of the storages."""
        sizes = [self._add(t, "argument") for t in tensors]
        return sum(n for n, _ in sizes), sum(r for _, r in sizes)

    def _add(self, t: torch.Tensor, label: str) -> tuple:
        """(exact, rounded) bytes of t's storage if it is new, else 0s."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return 0, 0
        n = st.nbytes()
        r = rounded(n)
        self._clock += 1
        entry = [label, r, self._clock, None]
        self._log.append(entry)
        self._refs[key] = weakref.ref(st, functools.partial(self._free, key,
                                                            entry))
        self.live += r
        if self.live > self.peak:
            self.peak, self._peak_clock = self.live, self._clock
        return n, r

    def _free(self, key, entry: list, _ref) -> None:
        if self._refs.pop(key, None) is not None:
            self._clock += 1
            entry[3] = self._clock
            self.live -= entry[1]

    def at_peak(self, top: int = 12) -> list:
        """The storages live at the peak, grouped by label (the op that
        allocated them, under the DTensor-level op it ran for, and their
        shape and dtype): [label, count, rounded bytes], the `top`
        largest totals first."""
        groups: dict = {}
        for label, r, born, died in self._log:
            if born <= self._peak_clock and (died is None
                                             or died > self._peak_clock):
                g = groups.setdefault(label, [label, 0, 0])
                g[1] += 1
                g[2] += r
        return sorted(groups.values(), key=lambda g: -g[2])[:top]

    def _label(self, func, t: torch.Tensor) -> str:
        return (f"{self._outer}>{func.__name__} {tuple(t.shape)} "
                f"{str(t.dtype).removeprefix('torch.')}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _steps_aside(types):
            self._outer = func.__name__
            return NotImplemented
        inputs = _tensors([args, kwargs or {}])
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if _propagating(inputs + outs):
            return out
        for t in inputs:
            self.read.add(t.untyped_storage()._cdata)
        for t in outs:
            if t.untyped_storage()._cdata not in self._refs:
                self.new_bytes += self._add(t, self._label(func, t))[0]
        return out


#: the functional collectives' kinds, as the reference names them
_COLL_OPS = {"all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_reduce": "all-reduce",
             "all_to_all_single": "all-to-all",
             "shard_dim_alltoall": "all-to-all",
             "permute_tensor": "collective-permute"}


def _group_size(func, args, kwargs) -> int:
    """The group size of a functional collective: its `group_size`
    argument, else the size of the group its `group_name` names."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs or {})
    if "group_size" in named:
        return int(named["group_size"])
    return _resolve_process_group(named["group_name"]).size()


def wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Bytes one device sends for a collective: the reference's rule."""
    frac = (g - 1) / g if g > 1 else 0.0
    if kind == "all-reduce":
        return result_bytes * 2 * frac
    if kind == "collective-permute":
        return result_bytes * 1.0
    return result_bytes * frac


class Collectives(TorchDispatchMode):
    """Wire bytes and counts, by kind, of the collectives a device issues
    (`_COLL_OPS`, on its local shards)."""

    def __init__(self):
        super().__init__()
        self.bytes = dict.fromkeys(_COLL_KINDS, 0.0)
        self.counts = dict.fromkeys(_COLL_KINDS, 0.0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _steps_aside(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = _COLL_OPS.get(func._schema.name.split("::")[-1])
        if kind is not None and not _propagating(_tensors(out)):
            g = _group_size(func, args, kwargs)
            result = sum(t.numel() * t.element_size() for t in _tensors(out))
            self.bytes[kind] += wire_bytes(kind, result, g)
            self.counts[kind] += 1
        return out


class _LocalFlopMode(_FlopCounterMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _steps_aside(types):
            return NotImplemented
        if _propagating(_tensors([args, kwargs or {}])):
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class LocalFlopCounter(FlopCounterMode):
    """`FlopCounterMode` that counts a device's ops only: the ops on its
    local shards, not the DTensor-level ops over global shapes."""

    def __enter__(self):
        self.flop_counts.clear()
        self.mod_tracker.__enter__()
        self.mode = _LocalFlopMode(self)
        self.mode.__enter__()
        return self


@contextlib.contextmanager
def _placed(on: bool):
    was, _PLACED[0] = _PLACED[0], on
    try:
        yield
    finally:
        _PLACED[0] = was


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, DTensors whole."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return []


def fake_mode() -> FakeTensorMode:
    """A fake mode that takes the real tensors it meets as constants."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def analyze_step(fn, *args, trackers=()) -> StepStats:
    """Run fn(*args) once, under the fake mode whose tensors `args` are
    (or plain meta tensors), counting FLOPs, traffic, peak memory and
    collectives, a device's own where `args` hold DTensors.  `trackers`:
    more `LiveBytes` to watch the same trace (each holding the
    arguments), read by the caller afterwards."""
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
        stack.enter_context(_placed(any(is_dtensor(t) for t in
                                        _leaves(args))))
        counter = stack.enter_context(LocalFlopCounter(display=False))
        coll = stack.enter_context(Collectives())
        for tr in (tracker, *others):
            stack.enter_context(tr)
        out = fn(*args)
    st.trace_s = time.perf_counter() - t0
    st.collective_bytes, st.collective_counts = coll.bytes, coll.counts
    st.flops = float(counter.get_total_flops())
    st.flops_by_op = {str(op): float(n) for op, n in
                      counter.get_flop_counts().get("Global", {}).items()}
    st.argument_bytes = sum(n for key, n in arg_storages.items()
                            if key in tracker.read)
    st.traffic_bytes = 2.0 * tracker.new_bytes
    st.peak_bytes = tracker.peak
    st.temp_bytes = tracker.peak - held
    st.at_peak = tracker.at_peak()
    seen = set()
    for t in _tensors(out):
        key = t.untyped_storage()._cdata
        if key not in arg_storages and key not in seen:
            seen.add(key)
            st.output_bytes += t.untyped_storage().nbytes()
    return st
