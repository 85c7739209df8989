"""DTensor sharding rules for the kernels' ops.

On a device mesh the flash and SSD kernels' inputs are DTensors, and
DTensor needs a rule to run `repro_torch::flash_attention` and
`repro_torch::ssd_intra` on each device's shards: the acceptable
placements of the inputs and the output, one mesh dimension at a time
(`torch.distributed.tensor.experimental.register_sharding`).  Each op
then launches once a device on its local shards, so its fake version and
FLOP formula see local shapes.  Any placement outside the rule's is
first redistributed to the cheapest one inside it; the rule lists
"replicate everything" explicitly, so an op on inputs that no sharding
fits gathers them.  The rules are registered on the first DTensor call
(`ensure`), so importing a kernel module imports nothing of
`torch.distributed`.
"""
from __future__ import annotations

import math

import torch
from torch._subclasses.fake_tensor import is_fake

_REGISTERED: set = set()


_DTENSOR: list = []


def dtensor_type() -> type:
    """DTensor's class (imported once), or a class nothing is an instance
    of where PyTorch has no torch.distributed."""
    if not _DTENSOR:
        if torch.distributed.is_available():
            from torch.distributed.tensor import DTensor
            _DTENSOR.append(DTensor)
        else:
            _DTENSOR.append(type("NoDTensor", (), {}))
    return _DTENSOR[0]


def is_dtensor(t) -> bool:
    return isinstance(t, dtensor_type())


def launched(out: torch.Tensor) -> bool:
    """Whether producing `out` launched a kernel: its (local) tensor is a
    real CUDA tensor, not a fake, meta or CPU one."""
    t = out.to_local() if is_dtensor(out) else out
    return t.is_cuda and not is_fake(t) and not t.is_meta


def ensure(op, rule) -> None:
    """Register `rule` as `op`'s sharding rule, once."""
    if op in _REGISTERED:
        return
    from torch.distributed.tensor.experimental import register_sharding
    register_sharding(op)(rule)
    _REGISTERED.add(op)


def contiguous_strides(shape) -> tuple:
    """Strides of a contiguous tensor of `shape` (a DTensor's global
    strides, computed without making the tensor)."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def mesh_sizes(spec) -> tuple:
    """The sizes of the mesh dimensions a DTensor spec lies on."""
    return tuple(spec.mesh.shape)


def divides_each(n: int, sizes) -> bool:
    """n splits evenly over any one mesh dimension."""
    return all(n % m == 0 for m in sizes)


def check_split(out: torch.Tensor, dim: int, *counts: int) -> None:
    """Raise unless every count splits evenly over the mesh dimensions
    that shard `out`'s dimension `dim` together: a rule offers a split
    that fits each mesh dimension alone, and DTensor may combine them."""
    if not is_dtensor(out):
        return
    from torch.distributed.tensor import Shard
    ways = math.prod(out.device_mesh.size(i)
                     for i, p in enumerate(out.placements)
                     if isinstance(p, Shard) and p.dim == dim)
    bad = [n for n in counts if n % ways]
    if bad:
        raise ValueError(f"dimension {dim} split {ways} ways does not "
                         f"divide {bad}")


def on_shards(fn, args, places, outs):
    """fn run on each device's shards of the DTensors `args`: each
    redistributed to its placements in `places` (a plain tensor taken as
    replicated) and handed to fn as its local shard; fn's outputs become
    DTensors, one for each (placements, global shape) of `outs`.  Over a
    mesh dimension that splits the work (some input is split there), an
    input used whole on each device takes a partial sum of its gradient
    there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    whole = [Replicate()] * mesh.ndim
    split = [any(not p[i].is_replicate() for p in places)
             for i in range(mesh.ndim)]
    local = []
    for a, place in zip(args, places):
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, whole, run_check=False)
        grad = [Partial() if s and p.is_replicate() else p
                for s, p in zip(split, place)]
        local.append(a.redistribute(mesh, place)
                     .to_local(grad_placements=grad))
    ys = fn(*local)
    one = isinstance(ys, torch.Tensor)
    ys = [DTensor.from_local(y, mesh, place, run_check=False, shape=shape,
                             stride=contiguous_strides(shape))
          for y, (place, shape) in zip([ys] if one else ys, outs)]
    return ys[0] if one else tuple(ys)
