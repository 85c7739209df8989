"""Production mesh construction.

Single pod : (data=16, model=16)            = 256 devices
Multi-pod  : (pod=2, data=16, model=16)     = 512 devices

A `Mesh` is the axis names and sizes that the sharding rules
(`launch.sharding`) and the dry run's parallelism choice
(`launch.dryrun.parallelism_for`) read, and the
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the open
process group that its DTensors live on (`device_mesh`, built on first
use).  The dry run opens a fake process group of 512 ranks in this one
process (`fake_world`), whose first 256 ranks carry the single-pod mesh,
so a trace sees the step as one device of the production mesh sees it;
a real group (`gloo`, `nccl`) carries a mesh of its own size.  Building
a `Mesh` touches no process group; only `device_mesh` does.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

#: ranks of the fake world: the multi-pod mesh, the single-pod mesh as its
#: first half
FAKE_WORLD = 512

#: DeviceMeshes built over the open process group, by (names, sizes, device
#: type); emptied when `fake_world` closes its group
_DEVICE_MESHES: dict = {}


@dataclass(frozen=True)
class Mesh:
    """A device mesh: axis names and their sizes, and (`device_mesh`) the
    DeviceMesh of the open process group's first `size` ranks."""

    axis_names: tuple
    axis_sizes: tuple
    #: the DTensors' device type; None: "cuda" on a PyTorch built with
    #: CUDA, else "cpu"
    device_type: Optional[str] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as a jax mesh's `shape`."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def device_mesh(self):
        """The DeviceMesh of ranks 0 .. size - 1 of the open process group,
        laid out row-major over the axes (the last axis varies fastest, as
        a jax mesh's devices)."""
        from torch.distributed.device_mesh import DeviceMesh
        if not dist.is_initialized():
            raise RuntimeError("no process group is open: enter "
                               "launch.mesh.fake_world() or init one")
        if dist.get_world_size() < self.size:
            raise RuntimeError(f"a {self.size}-device mesh needs as many "
                               f"ranks; the group has "
                               f"{dist.get_world_size()}")
        dtype = self.device_type or (
            "cuda" if torch.backends.cuda.is_built() else "cpu")
        key = (self.axis_names, self.axis_sizes, dtype)
        if key not in _DEVICE_MESHES:
            from torch.utils._python_dispatch import _disable_current_modes
            with _disable_current_modes():      # a real rank map, even
                ranks = torch.arange(self.size, device="cpu")  # in a trace
                _DEVICE_MESHES[key] = DeviceMesh(
                    dtype, ranks.reshape(self.axis_sizes),
                    mesh_dim_names=tuple(self.axis_names))
        return _DEVICE_MESHES[key]


@contextlib.contextmanager
def fake_world(size: int = FAKE_WORLD):
    """A fake process group of `size` ranks, this process rank 0, open
    for the block: its collectives move nothing and return tensors of the
    right shapes.  An open group is used as it is; on leaving, the group
    this opened is destroyed, so `dist.is_initialized()` is what it was."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        _DEVICE_MESHES.clear()
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The H100s' mesh.  Its device type is "cuda" even on a PyTorch built
    without CUDA, where its DTensors hold meta tensors: a "cpu" mesh would
    turn each all-to-all into an all-gather (gloo has no all-to-all)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16), "cuda")
    return Mesh(("data", "model"), (16, 16), "cuda")


def axes_of(mesh: Mesh) -> tuple[tuple[str, ...], str]:
    """(dp_axes, tp_axis) for a production mesh."""
    if "pod" in mesh.axis_names:
        return ("pod", "data"), "model"
    return ("data",), "model"


def make_ctx(mesh: Mesh):
    """The `ShardCtx` of a production mesh's (dp, tp) axes."""
    from repro_torch.models.common import ShardCtx
    dp, tp = axes_of(mesh)
    return ShardCtx(mesh=mesh, dp=dp, tp=tp)


def make_smoke_mesh(n: int = 1, *, data: int = 1,
                    device_type: Optional[str] = None) -> Mesh:
    """A (data, n) ("data", "model") mesh (tests; (1, 1) is one device)."""
    return Mesh(("data", "model"), (data, n), device_type)
