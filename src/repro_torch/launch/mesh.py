"""Production mesh shapes, as axis names and sizes.

Single pod : (data=16, model=16)            = 256 chips
Multi-pod  : (pod=2, data=16, model=16)     = 512 chips

The port runs on one device and places nothing: a `Mesh` here is only
the names and sizes that the sharding rules (`launch.sharding`) and the
dry run's parallelism choice (`launch.dryrun.parallelism_for`) read.
No function touches a device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Mesh:
    """An abstract device mesh: axis names and their sizes."""

    axis_names: tuple
    axis_sizes: tuple

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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def axes_of(mesh: Mesh) -> tuple[tuple[str, ...], str]:
    """(dp_axes, tp_axis) for a production mesh."""
    if "pod" in mesh.axis_names:
        return ("pod", "data"), "model"
    return ("data",), "model"


def make_smoke_mesh(n: int = 1) -> Mesh:
    """A (1, n) ("data", "model") mesh (tests)."""
    return Mesh(("data", "model"), (1, n))
