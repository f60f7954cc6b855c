"""Production meshes as plain values: axis names and sizes.

The reference builds ``jax`` meshes of 256 or 512 forged devices.  No
machine holds a 256-rank world, and nothing in the port runs
model-parallel, so a mesh here is what the sharding rules read: its axis
names and their sizes.  These are functions that never touch device or
process-group state when the module is imported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes (the shape of the reference's mesh)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Devices in the mesh."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 chips a pod (data x model); 2 x 16 x 16 = 512 across
    two pods."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_zero_mesh(*, multi_pod: bool = False) -> Mesh:
    """All chips on the ZeRO / data axis: the DynaComm bucketed trainer's
    mesh (pure data parallelism, the paper's Section III)."""
    if multi_pod:
        return Mesh(("pod", "data"), (2, 256))
    return Mesh(("data",), (256,))


def make_host_mesh(num_devices: Optional[int] = None,
                   axes=("data",)) -> Mesh:
    """A 1-D mesh over the live process group (its world size, or 1 when
    none is initialised), or over ``num_devices``."""
    if len(axes) != 1:
        raise ValueError("provide 1-D axes or build your own mesh")
    if num_devices is None:
        import torch.distributed as dist
        num_devices = (dist.get_world_size() if dist.is_available()
                       and dist.is_initialized() else 1)
    return Mesh(tuple(axes), (int(num_devices),))
