"""Mesh descriptions.

The port of ``repro/launch/mesh.py``.  A :class:`MeshSpec` names a mesh's
axes and their sizes; it holds no devices and runs nothing (the dry-run
computes layouts and per-device bytes from it).  Single pod: (data=16,
model=16), 256 chips; multi-pod: (pod=2, data=16, model=16), 512 chips;
``ONE_CARD``: (data=1, model=1), one H100.  Scaling out grows "pod" and
"data"; the sharding rules never change.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A device mesh as a description: ``axis_names`` and their sizes."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """Ordered axis name -> size (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> MeshSpec:
    """A small mesh for tests."""
    return MeshSpec(tuple(axes), tuple(shape))


ONE_CARD = MeshSpec(("data", "model"), (1, 1))
