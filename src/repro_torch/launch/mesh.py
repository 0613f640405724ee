"""Meshes: their descriptions and the process meshes that run them.

The port of ``repro/launch/mesh.py``.  A :class:`MeshSpec` names a mesh's
axes and their sizes; it holds no devices (the dry-run computes layouts
and per-device bytes from it).  Single pod: (data=16, model=16), 256
chips; multi-pod: (pod=2, data=16, model=16), 512 chips; ``ONE_CARD``:
(data=1, model=1), one H100.  Scaling out grows "pod" and "data"; the
sharding rules never change.

A run on a mesh is one process per device (``torchrun``, or ranks a test
spawns).  :func:`init_distributed` joins the process group from
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``) or from an explicit ``init_method``:
NCCL for CUDA, gloo when the caller asks for the CPU.  Nothing picks gloo
on the card: if NCCL does not come up, that is the error.
:func:`build_device_mesh` makes the ``DeviceMesh`` of a ``MeshSpec`` (the
same axis names in the same order); a spec whose size differs from the
world raises, as ``make_production_mesh`` raises with too few devices.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch


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


def mesh_spec(device_mesh) -> MeshSpec:
    """The description of a ``DeviceMesh`` (its dim names and sizes)."""
    return MeshSpec(tuple(device_mesh.mesh_dim_names),
                    tuple(int(s) for s in device_mesh.mesh.shape))


def parse_mesh(text: str) -> MeshSpec:
    """``"DxM"`` -> (data=D, model=M), the serve launcher's ``--mesh``."""
    try:
        d, m = (int(p) for p in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DxM, e.g. 2x2") from None
    return MeshSpec(("data", "model"), (d, m))


def init_distributed(device_type: str = "cuda", *, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     timeout=None):
    """Join the default process group (a no-op if it is up already):
    NCCL for ``device_type`` "cuda", gloo for "cpu".  Rank and world come
    from the arguments or from ``RANK``/``WORLD_SIZE``; ``init_method``
    defaults to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``); ``timeout`` (a
    ``timedelta``) bounds every collective.  On CUDA the rank's device is
    ``LOCAL_RANK`` (else ``rank`` modulo the card count).  Returns ``(rank,
    world_size)``."""
    import torch.distributed as dist

    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type {device_type!r}: cuda or cpu")
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a card; pass the CPU "
                               "explicitly for gloo")
        local = int(os.environ.get("LOCAL_RANK",
                                    rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method or "env://", rank=rank,
                            world_size=world_size, **kw)
    return rank, world_size


def build_device_mesh(spec: MeshSpec, device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``spec`` over the whole world (ranks laid out
    row-major, the last axis fastest, as ``jax.make_mesh`` lays devices
    out).  The process group must be up (:func:`init_distributed`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if spec.size != world:
        raise RuntimeError(f"mesh {spec.shape} needs {spec.size} ranks, the "
                           f"world has {world}")
    _check_backend(device_type)
    return init_device_mesh(device_type, spec.sizes,
                            mesh_dim_names=spec.axis_names)


def _check_backend(device_type: str) -> None:
    import torch.distributed as dist

    backend = dist.get_backend()
    want = "nccl" if device_type == "cuda" else "gloo"
    if want not in str(backend):
        raise RuntimeError(f"a {device_type} mesh runs on {want}; the "
                           f"process group is {backend}")
