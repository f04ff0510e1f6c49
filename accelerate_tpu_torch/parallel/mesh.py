"""The mesh of ranks: the port of `accelerate_tpu.parallel.mesh`.

The reference lays one ``jax.sharding.Mesh`` over every device of the job,
one process per host. The port runs one process per device, so its mesh is
over ranks: `build_mesh` returns a `Mesh` whose ``shape`` maps each axis of
`utils.constants.MESH_AXIS_NAMES` to its size, as the reference's does, and
which holds a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
(``device_mesh``) when a process group exists. At one process with no group
it is a stand-in whose axes are all 1, so ``accelerator.mesh.shape["data"]``
reads 1 as the reference's one-device mesh does.

`ParallelismConfig`'s arithmetic (``axis_sizes``, ``-1`` for the one axis
inferred) is the reference's. Only the ``data`` axis is ported: any other
axis above 1 raises NotImplementedError (ROADMAP Queue 1, item 21.3), as do
the reference's ``serving_mesh`` and ``inside_shard_map``, which are not
here (item 21.4 and the shard_map-based axes of item 21.3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Any

from ..utils.constants import MESH_AXIS_NAMES


@dataclass
class ParallelismConfig:
    """Degrees for each mesh axis; ``-1`` on ``data_parallel_size`` means
    every rank left over (the reference's fields and defaults)."""

    data_parallel_size: int = -1
    fsdp_size: int = 1
    stage_size: int = 1
    sequence_size: int = 1
    tensor_size: int = 1

    def axis_sizes(self, num_devices: int) -> dict[str, int]:
        """Each axis's size over ``num_devices`` ranks (reference
        `parallel/mesh.py:47-72`)."""
        sizes = {
            "data": self.data_parallel_size,
            "fsdp": self.fsdp_size,
            "stage": self.stage_size,
            "sequence": self.sequence_size,
            "tensor": self.tensor_size,
        }
        fixed = math.prod(v for v in sizes.values() if v != -1)
        n_infer = sum(1 for v in sizes.values() if v == -1)
        if n_infer > 1:
            raise ValueError("At most one mesh axis may be -1 (inferred).")
        if n_infer == 1:
            if num_devices % fixed != 0:
                raise ValueError(
                    f"Cannot infer axis size: {num_devices} devices not divisible by {fixed}.")
            sizes = {k: (num_devices // fixed if v == -1 else v) for k, v in sizes.items()}
        total = math.prod(sizes.values())
        if total != num_devices:
            raise ValueError(f"Mesh {sizes} covers {total} devices but {num_devices} are available.")
        return sizes

    @classmethod
    def from_kwargs(cls, **kwargs: Any) -> "ParallelismConfig":
        valid = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in kwargs.items() if k in valid})

    @property
    def non_data_degree(self) -> int:
        return (max(self.fsdp_size, 1) * max(self.stage_size, 1) * max(self.sequence_size, 1)
                * max(self.tensor_size, 1))


class Mesh:
    """Named axes over the ranks. ``shape`` is ``{axis: size}`` in
    `MESH_AXIS_NAMES` order, ``axis_names`` those names, and ``device_mesh``
    the torch ``DeviceMesh`` over the ``data`` axis (None at one process with
    no process group)."""

    def __init__(self, sizes: dict[str, int], device_mesh: Any = None):
        self.shape = {name: int(sizes[name]) for name in MESH_AXIS_NAMES}
        self.axis_names = MESH_AXIS_NAMES
        self.device_mesh = device_mesh

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def build_mesh(config: ParallelismConfig | None = None, num_processes: int | None = None,
               device_type: str | None = None) -> Mesh:
    """The mesh over the job's ranks (``num_processes``, default the process
    group's world size, else 1). With a process group, its ``data`` axis is
    a ``DeviceMesh`` over every rank, of ``device_type`` (default ``"cuda"``
    under NCCL, ``"cpu"`` otherwise). Raises NotImplementedError for an axis
    other than ``data`` above 1."""
    import torch.distributed as dist

    config = config or ParallelismConfig()
    group = dist.is_available() and dist.is_initialized()
    world = num_processes if num_processes is not None else (dist.get_world_size() if group else 1)
    sizes = config.axis_sizes(world)
    other = {name: size for name, size in sizes.items() if name != "data" and size > 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: only the data axis is ported; the fsdp, tensor, sequence and "
            "stage axes wait for ROADMAP Queue 1, item 21.3")
    if not group:
        return Mesh(sizes)
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(sizes, init_device_mesh(device_type, (sizes["data"],), mesh_dim_names=("data",)))


def mesh_axis_size(mesh: Mesh, *names: str) -> int:
    """The product of the sizes of the given axes."""
    return math.prod(mesh.shape[n] for n in names)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The axes the global batch is split over (data and fsdp, as the
    reference's)."""
    return tuple(n for n in ("data", "fsdp") if mesh.shape.get(n, 1) >= 1)


def active_batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """The batch axes of size above 1."""
    return tuple(n for n in ("data", "fsdp") if mesh.shape.get(n, 1) > 1)
