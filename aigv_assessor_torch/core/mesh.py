"""The device mesh (`aigv_assessor_tpu/core/mesh.py`) as a torch
`DeviceMesh` over the ranks of the process group, one rank per card, with
JAX's three axes:

- ``data``: data parallelism; parameters replicated;
- ``fsdp``: parameters, gradients and optimizer state sharded (FSDP2,
  `parallel/sharding.shard_params`); on a (data, fsdp) mesh that is HSDP:
  replicate over ``data``, shard over ``fsdp``;
- ``tensor``: JAX's intra-layer sharding; the port keeps the axis in the
  mesh but refuses a size above 1 (ROADMAP.md Queue 1 [11]).

Batches are split over (data, fsdp): each rank holds its rows
(`batch_spec`). JAX may lay a mesh over fewer devices than it has; here
every rank of the group is in the mesh, so the mesh must cover the world.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from aigv_assessor_torch.core.dist import process_count

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
MESH_AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)

TENSOR_AXIS_TODO = ("the tensor mesh axis is not ported: each rank's attention would see "
                    "H / tensor heads, and the towers reshape by the config's head counts "
                    "(ROADMAP.md Queue 1 [11])")


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    fsdp: int = 1
    tensor: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.fsdp * self.tensor

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, FSDP_AXIS: self.fsdp, TENSOR_AXIS: self.tensor}

    @classmethod
    def auto(cls, n_devices: Optional[int] = None, fsdp: bool = False) -> "MeshConfig":
        """Every rank on `data`, or on `fsdp` when parameters are to be
        sharded (JAX's stage-2 LoRA layout)."""
        n = n_devices if n_devices is not None else process_count()
        return cls(data=1, fsdp=n) if fsdp else cls(data=n, fsdp=1)


def check_mesh(config: MeshConfig, world: Optional[int] = None) -> MeshConfig:
    """`config` if a process group of `world` ranks can hold it, else
    ValueError (more ranks than the world has, as JAX raises, or fewer:
    every rank is in the mesh)."""
    world = process_count() if world is None else world
    n = config.num_devices
    if n > world:
        raise ValueError(f"mesh needs {n} devices ({config}), only {world} available")
    if n < world:
        raise ValueError(f"mesh covers {n} of {world} ranks ({config}): every rank of the "
                         "process group must be in the mesh")
    return config


def make_mesh(config: Optional[MeshConfig] = None, device_type: Optional[str] = None):
    """The (data, fsdp, tensor) `DeviceMesh` over the process group's ranks;
    `device_type` defaults to the group's ('cuda' under NCCL, else 'cpu')."""
    from torch.distributed.device_mesh import init_device_mesh

    config = check_mesh(config or MeshConfig.auto())
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group (core/dist.init_dist)")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (config.data, config.fsdp, config.tensor),
                            mesh_dim_names=MESH_AXES)


def mesh_config_of(mesh) -> MeshConfig:
    """The axis sizes of a mesh `make_mesh` built."""
    return MeshConfig(*(mesh.size(mesh.mesh_dim_names.index(a)) for a in MESH_AXES))


def batch_spec(batch_dim: int = 0) -> Tuple:
    """Placements over the (data, fsdp) mesh of a batch split on
    `batch_dim` over both axes (each rank its rows)."""
    return (Shard(batch_dim), Shard(batch_dim))


def replicated() -> Tuple:
    return (Replicate(), Replicate())
