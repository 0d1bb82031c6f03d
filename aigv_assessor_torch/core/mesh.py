"""The device mesh (`aigv_assessor_tpu/core/mesh.py`) as a torch
`DeviceMesh` over the ranks of the process group, one rank per card, with
JAX's three axes:

- ``data``: data parallelism; parameters replicated;
- ``fsdp``: parameters, gradients and optimizer state sharded (FSDP2,
  `parallel/sharding.shard_params`); on a (data, fsdp) mesh that is HSDP:
  replicate over ``data``, shard over ``fsdp``;
- ``tensor``: JAX's intra-layer sharding, Megatron-style: the float
  towers' projections split by heads (`parallel/tensor.py`,
  `parallel/sharding.tensor_plan`), everything else replicated over it.

The order is (data, fsdp, tensor), so ``tensor`` is innermost: rank =
(data index x fsdp + fsdp index) x tensor + tensor index. Batches are split
over (data, fsdp): the ranks of one tensor group hold the same rows, and
`data_coords` gives the (data, fsdp) coordinate and its size, the "data
rank" that loaders, generators and writers key on; `tensor_coords` gives
the tensor index and size. JAX may lay a mesh over fewer devices than it
has; here every rank of the group is in the mesh, so the mesh must cover
the world.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from aigv_assessor_torch.core.dist import process_count, process_index

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
MESH_AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)

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


def data_coords(mesh=None) -> Tuple[int, int]:
    """(this rank's index over (data, fsdp), their number): the data rank
    and size, which pick a rank's rows of a global batch and seed its
    generator; the ranks of one tensor group share them. Without a mesh,
    the process index and count."""
    if mesh is None:
        return process_index(), process_count()
    names = mesh.mesh_dim_names
    fsdp = mesh.size(names.index(FSDP_AXIS))
    rank = mesh.get_local_rank(DATA_AXIS) * fsdp + mesh.get_local_rank(FSDP_AXIS)
    return rank, mesh.size(names.index(DATA_AXIS)) * fsdp


def tensor_coords(mesh=None) -> Tuple[int, int]:
    """(this rank's index on `tensor`, the axis size); (0, 1) without a
    mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(TENSOR_AXIS), mesh.size(mesh.mesh_dim_names.index(TENSOR_AXIS))


def tensor_group(mesh):
    """The process group of the `tensor` axis: the ranks that hold one
    layer's heads between them."""
    return mesh.get_group(TENSOR_AXIS)


def batch_spec(batch_dim: int = 0) -> Tuple:
    """Placements over the (data, fsdp) mesh of a batch split on
    `batch_dim` over both axes (each rank its rows)."""
    return (Shard(batch_dim), Shard(batch_dim))


def replicated() -> Tuple:
    return (Replicate(), Replicate())
