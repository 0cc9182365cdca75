"""Device-mesh helpers: counterpart of
`gaussiansplattingregistration_tpu/parallel/mesh.py`.

The canonical mesh has two axes over the ranks of the default group:
* `data`: cameras and photometric batches (pure data parallelism);
* `splat`: the N Gaussians (projection local, composites combined across
  ranks).

Pipeline parallelism is deliberately absent. `splat_sharding` and
`replicated` have no counterpart: each rank holds its own shard
(`sharded_raster.shard_splats`) and calls the collectives itself; an
axis's group and this rank's coordinate on it are the mesh's own
`get_group(axis)` and `get_local_rank(axis)`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "splat")


def mesh_shape(n: int, data: int = 1, splat: Optional[int] = None) -> Tuple[int, int]:
    """(data, splat) for n ranks; `splat` defaults to the remaining ranks.
    Raises ValueError where the JAX package's `make_mesh` does."""
    if splat is None:
        if n % data != 0:
            raise ValueError(f"{n} devices not divisible by data={data}")
        splat = n // data
    if data * splat != n:
        raise ValueError(f"mesh {data}x{splat} != {n} devices")
    return data, splat


def make_mesh(data: int = 1, splat: Optional[int] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A (data, splat) `DeviceMesh` over the default group's ranks, every
    rank calling it (the subgroups are made collectively, in one order).
    `device_type` defaults to `cuda` on an NCCL group, else `cpu`."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize() first")
    shape = mesh_shape(dist.get_world_size(), data, splat)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k
