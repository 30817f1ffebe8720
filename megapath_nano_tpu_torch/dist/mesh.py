"""Device mesh for the mesh path (dist/fused_sharded.py).

The scale-out model: the minimizer index is sharded across devices along a
"shard" axis (each holds a slice of the sorted table and the packed target
sequences it refers to); read batches are data-parallel over a "data" axis;
the per-shard row blocks merge with one gather. This replaces the
reference's single-node minimap2 `-I` index batching (reference:
bin/megapath_nano.py:4017-4022 sizes index batches to RAM/64GB).

The port's counterpart of megapath_nano_tpu/dist/mesh.py, on torch. A mesh
is a (data, shard) grid of cells, in one of two modes:

- one process (no process group, or a group of one rank): every cell is a
  torch.device of this process, laid out over `devices` in turn (by default
  every visible CUDA device); this process runs every cell, one after
  another. With one GPU every cell is cuda:0; with devices=["cpu"] the
  plain versions run on the CPU.
- one rank a cell (torch.distributed initialised with a world of
  n_data * n_shards ranks): rank d * n_shards + s owns cell (d, s) on its
  own device, and the mesh holds a "shard" subgroup for its data row and a
  "data" subgroup for its shard column. The device must fit the group's
  backend (NCCL for CUDA tensors, gloo for CPU tensors); make_mesh raises
  where it does not and never moves work to the CPU on its own.

NCCL cannot place two ranks on one GPU, so one GPU runs the one-process
mode.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from megapath_nano_tpu_torch.align.pipeline import require_device

# the device type each torch.distributed backend moves tensors of
_BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


@dataclass
class Mesh:
    """A (data, shard) grid of cells. `devices[d][s]` is cell (d, s)'s
    device. `rank` is None in the one-process mode; across ranks it is this
    process's rank, `coords` its cell, and `shard_group` / `data_group` the
    subgroups of its data row and its shard column."""

    devices: list[list[torch.device]]
    rank: int | None = None
    coords: tuple[int, int] | None = None
    shard_group: object = None
    data_group: object = None

    @property
    def shape(self) -> dict[str, int]:
        """{"data": D, "shard": S}, as a JAX mesh's shape reads."""
        return {"data": len(self.devices), "shard": len(self.devices[0])}

    @property
    def distributed(self) -> bool:
        return self.rank is not None

    def local_cells(self) -> list[tuple[int, int]]:
        """The cells this process runs: every cell in the one-process
        mode, its own cell across ranks."""
        if self.distributed:
            return [self.coords]
        return [(d, s) for d in range(self.shape["data"])
                for s in range(self.shape["shard"])]


def make_mesh(n_shards: int | None = None, n_data: int = 1,
              devices=None) -> Mesh:
    """A (n_data, n_shards) mesh. `devices` defaults to every visible CUDA
    device (raising when there is none); cells take them in turn. Across
    ranks, n_shards defaults to world size // n_data and the world must hold
    exactly n_data * n_shards ranks."""
    if devices is None:
        require_device("cuda", "make_mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(x) for x in devices]
    if not devices:
        raise ValueError("make_mesh: no devices given")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_shards is None:
        n_shards = max(1, (world if world > 1 else len(devices)) // n_data)
    if n_shards < 1 or n_data < 1:
        raise ValueError(f"make_mesh: mesh ({n_data}, {n_shards})")
    n_cells = n_data * n_shards
    grid = [[devices[(d * n_shards + s) % len(devices)]
             for s in range(n_shards)] for d in range(n_data)]
    if world == 1:
        for dev in devices:
            require_device(dev, "make_mesh")
        return Mesh(grid)

    if world != n_cells:
        raise ValueError(f"make_mesh: a ({n_data}, {n_shards}) mesh needs "
                         f"{n_cells} ranks, the process group has {world}")
    rank = dist.get_rank()
    d, s = divmod(rank, n_shards)
    own = grid[d][s]
    backend = str(dist.get_backend()).lower()
    want = _BACKEND_DEVICE.get(backend)
    if want is not None and own.type != want:
        raise ValueError(f"make_mesh: rank {rank}'s device {own} does not "
                         f"fit the {backend} backend, which moves {want} "
                         f"tensors")
    require_device(own, "make_mesh")
    if own.type == "cuda":
        # NCCL binds a rank's communicators to its current device
        torch.cuda.set_device(own)
    # every rank creates every subgroup, in the same order
    shard_group = data_group = None
    for row in range(n_data):
        g = dist.new_group([row * n_shards + c for c in range(n_shards)])
        if row == d:
            shard_group = g
    for col in range(n_shards):
        g = dist.new_group([r * n_shards + col for r in range(n_data)])
        if col == s:
            data_group = g
    return Mesh(grid, rank=rank, coords=(d, s), shard_group=shard_group,
                data_group=data_group)
