"""Scaling-efficiency harness for the mesh path.

Measures ShardMapAligner (dist/fused_sharded.py: the fused map step per
index shard, merged with one gather) at increasing shard counts and
reports throughput and efficiency. Weak scaling: each added shard brings
its own slice of reference (genome_per_shard bp), so perfect scaling holds
throughput constant while index capacity grows with N.

The mesh is the one-process mesh (dist/mesh.py), which holds any shard
count: its cells take the visible CUDA devices in turn. On one card every
cell is that card and the cells run one after another, so "efficiency"
there measures running the shards in turn on one device, not scaling over
devices. With device="cpu" the plain versions run and the times say
nothing about a card.

    python -m megapath_nano_tpu_torch.dist.scaling [N_DATA]
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from megapath_nano_tpu_torch.align.pipeline import (AlignParams,
                                                    require_device)
from megapath_nano_tpu_torch.dist.fused_sharded import (ShardedIndexPlanes,
                                                        ShardMapAligner)
from megapath_nano_tpu_torch.dist.mesh import make_mesh
from megapath_nano_tpu_torch.utils.dna import mutate, random_sequence


@dataclass
class ScalePoint:
    n_shards: int
    reads_per_s: float
    efficiency: float       # vs 1-shard throughput (weak scaling: 1.0 =
    #                         constant throughput as index grows with N)
    n_data: int = 1


def measure_scaling(
    shard_counts: list[int] | None = None,
    *,
    genome_per_shard: int = 100_000,
    n_reads: int = 512,
    read_len: int = 800,
    iters: int = 3,
    seed: int = 0,
    device="cuda",
    n_data: int = 1,
) -> list[ScalePoint]:
    """Weak scaling over the "shard" axis at a fixed "data" width: each
    mesh point has n_data x n_shards cells; reads are data-parallel over
    the n_data rows and the index is sharded across n_shards columns.
    device="cuda" lays the cells over every visible card; "cuda:i" or "cpu"
    puts them all on that device. The clock is read after
    torch.cuda.synchronize() on every card of the mesh."""
    require_device(device, "measure_scaling")
    dev = torch.device(device)
    if shard_counts is None:
        shard_counts = [1, 2, 4, 8]
    rng = np.random.default_rng(seed)
    max_shards = max(shard_counts)
    genomes = [random_sequence(rng, genome_per_shard)
               for _ in range(max_shards)]
    names = [f"g{i}" for i in range(max_shards)]
    reads = []
    for i in range(n_reads):
        src = genomes[i % max_shards]
        s = int(rng.integers(0, genome_per_shard - read_len))
        reads.append(mutate(rng, src[s: s + read_len], 0.03, 0.015, 0.015))

    # a bare "cuda" spreads the cells over every visible card; a device
    # with an index, or the CPU, holds them all
    devices = None if dev.type == "cuda" and dev.index is None else [dev]
    params = AlignParams()
    points = []
    base = None
    for n_shards in shard_counts:
        mesh = make_mesh(n_shards=n_shards, n_data=n_data, devices=devices)
        cards = sorted({x.index or 0 for row in mesh.devices for x in row
                        if x.type == "cuda"})

        def clock():
            for i in cards:
                torch.cuda.synchronize(i)
            return time.perf_counter()

        # weak scaling: N shards index the first N genomes (reads from
        # genomes beyond the indexed set simply don't align)
        planes = ShardedIndexPlanes.build(
            genomes[:n_shards], names[:n_shards], n_shards)
        aligner = ShardMapAligner(planes, mesh, params=params, device=dev)
        aligner.map_reads(reads)            # warm-up: uploads, allocator
        t0 = clock()
        for _ in range(iters):
            aligner.map_reads(reads)
        dt = (clock() - t0) / iters
        rps = n_reads / dt
        if base is None:
            base = rps
        points.append(ScalePoint(n_shards, rps, rps / base, n_data))
    return points


if __name__ == "__main__":
    import sys

    nd = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    for pt in measure_scaling(n_data=nd):
        print(f"mesh (data={pt.n_data}, shard={pt.n_shards:2d})  "
              f"{pt.reads_per_s:9.1f} reads/s  "
              f"efficiency {pt.efficiency:.2f}")
