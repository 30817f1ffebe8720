"""The mesh path across processes (megapath_nano_tpu_torch dist/mesh.py and
dist/fused_sharded.py on torch.distributed, gloo, the CPU): one rank a
cell. One spawn of four ranks maps a (2, 2) mesh, once as it is and once
with a forced cap overflow; then two of them form a world of two and map a
(1, 2) mesh. Every rank's AlignList equals the one-process mesh's (which
tests/test_torch_fused_sharded.py holds to the TPU package). The spawn has
its own deadline: a hung collective fails its tests instead of holding the
suite. Also make_mesh's refusals across ranks and the scaling harness
(dist/scaling.py).

The rank function lives here, in a module that imports no JAX, so that a
spawned rank starts quickly."""

import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from megapath_nano_tpu_torch.align.pipeline import AlignParams
from megapath_nano_tpu_torch.dist.fused_sharded import (ShardedIndexPlanes,
                                                        ShardMapAligner)
from megapath_nano_tpu_torch.dist.mesh import make_mesh
from megapath_nano_tpu_torch.dist.scaling import measure_scaling
from megapath_nano_tpu_torch.utils.dna import mutate, random_sequence, revcomp

DEADLINE_S = 300
PARAMS = dict(devseed_out_per_read=2)
SEED = 3
N_SHARDS = 2
# (n_data, cut): the meshes the spawned ranks map, in the order they do
CASES = ((2, False), (2, True), (1, False))


def _world(seed, n_genomes=4, glen=12000, n_reads=40, read_len=400):
    """tests/test_fused_sharded.py's world (the same draws, through the
    port's copies of the sequence helpers), cut to size: by default fewer
    and shorter genomes, fewer reads, and reads of 400 b where that world
    has 900 b."""
    rng = np.random.default_rng(seed)
    genomes = [random_sequence(rng, glen) for _ in range(n_genomes)]
    names = [f"g{i}" for i in range(n_genomes)]
    reads = []
    for _ in range(n_reads):
        g = int(rng.integers(0, n_genomes))
        s = int(rng.integers(0, glen - read_len))
        r = mutate(rng, genomes[g][s: s + read_len], sub_rate=0.03,
                   ins_rate=0.015, del_rate=0.015)
        if rng.integers(0, 2):
            r = revcomp(r)
        reads.append(r)
    return genomes, names, reads


def _cut_out_cap(al):
    orig = al._caps

    def tiny(slice_n, read_max):
        w, a, g, _ = orig(slice_n, read_max)
        return w, a, g, 4
    al._caps = tiny


def _map(planes, mesh, reads, cut):
    al = ShardMapAligner(planes, mesh, params=AlignParams(**PARAMS),
                         device="cpu")
    if cut:
        _cut_out_cap(al)
    res = al.map_reads(reads, slice_size=32)
    return res, al.overflow_stats


def _case_name(n_data, cut):
    return f"{n_data}x{N_SHARDS}{'_cut' if cut else ''}"


def _init(rank, world, init_file):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)


def _rank_map(rank, out_dir, n_data, cut, reads, planes):
    """This rank's cell of an (n_data, 2) mesh maps the reads; it writes
    the AlignList's rows and the overflow statistics."""
    mesh = make_mesh(N_SHARDS, n_data, devices=["cpu"])
    assert mesh.coords == divmod(rank, N_SHARDS)
    res, stats = _map(planes, mesh, reads, cut)
    name = _case_name(n_data, cut)
    np.save(os.path.join(out_dir, f"{name}_rank{rank}.npy"), res.data)
    with open(os.path.join(out_dir, f"{name}_rank{rank}.json"), "w") as f:
        json.dump(stats, f)


def _refusals(rank, out_dir):
    """In a world of two ranks: make_mesh refuses a mesh with more cells
    than ranks and a CUDA device on a gloo group, and lays a default mesh
    one cell a rank."""
    got = {}
    for case, kw in (("too few ranks", dict(n_shards=2, n_data=2,
                                            devices=["cpu"])),
                     ("cuda on gloo", dict(devices=["cuda"]))):
        try:
            make_mesh(**kw)
            got[case] = None
        except ValueError as e:
            got[case] = str(e)
    mesh = make_mesh(devices=["cpu"])
    got["default"] = [mesh.shape, list(mesh.coords)]
    with open(os.path.join(out_dir, f"refusals_rank{rank}.json"), "w") as f:
        json.dump(got, f)


def _rank_main(rank, out_dir):
    """Four ranks map the (2, 2) mesh, as it is and with the rows cap cut;
    then ranks 0 and 1 form a world of two, map the (1, 2) mesh and try
    make_mesh's refusals."""
    planes = ShardedIndexPlanes.load(os.path.join(out_dir, "planes"))
    reads = _world(SEED)[2]
    _init(rank, 4, os.path.join(out_dir, "init4"))
    try:
        for n_data, cut in CASES[:2]:
            _rank_map(rank, out_dir, n_data, cut, reads, planes)
    finally:
        dist.destroy_process_group()
    if rank >= 2:
        return
    _init(rank, 2, os.path.join(out_dir, "init2"))
    try:
        _rank_map(rank, out_dir, *CASES[2], reads, planes)
        _refusals(rank, out_dir)
    finally:
        dist.destroy_process_group()


def _spawn(fn, args, nprocs):
    """mp.spawn with a deadline: a rank that raises fails the test with its
    traceback; ranks still running at the deadline are killed and the test
    fails."""
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"{fn.__name__}: ranks still running after "
                            f"{DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
            assert not p.is_alive()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The world's planes, saved; the four ranks spawned once for every
    case. Returns the directory of their outputs and the planes."""
    out = tmp_path_factory.mktemp("ranks")
    genomes, names, _ = _world(SEED)
    planes = ShardedIndexPlanes.build(genomes, names, N_SHARDS)
    planes.save(str(out / "planes"))
    _spawn(_rank_main, (str(out),), 4)
    return out, planes


@pytest.mark.parametrize("n_data,cut", CASES)
def test_ranks_match_one_process(spawned, n_data, cut):
    out, planes = spawned
    ref, ref_stats = _map(planes, make_mesh(N_SHARDS, n_data,
                                            devices=["cpu"]),
                          _world(SEED)[2], cut)
    assert len(ref) > 0
    assert (ref_stats["reads_redone"] > 0) == cut
    name = _case_name(n_data, cut)
    for rank in range(n_data * N_SHARDS):
        got = np.load(out / f"{name}_rank{rank}.npy")
        assert got.dtype == ref.data.dtype and len(got) == len(ref), rank
        for col in got.dtype.names:
            np.testing.assert_array_equal(got[col], ref.data[col],
                                          err_msg=f"rank {rank}: {col}")
        with open(out / f"{name}_rank{rank}.json") as f:
            assert json.load(f) == ref_stats, rank


def test_make_mesh_refusals_across_ranks(spawned):
    out, _ = spawned
    for rank in range(2):
        with open(out / f"refusals_rank{rank}.json") as f:
            got = json.load(f)
        assert "needs 4 ranks" in got["too few ranks"], got
        assert "gloo" in got["cuda on gloo"], got
        assert got["default"] == [{"data": 1, "shard": 2}, [0, rank]]


def test_scaling_harness_runs():
    """tests/test_dist.py::test_scaling_harness_runs's size, on the CPU,
    with reads of 400 b where that test has 800 b."""
    points = measure_scaling([1, 2], genome_per_shard=20000, n_reads=32,
                             read_len=400, iters=1, device="cpu")
    assert [p.n_shards for p in points] == [1, 2]
    assert all(p.reads_per_s > 0 for p in points)
    assert points[0].efficiency == 1.0 and points[1].efficiency > 0


def test_scaling_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_scaling([1])
