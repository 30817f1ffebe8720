"""Port parity for the mesh path (megapath_nano_tpu_torch dist/
fused_sharded.py and dist/mesh.py), one process on the CPU (plain versions):
ShardMapAligner against the TPU package's ShardMapAligner (backend "jnp",
the conftest's virtual CPU mesh) and its single-index mapper on
tests/test_fused_sharded.py's first world, all 18 fields; on that file's
other worlds (the data axis, empty shards with several slices, a cap
overflow with the partial redo, the multi-locus repeat, save / load)
against the port's own single-index MinimizerAligner, which the other
parity tests hold to the TPU package; those worlds have reads of 400 b
where that file's have 900 b, which halves the plain extension's loop.
ShardedIndexPlanes files written by either package load in the other. Across gloo ranks:
tests/test_torch_dist.py; card against CPU: tests/test_torch_cuda.py."""

import functools

import numpy as np
import pytest
import torch

from megapath_nano_tpu.align.pipeline import AlignParams as JAlignParams
from megapath_nano_tpu.align.pipeline import MinimizerAligner as JAligner
from megapath_nano_tpu.dist.fused_sharded import (
    ShardedIndexPlanes as JPlanes, ShardMapAligner as JShardMap)
from megapath_nano_tpu.dist.mesh import make_mesh as jmake_mesh
from megapath_nano_tpu.index.minimizer import MinimizerIndex as JIndex
from megapath_nano_tpu_torch import state
from megapath_nano_tpu_torch.align.pipeline import (AlignParams,
                                                    MinimizerAligner)
from megapath_nano_tpu_torch.dist.fused_sharded import (ShardedIndexPlanes,
                                                        ShardMapAligner)
from megapath_nano_tpu_torch.dist.mesh import Mesh, make_mesh
from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex
from megapath_nano_tpu_torch.utils.dna import mutate, random_sequence
from test_fused_sharded import _world
from test_torch_dist import _world as _short_world
from test_torch_profiler import assert_align_lists_equal

PLANE_ARRAYS = ("keys32", "pos_t", "pos_ss", "seq_data", "seq_offsets",
                "seq_lengths", "seq_global", "global_seq_lengths",
                "shard_of_seq")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the whole module (xdist runs several files at
    once)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mesh_aligner(planes, n_data=1, params=None):
    mesh = make_mesh(planes.n_shards, n_data, devices=["cpu"])
    return ShardMapAligner(planes, mesh, params=params, device="cpu")


def _single(genomes, names, reads, params=None):
    return MinimizerAligner(MinimizerIndex.build(genomes, names),
                            params=params, device="cpu").map_reads(
        reads, emit_cigars=False)


def _world_short(seed, n_genomes=6, n_reads=64):
    """That file's world for `seed` (genomes of 20 kb), with reads of
    400 b."""
    return _short_world(seed, n_genomes=n_genomes, glen=20000,
                        n_reads=n_reads)


@functools.lru_cache(maxsize=None)
def _single_short(seed, n_genomes, n_reads, out_per_read=None):
    """The single-index map of _world_short(seed, ...), made once for the
    tests that share a world."""
    params = None if out_per_read is None else AlignParams(
        devseed_out_per_read=out_per_read)
    return _single(*_world_short(seed, n_genomes, n_reads), params)


def _same_planes(a, b):
    for name in PLANE_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert (a.k, a.w, a.seq_bits) == (b.k, b.w, b.seq_bits)
    assert list(a.global_seq_names) == list(b.global_seq_names)


def test_shard_map_matches_jax_and_single_index():
    """test_fused_sharded.test_shard_map_matches_single_index's world at 2
    shards: the port's mesh path equals the TPU package's mesh path and its
    single-index mapper in all 18 fields; planes carried over from the TPU
    package equal the port's own build, local indexes included (the save /
    load test maps carried planes)."""
    genomes, names, reads = _world()
    jparams = JAlignParams(backend="jnp")
    single = JAligner(JIndex.build(genomes, names), params=jparams) \
        .map_reads(reads, emit_cigars=False)
    jplanes = JPlanes.build(genomes, names, 2)
    jmesh = JShardMap(jplanes, jmake_mesh(n_shards=2, n_data=1),
                      params=jparams).map_reads(reads)

    planes = ShardedIndexPlanes.build(genomes, names, 2)
    carried = state.sharded_planes_from_numpy(jplanes)
    _same_planes(carried, planes)
    assert len(carried.local_indexes) == 2
    for li, lj in zip(carried.local_indexes, planes.local_indexes):
        assert np.array_equal(li.keys, lj.keys)
        assert np.array_equal(li.positions, lj.positions)
    got = _mesh_aligner(planes).map_reads(reads)
    assert len(got) > 0
    assert_align_lists_equal(jmesh, got, "mesh vs TPU mesh")
    assert_align_lists_equal(single, got, "mesh vs TPU single index")


@pytest.mark.parametrize("n_data,n_shards", [(2, 2), (2, 4), (4, 2)])
def test_shard_map_data_axis_matches_single_index(n_data, n_shards):
    """Reads data-parallel over "data" x index over "shard", with a read
    count (50) no data width divides."""
    genomes, names, reads = _world_short(seed=3, n_reads=50)
    planes = ShardedIndexPlanes.build(genomes, names, n_shards)
    al = _mesh_aligner(planes, n_data)
    assert al.mesh.shape == {"data": n_data, "shard": n_shards}
    assert_align_lists_equal(_single_short(3, 6, 50), al.map_reads(reads),
                             f"({n_data}, {n_shards})")
    assert al.overflow_stats["blocks"] == n_data * n_shards


def test_shard_map_empty_shard_and_slicing():
    genomes, names, reads = _world_short(seed=5, n_genomes=2, n_reads=40)
    planes = ShardedIndexPlanes.build(genomes, names, 4)   # 2 empty shards
    assert (planes.seq_global[:, 0] == -1).sum() == 2
    al = _mesh_aligner(planes)
    got = al.map_reads(reads, slice_size=16)                # three slices
    assert al.overflow_stats["blocks"] == 3 * 4
    assert_align_lists_equal(_single_short(5, 2, 40), got, "empty")


def _cut_caps(al, cap):
    """Cut one static cap of every cell so that every shard overflows:
    "out" (the compacted rows) or "winners" (the device sketch's slots,
    which overflow on empty shards too)."""
    orig = al._caps

    def tiny(slice_n, read_max):
        w, a, g, o = orig(slice_n, read_max)
        return (w, a, g, 4) if cap == "out" else (64, a, g, o)
    al._caps = tiny


@pytest.mark.parametrize("cap", ["out", "winners"])
def test_shard_map_overflow_redoes_the_cut_reads(cap):
    """test_shard_map_overflow_falls_back_exactly's world: the read-id
    suffix each (data block, shard) cut is redone host-seeded against the
    shard's local index, and the merge equals the single-index map."""
    genomes, names, reads = _world_short(seed=9, n_genomes=4, n_reads=24)
    params = AlignParams(devseed_out_per_read=2)
    planes = ShardedIndexPlanes.build(genomes, names, 2)
    al = _mesh_aligner(planes, 2, params)
    _cut_caps(al, cap)
    got = al.map_reads(reads)
    st = al.overflow_stats
    assert st["overflow_blocks"] > 0 and st["reads_redone"] > 0, st
    assert_align_lists_equal(_single_short(9, 4, 24, 2), got,
                             f"overflow ({cap})")


def test_shard_map_overflow_on_empty_loaded_shards(tmp_path):
    """Empty shards, loaded from disk (their local indexes rebuilt as
    "__empty__"), with every cell's winner slots cut: the partial redo runs
    on every shard, the empty ones included."""
    genomes, names, reads = _world_short(seed=5, n_genomes=2, n_reads=40)
    ShardedIndexPlanes.build(genomes, names, 4).save(str(tmp_path / "p"))
    planes = ShardedIndexPlanes.load(str(tmp_path / "p"))
    al = _mesh_aligner(planes)
    _cut_caps(al, "winners")
    got = al.map_reads(reads)
    assert al.overflow_stats["overflow_blocks"] == 4
    empty = [s for s in range(4) if planes.seq_global[s, 0] < 0]
    assert [planes.local_index(s).seq_names for s in empty] == \
        [["__empty__"]] * 2
    assert_align_lists_equal(_single_short(5, 2, 40), got,
                             "empty + overflow")


def test_shard_map_multilocus_repeat():
    """Repeat cassette on one shard's genome: both loci survive the merge
    (test_fused_sharded.test_shard_map_multilocus_repeat's world with a
    cassette of 1 kb and a read of 800 b, where that test has 3 kb and
    2.6 kb)."""
    rng = np.random.default_rng(11)
    cass = random_sequence(rng, 1000)
    g0 = np.concatenate([random_sequence(rng, 4000), cass,
                         random_sequence(rng, 5000), cass,
                         random_sequence(rng, 4000)])
    g1 = random_sequence(rng, 15000)
    read = mutate(rng, cass[100:900], sub_rate=0.02, ins_rate=0.01,
                  del_rate=0.01)
    planes = ShardedIndexPlanes.build([g0, g1], ["rep", "other"], 2)
    out = _mesh_aligner(planes).map_reads([read])
    d = out.data
    assert len(d) == 2
    assert set(int(s) for s in d["sequence_id"]) == {0}
    froms = sorted(int(x) for x in d["sequence_from"])
    assert abs(froms[0] - 4100) < 150 and abs(froms[1] - 10100) < 150
    assert_align_lists_equal(
        _single([g0, g1], ["rep", "other"], [read]), out, "repeat")


def test_planes_save_load_both_packages(tmp_path):
    """test_planes_save_load_roundtrip's world: the port's files load in
    the port and in the TPU package, the TPU package's files in the port,
    with equal arrays, and every loaded object maps like the built one
    (its local indexes rebuilt lazily)."""
    genomes, names, reads = _world_short(seed=21, n_genomes=4, n_reads=24)
    planes = ShardedIndexPlanes.build(genomes, names, 2)
    planes.save(str(tmp_path / "port"))
    JPlanes.build(genomes, names, 2).save(str(tmp_path / "jax"))

    loaded = ShardedIndexPlanes.load(str(tmp_path / "port"))
    from_jax = ShardedIndexPlanes.load(str(tmp_path / "jax"))
    in_jax = JPlanes.load(str(tmp_path / "port"))
    for other in (loaded, from_jax, in_jax):
        _same_planes(other, planes)
        assert other.local_indexes == []
    ref = _mesh_aligner(planes).map_reads(reads)
    assert len(ref) > 0
    for label, other in (("port -> port", loaded),
                         ("TPU -> port", from_jax),
                         ("port -> TPU -> port",
                          state.sharded_planes_from_numpy(in_jax))):
        assert_align_lists_equal(ref, _mesh_aligner(other).map_reads(reads),
                                 label)
    li = loaded.local_index(0)
    assert li.seq_names == [names[i] for i in
                            np.flatnonzero(planes.shard_of_seq == 0)]
    assert np.array_equal(li.keys, planes.local_indexes[0].keys)


def test_mesh_path_refusals():
    genomes, names, reads = _world_short(seed=21, n_genomes=2, n_reads=4)
    planes = ShardedIndexPlanes.build(genomes, names, 2)
    al = _mesh_aligner(planes)
    with pytest.raises(ValueError, match="PAF-mode only"):
        al.map_reads(reads, emit_cigars=True)
    assert len(al.map_reads([])) == 0
    with pytest.raises(ValueError, match="shard"):
        ShardMapAligner(planes, make_mesh(3, devices=["cpu"]),
                        device="cpu")
    on_card = Mesh([[torch.device("cuda"), torch.device("cuda")]])
    with pytest.raises(ValueError, match="cell"):
        ShardMapAligner(planes, on_card, device="cpu")


def test_mesh_path_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    planes = ShardedIndexPlanes.build([random_sequence(
        np.random.default_rng(0), 5000)], ["g"], 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardMapAligner(planes, make_mesh(1, devices=["cpu"]))
    mesh = make_mesh(n_data=2, devices=["cpu"])
    assert mesh.shape == {"data": 2, "shard": 1}
    assert mesh.local_cells() == [(0, 0), (1, 0)]
