"""Port parity for the host-loop sharded aligner
(megapath_nano_tpu_torch dist/sharded_aligner.py, device "cpu", against the
TPU package's ShardedAligner with backend "jnp") on the worlds of
tests/test_sharded_aligner.py, with the same shard count on both sides: the
merged AlignList in all 18 fields plus cigar_map, in PAF and CIGAR mode,
with empty shards. The sharded path is held to the TPU package's sharded
path and not to a monolithic index: the max_occ repeat mask counts per shard
(the module's one intended divergence). (The CLI with `--index_shards 3`:
tests/test_torch_amr_cli.py, which holds the CLI world.)"""

import numpy as np
import pytest
import torch

from megapath_nano_tpu.align.pipeline import AlignParams as JAlignParams
from megapath_nano_tpu.dist.sharded_aligner import ShardedAligner as JSharded
from megapath_nano_tpu.utils.dna import random_sequence
from megapath_nano_tpu_torch.align.pipeline import AlignParams as TAlignParams
from megapath_nano_tpu_torch.dist.sharded_aligner import (
    ShardedAligner as TSharded)
from test_sharded_aligner import _world
from test_torch_profiler import assert_align_lists_equal


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the whole module, its module-scoped fixtures
    included (xdist runs several files at once)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both(genomes, names, assembly_of, assembly_names, n_shards, reads,
          emit_cigars, **params):
    j = JSharded.build(genomes, names, assembly_of, assembly_names,
                       n_shards=n_shards,
                       params=JAlignParams(backend="jnp", **params))
    t = TSharded.build(genomes, names, assembly_of, assembly_names,
                       n_shards=n_shards, params=TAlignParams(**params),
                       device="cpu")
    assert [s is None for s in j.shards] == [s is None for s in t.shards]
    for sh in t.shards:
        assert sh is None or str(sh.device) == "cpu"
    ja = j.map_reads(reads, emit_cigars=emit_cigars)
    ta = t.map_reads(reads, emit_cigars=emit_cigars)
    assert_align_lists_equal(ja, ta, f"sharded(cigars={emit_cigars})")
    return ta


@pytest.mark.parametrize("emit_cigars", [False, True])
def test_sharded_matches_reference(emit_cigars):
    """The slow single-index world of test_sharded_aligner.py cut to 4
    genomes of 8 kb, over 3 shards (one assembly is a two-sequence assembly,
    so a shard holds two sequences)."""
    genomes, names, reads = _world(seed=0, n_genomes=4, glen=8000)
    ta = _both(genomes, names, [0, 1, 2, 2], ["a0", "a1", "a2"], 3, reads,
               emit_cigars)
    assert len(ta) > 0
    assert set(np.unique(ta.data["sequence_id"])) == {0, 1, 2, 3}
    assert (ta.cigar_map is not None) == emit_cigars


def test_sharded_cigar_mode_and_empty_shards_match():
    """test_sharded_cigar_mode_and_empty_shard's world: 2 assemblies over 5
    shards (3 empty), CIGAR mode; also a read set no shard maps."""
    genomes, names, reads = _world(seed=3, n_genomes=2)
    ta = _both(genomes, names, [0, 1], names, 5, reads, True)
    assert len(ta) > 0
    rid, sid = int(ta.data["read_id"][0]), int(ta.data["sequence_id"][0])
    assert (rid, sid) in ta.cigar_map
    rng = np.random.default_rng(9)
    junk = [random_sequence(rng, 700) for _ in range(3)]
    assert len(_both(genomes, names, [0, 1], names, 5, junk, True)) == 0


def test_sharded_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    genomes, names, _ = _world(seed=3, n_genomes=2, glen=3000)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TSharded.build(genomes, names, [0, 1], names, 2)
