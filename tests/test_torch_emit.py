"""Port parity for the host-chained map path (CIGAR emit, and PAF problems
outside the fused gate): megapath_nano_tpu_torch's
MinimizerAligner(device="cpu").map_reads against the TPU package's
MinimizerAligner(backend="jnp"). All 18 AlignList fields and the whole
cigar_map (keys and (cigar, oriented_from, strand) entries) must be equal:
every value is an integer, a string or a float computed by the same numpy
code, so the tolerance is 0."""

import numpy as np
import pytest
import torch

from megapath_nano_tpu.align import pipeline as jp
from megapath_nano_tpu.align.records import ALIGN_DTYPE
from megapath_nano_tpu.index.minimizer import MinimizerIndex
from megapath_nano_tpu.utils.dna import mutate, random_sequence, revcomp
from megapath_nano_tpu_torch.align import pipeline as tp
from megapath_nano_tpu_torch.kernels.sw import banded_sw_scores
from megapath_nano_tpu_torch.state import index_from_numpy
from test_torch_cuda import mixed_lengths_world


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _simulated(seed, n_genomes, glen, n_reads, read_len, err):
    rng = np.random.default_rng(seed)
    genomes = [random_sequence(rng, glen) for _ in range(n_genomes)]
    reads = []
    for _ in range(n_reads):
        g = int(rng.integers(0, n_genomes))
        s = int(rng.integers(0, glen - read_len))
        read = mutate(rng, genomes[g][s: s + read_len], sub_rate=err * 0.5,
                      ins_rate=err * 0.25, del_rate=err * 0.25)
        if rng.integers(0, 2):
            read = revcomp(read)
        reads.append(read)
    return genomes, reads


def _repeat_world():
    """One genome with the same 3 kb cassette at two distant loci; reads
    from the cassette get two loci on one sequence."""
    rng = np.random.default_rng(5)
    cassette = random_sequence(rng, 3000)
    genome = np.concatenate([random_sequence(rng, 4000), cassette,
                             random_sequence(rng, 6000), cassette,
                             random_sequence(rng, 4000)])
    reads = [mutate(rng, cassette[s: s + 1100], sub_rate=0.02, ins_rate=0.01,
                    del_rate=0.01) for s in (200, 900, 1700)]
    return [genome], reads


def _chimeric_world():
    rng = np.random.default_rng(9)
    g0 = random_sequence(rng, 15000)
    g1 = random_sequence(rng, 15000)
    parts = [mutate(rng, g[a:b], sub_rate=0.02, ins_rate=0.01, del_rate=0.01)
             for g, a, b in ((g0, 2000, 2600), (g1, 8000, 8600))]
    return [g0, g1], [np.concatenate(parts), revcomp(np.concatenate(parts))]


def _clipped_world():
    """Reads across both ends of short genomes, with other bases beyond
    the ends: the windows clamp at the read's and the sequence's ends
    (qs, w_lo, w_hi)."""
    rng = np.random.default_rng(21)
    genomes = [random_sequence(rng, n) for n in (1500, 2500, 4000)]

    def err(x):
        return mutate(rng, x, sub_rate=0.02, ins_rate=0.01, del_rate=0.01)
    reads = []
    for g in genomes:
        for read in (np.concatenate([random_sequence(rng, 300), err(g[:900])]),
                     err(g[:700]),
                     np.concatenate([err(g[-900:]), random_sequence(rng, 300)]),
                     np.concatenate([random_sequence(rng, 200), err(g),
                                     random_sequence(rng, 200)])):
            reads += [read, revcomp(read)]
    return genomes, reads


def _tied_world():
    """Three identical genomes under three names: every read chains to
    three loci of equal score, so the rank's tie order (group order)
    decides which two are kept."""
    rng = np.random.default_rng(27)
    genome = random_sequence(rng, 6000)
    reads = [mutate(rng, genome[s: s + 800], sub_rate=0.02, ins_rate=0.01,
                    del_rate=0.01) for s in (100, 2000, 4500)]
    return [genome, genome.copy(), genome.copy()], reads + [revcomp(reads[1])]


def _random_reads_world():
    rng = np.random.default_rng(3)
    genomes = [random_sequence(rng, 10000) for _ in range(2)]
    return genomes, [random_sequence(rng, 600) for _ in range(10)]


# name -> (world, AlignParams fields, map_reads arguments)
CASES = {
    "align_pipeline_world": (
        lambda: _simulated(0, 3, 20000, 60, 800, 0.08), {}, {}),
    "paf_vs_cigar_world": (
        lambda: _simulated(11, 3, 30000, 48, 800, 0.06), {}, {}),
    "repeat_two_loci": (_repeat_world, {}, {}),
    "chimeric_split": (_chimeric_world, {}, {}),
    "sliced_two_threads": (
        lambda: _simulated(0, 3, 20000, 60, 800, 0.08), {},
        {"slice_size": 16}),
    "paf_unfused_full_stats": (
        lambda: _simulated(7, 2, 8000, 30, 500, 0.05), {"fused": False},
        {"emit_cigars": False}),
    "paf_unfused_sliced": (
        lambda: _simulated(7, 2, 8000, 30, 500, 0.05), {"fused": False},
        {"emit_cigars": False, "slice_size": 8}),
    "fixed_band_256_dshift": (
        lambda: _simulated(13, 2, 12000, 24, 700, 0.1), {"band": 256}, {}),
    "small_extend_batch": (
        lambda: _simulated(17, 2, 12000, 24, 600, 0.06),
        {"extend_batch": 7, "max_anchors_per_group": 32}, {}),
    # windows of 300 b to 3.4 kb in five launches, longest first
    "mixed_lengths_sorted_launches": (
        mixed_lengths_world, {"extend_batch": 8}, {}),
    "min_alignment_score_drops_all": (
        lambda: _simulated(19, 2, 8000, 8, 400, 0.05),
        {"min_alignment_score": 10 ** 6}, {}),
    "random_reads_empty": (_random_reads_world, {}, {}),
    "top_k_cut": (_repeat_world, {"max_alignments_per_read": 1}, {}),
    "window_clipped_at_sequence_ends": (_clipped_world, {}, {}),
    "chain_score_ties": (_tied_world, {"max_alignments_per_read": 2}, {}),
}


def _assert_same(got, ref, emit_cigars):
    assert len(got) == len(ref)
    assert got.data.dtype == ref.data.dtype == ALIGN_DTYPE
    for col in ALIGN_DTYPE.names:
        np.testing.assert_array_equal(got.data[col], ref.data[col],
                                      err_msg=col)
    assert got.sequence_names == ref.sequence_names
    assert got.assembly_names == ref.assembly_names
    if emit_cigars and len(ref):
        assert set(got.cigar_map) == set(ref.cigar_map)
        for key, entry in ref.cigar_map.items():
            assert got.cigar_map[key] == entry, key
    else:
        assert got.cigar_map == ref.cigar_map


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_chained_map_equal_jax(case):
    world, fields, kwargs = CASES[case]
    genomes, reads = world()
    names = [f"genome{i}" for i in range(len(genomes))]
    jidx = MinimizerIndex.build(genomes, names)
    jal = jp.MinimizerAligner(jidx, params=jp.AlignParams(backend="jnp",
                                                          **fields))
    tal = tp.MinimizerAligner(index_from_numpy(jidx),
                              params=tp.AlignParams(**fields), device="cpu")
    before = banded_sw_scores.launches
    ref = jal.map_reads(reads, **kwargs)
    got = tal.map_reads(reads, **kwargs)
    assert banded_sw_scores.launches == before   # CPU: plain versions only
    _assert_same(got, ref, kwargs.get("emit_cigars", True))
    if case in ("random_reads_empty", "min_alignment_score_drops_all"):
        assert len(got) == 0 or (got.data["alignment_score"] < 100).all()
    else:
        assert len(got) > 0
    if case == "repeat_two_loci":
        assert (np.bincount(got.data["read_id"]) == 2).all()
        assert all(len(k) == 2 or k[2] in got.data["sequence_from"]
                   for k in got.cigar_map)


def test_cigars_consistent_with_records():
    """On the port alone: each CIGAR's M+I spans the record's read
    interval, M+D its sequence interval, and PAF mode repeats the CIGAR
    mode's fields (the TPU package's test_paf_mode_matches_cigar_mode)."""
    genomes, reads = _simulated(11, 3, 30000, 32, 800, 0.06)
    index = tp.MinimizerIndex.build(genomes, ["g0", "g1", "g2"])
    tal = tp.MinimizerAligner(index, device="cpu")
    res = tal.map_reads(reads)
    assert len(res) >= 30
    for row in res.data:
        cigar, oriented_from, strand = res.cigar_map[
            (int(row["read_id"]), int(row["sequence_id"]),
             int(row["sequence_from"]))]
        q = sum(n for n, op in cigar if op in "MI")
        t = sum(n for n, op in cigar if op in "MD")
        assert q == row["read_to"] - row["read_from"]
        assert t == row["sequence_to"] - row["sequence_from"]
        assert strand == row["strand"]
    paf = tal.map_reads(reads, emit_cigars=False)
    assert paf.cigar_map is None and len(paf) == len(res)
    for col in ("read_id", "read_from", "read_to", "strand", "sequence_id",
                "sequence_from", "sequence_to", "match", "edit_dist",
                "alignment_score", "mapq"):
        np.testing.assert_array_equal(paf.data[col], res.data[col],
                                      err_msg=col)


def test_threads_do_not_change_the_result():
    """Two worker threads share the aligner: the sliced result equals the
    unsliced one whatever the interleaving, run after run."""
    genomes, reads = _simulated(23, 2, 12000, 40, 500, 0.06)
    index = tp.MinimizerIndex.build(genomes, ["a", "b"])
    tal = tp.MinimizerAligner(index, device="cpu")
    whole = tal.map_reads(reads)
    for _ in range(3):
        sliced = tal.map_reads(reads, slice_size=5)
        _assert_same(sliced, whole, True)
