"""Port parity for the genome-vs-genome filters and the noise projection,
called directly: megapath_nano_tpu_torch.taxon.genome_filters and
noise_projection with device="cpu" against the TPU package's with
backend="jnp", on the worlds of tests/test_genome_filters.py. Beds, marks and
projections must be equal (integers; tolerance 0)."""

import numpy as np
import pytest
import torch

from megapath_nano_tpu.index.minimizer import MinimizerIndex as JIndex
from megapath_nano_tpu.taxon import genome_filters as jgf
from megapath_nano_tpu.taxon import noise_projection as jnp_
from megapath_nano_tpu.utils.dna import mutate, random_sequence
from megapath_nano_tpu_torch.state import index_from_numpy
from megapath_nano_tpu_torch.taxon import genome_filters as tgf
from megapath_nano_tpu_torch.taxon import noise_projection as tnp
from test_torch_profiler import _assert_values_equal


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_tiers_and_chunks():
    for sim in (0.0, 0.8, 0.9, 0.95, 0.97, 0.98, 0.992, 1.0):
        assert jgf.tier_seed_params(sim) == tgf.tier_seed_params(sim)
    seq = random_sequence(np.random.default_rng(0), 23456)
    for kw in ({}, {"chunk": 4000}, {"chunk": 3000, "overlap": 500},
               {"chunk": 30000}):
        _assert_values_equal(jgf.chunk_genome(seq, **kw),
                             tgf.chunk_genome(seq, **kw), str(kw))
    assert jgf.BED_CACHE_SCHEMA == tgf.BED_CACHE_SCHEMA
    assert jgf.RATIO_LADDER == tgf.RATIO_LADDER


def test_align_genome_and_covered_bed():
    rng = np.random.default_rng(0)
    shared = random_sequence(rng, 8000)
    a = np.concatenate([random_sequence(rng, 5000), shared,
                        random_sequence(rng, 5000)])
    b = np.concatenate([random_sequence(rng, 3000), shared,
                        random_sequence(rng, 7000)])
    idx = JIndex.build([b], ["b"])
    for ident in (0.0, 0.95):
        ja = jgf.align_genome_to_index(a, idx, min_identity=ident,
                                       backend="jnp")
        ta = tgf.align_genome_to_index(a, index_from_numpy(idx),
                                       min_identity=ident, device="cpu")
        assert len(ja)
        _assert_values_equal(ja, ta, f"identity {ident}")
        sa = np.zeros(1, np.int32)
        _assert_values_equal(jgf.covered_bed(ja, sa),
                             tgf.covered_bed(ta, sa), "bed")


def test_human_repetitive_bed():
    rng = np.random.default_rng(1)
    alu_like = random_sequence(rng, 2000)
    human = np.concatenate([random_sequence(rng, 10000), alu_like,
                            random_sequence(rng, 10000)])
    microbe = np.concatenate([random_sequence(rng, 6000), alu_like,
                              random_sequence(rng, 6000)])
    idx = JIndex.build([microbe], ["m"])
    sa = np.zeros(1, np.int32)
    jb = jgf.human_repetitive_bed([human], idx, sa, backend="jnp")
    assert len(jb)
    _assert_values_equal(jb, tgf.human_repetitive_bed(
        [human], index_from_numpy(idx), sa, device="cpu"), "bed")


@pytest.mark.parametrize("abundances", [(2_000_000, 10_000),
                                        (20_000, 10_000)])
def test_microbe_repetitive_ladder(abundances):
    rng = np.random.default_rng(2)
    shared = random_sequence(rng, 5000)
    hi = np.concatenate([random_sequence(rng, 4000), shared])
    lo = np.concatenate([shared, random_sequence(rng, 4000)])
    asm = {0: [hi], 1: [lo]}
    jidx = {0: JIndex.build([hi]), 1: JIndex.build([lo])}
    sa = {0: np.zeros(1, np.int32), 1: np.zeros(1, np.int32)}
    ab = dict(enumerate(abundances))
    jb = jgf.microbe_repetitive_beds(asm, ab, {0: 1, 1: 2}, jidx, sa,
                                     backend="jnp")
    tb = tgf.microbe_repetitive_beds(
        asm, ab, {0: 1, 1: 2}, {a: index_from_numpy(i)
                                for a, i in jidx.items()}, sa, device="cpu")
    assert len(jb) == (1 if abundances[0] > 100 * abundances[1] else 0)
    _assert_values_equal(jb, tb, "bed")


def test_variable_region_bed():
    rng = np.random.default_rng(3)
    core = random_sequence(rng, 12000)
    chosen = np.concatenate([core, random_sequence(rng, 5000)])
    strains = {0: [chosen], 1: [mutate(rng, core, 0.01, 0.005, 0.005)],
               2: [mutate(rng, core, 0.01, 0.005, 0.005)]}
    idx = JIndex.build([chosen])
    sa = np.zeros(1, np.int32)
    jb = jgf.variable_region_bed(strains, idx, sa, 0, backend="jnp")
    assert len(jb)
    _assert_values_equal(jb, tgf.variable_region_bed(
        strains, index_from_numpy(idx), sa, 0, device="cpu"), "bed")


def _similar_world():
    rng = np.random.default_rng(4)
    top = random_sequence(rng, 10000)
    similar_sib = mutate(rng, top, 0.01, 0.005, 0.005)
    distant_sib = random_sequence(rng, 10000)
    return top, similar_sib, distant_sib


def test_similar_species_marker():
    top, similar_sib, distant_sib = _similar_world()
    idx = JIndex.build([similar_sib, distant_sib], ["s1", "s2"])
    sa = np.array([0, 1], np.int32)
    lens = {0: len(similar_sib), 1: len(distant_sib)}
    for combine in ("or", "and"):
        jm = jgf.similar_species_marker([top], idx, sa, lens,
                                        combine=combine, backend="jnp")
        assert jm == {0: True}
        assert tgf.similar_species_marker(
            [top], index_from_numpy(idx), sa, lens, combine=combine,
            device="cpu") == jm


def test_project_noise():
    top, similar_sib, distant_sib = _similar_world()
    sibs = {1: [similar_sib], 2: [distant_sib]}
    kw = dict(n_reads=120, max_read_length=1000, seed=3)
    jp = jnp_.project_noise(0, [top], sibs, backend="jnp", **kw)
    tp = tnp.project_noise(0, [top], sibs, device="cpu", **kw)
    assert jp[0].projected_noise_reads > 0
    _assert_values_equal(jp, tp, "projections")
