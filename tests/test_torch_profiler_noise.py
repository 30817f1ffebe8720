"""Port parity for the gates of the noise stack that map genomes against
genomes (steps 8, 10, 12, 20 and 21, and the on-disk bed cache of their
genome pairs): megapath_nano_tpu_torch's TaxonProfiler(device="cpu")
against the TPU package's with AlignParams(backend="jnp"), on the world of
test_torch_profiler.py and on the worlds of tests/test_noise_stack.py. Every
ProfileResult field is equal and the reports are byte-equal (archives member
by member), tolerance 0, as in test_torch_profiler.py."""

import os

import numpy as np
import pytest
import torch

from megapath_nano_tpu.db.refdb import RefDB as JRefDB
from megapath_nano_tpu.utils.dna import mutate, random_sequence
from megapath_nano_tpu_torch.state import refdb_from_numpy
from megapath_nano_tpu_torch.taxon.profiler import ProfileOptions as TOptions
from megapath_nano_tpu_torch.taxon.profiler import TaxonProfiler as TProfiler
from test_torch_profiler import (assert_results_equal, assert_same_files,
                                 check_gate, noise_world, run_both)

GATES = {
    "human_repetitive_filter": {"human_repetitive_filter": True},
    "microbe_repetitive_filter": {"microbe_repetitive_filter": True},
    "variable_region_adjustment": {"variable_region_adjustment": True},
    "similar_species_marker": {"similar_species_marker": True},
    "noise_projection": {"noise_projection": True,
                         "noise_projection_reads": 150},
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def world():
    reads, db, human_db, decoy_db = noise_world()
    return {"reads": reads, "names": [f"r{i}" for i in range(len(reads))],
            "jax": (db, human_db, decoy_db),
            "port": tuple(refdb_from_numpy(x)
                          for x in (db, human_db, decoy_db))}


@pytest.mark.parametrize("gate", list(GATES))
def test_noise_gate_matches_reference(world, gate, tmp_path):
    check_gate(world, gate, GATES[gate], tmp_path)


def test_bed_cache_matches_reference(world, tmp_path):
    """The genome-pair bed cache: written by the first run of each package
    (the same files), read back by the port's second run, which reads the
    reference's cache directory."""
    gates = {"human_repetitive_filter": True,
             "variable_region_adjustment": True}
    jres, tres, _, _ = run_both(world, gates, tmp_path, cache=True)
    assert_results_equal(jres, tres)
    jcache, tcache = tmp_path / "cache_jax", tmp_path / "cache_port"
    assert len(os.listdir(tcache)) == 2
    assert_same_files(str(jcache), str(tcache))
    tdb, th, td = world["port"]
    again = TProfiler(tdb, TOptions(**gates,
                                    genome_pair_cache_dir=str(jcache)),
                      human_db=th, decoy_db=td, device="cpu")
    assert_results_equal(jres, again.profile(world["reads"],
                                             world["names"]))


def _repetitive_world():
    """tests/test_noise_stack.py: a high-abundance genome whose shared
    segment makes reads cross-map onto a low one of the same genus."""
    rng = np.random.default_rng(0)
    shared = random_sequence(rng, 6000)
    hi_genome = np.concatenate([random_sequence(rng, 12000), shared])
    lo_genome = np.concatenate([shared, random_sequence(rng, 12000)])
    db = JRefDB.build([hi_genome, lo_genome], ["cH", "cL"], [0, 1],
                      ["asmHigh", "asmLow"], [(1, 10, 5), (2, 20, 5)],
                      {10: "High bug", 20: "Low bug"})
    reads = []
    for _ in range(80):
        s = int(rng.integers(0, len(hi_genome) - 800))
        reads.append(mutate(rng, hi_genome[s:s + 800], 0.02, 0.01, 0.01))
    return db, reads, {"microbe_repetitive_filter": True}


def _similar_world():
    """tests/test_noise_stack.py: a genus-top assembly and a 98% sibling."""
    rng = np.random.default_rng(1)
    top = random_sequence(rng, 12000)
    sib = mutate(rng, top, 0.01, 0.005, 0.005)
    db = JRefDB.build([top, sib], ["cT", "cS"], [0, 1], ["asmTop", "asmSib"],
                      [(1, 10, 5), (2, 20, 5)], {10: "Top bug", 20: "Sib bug"})
    reads = []
    for _ in range(40):
        s = int(rng.integers(0, 11000))
        reads.append(mutate(rng, top[s:s + 800], 0.02, 0.01, 0.01))
    return db, reads, {"similar_species_marker": True}


@pytest.mark.parametrize("make", [_repetitive_world, _similar_world],
                         ids=["microbe_repetitive", "similar_species"])
def test_noise_stack_worlds_match_reference(make, tmp_path):
    db, reads, gates = make()
    w = {"reads": reads, "names": None, "jax": (db, None, None),
         "port": (refdb_from_numpy(db), None, None)}
    jres, tres, jdir, tdir = run_both(w, gates, tmp_path)
    assert jres.noise_sources or jres.similar_marks
    assert_results_equal(jres, tres)
    assert_same_files(jdir, tdir)
