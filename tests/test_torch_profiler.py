"""Port parity for the taxon profile: megapath_nano_tpu_torch's
TaxonProfiler(device="cpu") against the TPU package's TaxonProfiler with
AlignParams(backend="jnp"), on the same reads and the same reference DB
(carried across by state.refdb_from_numpy). Every ProfileResult field must
be equal (AlignLists in all 18 fields, their name tables and cigar_map; stat
tables, beds, noise sources, projections, marks), and write_reports must
write byte-equal files: archives member by member (their headers stamp
times), and every other file byte for byte. All values are integers,
strings or floats computed by the same numpy code, so the tolerance is 0.

The world of this file has every structure a gate looks for: a dominant
assembly with a second strain of its species (variable regions), a
low-abundance species of the same genus that shares a segment with it
(microbe-repetitive regions, cross-mapping), a second genus of two close
species (similar-species marker, noise projection), a pile of reads at one
locus (spike filters), a human genome that carries a piece of one assembly
(human-repetitive regions) and human and decoy reads (read-id remaps after
both filters)."""

import dataclasses
import os
import tarfile
import zipfile

import numpy as np
import pytest
import torch

from megapath_nano_tpu.align.pipeline import AlignParams as JAlignParams
from megapath_nano_tpu.db.refdb import RefDB as JRefDB
from megapath_nano_tpu.taxon.profiler import ProfileOptions as JOptions
from megapath_nano_tpu.taxon.profiler import TaxonProfiler as JProfiler
from megapath_nano_tpu.utils.dna import mutate, random_sequence, revcomp
from test_assembly_selection import _worlds
from test_profiler import _mock_world, _reads_with_mix
from megapath_nano_tpu_torch.align.records import AlignList as TAlignList
from megapath_nano_tpu_torch.state import refdb_from_numpy
from megapath_nano_tpu_torch.taxon.profiler import ProfileOptions as TOptions
from megapath_nano_tpu_torch.taxon.profiler import TaxonProfiler as TProfiler

ARCHIVES = (".tar.gz", ".tar", ".zip", ".npz")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# comparison helpers (shared with the other test_torch_profile* files)


def assert_align_lists_equal(a, b, what):
    assert type(b) is TAlignList, what
    assert a.data.dtype == b.data.dtype, what
    assert len(a.data) == len(b.data), (what, len(a.data), len(b.data))
    for f in a.data.dtype.names:            # the 18 fields
        np.testing.assert_array_equal(a.data[f], b.data[f],
                                      err_msg=f"{what}.{f}")
    assert list(a.sequence_names) == list(b.sequence_names), what
    assert list(a.assembly_names) == list(b.assembly_names), what
    assert list(a.read_names) == list(b.read_names), what
    assert a.cigar_map == b.cigar_map, what


def _assert_values_equal(a, b, what):
    if hasattr(a, "data") and hasattr(a, "cigar_map"):
        assert_align_lists_equal(a, b, what)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), what
        for k in a:
            _assert_values_equal(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_values_equal(x, y, f"{what}[{i}]")
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for fa in dataclasses.fields(a):
            _assert_values_equal(getattr(a, fa.name), getattr(b, fa.name),
                                 f"{what}.{fa.name}")
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def assert_results_equal(a, b):
    """Every ProfileResult field of the TPU package's result `a` equals the
    port's `b`."""
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    _assert_values_equal(a, b, "result")


def _members(path):
    if path.endswith((".zip", ".npz")):
        with zipfile.ZipFile(path) as z:
            return {n: z.read(n) for n in z.namelist()}
    with tarfile.open(path) as t:
        return {m.name: (t.extractfile(m).read() if m.isfile() else m.type)
                for m in t.getmembers()}


def assert_same_files(dir_a, dir_b, skip=(".timing",)):
    """The files of dir_a and dir_b: the same names, archives equal member
    by member, every other file byte-equal; names ending in `skip` (wall
    times) are only required to exist on both sides. Returns the names."""
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b))
    for n in names:
        pa, pb = os.path.join(dir_a, n), os.path.join(dir_b, n)
        if n.endswith(skip):
            continue
        if n.endswith(ARCHIVES):
            ma, mb = _members(pa), _members(pb)
            assert sorted(ma) == sorted(mb), n
            for m in ma:
                assert ma[m] == mb[m], f"{n}: member {m} differs"
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                a, b = fa.read(), fb.read()
            if n.endswith(".sam"):
                # the @PG line names the program that wrote the file
                a, b = (b"".join(ln for ln in x.splitlines(True)
                                 if not ln.startswith(b"@PG\t"))
                        for x in (a, b))
            assert a == b, f"{n} differs"
    return names


# ---------------------------------------------------------------------------
# the world


def _reads_at(rng, genome, n, length=800, err=0.04, start=None):
    out = []
    for _ in range(n):
        s = int(rng.integers(0, len(genome) - length)) if start is None \
            else start + int(rng.integers(0, 20))
        r = mutate(rng, genome[s: s + length], sub_rate=err / 2,
                   ins_rate=err / 4, del_rate=err / 4)
        out.append(revcomp(r) if rng.integers(0, 2) else r)
    return out


def noise_world(seed=0):
    """(reads, db, human_db, decoy_db) as TPU-package RefDBs."""
    rng = np.random.default_rng(seed)
    shared = random_sequence(rng, 5000)
    g_a = np.concatenate([random_sequence(rng, 19000), shared])
    g_a2 = np.concatenate([mutate(rng, g_a[:9000], 0.004, 0.001, 0.001),
                           mutate(rng, g_a[11500:], 0.004, 0.001, 0.001)])
    g_b = np.concatenate([shared, random_sequence(rng, 14000)])
    g_c = random_sequence(rng, 20000)
    g_d = mutate(rng, g_c, 0.015, 0.0025, 0.0025)
    human = np.concatenate([random_sequence(rng, 12000), g_c[5000:6500],
                            random_sequence(rng, 3000)])
    decoy = random_sequence(rng, 8000)
    db = JRefDB.build(
        [g_a, g_a2, g_b, g_c, g_d], ["cA", "cA2", "cB", "cC", "cD"],
        [0, 1, 2, 3, 4], ["asmA", "asmA2", "asmB", "asmC", "asmD"],
        [(1001, 101, 11), (1002, 101, 11), (1003, 102, 11),
         (1004, 103, 12), (1005, 104, 12)],
        {101: "Species alpha", 102: "Species beta", 103: "Species gamma",
         104: "Species delta"})
    human_db = JRefDB.build([human], ["chrH"], [0], ["GRCh38"],
                            [(9606, 9606, 9605)])
    decoy_db = JRefDB.build([decoy], ["chrD"], [0], ["decoy"],
                            [(32630, 32630, 32629)])
    reads = (_reads_at(rng, g_a, 45) + _reads_at(rng, g_c, 14)
             + _reads_at(rng, g_d, 5)
             + _reads_at(rng, g_c, 12, start=10000)        # a spike
             + _reads_at(rng, human[:12000], 6) + _reads_at(rng, decoy, 4)
             + [random_sequence(rng, 700) for _ in range(2)])
    order = rng.permutation(len(reads))
    return [reads[i] for i in order], db, human_db, decoy_db


@pytest.fixture(scope="module")
def world():
    reads, db, human_db, decoy_db = noise_world()
    return {"reads": reads, "names": [f"r{i}" for i in range(len(reads))],
            "jax": (db, human_db, decoy_db),
            "port": tuple(refdb_from_numpy(x)
                          for x in (db, human_db, decoy_db))}


# gate name -> ProfileOptions fields: the default gates, then one case for
# each gate of the placement and of the noise stack that maps nothing of its
# own (test_torch_profiler_noise.py has those that map genomes)
GATES = {
    "default": {},
    "paf_placement": {"emit_cigars": False},
    "human_filter": {"human_filter": True},
    "decoy_filter": {"decoy_filter": True},
    "human_and_decoy_filter": {"human_filter": True, "decoy_filter": True,
                               "unique_alignment": True},
    "reassignment": {"reassignment": True},
    "spike_filter": {"spike_filter": True},
    "closing_spike_filter": {"closing_spike_filter": True,
                             "closing_spike_stdev": 3.0},
    "short_alignment_filter": {"short_alignment_filter": True,
                               "min_alignment_length": 700},
    "unique_alignment": {"unique_alignment": True},
    "amplicon_filter_module": {"amplicon_filter_module": True},
}

# what a gate must have left in the result, so that no case compares two
# empty outcomes
EXPECT = {
    "default": lambda r: r.best.cigar_map,
    "paf_placement": lambda r: r.best.cigar_map is None,
    "human_filter": lambda r: len(r.human_read_ids) >= 5,
    "decoy_filter": lambda r: len(r.decoy_read_ids) >= 3,
    "human_and_decoy_filter": lambda r: (len(r.human_read_ids) >= 5
                                         and len(r.decoy_read_ids) >= 3),
    "spike_filter": lambda r: "spike" in r.noise_sources,
    "unique_alignment": lambda r: len(r.unique_read_ids) > 0,
    "human_repetitive_filter": lambda r: "human_repetitive" in r.noise_sources,
    "microbe_repetitive_filter":
        lambda r: "microbe_repetitive" in r.noise_sources,
    "variable_region_adjustment":
        lambda r: "variable_region" in r.noise_sources,
    "similar_species_marker": lambda r: r.similar_marks,
    "noise_projection": lambda r: any(p.projected_noise_reads
                                      for p in r.noise_projections),
}


def run_both(w, gates, tmp_path, *, cache=False):
    """Profile the world's reads with both packages; write both reports.
    Returns (TPU result, port result, TPU report dir, port report dir)."""
    jdb, jh, jd = w["jax"]
    tdb, th, td = w["port"]
    out = {}
    for side in ("jax", "port"):
        extra = {}
        if cache:
            extra["genome_pair_cache_dir"] = str(tmp_path / f"cache_{side}")
        if side == "jax":
            opts = JOptions(align=JAlignParams(backend="jnp"), **gates,
                            **extra)
            prof = JProfiler(jdb, opts, human_db=jh, decoy_db=jd)
        else:
            opts = TOptions(**gates, **extra)
            prof = TProfiler(tdb, opts, human_db=th, decoy_db=td,
                             device="cpu")
        res = prof.profile(w["reads"], w["names"])
        lengths = np.array([len(r) for r in w["reads"]], np.int64)
        quals = np.linspace(8.0, 30.0, len(w["reads"]))
        d = tmp_path / side
        prof.write_reports(res, str(d), "mix", read_lengths=lengths,
                           read_quals=quals, reads=w["reads"])
        out[side] = (res, str(d))
    return out["jax"][0], out["port"][0], out["jax"][1], out["port"][1]


def check_gate(world, gate, gates, tmp_path):
    jres, tres, jdir, tdir = run_both(world, gates, tmp_path)
    if gate in EXPECT:
        assert EXPECT[gate](jres), f"gate {gate} left no trace"
    assert len(jres.best) > 0
    assert_results_equal(jres, tres)
    names = assert_same_files(jdir, tdir)
    assert "mix.preport" in names and "mix.per_read.tar.gz" in names
    return jres, tres


@pytest.mark.parametrize("gate", list(GATES))
def test_profile_matches_reference(world, gate, tmp_path):
    check_gate(world, gate, GATES[gate], tmp_path)


def test_profiler_device_defaults_to_the_card(world):
    tdb = world["port"][0]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TProfiler(tdb)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TProfiler(tdb, aligner=object())


def test_mock_world_matches_reference(tmp_path):
    """The world of tests/test_profiler.py, default gates."""
    rng, genomes, db = _mock_world()
    reads, _ = _reads_with_mix(rng, genomes, [40, 20, 5])
    w = {"reads": reads, "names": [f"r{i}" for i in range(len(reads))],
         "jax": (db, None, None), "port": (refdb_from_numpy(db), None, None)}
    check_gate(w, "default", {}, tmp_path)


def _selection_world():
    main_db, assembly_db, reads = _worlds()
    return main_db, assembly_db, reads, refdb_from_numpy(main_db), \
        refdb_from_numpy(assembly_db)


@pytest.mark.parametrize("gate_on", [False, True])
def test_assembly_selection_matches_reference(gate_on, tmp_path):
    """The worlds of tests/test_assembly_selection.py, steps 4-7 gated on
    and off."""
    jmain, jasm, reads, tmain, tasm = _selection_world()
    kw = {"emit_cigars": False, "assembly_selection": gate_on}
    out = {}
    for side, prof in (
            ("jax", JProfiler(jmain, JOptions(
                align=JAlignParams(backend="jnp"), **kw), assembly_db=jasm)),
            ("port", TProfiler(tmain, TOptions(**kw), assembly_db=tasm,
                               device="cpu"))):
        res = prof.profile(reads)
        prof.write_reports(res, str(tmp_path / side), "t", reads=reads)
        out[side] = res
    assert out["jax"].selected_assembly_list.get(7001) == (2 if gate_on
                                                           else 0)
    assert_results_equal(out["jax"], out["port"])
    assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
