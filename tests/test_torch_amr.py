"""Port parity for the AMR module (megapath_nano_tpu_torch amr/ with
device="cpu" against the TPU package's amr/ with backend="jnp"), on the
worlds of the 9 tests in tests/test_amr.py: consensus contigs (every
field, at three depth cuts), every AMRHit field, AMRResult.merged, ORFs and
protein hits, results.csv and the hydrolytic profile byte-equal, and the
AMRGeneDB on-disk format across the packages (state.amr_db_from_numpy
included). Every value is an integer, a string or a float computed by the
same numpy code, so the tolerance is 0."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from megapath_nano_tpu.align.pipeline import AlignParams as JAlignParams
from megapath_nano_tpu.amr import consensus as jconsensus
from megapath_nano_tpu.amr import db as jdb
from megapath_nano_tpu.amr import module as jmodule
from megapath_nano_tpu.amr import orf as jorf
from megapath_nano_tpu.amr import protein as jprotein
from megapath_nano_tpu.amr import report as jreport
from megapath_nano_tpu.amr import scan as jscan
from megapath_nano_tpu.db.refdb import RefDB as JRefDB
from megapath_nano_tpu.taxon.profiler import ProfileOptions as JOptions
from megapath_nano_tpu.taxon.profiler import TaxonProfiler as JProfiler
from megapath_nano_tpu.utils.dna import encode, mutate, random_sequence
from megapath_nano_tpu.utils.dna import revcomp
from megapath_nano_tpu_torch import state
from megapath_nano_tpu_torch.amr import consensus as tconsensus
from megapath_nano_tpu_torch.amr import db as tdb
from megapath_nano_tpu_torch.amr import module as tmodule
from megapath_nano_tpu_torch.amr import orf as torf
from megapath_nano_tpu_torch.amr import protein as tprotein
from megapath_nano_tpu_torch.amr import report as treport
from megapath_nano_tpu_torch.amr import scan as tscan
from megapath_nano_tpu_torch.taxon.profiler import ProfileOptions as TOptions
from megapath_nano_tpu_torch.taxon.profiler import TaxonProfiler as TProfiler
from test_torch_profiler import _assert_values_equal, assert_align_lists_equal

AAS = "ARNDCQEGHILKMFPSTWYV"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the whole module, its module-scoped fixtures
    included (xdist runs several files at once)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both_profiles(genome, reads):
    """The best alignments of the TPU package's profile and of the port's
    (device="cpu") on a one-genome DB, held equal; returns both."""
    refdb = JRefDB.build([genome], ["chr1"], [0], ["asm1"], [(1, 1, 1)],
                         {1: "Bug one"})
    jres = JProfiler(refdb, JOptions(align=JAlignParams(
        backend="jnp"))).profile(reads)
    tres = TProfiler(state.refdb_from_numpy(refdb), TOptions(),
                     device="cpu").profile(reads)
    assert_align_lists_equal(jres.best, tres.best, "best")
    return jres.best, tres.best


@pytest.fixture(scope="module")
def e2e():
    """tests/test_amr.py::test_amr_end_to_end's world: two genes in a 22 kb
    genome (a third gene only in the DB), 120 reads at 6% error, two gene
    DBs; profiled by both packages once."""
    rng = np.random.default_rng(0)
    gene_blaTEM = random_sequence(rng, 900)
    gene_vanA = random_sequence(rng, 1100)
    other_gene = random_sequence(rng, 800)
    backbone = random_sequence(rng, 20000)
    genome = np.concatenate([
        backbone[:6000], gene_blaTEM, backbone[6000:14000], gene_vanA,
        backbone[14000:]])
    dbs = [jdb.AMRGeneDB("resfinder", ["blaTEM-1", "vanA", "mecA"],
                         [gene_blaTEM, gene_vanA, other_gene],
                         [["ampicillin"], ["vancomycin"], ["methicillin"]]),
           jdb.AMRGeneDB("card", ["TEM-1"], [gene_blaTEM],
                         [["ampicillin", "penicillins"]])]
    reads = []
    for _ in range(120):
        s = int(rng.integers(0, len(genome) - 900))
        r = mutate(rng, genome[s: s + 900], sub_rate=0.03, ins_rate=0.015,
                   del_rate=0.015)
        if rng.integers(0, 2):
            r = revcomp(r)
        reads.append(r)
    jbest, tbest = _both_profiles(genome, reads)
    return genome, reads, dbs, jbest, tbest


def _protein_db(pkg, contigs):
    """A CBMAR-style protein DB whose first two proteins are the two
    longest ORFs of the contigs (so the protein path hits), with a third
    that matches nothing."""
    orfs = sorted((o for c in contigs for o in jorf.find_orfs(c.seq)),
                  key=lambda o: -len(o.aa))[:2]
    rng = np.random.default_rng(5)
    recs = [(f"blaP{i}", jorf.aa_to_str(o.aa), f"P{i}", prof)
            for i, (o, prof) in enumerate(zip(
                orfs, ["penicillinase", "cephalosporinase (class C)"]))]
    recs.append(("blaQ", "M" + "".join(rng.choice(list(AAS), 150)), "Q1",
                 "carbapenemase"))
    return pkg.ProteinDB.from_records("cbmar", recs)


def test_amr_end_to_end_matches(e2e, tmp_path):
    genome, reads, dbs, jbest, tbest = e2e
    jcontigs = jconsensus.consensus_contigs(jbest, reads, 0, genome)
    jres = jmodule.run_amr(jbest, reads, {0: genome}, dbs, backend="jnp",
                           protein_db=_protein_db(jprotein, jcontigs))
    tres = tmodule.run_amr(tbest, reads, {0: genome},
                           [state.amr_db_from_numpy(d) for d in dbs],
                           device="cpu",
                           protein_db=_protein_db(tprotein, jcontigs))
    _assert_values_equal(jres, tres, "amr")
    # the world's own answer, so the comparison is of a real result
    assert {h.gene for h in tres.hits_by_db["resfinder"]} == \
        {"blaTEM-1", "vanA"}
    assert set(tres.merged) == {"AMPICILLIN", "PENICILLIN", "VANCOMYCIN",
                                "BETALACTAMASE"}
    assert len(tres.protein_hits) >= 2 and tres.hydrolytic_profiles
    jres.write(str(tmp_path / "jax"), "demo")
    tres.write(str(tmp_path / "port"), "demo")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "demo.cbmar_protein_blasted_hydrolytic_profile.txt",
        "demo.results.csv"]
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == \
            (tmp_path / "port" / n).read_bytes(), n


def test_amr_device_defaults_to_the_card(e2e):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    genome, reads, dbs, _, tbest = e2e
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tmodule.run_amr(tbest, reads, {0: genome},
                        [state.amr_db_from_numpy(dbs[0])])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tscan.scan_contigs([], state.amr_db_from_numpy(dbs[0]))


def test_consensus_corrects_read_errors_matches():
    rng = np.random.default_rng(4)
    genome = random_sequence(rng, 5000)
    reads = [mutate(rng, genome[500:4500], sub_rate=0.04, ins_rate=0.02,
                    del_rate=0.02) for _ in range(40)]
    jbest, tbest = _both_profiles(genome, reads)
    jc = jconsensus.consensus_contigs(jbest, reads, 0, genome)
    tc = tconsensus.consensus_contigs(tbest, reads, 0, genome)
    _assert_values_equal(jc, tc, "contigs")
    assert max(len(c.seq) for c in tc) > 3500
    for min_depth in (3, 30):
        _assert_values_equal(
            jconsensus.consensus_contigs(jbest, reads, 0, genome,
                                         min_depth=min_depth),
            tconsensus.consensus_contigs(tbest, reads, 0, genome,
                                         min_depth=min_depth), "depth")
    np.testing.assert_array_equal(
        jconsensus.pileup_counts(jbest, reads, 0, len(genome)),
        tconsensus.pileup_counts(tbest, reads, 0, len(genome)))


def test_canonical_drug_and_header_parsers_match():
    for name in ("ampicillins", "beta-lactam antibiotics", "Vancomycin",
                 "aminoglycosides", "s", "", "Multi-drug antibiotic"):
        assert tdb.canonical_drug(name) == jdb.canonical_drug(name)
    headers = {
        "card": ["gb|GQ343019.1|+|132-1023|ARO:3002999|CblA-1 "
                 "[Bacteroides uniformis CL03T12C37]", "gb|X|-|1-2|ARO:1|Y"],
        "megares": ["MEG_1|Drugs|Aminoglycosides|Aminoglycoside-resistant_"
                    "16S_ribosomal_subunit_protein|A16S",
                    "MEG_2|Metals|Copper|Copper_resistance|PCOA"],
        "resfinder": ["blaTEM-1B_1_AY458016", "vanA_1", "x"],
    }
    for kind, hs in headers.items():
        for h in hs:
            assert getattr(tdb, f"parse_{kind}_header")(h) == \
                getattr(jdb, f"parse_{kind}_header")(h), (kind, h)


def test_orfs_and_translation_match():
    prot = "MKRLLATGWYV" * 12
    codon_of = {"M": "ATG", "K": "AAA", "R": "CGT", "L": "CTG", "A": "GCT",
                "T": "ACT", "G": "GGT", "W": "TGG", "Y": "TAT", "V": "GTT"}
    seq = encode("".join(codon_of[c] for c in prot) + "TAA")
    pad = encode("CCCCC")
    contig = np.concatenate([pad, seq, pad])
    rng = np.random.default_rng(2)
    for s in (contig, revcomp(contig), random_sequence(rng, 3000)):
        np.testing.assert_array_equal(torf.translate(s), jorf.translate(s))
        for min_aa in (50, 60):
            _assert_values_equal(jorf.find_orfs(s, min_aa=min_aa),
                                 torf.find_orfs(s, min_aa=min_aa), "orfs")
    assert torf.aa_to_str(torf.translate(seq)) == prot + "*"
    np.testing.assert_array_equal(torf.aa_from_str(prot),
                                  jorf.aa_from_str(prot))


def _protein_worlds():
    """test_protein_scan_and_hydrolytic_profile's and
    test_protein_scan_tolerates_mutations' worlds: (ORFs, protein
    records)."""
    rng = np.random.default_rng(7)
    prot = "M" + "".join(rng.choice(list(AAS), 150))
    a = jorf.aa_from_str(prot)
    w1 = ([jorf.ORF(start=0, end=3 * len(prot), strand=0, frame=0, aa=a)],
          [("blaX", prot, "P00811", "cephalosporinase (class C)"),
           ("blaY", "".join(rng.choice(list(AAS), 140)), "P12345",
            "penicillinase")])
    rng = np.random.default_rng(11)
    prot = list("M" + "".join(rng.choice(list(AAS), 150)))
    query = prot.copy()
    for i in rng.choice(len(query), 6, replace=False):
        query[int(i)] = AAS[int(rng.integers(0, 20))]
    w2 = ([jorf.ORF(0, 453, 0, 0, jorf.aa_from_str("".join(query)))],
          [("blaZ", "".join(prot), "P1", "carbapenemase")])
    return [w1, w2]


@pytest.mark.parametrize("world", [0, 1])
def test_protein_scan_matches(world):
    orfs, recs = _protein_worlds()[world]
    jp, tp = (pkg.ProteinDB.from_records("cbmar", recs)
              for pkg in (jprotein, tprotein))
    _assert_values_equal(jp, tp, "protein_db")
    t_orfs = [torf.ORF(o.start, o.end, o.strand, o.frame, o.aa)
              for o in orfs]
    for o, to in zip(orfs, t_orfs):
        for p in jp.sequences:
            assert tprotein.sw_protein(to.aa, p) == \
                jprotein.sw_protein(o.aa, p)
    jh = jprotein.scan_orfs(orfs, jp, min_identity=90.0,
                            min_query_coverage=60.0)
    th = tprotein.scan_orfs(t_orfs, tp, min_identity=90.0,
                            min_query_coverage=60.0)
    _assert_values_equal(jh, th, "hits")
    assert len(th) == 1
    assert tprotein.hydrolytic_profiles(th) == \
        jprotein.hydrolytic_profiles(jh)


def test_amrfinder_taxon_gating_matches():
    rng = np.random.default_rng(13)
    gene = random_sequence(rng, 1200)
    db = jdb.AMRGeneDB("amrfinder", ["pointmut_X"], [gene.copy()],
                       [["ciprofloxacin"]], accessions=["WP_1"],
                       taxa=["Escherichia"])
    contig = jconsensus.ConsensusContig(
        sequence_id=0, start=0, seq=np.concatenate(
            [random_sequence(rng, 300), gene, random_sequence(rng, 300)]))
    tcontig = tconsensus.ConsensusContig(**{
        f.name: getattr(contig, f.name)
        for f in dataclasses.fields(contig)})
    tdb_ = state.amr_db_from_numpy(db)
    counts = []
    for organism in (None, "Escherichia coli", "Klebsiella pneumoniae"):
        jh = jscan.scan_contigs([contig], db, organism=organism)
        th = tscan.scan_contigs([tcontig], tdb_, organism=organism,
                                device="cpu")
        _assert_values_equal(jh, th, f"hits[{organism}]")
        counts.append(len(th))
    assert counts == [0, 1, 0]


def test_results_csv_reference_columns_match(tmp_path):
    hits = {
        "card": [("card", "CblA-1", 0, 0.97, 0.9, 500, 0,
                  ["beta-lactam antibiotics"], "GQ343019.1")],
        "resfinder": [("resfinder", "blaTEM-1B_1", 0, 0.99, 0.95, 600, 0,
                       ["ampicillins"], "AY458016"),
                      ("resfinder", "blaTEM-2", 1, 0.95, 0.9, 550, 0,
                       ["ampicillins", "Vancomycin"], "AY458017")],
    }
    jm = jreport.merge_results(
        {k: [jscan.AMRHit(*h) for h in v] for k, v in hits.items()})
    tm = treport.merge_results(
        {k: [tscan.AMRHit(*h) for h in v] for k, v in hits.items()})
    _assert_values_equal(jm, tm, "merged")
    jreport.write_results_csv(str(tmp_path / "j.csv"), jm, sorted(hits))
    treport.write_results_csv(str(tmp_path / "t.csv"), tm, sorted(hits))
    jreport.write_hydrolytic_profile(str(tmp_path / "j.txt"), ["a", "b"])
    treport.write_hydrolytic_profile(str(tmp_path / "t.txt"), ["a", "b"])
    for a, b in (("j.csv", "t.csv"), ("j.txt", "t.txt")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()


def test_gene_db_on_disk_across_packages(tmp_path):
    """A gene DB saved by either package loads in the other, field for
    field; attach_phenotypes and the index agree; amr_db_from_numpy carries
    the built index over without rebuilding it."""
    rng = np.random.default_rng(3)
    db = jdb.AMRGeneDB("resfinder", ["blaTEM-1_1_AY1", "vanA_2", "mecA_1"],
                       [random_sequence(rng, n) for n in (900, 1100, 800)],
                       [[], ["vancomycin"], []], classes=["", "gly", ""],
                       accessions=["AY1", "", "X"],
                       taxa=[None, "Enterococcus", None])
    db.save(str(tmp_path / "j"))
    t = tdb.AMRGeneDB.load(str(tmp_path / "j"))
    t.save(str(tmp_path / "t"))
    back = jdb.AMRGeneDB.load(str(tmp_path / "t"))
    for a, b in ((db, t), (db, back)):
        for f in ("name", "gene_names", "drugs", "classes", "accessions",
                  "taxa"):
            assert getattr(a, f) == getattr(b, f), f
        for x, y in zip(a.sequences, b.sequences):
            np.testing.assert_array_equal(x, y)
    assert (tmp_path / "j" / "amrdb.json").read_bytes() == \
        (tmp_path / "t" / "amrdb.json").read_bytes()
    table = {"blaTEM-1": ["ampicillin"], "mecA_1": ["methicillin"]}
    db.attach_phenotypes(table)
    t.attach_phenotypes(table)
    assert t.drugs == db.drugs == [["ampicillin"], ["vancomycin"],
                                   ["methicillin"]]
    carried = state.amr_db_from_numpy(db)
    assert type(carried) is tdb.AMRGeneDB and carried._index is None
    ji = db.index()
    carried = state.amr_db_from_numpy(db)
    assert carried._index is not None and carried.index() is carried._index
    ti = t.index()
    for f in ("keys", "positions", "seq_lengths", "seq_data", "seq_offsets"):
        np.testing.assert_array_equal(getattr(ji, f), getattr(ti, f))
        np.testing.assert_array_equal(getattr(ji, f),
                                      getattr(carried.index(), f))
    assert (ti.k, ti.w) == (ji.k, ji.w) == (15, 5)
