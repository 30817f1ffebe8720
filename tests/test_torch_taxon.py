"""Port parity for the host modules of the taxon profile: the port's copies
(utils/log, native/ssw, io/fastq, io/adapters, taxon/intervals, abundance,
best_align, filters, reassign, noise_stats, bed_cache, assembly_selection's
tables, db/refdb, report/writers, report/histograms, sim/simulator) against
the TPU package's modules of the same names. The same inputs, made from a
seed with numpy, go through both; outputs are integers, strings or floats
from the same numpy code, so they must be equal exactly (tolerance 0), and
files byte-equal."""

import importlib
import io
import time

import numpy as np
import pytest

from megapath_nano_tpu.align.records import ALIGN_DTYPE
from megapath_nano_tpu.utils.dna import mutate, random_sequence, revcomp
from megapath_nano_tpu_torch.state import refdb_from_numpy
from test_torch_profiler import _assert_values_equal, assert_same_files


def both(module):
    return (importlib.import_module("megapath_nano_tpu." + module),
            importlib.import_module("megapath_nano_tpu_torch." + module))


def same(a, b, what="value"):
    _assert_values_equal(a, b, what)


def align_lists(data, n_seqs=8, n_asm=4, cigar_map=None):
    """The same rows as an AlignList of each package."""
    out = []
    for rec in both("align.records"):
        out.append(rec.AlignList(
            data.copy(), [f"seq{i}" for i in range(n_seqs)],
            [f"asm{i}" for i in range(n_asm)],
            [f"r{i}" for i in range(int(data["read_id"].max()) + 1)],
            None if cigar_map is None else dict(cigar_map)))
    return out


def random_align_data(seed=0, n=400, n_reads=70, n_asm=4, per_asm=2,
                      seq_len=20000):
    """Rows with many ties (scores in steps of 50), several alignments a
    read, and a pile of 40 rows at one locus of assembly 3 (a spike)."""
    rng = np.random.default_rng(seed)
    d = np.zeros(n, ALIGN_DTYPE)
    d["read_id"] = rng.integers(0, n_reads, n)
    d["read_length"] = 700 + (d["read_id"] * 37) % 500
    sid = rng.integers(0, n_asm * per_asm, n)
    start = rng.integers(0, seq_len - 1200, n)
    start[-40:] = 9000 + rng.integers(0, 30, 40)
    sid[-40:] = 3 * per_asm
    span = np.minimum(rng.integers(60, 1100, n), d["read_length"])
    d["sequence_id"] = sid
    d["assembly_id"] = sid // per_asm
    d["sequence_length"] = seq_len
    d["sequence_from"] = start
    d["sequence_to"] = start + span
    d["read_from"] = rng.integers(0, 40, n)
    d["read_to"] = np.minimum(d["read_from"] + span, d["read_length"])
    d["strand"] = rng.integers(0, 2, n)
    d["match"] = span - rng.integers(0, 60, n)
    d["edit_dist"] = span - d["match"] + rng.integers(0, 20, n)
    d["alignment_score"] = 50 * rng.integers(2, 30, n)
    d["mapq"] = rng.integers(0, 61, n)
    a = d["assembly_id"].astype(np.int64)
    d["tax_id"] = 1000 + a
    d["species_tax_id"] = 100 + a // 2 * 2 + (a == 3)
    d["genus_tax_id"] = 10 + a // 2
    d["alignment_score_tiebreaker"] = rng.random(n)
    return d


def infos(n_asm=4, per_asm=2, seq_len=20000):
    out = []
    for ab in both("taxon.abundance"):
        a = np.arange(n_asm, dtype=np.int64)
        out.append(ab.AssemblyInfo(
            length=np.full(n_asm, per_asm * seq_len, np.int64),
            tax_id=1000 + a, species_tax_id=100 + a // 2 * 2 + (a == 3),
            genus_tax_id=10 + a // 2))
    return out


def random_bed(rng, n=60, n_asm=3, n_seqs=5, length=5000):
    start = rng.integers(0, length - 300, n)
    sid = rng.integers(0, n_seqs, n)
    return (sid % n_asm, sid, start, start + rng.integers(1, 300, n))


# ---------------------------------------------------------------------------
# utils/log, native/ssw, io/fastq, io/adapters


def test_log_messages_and_timing_table(monkeypatch):
    clock = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "time", lambda: float(next(clock)))
    monkeypatch.setattr(time, "strftime", lambda fmt: "2000-01-01 00:00:00")
    outs = []
    for log_mod in both("utils.log"):
        buf = io.StringIO()
        log = log_mod.Log("prog", stream=buf)
        with log.step("a"):
            log.message("inside")
        with pytest.raises(ValueError):
            with log.step("b"):
                raise ValueError("x")
        outs.append((buf.getvalue(), log.timing_table(), log.timings))
    same(outs[0], outs[1])


@pytest.mark.parametrize("want_cigar", [True, False])
def test_ssw_align(want_cigar):
    rng = np.random.default_rng(3)
    ref = random_sequence(rng, 900)
    reads = [mutate(rng, ref[s: s + 300], 0.05, 0.02, 0.02)
             for s in (0, 250, 590)] + [random_sequence(rng, 200)]
    jssw, tssw = both("native.ssw")
    for r in reads:
        same(jssw.ssw_align(r, ref, want_cigar=want_cigar),
             tssw.ssw_align(r, ref, want_cigar=want_cigar))
        mat = jssw.build_score_matrix(3, 6)
        same(mat, tssw.build_score_matrix(3, 6))
        same(jssw.ssw_align(r[:40], ref, score_matrix=mat, gap_open=5,
                            gap_extend=2),
             tssw.ssw_align(r[:40], ref, score_matrix=mat, gap_open=5,
                            gap_extend=2))
    same(jssw.ssw_align_batch(reads, [ref] * len(reads)),
         tssw.ssw_align_batch(reads, [ref] * len(reads)))


def _fastq_world(tmp_path, gz=False):
    import gzip

    rng = np.random.default_rng(5)
    seqs = [random_sequence(rng, int(n)) for n in rng.integers(50, 900, 40)]
    seqs[3][10:30] = 4                       # an N stretch
    quals = [rng.integers(2, 40, len(s)).astype(np.int8) for s in seqs]
    quals[7][:] = 3                          # fails QC
    names = [f"read{i} extra" for i in range(len(seqs))]
    jfq, tfq = both("io.fastq")
    paths = []
    for mod, tag in ((jfq, "j"), (tfq, "t")):
        p = tmp_path / f"{tag}.fastq"
        mod.write_fastq(str(p), names, seqs, quals)
        mod.write_fasta(str(tmp_path / f"{tag}.fasta"), names, seqs)
        paths.append(p)
    if gz:
        with open(paths[0], "rb") as f, gzip.open(
                tmp_path / "j.fastq.gz", "wb") as g:
            g.write(f.read())
    return paths


@pytest.mark.parametrize("kw", [
    {}, {"min_quality": 7.0}, {"head_crop": 20, "tail_crop": 15,
                               "min_length": 100},
    {"min_quality": 12.0, "keep_failed": True}])
def test_read_fastq(tmp_path, kw):
    _fastq_world(tmp_path, gz=True)
    jfq, tfq = both("io.fastq")
    for name in ("j.fastq", "j.fastq.gz", "j.fasta"):
        a = jfq.read_fastq(str(tmp_path / name), **kw)
        b = tfq.read_fastq(str(tmp_path / name), **kw)
        assert type(b).__module__.startswith("megapath_nano_tpu_torch")
        same(a, b, name)
    for ext in ("fastq", "fasta"):
        assert (tmp_path / f"j.{ext}").read_bytes() == \
            (tmp_path / f"t.{ext}").read_bytes()


def test_trim_adapters():
    jad, tad = both("io.adapters")
    from megapath_nano_tpu.utils.dna import encode

    rng = np.random.default_rng(6)
    start = encode(jad.DEFAULT_ADAPTERS[0].start_seq)
    end = encode(jad.DEFAULT_ADAPTERS[0].end_seq)
    mid = encode(jad.DEFAULT_ADAPTERS[2].start_seq)
    reads = []
    for i in range(24):
        body = random_sequence(rng, int(rng.integers(200, 1500)))
        kind = i % 6
        if kind == 1:
            body = np.concatenate([random_sequence(rng, 5), start, body])
        elif kind == 2:
            body = np.concatenate([body, end, random_sequence(rng, 4)])
        elif kind == 3 and len(body) > 700:
            h = len(body) // 2
            body = np.concatenate([body[:h], mid, body[h:]])
        elif kind == 4:
            body = np.concatenate([start, body, end])
        elif kind == 5:
            body = np.concatenate([body[:100], revcomp(mid), body[100:]])
        reads.append(mutate(rng, body, 0.01, 0.005, 0.005))
    names = [f"q{i}" for i in range(len(reads))]
    a = jad.trim_adapters(reads, names)
    b = tad.trim_adapters(reads, names)
    assert a.n_start_trimmed and a.n_end_trimmed and a.n_split
    same(a, b)
    same(jad.trim_adapters(reads, check_middle=False, end_threshold=60.0),
         tad.trim_adapters(reads, check_middle=False, end_threshold=60.0))


# ---------------------------------------------------------------------------
# taxon/intervals, abundance, best_align, filters, reassign, noise_stats


@pytest.mark.parametrize("seed", [0, 1])
def test_intervals(seed):
    ji, ti = both("taxon.intervals")
    rng = np.random.default_rng(seed)
    cols_a, cols_b = random_bed(rng), random_bed(rng, n=30)
    outs = []
    for m in (ji, ti):
        a, b = m.make_bed(*cols_a), m.make_bed(*cols_b)
        outs.append([a, m.sort_bed(a), m.merge_bed(a),
                     m.covered_bp_by_assembly(m.merge_bed(a)),
                     m.depth_segments(np.concatenate([a, b])),
                     m.overlap_bp(b, m.merge_bed(a)),
                     m.subtract_bed(m.merge_bed(a), m.merge_bed(b)),
                     m.intersect_bed(m.merge_bed(a), m.merge_bed(b)),
                     m.align_list_to_bed(random_align_data(seed)),
                     m.merge_bed(m.make_bed([], [], [], []))])
    same(outs[0], outs[1])


@pytest.mark.parametrize("with_noise", [False, True])
def test_abundance_and_best_align(with_noise):
    data = random_align_data(2)
    ja, ta = align_lists(data)
    ji, tinfo = infos()
    (jab, tab), (jbest, tbest), (jint, tint) = (
        both("taxon.abundance"), both("taxon.best_align"),
        both("taxon.intervals"))
    rng = np.random.default_rng(9)
    cols = random_bed(rng, n=20, n_asm=4, n_seqs=8, length=20000)
    jn = jint.merge_bed(jint.make_bed(*cols)) if with_noise else None
    tn = tint.merge_bed(tint.make_bed(*cols)) if with_noise else None
    same(jab.best_per_read_assembly(data), tab.best_per_read_assembly(data))
    js, ts = (jab.align_stat_by_assembly(ja, ji, jn),
              tab.align_stat_by_assembly(ta, tinfo, tn))
    same(js, ts)
    same(jab.summary_stat_2(js), tab.summary_stat_2(ts))
    lens = np.full(8, 20000, np.int64)
    same(jab.align_stat_by_sequence(ja, lens),
         tab.align_stat_by_sequence(ta, lens))
    for seed in (1, 7):
        same(jbest.best_align_list(ja, ji, jn, seed=seed),
             tbest.best_align_list(ta, tinfo, tn, seed=seed))


@pytest.mark.parametrize("stdev", [2.0, 6.0])
def test_spike_filter_and_reassign(stdev):
    data = random_align_data(3)
    ja, ta = align_lists(data)
    ji, tinfo = infos()
    jf, tf = both("taxon.filters")
    bed = jf.spike_filter_bed(ja, ji, stdev=stdev)
    assert len(bed) or stdev > 2
    same(bed, tf.spike_filter_bed(ta, tinfo, stdev=stdev))
    jr, tr = both("taxon.reassign")
    for kw in ({}, {"ratio": 0.2, "error_rate": 0.1, "as_threshold": 300}):
        same(jr.reassign(ja, **kw), tr.reassign(ta, **kw))


def test_noise_stats():
    data = random_align_data(4)
    ja, ta = align_lists(data)
    ji, tinfo = infos()
    (jn, tn), (jint, tint), (jb, tb) = (
        both("taxon.noise_stats"), both("taxon.intervals"),
        both("taxon.best_align"))
    rng = np.random.default_rng(11)
    c1 = random_bed(rng, n=15, n_asm=4, n_seqs=8, length=20000)
    c2 = random_bed(rng, n=15, n_asm=4, n_seqs=8, length=20000)
    outs = []
    for n, it, b, al, info in ((jn, jint, jb, ja, ji),
                               (tn, tint, tb, ta, tinfo)):
        src = {"spike": it.merge_bed(it.make_bed(*c1)),
               "variable_region": it.merge_bed(it.make_bed(*c2))}
        bed = it.merge_bed(np.concatenate(list(src.values())))
        best = b.best_align_list(al, info)
        table, mask = n.noise_removal_stats(best, src, bed,
                                            min_align_length=300)
        outs.append([n.select_alignment_rows_by_bed(al, bed),
                     n.select_alignment_rows_by_bed(al, None),
                     table, mask,
                     n.noise_source_stats(best.filter(mask), best,
                                          human_read_ids=np.array([1, 2]),
                                          decoy_read_ids=np.array([5]))])
    same(outs[0], outs[1])


def test_bed_cache_round_trips_across_packages(tmp_path):
    (jc, tc), (jint, _) = both("taxon.bed_cache"), both("taxon.intervals")
    bed = jint.merge_bed(jint.make_bed(*random_bed(np.random.default_rng(2))))
    jc.BedCache(str(tmp_path)).put("pair@0.9", bed)
    cache = tc.BedCache(str(tmp_path))
    same(bed, cache.get("pair@0.9"))
    assert cache.get("other") is None
    calls = []
    got = cache.get_or_compute("new", lambda: calls.append(1) or bed[:2])
    same(bed[:2], jc.BedCache(str(tmp_path)).get("new"))
    same(got, cache.get_or_compute("new", lambda: calls.append(1)))
    assert calls == [1]


def test_assembly_selection_tables():
    data = random_align_data(5)
    ja, ta = align_lists(data)
    ji, tinfo = infos()
    jm, tm = both("taxon.assembly_selection")
    jb, tb = both("taxon.best_align")
    for r in (0.0, 0.8, 0.95):
        same(jm.good_align_list(ja, r), tm.good_align_list(ta, r))
        js = jm.select_assemblies_per_species(ja, ji, good_ratio=r)
        same(js, tm.select_assemblies_per_species(ta, tinfo, good_ratio=r))
        same(jm.restrict_to_selected(ja, js),
             tm.restrict_to_selected(ta, js))
    same(jm.read_species_map(jb.best_align_list(ja, ji)),
         tm.read_species_map(tb.best_align_list(ta, tinfo)))


# ---------------------------------------------------------------------------
# db/refdb and state.refdb_from_numpy


def _refdb_parts(seed=7):
    rng = np.random.default_rng(seed)
    seqs = [random_sequence(rng, int(n)) for n in (3000, 2500, 4000, 1800)]
    return (seqs, ["s0", "s1", "s2", "s3"], [0, 0, 1, 2],
            ["asmX", "asmY", "asmZ"], [(1, 10, 5), (2, 20, 5), (3, 30, 6)],
            {10: "ten", 20: "twenty", 30: "thirty"})


def _refdb_fields(db):
    idx = db.index
    return [idx.k, idx.w, idx.keys, idx.positions, idx.seq_lengths,
            list(idx.seq_names), idx.seq_data, idx.seq_offsets,
            db.seq_assembly, db.assembly_names, db.assembly_lengths,
            db.assembly_tax, db.tax_names, db.assembly_info,
            db.sequence_meta]


def test_refdb_build_subset_and_check():
    jr, tr = both("db.refdb")
    parts = _refdb_parts()
    jdb, tdb = jr.RefDB.build(*parts, k=13, w=6), \
        tr.RefDB.build(*parts, k=13, w=6)
    same(_refdb_fields(jdb), _refdb_fields(tdb))
    same(_refdb_fields(jdb.subset(["asmZ", "asmX"])),
         _refdb_fields(tdb.subset(["asmZ", "asmX"])))
    with pytest.raises(ValueError):
        tdb.subset(["nope"])
    jdb.assembly_lengths[1] += 1
    tdb.assembly_lengths[1] += 1
    assert jdb.data_integrity_check() == tdb.data_integrity_check() != []


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_refdb_save_load_across_packages(tmp_path, direction):
    jr, tr = both("db.refdb")
    parts = _refdb_parts(8)
    src, dst = (jr, tr) if direction == "jax_to_port" else (tr, jr)
    built = src.RefDB.build(*parts)
    built.save(str(tmp_path / "db"))
    loaded = dst.RefDB.load(str(tmp_path / "db"))
    assert type(loaded) is dst.RefDB
    same(_refdb_fields(built), _refdb_fields(loaded))
    # and it saves back to the same files
    loaded.save(str(tmp_path / "again"))
    assert (tmp_path / "db" / "refdb.json").read_bytes() == \
        (tmp_path / "again" / "refdb.json").read_bytes()
    assert_same_files(str(tmp_path / "db"), str(tmp_path / "again"))


def test_refdb_from_numpy_shares_the_tables():
    jr, tr = both("db.refdb")
    jdb = jr.RefDB.build(*_refdb_parts(9))
    tdb = refdb_from_numpy(jdb)
    assert type(tdb) is tr.RefDB
    same(_refdb_fields(jdb), _refdb_fields(tdb))
    assert np.shares_memory(tdb.index.keys, jdb.index.keys)
    assert np.shares_memory(tdb.assembly_tax, jdb.assembly_tax)


# ---------------------------------------------------------------------------
# report/writers, report/histograms


def test_report_writers(tmp_path):
    data = random_align_data(6)
    ja, ta = align_lists(data)
    ji, tinfo = infos()
    jr, tr = both("db.refdb")
    jdb = jr.RefDB.build(*_refdb_parts())
    sides = {"jax": (both("report.writers")[0], both("taxon.abundance")[0],
                     ja, ji, jdb),
             "port": (both("report.writers")[1], both("taxon.abundance")[1],
                      ta, tinfo, refdb_from_numpy(jdb))}
    bed = both("taxon.intervals")[0].make_bed(*random_bed(
        np.random.default_rng(1), n_asm=4, n_seqs=8))
    names = [f"asm{i}" for i in range(4)]
    for side, (w, ab, al, info, db) in sides.items():
        d = tmp_path / side
        d.mkdir()
        stat = ab.align_stat_by_assembly(al, info)
        pre = {int(r["assembly_id"]): r for r in stat[:2]}
        w.write_preport(str(d / "x.preport"), stat, {100: "a b", 102: "c"})
        w.write_microbe_stat(str(d / "x.microbe_stat"), stat, names,
                             pre_stat=pre, similar_marks={1: True})
        w.write_stat_table(str(d / "x.stat"), stat, names)
        w.write_align_list_tsv(str(d / "x.list"), al)
        w.write_bed_tsv(str(d / "x.bed"), bed,
                        [f"seq{i}" for i in range(8)], names)
        w.write_genome_set(str(d / "x.genome_set"), db.assembly_names,
                           stat[:2], db)
        w.write_read_stat(str(d / "x.read_stat"), {
            "all": {"reads": 10, "bp": 1000}, "human": {"reads": 2,
                                                        "bp": 30}})
        assert w.species_abundance(stat)
    assert len(assert_same_files(str(tmp_path / "jax"),
                                 str(tmp_path / "port"))) == 7


@pytest.mark.parametrize("bins", [(None, None), (100, 0.2), (250, 1.5)])
def test_histograms(tmp_path, bins):
    rng = np.random.default_rng(4)
    cats = {"all": {"lengths": rng.integers(50, 30000, 300),
                    "quals": rng.uniform(3.0, 40.0, 300)},
            "human": {"lengths": np.zeros(0), "quals": None},
            "microbe": {"lengths": rng.integers(50, 3000, 20)}}
    for side, h in zip(("jax", "port"), both("report.histograms")):
        h.write_histograms(str(tmp_path / side), "p", cats,
                           length_bin=bins[0], quality_bin=bins[1])
        same(h.histogram_table(cats["all"]["lengths"], h.LENGTH_BINS),
             both("report.histograms")[0].histogram_table(
                 cats["all"]["lengths"], h.LENGTH_BINS))
    assert len(assert_same_files(str(tmp_path / "jax"),
                                 str(tmp_path / "port"))) == 2


# ---------------------------------------------------------------------------
# sim/simulator


@pytest.mark.parametrize("kw", [
    {}, {"circular": True, "max_length": 900, "with_quals": True},
    {"seed": 5, "max_length": 2000}])
def test_simulator(kw, tmp_path):
    js, ts = both("sim.simulator")
    genome = random_sequence(np.random.default_rng(1), 12000)
    same(js.simulate_reads(genome, 40, **kw),
         ts.simulate_reads(genome, 40, **kw))
    same(js.simulate_reads(genome, 20, js.R104, **kw),
         ts.simulate_reads(genome, 20, ts.R104, **kw))
    ts.R941.save(str(tmp_path / "p.json"))
    same(js.ErrorProfile.load(str(tmp_path / "p.json")), ts.R941)


def test_fit_profile():
    js, ts = both("sim.simulator")
    rng = np.random.default_rng(2)
    ref = random_sequence(rng, 3000)
    reads = [mutate(rng, ref[s: s + 500], 0.03, 0.01, 0.01)
             for s in (0, 700, 1500)]
    data = np.zeros(3, ALIGN_DTYPE)
    data["read_id"] = [0, 1, 2]
    data["sequence_from"] = [0, 700, 1500]
    cmap = {(i, 0): ([(len(r), "M")], 0, 0) for i, r in enumerate(reads)}
    ja, ta = align_lists(data, n_seqs=1, n_asm=1, cigar_map=cmap)
    same(js.fit_profile(ja, reads, {0: ref}), ts.fit_profile(ta, reads,
                                                            {0: ref}))
