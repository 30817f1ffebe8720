"""The port's span and counter record (`megapath_nano_tpu_torch.utils.log`):
nesting, request ids across worker threads, counts on the innermost span,
the ring's bound, stamps against torch.profiler's clock, and the spans and
counters of the map path (host path and fused path), of trimming, of
`Log.step` and of the CLI (`--span_trace`). CPU only."""

import contextvars
import inspect
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from megapath_nano_tpu_torch.align import pipeline as tp
from megapath_nano_tpu_torch.cli import main as tcli
from megapath_nano_tpu_torch.db.refdb import RefDB
from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex
from megapath_nano_tpu_torch.io import adapters
from megapath_nano_tpu_torch.io.fastq import write_fastq
from megapath_nano_tpu_torch.utils import log
from megapath_nano_tpu_torch.utils.dna import (encode, mutate,
                                               random_sequence, revcomp)
from megapath_nano_tpu_torch.utils.log import RECORD, Log, count, span

TINY = staticmethod(lambda slice_n, read_max, occ=0.0: (64, 64, 64))
HOST_CHILDREN = {"map.seed", "map.chain", "map.fetch", "map.windows",
                 "map.extend", "map.select", "map.traceback", "map.emit"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _world(seed, n_genomes=3, glen=20000, n_reads=40, read_len=800):
    rng = np.random.default_rng(seed)
    genomes = [random_sequence(rng, glen) for _ in range(n_genomes)]
    reads = []
    for _ in range(n_reads):
        g = int(rng.integers(0, n_genomes))
        s = int(rng.integers(0, glen - read_len))
        read = mutate(rng, genomes[g][s: s + read_len], sub_rate=0.04,
                      ins_rate=0.02, del_rate=0.02)
        reads.append(revcomp(read) if rng.integers(0, 2) else read)
    return genomes, reads


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nesting_and_parent_ids():
    with span("outer") as a:
        with span("middle") as b:
            with span("inner") as c:
                pass
        with span("sibling") as d:
            pass
    assert (a.parent, b.parent, c.parent, d.parent) == (None, a.id, b.id,
                                                        a.id)
    assert {a.root, b.root, c.root, d.root} == {a.id}
    assert len({a.id, b.id, c.id, d.id}) == 4
    assert [s.name for s in RECORD.request(a.id)] == \
        ["inner", "middle", "sibling", "outer"]
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns \
        <= d.start_ns <= d.end_ns <= a.end_ns
    assert a.thread == threading.get_native_id()
    # an exception closes and records the span on its way out
    with pytest.raises(ValueError):
        with span("raises") as e:
            raise ValueError("x")
    assert e.end_ns >= e.start_ns and RECORD.request(e.id) == [e]


def test_counts_land_on_the_innermost_span():
    count("no_span_open", 5)            # nothing open: a no-op
    with span("a") as a:
        count("x", 2)
        with span("b") as b:
            count("y", 3)
            count("y", 4)
        count("x")
    assert a.counts == {"x": 3} and b.counts == {"y": 7}


def test_worker_threads_share_the_callers_request():
    def work(i):
        with span("work") as s:
            count("i", i)
        return s

    with span("call") as call:
        with ThreadPoolExecutor(max_workers=2) as ex:
            futs = [ex.submit(contextvars.copy_context().run, work, i)
                    for i in range(6)]
            got = [f.result() for f in futs]
    assert {(s.parent, s.root) for s in got} == {(call.id, call.id)}
    assert sorted(s.counts["i"] for s in got) == list(range(6))
    assert all(s.thread != call.thread for s in got)


def test_record_under_thread_stress():
    """More threads than cores, a short switch interval: every span gets
    its own id and lands in the record once."""
    import sys

    def work(i):
        for _ in range(300):
            with span("w"):
                count("n")
        return i

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with span("stress") as top:
            with ThreadPoolExecutor(max_workers=16) as ex:
                futs = [ex.submit(contextvars.copy_context().run, work, i)
                        for i in range(16)]
                assert sorted(f.result(timeout=60) for f in futs) == \
                    list(range(16))
    finally:
        sys.setswitchinterval(prev)
    got = [s for s in RECORD.request(top.id) if s.name == "w"]
    assert len(got) == 16 * 300 == len({s.id for s in got})
    assert all(s.counts == {"n": 1} and s.parent == top.id for s in got)


def test_ring_bound_and_dropped():
    assert RECORD._ring.maxlen == log.CAPACITY == 65536
    rec = log.SpanRecord(capacity=4)
    spans = [log.Span(f"s{i}", i, None, i, 0) for i in range(10)]
    for s in spans:
        rec.add(s)
    assert rec.spans() == spans[-4:] and rec.dropped == 6


def test_stamps_match_the_profilers_clock():
    """A span's epoch stamps lie within 1 ms of those of a profiler range
    opened right around it, and the span adds no range of its own."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):
            pass                # the first range pays the profiler's set-up
        mine = []
        for i in range(4):
            with torch.profiler.record_function(f"probe{i}"):
                with span(f"probe{i}") as s:
                    torch.ones(64).sum()
            mine.append(s)
    base = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events() if e.name.startswith("probe")}
    assert set(events) == {f"probe{i}" for i in range(4)}
    for s in mine:
        ev = events[s.name]
        assert abs(base + ev.time_range.start * 1000 - s.start_ns) < 1e6
        assert abs(base + ev.time_range.end * 1000 - s.end_ns) < 1e6
    assert not [e for e in prof.events() if e.name.startswith("mpn.")]


def test_spans_never_synchronise(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("a"):
            count("n", 1)
    with span("b"):
        count("n", 1)
    assert calls == []
    src = inspect.getsource(log)
    for word in ("synchronize", ".cpu(", ".item(", "torch.cuda"):
        assert word not in src, word


@pytest.fixture(scope="module")
def host_map():
    """A CPU map in CIGAR mode (the host path) with slices of 10 reads on
    the two worker threads; the extension kernel's calls recorded."""
    genomes, reads = _world(3, n_reads=30, read_len=700)
    aligner = tp.MinimizerAligner(MinimizerIndex.build(genomes),
                                  device="cpu")
    scored = []
    orig = tp.banded_sw_scores

    def spy(reads_t, *a, **kw):
        scored.append(reads_t.shape[0])
        return orig(reads_t, *a, **kw)

    tp.banded_sw_scores = spy
    try:
        with span("test") as top:
            al = aligner.map_reads(reads, slice_size=10, emit_cigars=True)
    finally:
        tp.banded_sw_scores = orig
    return al, RECORD.request(top.id), top, sum(scored), len(reads)


def test_host_path_span_tree(host_map):
    al, spans, top, n_scored, n_reads = host_map
    by = _by_name(spans)
    (call,) = by["map.call"]
    assert call.parent == top.id
    slices = by["map.slice"]
    assert len(slices) == 3 and {s.parent for s in slices} == {call.id}
    assert {s.root for s in spans} == {top.id}
    (concat,) = by["map.concat"]
    assert concat.parent == call.id
    ids = {s.id: s for s in spans}
    for sl in slices:
        kids = [s for s in spans if s.parent == sl.id]
        assert {k.name for k in kids} == HOST_CHILDREN
        assert len(kids) + 1 <= 64
        assert all(k.thread == sl.thread for k in kids)
        assert all(sl.start_ns <= k.start_ns <= k.end_ns <= sl.end_ns
                   for k in kids)
        assert sl.counts["host_path"] == 1
        assert sl.counts["long_reads"] == 0
    assert sum(s.counts["reads"] for s in slices) == n_reads
    # no span below the stages: nothing per read or per window
    assert all(ids[s.parent].name in ("map.slice", "map.call", "test")
               for s in spans if s.parent is not None)


def test_host_path_counters(host_map):
    al, spans, _, n_scored, _ = host_map
    by = _by_name(spans)
    tb = by["map.traceback"]
    assert sum(s.counts["traceback_pairs"] for s in tb) == len(al) > 0
    assert all(0 <= s.counts["traceback_redo"] <= s.counts["traceback_pairs"]
               for s in tb)
    ext = by["map.extend"]
    assert sum(s.counts["windows"] for s in ext) == n_scored > 0
    for s in ext:
        assert 0 < s.counts["window_bytes"] <= s.counts["window_bytes_padded"]


def test_long_reads_count():
    """A read over the fused gate's length sends its PAF slice to the host
    path; the slice counts it. The long read is the genome's last 700 b
    and 16 kb of random bases, so that its window stays short."""
    rng = np.random.default_rng(8)
    genome = random_sequence(rng, 20000)
    reads = [mutate(rng, genome[s: s + 700], sub_rate=0.02, ins_rate=0.01,
                    del_rate=0.01) for s in (19300, 2000)]
    reads[0] = np.concatenate([reads[0], random_sequence(rng, 16000)])
    aligner = tp.MinimizerAligner(MinimizerIndex.build([genome]),
                                  device="cpu")
    with span("test") as top:
        al = aligner.map_reads(reads, emit_cigars=False)
    by = _by_name(RECORD.request(top.id))
    (sl,) = by["map.slice"]
    assert sl.counts == {"reads": 2, "host_path": 1, "long_reads": 1}
    # short windows: the full-stats kernel, padded to rows of 1024, and
    # no host traceback
    (ext,) = by["map.extend"]
    assert ext.counts["windows"] >= len(al) > 0
    assert ext.counts["window_bytes_padded"] % 1024 == 0
    assert "map.traceback" not in by


@pytest.mark.parametrize("slice_size", [None, 8])
def test_fused_path_spans(slice_size, monkeypatch):
    """PAF mode inside the fused gate: submit, fetch, collect; with tiny
    device caps the partial redo is counted."""
    monkeypatch.setattr(tp.MinimizerAligner, "_devseed_caps", TINY)
    genomes, reads = _world(5, n_reads=16, read_len=600)
    aligner = tp.MinimizerAligner(MinimizerIndex.build(genomes),
                                  device="cpu")
    with span("test") as top:
        al = aligner.map_reads(reads, slice_size=slice_size,
                               emit_cigars=False)
    spans = RECORD.request(top.id)
    by = _by_name(spans)
    assert len(al) > 0
    assert {"map.call", "map.submit", "map.fetch", "map.collect"} <= set(by)
    assert not set(by) & {"map.windows", "map.extend", "map.traceback"}
    redone = sum(s.counts.get("redo_reads", 0) for s in spans)
    assert redone == aligner.overflow_stats["reads_redone"] >= 1
    if slice_size is None:
        (sl,) = by["map.slice"]
        assert sl.counts["reads"] == len(reads)
        assert "host_path" not in sl.counts


def test_trim_counts_match_the_adapter_set():
    """Reads without adapters scan every adapter: each start sequence over
    the first 150 b, each end sequence over the last 150 b, and every
    middle sequence (start, its reverse complement, end) over the read."""
    rng = np.random.default_rng(4)
    lens = [700, 1500, 2400]
    reads = [random_sequence(rng, n) for n in lens]
    ads = adapters.DEFAULT_ADAPTERS
    starts = [len(a.start_seq) for a in ads if a.start_seq]
    ends = [len(a.end_seq) for a in ads if a.end_seq]
    middles = 2 * starts + ends
    with span("test") as top:
        res = adapters.trim_adapters(reads)
    (tr,) = RECORD.request(top.id)[:-1]
    assert tr.name == "trim" and tr.parent == top.id
    cells = sum(sum(starts) * 150 + sum(ends) * 150 + sum(middles) * n
                for n in lens)
    assert tr.counts == {"reads": 3,
                         "scans": 3 * (len(starts) + len(ends)
                                       + len(middles)),
                         "scan_cells": cells, "split": 0, "dropped": 0}
    assert res.n_split == 0 and len(res.reads) == 3
    # a read with the first start adapter in its middle is split once
    a = encode(ads[0].start_seq)
    mid = np.concatenate([reads[1][:800], a, reads[2][:800]])
    with span("test") as top:
        res = adapters.trim_adapters([mid])
    (tr,) = RECORD.request(top.id)[:-1]
    assert tr.counts["split"] == res.n_split == 1
    assert tr.counts["dropped"] == res.n_dropped == 0


def test_log_step_spans():
    lg = Log("prog", enabled=False)
    with lg.step("outer") as _:
        with lg.step("inner"):
            count("n", 2)
    outer = [s for s in RECORD.spans() if s.name == "step.outer"][-1]
    inner = RECORD.request(outer.root)
    assert [s.name for s in inner] == ["step.inner", "step.outer"]
    assert inner[0].parent == outer.id and inner[0].counts == {"n": 2}
    assert [name for name, _ in lg.timings] == ["inner", "outer"]


def test_cli_span_tree_and_chrome_trace(tmp_path):
    """`cli.main` is the root; steps, the trim and the maps under it;
    `--span_trace` writes the run's spans as Chrome-trace JSON."""
    genomes, reads = _world(7, n_genomes=2, n_reads=30, read_len=900)
    db = RefDB.build(genomes, ["g0", "g1"], [0, 1], ["a0", "a1"],
                     [(100, 10, 1), (200, 20, 2)], {10: "s10", 20: "s20"})
    db.save(str(tmp_path / "db"))
    fq = tmp_path / "r.fastq"
    write_fastq(str(fq), [f"r{i}" for i in range(len(reads))], reads)
    trace = tmp_path / "spans.json"
    rc = tcli.main(["--query", str(fq), "--db", str(tmp_path / "db"),
                    "--output_folder", str(tmp_path / "out"),
                    "--output_prefix", "p", "--device", "cpu",
                    "--span_trace", str(trace)])
    assert rc == 0
    timing = (tmp_path / "out" / "p.timing").read_text().split()
    assert "write_reports" in timing
    doc = json.loads(trace.read_text())
    evs = doc["traceEvents"]
    assert doc["baseTimeNanoseconds"] == 0
    (root,) = [e for e in evs if e["name"] == "cli.main"]
    assert root["args"]["parent"] is None
    assert {e["args"]["root"] for e in evs} == {root["args"]["id"]}
    ids = {e["args"]["id"]: e for e in evs}
    names = {e["name"] for e in evs}
    assert {"step.load_db", "step.adaptor_trimming", "trim",
            "step.placement_to_species", "step.write_reports",
            "map.call"} <= names
    (trim,) = [e for e in evs if e["name"] == "trim"]
    assert ids[trim["args"]["parent"]]["name"] == "step.adaptor_trimming"
    assert trim["args"]["reads"] == len(reads)
    for e in evs:
        assert e["ph"] == "X" and e["dur"] >= 0
        if e is not root:
            assert root["ts"] <= e["ts"] <= root["ts"] + root["dur"]
    # the epoch clock, in microseconds
    assert abs(root["ts"] / 1e6 - log.now_ns() / 1e9) < 600


def test_amplicon_cli_span_tree_and_counters(tmp_path):
    """`cli.amplicon` is the root; the steps under it, the variant stages
    under `step.call_variants`, with their counters: alignments and bases
    piled up, candidates, model rows (real and launched, per model) and
    batches, realigned calls and pairs."""
    from megapath_nano_tpu_torch.cli import amplicon as tamp
    from megapath_nano_tpu_torch.variant import pretrained

    rng = np.random.default_rng(21)
    ref = random_sequence(rng, 3000)
    donor = ref.copy()
    snvs = [1200, 1500]
    for p in snvs:
        donor[p] = (donor[p] + 1) % 4
    reads = [mutate(rng, donor[1000:1800], sub_rate=0.03, ins_rate=0.01,
                    del_rate=0.02) for _ in range(40)]
    reads = [revcomp(r) if i % 2 else r for i, r in enumerate(reads)]
    RefDB.build([ref], ["chr1"], [0], ["ref"], [(1, 1, 1)]).save(
        str(tmp_path / "db"))
    fq = tmp_path / "r.fastq"
    write_fastq(str(fq), [f"r{i}" for i in range(len(reads))], reads)
    rc = tamp.main(["--query", str(fq), "--target_db", str(tmp_path / "db"),
                    "--output_folder", str(tmp_path / "out"),
                    "--device", "cpu"])
    assert rc == 0
    root = [s for s in RECORD.spans() if s.name == "cli.amplicon"][-1]
    assert root.parent is None
    by = _by_name(RECORD.request(root.id)[:-1])
    ids = {s.id: s for v in by.values() for s in v}
    assert {"step.align_to_target", "step.call_variants", "variant.pileup",
            "variant.candidates", "variant.model",
            "variant.realign"} <= set(by)
    for name, parent in [("step.call_variants", "cli.amplicon"),
                         ("variant.candidates", "step.call_variants"),
                         ("variant.pileup", "variant.candidates"),
                         ("variant.model", "step.call_variants"),
                         ("variant.realign", "step.call_variants")]:
        for s in by[name]:
            par = ids.get(s.parent, root if s.parent == root.id else None)
            assert par is not None and par.name == parent, name
    (pile,) = by["variant.pileup"]
    assert pile.counts["pileup_alignments"] > 30
    assert pile.counts["pileup_bases"] > 30 * 700
    (cand,) = by["variant.candidates"]
    n = cand.counts["candidates"]
    models = len(pretrained.manifest()["models"])
    (model,) = by["variant.model"]
    assert n > 0 and model.counts["model_rows"] == n * models
    batches = -(-n // 256)
    assert model.counts["model_batches"] == batches * models
    assert model.counts["model_rows_launched"] == batches * 256 * models
    (re,) = by["variant.realign"]
    vcf = (tmp_path / "out" / "amplicon.vcf").read_text().splitlines()
    assert re.counts["realign_calls"] >= sum(
        1 for line in vcf if not line.startswith("#"))
    assert re.counts["realign_pairs"] >= 30 * re.counts["realign_calls"]
