"""The generators repeat by seed and keep the R9.4.1 profile's shape."""

import numpy as np
import torch

from core import sim, worlds
from tests import tiny


def _reads(seed, n=60, adapters=True):
    cfg, tr = tiny.profile_world()
    world = worlds.build(cfg, "cpu")
    rng, gen = sim.generators(seed, 2, "cpu")
    return world, worlds.simulate(world, tr, n, rng, gen,
                                  adapters=cfg["adapters"] if adapters
                                  else None, with_quals=True)


def test_worlds_repeat_by_db_seed():
    for make in (tiny.profile_world, tiny.map_world):
        cfg, _ = make()
        a, b = worlds.build(cfg, "cpu"), worlds.build(cfg, "cpu")
        assert torch.equal(a.flat, b.flat)
        assert a.names == b.names and a.tax == b.tax
        cfg["db_seed"] += 1
        c = worlds.build(cfg, "cpu")
        assert not torch.equal(a.flat[:1000], c.flat[:1000])


def test_reads_repeat_by_seed_large_seed():
    seed = 2 ** 31 + 977
    _, a = _reads(seed)
    _, b = _reads(seed)
    assert all(np.array_equal(x, y) for x, y in zip(a.reads, b.reads))
    assert all(np.array_equal(x, y) for x, y in zip(a.quals, b.quals))
    assert np.array_equal(a.genome, b.genome)
    _, c = _reads(seed + 1)
    assert not all(len(x) == len(y) for x, y in zip(a.reads, c.reads))


def test_relatives_world_shape():
    cfg, _ = tiny.profile_world()
    w = worlds.build(cfg, "cpu")
    k = cfg["world"]["relatives_per_species"] + 1
    assert len(w.names) == k * len(cfg["world"]["species"])
    # a relative is 9-13% from its genus ancestor: its sibling differs by
    # edits, and it is as long as the ancestor within the indel rate
    g = w.genomes_np()
    bp = cfg["world"]["species"][0]["genome_bp"]
    assert abs(len(g[0]) - bp) < 0.05 * bp
    assert set(w.read_sources) == set(range(0, len(w.names), k))


def test_strains_lift_coordinates():
    """Strains of one species differ by substitutions and indels; the lift
    carries a position of one onto the same ancestral base of the other."""
    cfg, _ = tiny.map_world()
    w = worlds.build(cfg, "cpu")
    g = w.genomes_np()
    assert len(w.names) == 3 and list(w.group) == [0, 0, 1]
    assert len(g[0]) != len(g[1])
    bp = cfg["world"]["genome_bp"]
    assert abs(len(g[0]) - bp) < 0.01 * bp
    # every lift_step-th ancestral base goes exactly to its place
    pos = w.lifts[0][4:-8:4]
    zeros, ones = np.zeros(len(pos), np.int64), np.ones(len(pos), np.int64)
    moved = w.lift(pos, zeros, ones)
    assert np.array_equal(moved, w.lifts[1][4:-8:4])
    # and a window there matches far above chance (0.25)
    same = np.mean([np.mean(g[0][p: p + 40] == g[1][q: q + 40])
                    for p, q in zip(pos, moved)])
    assert same > 0.8
    between = w.lift(pos + 100, zeros, ones)
    assert np.all(np.abs(between - moved - 100) <= 16)
    assert np.array_equal(w.lift(pos, np.zeros(len(pos), np.int64),
                                 np.full(len(pos), 2)), pos)


def test_read_lengths_and_error_rate():
    p = sim.Profile()
    rng = np.random.default_rng(1)
    ln = sim.draw_lengths(rng, p, 20000, 10 ** 9)
    assert p.min_length <= ln.min() and ln.max() <= p.max_length
    assert 4000 < np.median(ln) < 6000
    # errors keep a read's length within the indel rates (plus junk)
    gen = torch.Generator().manual_seed(3)
    tmpl = torch.randint(0, 4, (200000,), generator=gen, dtype=torch.int8)
    lens = np.full(100, 2000)
    out, out_lens = sim.apply_errors(rng, gen, tmpl, lens, p,
                                     np.ones(len(lens)))
    assert out.numel() == out_lens.sum()
    assert np.all(out_lens >= 0.8 * 2000)
    assert np.all(out_lens <= 1.2 * 2000 + 80)


def test_seeds_share_the_sizes():
    """Every seed draws the same read lengths and adapter counts, in
    another order: a seed changes which reads, not how much work."""
    _, a = _reads(1, n=80)
    _, b = _reads(2, n=80)
    la = sorted(e - s for s, e in zip(a.start, a.end))
    lb = sorted(e - s for s, e in zip(b.start, b.end))
    assert la == lb
    assert [len(x) for x in a.reads] != [len(x) for x in b.reads]


def test_adapters_planted_at_read_start():
    cfg, _ = tiny.profile_world()
    _, r = _reads(5, n=200)
    start = sim.encode(cfg["adapters"][0]["start"])
    # with junk of at most 40 bases and ONT errors, the start adapter's
    # first 8 bases appear in the first 60 bases of most reads (80% carry
    # one)
    hits = sum(start[:8].tobytes() in x[:80].tobytes() for x in r.reads)
    assert 0.2 * len(r.reads) < hits < 0.9 * len(r.reads)


def test_fastq_round_trip(tmp_path):
    _, r = _reads(9, n=5)
    names = [f"r{i}" for i in range(5)]
    path = tmp_path / "x.fastq"
    path.write_bytes(sim.fastq_bytes(names, r.reads, r.quals))
    n2, s2 = sim.read_fastq_plain(str(path))
    assert n2 == names
    assert all(np.array_equal(a, b) for a, b in zip(s2, r.reads))
