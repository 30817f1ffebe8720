"""Port parity for the variant path's host work at an amplicon run's depth:
the port's vectorised `stranded_pileup`, `extract_candidates`,
`candidate_tensor` and `realign_candidates` against the TPU package's
loops, exactly equal, on the same AlignList.

The world: two amplicons of 700 and 900 b on a 6 kb reference, ~300 reads
each on both strands (3/2/3% sub/ins/del), hom and het SNVs, one of them
80 b into an amplicon (inside the band realignment cannot reach), and a
deletion planted in the donor. The port maps it once; both packages' host
functions then read that one AlignList (they read `data` and `cigar_map`
only). Edge cases ride on it: a sequence length cut short so that
alignments run past its end, rows whose CIGAR is missing, a second row of
a read on the sequence, N bases, and CIGARs with S and = ops (which the
loops walk without moving).
"""

import copy

import numpy as np
import pytest
import torch

from megapath_nano_tpu.variant import candidates as jcand
from megapath_nano_tpu.variant import realign as jrealign
from megapath_nano_tpu_torch.db.refdb import RefDB
from megapath_nano_tpu_torch.taxon.profiler import TaxonProfiler
from megapath_nano_tpu_torch.utils.dna import (mutate, random_sequence,
                                               revcomp)
from megapath_nano_tpu_torch.variant import candidates as tcand
from megapath_nano_tpu_torch.variant import realign as trealign

AMPLICONS = [(400, 1100), (3000, 3900)]
HOM = [480, 800, 3400, 3700]
HET = [950, 3150]
DELETED = (3550, 3553)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def deep_world():
    rng = np.random.default_rng(15)
    ref = random_sequence(rng, 6000)
    donor = ref.copy()
    for p in HOM + HET:
        donor[p] = (donor[p] + 1 + rng.integers(0, 3)) % 4
    hom_only = donor.copy()
    for p in HET:
        hom_only[p] = ref[p]
    donor = np.delete(donor, np.arange(*DELETED))
    hom_only = np.delete(hom_only, np.arange(*DELETED))
    cut = DELETED[1] - DELETED[0]
    reads = []
    for lo, hi in AMPLICONS:
        dlo, dhi = (lo, hi) if hi <= DELETED[0] else (lo, hi - cut)
        for k in range(300):
            src = donor if k % 5 < 2 else hom_only      # het AF 0.4
            r = mutate(rng, src[dlo:dhi], sub_rate=0.03, ins_rate=0.02,
                       del_rate=0.03)
            reads.append(revcomp(r) if k % 2 else r)
    reads[7] = reads[7].copy()
    reads[7][100:110] = 4                             # N bases
    db = RefDB.build([ref], ["chr1"], [0], ["ref"], [(1, 1, 1)])
    best = TaxonProfiler(db, device="cpu").profile(reads).best
    assert len(best.data) > 550
    return ref, reads, best


def _edge_list(best):
    """The world's AlignList with missing CIGARs, a second row of one read,
    and S / = ops in two CIGARs."""
    al = copy.copy(best)
    al.cigar_map = dict(best.cigar_map)
    rids = best.data["read_id"]
    for rid in rids[:5]:
        del al.cigar_map[(int(rid), 0)]
    cig, qf, strand = al.cigar_map[(int(rids[10]), 0)]
    al.cigar_map[(int(rids[10]), 0)] = ([(3, "S")] + list(cig), qf, strand)
    cig, qf, strand = al.cigar_map[(int(rids[11]), 0)]
    al.cigar_map[(int(rids[11]), 0)] = (list(cig[:1]) + [(0, "M"), (2, "=")]
                                        + list(cig[1:]), qf, strand)
    extra = best.data[20:21].copy()
    extra["sequence_from"] += 40
    extra["sequence_to"] += 40
    al.data = np.concatenate([best.data, extra])
    return al


def _cases(deep_world):
    ref, reads, best = deep_world
    return {"mapped": (best, ref), "edges": (_edge_list(best), ref),
            "past_end": (best, ref[:3500])}


@pytest.mark.parametrize("case", ["mapped", "edges", "past_end"])
def test_pileup_candidates_tensors_exact(deep_world, case):
    _, reads, _ = deep_world
    al, ref = _cases(deep_world)[case]
    jp = jcand.stranded_pileup(al, reads, 0, len(ref))
    tp = tcand.stranded_pileup(al, reads, 0, len(ref))
    assert jp.dtype == tp.dtype and jp.shape == tp.shape
    assert np.array_equal(jp, tp)
    assert tp[5].sum(axis=1).max() >= 250
    jc = jcand.extract_candidates(al, reads, 0, ref, min_af=0.125,
                                  min_depth=4)
    tc = tcand.extract_candidates(al, reads, 0, ref, min_af=0.125,
                                  min_depth=4)
    assert [(c.position, c.ref_base, c.depth, c.alt_fraction) for c in jc] \
        == [(c.position, c.ref_base, c.depth, c.alt_fraction) for c in tc]
    for a, b in zip(jc, tc):
        assert np.array_equal(a.context, b.context)
        assert np.array_equal(jcand.candidate_tensor(a, ref),
                              tcand.candidate_tensor(b, ref))
    for p in HOM + HET:
        if p < len(ref):
            assert any(c.position == p for c in tc), p


@pytest.mark.parametrize("case", ["mapped", "edges"])
def test_realignment_counts_exact(deep_world, case):
    _, reads, _ = deep_world
    al, ref = _cases(deep_world)[case]
    # planted SNVs (one 80 b into its amplicon), a deletion, clean
    # positions, an amplicon's first bases and an uncovered position
    positions = HOM + HET + [DELETED[0] + 1, 600, 3300, AMPLICONS[0][0] + 3,
                             2000]
    jr = jrealign.realign_candidates(al, reads, 0, ref, positions)
    tr = trealign.realign_candidates(al, reads, 0, ref, positions)
    assert len(jr) == len(tr) == len(positions)
    for a, b in zip(jr, tr):
        assert (a.position, a.depth, a.ref_support, a.alt_support) == \
            (b.position, b.depth, b.ref_support, b.alt_support)
        assert np.array_equal(a.base_counts, b.base_counts)
    by_pos = {r.position: r for r in tr}
    assert by_pos[2000].depth == 0
    assert by_pos[HOM[2]].depth > 200


def test_offsets_match_the_cigar_walk(deep_world):
    """`offsets_at` on run arrays gives what the loops' CIGAR walk gives at
    every position of a few alignments, M, I and D runs alike."""
    _, _, best = deep_world
    al = _edge_list(best)
    rows = al.data[:40]
    entries = [al.cigar_map.get((int(r), 0)) for r in rows["read_id"]]
    keep = [i for i, e in enumerate(entries) if e is not None]
    runs = tcand.cigar_runs([entries[i][0] for i in keep],
                            [entries[i][1] for i in keep],
                            rows["sequence_from"][keep])
    for pos in range(350, 1200, 7):
        got = tcand.offsets_at(runs, np.arange(len(keep)), pos)
        for j, i in enumerate(keep):
            cig, qf, _ = entries[i]
            want = jrealign._read_offset_at(cig, qf,
                                            int(rows["sequence_from"][i]),
                                            pos)
            assert (None if got[j] == tcand.NOT_COVERED else got[j]) == want
