"""The host path's window table (`pipeline._window_table`) and its query
buffer (`pipeline._oriented_reads`) against the per-window loop they
replaced, copied below as the oracle, on random chain outputs: both
strands, windows clamped at read and sequence ends, chain-score ties, a
band whose diagonal back-shift is not zero, and a top-K cut. The
arithmetic is the same integer arithmetic, so the columns must be equal."""

import numpy as np
import pytest

from megapath_nano_tpu_torch.align import pipeline as tp
from megapath_nano_tpu_torch.align.anchors import AnchorGroups
from megapath_nano_tpu_torch.utils.dna import revcomp

K = 15


def _loop_windows(groups, stacked, t_base, reads, seq_offsets, seq_lens, k,
                  p):
    """The top-K cut and the per-window loop of the host path as they were
    written before the window table (one dict a window)."""
    best = stacked[0].astype(np.int64)
    q_min, q_max_, t_min, t_max_ = stacked[1:5]
    keep = best >= p.min_chain_score
    g_ids = np.flatnonzero(keep)
    if len(g_ids) == 0:
        return [], [], []

    order = np.lexsort((-best[g_ids], groups.group_read[g_ids]))
    g_sorted = g_ids[order]
    rids = groups.group_read[g_sorted]
    rank = np.zeros(len(g_sorted), np.int64)
    same = np.flatnonzero(np.append(False, rids[1:] == rids[:-1]))
    for s in same:  # cumulative rank within read runs
        rank[s] = rank[s - 1] + 1
    g_final = g_sorted[rank < p.max_alignments_per_read]

    recs = []
    ext_starts, ext_wlens = [], []
    for g in g_final:
        rid = int(groups.group_read[g])
        seq_id = int(groups.group_seq[g])
        strand = int(groups.group_strand[g])
        qlen = len(reads[rid])
        q_lo = int(q_min[g]) - (k - 1)
        q_hi = int(q_max_[g]) + 1
        t_lo = int(t_min[g]) + int(t_base[g]) - (k - 1)
        t_hi = int(t_max_[g]) + int(t_base[g]) + 1
        wband = p.band if p.band is not None else 0
        wpad = p.window_pad
        dshift = min(wband // 8, 64) if wband > 128 else 0
        seq_off = int(seq_offsets[seq_id])
        seq_len = int(seq_lens[seq_id])
        left = min(q_lo, t_lo) + wpad
        right = min(qlen - q_hi, seq_len - t_hi) + wpad
        qs = max(q_lo - left, 0)
        qe = min(q_hi + right, qlen)
        w_lo = max(t_lo - (q_lo - qs) - dshift, 0)
        w_hi = min(t_hi + (qe - q_hi) + dshift, seq_len)
        recs.append(dict(
            rid=rid, seq_id=seq_id, strand=strand, qlen=qlen,
            w_lo=w_lo, w_hi=w_hi, qs=qs, qe=qe,
            chain_score=int(best[g]),
            cq_lo=max(q_lo, 0), cq_hi=min(q_hi, qlen),
            ct_lo=max(t_lo, 0), ct_hi=min(t_hi, seq_len)))
        ext_starts.append(seq_off + w_lo)
        ext_wlens.append(w_hi - w_lo)
    ext_reads = [(reads[r["rid"]] if r["strand"] == 0
                  else revcomp(reads[r["rid"]]))[r["qs"]: r["qe"]]
                 for r in recs]
    return recs, list(zip(ext_starts, ext_wlens)), ext_reads


def _chain_world(seed, n_reads=40, n_seqs=5, n_groups=600):
    """Random groups and chain outputs in the kernel's layout. Scores
    from a narrow range (ties), chains that run to the ends of short
    sequences and of the reads, both strands."""
    rng = np.random.default_rng(seed)
    reads = [rng.integers(0, 5, int(n), dtype=np.int8)
             for n in rng.integers(60, 2500, n_reads)]
    qlens = np.array([len(r) for r in reads])
    seq_lens = rng.integers(300, 4000, n_seqs)
    seq_offsets = np.concatenate([[0], np.cumsum(seq_lens)])
    rid = rng.integers(0, n_reads, n_groups)
    sid = rng.integers(0, n_seqs, n_groups)
    q_min = rng.integers(K - 1, qlens[rid])
    q_max = rng.integers(q_min, qlens[rid])
    t_lo_abs = rng.integers(K - 1, seq_lens[sid])
    t_hi_abs = rng.integers(t_lo_abs, seq_lens[sid])
    t_base = rng.integers(0, t_lo_abs + 1).astype(np.int64)
    stacked = np.stack([rng.integers(0, 90, n_groups), q_min, q_max,
                        t_lo_abs - t_base, t_hi_abs - t_base]).astype(np.int32)
    groups = AnchorGroups(
        q_end=np.zeros(0, np.int32), t_end=np.zeros(0, np.int64),
        group_offsets=np.zeros(n_groups + 1, np.int64),
        group_read=rid.astype(np.int32), group_seq=sid.astype(np.int32),
        group_strand=rng.integers(0, 2, n_groups).astype(np.int8))
    return groups, stacked, t_base, reads, seq_offsets, seq_lens


@pytest.mark.parametrize("band", [None, 256, 1024])
@pytest.mark.parametrize("max_per_read", [2, 50])
def test_window_table_equals_the_loop(band, max_per_read):
    p = tp.AlignParams(band=band, max_alignments_per_read=max_per_read)
    for seed in range(4):
        groups, stacked, t_base, reads, offs, lens = _chain_world(seed)
        recs, ext, ext_reads = _loop_windows(groups, stacked, t_base, reads,
                                             offs, lens, K, p)
        qlens = np.array([len(r) for r in reads])
        win = tp._window_table(groups, stacked, t_base, qlens, offs, lens,
                               k=K, p=p)
        assert len(win) == len(recs) > 0
        for col in ("rid", "seq_id", "strand", "qlen", "qs", "qe", "w_lo",
                    "cq_lo", "cq_hi", "ct_lo", "ct_hi"):
            got = getattr(win, col)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, [r[col] for r in recs],
                                          err_msg=col)
        np.testing.assert_array_equal(win.t_start, [s for s, _ in ext])
        np.testing.assert_array_equal(win.t_len, [n for _, n in ext])
        qbuf, q0 = tp._oriented_reads(reads, qlens, win)
        for a, n, want in zip(q0, win.q_len, ext_reads):
            np.testing.assert_array_equal(qbuf[a: a + n], want)

        # the world reaches what the algebra clamps, and the cut
        w_hi = win.w_lo + win.t_len
        assert (win.qs == 0).any() and (win.qs > 0).any()
        assert (win.w_lo == 0).any() and (w_hi == lens[win.seq_id]).any()
        assert (win.qe == win.qlen).any() and set(win.strand) == {0, 1}
        n_top = np.bincount(win.rid).max()
        assert n_top == max_per_read if max_per_read == 2 else n_top > 2


def test_window_table_none_reach_min_chain_score():
    groups, stacked, t_base, reads, offs, lens = _chain_world(9)
    p = tp.AlignParams(min_chain_score=1000)
    win = tp._window_table(groups, stacked, t_base,
                           np.array([len(r) for r in reads]), offs, lens,
                           k=K, p=p)
    assert len(win) == 0
    assert _loop_windows(groups, stacked, t_base, reads, offs, lens, K,
                         p)[0] == []
