"""Reference judgement of a map call's answers.

The configuration states what a map answers for each read: its primary
alignment (the highest score) on the genome and at the place the read came
from, and a score that is the local affine-gap score of the read against
that place. Three numbers:

- `misplaced_pct`: of all reads, the share whose primary alignment is
  missing, or lies on another species, or does not overlap the read's
  source interval (carried by the world's lift onto the strain the read
  was placed on, where that is another strain of its species);
- `score_over`: of a sample of primary alignments, how many report a score
  above the best local score of the whole read against the target region
  around the alignment (no alignment there scores more: exact, limit 0);
- `score_short_pct`: over the same sample, how far the reported scores
  fall short of those best scores, as a share of their sum. A mapper that
  stops an alignment early (a narrow band, a cut extension) reads high.

The best scores come from `reference.sw` on the whole read against the
alignment's target span, widened by the read's unaligned flanks and a pad.
"""

from __future__ import annotations

import numpy as np

from core import sim
from reference.sw import local_affine, pad_batch


def primary_rows(data: np.ndarray, n_reads: int) -> np.ndarray:
    """Index of each read's highest-scoring row (first on ties), -1 where
    the read has none."""
    out = np.full(n_reads, -1, np.int64)
    if len(data) == 0:
        return out
    order = np.lexsort((np.arange(len(data)), -data["alignment_score"],
                        data["read_id"]))
    rid = data["read_id"][order]
    first = np.ones(len(order), bool)
    first[1:] = rid[1:] != rid[:-1]
    out[rid[first]] = order[first]
    return out


def misplaced(data, prim, truth_species, truth_start, truth_end,
              seq_species) -> np.ndarray:
    """Per read, True where the primary alignment is not at its source."""
    bad = prim < 0
    rows = data[np.maximum(prim, 0)]
    sid = rows["sequence_id"].astype(np.int64)
    on_species = seq_species[np.minimum(sid, len(seq_species) - 1)] \
        == truth_species
    overlap = (rows["sequence_from"] < truth_end) & \
        (rows["sequence_to"] > truth_start)
    return bad | ~on_species | ~overlap


def regions(rows, reads, seq_offsets, pad_base=64, pad_frac=0.1):
    """(oriented read, target start, target end) per row: the span the
    whole read can align to."""
    out = []
    for r in rows:
        read = reads[int(r["read_id"])]
        L = len(read)
        strand = int(r["strand"])
        o = sim.revcomp_np(read) if strand else read
        qf, qt = int(r["read_from"]), int(r["read_to"])
        if strand:
            qf, qt = L - qt, L - qf
        pad = pad_base + int(pad_frac * L)
        sid = int(r["sequence_id"])
        glen = int(seq_offsets[sid + 1] - seq_offsets[sid])
        t0 = max(int(r["sequence_from"]) - qf - pad, 0)
        t1 = min(int(r["sequence_to"]) + (L - qt) + pad, glen)
        out.append((o, sid, t0, t1))
    return out


def best_scores(rows, reads, genome_flat, seq_offsets, params, device,
                batch: int = 64) -> np.ndarray:
    """The reference's best local score of each row's read in its region."""
    spans = regions(rows, reads, seq_offsets)
    order = np.argsort([len(s[0]) for s in spans], kind="stable")
    best = np.zeros(len(spans), np.int64)
    kw = dict(match=params["match"], mismatch=params["mismatch"],
              gap_open=params["gap_open"], gap_extend=params["gap_extend"])
    for b0 in range(0, len(order), batch):
        idx = order[b0: b0 + batch]
        qs = [spans[i][0] for i in idx]
        ts = []
        for i in idx:
            _, sid, t0, t1 = spans[i]
            base = int(seq_offsets[sid])
            ts.append(genome_flat[base + t0: base + t1])
        sc, _ = local_affine(pad_batch(qs, device), pad_batch(ts, device),
                             **kw)
        best[idx] = sc.cpu().numpy()
    return best


def score_numbers(reported: np.ndarray, best: np.ndarray) -> tuple:
    over = int(np.count_nonzero(reported > best))
    total = float(best.sum())
    short = 100.0 * float(np.maximum(best - reported, 0).sum()) / total \
        if total > 0 else 0.0
    return over, short


def sample_reads(rng: np.random.Generator, lengths: np.ndarray,
                 candidates: np.ndarray, k: int) -> np.ndarray:
    """k candidates drawn from the seed, the longest always among them."""
    if len(candidates) <= k:
        return np.sort(candidates)
    longest = candidates[np.argmax(lengths[candidates])]
    rest = rng.choice(candidates[candidates != longest], size=k - 1,
                      replace=False)
    return np.sort(np.concatenate([[longest], rest]))
