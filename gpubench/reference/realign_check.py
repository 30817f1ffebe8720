"""Plain recount of the local realignment around each call: the benchmark's
reference for `realign_candidates` and the VCF it filters.

The realignment's semantics, as `variant/realign.py` documents them, for
a call at position pos (0-based) of a sequence:

- the covering reads: the alignment rows on the sequence with
  sequence_from <= pos < sequence_to whose CIGAR (the cigar_map entry
  (ops, oriented_from, strand) of (read_id, sequence_id)) has an M or D
  run at pos, walked from (oriented_from, sequence_from): M moves the read
  and the reference, I the read, D the reference, any other op neither.
  The read's oriented offset there is c (inside an M run) or the read
  position the deletion lies before (inside a D run);
- each covering read's window: its oriented bases [c - 200, c + 201),
  cut to the read; the reference window [pos - 300, pos + 301), cut to
  the sequence;
- the realignment: a best local alignment of the two windows with affine
  gaps (match 4, mismatch 6, gap open 8, gap extend 2, a gap of L costing
  open + (L - 1) * extend; an N scores 0 against anything), inside the
  band the native aligner documents: at read row i only reference columns
  j with -band/2 <= j - i < band/2 (band 256);
- the support: each realigned read with a positive score adds the base
  its alignment puts at the call's column (A/C/G/T; an N adds nothing) or
  a deletion; depth is their sum, the ref support the reference base's
  count, the alt support depth less it;
- the CLI keeps a call whose depth is positive and whose alt support over
  depth is at least the AF threshold, and writes DP = depth and AF = that
  share to 3 decimals (one-base REFs never overlap, so the overlap filter
  keeps every call).

Where several alignments reach the best score, any one of them is right:
the check walks the program's own alignment of each pair, holds its score
to the walk and to the best score the band allows (computed here), and
recounts the support from those walks, so a tie broken another way is
never counted wrong. Written from the semantics alone; it shares no code
with the program it judges.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from reference.variant_check import _oriented

READ_WINDOW = 200
REF_WINDOW = 300
BAND = 256
SCORES = {"match": 4, "mismatch": 6, "gap_open": 8, "gap_extend": 2}
PAD = -1
NEG = -(2 ** 28)


def offset_at(cigar, q: int, t: int, pos: int):
    """The oriented-read offset of a CIGAR walked from (q, t) at reference
    position pos: >= 0 in an M run, -(offset + 1) in a D run, None where
    no M or D run holds pos."""
    for n, op in cigar:
        if op == "M":
            if t <= pos < t + n:
                return q + pos - t
            q += n
            t += n
        elif op == "I":
            q += n
        elif op == "D":
            if t <= pos < t + n:
                return -(q + 1)
            t += n
    return None


def windows(rows, cigar_map: dict, reads: list, sequence_id: int, pos: int,
            seq_len: int) -> tuple[int, list[np.ndarray]]:
    """(the reference window's start, the covering reads' windows in row
    order) of a call at pos."""
    out = []
    cover = np.flatnonzero((rows["sequence_from"] <= pos)
                           & (pos < rows["sequence_to"]))
    for i in cover.tolist():
        rid = int(rows["read_id"][i])
        entry = cigar_map.get((rid, sequence_id))
        if entry is None:
            continue
        ops, q, strand = entry
        off = offset_at(ops, q, int(rows["sequence_from"][i]), pos)
        if off is None:
            continue
        read = _oriented(reads[rid], int(strand))
        c = off if off >= 0 else -off - 1
        out.append(read[max(c - READ_WINDOW, 0): min(c + READ_WINDOW + 1,
                                                     len(read))])
    return max(pos - REF_WINDOW, 0), out


def window_mismatch(have: list, want: list) -> int:
    """Windows in one list and not the other, as multisets of bases."""
    a = Counter(np.asarray(w, np.int8).tobytes() for w in have)
    b = Counter(np.asarray(w, np.int8).tobytes() for w in want)
    return sum(((a - b) + (b - a)).values())


def banded_best(queries: list[np.ndarray], target: np.ndarray, device, *,
                band: int = BAND, match: int, mismatch: int, gap_open: int,
                gap_extend: int) -> np.ndarray:
    """(B,) the best local score of each query against the target, cells
    with -band/2 <= j - i < band/2 only. One query row at a time over the
    whole target row, as `reference.sw.local_affine`, with the cells off
    the band held at H = 0 and no gap passing through them."""
    b, lt = len(queries), len(target)
    if b == 0 or lt == 0:
        return np.zeros(b, np.int64)
    lq = max(len(x) for x in queries)
    qm = np.full((b, max(lq, 1)), PAD, np.int8)
    for k, x in enumerate(queries):
        qm[k, :len(x)] = x
    query = torch.as_tensor(qm, device=device)
    t = torch.as_tensor(np.asarray(target, np.int8), device=device
                        ).to(torch.int32)[None, :]
    half = band // 2
    col = torch.arange(1, lt + 1, device=device, dtype=torch.int32)[None, :]
    k = torch.arange(lt + 1, device=device, dtype=torch.int32)[None, :]
    ramp = k * gap_extend
    h = torch.zeros((b, lt + 1), dtype=torch.int32, device=device)
    f = torch.full((b, lt + 1), NEG, dtype=torch.int32, device=device)
    best = torch.zeros(b, dtype=torch.int32, device=device)
    zero_col = torch.zeros((b, 1), dtype=torch.int32, device=device)
    for i in range(1, lq + 1):
        q = query[:, i - 1].to(torch.int32)[:, None]
        off = (col - i < -half) | (col - i >= half)
        sub = torch.where(t == q, match, -mismatch)
        sub = torch.where((t >= 4) | (q >= 4), 0, sub)
        sub = torch.where(q == PAD, NEG, sub)
        diag = h[:, :-1] + sub
        f = torch.maximum(h - gap_open, f - gap_extend)
        f[:, 1:] = torch.where(off, NEG, f[:, 1:])
        h0 = torch.clamp_min(torch.maximum(
            torch.cat([zero_col, diag], 1), f), 0)
        h0[:, 0] = 0
        h0[:, 1:] = torch.where(off, 0, h0[:, 1:])
        run = torch.cummax(h0 + ramp, 1).values
        e = run[:, :-1] - gap_open - ramp[:, :-1]
        h = torch.cat([zero_col, torch.where(off, 0, torch.maximum(
            h0[:, 1:], e))], 1)
        best = torch.maximum(best, h[:, 1:].max(1).values)
    return best.cpu().numpy().astype(np.int64)


def walk(cigar, read_begin: int, ref_begin: int, query: np.ndarray,
         target: np.ndarray, column: int, *, match: int, mismatch: int,
         gap_open: int, gap_extend: int):
    """(the score of an alignment given by its CIGAR from (read_begin,
    ref_begin), what it puts at the target column: a query offset >= 0, -1
    for a deletion, None where it does not span it). The score is None
    where the CIGAR runs off either sequence or holds another op."""
    i, j, score, at = int(read_begin), int(ref_begin), 0, None
    for n, op in cigar:
        n = int(n)
        if op == "M":
            a, b = query[i: i + n], target[j: j + n]
            if i < 0 or j < 0 or len(a) != n or len(b) != n:
                return None, at
            a, b = a.astype(np.int64), b.astype(np.int64)
            sub = np.where(a == b, match, -mismatch)
            score += int(np.where((a >= 4) | (b >= 4), 0, sub).sum())
            if j <= column < j + n:
                at = i + column - j
            i += n
            j += n
        elif op in ("I", "D"):
            score -= gap_open + (n - 1) * gap_extend
            if op == "I":
                i += n
            else:
                if j <= column < j + n:
                    at = -1
                j += n
            if i > len(query) or j > len(target):
                return None, at
        else:
            return None, at
    return score, at


def recount(pairs, target: np.ndarray, column: int, scores: dict
            ) -> tuple[np.ndarray, int]:
    """(the (5,) A/C/G/T/del support of realigned pairs [(window, score,
    cigar, read_begin, ref_begin)], the pairs whose CIGAR does not walk to
    their score)."""
    counts = np.zeros(5, np.int64)
    bad = 0
    for window, score, cigar, rb, tb in pairs:
        if score <= 0:
            continue
        s, at = walk(cigar, rb, tb, window, target, column, **scores)
        if s != score:
            bad += 1
            continue
        if at is None:
            continue
        if at < 0:
            counts[4] += 1
        elif window[at] < 4:
            counts[int(window[at])] += 1
    return counts, bad


def kept(counts: np.ndarray, ref_base: int, af: float):
    """(depth, AF to 3 decimals) of a call the CLI keeps, or None."""
    depth = int(counts.sum())
    if depth == 0:
        return None
    ref_sup = int(counts[ref_base]) if 0 <= ref_base < 4 else 0
    frac = (depth - ref_sup) / depth
    return (depth, f"{frac:.3f}") if frac >= af else None
