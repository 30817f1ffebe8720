"""Interval algebra — vectorized replacement for the reference's bedtools use.

The reference leans on pybedtools/bedtools subprocesses for every noise and
depth computation (reference: bin/megapath_nano.py:417 align_list_to_depth_bed
via `genomecov -bg`, :340 align_list_to_bed via `sort | merge`, :666
select_alignment_by_bed via `intersect -wo` with 50% overlap). Here a BED is a
numpy structured array keyed by (assembly_id, sequence_id); all operations are
sort/sweep based with no subprocess round-trips, and semantics are
property-tested against brute-force coverage arrays.

The port's own copy of megapath_nano_tpu/taxon/intervals.py.
"""

from __future__ import annotations

import numpy as np

BED_DTYPE = np.dtype([
    ("assembly_id", np.int32),
    ("sequence_id", np.int32),
    ("start", np.int64),
    ("end", np.int64),
])


def make_bed(assembly_id, sequence_id, start, end) -> np.ndarray:
    bed = np.zeros(len(start), BED_DTYPE)
    bed["assembly_id"] = assembly_id
    bed["sequence_id"] = sequence_id
    bed["start"] = start
    bed["end"] = end
    return bed[bed["end"] > bed["start"]]


def _key(bed: np.ndarray) -> np.ndarray:
    return (bed["assembly_id"].astype(np.int64) << np.int64(32)) \
        | bed["sequence_id"].astype(np.int64)


def sort_bed(bed: np.ndarray) -> np.ndarray:
    order = np.lexsort((bed["start"], bed["sequence_id"], bed["assembly_id"]))
    return bed[order]


def merge_bed(bed: np.ndarray) -> np.ndarray:
    """Union of intervals per (assembly, sequence) — bedtools merge."""
    if len(bed) == 0:
        return bed.copy()
    bed = sort_bed(bed)
    key = _key(bed)
    starts, ends = bed["start"], bed["end"]
    # segmented (per-key) running max of interval ends: add a per-segment
    # offset larger than any coordinate so accumulate-max can't cross keys
    new_key = np.append(True, key[1:] != key[:-1])
    seg_id = np.cumsum(new_key) - 1
    big = np.int64(int(ends.max()) + 1)
    run_max = np.maximum.accumulate(ends + seg_id * big) - seg_id * big
    # an interval starts a new merged block if start > max(end of previous)
    prev_max = np.empty_like(run_max)
    prev_max[0] = -(2 ** 62)
    prev_max[1:] = run_max[:-1]
    prev_max[new_key] = -(2 ** 62)
    block_start = new_key | (starts > prev_max)
    block_id = np.cumsum(block_start) - 1
    n_blocks = block_id[-1] + 1
    out = np.zeros(n_blocks, BED_DTYPE)
    first = np.flatnonzero(block_start)
    out["assembly_id"] = bed["assembly_id"][first]
    out["sequence_id"] = bed["sequence_id"][first]
    out["start"] = starts[first]
    np.maximum.at(out["end"], block_id, ends)
    return out


def covered_bp_by_assembly(bed: np.ndarray) -> dict[int, int]:
    """Total covered bp per assembly (input may overlap; merged internally)."""
    merged = merge_bed(bed)
    out: dict[int, int] = {}
    lens = merged["end"] - merged["start"]
    for aid in np.unique(merged["assembly_id"]):
        out[int(aid)] = int(lens[merged["assembly_id"] == aid].sum())
    return out


def depth_segments(bed: np.ndarray) -> np.ndarray:
    """Per-base depth segments — bedtools genomecov -bg equivalent.

    Returns a structured array with fields of BED_DTYPE plus 'depth'
    (only segments with depth >= 1)."""
    out_dtype = np.dtype(BED_DTYPE.descr + [("depth", np.int64)])
    if len(bed) == 0:
        return np.zeros(0, out_dtype)
    key = _key(bed)
    # events: (key, pos, delta)
    pos = np.concatenate([bed["start"], bed["end"]])
    delta = np.concatenate([np.ones(len(bed), np.int64),
                            -np.ones(len(bed), np.int64)])
    kk = np.concatenate([key, key])
    order = np.lexsort((-delta, pos, kk))  # starts before ends at same pos
    kk, pos, delta = kk[order], pos[order], delta[order]
    depth = np.cumsum(delta)
    # depth within each key = global cumsum minus the cumsum just before the
    # key starts (each key's deltas sum to zero, so this is exact)
    new_key = np.append(True, kk[1:] != kk[:-1])
    key_start_idx = np.flatnonzero(new_key)
    cum_before_key = np.where(key_start_idx > 0,
                              depth[np.maximum(key_start_idx - 1, 0)], 0)
    key_id = np.cumsum(new_key) - 1
    depth = depth - cum_before_key[key_id]
    # segments between consecutive events of the same key
    seg_start = pos
    seg_end = np.empty_like(pos)
    seg_end[:-1] = pos[1:]
    seg_end[-1] = pos[-1]
    last_of_key = np.append(kk[1:] != kk[:-1], True)
    valid = (~last_of_key) & (seg_end > seg_start) & (depth > 0)
    out = np.zeros(int(valid.sum()), out_dtype)
    out["assembly_id"] = (kk[valid] >> np.int64(32)).astype(np.int32)
    out["sequence_id"] = (kk[valid] & np.int64(0xFFFFFFFF)).astype(np.int32)
    out["start"] = seg_start[valid]
    out["end"] = seg_end[valid]
    out["depth"] = depth[valid]
    return out


def overlap_bp(query: np.ndarray, bed: np.ndarray) -> np.ndarray:
    """For each query interval, bp overlapped by (merged) bed — vectorized.

    Semantics of bedtools intersect -wo aggregated per query interval, as
    used by select_alignment_by_bed (megapath_nano.py:666-717)."""
    if len(query) == 0:
        return np.zeros(0, np.int64)
    if len(bed) == 0:
        return np.zeros(len(query), np.int64)
    merged = merge_bed(bed)
    mkey = _key(merged)
    qkey = _key(query)
    out = np.zeros(len(query), np.int64)
    # process per key present in both
    for key in np.intersect1d(np.unique(mkey), np.unique(qkey)):
        m = merged[mkey == key]
        qi = np.flatnonzero(qkey == key)
        starts, ends = m["start"], m["end"]
        cum = np.concatenate([[0], np.cumsum(ends - starts)])

        def covered_until(x):
            """covered bp in (-inf, x)."""
            i = np.searchsorted(starts, x, side="right")
            partial = np.clip(x - starts[np.maximum(i - 1, 0)], 0,
                              (ends - starts)[np.maximum(i - 1, 0)])
            partial = np.where(i > 0, partial, 0)
            return cum[np.maximum(i - 1, 0)] + partial

        qs = query["start"][qi]
        qe = query["end"][qi]
        out[qi] = covered_until(qe) - covered_until(qs)
    return out


def subtract_bed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a minus b (bedtools subtract): parts of a's intervals not covered by b."""
    if len(a) == 0 or len(b) == 0:
        return a.copy()
    a = merge_bed(a)
    b = merge_bed(b)
    akey, bkey = _key(a), _key(b)
    pieces = []
    b_by_key = {int(k): b[bkey == k] for k in np.unique(bkey)}
    for i in range(len(a)):
        key = int(akey[i])
        s, e = int(a["start"][i]), int(a["end"][i])
        bb = b_by_key.get(key)
        if bb is None:
            pieces.append((a["assembly_id"][i], a["sequence_id"][i], s, e))
            continue
        lo = np.searchsorted(bb["end"], s, side="right")
        cur = s
        for j in range(lo, len(bb)):
            bs, be = int(bb["start"][j]), int(bb["end"][j])
            if bs >= e:
                break
            if bs > cur:
                pieces.append((a["assembly_id"][i], a["sequence_id"][i], cur,
                               min(bs, e)))
            cur = max(cur, be)
            if cur >= e:
                break
        if cur < e:
            pieces.append((a["assembly_id"][i], a["sequence_id"][i], cur, e))
    out = np.zeros(len(pieces), BED_DTYPE)
    for f, vals in zip(BED_DTYPE.names, zip(*pieces) if pieces else ([],) * 4):
        out[f] = vals
    return out


def intersect_bed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of two (merged) beds."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros(0, BED_DTYPE)
    return subtract_bed(a, subtract_bed(a, b))


def align_list_to_bed(align_data: np.ndarray) -> np.ndarray:
    """Alignment spans as a merged bed (align_list_to_bed, ref :340-357)."""
    return merge_bed(make_bed(align_data["assembly_id"],
                              align_data["sequence_id"],
                              align_data["sequence_from"],
                              align_data["sequence_to"]))
