"""Device seed stage as torch ops: sketch -> lookup -> anchors -> groups.

Port of megapath_nano_tpu.align.device_seed (`hash32`, `sketch_winners`,
`_bounded_lower_bound`, `build_groups_device`, and `sketch_device` and
`_blocked_cummax`, which no map path calls), bit-equal to it. The seeding
is minimap2's minimizer scheme with the Wang hash of cpp/mpn_minimizer.cc,
the same window and tie rules, max_occ masking, gap-break grouping and
per-group even subsample as the host path (align/anchors.py).

Every stage has a static shape (caps passed as ints), so a slice runs with
no host synchronisation. Each cap truncates a suffix of read ids, and the
counts row carries the smallest affected read id, so the host re-runs only
those reads through the exact host-seeded path.

Translation notes:
- uint32 hashes are held in int64 with explicit 32-bit masks; the
  0xFFFFFFFF "no hash" value becomes -1 when viewed as int32, as in the
  reference's `astype(int32)`.
- A JAX scatter with mode="drop" becomes a scatter into one extra dump slot
  that is sliced off; every gather index is clipped where the reference
  clips it (all of them, here).
- The three-key lax.sort becomes three stable argsorts (least significant
  key first), a true lexicographic sort; equal triples are identical.
"""

from __future__ import annotations

import torch

I32_MAX = 2 ** 31 - 1
# "no read affected" sentinel for the min-affected-rid overflow channel
NO_RID = 1 << 29
_U32 = 0xFFFFFFFF


def hash32(key: torch.Tensor, kbits: int) -> torch.Tensor:
    """Thomas Wang 64-bit invertible hash masked to kbits <= 30, on int64
    tensors holding uint32 values. Equal to the reference's uint32 hash32
    on the low kbits (every masked step only needs low bits of its sums)."""
    mask = (1 << kbits) - 1
    key = key.to(torch.int64) & _U32
    key = ((_U32 - key) + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def _shift_row(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """Row-local right shift along axis 1: out[:, i] = x[:, i-s]."""
    if not s:
        return x
    s = min(s, x.shape[1])
    return torch.cat([torch.full_like(x[:, :s], fill),
                      x[:, :x.shape[1] - s]], dim=1)


def sketch_winners(codes: torch.Tensor, qlens: torch.Tensor, *, k: int,
                   w: int):
    """(k,w) minimizer winners of every read in an (n, L) code matrix, in
    position space. Returns (neww bool, Hm int64, Pm int32, H int64), all
    (n, L): the first emitting window of each new winner, the winner's hash
    (uint32 value, 0xFFFFFFFF for none), the winner packed as
    pos << 1 | strand, and every position's own canonical k-mer hash."""
    if not 1 <= k <= 15:
        raise ValueError(f"device sketch requires k <= 15; got k={k}")
    n, L = codes.shape
    dev = codes.device
    pos_i = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    inread = pos_i < qlens[:, None]
    good = (codes >= 0) & (codes < 4) & inread
    c = torch.where(good, codes.to(torch.int64), 0)

    kf = torch.zeros((n, L), dtype=torch.int64, device=dev)
    kr = torch.zeros((n, L), dtype=torch.int64, device=dev)
    for d in range(k):   # k-mer ending at i uses bases i-k+1..i
        shifted = _shift_row(c, d, 0)
        kf = kf | (shifted << (2 * d))
        kr = kr | ((3 - shifted) << (2 * (k - 1 - d)))

    cs = torch.cumsum(good.to(torch.int32), dim=1, dtype=torch.int32)
    cs_lag = _shift_row(cs, k, 0)
    validk = (cs - cs_lag == k) & (pos_i >= k - 1)

    tie = kf == kr
    strand = (kr < kf).to(torch.int32)
    canon = torch.minimum(kf, kr)
    H = torch.where(validk & ~tie, hash32(canon, 2 * k), _U32)
    packed = (pos_i << 1) | strand

    # window lex-min by (hash, packed) over [i-w+1, i] in doubling rounds;
    # the earliest position wins ties
    def cmb(Hm, Pm, s):
        Hs = _shift_row(Hm, s, _U32)
        Ps = _shift_row(Pm, s, 0)
        better = (Hs < Hm) | ((Hs == Hm) & (Ps < Pm))
        return torch.where(better, Hs, Hm), torch.where(better, Ps, Pm)

    Hm, Pm = H, packed
    span = 1
    while span * 2 <= w:
        Hm, Pm = cmb(Hm, Pm, span)
        span *= 2
    if span < w:
        Hm, Pm = cmb(Hm, Pm, w - span)

    emit = (pos_i >= k + w - 2) & inread & (Hm != _U32)
    emit_prev = _shift_row(emit, 1, False)
    Pm_prev = _shift_row(Pm, 1, -1)
    neww = emit & (~emit_prev | (Pm != Pm_prev))
    return neww, Hm, Pm, H


def sketch_device(codes: torch.Tensor, qlens: torch.Tensor, *, k: int,
                  w: int):
    """The reference's parity wrapper over sketch_winners with its original
    output layout, flat (n*L,) tensors indexed by absolute position
    j = rid*L + pos: win (int32 0/1: position j's k-mer is an emitted
    minimizer), H (every position's canonical k-mer hash, a uint32 value in
    int64, 0xFFFFFFFF where invalid) and strand (int32 0/1). No map path
    calls it; build_groups_device uses sketch_winners directly."""
    n, L = codes.shape
    dev = codes.device
    neww, Hm, Pm, H = sketch_winners(codes, qlens, k=k, w=w)
    rows = torch.arange(n, dtype=torch.int32, device=dev)[:, None] * L
    j = torch.where(neww, rows + (Pm >> 1), n * L).reshape(-1)
    win = _scatter_drop(n * L, j, torch.ones_like(j))

    # per-position strand plane (the original API's companion)
    pos_i = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    good = (codes >= 0) & (codes < 4) & (pos_i < qlens[:, None])
    c = torch.where(good, codes.to(torch.int64), 0)
    kf = torch.zeros((n, L), dtype=torch.int64, device=dev)
    kr = torch.zeros((n, L), dtype=torch.int64, device=dev)
    for d in range(k):
        shifted = _shift_row(c, d, 0)
        kf = kf | (shifted << (2 * d))
        kr = kr | ((3 - shifted) << (2 * (k - 1 - d)))
    strand = (kr < kf).to(torch.int32)
    return win, H.reshape(-1), strand.reshape(-1)


def _blocked_cummax(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Cumulative max over a 1-D int32 tensor by the reference's 2-level
    block decomposition: a scan within each block of a (B, block) view,
    a scan over the block maxima, and the carry of the blocks before.
    Lengths that are no multiple of `block` take one plain scan. No map
    path calls it (build_groups_device runs torch.cummax)."""
    n = x.shape[0]
    if n % block:
        return torch.cummax(x, dim=0).values
    intra = torch.cummax(x.reshape(n // block, block), dim=1).values
    carry = torch.cummax(intra[:, -1], dim=0).values
    carry = torch.cat([torch.full((1,), -(2 ** 31) + 1, dtype=x.dtype,
                                  device=x.device), carry[:-1]])
    return torch.maximum(intra, carry[:, None]).reshape(n)


def _bounded_lower_bound(keys, q, lo, hi, steps: int):
    """First index in sorted `keys` restricted to [lo, hi) whose value is
    >= q (hi when none), in `steps` bisection rounds."""
    K = keys.shape[0]
    for _ in range(steps):
        cont = lo < hi
        mid = (lo + hi) >> 1
        v = keys[mid.clamp(0, K - 1).long()]
        go_right = v < q
        lo = torch.where(cont & go_right, mid + 1, lo)
        hi = torch.where(cont & ~go_right, mid, hi)
    return lo


def _scatter_drop(size: int, idx, vals):
    """zeros(size).at[idx].set(vals, mode="drop") for unique in-range idx:
    out-of-range rows go to a dump slot that is sliced off."""
    idx = torch.where((idx >= 0) & (idx < size), idx, size).long()
    out = torch.zeros((size + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    out[idx] = vals
    return out[:size]


def build_groups_device(codes, qlens, keys32, pos_t, ss16, lut2, runcnt, *,
                        k: int, w: int, max_occ: int, min_group_anchors: int,
                        gap_break: int, cap: int, seq_bits: int,
                        lut_bits: int, n_bisect: int, wtot_max: int,
                        a_max: int, g_max: int):
    """Full device seed stage: sketch -> bucket-LUT hash lookup -> anchor
    expansion -> (read, seq, strand, gap)-grouping -> capped even subsample.

    codes (n, L) int8 read codes, qlens (n,) int32; keys32 sorted int32 hash
    table, pos_t (K,) int32 k-mer end positions, ss16 (K,) seq_id << 1 |
    strand (int32 here: torch's uint16 has too few ops), lut2
    (2**lut_bits, 2) int32 paired bucket bounds, runcnt (K,) uint8 run
    lengths at run starts.

    Returns (qg, tg, cnt, rid, seqid, strand, t_base, counts): (g_max, cap)
    anchor planes, (g_max,) group identities, and int32 counts [n_winners,
    n_anchors, n_groups_kept, min_affected_rid] — all int32."""
    n, L = codes.shape
    dev = codes.device
    i32 = torch.int32
    if n * (1 << (seq_bits + 1)) >= I32_MAX:
        raise ValueError(f"identity key overflow: n_reads={n} "
                         f"seq_bits={seq_bits}")
    if 2 * n * L >= I32_MAX:
        raise ValueError(f"packed winner slot overflow: {n}x{L}")
    if max_occ >= 255:
        raise ValueError("runcnt clip requires max_occ < 255")
    qlens = qlens.to(i32)
    neww, Hm, Pm, H = sketch_winners(codes, qlens, k=k, w=w)
    rid_plane = torch.arange(n, dtype=i32, device=dev)[:, None].expand(n, L)
    K = keys32.shape[0]

    # compact winners into wtot_max slots (read-major order)
    nf = neww.reshape(-1)
    woff = torch.cumsum(nf.to(i32), dim=0, dtype=i32)
    tot_w = woff[-1]
    dst = torch.where(nf, woff - 1, wtot_max)
    flatwin = (rid_plane * L).reshape(-1) + (Pm.reshape(-1) >> 1)
    msrc2 = _scatter_drop(wtot_max, dst,
                          (flatwin << 1) | (Pm.reshape(-1) & 1))
    msrc = msrc2 >> 1
    slots = torch.arange(wtot_max, dtype=i32, device=dev)
    wvalid = slots < torch.clamp(tot_w, max=wtot_max)
    mH = torch.where(wvalid, H.reshape(-1)[msrc.long()], _U32)
    minrid_w = torch.where(nf & (woff > wtot_max), rid_plane.reshape(-1),
                           NO_RID).min()

    # lookup: the int32 view is order-preserving (valid hashes < 2**30; the
    # 0xFFFFFFFF sentinel becomes -1 and is never in the table)
    mHs = torch.where(mH > I32_MAX, mH - (1 << 32), mH).to(i32)
    shift = 2 * k - lut_bits
    b = torch.where(mHs >= 0, mHs >> shift, 0).clamp(0, (1 << lut_bits) - 1)
    bounds = lut2[b.long()]
    lo = _bounded_lower_bound(keys32, mHs, bounds[:, 0], bounds[:, 1],
                              n_bisect)
    loc = lo.clamp(0, K - 1).long()
    present = (keys32[loc] == mHs) & (lo < K)
    cnt0 = torch.where(present, runcnt[loc].to(i32), 0)
    mcnt = torch.where(wvalid & (cnt0 > 0) & (cnt0 <= max_occ), cnt0, 0)

    # expand hits into a_max anchor slots: scatter each winner's slot id at
    # its exclusive offset, forward-fill with a running max, rank within
    aoff = torch.cumsum(mcnt, dim=0, dtype=i32)
    tot_a = aoff[-1]
    aoff_exc = aoff - mcnt
    aslots = torch.arange(a_max, dtype=i32, device=dev)
    dst_a = torch.where(mcnt > 0, aoff_exc, a_max)
    am = torch.cummax(_scatter_drop(a_max, dst_a, slots), dim=0).values
    avalid = aslots < torch.clamp(tot_a, max=a_max)
    wp = torch.stack([msrc2, aoff_exc, lo], dim=1)[am.long()]
    w2 = wp[:, 0]
    within = aslots - wp[:, 1]
    pidx = (wp[:, 2] + within).clamp(0, pos_t.shape[0] - 1).long()
    a_t = pos_t[pidx]
    ss = ss16[pidx].to(i32)
    a_seq = ss >> 1
    wsrc = w2 >> 1
    a_rid = torch.div(wsrc, L, rounding_mode="floor")
    qp = wsrc - a_rid * L
    a_strand = (ss & 1) ^ (w2 & 1)
    a_q = torch.where(a_strand == 1, qlens[a_rid.long()] + (k - 2) - qp, qp)
    rid_slot = torch.div(msrc, L, rounding_mode="floor")
    minrid_a = torch.where((mcnt > 0) & (aoff > a_max), rid_slot,
                           NO_RID).min()

    # sort by (rid, seq, strand, t, q): identity packs into one int32 key
    key1 = torch.where(avalid,
                       (a_rid << (seq_bits + 1)) | (a_seq << 1) | a_strand,
                       I32_MAX)
    perm = torch.argsort(a_q, stable=True)
    perm = perm[torch.argsort(a_t[perm], stable=True)]
    perm = perm[torch.argsort(key1[perm], stable=True)]
    k1s, st, sq = key1[perm], a_t[perm], a_q[perm]
    svalid = k1s != I32_MAX
    srid = k1s >> (seq_bits + 1)
    sseq = (k1s >> 1) & ((1 << seq_bits) - 1)
    sstrand = k1s & 1

    # group boundaries: identity change or target gap > gap_break
    newg = torch.cat([
        svalid[:1],
        svalid[1:] & ((k1s[1:] != k1s[:-1]) | (st[1:] - st[:-1] > gap_break)),
    ])
    gid = torch.cumsum(newg.to(i32), dim=0, dtype=i32) - 1
    gidx = torch.where(svalid, gid, a_max).long()
    sizes = torch.zeros(a_max + 1, dtype=i32, device=dev).index_add_(
        0, gidx, torch.ones_like(gid))[:a_max]
    asize = sizes[gid.clamp(0, a_max - 1).long()]
    kept = svalid & (asize >= min_group_anchors)

    kg_start = newg & kept
    kgid = torch.cumsum(kg_start.to(i32), dim=0, dtype=i32) - 1
    n_groups_kept = kgid[-1] + 1
    minrid_g = torch.where(kg_start & (kgid >= g_max), srid, NO_RID).min()

    tgt = torch.where(kg_start, kgid, g_max)
    gvals = torch.stack([aslots, asize, srid, sseq, sstrand, st], dim=1)
    g_all = _scatter_drop(g_max, tgt, gvals)
    g_start, g_size, g_rid, g_seq, g_strand, g_tbase = g_all.unbind(dim=1)
    g_m = torch.clamp(g_size, max=cap)

    # even subsample (pack_groups_flat's pick: c*(size-1)//(m-1), endpoints
    # kept exactly)
    c = torch.arange(cap, dtype=i32, device=dev)[None, :]
    denom = torch.clamp(g_m - 1, min=1)[:, None]
    src_rank = torch.where(
        g_m[:, None] > 1,
        torch.div(c * (g_size[:, None] - 1), denom, rounding_mode="floor"),
        0)
    src = (g_start[:, None] + src_rank).clamp(0, a_max - 1).long()
    amask = c < g_m[:, None]
    qg = torch.where(amask, sq[src], 0)
    tg = torch.where(amask, st[src] - g_tbase[:, None], 0)

    minrid = torch.minimum(torch.minimum(minrid_w, minrid_a), minrid_g)
    counts = torch.stack([tot_w, tot_a, n_groups_kept, minrid]).to(i32)
    return (qg.to(i32), tg.to(i32), g_m, g_rid, g_seq, g_strand, g_tbase,
            counts)
