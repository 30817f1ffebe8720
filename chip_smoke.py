#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (megapath_nano_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (the kernels are built from
megapath_nano_tpu_torch/kernels/csrc at first use) and g++ with zlib (the
native host layer, built from cpp/ at first use). Imports nothing of JAX and
nothing of the megapath_nano_tpu package. Phases, each of which raises on
failure:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, the nvcc and g++ build times.
2. Kernels against their plain PyTorch versions on the card, bit-equal:
   banded_sw_full at band 128 on 8192 pairs of 1 kb (the PAF path's shape),
   at band 256 on 1024 pairs of 4 kb, at band 512 on 256 pairs of 8 kb;
   banded_sw_scores at 1024 x 1 kb band 128 (the CIGAR path's shape),
   1024 x 4 kb band 256, 128 x 16 kb band 512 and 8 x 40 kb band 512 (the
   40 kb map's call); the bands above 1024, which only the block-per-pair
   forms serve: banded_sw_full at band 2048 on 64 x 4 kb, banded_sw_scores
   at band 2048 on 64 x 8 kb and at band 1152 on 64 x 2 kb; both on edge
   cases, on a ragged batch (1027 pairs,
   read lengths 0..1024), on a batch shaped like the fused PAF launch
   (8192 pairs, most of them with read length 0) and on a tie-heavy batch
   (homopolymers, N stretches, refs of 0..3 bases). Every extension batch
   goes through the wrapper and through both forms of its kernel (a warp
   per pair, a block per pair; the block form alone where the band has no
   warp form), and the two forms are timed in turn: block, warp, warp,
   block. chain_and_extents on 16384 groups x 32
   anchors, 4096 x 256, on groups that read every entry of the gap-cost
   table, on int16 planes, on rows of 33, 100 and 512 anchors, with windows
   of 1, 7 and 31, on a batch of empty groups and on counts beyond the row
   and below 0; its time is given twice, around the wrapper (CUDA events)
   and for the kernel alone (torch.profiler), and the profiled run of 20
   calls must show no host-to-device copy, no synchronisation and no other
   device work than the kernel. Times from CUDA events after a warm-up;
   beside each, the least time the card could take for the same inputs
   (see `Bound`).
3. The PAF-mode map at a real size: 32 random genomes of 4 Mbp (128 Mbp,
   k=15 w=10 index), 32768 simulated 1 kb reads at 6% error (sub:ins:del
   2:1:1, half reverse-complemented), mapped with
   map_reads(slice_size=4096, emit_cigars=False) after a warm-up on the
   same reads. At least 90% of reads must map and 95% of those land on
   their true genome and strand within 150 bases; sw_full and chain must
   have been launched. One more map runs under torch.profiler (device busy
   time, idle share, kernel time by name). Then 2048 reads of 4 kb, so that
   band 256 runs on the path.
4. The same aligner on the card and on the CPU (plain versions) on 512
   reads in PAF mode: all 18 AlignList fields equal. Then 2048 reads in
   slices of 512 with the device-seeding caps cut to a quarter, on both:
   slices overflow and their tails are redone host-seeded; at least one
   read must have been redone, and records, overflow statistics and cap
   scales must be equal.
5. The CIGAR-mode map on the same index: 8192 of those 1 kb reads with
   map_reads(slice_size=4096, emit_cigars=True) (two worker threads), the
   same accuracy bars, every CIGAR consistent with its record, a SAM file
   written; chain and sw_scores must have been launched. The PAF-mode map
   with the fused dispatch off (the same host-chained path, fields from
   the full-stats kernel) equals it in 11 fields; the fused PAF map, whose
   device seeding caps a group at 32 anchors, may differ in at most 1% of
   rows. One slice again with a timer on each stage, and the native
   traceback's score held to the score-only kernel's on every pair it
   traced. 512 reads of 4 kb (band 256); 8 reads of 40 kb (windows of
   65536, band 512: beyond the full-stats kernel's limit).
6. Card against CPU on 256 reads in CIGAR mode: 18 fields and the whole
   cigar_map equal.
7. The taxon profile through its CLI (megapath_nano_tpu_torch.cli.main.main)
   on the card, with the default flags (read filter, adapter trimming, PAF
   placement): 32 genomes of 4 Mbp as 8 genera x 4 species (each species
   its genus ancestor mutated by 3-8%), a RefDB built and saved, 32768
   reads of 1 kb at 6% error as FASTQ with qualities, in a geometric mix
   over the species (ratio 0.75, ranks drawn at random). At least 90% of
   the reads aligned, at least 90% of the best alignments on the true
   species, the .preport's top 8 in the order of the mix, every file of the
   output surface written; sw_full and chain launched. The wall time, the
   time by step (.timing) and the launch counts are logged.
8. The CLI with the noise stack's gates on (human filter, reassignment,
   spike, microbe-repetitive regions, variable regions, similar-species
   marker, noise projection, unique alignment, closing spike): 8 genomes of
   1 Mbp (2 genera x 4 species, 0.5-2% from their ancestor), a 2 Mbp human
   RefDB, 4096 reads of 1 kb, 5% of them human. Once with --device cuda and
   once with --device cpu (plain versions; a child process at low priority
   started before phase 7, since it takes minutes): every output file equal
   (archives member by member, .timing aside); sw_scores launched.
9. AMR through the CLI: 8 genomes of 4 Mbp (4 genera x 2 species, 3-8%
   from their genus ancestor) and a 64 kb plasmid in species 1's assembly,
   a RefDB built and saved by cli.build_db ref; a gene DB of 3000 genes
   built by cli.build_db amr (24 genes cut from the genomes: 16 from the
   chromosomes of the 6 species of genera 1-3, 4 from the plasmid, 4 from
   genus 4, whose species get no reads; a homolog of each at 20%
   substitutions; random genes; 1-3 drugs a gene); 12288 reads of 1 kb at
   6% error (4096 over the 6 species, 6144 around the 16 chromosomal loci,
   2048 from the plasmid). cli.main --amr_db --no_adaptor_trimming on the
   card, under torch.profiler: the 20 genes of the present species and the
   plasmid in results.csv with all their drugs, no other gene; the
   .species.sam written; sw_scores and chain launched inside the amr step
   (launches counted by step). Then cli.amr on that .species.sam's records
   on species 0's chromosome and the plasmid with --device cuda and
   --device cpu (a child process): results.csv byte-equal.
10. Phase 9's RefDB and its 4096 whole-genome reads through the CLI
   (--no_amr --no_adaptor_trimming), monolithic and with --index_shards 4:
   the .preport byte-equal, sw_full and chain launched in the sharded run.
   ShardedAligner over 4 shards on 256 of those reads, card against CPU:
   all 18 fields equal.

The last line of output is {"ok": true, "device": {...}}; the line before it
holds the per-kernel JSON record, whose `launches_by_path` counts each
kernel's launches in the PAF map, the CIGAR map, the profile (phase 7 and
phase 8's card run), phase 9's amr step and phase 10's sharded run.

    python3 chip_smoke.py profile

runs phases 1, 7 and 8 only and ends with a {"profile_launches": {...}}
line.

    python3 chip_smoke.py amr

runs phases 1, 9 and 10 only and ends with an {"amr_launches": {...}} line.

    python3 chip_smoke.py kernels

runs phases 1 and 2 only (a quick check after a change to a kernel) and
ends with a {"kernel_checks": [...]} line: the same per-kernel records
without the launch counts (no map ran, so there is none to report), and
without the "ok" line.

    python3 chip_smoke.py chain [TREE]

times the chain wrapper alone (wrapper, kernel only, uploads and
synchronisations a call, the host's wait behind queued work) and ends with a
{"chain_times": [...]} line.

    python3 chip_smoke.py maps [TREE]

runs phases 1, 3 and 5 only: the two maps with their timed runs, stage
times and profile. With TREE (a directory that holds megapath_nano_tpu_torch/
and cpp/ of another checkout), `chain` and `maps` import that package
instead of this one's: two versions can be timed in turn on one card, one
after the other.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "megapath_nano_tpu_torch/kernels/csrc/"
# name -> (source, file:line of the TPU kernel it replaces)
KERNELS = {
    "banded_sw_full": (CSRC + "sw_full.cu",
                       "megapath_nano_tpu/kernels/sw.py:276"),
    "chain_and_extents": (CSRC + "chain.cu",
                          "megapath_nano_tpu/kernels/chain.py:29"),
    "banded_sw_scores": (CSRC + "sw_scores.cu",
                         "megapath_nano_tpu/kernels/sw.py:423"),
}
SW_PARAMS = dict(match=2, mismatch=4, gap_open=4, gap_extend=2)
PAF_FIELDS = ("read_id", "read_from", "read_to", "strand", "sequence_id",
              "sequence_from", "sequence_to", "match", "edit_dist",
              "alignment_score", "mapq")

# Bound: the least time an H100 SXM could take for a call, the larger of
#   bytes / 3.35e12 B/s   (each input read once, each output written once)
#   ops / 16.75e12 op/s   (operations that only the SM's integer pipe can do).
# The rate: an sm_90 SM retires 64 results a clock of a 32-bit integer
# compare, minimum or maximum (NVIDIA's CUDA C++ programming manual, table
# "Throughput of Native Arithmetic Instructions", compute capability 9.0);
# 132 SMs at the 1.98 GHz boost clock give 16.75e12 a second, also the data
# sheet's 67 TFLOP/s of float32 (128 lanes, a fused multiply-add counted
# twice) over 4. Hopper's DPX instructions (a fused add-maximum, a maximum
# of three, a maximum that reports its winner: __viaddmax_s32, __vimax3_s32,
# __vibmax_s32) are taken to run at that same rate, one instruction a
# result; NVIDIA publishes no separate figure for them.
# The operations: those of the least program for the function, not of the
# plain version and not of the kernels: a sequential F chain (one step a
# cell), every add-maximum pair and every maximum of three as one fused
# instruction, one compare for all the selects it decides. Counted are only
# compares, maxima (fused ones too) and selects. Additions are left out:
# an integer add can also go as a multiply-add down the floating-point
# pipe, so it does not bound the integer pipe. On these assumptions no
# kernel beats the bound on this card; cells are what these inputs need
# (rows stop at each pair's own read length).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# banded_sw_scores, a cell: substitution score 1 (a select on the codes'
# equality, N and dead codes folded into the compare), E 1 (add-maximum of
# E_up - e and H_up - o, its floor at 0 fused), Hnod 1 (add-maximum of
# H_diag + sub and E), dead cell 1 (select), F 1 (add-maximum), H 1
# (maximum of Hnod, F and 0), running best 1 (a maximum over the row's
# cells; the lane's compare and selects are shared by its slots)
SW_SCORES_OPS_PER_CELL = 7
# banded_sw_full, a cell: the same 7, and for the companions P and B:
# diagonal 4 (fresh compare, select of the increment, P and B selects), E 2,
# Hnod 2 and F 2 (P and B selects on the maximum's own winner flag), H 3 (the
# maximum of three splits into a maximum with winner flag and a floor, P and
# B selects), H > 0 2 (P and B selects)
SW_FULL_OPS_PER_CELL = 22
# chain_and_extents, per (anchor, predecessor) pair: |dq - dt| 1, the range
# tests 3 (unsigned compares of dq - 1, dt - 1 and dd, chained through their
# predicates with the live flag), alpha 1 (minimum of three), the masking
# select 1, the maximum with winner flag 1, the select of its index 1
CHAIN_OPS_PER_PAIR = 8


def log(*args):
    print(*args, flush=True)


def mutate_fast(rng, src, err):
    """ONT-style errors at rate err, sub:ins:del = 2:1:1 (the same per-base
    rule as megapath_nano_tpu_torch.utils.dna.mutate, vectorized)."""
    d, i, s = err / 4, err / 4, err / 2
    r = rng.random(len(src))
    is_ins = (r >= d) & (r < d + i)
    is_sub = (r >= d + i) & (r < d + i + s)
    base = src.copy()
    base[is_sub] = (base[is_sub] + rng.integers(1, 4, int(is_sub.sum()))) % 4
    reps = np.where(r < d, 0, np.where(is_ins, 2, 1))
    out = np.repeat(base, reps)
    first = np.cumsum(reps) - reps
    out[first[is_ins]] = rng.integers(0, 4, int(is_ins.sum()))
    return out.astype(np.int8)


def simulate_reads(rng, genomes, n, length, err):
    """n reads of `length` from random genomes/positions; half are
    reverse-complemented. Returns (reads, truth (n, 3): genome, start,
    strand)."""
    from megapath_nano_tpu_torch.utils.dna import revcomp

    reads, truth = [], np.zeros((n, 3), np.int64)
    for j in range(n):
        g = int(rng.integers(len(genomes)))
        s = int(rng.integers(0, len(genomes[g]) - length))
        r = mutate_fast(rng, genomes[g][s: s + length], err)
        strand = int(rng.integers(0, 2))
        reads.append(revcomp(r) if strand else r)
        truth[j] = (g, s, strand)
    return reads, truth


def cuda_ms(fn, iters):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def steady_ms(fn, iters=50, turns=3):
    """Time a call of a short kernel's wrapper: the least of `turns` runs of
    `iters` calls each, after a few calls that bring the card's clocks and
    the allocator to a steady state. Returns (least, all turns)."""
    for _ in range(5):
        fn()
    times = [cuda_ms(fn, iters) for _ in range(turns)]
    return min(times), times


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by) for a call that must move n_bytes and do n_ops
    int32 operations."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sw_bound(arrays, band, ops_per_cell, out_cols):
    """Bound of one banded extension call on (reads, rlens, refs, tlens):
    int8 planes and int32 lengths in, out_cols int32 per pair out; cells =
    sum over pairs of read length x band."""
    ra, rl, ta, tl = arrays
    n_bytes = ra.size + ta.size + 4 * (rl.size + tl.size) \
        + 4 * out_cols * len(rl)
    cells = int(np.minimum(rl, ra.shape[1]).astype(np.int64).sum()) * band
    return bound(n_bytes, cells * ops_per_cell)


def chain_bound(arrays, window=32, bandwidth=500):
    """Bound of one chain call on (q, t, cnt), int16 or int32 planes and
    int32 counts: pairs = for every live anchor i of a group, its
    min(i, window) predecessors."""
    q, t, cnt = arrays
    n_bytes = q.nbytes + t.nbytes + 4 * cnt.size + 4 * (bandwidth + 1) \
        + 24 * len(cnt)
    c = np.clip(cnt, 0, q.shape[1]).astype(np.int64)
    w = np.minimum(c, window)
    pairs = int((w * (w - 1) // 2 + (c - w) * window).sum())
    return bound(n_bytes, pairs * CHAIN_OPS_PER_PAIR)


def kernel_record(err, ms, plain_ms, bnd):
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}


def require_equal(name, got, ref):
    """Hold a kernel's output to its plain version's: integers, so the
    tolerance is 0. Returns the max absolute difference."""
    import torch

    got, ref = got.cpu().to(torch.int64), ref.cpu().to(torch.int64)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    err = int((got - ref).abs().max().item()) if got.numel() else 0
    if err:
        bad = (got != ref).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: kernel != plain version at {bad} "
                             f"(max_abs_err {err})")
    log(f"  {name}: bit-equal (max_abs_err 0, tolerance 0)")
    return err


# ---------------------------------------------------------------------------
# phase 1


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    log(nvidia_smi_line())
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    from megapath_nano_tpu_torch.kernels import build

    t0 = time.perf_counter()
    cached = os.path.exists(build.library_path())
    build.load()
    log(f"nvcc build: {time.perf_counter() - t0:.2f} s "
        f"({'cached' if cached else 'compiled'}) -> "
        f"{os.path.relpath(build.library_path(), ROOT)}")
    from megapath_nano_tpu_torch.native import lib as native

    t0 = time.perf_counter()
    cached = os.path.exists(native.library_path())
    native.load_native_lib()
    log(f"g++ build of cpp/: {time.perf_counter() - t0:.2f} s "
        f"({'cached' if cached else 'compiled'}) -> "
        f"{os.path.relpath(native.library_path(), ROOT)}")
    with open(build.library_path()[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())


# ---------------------------------------------------------------------------
# phase 2


def sw_batch(rng, n, q_len, t_len, err):
    """(reads, rlens, refs, tlens) of n pairs: a read with err errors drawn
    from a ref window, as the map path's extension windows are."""
    ra = np.full((n, q_len), 4, np.int8)
    ta = rng.integers(0, 4, (n, t_len)).astype(np.int8)
    rl = np.zeros(n, np.int32)
    tl = np.full(n, t_len, np.int32)
    for j in range(n):
        r = mutate_fast(rng, ta[j, 16: 16 + q_len - 64], err)[: q_len]
        ra[j, : len(r)] = r
        rl[j] = len(r)
    return ra, rl, ta, tl


def pad_pairs(pairs):
    """(reads, rlens, refs, tlens) from a list of (read, ref) code arrays."""
    q_max = max(len(r) for r, _ in pairs)
    t_max = max(len(x) for _, x in pairs)
    ra = np.full((len(pairs), q_max), 4, np.int8)
    ta = np.full((len(pairs), t_max), 5, np.int8)
    rl = np.array([len(r) for r, _ in pairs], np.int32)
    tl = np.array([len(x) for _, x in pairs], np.int32)
    for j, (r, x) in enumerate(pairs):
        ra[j, : len(r)] = r
        ta[j, : len(x)] = x
    return ra, rl, ta, tl


def sw_edge_batch(rng):
    t = rng.integers(0, 4, 150).astype(np.int8)
    return pad_pairs([
        (t[:137].copy(), t), (np.zeros(0, np.int8), t),
        (np.full(90, 4, np.int8), t[:120]),
        (rng.integers(0, 4, 173).astype(np.int8), t[:60]),
        (np.zeros(70, np.int8), np.ones(80, np.int8)),
        (t[:50].copy(), np.full(64, 4, np.int8)),
        # a deletion right at the ref's last bases, then the read runs
        # on past the ref: E next to and on the dead slots is carried
        (np.concatenate([t[10:100], t[106:120],
                         rng.integers(0, 4, 60).astype(np.int8)]),
         t[:120])])


def sw_tie_batch(rng):
    """Pairs whose DP is full of equal values, so that the tie rules decide:
    homopolymers and short-period repeats (every diagonal scores alike, an
    indel can sit anywhere in the run), N stretches (zero substitution
    score), refs of 0..3 bases and refs shorter than the band (dead slots,
    whose g lies below, at and above NEG at k = 0, 1, 2 and up)."""
    def rep(unit, n):
        return np.tile(np.array(unit, np.int8), n // len(unit) + 1)[:n]

    pairs = []
    for unit in ([0], [0, 1], [0, 1, 2], [3, 3, 1]):
        for _ in range(4):
            q, t = (int(x) for x in rng.integers(60, 300, 2))
            ref = rep(unit, t)
            pairs.append((rep(unit, q), ref))
            cut = int(rng.integers(10, q - 10))
            pairs.append((np.concatenate([rep(unit, q)[:cut],
                                          rep(unit, q)[cut + 5:]]), ref))
            with_n = rep(unit, q)
            with_n[cut: cut + int(rng.integers(1, 40))] = 4
            pairs.append((with_n, ref))
            ref_n = ref.copy()
            ref_n[t // 3: t // 3 + int(rng.integers(1, 40))] = 4
            pairs.append((rep(unit, q), ref_n))
    for t in (0, 1, 2, 3, 17, 63, 64, 65):
        pairs.append((rep([0], 200), rep([0], t)))
        pairs.append((rep([2, 1], 150), rep([2, 1], t)))
    pairs.append((np.full(120, 4, np.int8), rep([1], 200)))
    pairs.append((rep([1], 120), np.full(200, 4, np.int8)))
    pairs.append((np.zeros(0, np.int8), rep([1], 50)))
    return pad_pairs(pairs)


def sw_ragged_batch(rng, n=1027, q_len=1024, t_len=1280):
    """n (no multiple of the pairs a block holds) pairs whose read lengths
    run from 0 to q_len and whose ref lengths run from 0 to t_len, in no
    order: neighbours in a block stop at different rows."""
    ra, _, ta, _ = sw_batch(rng, n, q_len, t_len, 0.06)
    rl = rng.integers(0, q_len + 1, n).astype(np.int32)
    tl = rng.integers(0, t_len + 1, n).astype(np.int32)
    rl[:8] = (0, q_len, 1, 0, 2, 3, q_len - 1, 5)
    return ra, rl, ta, tl


def sw_fused_shape_batch(arrays, rng):
    """The batch as the fused PAF launch passes it: the static group cap of
    pairs, the kept ones compacted to the front or scattered (no cap), all
    others with read and ref length 0."""
    ra, rl, ta, tl = arrays
    n = len(rl)
    live = np.zeros(n, bool)
    live[: n // 4] = True
    live[n // 2:] = rng.random(n - n // 2) < 0.1
    return ra, np.where(live, rl, 0).astype(np.int32), ta, \
        np.where(live, tl, 0).astype(np.int32)


def check_sw(kind, name, arrays, band, kernel_iters=5):
    """Hold one banded extension wrapper (kind "full" or "scores"), and both
    forms of its kernel, to the plain version on the card; time the wrapper,
    the plain version (one run) and the two forms in turn."""
    import torch

    from megapath_nano_tpu_torch.kernels import sw

    dev = torch.device("cuda")
    ra, rl, ta, tl = (torch.from_numpy(x).to(dev) for x in arrays)
    reads, rlens, refs_p = sw._prepare(ra, rl, ta, tl, band)
    if kind == "full":
        def kernel():
            return sw.banded_sw_full(ra, rl, ta, tl, band=band, **SW_PARAMS)

        def form(which):
            return lambda: sw._sw_full_cuda(ra, rl, ta, tl, band=band,
                                            form=which, **SW_PARAMS)

        def plain():
            return sw.banded_sw_full_torch(reads, rlens, refs_p, band=band,
                                           **SW_PARAMS)
        bnd = sw_bound(arrays, band, SW_FULL_OPS_PER_CELL, 7)
    else:
        def kernel():
            return torch.stack(sw.banded_sw_scores(ra, rl, ta, tl, band=band,
                                                   **SW_PARAMS))

        def form(which):
            return lambda: sw._sw_scores_cuda(ra, rl, ta, tl, band=band,
                                              form=which, **SW_PARAMS)

        def plain():
            return sw.banded_sw_scores_torch(reads, rlens, refs_p, band=band,
                                             **SW_PARAMS)
        bnd = sw_bound(arrays, band, SW_SCORES_OPS_PER_CELL, 3)
    out = {}
    plain_ms = cuda_ms(lambda: out.update(ref=plain()), 1)
    err = 0
    # bands other than 128, 256 and 512 have the block form only
    warp = band in sw.WARP_BANDS
    forms = [("", kernel)] + ([(" [warp per pair]", form(sw.FORM_WARP))]
                              if warp else []) \
        + [(" [block per pair]", form(sw.FORM_BLOCK))]
    for label, fn in forms:
        got = fn()
        torch.cuda.synchronize()
        err = max(err, require_equal(name + label, got, out["ref"]))
    ms = cuda_ms(kernel, kernel_iters)
    n, q = arrays[0].shape
    rows = int(np.minimum(arrays[1], q).astype(np.int64).sum())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"  {name}: wrapper {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bnd[0]:.4f} ms by {bnd[1]} ({n} pairs x {q} rows, band {band}; "
        f"{rows * band / ms / 1e6:.2f} Gcell/s, "
        f"{rows / ms / sms / 1e3:.3f} Mrow/s per SM)")
    rec = kernel_record(err, ms, plain_ms, bnd)
    if not warp:
        log(f"  {name}: block per pair only (this card takes bands up to "
            f"{sw.block_max_band(f'mpn_sw_{kind}', 0)} in that form)")
        return rec
    turns = [cuda_ms(form(which), kernel_iters) for which in
             (sw.FORM_BLOCK, sw.FORM_WARP, sw.FORM_WARP, sw.FORM_BLOCK)]
    block_ms, warp_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    log(f"  {name}: kernel alone, in turn block, warp, warp, block: "
        + ", ".join(f"{t:.3f}" for t in turns)
        + f" ms; block per pair {block_ms:.3f}, warp per pair {warp_ms:.3f}")
    # prev_ms: the block-per-pair form, which was the whole kernel before
    # the warp-per-pair form existed
    rec.update(prev_ms=block_ms, warp_ms=warp_ms)
    return rec


def chain_groups(rng, n, a=32):
    """Colinear, noisy and random anchor rows sorted by (t, q)."""
    q = np.zeros((n, a), np.int32)
    t = np.zeros((n, a), np.int32)
    cnt = rng.integers(0, a + 1, n).astype(np.int32)
    for g in range(n):
        step = rng.integers(5, 60, a)
        tt = np.cumsum(step)
        if g % 3 == 0:
            qq = tt + 17
        elif g % 3 == 1:
            qq = tt + rng.integers(-40, 40, a)
        else:
            tt = np.sort(rng.integers(0, 6000, a))
            qq = rng.integers(0, 6000, a)
        order = np.lexsort((qq, tt))
        q[g], t[g] = np.abs(qq[order]), tt[order]
    return q, t, cnt


def beta_groups(bandwidth=500, a=32):
    """One group per dd in [0, bandwidth], so the kernel reads every entry
    of the gap-cost table on a path that reaches the output: 16 anchors on
    one diagonal, then 16 on a diagonal shifted by dd. The best chain
    crosses the shift once, so best = 480 - beta[dd]."""
    n = bandwidth + 1
    pos = 100 + 20 * np.arange(a, dtype=np.int32)
    t = np.tile(pos, (n, 1))
    q = t.copy()
    q[:, a // 2:] += np.arange(n, dtype=np.int32)[:, None]
    return q, t, np.full(n, a, np.int32)


def chain_profile(fn, calls):
    """`calls` calls of a chain wrapper under torch.profiler. Returns (the
    chain kernel's own time a call in ms, the names of all other device
    work such as copies and conversion kernels, the synchronisations the
    host made) over those calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    waits = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaEventSynchronize")
    fn()
    torch.cuda.synchronize()
    for _attempt in range(4):   # the tracer now and then drops events
        with profile(activities=acts) as prof:
            with record_function("chain_calls"):
                for _ in range(calls):
                    fn()
            torch.cuda.synchronize()
        events = list(prof.events())
        span = next(ev.time_range for ev in events
                    if ev.name == "chain_calls")
        kernel_us, others, syncs = [], [], 0
        for ev in events:
            if ev.name == "chain_calls":    # the span, on either timeline
                continue
            if ev.device_type == DeviceType.CUDA:
                if "chain_kernel" in ev.name:
                    kernel_us.append(ev.time_range.elapsed_us())
                else:
                    others.append(ev.name)
            elif ev.name in waits \
                    and span.start <= ev.time_range.start <= span.end:
                syncs += 1
        if len(kernel_us) == calls:
            return sum(kernel_us) / 1e3 / calls, others, syncs
    raise AssertionError(f"profiler saw {len(kernel_us)} chain kernels in "
                         f"{calls} calls, four times over; kernel time not "
                         f"measured")


def check_chain(name, arrays, window=32, plain_iters=1):
    """Hold the chain wrapper to the plain version on the card; time the
    wrapper (CUDA events around the calls), the kernel alone (profiler) and
    the plain version. After its first call on a device a call must be its
    kernel alone: no upload, no conversion of int16 or int32 planes, no
    synchronisation."""
    import torch

    from megapath_nano_tpu_torch.kernels import chain

    dev = torch.device("cuda")
    q, t, cnt = (torch.from_numpy(x).to(dev) for x in arrays)
    kw = dict(window=window, k=15, max_dist=5000, bandwidth=500)
    beta = chain.beta_tensor(15, 500, dev)

    def kernel():
        return chain.chain_and_extents(q, t, cnt, **kw)

    def plain():
        return chain.chain_and_extents_torch(q, t, cnt, beta, **kw)

    kern, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = require_equal(name, kern, ref)
    ms, _ = steady_ms(kernel)
    kernel_ms, others, syncs = chain_profile(kernel, 20)
    if others or syncs:
        raise AssertionError(
            f"{name}: a chain call on the card must be its kernel alone; 20 "
            f"calls also ran {others} and synchronised {syncs} times")
    plain_ms = cuda_ms(plain, plain_iters)
    bnd = chain_bound(arrays, window=window)
    log(f"  {name}: wrapper {ms:.4f} ms, kernel alone {kernel_ms:.4f} ms "
        f"(20 calls: no other device work, no synchronisation), plain "
        f"{plain_ms:.3f} ms, bound {bnd[0]:.4f} ms by {bnd[1]} "
        f"({arrays[0].shape[0]} groups x {arrays[0].shape[1]} anchors, "
        f"{arrays[0].dtype}, window {window})")
    rec = kernel_record(err, ms, plain_ms, bnd)
    rec["kernel_only_ms"] = kernel_ms
    return rec


def chain_edge_groups(rng):
    """(name, arrays, window) of the chain checks beyond the main paths'
    shapes: int16 planes, row lengths that are no multiple of 32 and the
    longest the host-chained path can ask for, short windows, a batch of
    empty groups, counts beyond the row and below 0."""
    def typed(arrays, dtype):
        return arrays[0].astype(dtype), arrays[1].astype(dtype), arrays[2]

    out = [("chain 4096 x 64, int16", typed(chain_groups(rng, 4096, 64),
                                            np.int16), 32),
           ("chain 1000 x 33", chain_groups(rng, 1000, 33), 32),
           ("chain 1000 x 100, int16", typed(chain_groups(rng, 1000, 100),
                                             np.int16), 32),
           ("chain 515 x 512", chain_groups(rng, 515, 512), 32)]
    for window in (1, 7, 31):
        out.append((f"chain 2048 x 100, window {window}",
                    chain_groups(rng, 2048, 100), window))
    q, t, cnt = chain_groups(rng, 2048, 64)
    out.append(("chain 2048 x 64, all counts 0", (q, t, np.zeros_like(cnt)),
                32))
    wild = rng.integers(-70, 140, len(cnt)).astype(np.int32)
    out.append(("chain 2048 x 64, counts -70..139", (q, t, wild), 32))
    return out


def chain_times(rng, tree):
    """Times of the chain wrapper of the package under `tree` (this checkout
    or another one, for a comparison on one card in one go): CUDA
    events around the calls, the kernel alone under the profiler, the
    uploads and synchronisations the calls made, and the host's time in one
    call made while the stream still holds other work (a wrapper that
    uploads from pageable memory waits for all of it). Returns the records
    printed as the {"chain_times": [...]} line."""
    import torch

    from megapath_nano_tpu_torch.kernels import chain

    dev = torch.device("cuda")
    shapes = [("16384 x 32 int32", chain_groups(rng, 16384)),
              ("4096 x 256 int32", chain_groups(rng, 4096, 256))]
    q, t, cnt = chain_groups(rng, 4096, 64)
    shapes.append(("4096 x 64 int16", (q.astype(np.int16),
                                       t.astype(np.int16), cnt)))
    iters = 50
    busy = torch.randn(8192, 8192, device=dev)
    busy @ busy
    out = []
    for name, arrays in shapes:
        q, t, cnt = (torch.from_numpy(x).to(dev) for x in arrays)

        def call():
            return chain.chain_and_extents(q, t, cnt)

        least, turns = steady_ms(call, iters)
        kernel_ms, others, syncs = chain_profile(call, iters)
        htod = sum("memcpy" in x.lower() and "htod" in x.lower()
                   for x in others)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(4):
            busy @ busy
        end.record()
        t0 = time.perf_counter()
        call()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        rec = {"tree": tree, "shape": name, "wrapper_ms": least,
               "wrapper_ms_turns": turns, "kernel_only_ms": kernel_ms,
               "htod_copies": htod, "synchronisations": syncs, "calls": iters,
               "host_ms_behind_queue": host_ms,
               "queued_ms": start.elapsed_time(end),
               "bound_ms": chain_bound(arrays)[0]}
        log(f"  chain {name}: wrapper {least:.4f} ms (turns "
            + ", ".join(f"{x:.4f}" for x in turns)
            + f"), kernel alone {kernel_ms:.4f} ms, {htod} uploads and "
            f"{syncs} synchronisations in {iters} calls; host "
            f"{host_ms:.3f} ms in a call behind {rec['queued_ms']:.2f} ms "
            f"of queued work")
        out.append(rec)
    return out


def phase_kernels(rng):
    """Returns {kernel name: record at the shape its main path gives it};
    the record's max_abs_err covers every shape checked."""
    log("phase 2: kernels vs plain versions on the card")
    paf_shape = sw_batch(rng, 8192, 1024, 1280, 0.06)
    full = check_sw("full", "sw_full band 128, 8192 x 1 kb", paf_shape, 128)
    scores = check_sw("scores", "sw_scores band 128, 1024 x 1 kb",
                      sw_batch(rng, 1024, 1024, 2048, 0.06), 128)
    edge = sw_edge_batch(rng)
    ties = sw_tie_batch(rng)
    ragged = sw_ragged_batch(rng)
    fused = sw_fused_shape_batch(paf_shape, rng)
    others = {
        "banded_sw_full": [
            check_sw("full", "sw_full band 256, 1024 x 4 kb",
                     sw_batch(rng, 1024, 4096, 4352, 0.06), 256),
            check_sw("full", "sw_full band 512, 256 x 8 kb",
                     sw_batch(rng, 256, 8192, 8704, 0.06), 512,
                     kernel_iters=3),
            check_sw("full", "sw_full edge cases", edge, 128),
            check_sw("full", f"sw_full ties ({len(ties[1])} pairs)", ties,
                     128),
            check_sw("full", "sw_full ragged, 1027 pairs", ragged, 128),
            check_sw("full", "sw_full fused-launch shape, 8192 pairs", fused,
                     128),
            check_sw("full", "sw_full band 2048, 64 x 4 kb",
                     sw_batch(rng, 64, 4096, 6144, 0.06), 2048,
                     kernel_iters=2)],
        "banded_sw_scores": [
            check_sw("scores", "sw_scores band 256, 1024 x 4 kb",
                     sw_batch(rng, 1024, 4096, 8192, 0.06), 256),
            check_sw("scores", "sw_scores band 512, 128 x 16 kb",
                     sw_batch(rng, 128, 16384, 32768, 0.06), 512,
                     kernel_iters=3),
            check_sw("scores", "sw_scores band 512, 8 x 40 kb",
                     sw_batch(rng, 8, 40960, 65536, 0.06), 512,
                     kernel_iters=2),
            check_sw("scores", "sw_scores edge cases (7 pairs)", edge, 128),
            check_sw("scores", f"sw_scores ties ({len(ties[1])} pairs)",
                     ties, 128),
            check_sw("scores", "sw_scores ragged, 1027 pairs", ragged, 128),
            check_sw("scores", "sw_scores fused-launch shape, 8192 pairs",
                     fused, 128),
            check_sw("scores", "sw_scores band 2048, 64 x 8 kb",
                     sw_batch(rng, 64, 8192, 10240, 0.06), 2048,
                     kernel_iters=2),
            check_sw("scores", "sw_scores band 1152, 64 x 2 kb",
                     sw_batch(rng, 64, 2048, 3200, 0.06), 1152,
                     kernel_iters=2)],
    }
    chain = check_chain("chain 16384 x 32", chain_groups(rng, 16384),
                        plain_iters=2)
    others["chain_and_extents"] = [
        check_chain("chain 4096 x 256", chain_groups(rng, 4096, 256)),
        check_chain("chain gap-cost table (dd 0..500)", beta_groups())]
    others["chain_and_extents"] += [
        check_chain(name, arrays, window=window)
        for name, arrays, window in chain_edge_groups(rng)]
    out = {"banded_sw_full": full, "banded_sw_scores": scores,
           "chain_and_extents": chain}
    for name, rec in out.items():
        rec["max_abs_err"] = max([rec["max_abs_err"]]
                                 + [o["max_abs_err"] for o in others[name]])
    return out


# ---------------------------------------------------------------------------
# phase 3


def check_accuracy(al, truth, label):
    d = al.data
    n = len(truth)
    order = np.lexsort((-d["alignment_score"], d["read_id"]))
    d = d[order]
    first = np.concatenate([[True], d["read_id"][1:] != d["read_id"][:-1]])
    best = d[first]
    tr = truth[best["read_id"]]
    ok = ((best["sequence_id"] == tr[:, 0]) & (best["strand"] == tr[:, 2])
          & (np.abs(best["sequence_from"] - tr[:, 1]) < 150))
    mapped = len(best) / n
    right = float(ok.mean()) if len(best) else 0.0
    log(f"  {label}: {len(best)}/{n} reads mapped ({100 * mapped:.2f}%), "
        f"{100 * right:.2f}% of them on the true genome/strand within 150 b")
    if mapped < 0.90 or right < 0.95:
        raise AssertionError(f"{label}: accuracy below 90% mapped / 95% "
                             f"correct")


def require_same_records(label, a, b, fields=None):
    """All 18 AlignList fields (or the given ones) equal, row for row."""
    from megapath_nano_tpu_torch.align.records import ALIGN_DTYPE

    if len(a) != len(b) or len(a) == 0:
        raise AssertionError(f"{label}: row counts {len(a)} vs {len(b)}")
    for col in fields or ALIGN_DTYPE.names:
        if not np.array_equal(a.data[col], b.data[col]):
            raise AssertionError(f"{label}: the two differ in {col}")
    log(f"  {label}: {len(fields or ALIGN_DTYPE.names)} fields equal on "
        f"{len(a)} rows")


def require_nearly_same(label, a, b, fields, max_share):
    """At most max_share of the rows differ in any of the fields (rows
    paired by position when the counts agree, else compared as sets)."""
    if len(a) == len(b):
        bad = np.zeros(len(a), bool)
        for col in fields:
            bad |= a.data[col] != b.data[col]
        n_bad = int(bad.sum())
    else:
        rows_a = {tuple(r) for r in a.data[list(fields)].tolist()}
        rows_b = {tuple(r) for r in b.data[list(fields)].tolist()}
        n_bad = len(rows_a ^ rows_b)
    share = n_bad / max(len(b), 1)
    log(f"  {label}: {n_bad} of {len(b)} rows differ ({100 * share:.3f}%, "
        f"at most {100 * max_share:.0f}% allowed)")
    if len(b) == 0 or share > max_share:
        raise AssertionError(f"{label}: {n_bad} of {len(b)} rows differ")


def stage_breakdown(aligner, reads):
    """Map one slice with CUDA events around each stage's entry point (device
    stream time between the events) and a host clock around the collect."""
    import torch

    from megapath_nano_tpu_torch.align import pipeline

    stages = {"seed": "build_groups_device", "chain": "chain_and_extents",
              "extension": "banded_sw_full"}
    events = {k: [] for k in stages}
    host = {"collect": 0.0}
    saved = {}

    def wrap_dev(stage, fn):
        def run(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            events[stage].append((s, e))
            return out
        return run

    def wrap_host(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            host["collect"] += time.perf_counter() - t0
            return out
        return run

    for stage, attr in stages.items():
        saved[attr] = getattr(pipeline, attr)
        setattr(pipeline, attr, wrap_dev(stage, saved[attr]))
    saved["fused_collect_np"] = pipeline.fused_collect_np
    pipeline.fused_collect_np = wrap_host(saved["fused_collect_np"])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aligner.map_reads(reads, emit_cigars=False)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for attr, fn in saved.items():
            setattr(pipeline, attr, fn)
    out = {k: sum(s.elapsed_time(e) for s, e in v)
           for k, v in events.items()}
    out["collect (host)"] = 1e3 * host["collect"]
    out["slice wall"] = 1e3 * total
    log("  stage times, one slice of %d reads (ms): %s" % (
        len(reads), ", ".join(f"{k} {v:.3f}" for k, v in out.items())))
    return out


def traced(fn):
    """fn() under torch.profiler. Returns (fn's result, wall ms, device
    busy ms (union of kernel and copy intervals) or None when the tracer
    recorded no device event, device events, {name: (ms, count)})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):     # the first trace pays the tracer's
        torch.zeros(1, device="cuda")  # start-up (seconds); not this one
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        total, count = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (total + ev.time_range.elapsed_us() / 1e3,
                            count + 1)
    if not spans:
        return out, wall_ms, None, 0, by_name
    spans.sort()
    busy_us, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy_us += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return out, wall_ms, (busy_us + hi - lo) / 1e3, len(spans), by_name


def profile_map(aligner, reads):
    """One more PAF-mode map under torch.profiler: the device's busy time
    (union of kernel and copy intervals), its idle share of the wall, and
    the kernel time by name."""
    _, wall_ms, busy_ms, n_events, by_name = traced(
        lambda: aligner.map_reads(reads, slice_size=4096, emit_cigars=False))
    if busy_ms is None:
        log("  profiler: no device events recorded; device time not "
            "measured")
        return
    log(f"  profiler, one traced map of {len(reads)} reads: wall "
        f"{wall_ms:.2f} ms, device events {n_events}, summed "
        f"{sum(t for t, _ in by_name.values()):.2f} ms, busy (union) "
        f"{busy_ms:.2f} ms, idle share {100 - 100 * busy_ms / wall_ms:.2f}%")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for rank, (name, (total, count)) in enumerate(ranked):
        if rank < 8 or "sw_full" in name or "chain_kernel" in name:
            log(f"    {total:9.3f} ms  {count:5d} x  {name[:90]}")


def phase_map(rng):
    import torch

    from megapath_nano_tpu_torch.align.pipeline import MinimizerAligner
    from megapath_nano_tpu_torch.index.minimizer import MinimizerIndex
    from megapath_nano_tpu_torch.kernels.chain import chain_and_extents
    from megapath_nano_tpu_torch.kernels.sw import (banded_sw_full,
                                                    banded_sw_scores)

    log("phase 3: map path at 128 Mbp")
    t0 = time.perf_counter()
    genomes = [rng.integers(0, 4, 4_000_000).astype(np.int8)
               for _ in range(32)]
    index = MinimizerIndex.build(genomes, [f"genome{i}" for i in range(32)],
                                 k=15, w=10)
    log(f"  index: {sum(map(len, genomes))} bases, {len(index.keys)} "
        f"minimizers, built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reads, truth = simulate_reads(rng, genomes, 32768, 1000, 0.06)
    log(f"  simulated 32768 reads in {time.perf_counter() - t0:.1f} s")

    aligner = MinimizerAligner(index)     # the default device is the card
    t0 = time.perf_counter()
    aligner.map_reads(reads, slice_size=4096, emit_cigars=False)
    torch.cuda.synchronize()
    log(f"  warm-up (the same reads; planes upload and allocator growth "
        f"included): {time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    banded_sw_full.launches = 0
    chain_and_extents.launches = 0
    banded_sw_scores.launches = 0
    t0 = time.perf_counter()
    res = aligner.map_reads(reads, slice_size=4096, emit_cigars=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"banded_sw_full": banded_sw_full.launches,
                "chain_and_extents": chain_and_extents.launches}
    all_launches = dict(launches,
                        banded_sw_scores=banded_sw_scores.launches)
    log(f"  timed run: 32768 reads in {dt:.3f} s = "
        f"{32768 / dt:.1f} reads/s; launches {launches}; "
        f"overflow_stats {aligner.overflow_stats}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel was not launched on the path: "
                             f"{launches}")
    check_accuracy(res, truth, "1 kb reads")
    again = []
    for _ in range(4):
        t0 = time.perf_counter()
        aligner.map_reads(reads, slice_size=4096, emit_cigars=False)
        torch.cuda.synchronize()
        again.append(32768 / (time.perf_counter() - t0))
    log("  four more maps of the same reads: "
        + ", ".join(f"{x:.1f}" for x in again) + " reads/s")
    stage_breakdown(aligner, reads[:4096])
    profile_map(aligner, reads)

    long_reads, long_truth = simulate_reads(rng, genomes, 2048, 4000, 0.06)
    before = dict(sw=banded_sw_full.launches, chain=chain_and_extents.launches)
    t0 = time.perf_counter()
    res4 = aligner.map_reads(long_reads, slice_size=4096, emit_cigars=False)
    torch.cuda.synchronize()
    log(f"  4 kb reads (band 256): 2048 reads in "
        f"{time.perf_counter() - t0:.3f} s (first call at this shape)")
    if banded_sw_full.launches == before["sw"] or \
            chain_and_extents.launches == before["chain"]:
        raise AssertionError("4 kb map did not launch both kernels")
    check_accuracy(res4, long_truth, "4 kb reads")
    return index, genomes, aligner, reads, truth, all_launches


# ---------------------------------------------------------------------------
# phase 4


def phase_card_vs_cpu(index, aligner, reads):
    from megapath_nano_tpu_torch.align.pipeline import MinimizerAligner

    log("phase 4: card vs CPU (plain versions), 512 reads, PAF mode")
    sub = reads[:512]
    gpu = aligner.map_reads(sub, emit_cigars=False)
    t0 = time.perf_counter()
    cpu = MinimizerAligner(index, device="cpu").map_reads(sub,
                                                          emit_cigars=False)
    log(f"  CPU map: {time.perf_counter() - t0:.1f} s")
    require_same_records("card vs CPU", gpu, cpu)


def phase_cap_overflow(index, reads):
    """The PAF-mode map with the device-seeding caps cut to a quarter, on
    the card and on the CPU: slices overflow, the reads behind the cutoff
    are redone through the host-seeded fused dispatch (the chain kernel on
    redo-shaped groups), the cap scales adapt. Records, overflow statistics
    and scales must agree."""
    from megapath_nano_tpu_torch.align.pipeline import MinimizerAligner
    from megapath_nano_tpu_torch.kernels.chain import chain_and_extents

    log("phase 4b: cap overflow and partial redo, 2048 reads, card vs CPU")

    def quarter_caps(slice_n, read_max, occ=0.0):
        return tuple(c // 4 for c in MinimizerAligner._devseed_caps(
            slice_n, read_max, occ))

    sub = reads[:2048]
    out = {}
    for device in ("cuda", "cpu"):
        al = MinimizerAligner(index, device=device)
        al._devseed_caps = quarter_caps
        before = chain_and_extents.launches
        t0 = time.perf_counter()
        res = al.map_reads(sub, slice_size=512, emit_cigars=False)
        log(f"  {device}: {time.perf_counter() - t0:.1f} s, overflow_stats "
            f"{al.overflow_stats}, cap scales {al._cap_scales}, chain "
            f"launches {chain_and_extents.launches - before}")
        out[device] = (res, dict(al.overflow_stats), dict(al._cap_scales))
    (gpu, gpu_stats, gpu_scales), (cpu, cpu_stats, cpu_scales) = \
        out["cuda"], out["cpu"]
    if gpu_stats["reads_redone"] < 1:
        raise AssertionError(f"no read was redone: {gpu_stats}")
    if gpu_stats != cpu_stats or gpu_scales != cpu_scales:
        raise AssertionError(f"card and CPU differ: {gpu_stats} / "
                             f"{cpu_stats}, {gpu_scales} / {cpu_scales}")
    require_same_records("cap overflow, card vs CPU", gpu, cpu)


# ---------------------------------------------------------------------------
# phase 5


def check_cigars(al, label):
    """Every record has its CIGAR under the 3-key, and the CIGAR spans the
    record: M+I = read interval, M+D = sequence interval."""
    if not al.cigar_map:
        raise AssertionError(f"{label}: no cigar_map")
    for row in al.data:
        key = (int(row["read_id"]), int(row["sequence_id"]),
               int(row["sequence_from"]))
        cigar, _oriented_from, strand = al.cigar_map[key]
        q = sum(n for n, op in cigar if op in "MI")
        t = sum(n for n, op in cigar if op in "MD")
        if q != row["read_to"] - row["read_from"] \
                or t != row["sequence_to"] - row["sequence_from"] \
                or strand != row["strand"]:
            raise AssertionError(f"{label}: CIGAR of {key} does not span "
                                 f"its record")
    log(f"  {label}: {len(al)} CIGARs span their records")


def traced_cigar_map(aligner, reads, label):
    """Map `reads` in one piece (no worker threads) with a timer on each
    stage of the host-chained path, and keep every pair the native
    traceback was given. Then hold the traceback's final score of each pair
    to the score-only kernel's score for the same pair, computed again on
    the card at the map's band. Returns the AlignList."""
    import torch

    from megapath_nano_tpu_torch.align import pipeline
    from megapath_nano_tpu_torch.kernels.sw import banded_sw_scores

    dev_events = {"chain chunks": [], "device scores": []}
    host_s = {"collect_anchors": 0.0, "pack_groups": 0.0,
              "native traceback": 0.0, "select_alignments": 0.0}
    traced = {}     # (id(read), id(ref)) -> [read, ref, native score]
    bands = []
    saved = {n: getattr(pipeline, n) for n in (
        "chain_and_extents", "banded_sw_scores", "collect_anchors",
        "pack_groups", "banded_align_batch", "select_alignments")}

    def timed_dev(stage, fn):
        def run(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            dev_events[stage].append((s, e))
            if stage == "device scores":
                bands.append(kw["band"])
            return out
        return run

    def timed_host(stage, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            host_s[stage] += time.perf_counter() - t0
            if stage == "native traceback":   # the redo overwrites
                for r, t, aln in zip(a[0], a[1], out):
                    traced[(id(r), id(t))] = [r, t, aln.score]
            return out
        return run

    pipeline.chain_and_extents = timed_dev("chain chunks",
                                           saved["chain_and_extents"])
    pipeline.banded_sw_scores = timed_dev("device scores",
                                          saved["banded_sw_scores"])
    pipeline.collect_anchors = timed_host("collect_anchors",
                                          saved["collect_anchors"])
    pipeline.pack_groups = timed_host("pack_groups", saved["pack_groups"])
    pipeline.banded_align_batch = timed_host("native traceback",
                                             saved["banded_align_batch"])
    pipeline.select_alignments = timed_host("select_alignments",
                                            saved["select_alignments"])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = aligner.map_reads(reads, emit_cigars=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for n, fn in saved.items():
            setattr(pipeline, n, fn)
    out = {k: sum(s.elapsed_time(e) for s, e in v)
           for k, v in dev_events.items()}
    busy = sum(out.values())
    out.update({k + " (host)": 1e3 * v for k, v in host_s.items()})
    out["Python record loops and uploads (host, the rest)"] = \
        1e3 * wall - busy - 1e3 * sum(host_s.values())
    out["wall"] = 1e3 * wall
    log("  %s, stage times for one piece of %d reads (ms): %s" % (
        label, len(reads), ", ".join(f"{k} {v:.3f}" for k, v in out.items())))
    log(f"  {label}: {len(reads) / wall:.1f} reads/s in one thread; the two "
        f"kernels keep the device busy {100 * busy / (1e3 * wall):.2f}% of "
        f"the wall (idle share {100 - 100 * busy / (1e3 * wall):.2f}%, "
        f"copies not counted)")

    # native score against the device score, pair by pair
    if len(set(bands)) != 1:
        raise AssertionError(f"{label}: bands {set(bands)}")
    band = bands[0]
    pairs = list(traced.values())
    if len(pairs) != len(res):
        raise AssertionError(f"{label}: {len(pairs)} pairs traced for "
                             f"{len(res)} records")
    q_max = max(256, 1 << (max(len(r) for r, _, _ in pairs) - 1).bit_length())
    t_max = max(q_max,
                1 << (max(len(t) for _, t, _ in pairs) - 1).bit_length())
    dev = torch.device("cuda")
    worst = 0
    for s0 in range(0, len(pairs), 1024):
        chunk = pairs[s0: s0 + 1024]
        ra = np.full((len(chunk), q_max), 4, np.int8)
        ta = np.full((len(chunk), t_max), 5, np.int8)
        for j, (r, t, _) in enumerate(chunk):
            ra[j, : len(r)] = r
            ta[j, : len(t)] = t
        rl = np.array([len(r) for r, _, _ in chunk], np.int32)
        tl = np.array([len(t) for _, t, _ in chunk], np.int32)
        sc, _, _ = banded_sw_scores(*(torch.from_numpy(x).to(dev)
                                      for x in (ra, rl, ta, tl)), band=band,
                                    **SW_PARAMS)
        native = np.array([x for _, _, x in chunk], np.int64)
        worst = max(worst, int(np.abs(sc.cpu().numpy() - native).max()))
    if worst:
        raise AssertionError(f"{label}: native traceback score differs from "
                             f"the device score by up to {worst}")
    log(f"  {label}: native score == device score on all {len(pairs)} "
        f"traced pairs (band {band})")
    return res


def phase_cigar_map(rng, index, genomes, aligner, reads, truth):
    import torch

    from megapath_nano_tpu_torch.align.pipeline import (AlignParams,
                                                        MinimizerAligner)
    from megapath_nano_tpu_torch.kernels.chain import chain_and_extents
    from megapath_nano_tpu_torch.kernels.sw import (banded_sw_full,
                                                    banded_sw_scores)
    from megapath_nano_tpu_torch.report.samout import write_sam

    log("phase 5: CIGAR-mode map at 128 Mbp (host-chained path)")
    n = 8192
    sub, sub_truth = reads[:n], truth[:n]
    t0 = time.perf_counter()
    aligner.map_reads(sub[:2048], slice_size=1024)
    torch.cuda.synchronize()
    log(f"  warm-up (2048 reads): {time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    chain_and_extents.launches = 0
    banded_sw_scores.launches = 0
    banded_sw_full.launches = 0
    t0 = time.perf_counter()
    res = aligner.map_reads(sub, slice_size=4096, emit_cigars=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"chain_and_extents": chain_and_extents.launches,
                "banded_sw_scores": banded_sw_scores.launches}
    all_launches = dict(launches, banded_sw_full=banded_sw_full.launches)
    log(f"  timed run: {n} reads, slice 4096, two threads, in {dt:.3f} s = "
        f"{n / dt:.1f} reads/s; launches {launches} (sw_full "
        f"{banded_sw_full.launches}); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel was not launched on the path: "
                             f"{launches}")
    check_accuracy(res, sub_truth, "1 kb reads, CIGAR mode")
    check_cigars(res, "1 kb reads")
    again = []
    for _ in range(2):
        t0 = time.perf_counter()
        aligner.map_reads(sub, slice_size=4096, emit_cigars=True)
        torch.cuda.synchronize()
        again.append(n / (time.perf_counter() - t0))
    log("  two more maps of the same reads: "
        + ", ".join(f"{x:.1f}" for x in again) + " reads/s")
    # PAF mode through the same host-chained path (fused dispatch off):
    # the same candidates and windows, every field from the full-stats
    # kernel instead of the traceback, so the 11 fields are equal exactly
    unfused = MinimizerAligner(index, params=AlignParams(fused=False))
    before = banded_sw_full.launches
    paf_u = unfused.map_reads(sub, slice_size=4096, emit_cigars=False)
    log(f"  PAF outside the fused gate: {banded_sw_full.launches - before} "
        f"sw_full launches for {n} reads")
    if banded_sw_full.launches == before:
        raise AssertionError("the unfused PAF map did not launch sw_full")
    require_same_records("PAF outside the fused gate vs CIGAR mode", paf_u,
                         res, PAF_FIELDS)
    # the fused PAF map seeds on the device and caps a group at 32 anchors,
    # so a few windows differ by a few bases from the host-chained ones (in
    # the reference as well); held to at most 1% of rows
    paf = aligner.map_reads(sub, slice_size=4096, emit_cigars=False)
    require_nearly_same("fused PAF mode vs CIGAR mode", paf, res, PAF_FIELDS,
                        0.01)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.sam")
        write_sam(path, res, sub, index.seq_lengths)
        with open(path) as f:
            n_rec = sum(1 for line in f if not line.startswith("@"))
        size = os.path.getsize(path)
    if n_rec != len(res):
        raise AssertionError(f"SAM has {n_rec} records for {len(res)} rows")
    log(f"  SAM written: {n_rec} records, {size} bytes")

    one = traced_cigar_map(aligner, sub[:4096], "1 kb slice")
    first = res.data[res.data["read_id"] < 4096]
    if not np.array_equal(one.data, first):
        raise AssertionError("the traced slice differs from the timed run")

    long_reads, long_truth = simulate_reads(rng, genomes, 512, 4000, 0.06)
    res4 = traced_cigar_map(aligner, long_reads, "4 kb reads (band 256)")
    check_accuracy(res4, long_truth, "4 kb reads, CIGAR mode")
    check_cigars(res4, "4 kb reads")

    ultra, ultra_truth = simulate_reads(rng, genomes, 8, 40000, 0.06)
    t0 = time.perf_counter()
    res40 = traced_cigar_map(aligner, ultra, "40 kb reads (band 512)")
    check_accuracy(res40, ultra_truth, "40 kb reads, CIGAR mode")
    check_cigars(res40, "40 kb reads")
    before = banded_sw_scores.launches
    paf40 = aligner.map_reads(ultra, emit_cigars=False)
    if banded_sw_scores.launches == before or paf40.cigar_map is not None:
        raise AssertionError("40 kb PAF map must go through sw_scores")
    require_same_records("40 kb, PAF mode vs CIGAR mode", paf40, res40)
    return all_launches, n / dt


# ---------------------------------------------------------------------------
# phase 6


def phase_cigar_card_vs_cpu(index, aligner, reads):
    from megapath_nano_tpu_torch.align.pipeline import MinimizerAligner

    log("phase 6: card vs CPU (plain versions), 256 reads, CIGAR mode")
    sub = reads[:256]
    gpu = aligner.map_reads(sub, slice_size=128)
    t0 = time.perf_counter()
    cpu = MinimizerAligner(index, device="cpu").map_reads(sub, slice_size=128)
    log(f"  CPU map: {time.perf_counter() - t0:.1f} s")
    require_same_records("card vs CPU", gpu, cpu)
    if gpu.cigar_map != cpu.cigar_map or not gpu.cigar_map:
        raise AssertionError("card and CPU differ in cigar_map")
    log(f"  cigar_map equal ({len(gpu.cigar_map)} entries)")


# ---------------------------------------------------------------------------
# phases 7 and 8: the taxon profile through the CLI


def taxon_world(rng, n_genus, per_genus, glen, divergence=(0.03, 0.08)):
    """n_genus random ancestors of glen bases; each species a copy of its
    genus ancestor mutated at a rate drawn from `divergence` (mutate_fast).
    Returns (genomes, tax triples (tax, species, genus), tax names)."""
    genomes, tax, names = [], [], {}
    for g in range(n_genus):
        ancestor = rng.integers(0, 4, glen).astype(np.int8)
        for k in range(per_genus):
            s = g * per_genus + k
            genomes.append(mutate_fast(rng, ancestor,
                                       float(rng.uniform(*divergence))))
            tax.append((1000 + s, 100 + s, 10 + g))
            names[100 + s] = f"Species {g}-{k}"
    return genomes, tax, names


def mixed_reads(rng, sources, counts, length, err):
    """counts[i] reads of `length` from sources[i] at error rate err, half
    reverse-complemented, shuffled. Returns (reads, source index a read)."""
    from megapath_nano_tpu_torch.utils.dna import revcomp

    reads, origin = [], []
    for i, (genome, n) in enumerate(zip(sources, counts)):
        for _ in range(int(n)):
            s = int(rng.integers(0, len(genome) - length))
            r = mutate_fast(rng, genome[s: s + length], err)
            reads.append(revcomp(r) if rng.integers(0, 2) else r)
            origin.append(i)
    order = rng.permutation(len(reads))
    return [reads[i] for i in order], np.asarray(origin)[order]


def write_query(path, reads, rng):
    """The reads as FASTQ with per-base qualities (phred 12..34)."""
    from megapath_nano_tpu_torch.io.fastq import write_fastq

    write_fastq(path, [f"read{i}" for i in range(len(reads))], reads,
                [rng.integers(12, 35, len(r)).astype(np.int8)
                 for r in reads])


def save_refdb(genomes, tax, tax_names, prefix, path):
    from megapath_nano_tpu_torch.db.refdb import RefDB

    t0 = time.perf_counter()
    n = len(genomes)
    db = RefDB.build(genomes, [f"{prefix}{i}" for i in range(n)],
                     list(range(n)), [f"asm_{prefix}{i}" for i in range(n)],
                     tax, tax_names)
    t1 = time.perf_counter()
    db.save(path)
    log(f"  RefDB {path}: {sum(map(len, genomes))} bases, "
        f"{len(db.index.keys)} minimizers, built in {t1 - t0:.1f} s, "
        f"saved in {time.perf_counter() - t1:.1f} s")


def kernel_wrappers():
    """{kernel name: its wrapper}; each wrapper counts its launches in
    `.launches`."""
    from megapath_nano_tpu_torch.kernels.chain import chain_and_extents
    from megapath_nano_tpu_torch.kernels.sw import (banded_sw_full,
                                                    banded_sw_scores)

    return {"banded_sw_full": banded_sw_full,
            "chain_and_extents": chain_and_extents,
            "banded_sw_scores": banded_sw_scores}


def run_cli(args):
    """megapath_nano_tpu_torch.cli.main.main(args) with the three launch
    counts set to 0 before. Returns (wall s, launches)."""
    import torch

    from megapath_nano_tpu_torch.cli.main import main as cli_main

    kernels = kernel_wrappers()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    rc = cli_main(args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.main exited with {rc}: {args}")
    return dt, {name: k.launches for name, k in kernels.items()}


def log_timing(path):
    with open(path) as f:
        steps = [line.split("\t") for line in f.read().split("\n") if line]
    log("  time by step (.timing, s): " + ", ".join(
        f"{name} {float(sec):.3f}" for name, sec in steps))


def read_tsv(path):
    with open(path) as f:
        header, *rows = [line.rstrip("\n").split("\t") for line in f]
    return header, rows


# the files a profile run with the default flags writes (no human or decoy
# DB, no noise gate), after the prefix
PROFILE_SURFACE = (
    ".assembly_selection", ".bam_filter", ".bam_filter_good",
    ".genome_set", ".id_stat", ".microbe_stat",
    ".microbe_stat_by_sequence_id", ".noise.tar.gz", ".per_read.tar.gz",
    ".preport", ".quality_score.tar.gz", ".raw_stat", ".read_count_by_name",
    ".read_length.tar.gz", ".read_stat", ".species.paf", ".timing")


def phase_profile(rng, work):
    """Phase 7: 32 genomes of 4 Mbp (8 genera x 4 species), 32768 reads of
    1 kb in a geometric mix over the species, the CLI with its default
    flags on the card."""
    log("phase 7: taxon profile at 128 Mbp through the CLI, on the card")
    t0 = time.perf_counter()
    genomes, tax, tax_names = taxon_world(rng, 8, 4, 4_000_000)
    n_sp, n_reads = len(genomes), 32768
    weights = 0.75 ** np.arange(n_sp)
    counts = np.floor(n_reads * weights / weights.sum()).astype(np.int64)
    counts[0] += n_reads - counts.sum()
    rank = rng.permutation(n_sp)           # species rank[i] gets counts[i]
    by_species = np.zeros(n_sp, np.int64)
    by_species[rank] = counts
    reads, origin = mixed_reads(rng, genomes, by_species, 1000, 0.06)
    log(f"  world and reads: {time.perf_counter() - t0:.1f} s; reads a "
        f"species, top 8: {counts[:8].tolist()}")
    db_dir, out = os.path.join(work, "db128"), os.path.join(work, "out128")
    save_refdb(genomes, tax, tax_names, "g", db_dir)
    del genomes
    query = os.path.join(work, "reads128.fastq")
    t0 = time.perf_counter()
    write_query(query, reads, rng)
    log(f"  FASTQ written in {time.perf_counter() - t0:.1f} s")
    (dt, launches), _, busy_ms, n_events, _ = traced(lambda: run_cli(
        ["--query", query, "--db", db_dir, "--output_folder", out,
         "--output_prefix", "p"]))
    log(f"  cli.main: {dt:.3f} s wall for {n_reads} reads "
        f"({n_reads / dt:.1f} reads/s end to end); launches {launches}")
    if busy_ms is None:
        log("  profiler: no device events recorded; device time not "
            "measured")
    else:
        log(f"  profiler: {n_events} device events, device busy (union) "
            f"{busy_ms:.2f} ms, idle share "
            f"{100 - 100 * busy_ms / (1e3 * dt):.3f}% of the run's wall")
    log_timing(os.path.join(out, "p.timing"))
    if launches["banded_sw_full"] < 1 or launches["chain_and_extents"] < 1:
        raise AssertionError(f"profile did not launch the PAF kernels: "
                             f"{launches}")
    missing = [x for x in PROFILE_SURFACE
               if not os.path.exists(os.path.join(out, "p" + x))]
    if missing:
        raise AssertionError(f"profile output files missing: {missing}")
    header, rows = read_tsv(os.path.join(out, "p.read_stat"))
    stat = dict(zip(header, rows[0]))
    total, aligned = int(stat["total_number_of_read"]), int(stat["aligned"])
    if total != n_reads:
        raise AssertionError(f"{total} reads reached the profile, not "
                             f"{n_reads}")
    header, rows = read_tsv(os.path.join(out, "p.bam_filter"))
    rid, sp = header.index("read_id"), header.index("species_tax_id")
    right = sum(int(r[sp]) == 100 + int(origin[int(r[rid])]) for r in rows)
    log(f"  {aligned}/{total} reads aligned ({100 * aligned / total:.2f}%), "
        f"{right}/{len(rows)} best alignments on the true species "
        f"({100 * right / max(len(rows), 1):.2f}%)")
    if aligned < 0.9 * total or right < 0.9 * len(rows):
        raise AssertionError("profile below 90% aligned / 90% on the true "
                             "species")
    _, rows = read_tsv(os.path.join(out, "p.preport"))
    got = [int(r[0]) for r in rows[:8]]
    want = [100 + int(s) for s in rank[:8]]
    log(f"  .preport top 8 {got}, the mix's top 8 {want}")
    if got != want:
        raise AssertionError("the .preport does not rank the top 8 species "
                             "in the order of the mix")
    return launches


def same_outputs(dir_a, dir_b):
    """The same file names; archives equal member by member (their headers
    stamp times); every other file byte-equal; .timing (wall times) only
    present on both. Returns the names."""
    import tarfile

    names = sorted(os.listdir(dir_a))
    if names != sorted(os.listdir(dir_b)):
        raise AssertionError(f"file lists differ: {names} / "
                             f"{sorted(os.listdir(dir_b))}")

    def members(path):
        with tarfile.open(path) as t:
            return {m.name: t.extractfile(m).read() if m.isfile() else m.type
                    for m in t.getmembers()}

    for n in names:
        a, b = os.path.join(dir_a, n), os.path.join(dir_b, n)
        if n.endswith(".timing"):
            continue
        if n.endswith(".tar.gz"):
            same = members(a) == members(b)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                same = fa.read() == fb.read()
        if not same:
            raise AssertionError(f"{n} differs between the two runs")
    return names


NOISE_GATES = ("--human_filter", "--reassignment", "--spike_filter",
               "--microbe_repetitive_region_filter",
               "--variable_region_adjustment", "--similar_species_marker",
               "--noise_projection", "--unique_alignment",
               "--closing_spike_filter")


def noise_inputs(rng, work):
    """Phase 8's inputs: 8 genomes of 1 Mbp (2 genera x 4 species) and a
    2 Mbp human genome as two saved RefDBs, 4096 reads of 1 kb (5% human)
    as FASTQ. Returns the CLI arguments of a run without the output folder
    and the device."""
    # species 0.5-2% from their genus ancestor: close enough for the
    # similar-species marker and the >= 98% tiers of the microbe ladder
    genomes, tax, tax_names = taxon_world(rng, 2, 4, 1_000_000,
                                          divergence=(0.005, 0.02))
    human = rng.integers(0, 4, 2_000_000).astype(np.int8)
    weights = np.array([0.30, 0.15, 0.08, 0.04, 0.20, 0.10, 0.05, 0.03])
    counts = np.round(4096 * 0.95 * weights).astype(np.int64)
    counts = np.append(counts, 4096 - counts.sum())        # human: 5%
    reads, _ = mixed_reads(rng, genomes + [human], counts, 1000, 0.06)
    db_dir, hdb_dir = os.path.join(work, "db8"), os.path.join(work, "hdb")
    save_refdb(genomes, tax, tax_names, "s", db_dir)
    save_refdb([human], [(9606, 9606, 9605)], {9606: "Homo sapiens"}, "h",
               hdb_dir)
    query = os.path.join(work, "reads8.fastq")
    write_query(query, reads, rng)
    return ["--query", query, "--db", db_dir, "--human_db", hdb_dir,
            "--output_prefix", "p", "--noise_projection_num_read_to_simulate",
            "300", *NOISE_GATES]


class BackgroundCli:
    """A CLI of the port (cli.main unless `module` names another) in a
    child process at low priority (nice 10, `threads` torch threads), so
    that a CPU run (plain versions, minutes) overlaps the card's phases,
    which keep a core or two of the host's eight busy. stop() kills the
    child if it still runs."""

    def __init__(self, args, log_path,
                 module="megapath_nano_tpu_torch.cli.main", threads=6):
        env = dict(os.environ, OMP_NUM_THREADS=str(threads),
                   PYTHONPATH=os.pathsep.join(
                       [sys.path[0], os.environ.get("PYTHONPATH", "")]))
        self.log_path = log_path
        self._log = open(log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            ["nice", "-n", "10", sys.executable, "-m", module, *args],
            env=env, stdout=self._log, stderr=subprocess.STDOUT)

    def wait(self, timeout):
        """Wait for the child; raise unless it exits with 0. Returns the
        seconds from its start to its end."""
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            self.stop()
        if rc != 0:
            with open(self.log_path) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"background CLI exited with {rc}:\n{tail}")
        return time.perf_counter() - self.t0

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._log.close()


def phase_profile_noise(work, args, cpu_run):
    """Phase 8: the CLI with the noise stack's gates on, once on the card
    (here) and once on the CPU (cpu_run, started before phase 7): the same
    files."""
    log("phase 8: taxon profile with the noise stack, card vs CPU")
    card_out = os.path.join(work, "noise_cuda")
    wall, launches = run_cli([*args, "--output_folder", card_out,
                              "--device", "cuda"])
    log(f"  --device cuda: {wall:.3f} s wall, launches {launches}")
    log_timing(os.path.join(card_out, "p.timing"))
    cpu_wall = cpu_run.wait(timeout=900)
    cpu_out = os.path.join(work, "noise_cpu")
    log(f"  --device cpu (child process, started before phase 7): "
        f"{cpu_wall:.3f} s from its start to its end")
    log_timing(os.path.join(cpu_out, "p.timing"))
    names = same_outputs(card_out, cpu_out)
    log(f"  {len(names)} files, equal between the card and the CPU: "
        f"{', '.join(names)}")
    header, rows = read_tsv(os.path.join(card_out, "p.read_stat"))
    log("  read_stat: " + ", ".join(f"{h} {v}"
                                    for h, v in zip(header, rows[0])))
    for name in sorted(os.listdir(card_out)):
        if name.endswith("noise.bed") or name in ("p.similar_species",
                                                   "p.noise_projection"):
            with open(os.path.join(card_out, name)) as f:
                log(f"  {name}: {sum(1 for _ in f)} lines")
    if launches["banded_sw_scores"] < 1:
        raise AssertionError(f"the noise stack did not launch sw_scores: "
                             f"{launches}")
    return launches


def phase_profiles(rng, between=None):
    """Phases 7 and 8 in a scratch directory that is removed after: phase
    8's inputs first and its CPU run started in the background, then phase
    7, then `between()` (the full smoke's phases 9 and 10, which so overlap
    the CPU run instead of waiting after it), then phase 8's card run and
    the comparison. Returns (the kernels' launch counts on the profile
    path: phase 7's run and phase 8's card run; between()'s result)."""
    with tempfile.TemporaryDirectory(prefix="mpn_profile_") as work:
        args = noise_inputs(rng, work)
        cpu_run = BackgroundCli(
            [*args, "--output_folder", os.path.join(work, "noise_cpu"),
             "--device", "cpu"], os.path.join(work, "noise_cpu.log"))
        try:
            launches7 = phase_profile(rng, work)
            got = between() if between else None
            launches8 = phase_profile_noise(work, args, cpu_run)
        finally:
            cpu_run.stop()
    return {k: launches7[k] + launches8[k] for k in launches7}, got


# ---------------------------------------------------------------------------
# phases 9 and 10: AMR through the CLI, and the sharded index


# phase 9's world: genome and plasmid lengths, genes in the DB, reads over
# the 6 species' genomes, around the 16 chromosomal loci and from the
# plasmid; phase 10's reads for ShardedAligner card against CPU
AMR_SIZES = dict(genome=4_000_000, plasmid=64_000, genes=3000, whole=4096,
                 local=6144, plasmid_reads=2048, shard_reads=256)
# the device of the phases' card runs; their CPU runs name "cpu"
CARD = "cuda"
# the drugs of phase 9's gene DB, already in canonical form (no trailing
# "s", no dash: amr.db.canonical_drug leaves them as they are)
AMR_DRUGS = ("AMIKACIN", "AMPICILLIN", "CEFTAZIDIME", "CHLORAMPHENICOL",
             "CIPROFLOXACIN", "COLISTIN", "ERYTHROMYCIN", "GENTAMICIN",
             "MEROPENEM", "RIFAMPICIN", "TETRACYCLINE", "VANCOMYCIN")


class StepLaunches:
    """Count the three kernels' launches inside every step of a CLI run:
    Log.step of the port is wrapped so that each step adds the launches
    made between its start and its end to launches[step name]. The AMR
    module's run_amr is wrapped as well, to keep its consensus contigs'
    lengths, and the parts of the amr step are timed on the host clock
    (seconds[name]): the gene DBs' load and run_amr's consensus and
    scan."""

    def __init__(self):
        from megapath_nano_tpu_torch.amr import module as amr_module
        from megapath_nano_tpu_torch.amr.db import AMRGeneDB
        from megapath_nano_tpu_torch.utils.log import Log

        self.kernels = kernel_wrappers()
        self.launches, self.contigs = {}, []
        self._log, self._step = Log, Log.step
        self._module = amr_module
        self._run_amr = amr_module.run_amr
        # name -> (owner, attribute, the attribute as stored, the function)
        self._timed = {
            name: (owner, attr, vars(owner)[attr], getattr(owner, attr))
            for name, owner, attr in (
                ("AMRGeneDB.load", AMRGeneDB, "load"),
                ("consensus_contigs", amr_module, "consensus_contigs"),
                ("scan_contigs", amr_module, "scan_contigs"))}
        self.seconds = dict.fromkeys(self._timed, 0.0)

    def __enter__(self):
        import contextlib

        outer, step = self, self._step

        @contextlib.contextmanager
        def counted(log_self, name):
            before = {k: f.launches for k, f in outer.kernels.items()}
            with step(log_self, name):
                yield
            got = outer.launches.setdefault(name, dict.fromkeys(before, 0))
            for k, f in outer.kernels.items():
                got[k] += f.launches - before[k]

        def run_amr(*args, **kw):
            res = outer._run_amr(*args, **kw)
            outer.contigs = [len(c.seq) for c in res.contigs]
            return res

        def timed(name, fn):
            def call(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    outer.seconds[name] += time.perf_counter() - t0
            return call

        self._log.step = counted
        self._module.run_amr = run_amr
        for name, (owner, attr, stored, fn) in self._timed.items():
            call = timed(name, fn)
            setattr(owner, attr, staticmethod(call)
                    if isinstance(stored, staticmethod) else call)
        return self

    def __exit__(self, *exc):
        self._log.step = self._step
        self._module.run_amr = self._run_amr
        for owner, attr, stored, _ in self._timed.values():
            setattr(owner, attr, stored)


def cut_gene(rng, genome, lo=800, hi=1500, margin=10_000):
    n = int(rng.integers(lo, hi + 1))
    s = int(rng.integers(margin, len(genome) - margin - n))
    return genome[s: s + n].copy(), s


def amr_world(rng, work):
    """Phase 9's inputs, written under `work`: 8 genomes of 4 Mbp (4 genera
    x 2 species, 3-8% from their genus ancestor) and a 64 kb plasmid as the
    second sequence of species 1's assembly, as FASTA with a metadata
    table; a gene DB of 3000 genes as FASTA with a phenotype table (24
    genes of 800-1500 b: 16 cut from the chromosomes of the 6 species of
    genera 1-3, 4 from the plasmid, 4 from the 2 species of genus 4, which
    get no reads; a homolog of each at 20% substitutions; random genes for
    the rest; 1-3 drugs a gene of 12); 12288 reads of 1 kb at 6% error
    (4096 over the 6 species' genomes, 6144 from +-6 kb around the 16
    chromosomal loci, 2048 from the plasmid) as FASTQ. Returns (paths,
    {present gene: drugs}, names of the genes that must not be called, the
    4096 whole-genome reads)."""
    from megapath_nano_tpu_torch.io.fastq import write_fasta

    t0 = time.perf_counter()
    size = AMR_SIZES
    genomes, tax, tax_names = taxon_world(rng, 4, 2, size["genome"])
    plasmid = rng.integers(0, 4, size["plasmid"]).astype(np.int8)
    fastas = []
    for i, g in enumerate(genomes):
        path = os.path.join(work, f"asm{i}.fna")
        names, seqs = [f"chr{i}"], [g]
        if i == 1:
            names, seqs = names + ["plasmid1"], seqs + [plasmid]
        write_fasta(path, names, seqs)
        fastas.append(path)
    meta = os.path.join(work, "assemblies.tsv")
    with open(meta, "w") as f:
        for i, (t, sp, gn) in enumerate(tax):
            f.write(f"asm{i}\t{t}\t{sp}\t{gn}\t{tax_names[sp]}\n")

    genes, names, present = [], [], {}
    loci = []                       # (species, start, length) of each locus
    per_species = (3, 3, 3, 3, 2, 2)
    for sp, k in enumerate(per_species):
        for _ in range(k):
            gene, s = cut_gene(rng, genomes[sp])
            loci.append((sp, s, len(gene)))
            genes.append(gene)
            names.append(f"amrC{len(names)}")
    for _ in range(4):
        genes.append(cut_gene(rng, plasmid, margin=2000)[0])
        names.append(f"amrP{len(names)}")
    for sp in (6, 6, 7, 7):
        genes.append(cut_gene(rng, genomes[sp])[0])
        names.append(f"amrA{len(names)}")
    for j in range(24):
        hom = genes[j].copy()
        hit = rng.random(len(hom)) < 0.20
        hom[hit] = (hom[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        genes.append(hom)
        names.append(f"hom{j}")
    while len(genes) < size["genes"]:
        genes.append(rng.integers(0, 4, int(rng.integers(800, 1501))
                                  ).astype(np.int8))
        names.append(f"rnd{len(genes)}")
    drugs = [[str(d) for d in rng.choice(AMR_DRUGS, int(rng.integers(1, 4)),
                                         replace=False)] for _ in genes]
    present = {names[j]: drugs[j] for j in range(20)}
    absent = set(names[20:])
    gene_fa = os.path.join(work, "genes.fna")
    write_fasta(gene_fa, names, genes)
    pheno = os.path.join(work, "pheno.tsv")
    with open(pheno, "w") as f:
        for n, d in zip(names, drugs):
            f.write(f"{n}\t{';'.join(d)}\n")

    n_whole = size["whole"]
    whole, _ = mixed_reads(rng, genomes[:6], [n_whole // 6] * 5
                           + [n_whole - 5 * (n_whole // 6)], 1000, 0.06)
    around = [genomes[sp][s - 6000: s + n + 6000] for sp, s, n in loci]
    local, _ = mixed_reads(rng, around, [size["local"] // 16] * 16, 1000,
                           0.06)
    plas, _ = mixed_reads(rng, [plasmid], [size["plasmid_reads"]], 1000,
                          0.06)
    reads = whole + local + plas
    order = rng.permutation(len(reads))
    query = os.path.join(work, "amr_reads.fastq")
    write_query(query, [reads[i] for i in order], rng)
    query4096 = os.path.join(work, "genome_reads.fastq")
    write_query(query4096, whole, rng)
    log(f"  world, gene DB and reads written in "
        f"{time.perf_counter() - t0:.1f} s: {len(genomes)} genomes + a "
        f"{len(plasmid)} b plasmid, {len(genes)} genes, {len(reads)} reads")
    return (dict(fastas=fastas, meta=meta, genes=gene_fa, pheno=pheno,
                 query=query, query4096=query4096), present, absent, whole)


def build_dbs(paths, work):
    """The RefDB and the gene DB, built and saved by the port's
    cli.build_db. Returns their directories."""
    from megapath_nano_tpu_torch.cli import build_db

    refdb, amrdb = os.path.join(work, "refdb"), os.path.join(work, "amrdb")
    t0 = time.perf_counter()
    argv = ["ref", "--metadata", paths["meta"], "--out", refdb]
    for fa in paths["fastas"]:
        argv += ["--fasta", fa]
    if build_db.main(argv) != 0:
        raise AssertionError("build_db ref failed")
    t1 = time.perf_counter()
    if build_db.main(["amr", "--name", "resfinder", "--fasta",
                      paths["genes"], "--phenotypes", paths["pheno"],
                      "--out", amrdb]) != 0:
        raise AssertionError("build_db amr failed")
    log(f"  cli.build_db: ref {t1 - t0:.1f} s, amr "
        f"{time.perf_counter() - t1:.1f} s")
    return refdb, amrdb


def check_amr_results(path, present, absent):
    """Every present gene in results.csv, in the row of each of its drugs;
    no gene that must not be called anywhere in the file."""
    with open(path) as f:
        rows = {line.split(",", 1)[0]: line for line in f.read().splitlines()}
    missing = [(g, d) for g, drugs in present.items() for d in drugs
               if f"{g}[" not in rows.get(d, "")]
    text = "\n".join(rows.values())
    wrong = sorted(g for g in absent if f"{g}[" in text)
    log(f"  results.csv: {len(rows) - 1} antibiotics; "
        f"{len(present) - len({g for g, _ in missing})}/{len(present)} "
        f"present genes called with all their drugs; {len(wrong)} of the "
        f"{len(absent)} absent, homolog and random genes called")
    if missing or wrong:
        raise AssertionError(f"AMR calls wrong: missing (gene, drug) "
                             f"{missing[:8]}, called but absent {wrong[:8]}")


def run_cli_amr(device, query_sam, refdb, amrdb, out):
    """megapath_nano_tpu_torch.cli.amr.main in this process. Returns (wall
    s, launches)."""
    import torch

    from megapath_nano_tpu_torch.cli import amr as cli_amr

    kernels = kernel_wrappers()
    before = {k: f.launches for k, f in kernels.items()}
    t0 = time.perf_counter()
    rc = cli_amr.main(["--query_sam", query_sam, "--db", refdb, "--amr_db",
                       amrdb, "--output_folder", out, "--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = {k: f.launches - before[k] for k, f in kernels.items()}
    if rc != 0:
        raise AssertionError(f"cli.amr --device {device} exited with {rc}")
    return dt, launched


def phase_amr(rng, work):
    """Phase 9: the CLI with --amr_db on the card, then cli.amr on its
    .species.sam on the card (here) and on the CPU (a child process, which
    runs on beside phase 10; compare_cli_amr waits for it). Returns (the
    kernels' launches inside the amr step, the paths, the RefDB directory,
    the 4096 whole-genome reads, (the CPU run, the two output
    folders))."""
    log("phase 9: AMR through the CLI at 32 Mbp, 3000 genes, on the card")
    paths, present, absent, whole = amr_world(rng, work)
    refdb, amrdb = build_dbs(paths, work)
    out = os.path.join(work, "amr_out")
    with StepLaunches() as steps:
        (dt, launches), _, busy_ms, n_events, _ = traced(lambda: run_cli(
            ["--query", paths["query"], "--db", refdb, "--amr_db", amrdb,
             "--no_adaptor_trimming", "--output_folder", out,
             "--output_prefix", "p", "--device", CARD]))
    log(f"  cli.main --amr_db: {dt:.3f} s wall; launches {launches}")
    if busy_ms is not None:
        log(f"  profiler: {n_events} device events, device busy (union) "
            f"{busy_ms:.2f} ms, idle share "
            f"{100 - 100 * busy_ms / (1e3 * dt):.3f}% of the run's wall")
    log_timing(os.path.join(out, "p.timing"))
    log("  launches by step: " + "; ".join(
        f"{name} {got}" for name, got in steps.launches.items()))
    contigs = steps.contigs
    log(f"  consensus contigs: {len(contigs)}, longest "
        f"{max(contigs, default=0)} b, {sum(contigs)} b in all")
    log("  amr step, host clock: " + ", ".join(
        f"{name} {sec:.3f} s" for name, sec in steps.seconds.items()))
    amr = steps.launches.get("amr", {})
    if amr.get("banded_sw_scores", 0) < 1 or amr.get("chain_and_extents",
                                                     0) < 1:
        raise AssertionError(f"the amr step did not launch sw_scores and "
                             f"chain: {amr}")
    sam = os.path.join(out, "p.species.sam")
    if not os.path.exists(sam):
        raise AssertionError("p.species.sam not written")
    check_amr_results(os.path.join(out, "p.results.csv"), present, absent)

    # the comparison runs on the records of species 0's chromosome and the
    # plasmid (7 genes): cli.amr's consensus walks every base of each
    # aligned target in Python, some 10 s a 4 Mbp genome
    sam = sam_subset(sam, os.path.join(work, "chr0_plasmid.sam"),
                     {"chr0", "plasmid1"})
    cpu_out = os.path.join(work, "cli_amr_cpu")
    cpu_run = BackgroundCli(["--query_sam", sam, "--db", refdb, "--amr_db",
                             amrdb, "--output_folder", cpu_out, "--device",
                             "cpu"], os.path.join(work, "cli_amr_cpu.log"),
                            module="megapath_nano_tpu_torch.cli.amr",
                            threads=2)
    card_out = os.path.join(work, "cli_amr_card")
    dt, got = run_cli_amr(CARD, sam, refdb, amrdb, card_out)
    log(f"  cli.amr --device {CARD}: {dt:.3f} s; launches {got}")
    if got["banded_sw_scores"] < 1 or got["chain_and_extents"] < 1:
        raise AssertionError(f"cli.amr on the card did not launch sw_scores "
                             f"and chain: {got}")
    return amr, paths, refdb, whole, (cpu_run, card_out, cpu_out)


def sam_subset(src, dst, names):
    """Write the SAM `src`'s header and its records on the sequences
    `names` to `dst`; returns dst."""
    with open(src) as f, open(dst, "w") as out:
        for line in f:
            if line.startswith("@") or line.split("\t", 3)[2] in names:
                out.write(line)
    return dst


def compare_cli_amr(cpu_run, card_out, cpu_out):
    """Wait for phase 9's cli.amr CPU run (a child process started with the
    card's) and hold its results.csv to the card's, byte for byte."""
    wall = cpu_run.wait(timeout=900)
    log(f"  cli.amr --device cpu (child process): {wall:.3f} s from its "
        f"start to its end")
    csv = {}
    for side, d_out in (("card", card_out), ("cpu", cpu_out)):
        with open(os.path.join(d_out, "amr.results.csv"), "rb") as f:
            csv[side] = f.read()
    if csv["card"] != csv["cpu"]:
        raise AssertionError("cli.amr results.csv differs between the card "
                             "and the CPU")
    log(f"  cli.amr results.csv equal between the card and the CPU "
        f"({len(csv['cpu'])} B, {csv['cpu'].count(b'[')} gene calls)")


def phase_sharded(paths, refdb, whole, work):
    """Phase 10: phase 9's RefDB and its 4096 whole-genome reads through
    the CLI, monolithic and with --index_shards 4 (the same .preport), then
    ShardedAligner over 4 shards on 256 of the reads, card against CPU.
    Returns the kernels' launches in the sharded CLI run."""
    from megapath_nano_tpu_torch.db.refdb import RefDB
    from megapath_nano_tpu_torch.dist.sharded_aligner import ShardedAligner

    log("phase 10: the sharded index (4 shards) against the monolithic one")
    common = ["--query", paths["query4096"], "--db", refdb, "--no_amr",
              "--no_adaptor_trimming", "--output_prefix", "p", "--device",
              CARD]
    outs, launches = {}, {}
    for label, extra in (("monolithic", []),
                         ("sharded", ["--index_shards", "4"])):
        outs[label] = os.path.join(work, f"out_{label}")
        dt, launches[label] = run_cli(common + extra
                                      + ["--output_folder", outs[label]])
        log(f"  cli.main {label}: {dt:.3f} s wall; launches "
            f"{launches[label]}")
        log_timing(os.path.join(outs[label], "p.timing"))
    with open(os.path.join(outs["monolithic"], "p.preport"), "rb") as f:
        mono = f.read()
    with open(os.path.join(outs["sharded"], "p.preport"), "rb") as f:
        shard = f.read()
    if mono != shard:
        raise AssertionError(".preport differs between the monolithic and "
                             "the sharded index")
    rows = mono.count(b"\n") - 1
    log(f"  .preport equal, monolithic vs 4 shards ({rows} species rows)")
    got = launches["sharded"]
    if got["banded_sw_full"] < 1 or got["chain_and_extents"] < 1:
        raise AssertionError(f"the sharded run did not launch sw_full and "
                             f"chain: {got}")

    db = RefDB.load(refdb)
    idx = db.index
    seqs = [idx.seq_data[idx.seq_offsets[i]: idx.seq_offsets[i + 1]]
            for i in range(len(idx.seq_names))]
    res, n = {}, AMR_SIZES["shard_reads"]
    for side, device in (("card", CARD), ("cpu", "cpu")):
        t0 = time.perf_counter()
        al = ShardedAligner.build(
            seqs, list(idx.seq_names), db.sequence_meta.assembly_idx,
            db.assembly_names, 4, meta=db.sequence_meta, k=idx.k, w=idx.w,
            device=device)
        t1 = time.perf_counter()
        res[side] = al.map_reads(whole[:n])
        log(f"  ShardedAligner --device {device}: built in {t1 - t0:.1f} s, "
            f"{n} reads mapped in {time.perf_counter() - t1:.1f} s, "
            f"{len(res[side].data)} records")
    require_same_records("ShardedAligner card vs CPU", res["card"],
                         res["cpu"])
    return got


def phase_amr_sharded(rng):
    """Phases 9 and 10 in a scratch directory that is removed after.
    Returns {"amr": launches in phase 9's amr step, "sharded": launches in
    phase 10's sharded CLI run}."""
    with tempfile.TemporaryDirectory(prefix="mpn_amr_") as work:
        amr, paths, refdb, whole, cli_amr_cpu = phase_amr(rng, work)
        try:
            sharded = phase_sharded(paths, refdb, whole, work)
            compare_cli_amr(*cli_amr_cpu)
        finally:
            cli_amr_cpu[0].stop()
    return {"amr": amr, "sharded": sharded}


def nvidia_smi_line():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def kernels_line(kstats, paf_launches=None, cigar_launches=None,
                 profile_launches=None, amr_launches=None):
    """The per-kernel records as one JSON line. With the launch counts of
    the paths: {"kernels": [...]}, each record with `launches` (the count
    from the kernel's own map path: the PAF-mode map for sw_full and chain,
    the CIGAR-mode map for sw_scores) and every path's counts in
    `launches_by_path` (the two maps; the taxon profile: phase 7's run and
    phase 8's card run together; phase 9's amr step; phase 10's sharded
    run). Without them (no map ran): {"kernel_checks": [...]}, the records
    without those two keys."""
    kernels = []
    for name, (src, rep) in KERNELS.items():
        rec = {"name": name, "route": "cuda", "source": src, "replaces": rep}
        if paf_launches is not None:
            by_path = {"paf_map": paf_launches[name],
                       "cigar_map": cigar_launches[name],
                       "profile": profile_launches[name],
                       "amr": amr_launches["amr"][name],
                       "sharded": amr_launches["sharded"][name]}
            rec["launches"] = by_path["paf_map"] or by_path["cigar_map"]
        rec.update(kstats[name])
        if paf_launches is not None:
            rec["launches_by_path"] = by_path
        kernels.append(rec)
    return json.dumps({"kernels" if paf_launches is not None
                       else "kernel_checks": kernels})


def main(argv):
    import torch

    if argv not in ([], ["kernels"], ["profile"], ["amr"]) \
            and argv[:1] not in (["chain"], ["maps"]):
        raise SystemExit("usage: chip_smoke.py [kernels | profile | amr | "
                         "chain [TREE] | maps [TREE]]")
    rng = np.random.default_rng(2026)
    if argv == ["profile"]:
        phase_device()
        profile_launches, _ = phase_profiles(rng)
        log(nvidia_smi_line())
        print(json.dumps({"profile_launches": profile_launches}), flush=True)
        return
    if argv == ["amr"]:
        t0 = time.perf_counter()
        phase_device()
        amr_launches = phase_amr_sharded(rng)
        log(f"wall time of phases 1, 9 and 10: "
            f"{time.perf_counter() - t0:.1f} s")
        log(nvidia_smi_line())
        print(json.dumps({"amr_launches": amr_launches}), flush=True)
        return
    if argv[:1] == ["maps"]:
        phase_device()
        index, genomes, aligner, reads, truth, _ = phase_map(rng)
        phase_cigar_map(rng, index, genomes, aligner, reads, truth)
        log(nvidia_smi_line())
        return
    if argv[:1] == ["chain"]:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device")
        log(nvidia_smi_line())
        print(json.dumps({"chain_times": chain_times(
            rng, argv[1] if len(argv) > 1 else ".")}), flush=True)
        return
    marks = [("start", time.perf_counter())]
    phase_device()
    kstats = phase_kernels(rng)
    marks.append(("phases 1-2", time.perf_counter()))
    if argv:
        log(nvidia_smi_line())
        print(kernels_line(kstats), flush=True)
        return
    index, genomes, aligner, reads, truth, paf_launches = phase_map(rng)
    phase_card_vs_cpu(index, aligner, reads)
    phase_cap_overflow(index, reads)
    marks.append(("phases 3-4", time.perf_counter()))
    cigar_launches, _ = phase_cigar_map(rng, index, genomes, aligner, reads,
                                        truth)
    phase_cigar_card_vs_cpu(index, aligner, reads)
    marks.append(("phases 5-6", time.perf_counter()))
    del index, genomes, aligner, reads, truth
    # phases 9 and 10 run between 7 and 8, beside phase 8's CPU run
    profile_launches, amr_launches = phase_profiles(
        rng, between=lambda: phase_amr_sharded(rng))
    marks.append(("phases 7-10", time.perf_counter()))
    log("wall time by phase (s): " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}"
        for i, (name, t) in enumerate(marks[1:])))
    log(nvidia_smi_line())
    print(kernels_line(kstats, paf_launches, cigar_launches,
                       profile_launches, amr_launches), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    # `chain TREE` and `maps TREE` run the package of another checkout
    sys.path.insert(0, os.path.abspath(sys.argv[2])
                    if sys.argv[1:2] in (["chain"], ["maps"])
                    and len(sys.argv) > 2 else ROOT)
    main(sys.argv[1:])
