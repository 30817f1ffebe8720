// Banded local affine-gap Smith-Waterman, score only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel megapath_nano_tpu/kernels/sw.py _sw_kernel
// (called through banded_sw_scores): the same row recurrence
// (_row_step_factory) and the same best-cell rule (_reduce_best), bit for
// bit. Output: (3, N) int32 rows [score, end_read, end_ref].
//
// This is not sw_full.cu without its companions: the row steps are written
// differently. Here the carried E is max(E, 0) on every slot, dead
// (sentinel 5) slots included, as in the reference's score-only step; the
// full-stats step zeroes E on dead slots. (A dead slot stays dead down its
// whole ref column, whose H is always 0, so its E never gets above 0 and
// the two forms give the same scores; this kernel follows its own
// reference line by line all the same.)
//
// What bounds it on this card: the rate at which a scheduler issues integer
// instructions, then the latency of one row; never bytes. A pair does
// q * band cells, each of at least 7 compares, maxima and selects on the
// integer pipe, against q + t + 20 bytes of traffic, and row i + 1 cannot
// start before row i's F chain (a prefix maximum across the whole band) is
// done. The exact rows below cost 437 / 259 / 166 SASS instructions a row
// at S = 16 / 8 / 4 (27 / 32 / 42 a slot; ptxas: 115 / 72 / 48 registers),
// and at band 512 a second warp on a scheduler cut the time a row costs it
// by only 18% (PERF.md): issue slots, not occupancy, set the pace. The packed
// rows (below) do the same row in 272 / 173 / 103 (17 / 22 / 26 a slot;
// 113 / 72 / 48 registers for the kernel with both paths): 1.70x faster a
// row for one warp alone at band 512 and 1.82x at four warps a scheduler.
//
// Warp-per-pair form (sw_scores_warp_kernel<S>, band = 32 * S): one warp
// walks one pair, lane l owns the slots k = S*l .. S*l + S - 1, and H and E
// are 2 * S registers a lane; the warps of a block are independent pairs, so
// the row loop has no __syncthreads and no DP state in shared memory, and a
// warp stops at its own read length (later rows are exact no-ops in the
// reference, under its `active` mask). Slot k of row i covers ref position
// j = i + k - band/2: the diagonal predecessor is the slot's own previous
// value, the vertical one is slot k + 1's, a register of the same lane for
// S - 1 slots and one __shfl_down_sync a plane (2 a row) for the last, NEG
// right of the band. The F chain needs values only: an exclusive prefix
// maximum of g = Hnod - gap_open + k * gap_extend, floored at NEG, done as a
// running maximum over the lane's S slots, a 5-step shuffle scan over the 32
// lane totals, and a second walk that applies the incoming prefix. The
// running best is kept per lane (slots in ascending k, rows in ascending i,
// strict >), and one shuffle reduction on a packed 64-bit key with 22 row
// bits picks (max score, min row, min slot). Read and ref codes travel as
// packed words loaded four rows ahead (sw_band.cuh), and the kernels form
// the dead cells (sentinel 5 left of the window and past its length)
// themselves, so the CUDA route needs no padded copy of the refs. Rows are
// indexed with int offsets inside a pair (below 2**23) and 64-bit offsets
// between pairs: this kernel has no window limit and serves reads of 65536
// bases and more.
//
// Packed rows (walk_packed): the warp form's rows for every pair whose
// window holds only the codes 0..4 within its length (odd_codes checks
// that, once a pair), under a scoring that the packing holds
// (packed_rows_fit; a launch that fails it walks exact rows). The same
// scores, tie rules and order of rows, in fewer instructions a slot:
// - Substitution: the row's reference codes travel as nibbles, and one
//   byte permute a group of four slots looks their substitution up in a
//   table of bytes built once a row from the read code; a slot then costs
//   one sign-extending byte extract.
// - No dead-cell tests. A dead cell left of the window has substitution 0
//   and only dead cells above and left of it, so it computes H = E = 0
//   itself, as the reference forces; its Hnod is 0 where the reference's is
//   NEG, which only feeds F values below 0, and F enters H through
//   max(Hnod, F, 0). The dead cells right of the window feed only each
//   other (diagonal, vertical and F all lead right or down a dead column),
//   and none of their H exceeds the largest live H of the rows before or of
//   its own row, which lies left of it (gap penalties >= 0), so none wins
//   the (max score, min row, min slot) reduction.
// - E is kept as E - gap_extend, floored at 0 in the same add-maximum.
// - F: g is taken in the lane's frame (k0 * gap_extend left out), so the
//   slot terms are the same in every lane; part 1 keeps the lane's running
//   maximum p of g and, with it, A = max(Hnod, p + d, 0), all of H but the
//   prefix from the lanes to the left; the scan moves each lane's total
//   into the receiving lane's frame in its add-maximum; part 3 is one
//   add-maximum a slot, H = max(y + d, A), with no chain through the slots.
// - The running best: a key 16 * H + 15 - j a slot, a three-way maximum
//   over the row's keys, and the row replaces the lane's best only when its
//   H part is larger: rows in ascending i, then the lowest slot.
// tests/test_torch_sw_scan.py writes these rows out in numpy and holds them
// to the plain version and to the TPU package.
//
// Block-per-pair form (sw_scores_block_kernel): the DP state of every slot
// in 4 planes of the band, a thread for every nt-th slot, the k + 1
// exchange through the planes, and per chunk of nt slots a warp-shuffle
// scan plus a fold over the earlier warps' totals and the chunks before.
// It serves the bands the warp form has no instantiation for
// (mpn::has_warp_form in sw_band.cuh). The planes lie in shared memory up to
// the band whose planes fill the shared memory a block may have
// (mpn::block_max_band: 14464 on an H100) and beyond it in a scratch of
// device memory that the caller allocates, a slice of 4 planes for every
// block of a launch; the DP order is the same in both.

#include <cstdint>
#include <cuda_runtime.h>

#include "sw_band.cuh"

namespace {

using mpn::kAllLanes;
using mpn::kNeg;
using mpn::kWarpsPerBlock;
using mpn::Scoring;

constexpr int kRowBits = 22;  // end_read < 2**22 in the reduction key
constexpr int kRowMax = (1 << kRowBits) - 1;
// Planes of band int32 the block-per-pair form keeps in shared memory.
constexpr int kScorePlanes = 4;

// (v, i, k) of the warp's best cell by (max v, min i, min k), to every lane.
__device__ __forceinline__ void warp_best3(int& v, int& i, int& k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kAllLanes, v, off);
    const int oi = __shfl_xor_sync(kAllLanes, i, off);
    const int ok = __shfl_xor_sync(kAllLanes, k, off);
    if (ov > v || (ov == v && (oi < i || (oi == i && ok < k)))) {
      v = ov;
      i = oi;
      k = ok;
    }
  }
}

// A lane's DP state. Slots 0 .. S - 1 are the lane's own; index S holds, for
// one row, the old values of slot 0 of lane + 1.
template <int S>
struct ScoreLane {
  int h[S + 1], e[S + 1];
  int best_v, best_ij;
};

// Row i of one pair: rc is the read code, tc_words hold the lane's S ref
// codes, k0 = S * lane is the lane's first slot.
template <int S>
__device__ __forceinline__ void score_row(ScoreLane<S>& st, int i, int rc,
                                          const uint32_t* tc_words, int lane,
                                          int k0, const Scoring& sc) {
  const bool read_n = rc == 4;

  // vertical predecessors of the lane's last slot: slot 0 of lane + 1
  st.h[S] = __shfl_down_sync(kAllLanes, st.h[0], 1);
  st.e[S] = __shfl_down_sync(kAllLanes, st.e[0], 1);
  if (lane == 31) st.h[S] = st.e[S] = kNeg;  // right of the band

  // part 1: diagonal, E, Hnod; in place (slot j reads the old values of
  // slots j and j + 1 only); the lane's maximum of g
  int total = kNeg;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int tc = mpn::code_at(tc_words, j);
    const bool ambig = read_n || tc >= 4;
    const int sub = ambig ? 0 : (rc == tc ? sc.match : -sc.mismatch);
    const int m = st.h[j] + sub;
    const int eo = st.h[j + 1] - sc.gap_open;
    const int ee = st.e[j + 1] - sc.gap_extend;
    const int e_new = eo > ee ? eo : ee;
    int h_nod = m > e_new ? m : e_new;
    if (tc == 5) h_nod = kNeg;  // dead; a live cell has h_nod >= -mismatch
    st.h[j] = h_nod;
    st.e[j] = e_new > 0 ? e_new : 0;  // no zeroing on dead slots (see above)
    const int g = h_nod - sc.gap_open + (k0 + j) * sc.gap_extend;
    total = g > total ? g : total;
  }

  // part 2: inclusive maximum scan of the lane totals, then the exclusive
  // prefix, NEG left of slot 0 (total is floored at NEG)
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(kAllLanes, total, s);
    if (lane >= s && o > total) total = o;
  }
  int run = __shfl_up_sync(kAllLanes, total, 1);
  if (lane == 0) run = kNeg;

  // part 3: apply the prefix, F, H, the running best
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int k = k0 + j;
    const int h_nod = st.h[j];
    const int f = run - (k - 1) * sc.gap_extend;
    const int g = h_nod - sc.gap_open + k * sc.gap_extend;
    run = g > run ? g : run;
    int hh = h_nod > f ? h_nod : f;
    hh = hh > 0 ? hh : 0;
    if (h_nod == kNeg) hh = 0;  // dead
    st.h[j] = hh;
    if (hh > st.best_v) {
      st.best_v = hh;
      st.best_ij = i * 16 + j;
    }
  }
}

// The rows of one pair as written above (exact rows): the lane's best cell
// as (score, row, slot).
template <int S>
__device__ __forceinline__ void walk_exact(const int8_t* read,
                                           const int8_t* ref, int rlen,
                                           int tlen, int q_max, int lane,
                                           const Scoring& sc, int& best_v,
                                           int& best_i, int& best_k) {
  constexpr int half = 16 * S;
  const int k0 = S * lane;
  ScoreLane<S> st;
#pragma unroll
  for (int j = 0; j < S; ++j) st.h[j] = st.e[j] = 0;
  st.best_v = st.best_ij = 0;

  mpn::RefWindow<S> win;
  win.init(ref, k0 - half, tlen);
  uint32_t read_now = mpn::read_word(read, 0, q_max);
  uint32_t read_ahead = mpn::read_word(read, 4, q_max);

  for (int i = 0; i < rlen; ++i) {
    const int r = i & 3;
    uint32_t tc_words[S / 4];
    win.row(r, tc_words);
    score_row<S>(st, i, static_cast<int>((read_now >> (8 * r)) & 0xFFu),
                 tc_words, lane, k0, sc);
    if (r == 3) {  // the next row starts a block of four
      win.advance(ref, i + 1, k0 - half, tlen);
      read_now = read_ahead;
      read_ahead = mpn::read_word(read, i + 5, q_max);
    }
  }
  best_v = st.best_v;
  best_i = st.best_ij >> 4;
  best_k = k0 + (st.best_ij & 15);
}

// ---------------------------------------------------------------------------
// Packed rows: the scores of the exact rows for a pair whose window holds
// only the codes 0..4 within its length, in fewer instructions a slot (the
// header note says how). mpn_sw_scores checks the scoring
// (packed_rows_fit), odd_codes the window.

// prmt.b32 d, a, b, sel: byte n of d is the byte that bits 4n .. 4n + 2 of
// sel pick of the eight of a (0..3) and b (4..7), or its sign in all 8 bits
// where bit 4n + 3 is set; the bits of sel above 15 are not read.
// (__byte_perm clears those bits and every bit 4n + 3 first, an
// instruction more.)
__device__ __forceinline__ uint32_t permute(uint32_t a, uint32_t b,
                                            uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Byte j of w, sign-extended: one permute.
__device__ __forceinline__ int signed_byte(uint32_t w, int j) {
  return static_cast<int>(permute(w, 0u, 0x8880u + 0x1111u * j));
}

// The reference codes of a lane for four consecutive rows i0 .. i0 + 3 as
// nibbles: w[x] holds those of slots 4x .. 4x + 7 of row i0, so row i0 + r's
// codes of slots 4x .. 4x + 3 are the low 16 bits of w[x] >> 4r, a byte
// permute's selector as they stand. Codes past the window are the dead code
// 5 (mpn::ref_word); a block of four rows brings one new byte word, loaded a
// block ahead as in mpn::RefWindow.
template <int S>
struct NibbleWindow {
  static constexpr int kGroups = S / 4;
  uint32_t w[kGroups];
  uint32_t ahead;  // ref positions i0 + base + S + 4 .. + 7, as bytes

  // a byte word of codes 0..15 with its codes c0, c1 in byte 0 and c2, c3
  // in byte 2, a nibble each
  static __device__ __forceinline__ uint32_t pair_nibbles(uint32_t b) {
    return b | (b >> 4);
  }

  __device__ __forceinline__ void init(const int8_t* ref, int base,
                                       int tlen) {
#pragma unroll
    for (int x = 0; x < kGroups; ++x)
      w[x] = permute(pair_nibbles(mpn::ref_word(ref, base + 4 * x, tlen)),
                     pair_nibbles(mpn::ref_word(ref, base + 4 * x + 4, tlen)),
                     0x6420);
    ahead = mpn::ref_word(ref, base + S + 4, tlen);
  }

  // Move on to the block that starts at row i0 (the one after the current),
  // and start the load for the block after it.
  __device__ __forceinline__ void advance(const int8_t* ref, int i0, int base,
                                          int tlen) {
#pragma unroll
    for (int x = 0; x + 1 < kGroups; ++x) w[x] = w[x + 1];
    w[kGroups - 1] = permute(w[kGroups - 1], pair_nibbles(ahead), 0x6432);
    ahead = mpn::ref_word(ref, i0 + base + S + 4, tlen);
  }
};

// Whether the tlen bases of a window hold a code other than 0..4 (A, C, G,
// T, N); the whole warp gets the answer. Such a pair walks exact rows: a
// code 5 inside the window is a dead cell that packed rows would not see,
// and codes from 6 up or below 0 do not fit a nibble.
__device__ __forceinline__ bool odd_codes(const int8_t* ref, int tlen,
                                          int lane) {
  bool odd = false;
  for (int o = 4 * lane; o < tlen; o += 128) {
    uint32_t b = __ldg(reinterpret_cast<const uint32_t*>(ref + o));
    if (tlen - o < 4) b &= (1u << (8 * (tlen - o))) - 1u;  // past tlen: 0
    // a byte's top bit is set when it is 0x80 or more, or when it is 5 or
    // more and adding 0x7b carries into it (a byte below 0x80 cannot carry
    // out of itself)
    odd |= ((b | ((b & 0x7f7f7f7fu) + 0x7b7b7b7bu)) & 0x80808080u) != 0u;
  }
  return __any_sync(kAllLanes, odd);
}

// What the packed rows keep constant, the same in every lane. g and F are
// taken in the lane's own frame (k0 * gap_extend left out of g; the lane's
// slot j is band slot k0 + j), so their slot terms do not depend on the lane.
template <int S>
struct PackedConsts {
  int go, ge;
  int c[S];         // j * gap_extend - gap_open: g = Hnod + c[j]
  int d[S];         // (1 - j) * gap_extend: F = y + d[j], y the prefix of g
  uint32_t xw, mx;  // -mismatch in each byte; (match ^ -mismatch) & 0xff

  __device__ __forceinline__ explicit PackedConsts(const Scoring& sc)
      : go(sc.gap_open), ge(sc.gap_extend) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      c[j] = j * ge - go;
      d[j] = (1 - j) * ge;
    }
    xw = (static_cast<uint32_t>(-sc.mismatch) & 0xFFu) * 0x01010101u;
    mx = static_cast<uint32_t>(sc.match ^ -sc.mismatch) & 0xFFu;
  }

  // A row's substitution by reference code as bytes 0..3 (codes 0..3; the
  // codes 4..7 read zero beyond the word): match at the read's base,
  // -mismatch at the other bases, 0 at N (4) and at the dead code 5. A read
  // code other than 0..4 matches no base.
  __device__ __forceinline__ uint32_t table(uint32_t rc) const {
    return rc < 4u ? xw ^ (mx << (8 * rc)) : (rc == 4u ? 0u : xw);
  }
};

template <int S>
struct PackedLane {
  int h[S + 1];   // H; index S holds, for one row, slot 0 of lane + 1
  int ee[S + 1];  // E - gap_extend
  int best;       // 16 * H + 15 - j of the lane's best cell (H < 2**27)
  int best_i;     // its row
};

// Row i: sub[x] holds the substitution of slots 4x .. 4x + 3 as bytes.
template <int S>
__device__ __forceinline__ void packed_row(PackedLane<S>& st, int i,
                                           const uint32_t (&sub)[S / 4],
                                           int lane,
                                           const PackedConsts<S>& pc) {
  st.h[S] = __shfl_down_sync(kAllLanes, st.h[0], 1);
  st.ee[S] = __shfl_down_sync(kAllLanes, st.ee[0], 1);
  if (lane == 31) st.h[S] = st.ee[S] = kNeg;  // right of the band

  // part 1, in place: E, Hnod, the lane's running maximum p of g, and
  // A = max(Hnod, F from the lane's own slots, 0), all that H needs but the
  // prefix from the lanes to the left
  int p = kNeg;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int s = signed_byte(sub[j >> 2], j & 3);
    const int e_new = __viaddmax_s32(st.h[j + 1], -pc.go, st.ee[j + 1]);
    const int h_nod = __viaddmax_s32(st.h[j], s, e_new);
    st.ee[j] = __viaddmax_s32(e_new, -pc.ge, -pc.ge);  // max(E, 0) - ge
    st.h[j] = __viaddmax_s32_relu(p, pc.d[j], h_nod);
    p = __viaddmax_s32(h_nod, pc.c[j], p);
  }

  // part 2: inclusive maximum scan of p over the lanes, each value moved
  // into the receiving lane's frame (S * gap_extend a lane), then the
  // exclusive prefix y; a lane below s gets its own p back, which the move
  // only lowers (gap_extend >= 0)
  int t = p;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1)
    t = __viaddmax_s32(__shfl_up_sync(kAllLanes, t, s), -S * s * pc.ge, t);
  int y = __shfl_up_sync(kAllLanes, t, 1) - S * pc.ge;
  if (lane == 0) y = kNeg;

  // part 3: H = max(y + d, A), and the row's best key: its largest H, then
  // its lowest slot
  int key[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    st.h[j] = __viaddmax_s32(y, pc.d[j], st.h[j]);
    key[j] = st.h[j] * 16 + (15 - j);
  }
  int m = kNeg;
#pragma unroll
  for (int x = 0; x < S; x += 4)
    m = __vimax3_s32(m, __vimax3_s32(key[x], key[x + 1], key[x + 2]),
                     key[x + 3]);
  if (m > (st.best | 15)) {  // a larger H: rows in ascending i, strict >
    st.best = m;
    st.best_i = i;
  }
}

template <int S>
__device__ __forceinline__ void walk_packed(const int8_t* read,
                                            const int8_t* ref, int rlen,
                                            int tlen, int q_max, int lane,
                                            const Scoring& sc, int& best_v,
                                            int& best_i, int& best_k) {
  constexpr int half = 16 * S;
  const int k0 = S * lane;
  const PackedConsts<S> pc(sc);
  PackedLane<S> st;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    st.h[j] = 0;
    st.ee[j] = -pc.ge;
  }
  st.best = 15;  // H 0 at slot 0
  st.best_i = 0;

  NibbleWindow<S> win;
  win.init(ref, k0 - half, tlen);
  uint32_t read_now = mpn::read_word(read, 0, q_max);
  uint32_t read_ahead = mpn::read_word(read, 4, q_max);

  for (int i = 0; i < rlen; ++i) {
    const int r = i & 3;
    const uint32_t tab = pc.table((read_now >> (8 * r)) & 0xFFu);
    uint32_t sub[S / 4];
#pragma unroll
    for (int x = 0; x < S / 4; ++x)
      sub[x] = permute(tab, 0u, win.w[x] >> (4 * r));
    packed_row<S>(st, i, sub, lane, pc);
    if (r == 3) {  // the next row starts a block of four
      win.advance(ref, i + 1, k0 - half, tlen);
      read_now = read_ahead;
      read_ahead = mpn::read_word(read, i + 5, q_max);
    }
  }
  best_v = st.best >> 4;
  best_i = st.best_i;
  best_k = k0 + 15 - (st.best & 15);
}

template <int S>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    sw_scores_warp_kernel(const int8_t* __restrict__ reads,
                          const int32_t* __restrict__ rlens,
                          const int8_t* __restrict__ refs,
                          const int32_t* __restrict__ tlens,
                          int32_t* __restrict__ out, int n, int q_max,
                          int t_max, Scoring sc, bool packed) {
  constexpr int half = 16 * S;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= n) return;  // the whole warp leaves together
  const int8_t* read = reads + static_cast<size_t>(pair) * q_max;
  const int8_t* ref = refs + static_cast<size_t>(pair) * t_max;
  const int rlen = mpn::clamp_read_len(rlens[pair], q_max);
  const int tlen = mpn::clamp_ref_len(tlens[pair], t_max);

  int best_v, best_i, best_k;
  if (packed && !odd_codes(ref, tlen, lane))  // the same in the whole warp
    walk_packed<S>(read, ref, rlen, tlen, q_max, lane, sc, best_v, best_i,
                   best_k);
  else
    walk_exact<S>(read, ref, rlen, tlen, q_max, lane, sc, best_v, best_i,
                  best_k);

  // warp reduction by (max score, min row, min slot) on one packed key
  const unsigned long long key = mpn::warp_max_key(
      (static_cast<unsigned long long>(best_v) << 32) |
      (static_cast<unsigned long long>(kRowMax - best_i) << 10) |
      static_cast<unsigned long long>(1023 - best_k));
  if (lane != 0) return;
  int score = static_cast<int>(key >> 32);
  int wi = kRowMax - static_cast<int>((key >> 10) & kRowMax);
  int wk = 1023 - static_cast<int>(key & 1023ull);
  if (score <= 0) {  // no positive cell: (0, 0, -band/2)
    score = 0;
    wi = 0;
    wk = 0;
  }
  out[pair] = score;
  out[static_cast<size_t>(n) + pair] = wi;
  out[2 * static_cast<size_t>(n) + pair] = wi + wk - half;
}

// Block-per-pair form: blockDim.x = nt threads, and thread t owns the slots
// k = t, t + nt, t + 2 nt, ... of the band (mpn::block_threads). The DP
// state lives in 4 planes of band int32 (the row's old H and E, its new Hnod
// and E): in dynamic shared memory when kDevicePlanes is false, else in the
// block's slice of `planes`, a scratch of device memory of 4 * band int32
// for every block of the launch. Block b serves pair pair0 + b. A row is
// (A) diagonal, E and Hnod from the old planes into the new ones, then (B)
// the F chain chunk by chunk (chunk c is slots c*nt .. c*nt + nt - 1, one a
// thread: a warp-shuffle maximum scan, a fold over the earlier warps'
// totals and the carry of the chunks left of it) with F, H and the running
// best written back to the old planes.
template <bool kDevicePlanes>
__global__ void sw_scores_block_kernel(const int8_t* __restrict__ reads,
                                       const int32_t* __restrict__ rlens,
                                       const int8_t* __restrict__ refs,
                                       const int32_t* __restrict__ tlens,
                                       int32_t* __restrict__ out, int n,
                                       int q_max, int t_max, int band,
                                       Scoring sc, int pair0,
                                       int32_t* __restrict__ planes) {
  const int match = sc.match, mismatch = sc.mismatch;
  const int gap_open = sc.gap_open, gap_extend = sc.gap_extend;
  extern __shared__ int32_t smem[];
  __shared__ int32_t warp_top[32];
  __shared__ int32_t warp_v[32], warp_i[32], warp_k[32];

  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = nt >> 5;
  const int pair = pair0 + blockIdx.x;
  const int half = band >> 1;
  const int8_t* read = reads + static_cast<size_t>(pair) * q_max;
  const int8_t* ref = refs + static_cast<size_t>(pair) * t_max;
  const int rlen = mpn::clamp_read_len(rlens[pair], q_max);
  const int tlen = mpn::clamp_ref_len(tlens[pair], t_max);

  // the previous row's H and E
  int32_t* xh = kDevicePlanes ? planes + static_cast<size_t>(blockIdx.x) *
                                             kScorePlanes * band
                              : smem;
  int32_t* xe = xh + band;
  int32_t* nh = xe + band;  // this row's Hnod and E
  int32_t* ne = nh + band;
  for (int k = t; k < band; k += nt) xh[k] = xe[k] = 0;
  // the running best of the thread's slots: (max score, min row, min slot)
  int best_v = 0, best_i = 0, best_k = t;
  __syncthreads();

  for (int i = 0; i < rlen; ++i) {
    const int rc = mpn::read_code(read, i, q_max);
    // (A) vertical predecessor: slot k + 1 of the previous row, NEG past the
    // band
    for (int k = t; k < band; k += nt) {
      int up_h = kNeg, up_e = kNeg;
      if (k + 1 < band) {
        up_h = xh[k + 1];
        up_e = xe[k + 1];
      }
      const int tc = mpn::ref_code(ref, i + k - half, tlen);
      const bool ambig = (rc == 4) || (tc >= 4);
      const int sub = ambig ? 0 : (rc == tc ? match : -mismatch);
      const int m = xh[k] + sub;
      const int eo = up_h - gap_open;
      const int ee = up_e - gap_extend;
      const int e_new = eo > ee ? eo : ee;
      int h_nod = m > e_new ? m : e_new;
      if (tc == 5) h_nod = kNeg;  // dead; a live cell has h_nod >= -mismatch
      nh[k] = h_nod;
      ne[k] = e_new > 0 ? e_new : 0;  // no zeroing on dead slots (see above)
    }
    __syncthreads();  // every read of the old planes in this row is done

    // (B) exclusive prefix-max of g over the band, floored at NEG
    int carry = kNeg;
    for (int c0 = 0; c0 < band; c0 += nt) {
      const int k = c0 + t;
      const int g = k < band ? nh[k] - gap_open + k * gap_extend : kNeg;
      int inc = g;
      for (int s = 1; s < 32; s <<= 1) {
        const int o = __shfl_up_sync(kAllLanes, inc, s);
        if (lane >= s && o > inc) inc = o;
      }
      int y = __shfl_up_sync(kAllLanes, inc, 1);
      if (lane == 0) y = kNeg;
      if (lane == 31) warp_top[warp] = inc;
      __syncthreads();
      for (int w = 0; w < warp; ++w) y = warp_top[w] > y ? warp_top[w] : y;
      y = carry > y ? carry : y;
      for (int w = 0; w < n_warps; ++w)
        carry = warp_top[w] > carry ? warp_top[w] : carry;
      __syncthreads();  // warp_top is rewritten by the next chunk
      if (k >= band) continue;

      if (y < kNeg) y = kNeg;
      const int h_nod = nh[k];
      const int f = y - (k - 1) * gap_extend;
      int hh = h_nod > f ? h_nod : f;
      hh = hh > 0 ? hh : 0;
      if (h_nod == kNeg) hh = 0;  // dead
      xh[k] = hh;
      xe[k] = ne[k];
      if (hh > best_v) {  // slots in ascending k, rows in ascending i
        best_v = hh;
        best_i = i;
        best_k = k;
      }
    }
    __syncthreads();  // the next row reads the old planes at k + 1
  }

  // block reduction by (max score, min row, min slot)
  warp_best3(best_v, best_i, best_k);
  if (lane == 0) {
    warp_v[warp] = best_v;
    warp_i[warp] = best_i;
    warp_k[warp] = best_k;
  }
  __syncthreads();
  if (t >= 32) return;
  int v = 0, bi = 0, bk = band;
  if (t < n_warps) {
    v = warp_v[t];
    bi = warp_i[t];
    bk = warp_k[t];
  }
  warp_best3(v, bi, bk);
  if (t != 0) return;
  if (v <= 0) {  // no positive cell: (0, 0, -band/2)
    v = 0;
    bi = 0;
    bk = 0;
  }
  out[pair] = v;
  out[static_cast<size_t>(n) + pair] = bi;
  out[2 * static_cast<size_t>(n) + pair] = bi + bk - half;
}

template <int S>
void launch_warp_form(const int8_t* reads, const int32_t* rlens,
                      const int8_t* refs, const int32_t* tlens, int32_t* out,
                      int n, int q_max, int t_max, const Scoring& sc,
                      bool packed, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sw_scores_warp_kernel<S><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      reads, rlens, refs, tlens, out, n, q_max, t_max, sc, packed);
}

// Whether the warp form's pairs may walk packed rows under this scoring and
// read length: no dead-cell tests need gap penalties of at least 0 (a dead
// cell left of the window then stays at 0, and none right of it wins), the
// substitution bytes need match and -mismatch in a signed byte, and the
// best-cell key 16 * H + 15 needs H <= match * (q_max + 128) below 2**27.
// The gap bounds keep every g and F of the band far from int32's ends.
bool packed_rows_fit(const Scoring& sc, int q_max) {
  return sc.gap_open >= 0 && sc.gap_open <= 65535 && sc.gap_extend >= 0 &&
         sc.gap_extend <= 65535 && sc.match >= -128 && sc.match <= 127 &&
         sc.mismatch >= -127 && sc.mismatch <= 128 &&
         static_cast<long long>(sc.match > 0 ? sc.match : 0) *
                 (q_max + 128) <
             (1LL << 27);
}

}  // namespace

// The largest band the block-per-pair form takes on `device` with its
// planes in shared memory, in *band.
extern "C" int mpn_sw_scores_max_band(int device, int* band) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mpn::block_max_band(
      reinterpret_cast<const void*>(sw_scores_block_kernel<false>),
      kScorePlanes, device, band));
}

// reads (n, q_max) and refs (n, t_max) int8 with q_max and t_max multiples
// of 4 and 4-byte aligned bases, rlens and tlens (n,) int32, out (3, n)
// int32. form: 0 = the warp form where the band has one, 1 = warp per pair,
// 2 = block per pair with the planes in shared memory, 3 = block per pair
// with the planes in `scratch`, scratch_blocks * 4 * band int32 of device
// memory (the pairs go in launches of scratch_blocks blocks, in turn on the
// stream). *packed (when not null) is set to 1 when the warp form was
// launched with packed rows allowed (packed_rows_fit), else to 0.
extern "C" int mpn_sw_scores(const void* reads_, const void* rlens_,
                             const void* refs_, const void* tlens_,
                             void* out_, int n, int q_max, int t_max,
                             int band, int match, int mismatch, int gap_open,
                             int gap_extend, int form, int device,
                             void* stream_, void* scratch,
                             int scratch_blocks, int* packed) {
  if (packed != nullptr) *packed = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const auto* reads = static_cast<const int8_t*>(reads_);
  const auto* rlens = static_cast<const int32_t*>(rlens_);
  const auto* refs = static_cast<const int8_t*>(refs_);
  const auto* tlens = static_cast<const int32_t*>(tlens_);
  auto* out = static_cast<int32_t*>(out_);
  auto stream = static_cast<cudaStream_t>(stream_);
  const Scoring sc{match, mismatch, gap_open, gap_extend};
  if (band < 128 || band % 128 != 0 || q_max % 4 != 0 ||
      t_max % 4 != 0 || q_max + 128 >= (1 << kRowBits) ||
      reinterpret_cast<uintptr_t>(reads) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(refs) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // At band 512 with no more pairs than SMs the block form measured about
  // one percent faster than the warp form (times in PERF.md): too little to
  // keep a second path for, so every band with a warp form takes it.
  if (form == 0) form = mpn::has_warp_form(band) ? 1 : 2;
  const bool pack = form == 1 && packed_rows_fit(sc, q_max);
  if (form == 1 && band == 128)
    launch_warp_form<4>(reads, rlens, refs, tlens, out, n, q_max, t_max, sc,
                        pack, stream);
  else if (form == 1 && band == 256)
    launch_warp_form<8>(reads, rlens, refs, tlens, out, n, q_max, t_max, sc,
                        pack, stream);
  else if (form == 1 && band == 512)
    launch_warp_form<16>(reads, rlens, refs, tlens, out, n, q_max, t_max, sc,
                         pack, stream);
  else if (form == 2) {
    size_t smem = 0;
    err = mpn::block_smem(
        reinterpret_cast<const void*>(sw_scores_block_kernel<false>),
        kScorePlanes, band, device, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sw_scores_block_kernel<false><<<n, mpn::block_threads(band), smem,
                                    stream>>>(reads, rlens, refs, tlens, out,
                                              n, q_max, t_max, band, sc, 0,
                                              nullptr);
  } else if (form == 3 && scratch != nullptr && scratch_blocks > 0) {
    for (int p0 = 0; p0 < n; p0 += scratch_blocks) {
      const int blocks = n - p0 < scratch_blocks ? n - p0 : scratch_blocks;
      sw_scores_block_kernel<true><<<blocks, mpn::block_threads(band), 0,
                                     stream>>>(
          reads, rlens, refs, tlens, out, n, q_max, t_max, band, sc, p0,
          static_cast<int32_t*>(scratch));
    }
  } else
    return static_cast<int>(cudaErrorInvalidValue);
  if (packed != nullptr) *packed = pack ? 1 : 0;
  return static_cast<int>(cudaGetLastError());
}
