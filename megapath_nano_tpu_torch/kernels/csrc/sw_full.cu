// Banded local affine-gap Smith-Waterman with full path statistics, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel megapath_nano_tpu/kernels/sw.py
// _sw_kernel_full (called through banded_sw_full): the same row recurrence
// (_row_step_full_factory), the same best-cell rule (_reduce_best) and the
// same output columns (_full_outputs), bit for bit.
//
// What bounds it on this card: the integer instruction rate and the latency
// of one row, never bytes. A pair does q * band cells, each of at least 22
// compares, maxima and selects on the integer pipe beside its additions
// (about 70 elementwise operations as the plain version spells the step
// out), against q + t + 36 bytes of traffic, and row i + 1 cannot
// start before row i's F chain (a prefix scan across the whole band) is
// done. So the design spends as few instructions a cell as it can, keeps
// everything a row touches in registers, and leaves it to the other warps
// of the SM to fill the latency of a row's shuffles.
//
// Warp-per-pair form (sw_full_warp_kernel<S>, band = 32 * S):
//  - One warp walks one pair; lane l owns the S consecutive slots
//    k = S*l .. S*l + S - 1. H, E and their companions P_H, B_H, P_E, B_E
//    are 6 * S registers a lane. The warps of a block are independent pairs:
//    the row loop has no __syncthreads and no DP state in shared memory, and
//    each warp stops at its own read length (later rows are exact no-ops in
//    the reference, under its `active` mask).
//  - Slot k of row i covers ref position j = i + k - band/2, so the diagonal
//    predecessor is the slot's own previous value and the vertical one is
//    slot k + 1's: a register of the same lane for S - 1 slots, one
//    __shfl_down_sync a plane (6 a row) for the lane's last slot. The slot
//    right of the band reads as (NEG, NEG, 0, 0, 0, 0), the fills of the
//    reference's lane shifts.
//  - The F chain (gap in the ref) is an exclusive prefix scan of the tuple
//    (g, p, b) under "keep the left operand when left.g >= right.g": the
//    leftmost maximum, so the earliest opener wins ties. It is done in
//    three parts: a sequential scan over the lane's own S slots, a 5-step
//    shuffle scan over the 32 lane totals, and a second walk over the S
//    slots that applies the incoming prefix. The operator is associative, so
//    this order gives the reference's Hillis-Steele result. The element left
//    of slot 0 is the fill (NEG, 0, 0); it wins against every real value
//    <= NEG (dead slots), which the scan gets by seeding the exclusive
//    prefix with it.
//  - The running best is kept per lane, not per slot: slots are walked in
//    ascending k and rows in ascending i with a strict >, which keeps (max
//    score, min row, min slot) exactly. One shuffle reduction on a packed
//    64-bit key picks the winner; its companions are taken before a
//    no-alignment result is zeroed.
//  - Read and ref codes travel as packed 32-bit words (sw_band.cuh): one
//    broadcast word holds the read codes of four rows, S / 4 + 1 words hold a
//    lane's ref codes for four rows, and both are loaded one block of four
//    rows ahead, outside the row-to-row dependency.
//  - The kernels take the windows as the caller has them and form the dead
//    cells (sentinel 5 left of the window and past its length) themselves, so
//    the CUDA route needs no padded copy of the refs.
//
// Block-per-pair form (sw_full_block_kernel): the DP state of every slot in
// 12 planes of shared memory, a thread for every nt-th slot, the k + 1
// exchange through shared memory and the F chain scanned chunk by chunk with
// block barriers. It serves the bands the warp form has no instantiation for
// (mpn::has_warp_form in sw_band.cuh), up to the band whose planes fill the
// shared memory a block may have (mpn::block_max_band: 4736 on an H100);
// where both forms exist the warp form is the faster one at every batch size
// measured (times in PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "sw_band.cuh"

namespace {

using mpn::kAllLanes;
using mpn::kNeg;
using mpn::kWarpsPerBlock;
using mpn::Scoring;

// Planes of band int32 the block-per-pair form keeps in shared memory.
constexpr int kFullPlanes = 12;

// One element of the F chain's scan.
struct Opener {
  int g, p, b;
};

// Leftmost maximum: the earlier slot wins ties.
__device__ __forceinline__ Opener keep_left(const Opener& l, const Opener& r) {
  const bool t = l.g >= r.g;
  Opener o;
  o.g = t ? l.g : r.g;
  o.p = t ? l.p : r.p;
  o.b = t ? l.b : r.b;
  return o;
}

// A lane's DP state. Slots 0 .. S - 1 are the lane's own; index S holds, for
// one row, the old values of slot 0 of lane + 1.
template <int S>
struct FullLane {
  int h[S + 1], e[S + 1], ph[S + 1], bh[S + 1], pe[S + 1], be[S + 1];
  int best_v, best_ij, best_p, best_b;
};

// Row i of one pair: rc is the read code, tc_words hold the lane's S ref
// codes, k0 = S * lane is the lane's first slot.
template <int S>
__device__ __forceinline__ void full_row(FullLane<S>& st, int i, int rc,
                                         const uint32_t* tc_words, int lane,
                                         int k0, const Scoring& sc) {
  constexpr int band = 32 * S;
  constexpr int half = band / 2;
  const bool read_n = rc == 4;

  // vertical predecessors of the lane's last slot: slot 0 of lane + 1
  st.h[S] = __shfl_down_sync(kAllLanes, st.h[0], 1);
  st.e[S] = __shfl_down_sync(kAllLanes, st.e[0], 1);
  st.ph[S] = __shfl_down_sync(kAllLanes, st.ph[0], 1);
  st.bh[S] = __shfl_down_sync(kAllLanes, st.bh[0], 1);
  st.pe[S] = __shfl_down_sync(kAllLanes, st.pe[0], 1);
  st.be[S] = __shfl_down_sync(kAllLanes, st.be[0], 1);
  if (lane == 31) {  // right of the band: the reference's shift fills
    st.h[S] = st.e[S] = kNeg;
    st.ph[S] = st.bh[S] = st.pe[S] = st.be[S] = 0;
  }
  // B of a path that starts at slot j of this row is cur_b0 + j
  const int cur_b0 = (i + band) * 32768 + (i + k0 - half + band);

  // part 1: diagonal, E, Hnod; in place (slot j reads the old values of
  // slots j and j + 1 only); the lane's total for the F chain
  Opener total;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int k = k0 + j;
    const int tc = mpn::code_at(tc_words, j);
    const bool same = rc == tc;
    const bool ambig = read_n || tc >= 4;
    const int sub = ambig ? 0 : (same ? sc.match : -sc.mismatch);
    const bool is_match = same && !ambig;
    const bool dead = tc == 5;
    const int cur_b = cur_b0 + j;

    // diagonal: fresh start when the predecessor H is 0 (local stop)
    const int m = st.h[j] + sub;
    const bool fresh = st.h[j] == 0;
    const int p_m = (fresh ? 0 : st.ph[j]) + (is_match ? (1 << 16) : 1);
    const int b_m = fresh ? cur_b : st.bh[j];

    const int eo = st.h[j + 1] - sc.gap_open;
    const int ee = st.e[j + 1] - sc.gap_extend;
    const int e_new = eo > ee ? eo : ee;
    const bool take_ext = ee >= eo;  // extension wins ties
    const int p_e_new = (take_ext ? st.pe[j + 1] : st.ph[j + 1]) + 1;
    const int b_e_new = take_ext ? st.be[j + 1] : st.bh[j + 1];

    const bool take_m = m >= e_new;  // diagonal wins ties
    int h_nod = m > e_new ? m : e_new;
    const int p_nod = take_m ? p_m : p_e_new;
    const int b_nod = take_m ? b_m : b_e_new;
    if (dead) h_nod = kNeg;  // a live cell has h_nod >= -mismatch

    st.h[j] = h_nod;
    st.ph[j] = p_nod;
    st.bh[j] = b_nod;
    st.e[j] = dead ? 0 : (e_new > 0 ? e_new : 0);
    st.pe[j] = p_e_new;
    st.be[j] = b_e_new;

    Opener x;
    x.g = h_nod - sc.gap_open + k * sc.gap_extend;
    x.p = p_nod + (band - k);
    x.b = b_nod;
    total = j == 0 ? x : keep_left(total, x);
  }

  // part 2: inclusive scan of the lane totals, then the exclusive prefix,
  // seeded with the fill left of slot 0
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    Opener o;
    o.g = __shfl_up_sync(kAllLanes, total.g, s);
    o.p = __shfl_up_sync(kAllLanes, total.p, s);
    o.b = __shfl_up_sync(kAllLanes, total.b, s);
    if (lane >= s) total = keep_left(o, total);
  }
  Opener run;
  run.g = __shfl_up_sync(kAllLanes, total.g, 1);
  run.p = __shfl_up_sync(kAllLanes, total.p, 1);
  run.b = __shfl_up_sync(kAllLanes, total.b, 1);
  if (lane == 0 || run.g <= kNeg) {
    run.g = kNeg;
    run.p = 0;
    run.b = 0;
  }

  // part 3: apply the prefix, F, the H selection, the running best
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int k = k0 + j;
    const int h_nod = st.h[j], p_nod = st.ph[j], b_nod = st.bh[j];
    const bool dead = h_nod == kNeg;
    const Opener y = run;
    Opener x;
    x.g = h_nod - sc.gap_open + k * sc.gap_extend;
    x.p = p_nod + (band - k);
    x.b = b_nod;
    run = keep_left(run, x);

    const int f = y.g - (k - 1) * sc.gap_extend;
    const int p_f = y.p + k - band;
    const bool take_nod = h_nod >= f;  // diagonal/E win ties over F
    int hh = h_nod > f ? h_nod : f;
    const int p_hx = take_nod ? p_nod : p_f;
    const int b_hx = take_nod ? b_nod : y.b;
    hh = hh > 0 ? hh : 0;
    if (dead) hh = 0;
    const bool pos = hh > 0;
    st.h[j] = hh;
    st.ph[j] = pos ? p_hx : 0;
    st.bh[j] = pos ? b_hx : cur_b0 + j;
    if (hh > st.best_v) {
      st.best_v = hh;
      st.best_ij = i * 16 + j;
      st.best_p = st.ph[j];
      st.best_b = st.bh[j];
    }
  }
}

template <int S>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    sw_full_warp_kernel(const int8_t* __restrict__ reads,
                        const int32_t* __restrict__ rlens,
                        const int8_t* __restrict__ refs,
                        const int32_t* __restrict__ tlens,
                        int32_t* __restrict__ out, int n, int q_max, int t_max,
                        Scoring sc) {
  constexpr int band = 32 * S;
  constexpr int half = band / 2;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= n) return;  // the whole warp leaves together
  const int8_t* read = reads + static_cast<size_t>(pair) * q_max;
  const int8_t* ref = refs + static_cast<size_t>(pair) * t_max;
  const int rlen = mpn::clamp_read_len(rlens[pair], q_max);
  const int tlen = mpn::clamp_ref_len(tlens[pair], t_max);
  const int k0 = S * lane;

  FullLane<S> st;
#pragma unroll
  for (int j = 0; j < S; ++j)
    st.h[j] = st.e[j] = st.ph[j] = st.bh[j] = st.pe[j] = st.be[j] = 0;
  st.best_v = st.best_ij = st.best_p = st.best_b = 0;

  mpn::RefWindow<S> win;
  win.init(ref, k0 - half, tlen);
  uint32_t read_now = mpn::read_word(read, 0, q_max);
  uint32_t read_ahead = mpn::read_word(read, 4, q_max);

  for (int i = 0; i < rlen; ++i) {
    const int r = i & 3;
    uint32_t tc_words[S / 4];
    win.row(r, tc_words);
    full_row<S>(st, i, static_cast<int>((read_now >> (8 * r)) & 0xFFu),
                tc_words, lane, k0, sc);
    if (r == 3) {  // the next row starts a block of four
      win.advance(ref, i + 1, k0 - half, tlen);
      read_now = read_ahead;
      read_ahead = mpn::read_word(read, i + 5, q_max);
    }
  }

  // warp reduction by (max score, min row, min slot) on one packed key
  const int best_i = st.best_ij >> 4;
  const int best_k = k0 + (st.best_ij & 15);
  const unsigned long long key = mpn::warp_max_key(
      (static_cast<unsigned long long>(st.best_v) << 32) |
      (static_cast<unsigned long long>(32767 - best_i) << 16) |
      static_cast<unsigned long long>(65535 - best_k));
  int wk = 65535 - static_cast<int>(key & 0xFFFFull);
  // the companions are taken before a no-alignment result is zeroed
  const int wp = __shfl_sync(kAllLanes, st.best_p, wk / S);
  const int wb = __shfl_sync(kAllLanes, st.best_b, wk / S);
  if (lane != 0) return;
  int score = static_cast<int>(key >> 32);
  int wi = 32767 - static_cast<int>((key >> 16) & 0xFFFFull);
  if (score <= 0) {
    score = 0;
    wi = 0;
    wk = 0;
  }
  int32_t* o = out + static_cast<size_t>(pair) * 7;
  o[0] = score;
  o[1] = wi;
  o[2] = wi + wk - half;
  o[3] = wp >> 16;
  o[4] = wp & 0xFFFF;
  o[5] = (wb >> 15) - band;
  o[6] = (wb & 0x7FFF) - band;
}

// Block-per-pair form: blockDim.x = nt threads, and thread t owns the slots
// k = t, t + nt, t + 2 nt, ... of the band (block_threads: nt <= 1024). The
// DP state of every slot lives in shared memory, in 12 planes of band int32
// (the row's old H, E and companions, and the new Hnod and E with theirs),
// so the band is bounded by shared memory alone (sw_full_block_smem). A row
// is three passes over the thread's slots: (A) diagonal, E and Hnod from the
// old planes into the new ones; (B) the F chain, chunk by chunk: chunk c is
// slots c*nt .. c*nt + nt - 1, one a thread, scanned as in the warp form (a
// shuffle scan in the warp, a fold over the earlier warps' totals) and
// seeded with the carry of the chunks left of it, which starts as the fill
// (NEG, 0, 0); (C) in the same chunk loop, F, the H selection and the
// running best, written back to the old planes. The leftmost-maximum
// operator is associative, so this order gives the reference's scan.
__global__ void sw_full_block_kernel(const int8_t* __restrict__ reads,
                                     const int32_t* __restrict__ rlens,
                                     const int8_t* __restrict__ refs,
                                     const int32_t* __restrict__ tlens,
                                     int32_t* __restrict__ out, int q_max,
                                     int t_max, int band, Scoring sc) {
  const int match = sc.match, mismatch = sc.mismatch;
  const int gap_open = sc.gap_open, gap_extend = sc.gap_extend;
  extern __shared__ int32_t smem[];
  __shared__ Opener warp_total[32];
  __shared__ unsigned long long warp_best[32];
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = nt >> 5;
  const int pair = blockIdx.x;
  const int half = band >> 1;
  const int8_t* read = reads + static_cast<size_t>(pair) * q_max;
  const int8_t* ref = refs + static_cast<size_t>(pair) * t_max;
  const int rlen = mpn::clamp_read_len(rlens[pair], q_max);
  const int tlen = mpn::clamp_ref_len(tlens[pair], t_max);

  // the previous row: H, E and their companions, read at slots k and k + 1
  int32_t* xh = smem;
  int32_t* xe = xh + band;
  int32_t* xph = xe + band;
  int32_t* xbh = xph + band;
  int32_t* xpe = xbh + band;
  int32_t* xbe = xpe + band;
  // this row: Hnod and its companions, E and its companions
  int32_t* nh = xbe + band;
  int32_t* np = nh + band;
  int32_t* nb = np + band;
  int32_t* ne = nb + band;
  int32_t* npe = ne + band;
  int32_t* nbe = npe + band;
  for (int k = t; k < band; k += nt)
    xh[k] = xe[k] = xph[k] = xbh[k] = xpe[k] = xbe[k] = 0;
  // the running best of the thread's slots: (max score, min row, min slot)
  int best_v = 0, best_i = 0, best_k = t, best_p = 0, best_b = 0;
  __syncthreads();

  for (int i = 0; i < rlen; ++i) {
    const int rc = mpn::read_code(read, i, q_max);
    // (A) diagonal, E, Hnod
    for (int k = t; k < band; k += nt) {
      int up_h = kNeg, up_e = kNeg, ph_up = 0, bh_up = 0, pe_up = 0;
      int be_up = 0;
      if (k + 1 < band) {
        up_h = xh[k + 1];
        up_e = xe[k + 1];
        ph_up = xph[k + 1];
        bh_up = xbh[k + 1];
        pe_up = xpe[k + 1];
        be_up = xbe[k + 1];
      }
      const int h = xh[k];
      const int cur_j = i + k - half;
      const int tc = mpn::ref_code(ref, cur_j, tlen);
      const bool ambig = (rc == 4) || (tc >= 4);
      const int sub = ambig ? 0 : (rc == tc ? match : -mismatch);
      const bool dead = tc == 5;
      const bool is_match = (rc == tc) && !ambig;
      const int cur_b = (i + band) * 32768 + (cur_j + band);

      // diagonal: fresh start when the predecessor H is 0 (local stop)
      const int m = h + sub;
      const bool fresh = h == 0;
      const int p_m = (fresh ? 0 : xph[k]) + (is_match ? (1 << 16) : 1);
      const int b_m = fresh ? cur_b : xbh[k];

      const int eo = up_h - gap_open;
      const int ee = up_e - gap_extend;
      const int e_new = eo > ee ? eo : ee;
      const bool take_ext = ee >= eo;  // extension wins ties
      const int p_e_new = (take_ext ? pe_up : ph_up) + 1;
      const int b_e_new = take_ext ? be_up : bh_up;

      const bool take_m = m >= e_new;  // diagonal wins ties
      int h_nod = m > e_new ? m : e_new;
      if (dead) h_nod = kNeg;  // a live cell has h_nod >= -mismatch
      nh[k] = h_nod;
      np[k] = take_m ? p_m : p_e_new;
      nb[k] = take_m ? b_m : b_e_new;
      ne[k] = dead ? 0 : (e_new > 0 ? e_new : 0);
      npe[k] = p_e_new;
      nbe[k] = b_e_new;
    }
    __syncthreads();  // every read of the old planes in this row is done

    // (B) + (C): the F chain chunk by chunk, then F, H and the best
    Opener carry;
    carry.g = kNeg;
    carry.p = 0;
    carry.b = 0;
    for (int c0 = 0; c0 < band; c0 += nt) {
      const int k = c0 + t;
      Opener x = carry;  // slots past the band stand right of every slot
      if (k < band) {
        x.g = nh[k] - gap_open + k * gap_extend;
        x.p = np[k] + (band - k);
        x.b = nb[k];
      }
      Opener inc = x;
      for (int s = 1; s < 32; s <<= 1) {
        Opener o;
        o.g = __shfl_up_sync(kAllLanes, inc.g, s);
        o.p = __shfl_up_sync(kAllLanes, inc.p, s);
        o.b = __shfl_up_sync(kAllLanes, inc.b, s);
        if (lane >= s) inc = keep_left(o, inc);
      }
      Opener ex;
      ex.g = __shfl_up_sync(kAllLanes, inc.g, 1);
      ex.p = __shfl_up_sync(kAllLanes, inc.p, 1);
      ex.b = __shfl_up_sync(kAllLanes, inc.b, 1);
      if (lane == 31) warp_total[warp] = inc;
      __syncthreads();
      // the exclusive prefix of slot k: the fill and every slot left of it
      Opener y = carry;
      for (int w = 0; w < warp; ++w) y = keep_left(y, warp_total[w]);
      if (lane > 0) y = keep_left(y, ex);
      for (int w = 0; w < n_warps; ++w)
        carry = keep_left(carry, warp_total[w]);
      __syncthreads();  // warp_total is rewritten by the next chunk
      if (k >= band) continue;

      const int h_nod = nh[k];
      const int p_nod = np[k];
      const int b_nod = nb[k];
      const bool dead = h_nod == kNeg;
      const int f = y.g - (k - 1) * gap_extend;
      const int p_f = y.p + k - band;
      const bool take_nod = h_nod >= f;  // diagonal/E win ties over F
      int hh = h_nod > f ? h_nod : f;
      const int p_hx = take_nod ? p_nod : p_f;
      const int b_hx = take_nod ? b_nod : y.b;
      hh = hh > 0 ? hh : 0;
      if (dead) hh = 0;
      const bool pos = hh > 0;
      const int ph = pos ? p_hx : 0;
      const int bh = pos ? b_hx : (i + band) * 32768 + (i + k - half + band);
      xh[k] = hh;
      xph[k] = ph;
      xbh[k] = bh;
      xe[k] = ne[k];
      xpe[k] = npe[k];
      xbe[k] = nbe[k];
      if (hh > best_v) {  // slots in ascending k, rows in ascending i
        best_v = hh;
        best_i = i;
        best_k = k;
        best_p = ph;
        best_b = bh;
      }
    }
    __syncthreads();  // the next row reads the old planes at k + 1
  }

  // block reduction by (max score, min row, min slot) on one packed key
  // (rows and slots below 2**15: q_max + band < 2**15)
  unsigned long long key =
      (static_cast<unsigned long long>(best_v) << 32) |
      (static_cast<unsigned long long>(32767 - best_i) << 16) |
      static_cast<unsigned long long>(65535 - best_k);
  key = mpn::warp_max_key(key);
  if (lane == 0) warp_best[warp] = key;
  __syncthreads();
  if (t < 32) {
    unsigned long long v = t < n_warps ? warp_best[t] : 0ull;
    v = mpn::warp_max_key(v);
    if (t == 0) warp_best[0] = v;
  }
  __syncthreads();
  const unsigned long long win = warp_best[0];
  if (best_k != 65535 - static_cast<int>(win & 0xFFFFull)) return;

  // the companions are taken before a no-alignment result is zeroed
  int score = best_v, bi = best_i, bk = best_k;
  if (score <= 0) {
    score = 0;
    bi = 0;
    bk = 0;
  }
  int32_t* o = out + static_cast<size_t>(pair) * 7;
  o[0] = score;
  o[1] = bi;
  o[2] = bi + bk - half;
  o[3] = best_p >> 16;
  o[4] = best_p & 0xFFFF;
  o[5] = (best_b >> 15) - band;
  o[6] = (best_b & 0x7FFF) - band;
}

template <int S>
void launch_warp_form(const int8_t* reads, const int32_t* rlens,
                      const int8_t* refs, const int32_t* tlens, int32_t* out,
                      int n, int q_max, int t_max, const Scoring& sc,
                      cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sw_full_warp_kernel<S><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      reads, rlens, refs, tlens, out, n, q_max, t_max, sc);
}

}  // namespace

// The largest band the block-per-pair form takes on `device`, in *band.
extern "C" int mpn_sw_full_max_band(int device, int* band) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mpn::block_max_band(
      reinterpret_cast<const void*>(sw_full_block_kernel), kFullPlanes,
      device, band));
}

// reads (n, q_max) and refs (n, t_max) int8 with q_max and t_max multiples
// of 4 and 4-byte aligned bases, rlens and tlens (n,) int32, out (n, 7)
// int32. form: 0 = the warp form where the band has one, 1 = warp per pair,
// 2 = block per pair.
extern "C" int mpn_sw_full(const void* reads_, const void* rlens_,
                           const void* refs_, const void* tlens_, void* out_,
                           int n, int q_max, int t_max, int band, int match,
                           int mismatch, int gap_open, int gap_extend,
                           int form, int device, void* stream_) {
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
      t_max % 4 != 0 || reinterpret_cast<uintptr_t>(reads) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(refs) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == 0) form = mpn::has_warp_form(band) ? 1 : 2;
  if (form == 1 && band == 128)
    launch_warp_form<4>(reads, rlens, refs, tlens, out, n, q_max, t_max, sc,
                        stream);
  else if (form == 1 && band == 256)
    launch_warp_form<8>(reads, rlens, refs, tlens, out, n, q_max, t_max, sc,
                        stream);
  else if (form == 1 && band == 512)
    launch_warp_form<16>(reads, rlens, refs, tlens, out, n, q_max, t_max, sc,
                         stream);
  else if (form == 2) {
    size_t smem = 0;
    err = mpn::block_smem(reinterpret_cast<const void*>(sw_full_block_kernel),
                          kFullPlanes, band, device, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sw_full_block_kernel<<<n, mpn::block_threads(band), smem, stream>>>(
        reads, rlens, refs, tlens, out, q_max, t_max, band, sc);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
