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
// What bounds it on this card: the integer instruction rate and the latency
// of one row, never bytes. A pair does q * band cells, each of at least 7
// compares, maxima and selects on the integer pipe beside its additions
// (about 30 elementwise operations as the plain version spells the step
// out), against q + t + 20 bytes of traffic, and row i + 1 cannot
// start before row i's F chain (a prefix maximum across the whole band) is
// done. The map path calls it with 1024 pairs, an eighth of the warps the
// card can hold, so what a row costs one warp shows directly.
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
// Block-per-pair form (sw_scores_block_kernel): the DP state of every slot
// in 4 planes of shared memory, a thread for every nt-th slot, the k + 1
// exchange through shared memory, and per chunk of nt slots a warp-shuffle
// scan plus a fold over the earlier warps' totals and the chunks before.
// It serves the bands the warp form has no instantiation for
// (mpn::has_warp_form in sw_band.cuh), up to the band whose planes fill the
// shared memory a block may have (mpn::block_max_band: 14464 on an H100).

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

template <int S>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    sw_scores_warp_kernel(const int8_t* __restrict__ reads,
                          const int32_t* __restrict__ rlens,
                          const int8_t* __restrict__ refs,
                          const int32_t* __restrict__ tlens,
                          int32_t* __restrict__ out, int n, int q_max,
                          int t_max, Scoring sc) {
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

  // warp reduction by (max score, min row, min slot) on one packed key
  const int best_i = st.best_ij >> 4;
  const int best_k = k0 + (st.best_ij & 15);
  const unsigned long long key = mpn::warp_max_key(
      (static_cast<unsigned long long>(st.best_v) << 32) |
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
// state lives in 4 planes of band int32 in shared memory (the row's old H
// and E, its new Hnod and E). A row is (A) diagonal, E and Hnod from the old
// planes into the new ones, then (B) the F chain chunk by chunk (chunk c is
// slots c*nt .. c*nt + nt - 1, one a thread: a warp-shuffle maximum scan, a
// fold over the earlier warps' totals and the carry of the chunks left of
// it) with F, H and the running best written back to the old planes.
__global__ void sw_scores_block_kernel(const int8_t* __restrict__ reads,
                                       const int32_t* __restrict__ rlens,
                                       const int8_t* __restrict__ refs,
                                       const int32_t* __restrict__ tlens,
                                       int32_t* __restrict__ out, int n,
                                       int q_max, int t_max, int band,
                                       Scoring sc) {
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
  const int pair = blockIdx.x;
  const int half = band >> 1;
  const int8_t* read = reads + static_cast<size_t>(pair) * q_max;
  const int8_t* ref = refs + static_cast<size_t>(pair) * t_max;
  const int rlen = mpn::clamp_read_len(rlens[pair], q_max);
  const int tlen = mpn::clamp_ref_len(tlens[pair], t_max);

  int32_t* xh = smem;       // the previous row's H and E
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
                      cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sw_scores_warp_kernel<S><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      reads, rlens, refs, tlens, out, n, q_max, t_max, sc);
}

}  // namespace

// The largest band the block-per-pair form takes on `device`, in *band.
extern "C" int mpn_sw_scores_max_band(int device, int* band) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mpn::block_max_band(
      reinterpret_cast<const void*>(sw_scores_block_kernel), kScorePlanes,
      device, band));
}

// reads (n, q_max) and refs (n, t_max) int8 with q_max and t_max multiples
// of 4 and 4-byte aligned bases, rlens and tlens (n,) int32, out (3, n)
// int32. form: 0 = the warp form where the band has one, 1 = warp per pair,
// 2 = block per pair.
extern "C" int mpn_sw_scores(const void* reads_, const void* rlens_,
                             const void* refs_, const void* tlens_,
                             void* out_, int n, int q_max, int t_max,
                             int band, int match, int mismatch, int gap_open,
                             int gap_extend, int form, int device,
                             void* stream_) {
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
    err = mpn::block_smem(
        reinterpret_cast<const void*>(sw_scores_block_kernel), kScorePlanes,
        band, device, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sw_scores_block_kernel<<<n, mpn::block_threads(band), smem, stream>>>(
        reads, rlens, refs, tlens, out, n, q_max, t_max, band, sc);
  } else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
