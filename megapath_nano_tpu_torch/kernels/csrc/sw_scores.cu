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
// Design: one thread block per (read, ref) pair, one thread per band slot.
// Slot k of row i covers ref position j = i + k - band/2, so the diagonal
// predecessor is the thread's own previous cell and the vertical one is slot
// k+1's, exchanged through shared memory. The F chain (gap in ref) needs
// values only, so it is an exclusive prefix-max of
// g = Hnod - gap_open + k * gap_extend: an inclusive max scan by warp
// shuffles, then each thread folds in the totals of the warps before its
// own. That is two block barriers a row. Each thread keeps its slot's
// running best (strict >, so the earliest row of the slot's maximum); one
// block reduction by (max score, min row, min slot) picks the result. Rows
// past the pair's read length are exact no-ops in the reference (its
// `active` mask), so the block stops at its own read length. Read and ref
// rows are indexed with 64-bit offsets: this kernel has no window limit and
// serves reads of 65536 bases and more.
//
// What bounds it: latency and synchronisation, not bytes. A pair does
// q * band cells of integer work against (q + t + 16) bytes of traffic, and
// the rows are strictly sequential with two barriers each.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 29);
constexpr int kRowBits = 22;  // end_read < 2**22 in the reduction key

__global__ void sw_scores_kernel(const int8_t* __restrict__ reads,
                                 const int32_t* __restrict__ rlens,
                                 const int8_t* __restrict__ refs,
                                 int32_t* __restrict__ out, int n, int q_max,
                                 int width, int band, int match, int mismatch,
                                 int gap_open, int gap_extend) {
  __shared__ int32_t xh[1024];
  __shared__ int32_t xe[1024];
  __shared__ int32_t warp_top[32];
  __shared__ unsigned long long warp_best[32];

  const int k = threadIdx.x;
  const int lane = k & 31;
  const int warp = k >> 5;
  const int pair = blockIdx.x;
  const int half = band >> 1;
  const int8_t* read = reads + static_cast<size_t>(pair) * q_max;
  const int8_t* ref = refs + static_cast<size_t>(pair) * width;
  int rlen = rlens[pair];
  rlen = rlen < 0 ? 0 : (rlen > q_max ? q_max : rlen);

  int h = 0, e = 0;
  int best_v = 0, best_i = 0;
  xh[k] = 0;
  xe[k] = 0;
  __syncthreads();

  for (int i = 0; i < rlen; ++i) {
    // vertical predecessor: slot k+1 of the previous row, NEG past the band
    int up_h = kNeg, up_e = kNeg;
    if (k + 1 < band) {
      up_h = xh[k + 1];
      up_e = xe[k + 1];
    }

    const int rc = read[i];
    const size_t jj = static_cast<size_t>(i) + k;
    const int tc = jj < static_cast<size_t>(width) ? ref[jj] : 5;
    const bool ambig = (rc == 4) || (tc >= 4);
    const int sub = ambig ? 0 : (rc == tc ? match : -mismatch);
    const bool dead = tc == 5;

    const int m = h + sub;
    const int eo = up_h - gap_open;
    const int ee = up_e - gap_extend;
    const int e_new = eo > ee ? eo : ee;
    int h_nod = m > e_new ? m : e_new;
    if (dead) h_nod = kNeg;

    // exclusive prefix-max of g over the band, floored at NEG
    const int g = h_nod - gap_open + k * gap_extend;
    int inc = g;
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, inc, s);
      if (lane >= s && o > inc) inc = o;
    }
    int y = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) y = kNeg;
    if (lane == 31) warp_top[warp] = inc;
    __syncthreads();  // warp_top written; every xh/xe read of this row done
    for (int w = 0; w < warp; ++w) {
      const int o = warp_top[w];
      if (o > y) y = o;
    }
    if (y < kNeg) y = kNeg;
    const int f = y - (k - 1) * gap_extend;

    int hh = h_nod > f ? h_nod : f;
    hh = hh > 0 ? hh : 0;
    if (dead) hh = 0;
    h = hh;
    e = e_new > 0 ? e_new : 0;  // no zeroing on dead slots (see above)
    if (h > best_v) {
      best_v = h;
      best_i = i;
    }
    xh[k] = h;
    xe[k] = e;
    __syncthreads();  // next row reads xh/xe and rewrites warp_top
  }

  // block reduction by (max score, min row, min slot) on one packed key
  unsigned long long key =
      (static_cast<unsigned long long>(best_v) << 32) |
      (static_cast<unsigned long long>(((1 << kRowBits) - 1) - best_i) << 10) |
      static_cast<unsigned long long>(1023 - k);
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, key, off);
    key = o > key ? o : key;
  }
  if (lane == 0) warp_best[warp] = key;
  __syncthreads();
  if (k < 32) {
    unsigned long long v = k < (band >> 5) ? warp_best[k] : 0ull;
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
      v = o > v ? o : v;
    }
    if (k == 0) {
      int score = static_cast<int>(v >> 32);
      int bi = ((1 << kRowBits) - 1) -
               static_cast<int>((v >> 10) & ((1ull << kRowBits) - 1));
      int bk = 1023 - static_cast<int>(v & 1023ull);
      if (score <= 0) {  // no positive cell: (0, 0, -band/2)
        score = 0;
        bi = 0;
        bk = 0;
      }
      out[pair] = score;
      out[static_cast<size_t>(n) + pair] = bi;
      out[2 * static_cast<size_t>(n) + pair] = bi + bk - half;
    }
  }
}

}  // namespace

extern "C" int mpn_sw_scores(const void* reads, const void* rlens,
                             const void* refs, void* out, int n, int q_max,
                             int width, int band, int match, int mismatch,
                             int gap_open, int gap_extend, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (band < 32 || band > 1024 || band % 32 != 0 || q_max >= (1 << kRowBits))
    return static_cast<int>(cudaErrorInvalidValue);
  sw_scores_kernel<<<n, band, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(reads), static_cast<const int32_t*>(rlens),
      static_cast<const int8_t*>(refs), static_cast<int32_t*>(out), n, q_max,
      width, band, match, mismatch, gap_open, gap_extend);
  return static_cast<int>(cudaGetLastError());
}
