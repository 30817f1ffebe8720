// Shared pieces of the two banded extension kernels (sw_full.cu,
// sw_scores.cu). In their warp-per-pair form one warp walks one (read, ref)
// pair, lane l owns the S = band / 32 consecutive band slots
// k = S*l .. S*l + S - 1, and all DP state lives in registers. In their
// block-per-pair form a block walks a pair, the DP state lives in planes of
// band int32 in dynamic shared memory, and a thread owns every nt-th slot.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mpn {

constexpr int kNeg = -(1 << 29);
constexpr unsigned kAllLanes = 0xffffffffu;
// Pairs (warps) per block. The warps of a block never synchronise with each
// other; they share a block only so that an SM is filled with few blocks.
constexpr int kWarpsPerBlock = 4;
struct Scoring {
  int match, mismatch, gap_open, gap_extend;
};

// The warp-per-pair form exists for these bands (S = 4, 8, 16 slots a lane);
// the block-per-pair form serves every other band the wrappers accept
// (every multiple of 128 whose planes fit in shared memory).
inline bool has_warp_form(int band) {
  return band == 128 || band == 256 || band == 512;
}

// Threads of a block-per-pair launch: ceil(band / 1024) slots a thread,
// rounded up to whole warps (the band itself up to 1024).
inline int block_threads(int band) {
  const int per = (band + 1023) / 1024;
  return 32 * ((band + 32 * per - 1) / (32 * per));
}

// The largest band a block-per-pair kernel takes on `device`: `planes`
// int32 planes of band in dynamic shared memory, beside the kernel's static
// shared memory, within what one block may opt in to (227 KB on an H100).
inline cudaError_t block_max_band(const void* kernel, int planes, int device,
                                  int* band) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const long long room = optin - static_cast<long long>(attr.sharedSizeBytes);
  *band = static_cast<int>(room / (4LL * planes) / 128 * 128);
  return cudaSuccess;
}

// Opt a block-per-pair kernel in to the dynamic shared memory of `band`
// (refused past block_max_band); the bytes go to *smem.
inline cudaError_t block_smem(const void* kernel, int planes, int band,
                              int device, size_t* smem) {
  int max_band = 0;
  cudaError_t err = block_max_band(kernel, planes, device, &max_band);
  if (err != cudaSuccess) return err;
  if (band > max_band) return cudaErrorInvalidValue;
  *smem = 4ull * planes * band;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

// A pair's read length as the reference clamps it: to [0, q_max rounded up
// to a multiple of 128] (its wrapper pads the reads that far with N).
__device__ __forceinline__ int clamp_read_len(int len, int q_max) {
  const int cap = (q_max + 127) & ~127;
  return len < 0 ? 0 : (len > cap ? cap : len);
}

__device__ __forceinline__ int clamp_ref_len(int len, int t_max) {
  return len < 0 ? 0 : (len > t_max ? t_max : len);
}

// The code at ref position o of a window of tlen bases: sentinel 5 (a dead
// cell) left of the window and past its length, as the reference's wrapper
// pads it.
__device__ __forceinline__ int ref_code(const int8_t* ref, int o, int tlen) {
  return o >= 0 && o < tlen ? ref[o] : 5;
}

__device__ __forceinline__ int read_code(const int8_t* read, int i,
                                         int q_max) {
  return i < q_max ? read[i] : 4;
}

// Four packed codes at ref positions o .. o + 3 (o a multiple of 4, rows of
// t_max bytes with t_max a multiple of 4, tlen <= t_max).
__device__ __forceinline__ uint32_t ref_word(const int8_t* ref, int o,
                                             int tlen) {
  if (o < 0 || o >= tlen) return 0x05050505u;
  uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(ref + o));
  const int live = tlen - o;
  if (live < 4) {
    const uint32_t keep = (1u << (8 * live)) - 1u;
    w = (w & keep) | (0x05050505u & ~keep);
  }
  return w;
}

// Four packed read codes for rows i0 .. i0 + 3 (i0 and q_max multiples of
// 4); 4 (N) past the row.
__device__ __forceinline__ uint32_t read_word(const int8_t* read, int i0,
                                              int q_max) {
  return i0 < q_max ? __ldg(reinterpret_cast<const uint32_t*>(read + i0))
                    : 0x04040404u;
}

// The reference codes of a lane for four consecutive rows i0 .. i0 + 3, as
// S / 4 + 1 packed words: ref positions [i0 + base, i0 + base + S + 4) with
// base = S*lane - band/2, the position of the lane's first slot in row 0.
// Row i0 + r needs bytes r .. r + S - 1 of them, so a row costs one funnel
// shift a word instead of S byte loads, and a block of four rows costs one
// new word, which is loaded one block ahead of its use: no global load sits
// inside the row-to-row dependency.
template <int S>
struct RefWindow {
  static constexpr int kWords = S / 4;
  uint32_t w[kWords + 1];
  uint32_t ahead;  // the top word of the next block of four rows

  __device__ __forceinline__ void init(const int8_t* ref, int base,
                                       int tlen) {
#pragma unroll
    for (int x = 0; x <= kWords; ++x) w[x] = ref_word(ref, base + 4 * x, tlen);
    ahead = ref_word(ref, 4 + base + S, tlen);
  }

  // Codes of row i0 + r: word x holds the slots 4x .. 4x + 3 of the lane.
  __device__ __forceinline__ void row(int r, uint32_t (&tc)[kWords]) const {
#pragma unroll
    for (int x = 0; x < kWords; ++x)
      tc[x] = __funnelshift_r(w[x], w[x + 1], 8 * r);
  }

  // Move on to the block that starts at row i0 (the one after the current),
  // and start the load for the block after it.
  __device__ __forceinline__ void advance(const int8_t* ref, int i0, int base,
                                          int tlen) {
#pragma unroll
    for (int x = 0; x < kWords; ++x) w[x] = w[x + 1];
    w[kWords] = ahead;
    ahead = ref_word(ref, i0 + 4 + base + S, tlen);
  }
};

__device__ __forceinline__ int code_at(const uint32_t* words, int j) {
  return static_cast<int>((words[j >> 2] >> (8 * (j & 3))) & 0xFFu);
}

// Warp maximum of a 64-bit key; every lane gets the result.
__device__ __forceinline__ unsigned long long warp_max_key(
    unsigned long long key) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kAllLanes, key, off);
    key = o > key ? o : key;
  }
  return key;
}

}  // namespace mpn
