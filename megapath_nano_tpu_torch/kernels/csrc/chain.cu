// Anchor chaining DP with extents (minimap2-style), for Hopper (sm_90a).
//
// Replaces the chain recurrence of the TPU package: the XLA lax.scan in
// megapath_nano_tpu/align/chain.py chain_and_extents, which the map path
// runs, and its Pallas twin megapath_nano_tpu/kernels/chain.py
// _chain_kernel. Same outputs, bit for bit: (6, N) int32 rows
// [best, q_min, q_max, t_min, t_max, chain_len].
//
//   f[i] = max(max_{j<i, i-j<=window} f[j] + alpha - beta, k)
//   alpha = min(dq, dt, k); beta = beta_table[|dq - dt|]
//
// beta_table is computed once on the host from the reference's float32
// expression, so no float rounding happens on the card.
//
// What bounds it: the serial step (anchor i needs f of anchor i - 1). A
// step is about 60 warp instructions, 7 of them cross-lane, and a warp
// alone needs some hundreds of cycles for it; with the SMs full (16384
// groups) about half the time is instruction issue, the rest stalls on the
// step's own chain of dependent instructions and uneven group lengths. The
// bytes (2 or 4 per position in, 24 per group out) are negligible, and the
// bound by bytes lies below the duration of any launch.
//
// Design: one warp per group, everything in registers, no shared memory and
// no barrier.
// - The window of the last 32 anchors is a ring across the lanes: anchor j
//   lives in lane 31 - (j & 31) with its q, t, f, q_min, t_min and chain
//   length. At step i the ring is exactly anchors i-32 .. i-1, and the
//   anchor in lane l is 1 + ((i + l) & 31) steps old. It is masked when that
//   age exceeds min(window, i); no lane indexes anything.
// - The positions: each lane loads one q and one t of a block of 32 anchors
//   with a coalesced load, one block ahead of use; a step's anchor comes to
//   all lanes by two __shfl_sync.
// - The pick: __reduce_max_sync gives the best candidate, __ballot_sync the
//   lanes that hold it. The oldest predecessor wins ties, as the reference's
//   argmax does: the oldest anchor sits in lane 31 - (i & 31) and age falls
//   with the lane number from there (wrapping), so the ballot is rotated
//   left by i & 31 and its highest set bit taken (one FLO; the ring runs
//   against the lane numbers for that reason). Three __shfl_sync bring the
//   winner's q_min, t_min and chain length. Every lane computes the new
//   anchor's state; the anchor's lane keeps it.
// - Off the serial path: the gap term alpha - beta of step i + 1 depends on
//   positions only, so it is computed during step i (the ring's q and t are
//   updated before f is). It has no branch: every lane reads the table at a
//   clamped index (__ldg, 2 KB that stay in L1) and masks afterwards. A
//   masked lane carries kNeg as its gap term, and its sum with f stays below
//   every real candidate without a select. Staging the table in shared
//   memory measured within 3% either way and is not done.
// - The loop ends at the group's own count. The best anchor (largest f, the
//   first on ties: replaced only by a strictly larger f) is carried through
//   the loop in registers every lane holds alike; it starts as anchor 0 with
//   no score, which is what an empty group reports.
// - int16 or int32 positions are read as they are (template on the type).
// - Two warps a block, so that a block's slot on its SM is held by the
//   longer of two groups only; the loop unrolled by four (7% at 4096 x 256).
//
// ptxas (sm_90a, -O3): 48 registers, no spill, no stack frame, no shared
// memory, no barrier.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kWarpsPerBlock = 2;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
chain_kernel(const T* __restrict__ q_pos, const T* __restrict__ t_pos,
             const int32_t* __restrict__ n_anchors,
             const int32_t* __restrict__ beta, int32_t* __restrict__ out,
             int n, int a, int window, int k, int max_dist, int bandwidth) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (g >= n) return;  // the whole warp leaves

  const T* __restrict__ qrow = q_pos + static_cast<size_t>(g) * a;
  const T* __restrict__ trow = t_pos + static_cast<size_t>(g) * a;
  int na = n_anchors[g];
  na = na < 0 ? 0 : (na > a ? a : na);

  // the block of 32 positions in use and the one after it, a position a lane
  int cq = 0, ct = 0, nq = 0, nt = 0;
  if (lane < a) {
    cq = __ldg(qrow + lane);
    ct = __ldg(trow + lane);
  }
  if (32 + lane < a) {
    nq = __ldg(qrow + 32 + lane);
    nt = __ldg(trow + 32 + lane);
  }

  // 0 < d <= max_dist as one unsigned compare of d - 1
  const unsigned max_dist_u = max_dist < 0 ? 0u : max_dist;

  // the ring: this lane's anchor of the window
  int rq = 0, rt = 0, rf = kNeg, rqmin = 0, rtmin = 0, rcnt = 0;
  // anchor i, and this lane's gap term against it (kNeg: masked)
  int qi = __shfl_sync(kFull, cq, 0);
  int ti = __shfl_sync(kFull, ct, 0);
  int pre = kNeg;
  // the best anchor so far
  int bf = kNeg, bi = 0, bqmin = qi, btmin = ti, bcnt = 1;

#pragma unroll 4
  for (int i = 0; i < na; ++i) {
    const int li = i & 31;
    const bool mine = lane == 31 - li;

    // the serial part: the best predecessor, the oldest on ties. A masked
    // lane's sum stays below every real candidate.
    const int cand = rf + pre;
    const int m = __reduce_max_sync(kFull, cand);
    const unsigned tied = __ballot_sync(kFull, cand == m);
    const int winner = 31 - __clz(__funnelshift_l(tied, tied, li)) - li;

    // meanwhile, from positions only: anchor i enters the ring, and the gap
    // terms of step i + 1 are formed
    if (mine) {
      rq = qi;
      rt = ti;
    }
    const int nx = i + 1;
    if ((nx & 31) == 0) {
      cq = nq;
      ct = nt;
      nq = 0;
      nt = 0;
      if (nx + 32 + lane < a) {
        nq = __ldg(qrow + nx + 32 + lane);
        nt = __ldg(trow + nx + 32 + lane);
      }
    }
    const int qn = __shfl_sync(kFull, cq, nx);
    const int tn = __shfl_sync(kFull, ct, nx);
    // no branch: every lane reads the table, at a clamped index
    const int dq = qn - rq;
    const int dt = tn - rt;
    const int dd = abs(dq - dt);
    const bool ok = (((nx + lane) & 31) < min(window, nx)) &
                    (static_cast<unsigned>(dq - 1) < max_dist_u) &
                    (static_cast<unsigned>(dt - 1) < max_dist_u) &
                    (dd <= bandwidth);
    const int gap = min(min(dq, dt), k) - __ldg(beta + min(dd, bandwidth));

    // the winner's chain start and length; anchor i's state
    const int wqmin = __shfl_sync(kFull, rqmin, winner);
    const int wtmin = __shfl_sync(kFull, rtmin, winner);
    const int wcnt = __shfl_sync(kFull, rcnt, winner);
    const bool has = m >= k;
    const int fi = max(m, k);
    const int qmin_i = has ? wqmin : qi;
    const int tmin_i = has ? wtmin : ti;
    const int cnt_i = has ? wcnt + 1 : 1;
    if (mine) {
      rf = fi;
      rqmin = qmin_i;
      rtmin = tmin_i;
      rcnt = cnt_i;
    }
    if (fi > bf) {
      bf = fi;
      bi = i;
      bqmin = qmin_i;
      btmin = tmin_i;
      bcnt = cnt_i;
    }
    qi = qn;
    ti = tn;
    pre = ok ? gap : kNeg;
  }

  // six lanes write a row each; two of them fetch the best anchor's position
  int v = max(bf, 0);
  v = lane == 1 ? bqmin : v;
  v = lane == 3 ? btmin : v;
  v = lane == 5 ? bcnt : v;
  if (lane == 2) v = __ldg(qrow + bi);
  if (lane == 4) v = __ldg(trow + bi);
  if (lane < 6) out[static_cast<size_t>(lane) * n + g] = v;
}

template <typename T>
int launch(const void* q_pos, const void* t_pos, const void* n_anchors,
           const void* beta, void* out, int n, int a, int window, int k,
           int max_dist, int bandwidth, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  chain_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(q_pos), static_cast<const T*>(t_pos),
      static_cast<const int32_t*>(n_anchors),
      static_cast<const int32_t*>(beta), static_cast<int32_t*>(out), n, a,
      window, k, max_dist, bandwidth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos_bytes: the size of a position in q_pos and t_pos, 2 (int16) or 4
// (int32). Returns a CUDA error code, 0 on success.
extern "C" int mpn_chain(const void* q_pos, const void* t_pos,
                         const void* n_anchors, const void* beta, void* out,
                         int n, int a, int pos_bytes, int window, int k,
                         int max_dist, int bandwidth, int device,
                         void* stream) {
  if (pos_bytes != 2 && pos_bytes != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || a <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pos_bytes == 2
             ? launch<int16_t>(q_pos, t_pos, n_anchors, beta, out, n, a,
                               window, k, max_dist, bandwidth, s)
             : launch<int32_t>(q_pos, t_pos, n_anchors, beta, out, n, a,
                               window, k, max_dist, bandwidth, s);
}
