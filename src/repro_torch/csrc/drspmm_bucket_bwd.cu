// Per-degree-bucket DR-SpMM sampled backward (Alg. 2, SSpMM) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel drspmm_bwd_bucket (src/repro/kernels/drspmm.py),
// the executor of ops.drspmm's per-bucket backward (backend "bucket"): one
// launch per degree bucket of the TRANSPOSED packing, straight over the
// bucket's ELL slab (nbr, w), both (R, E):
//
//   dV[j, t] = sum_e w[j,e] * gY[nbr[j,e], xi_rows[j, t]]      dV: (R, k)
//
// with xi_rows = x_idx gathered at the bucket's source rows.  Only the k
// sampled columns of each gY row are read, so the dense (N, dim) cotangent
// Aᵀ·gY is never formed; the caller adds the rows into dV at the bucket's
// row ids (index_add_).
//
// Bound on the H100: memory.  Each real slot gathers k scattered floats of
// one gY row (at k 16 of a 256-byte row they touch ~7 of its 8 sectors,
// mostly L2 hits) and each output row is written once.  Walked by one warp
// a row, a row's windows of 32 slots ran one after another, each an index
// load, then its samples: the 144 x 78 bucket took three such round trips
// a row.  So:
//  * a slab row is split over P warps (1 up to 32 slots, kParts64 up to 64,
//    then one warp per kWarpSlots slots, at most kMaxParts), the row's
//    windows of 32 slots dealt to them in turn; the P partial sums of the
//    k columns are added in the order p = 0..P-1 after the block's one
//    barrier (no shared memory at P = 1), so every output element has one
//    writer: fp32, no atomics, the same bits from run to run;
//  * for k <= 32 the warp splits into G = 32/KP slot groups of KP lanes
//    (KP = k rounded up to a power of two, at least 4): lane (s, t) samples
//    position t of slots s, s+G, ... of a window of 32 slots, the next
//    window's neighbours and weights loaded while this one is added, only
//    the real slots (one ballot a window) loading, kNarrowLoads samples a
//    lane issued before their adds, and the groups' partial sums folded
//    by shuffles in a fixed order.  A 7568 x 64 bucket (one warp a row)
//    is many rows, not a long chain: it reads its sectors at the L2's
//    rate when the SM holds kMinBlocks = 8 blocks, which the walk's 32
//    registers allow at 4 samples a lane and not at 16;
//  * rows wider than 32 samples take bucket_rows.cuh's walk with lane l
//    owning positions l, l + 32, ...: the ids two windows ahead and the
//    samples of a batch of slots (kWideLoads floats a lane) before their
//    adds, kWideMinBlocks blocks an SM.
// Columns outside [0, dim) sample nothing (they contribute 0).  The
// constants were swept with tools/bucket_fwd_probe.py --kernel 11 on the
// H100 at the main path's buckets (PERF.md).
#include <cuda_runtime.h>

#include "bucket_rows.cuh"

namespace {

using bucket_rows::batch_of;
using bucket_rows::combine_parts;
using bucket_rows::kFullMask;
using bucket_rows::walk_batches;

constexpr int kBlockWarps = 8;   // warps a block
constexpr int kWarpSlots = 32;   // past 64 slots, one warp per kWarpSlots ...
constexpr int kMaxParts = 8;     // ... up to kMaxParts warps a row
constexpr int kParts64 = 1;      // warps a row for 32 < E <= 64
constexpr int kMinBlocks = 8;    // blocks an SM must hold, k <= 32
constexpr int kNarrowLoads = 4;  // samples a lane has in flight (k <= 32)
constexpr int kWideMinBlocks = 4;  // ... and k > 32 (cap the registers)
constexpr int kWideLoads = 16;   // floats a lane has in flight (k > 32)
constexpr int kMaxWide = 8;      // positions per lane for k > 32 (k <= 256)
static_assert(kMaxParts <= kBlockWarps && kParts64 <= kBlockWarps,
              "a block holds at least one whole row");

// A block of (32, P, rows): warp (p, r) adds part p of the block's row r,
// the row's windows of 32 slots p, p + P, p + 2P, ...
template <int KP>
__global__ void __launch_bounds__(32 * kBlockWarps, kMinBlocks)
    bucket_bwd_narrow(const int* __restrict__ nbr,
                      const float* __restrict__ w,
                      const float* __restrict__ gy,
                      const int* __restrict__ xi_rows,
                      float* __restrict__ out, int n_rows, int e_width,
                      int k, int dim) {
  constexpr int G = 32 / KP;   // slot groups per warp
  constexpr int NI = 32 / G;   // slots per lane for a window of 32 slots
  constexpr int NB = NI < kNarrowLoads ? NI : kNarrowLoads;  // in flight
  __shared__ float part[kBlockWarps][32];
  const int lane = threadIdx.x;
  const int t = lane % KP;
  const int s = lane / KP;
  const int row = blockIdx.x * blockDim.z + threadIdx.z;
  const bool live = row < n_rows;  // warp-uniform
  float acc = 0.f;
  if (live) {
    int col = -1;
    if (t < k) {
      const int c = xi_rows[(long long)row * k + t];
      if ((unsigned)c < (unsigned)dim) col = c;
    }
    const long long base = (long long)row * e_width;
    // lane l holds slot e0 + 32 P v of window v; a slot at or past e_width
    // has weight 0
    const int e0 = 32 * threadIdx.y + lane;
    const int step = 32 * blockDim.y;
    float w_cur = 0.f;
    int n_cur = 0;
    if (e0 < e_width) {
      w_cur = w[base + e0];
      n_cur = nbr[base + e0];
    }
    for (int e = e0; e - lane < e_width; e += step) {
      // in flight while this window is added: the next window's slots
      float w_nxt = 0.f;
      int n_nxt = 0;
      if (e + step < e_width) {
        w_nxt = w[base + e + step];
        n_nxt = nbr[base + e + step];
      }
      const unsigned real = __ballot_sync(kFullMask, w_cur != 0.f);
      if (real) {  // warp-uniform
#pragma unroll
        for (int i0 = 0; i0 < NI; i0 += NB) {
          float g[NB];
#pragma unroll
          for (int i = 0; i < NB; ++i) {
            const int sl = s + G * (i0 + i);
            const int tgt = __shfl_sync(kFullMask, n_cur, sl);
            g[i] = ((real >> sl) & 1u) && col >= 0
                       ? gy[(long long)tgt * dim + col] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < NB; ++i)
            acc += __shfl_sync(kFullMask, w_cur, s + G * (i0 + i)) * g[i];
        }
      }
      n_cur = n_nxt;
      w_cur = w_nxt;
    }
  }
#pragma unroll
  for (int off = 16; off >= KP; off >>= 1)
    acc += __shfl_down_sync(kFullMask, acc, off);
  float* o = out + (long long)row * k;
  if (blockDim.y == 1) {  // block-uniform: the row is the warp's own sum
    if (live && s == 0 && t < k) o[t] = acc;
    return;
  }
  // lanes 0..KP-1 hold the warp's partial sums of columns 0..KP-1
  const float mine[1] = {lane < KP ? acc : 0.f};
  combine_parts<1>(part, mine, live, o, k, lane);
}

// Lane l's positions l + 32 j of the row's k sampled columns (-1: none).
template <int KW>
struct SampledCols {
  int c[KW];
  __device__ __forceinline__ bool ok(int j) const { return c[j] >= 0; }
  __device__ __forceinline__ int col(int j) const { return c[j]; }
};

template <int KW>
__global__ void __launch_bounds__(32 * kBlockWarps, kWideMinBlocks)
    bucket_bwd_wide(const int* __restrict__ nbr, const float* __restrict__ w,
                    const float* __restrict__ gy,
                    const int* __restrict__ xi_rows, float* __restrict__ out,
                    int n_rows, int e_width, int k, int dim) {
  constexpr int S = batch_of(KW, kWideLoads);
  __shared__ float part[kBlockWarps][32 * KW];
  const int lane = threadIdx.x;
  const int row = blockIdx.x * blockDim.z + threadIdx.z;
  const bool live = row < n_rows;  // warp-uniform
  float acc[KW];
#pragma unroll
  for (int j = 0; j < KW; ++j) acc[j] = 0.f;
  if (live) {
    SampledCols<KW> cols;
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      const int t = lane + 32 * j;
      const int c = t < k ? xi_rows[(long long)row * k + t] : -1;
      cols.c[j] = (unsigned)c < (unsigned)dim ? c : -1;
    }
    walk_batches<KW, S>(nbr, w, (long long)row * e_width, e_width,
                        threadIdx.y, blockDim.y, gy, dim, cols, acc, lane);
  }
  float* o = out + (long long)row * k;
  if (blockDim.y == 1) {  // block-uniform: the row is the warp's own sum
    if (!live) return;
#pragma unroll
    for (int j = 0; j < KW; ++j)
      if (lane + 32 * j < k) o[lane + 32 * j] = acc[j];
    return;
  }
  combine_parts<KW>(part, acc, live, o, k, lane);
}

template <int KP>
void launch_narrow(const int* nbr, const float* w, const float* gy,
                   const int* xi_rows, float* out, int n_rows, int e_width,
                   int k, int dim, int parts, cudaStream_t stream) {
  const int rows = kBlockWarps / parts;
  bucket_bwd_narrow<KP><<<(n_rows + rows - 1) / rows,
                          dim3(32, parts, rows), 0, stream>>>(
      nbr, w, gy, xi_rows, out, n_rows, e_width, k, dim);
}

template <int KW>
void launch_wide(const int* nbr, const float* w, const float* gy,
                 const int* xi_rows, float* out, int n_rows, int e_width,
                 int k, int dim, int parts, cudaStream_t stream) {
  const int rows = kBlockWarps / parts;
  bucket_bwd_wide<KW><<<(n_rows + rows - 1) / rows, dim3(32, parts, rows),
                        0, stream>>>(nbr, w, gy, xi_rows, out, n_rows,
                                     e_width, k, dim);
}

}  // namespace

// dV (n_rows, k) of one transposed bucket slab; any e_width >= 1,
// 1 <= k <= 256.  Returns a CUDA error code (cudaGetLastError right after
// the launch).
extern "C" int drspmm_bucket_bwd(const int* nbr, const float* w,
                                 const float* gy, const int* xi_rows,
                                 float* out, int n_rows, int e_width, int k,
                                 int dim, cudaStream_t stream) {
  if (e_width < 1 || k < 1 || k > 32 * kMaxWide || dim < 1)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const int parts = bucket_rows::split_parts(e_width, kParts64, kWarpSlots,
                                             kMaxParts);
#define NARROW(KP) \
  launch_narrow<KP>(nbr, w, gy, xi_rows, out, n_rows, e_width, k, dim, \
                    parts, stream)
#define WIDE(KW) \
  launch_wide<KW>(nbr, w, gy, xi_rows, out, n_rows, e_width, k, dim, parts, \
                  stream)
  if (k <= 4) NARROW(4);
  else if (k <= 8) NARROW(8);
  else if (k <= 16) NARROW(16);
  else if (k <= 32) NARROW(32);
  else switch ((k + 31) / 32) {
    case 2: WIDE(2); break;
    case 3: WIDE(3); break;
    case 4: WIDE(4); break;
    case 5: WIDE(5); break;
    case 6: WIDE(6); break;
    case 7: WIDE(7); break;
    default: WIDE(8); break;
  }
#undef NARROW
#undef WIDE
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
