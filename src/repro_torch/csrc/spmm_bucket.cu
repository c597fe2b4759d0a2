// Per-degree-bucket dense-operand SpMM for Hopper (sm_90a).
//
// Replaces the TPU kernel spmm_dense_bucket (src/repro/kernels/drspmm.py),
// the executor of ops.spmm's per-bucket loop (backend "bucket"): the
// relations of a node type that stays dense (D-ReLU off, or k >= width) and
// the GCN / GraphSAGE baselines, forward over the buckets of A and backward
// over the buckets of Aᵀ with gY as the operand.  One launch per degree
// bucket, straight over the bucket's ELL slab (nbr, w), both (R, E):
//
//   Y[r, :] = sum_e w[r,e] * x[nbr[r,e], :]                     Y: (R, D)
//
// Rows are bucket-local; the caller adds them into the relation's output at
// the bucket's row ids (index_add_, since the padding rows repeat row 0).
//
// Bound on the H100: memory.  Each real slot reads one whole dense row of x
// (D floats, 8 sectors of 32 bytes at D = 64, mostly L2 hits) and each
// output row is written once, so the floor is the L2's rate for those
// sectors, not the byte bound.  Walked by one warp a row, a 260-slot row
// was a chain of ~9 index loads and ~36 batches of row loads, and a
// 40 x 260 bucket took that chain (0.015 ms).  So (bucket_rows.cuh):
//  * a slab row is split over P warps (1 up to 32 slots, kParts64 up to 64,
//    then one warp per kWarpSlots slots, at most kMaxParts), the row's
//    batches dealt to them in turn; the partial rows are added in the
//    order p = 0..P-1 after the block's one barrier (no shared memory at
//    P = 1);
//  * lane l owns columns l, l + 32, ... (at D = 64 two floats of each
//    neighbour's contiguous 256-byte row); a part reads 32 slots a window
//    with the ids two windows ahead, one ballot a window, the row loads of
//    a batch of slots (kLoads floats a lane) before their adds;
//  * kBlockWarps warps a block, kMinBlocks blocks an SM, which caps the
//    walk at 48 registers without a spill.
// The constants were swept with tools/bucket_fwd_probe.py --kernel 12 on
// the H100 at the main path's buckets (PERF.md): two warps at 33-64 slots,
// 16-slot or 64-slot parts, 32 floats a lane, 4 or 6 blocks an SM and
// blocks of 4 or 16 warps were each no faster over the buckets.
#include <cuda_runtime.h>

#include "bucket_rows.cuh"

namespace {

using bucket_rows::batch_of;
using bucket_rows::combine_parts;
using bucket_rows::walk_batches;

constexpr int kBlockWarps = 8;   // warps a block
constexpr int kWarpSlots = 32;   // past 64 slots, one warp per kWarpSlots ...
constexpr int kMaxParts = 8;     // ... up to kMaxParts warps a row
constexpr int kParts64 = 1;      // warps a row for 32 < E <= 64
constexpr int kMinBlocks = 5;    // blocks an SM must hold (caps registers)
constexpr int kLoads = 16;       // floats a lane has in flight a batch
static_assert(kMaxParts <= kBlockWarps && kParts64 <= kBlockWarps,
              "a block holds at least one whole row");

// Lane l's columns l + 32 j below dim.
struct DenseCols {
  int lane, dim;
  __device__ __forceinline__ bool ok(int j) const {
    return lane + 32 * j < dim;
  }
  __device__ __forceinline__ int col(int j) const { return lane + 32 * j; }
};

// A block of (32, P, rows): warp (p, r) adds part p of the block's row r.
template <int DPL>
__global__ void __launch_bounds__(32 * kBlockWarps, kMinBlocks)
    spmm_bucket_kernel(const int* __restrict__ nbr,
                       const float* __restrict__ w,
                       const float* __restrict__ x, float* __restrict__ out,
                       int n_rows, int e_width, int dim) {
  constexpr int S = batch_of(DPL, kLoads);
  __shared__ float part[kBlockWarps][32 * DPL];
  const int lane = threadIdx.x;
  const int row = blockIdx.x * blockDim.z + threadIdx.z;
  const bool live = row < n_rows;  // warp-uniform
  const DenseCols cols{lane, dim};
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;
  if (live)
    walk_batches<DPL, S>(nbr, w, (long long)row * e_width, e_width,
                         threadIdx.y, blockDim.y, x, dim, cols, acc, lane);
  float* o = out + (long long)row * dim;
  if (blockDim.y == 1) {  // block-uniform: the row is the warp's own sum
    if (!live) return;
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      if (cols.ok(j)) o[cols.col(j)] = acc[j];
    return;
  }
  combine_parts<DPL>(part, acc, live, o, dim, lane);
}

template <int DPL>
void launch(const int* nbr, const float* w, const float* x, float* out,
            int n_rows, int e_width, int dim, cudaStream_t stream) {
  const int parts = bucket_rows::split_parts(e_width, kParts64, kWarpSlots,
                                             kMaxParts);
  const int rows = kBlockWarps / parts;
  const int grid = (n_rows + rows - 1) / rows;
  spmm_bucket_kernel<DPL><<<grid, dim3(32, parts, rows), 0, stream>>>(
      nbr, w, x, out, n_rows, e_width, dim);
}

}  // namespace

// Y (n_rows, dim) of one bucket slab; any e_width >= 1, 1 <= dim <= 256.
// Returns a CUDA error code (cudaGetLastError right after the launch).
extern "C" int spmm_bucket(const int* nbr, const float* w, const float* x,
                           float* out, int n_rows, int e_width, int dim,
                           cudaStream_t stream) {
  if (e_width < 1) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  switch ((dim + 31) / 32) {
    case 1: launch<1>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    case 2: launch<2>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    case 3: launch<3>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    case 4: launch<4>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    case 5: launch<5>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    case 6: launch<6>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    case 7: launch<7>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    case 8: launch<8>(nbr, w, x, out, n_rows, e_width, dim, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
