// Per-degree-bucket DR-SpMM forward for Hopper (sm_90a).
//
// Replaces the TPU kernel drspmm_fwd_bucket (src/repro/kernels/drspmm.py),
// the executor of ops.drspmm's per-bucket loop (backend "bucket"): one
// launch per degree bucket of a relation, straight over the bucket's ELL
// slab (nbr, w), both (R, E):
//
//   Y[r, x_idx[nbr[r,e], t]] += w[r,e] * x_vals[nbr[r,e], t]    Y: (R, dim)
//
// Rows are bucket-local; the caller adds them into the relation's output at
// the bucket's row ids (index_add_, since the padding rows repeat row 0).
//
// One warp per slab row, eight rows a block.  Lane l owns output columns
// l, l+32, ..., so every column has exactly one writer: the sum is fp32,
// has no atomics and is deterministic.  The row's E slots are walked 32 at
// a time (any E): lane s loads slot s's neighbour and weight once, and the
// warp broadcasts them with shuffles.
//
// Bound on the H100: memory.  Each real slot gathers one CBSR row of the
// operand (k values + k indices, 8k bytes, mostly L2 hits), and each output
// row is written once.  What the design does about it:
//  * for k <= 32 the CBSR loads of eight slots are issued together (lane t
//    holds pair t of each), so eight slots cost about one memory round trip;
//  * the scatter of a slot's k pairs into the lane-owned columns is the
//    owner-table permutation of cbsr_densify.cuh (a broadcast fallback
//    keeps repeated columns exact); rows wider than 32 pairs scatter slot by
//    slot, 32 pairs at a time;
//  * padding slots (weight 0) issue no load, and a group of 32 slots that
//    is all padding is skipped warp-uniformly.
#include <cuda_runtime.h>

#include "cbsr_densify.cuh"

namespace {

constexpr int kRows = 8;       // slab rows (warps) per block
constexpr int kInFlight = 8;   // slots whose CBSR loads are issued together
constexpr int kMaxGroups = 8;  // groups of 32 pairs per CBSR row (k <= 256)

template <int DPL>
__global__ void __launch_bounds__(256) bucket_fwd_kernel(
    const int* __restrict__ nbr, const float* __restrict__ w,
    const float* __restrict__ xv, const int* __restrict__ xi,
    float* __restrict__ out, int n_rows, int e_width, int k, int dim) {
  __shared__ int owner_tab[kRows][32 * DPL];
  const int lane = threadIdx.x;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.y;
  if (row >= n_rows) return;  // warp-uniform; the kernel has no block sync
  int* owner = owner_tab[threadIdx.y];
#pragma unroll
  for (int j = 0; j < DPL; ++j) owner[lane + 32 * j] = -1;
  __syncwarp();
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  const int* nr = nbr + row * e_width;
  const float* wr = w + row * e_width;
  for (int e0 = 0; e0 < e_width; e0 += 32) {
    int my_n = 0;
    float my_w = 0.f;
    if (e0 + lane < e_width) {
      my_n = nr[e0 + lane];
      my_w = wr[e0 + lane];
    }
    if (!__any_sync(kFullMask, my_w != 0.f)) continue;  // all padding
    const int ne = min(32, e_width - e0);
    if (k > 32) {  // wide CBSR rows: slot by slot, 32 pairs at a time
      for (int s = 0; s < ne; ++s) {
        const float wt = __shfl_sync(kFullMask, my_w, s);
        const int src = __shfl_sync(kFullMask, my_n, s);
        if (wt == 0.f) continue;  // warp-uniform
        float pv[kMaxGroups];
        int pc[kMaxGroups];
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g) {
          const int t = 32 * g + lane;
          pv[g] = 0.f;
          pc[g] = 0;
          if (t < k) {
            pv[g] = wt * xv[(long long)src * k + t];
            pc[g] = xi[(long long)src * k + t];
          }
        }
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
          if (32 * g < k)  // warp-uniform
            scatter_row_pairs<DPL>(acc, owner, pv[g], pc[g], dim, lane);
      }
      continue;
    }
    // s0 + i < 32: lanes past the slab's end hold weight 0 and load nothing
    for (int s0 = 0; s0 < ne; s0 += kInFlight) {
      float pv[kInFlight];
      int pc[kInFlight];
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        const float wt = __shfl_sync(kFullMask, my_w, s0 + i);
        const int src = __shfl_sync(kFullMask, my_n, s0 + i);
        pv[i] = 0.f;
        pc[i] = 0;
        if (wt != 0.f && lane < k) {
          pv[i] = wt * xv[(long long)src * k + lane];
          pc[i] = xi[(long long)src * k + lane];
        }
      }
#pragma unroll
      for (int i = 0; i < kInFlight; ++i)
        scatter_row_pairs<DPL>(acc, owner, pv[i], pc[i], dim, lane);
    }
  }
  float* o = out + row * dim;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int col = lane + 32 * j;
    if (col < dim) o[col] = acc[j];
  }
}

template <int DPL>
void launch(const int* nbr, const float* w, const float* xv, const int* xi,
            float* out, int n_rows, int e_width, int k, int dim,
            cudaStream_t stream) {
  const int grid = (n_rows + kRows - 1) / kRows;
  bucket_fwd_kernel<DPL><<<grid, dim3(32, kRows), 0, stream>>>(
      nbr, w, xv, xi, out, n_rows, e_width, k, dim);
}

}  // namespace

// Y (n_rows, dim) of one bucket slab; any e_width >= 1, 1 <= k <= 256,
// 1 <= dim <= 256.  Returns a CUDA error code (cudaGetLastError right after
// the launch).
extern "C" int drspmm_bucket_fwd(const int* nbr, const float* w,
                                 const float* xv, const int* xi, float* out,
                                 int n_rows, int e_width, int k, int dim,
                                 cudaStream_t stream) {
  if (e_width < 1 || k < 1 || k > 32 * kMaxGroups) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  switch ((dim + 31) / 32) {
    case 1: launch<1>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    case 2: launch<2>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    case 3: launch<3>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    case 4: launch<4>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    case 5: launch<5>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    case 6: launch<6>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    case 7: launch<7>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    case 8: launch<8>(nbr, w, xv, xi, out, n_rows, e_width, k, dim, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
