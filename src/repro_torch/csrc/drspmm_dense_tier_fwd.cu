// DR-SpMM dense-tier forward for Hopper (sm_90a).
//
// Replaces the TPU kernel drspmm_dense_tier_fwd
// (src/repro/kernels/drspmm.py): Y (M, dim) = A (M, N) . densify(CBSR x),
// with the CBSR operand densified inside the kernel, source chunk by source
// chunk, so the dense (N, dim) operand never reaches device memory.
//
// One thread block of 8 warps per 8 output rows.  For each chunk of 32
// source rows the warps densify the chunk into shared memory (lane-owned
// columns filled by the permutation scatter of cbsr_densify.cuh, so
// duplicate CBSR columns accumulate without atomics; each warp issues the
// loads of its 4 sources together), each warp reads its row's 32 A entries
// with one coalesced load, and the warp then adds a * xd[s] for every
// non-zero a (zero entries of the masked relation table are skipped
// warp-uniformly).  The sum is fp32 and deterministic.
//
// Bound on the H100: memory.  The dense-tier table is mostly zeros (a
// relation lands here only with nnz <= 4096), so reading A once dominates;
// the densify is recomputed per row-block but stays on chip.  At the tier's
// sizes (a few hundred rows) the kernel fills less than half the SMs and is
// bound by the latency of its chunk loop rather than by either roof.
#include <cuda_runtime.h>

#include "cbsr_densify.cuh"

constexpr int kRows = 8;       // output rows per block (one warp each)
constexpr int kSrcChunk = 32;  // source rows densified per step
constexpr int kSrcPerWarp = kSrcChunk / kRows;

template <int DPL>
__global__ void __launch_bounds__(256) dense_tier_fwd_kernel(
    const float* __restrict__ a, const float* __restrict__ xv,
    const int* __restrict__ xi, float* __restrict__ out, int m, int n, int k,
    int dim) {
  __shared__ float xd[kSrcChunk][32 * DPL];
  __shared__ int owner_tab[kRows][32 * DPL];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + warp;
  int* owner = owner_tab[warp];
#pragma unroll
  for (int j = 0; j < DPL; ++j) owner[lane + 32 * j] = -1;
  __syncwarp();
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  for (int n0 = 0; n0 < n; n0 += kSrcChunk) {
    float my_a = 0.f;
    if (row < m && n0 + lane < n) my_a = a[(long long)row * n + n0 + lane];
    // this warp densifies sources warp, warp + kRows, ... of the chunk;
    // with k <= 32 their pairs are all loaded before any is scattered
    float pv[kSrcPerWarp];
    int pc[kSrcPerWarp];
#pragma unroll
    for (int q = 0; q < kSrcPerWarp; ++q) {
      const int src = n0 + warp + kRows * q;
      pv[q] = 0.f;
      pc[q] = 0;
      if (k <= 32 && src < n && lane < k) {
        pv[q] = xv[(long long)src * k + lane];
        pc[q] = xi[(long long)src * k + lane];
      }
    }
#pragma unroll
    for (int q = 0; q < kSrcPerWarp; ++q) {
      const int s = warp + kRows * q;
      float d[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) d[j] = 0.f;
      if (k <= 32)
        scatter_row_pairs<DPL>(d, owner, pv[q], pc[q], dim, lane);
      else if (n0 + s < n)
        accumulate_cbsr_row<DPL>(d, xv + (long long)(n0 + s) * k,
                                 xi + (long long)(n0 + s) * k, k, 1.f, lane);
#pragma unroll
      for (int j = 0; j < DPL; ++j) xd[s][lane + 32 * j] = d[j];
    }
    __syncthreads();
    const int ns = min(kSrcChunk, n - n0);
    for (int s = 0; s < ns; ++s) {
      const float av = __shfl_sync(kFullMask, my_a, s);
      if (av == 0.f) continue;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[j] += av * xd[s][lane + 32 * j];
    }
    __syncthreads();
  }
  if (row >= m) return;
  float* o = out + (long long)row * dim;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int col = lane + 32 * j;
    if (col < dim) o[col] = acc[j];
  }
}

template <int DPL>
static void launch(const float* a, const float* xv, const int* xi, float* out,
                   int m, int n, int k, int dim, cudaStream_t stream) {
  dense_tier_fwd_kernel<DPL><<<(m + kRows - 1) / kRows, 32 * kRows, 0,
                               stream>>>(a, xv, xi, out, m, n, k, dim);
}

extern "C" int drspmm_dense_tier_fwd(const float* a, const float* xv,
                                     const int* xi, float* out, int m, int n,
                                     int k, int dim, cudaStream_t stream) {
  if (m == 0) return 0;
  switch ((dim + 31) / 32) {
    case 1: launch<1>(a, xv, xi, out, m, n, k, dim, stream); break;
    case 2: launch<2>(a, xv, xi, out, m, n, k, dim, stream); break;
    case 3: launch<3>(a, xv, xi, out, m, n, k, dim, stream); break;
    case 4: launch<4>(a, xv, xi, out, m, n, k, dim, stream); break;
    case 5: launch<5>(a, xv, xi, out, m, n, k, dim, stream); break;
    case 6: launch<6>(a, xv, xi, out, m, n, k, dim, stream); break;
    case 7: launch<7>(a, xv, xi, out, m, n, k, dim, stream); break;
    case 8: launch<8>(a, xv, xi, out, m, n, k, dim, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
