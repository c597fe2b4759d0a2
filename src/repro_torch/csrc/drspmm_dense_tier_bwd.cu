// DR-SpMM dense-tier sampled backward for Hopper (sm_90a).
//
// Replaces the TPU kernel drspmm_dense_tier_bwd
// (src/repro/kernels/drspmm.py):
//
//   dV[n, t] = sum_m Aᵀ[n, m] * gY[m, xi[n, t]]      Aᵀ (N, M), gY (M, dim)
//
// for the plan's stacked transposed dense-tier table.  The product is
// sampled inside the kernel, so the (N, dim) dense cotangent Aᵀ·gY is never
// written to device memory.
//
// One thread block of 8 warps per 8 source rows (one warp a row).  The
// block walks M in tiles of 32 gY rows: each warp reads its row's 32 table
// entries with one coalesced load; if the block's 8 x 32 entries are all
// zero the tile is skipped (the table is mostly empty: a relation lands in
// the dense tier only with nnz <= 4096), else the block stages the 32 gY
// rows in shared memory and each warp adds a * gY[m, col_t] for every
// non-zero entry a of its row (the ballot of non-zeros walked in order,
// warp-uniformly), lane t owning positions t, t+32, ...  The sum is fp32 and
// deterministic; a row outside every dense relation comes back exactly 0.
//
// Bound on the H100: memory, reading the table once.  At the tier's sizes
// (a few hundred rows) the kernel fills less than half the SMs and is bound
// by the latency of its tile loop rather than by either roof.
// Columns outside [0, dim) sample nothing (they contribute 0).
#include <cuda_runtime.h>

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRows = 8;       // source rows per block (one warp each)
constexpr int kTile = 32;      // gY rows staged per step
constexpr int kMaxDim = 256;

template <int TPL>
__global__ void __launch_bounds__(256) dense_tier_bwd_kernel(
    const float* __restrict__ at, const float* __restrict__ gy,
    const int* __restrict__ xi, float* __restrict__ out, int n, int m, int k,
    int dim) {
  __shared__ float gs[kTile][kMaxDim];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + warp;
  int col[TPL];
  float acc[TPL];
#pragma unroll
  for (int j = 0; j < TPL; ++j) {
    const int t = lane + 32 * j;
    col[j] = -1;
    acc[j] = 0.f;
    if (row < n && t < k) {
      const int c = xi[(long long)row * k + t];
      if ((unsigned)c < (unsigned)dim) col[j] = c;
    }
  }
  for (int m0 = 0; m0 < m; m0 += kTile) {
    float my_a = 0.f;
    if (row < n && m0 + lane < m) my_a = at[(long long)row * m + m0 + lane];
    if (!__syncthreads_or(my_a != 0.f)) continue;   // block-uniform
    for (int q = warp; q < kTile; q += kRows) {
      const int mr = m0 + q;
      for (int c = lane; c < dim; c += 32)
        gs[q][c] = mr < m ? gy[(long long)mr * dim + c] : 0.f;
    }
    __syncthreads();
    unsigned nz = __ballot_sync(kFullMask, my_a != 0.f);
    while (nz) {
      const int q = __ffs(nz) - 1;
      nz &= nz - 1;
      const float a = __shfl_sync(kFullMask, my_a, q);
#pragma unroll
      for (int j = 0; j < TPL; ++j)
        if (col[j] >= 0) acc[j] += a * gs[q][col[j]];
    }
    __syncthreads();
  }
  if (row >= n) return;
#pragma unroll
  for (int j = 0; j < TPL; ++j) {
    const int t = lane + 32 * j;
    if (t < k) out[(long long)row * k + t] = acc[j];
  }
}

template <int TPL>
static void launch(const float* at, const float* gy, const int* xi,
                   float* out, int n, int m, int k, int dim,
                   cudaStream_t stream) {
  dense_tier_bwd_kernel<TPL><<<(n + kRows - 1) / kRows, 32 * kRows, 0,
                               stream>>>(at, gy, xi, out, n, m, k, dim);
}

extern "C" int drspmm_dense_tier_bwd(const float* at, const float* gy,
                                     const int* xi, float* out, int n, int m,
                                     int k, int dim, cudaStream_t stream) {
  if (dim > kMaxDim || k < 1) return (int)cudaErrorInvalidValue;
  if (n == 0 || m == 0) return 0;
  switch ((k + 31) / 32) {
    case 1: launch<1>(at, gy, xi, out, n, m, k, dim, stream); break;
    case 2: launch<2>(at, gy, xi, out, n, m, k, dim, stream); break;
    case 3: launch<3>(at, gy, xi, out, n, m, k, dim, stream); break;
    case 4: launch<4>(at, gy, xi, out, n, m, k, dim, stream); break;
    case 5: launch<5>(at, gy, xi, out, n, m, k, dim, stream); break;
    case 6: launch<6>(at, gy, xi, out, n, m, k, dim, stream); break;
    case 7: launch<7>(at, gy, xi, out, n, m, k, dim, stream); break;
    case 8: launch<8>(at, gy, xi, out, n, m, k, dim, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
