// Learnable-edge DR-SpMM weight gradient for Hopper (sm_90a).
//
// Replaces the TPU kernel drspmm_dw_learnable_fused
// (src/repro/kernels/drspmm.py) and the scatter to canonical order that
// follows it (_dw_contrib_to_canon, src/repro/kernels/ops.py):
//
//   gw[eid[c,r,e]] = sum_t gY[rows[blk*BR + r], xi[nbr, t]] * x_vals[nbr, t]
//
// for every real slot (eid >= 0) of the forward edge-id arena: the same
// sampled gather as the dx backward with the roles of weight and value
// swapped.  Each canonical edge id occupies exactly one slot of the arena
// (checked at pack time), so the reduction to canonical order is a
// permutation: the kernel writes gw[eid] directly, once per id, with no
// atomics, and the result is deterministic.
//
// One thread block per arena row-block, one warp per arena row.  A row's
// gY row is fixed for the whole chunk run, so the warp stages it once in
// shared memory and every slot samples it there.  Lane l handles CBSR
// positions l, l+32, ... of a slot; the slot's sum is folded by a butterfly
// of shuffles in a fixed order and lane 0 writes it.
//
// Bound on the H100: memory.  Each real slot reads one CBSR row of its
// source (k values + k indices, 8k bytes, mostly L2 hits) and writes one
// float; each arena row reads its gY row once.  What the design does about
// it:
//  * all of a chunk row's real slots issue their CBSR loads before any is
//    reduced, so a chunk row costs about one memory round trip;
//  * padding slots (eid -1) issue no load and a chunk row of padding is
//    skipped warp-uniformly;
//  * the gY samples are shared-memory reads, not scattered global loads;
//  * row-blocks run heaviest first (block b = n_blocks-1-blockIdx.x).
// Columns outside [0, dim) sample nothing (they contribute 0).
#include <cuda_runtime.h>

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxRows = 8;     // rows (warps) per block
constexpr int kMaxDim = 256;

template <int KPL, int EC>
__global__ void __launch_bounds__(256) dw_kernel(
    const int* __restrict__ blk_ptr, const int* __restrict__ nbr,
    const int* __restrict__ eid, const int* __restrict__ rows,
    const float* __restrict__ gy, const float* __restrict__ xv,
    const int* __restrict__ xi, float* __restrict__ gw, int n_blocks, int k,
    int dim) {
  __shared__ float gy_tab[kMaxRows][kMaxDim];
  const int b = n_blocks - 1 - blockIdx.x;
  const int br = blockDim.y;
  const int r = threadIdx.y;
  const int lane = threadIdx.x;
  const long long row = (long long)b * br + r;
  float* g_row = gy_tab[r];
  const float* gsrc = gy + (long long)rows[row] * dim;
  for (int col = lane; col < dim; col += 32) g_row[col] = gsrc[col];
  __syncwarp();

  const int c1 = blk_ptr[b + 1];
  for (int c = blk_ptr[b]; c < c1; ++c) {
    const long long slot0 = ((long long)c * br + r) * EC;
    int my_n = 0, my_id = -1;
    if (lane < EC) {
      my_n = nbr[slot0 + lane];
      my_id = eid[slot0 + lane];
    }
    if (!__any_sync(kFullMask, my_id >= 0)) continue;   // all padding
    float s[EC];
#pragma unroll
    for (int e = 0; e < EC; ++e) {
      const int id = __shfl_sync(kFullMask, my_id, e);
      const int src = __shfl_sync(kFullMask, my_n, e);
      s[e] = 0.f;
      if (id >= 0) {
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int t = lane + 32 * j;
          if (t < k) {
            const int col = xi[(long long)src * k + t];
            const float v = xv[(long long)src * k + t];
            if ((unsigned)col < (unsigned)dim) s[e] += v * g_row[col];
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < EC; ++e) {
      const int id = __shfl_sync(kFullMask, my_id, e);
      if (id < 0) continue;                 // warp-uniform
      float v = s[e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(kFullMask, v, off);
      if (lane == 0) gw[id] = v;
    }
  }
}

template <int KPL>
static int launch_ec(const int* blk_ptr, const int* nbr, const int* eid,
                     const int* rows, const float* gy, const float* xv,
                     const int* xi, float* gw, int n_blocks, int row_block,
                     int ec, int k, int dim, cudaStream_t stream) {
  const dim3 block(32, row_block);
  switch (ec) {
    case 4: dw_kernel<KPL, 4><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, eid, rows, gy, xv, xi, gw, n_blocks, k, dim); break;
    case 8: dw_kernel<KPL, 8><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, eid, rows, gy, xv, xi, gw, n_blocks, k, dim); break;
    case 16: dw_kernel<KPL, 16><<<n_blocks, block, 0, stream>>>(blk_ptr, nbr, eid, rows, gy, xv, xi, gw, n_blocks, k, dim); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

extern "C" int drspmm_learnable_dw(const int* blk_ptr, const int* nbr,
                                   const int* eid, const int* rows,
                                   const float* gy, const float* xv,
                                   const int* xi, float* gw, int n_blocks,
                                   int row_block, int ec, int k, int dim,
                                   cudaStream_t stream) {
  if (row_block > kMaxRows || dim < 1 || dim > kMaxDim || k < 1 || k > 256)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  int rc;
  switch ((k + 31) / 32) {
    case 1: rc = launch_ec<1>(blk_ptr, nbr, eid, rows, gy, xv, xi, gw, n_blocks, row_block, ec, k, dim, stream); break;
    case 2: rc = launch_ec<2>(blk_ptr, nbr, eid, rows, gy, xv, xi, gw, n_blocks, row_block, ec, k, dim, stream); break;
    case 3: rc = launch_ec<3>(blk_ptr, nbr, eid, rows, gy, xv, xi, gw, n_blocks, row_block, ec, k, dim, stream); break;
    case 4: rc = launch_ec<4>(blk_ptr, nbr, eid, rows, gy, xv, xi, gw, n_blocks, row_block, ec, k, dim, stream); break;
    case 5: rc = launch_ec<5>(blk_ptr, nbr, eid, rows, gy, xv, xi, gw, n_blocks, row_block, ec, k, dim, stream); break;
    case 6: rc = launch_ec<6>(blk_ptr, nbr, eid, rows, gy, xv, xi, gw, n_blocks, row_block, ec, k, dim, stream); break;
    case 7: rc = launch_ec<7>(blk_ptr, nbr, eid, rows, gy, xv, xi, gw, n_blocks, row_block, ec, k, dim, stream); break;
    case 8: rc = launch_ec<8>(blk_ptr, nbr, eid, rows, gy, xv, xi, gw, n_blocks, row_block, ec, k, dim, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
